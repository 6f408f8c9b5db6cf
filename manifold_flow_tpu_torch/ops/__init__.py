"""Field-analysis ops over velocity movies. Counterpart of
manifold_flow_tpu.ops; so far recombination and singularity detection
(the S3 flow stage). The other analysis stages are ROADMAP Queue A items
10-13."""

from manifold_flow_tpu_torch.ops import singularity
from manifold_flow_tpu_torch.ops.recombine import (
    velocity_to_complex,
    velocity_to_world,
    velocity_to_world_and_speed,
    world_speed,
)

__all__ = [
    "singularity",
    "velocity_to_complex",
    "velocity_to_world",
    "velocity_to_world_and_speed",
    "world_speed",
]
