"""Field-analysis ops over velocity movies. Counterpart of
manifold_flow_tpu.ops; so far recombination, singularity detection and
classification (S3), streamlines (S6) and winding lines (S7). Wave speeds,
interpolation and the decomposition are ROADMAP Queue A item 13."""

from manifold_flow_tpu_torch.ops import singularity, streamline, winding
from manifold_flow_tpu_torch.ops.recombine import (
    velocity_to_complex,
    velocity_to_world,
    velocity_to_world_and_speed,
    world_speed,
)

__all__ = [
    "singularity",
    "streamline",
    "winding",
    "velocity_to_complex",
    "velocity_to_world",
    "velocity_to_world_and_speed",
    "world_speed",
]
