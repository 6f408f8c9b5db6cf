"""Field-analysis ops over movies. Counterpart of manifold_flow_tpu.ops:
recombination, singularity detection and classification (S3), phases and
RBF interpolation (S2), the SVD modes (S4), wave speeds (S5), streamlines
(S6), winding lines (S7) and the simulated-data validation."""

from manifold_flow_tpu_torch.ops import (
    interpolate,
    phase,
    singularity,
    streamline,
    svd,
    validation,
    wavespeed,
    winding,
)
from manifold_flow_tpu_torch.ops.recombine import (
    velocity_to_complex,
    velocity_to_world,
    velocity_to_world_and_speed,
    world_speed,
)

__all__ = [
    "interpolate",
    "phase",
    "singularity",
    "streamline",
    "svd",
    "validation",
    "wavespeed",
    "winding",
    "velocity_to_complex",
    "velocity_to_world",
    "velocity_to_world_and_speed",
    "world_speed",
]
