"""manifold_flow_tpu_torch — the PyTorch/CUDA port of manifold_flow_tpu.

Manifold optical flow on triangulated surfaces, for an NVIDIA H100: P1 finite
elements on the surface, and a batched velocity solve over every frame of a
potentials movie: matrix-free PCG with block-Jacobi or a two-level
preconditioner, mixed-precision refinement, windows for long movies, and a
dense Cholesky direct solve. The JAX package `manifold_flow_tpu` is the
reference this port is held against; the two share module names. This
package imports neither JAX nor the JAX package.

The hot kernels of the solve, of a trial's analysis and of the field stages
are hand-written CUDA C++ for sm_90a (`csrc/`, wrapped in `kernels.fem`,
`kernels.coarse`, `kernels.analysis`, `kernels.streams`, `kernels.winding`
and `kernels.fields`), built with nvcc at the first call that gets CUDA
tensors; CPU tensors run their plain torch versions. The S0 preprocessing
(MNE-Python needed), the S1 surface reconstruction, the S2 interpolation,
the S3 flow stage (with classification), the S4 SVD modes, the S5 wave
speeds, the S6 streamlines and the S7 winding lines run through
`pipeline.stages`, a whole results tree through `pipeline.batch` (with the
geometry cache of `utils.cache`), and `python -m
manifold_flow_tpu_torch.pipeline.cli
preprocess|reconstruct|interpolate|flow|decompose|wavespeed|streamline|winding|visualize|batch|demo`.
`viz` renders fields, modes and streamlines with matplotlib (imported when
a plot is drawn), `utils.profiling` times and traces. `parallel` spreads
the solve and the analysis over a ('frames', 'mesh') grid of
torch.distributed ranks (frame blocks, and halo-exchanged vertex blocks).
Entry points put their work on the GPU unless the caller passes
device="cpu".
"""

from manifold_flow_tpu_torch import (
    fem,
    geometry,
    kernels,
    ops,
    parallel,
    pipeline,
    solve,
    utils,
    viz,
)
from manifold_flow_tpu_torch.convert import mesh_from_jax_arrays
from manifold_flow_tpu_torch.geometry.mesh import TriMesh, build_mesh
from manifold_flow_tpu_torch.solve.api import compute_velocity_fields

__all__ = [
    "TriMesh",
    "build_mesh",
    "compute_velocity_fields",
    "mesh_from_jax_arrays",
    "fem",
    "geometry",
    "kernels",
    "ops",
    "parallel",
    "pipeline",
    "solve",
    "utils",
    "viz",
]
