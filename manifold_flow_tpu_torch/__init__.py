"""manifold_flow_tpu_torch — the PyTorch/CUDA port of manifold_flow_tpu.

Manifold optical flow on triangulated surfaces, for an NVIDIA H100: P1 finite
elements on the surface, and a batched velocity solve over every frame of a
potentials movie: matrix-free PCG with block-Jacobi or a two-level
preconditioner, mixed-precision refinement, windows for long movies, and a
dense Cholesky direct solve. The JAX package `manifold_flow_tpu` is the
reference this port is held against; the two share module names. This
package imports neither JAX nor the JAX package.

The hot kernels of the solve and of the flow stage's analysis are
hand-written CUDA C++ for sm_90a (`csrc/`, wrapped in `kernels.fem`,
`kernels.coarse` and `kernels.analysis`), built with nvcc at the first call that gets CUDA
tensors; CPU tensors run their plain torch versions. The S3 flow stage runs
through `pipeline.stages` and `python -m manifold_flow_tpu_torch.pipeline.cli
flow`.
"""

from manifold_flow_tpu_torch import fem, geometry, kernels, ops, pipeline, solve, utils
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
    "pipeline",
    "solve",
    "utils",
]
