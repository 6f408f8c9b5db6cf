"""Hand-written CUDA kernels for Hopper (sm_90a): `build` compiles csrc/*.cu
at first use, one nvcc process a source in parallel, into one library
(`_lib.library`); `fem` (K1-K4, the solve), `coarse` (K8-K11, the two-level
preconditioner), `analysis` (K5-K7 recombination and singularity detection,
K12 classification), `streams` (K13 next hops, K14 walks), `winding` (K15
ring winding numbers) and `fields` (K16 wave speeds, K17 RBF interpolation)
hold one wrapper per kernel with its plain torch version. `LAUNCHES` counts
every kernel's launches. Importing this package loads no library."""

from manifold_flow_tpu_torch.kernels._lib import LAUNCHES, library, reset_launches

__all__ = ["LAUNCHES", "library", "reset_launches"]
