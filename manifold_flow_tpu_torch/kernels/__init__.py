"""Hand-written CUDA kernels for Hopper (sm_90a): `build` compiles csrc/*.cu
at first use into one library (`_lib.library`); `fem` (K1-K4, the solve),
`coarse` (K8-K11, the two-level preconditioner) and `analysis` (K5-K7,
recombination and singularity detection) hold one wrapper per kernel with
its plain torch version. `LAUNCHES` counts every kernel's
launches. Importing this package loads no library."""

from manifold_flow_tpu_torch.kernels._lib import LAUNCHES, library, reset_launches

__all__ = ["LAUNCHES", "library", "reset_launches"]
