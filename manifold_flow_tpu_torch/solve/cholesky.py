"""Dense Cholesky with iterative refinement.

Counterpart of manifold_flow_tpu/solve/cholesky.py: the exact-solve path for
small meshes (the reference's ~3.1k-vertex cortical patches give 2N ~ 6.2k
DOFs, a dense (2N)^2 matrix of ~315 MB in f64). Each frame's dense matrix
is assembled and factored in f's dtype, one frame at a time, which bounds
peak memory to one matrix and its factor; `refine_steps` of iterative
refinement then correct each solution with the matrix-free operator's
residual (K1 `fem_matvec<double>` with `f - Ax` fused, on CUDA). The
factorization and the triangular solves are library calls (`torch.linalg`),
as they are in the JAX package. Replaces `spsolve` (SuperLU) at
utils/compute_optical_flow.py:143-147.

The JAX package's `factor_dtype` and `batch_size` are not carried over: its
f32 factor is not honoured on an f64 mesh (ROADMAP C6), and torch's batched
factorization on CUDA is slower than one frame at a time (on an H100, four
6272 x 6272 f64 factors took 60 ms in one batched call, 22 ms one by one).
"""

from __future__ import annotations

import dataclasses

import torch

from manifold_flow_tpu_torch.fem import assembly
from manifold_flow_tpu_torch.fem.operator import FlowOperator
from manifold_flow_tpu_torch.geometry.mesh import TriMesh


def _chol_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = b for rows b (1, 2N) given the lower factor L."""
    y = torch.linalg.solve_triangular(chol, b.mT, upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True).mT


def solve_cholesky(mesh: TriMesh, operator: FlowOperator, f: torch.Tensor,
                   refine_steps: int = 2) -> torch.Tensor:
    """Solve all frames by dense Cholesky (+ refinement). Returns (T, 2N).

    The dense matrices, their factors and the refinement residuals are all
    in f's dtype (the operator's).
    """
    dtype = f.dtype
    a2d = assembly.dense_a2(mesh).to(dtype)
    f = f.contiguous()
    x_out = torch.empty_like(f)
    for k in range(f.shape[0]):
        op_k = dataclasses.replace(operator, g=operator.g[k: k + 1])
        a1 = assembly.scatter_dense(mesh, assembly.a1_blocks(mesh, op_k.g).to(dtype))
        chol = torch.linalg.cholesky(operator.lambda_ * a2d + a1[0])
        f_k = f[k: k + 1]
        x = _chol_solve(chol, f_k)
        for _ in range(refine_steps):
            x = x + _chol_solve(chol, op_k.residual(f_k, x))
        x_out[k] = x[0]
    return x_out
