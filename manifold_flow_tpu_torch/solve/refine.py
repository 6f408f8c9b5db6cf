"""Mixed-precision iterative refinement for the batched velocity solve.

Counterpart of manifold_flow_tpu/solve/refine.py. Plain f32 PCG stalls at a
normalized error around cond(A) * eps_f32 on the a1 + lambda a2 systems, so
the solve iterates

    r = f - A x          (float64)
    d = PCG_f32(A, r)    (float32 — the bulk of the matvecs)
    x = x + d            (float64 accumulate)

The H100 has native float64, so the residual is the f64 instance of the
`fem_matvec` kernel with the subtraction fused in; the JAX package's
two-float32 (DF) arithmetic, which exists because the TPU has no f64 units,
has no counterpart here. The inner preconditioner is block-Jacobi, or with
`coarse_tables` the two-level one (solve.coarse), built from the f32
operator as the JAX package builds it. The temporal warm start
(`anchor_stride`) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from manifold_flow_tpu_torch.fem.operator import (
    FlowOperator,
    block_jacobi_inverse,
    make_operator,
)
from manifold_flow_tpu_torch.geometry.mesh import TriMesh
from manifold_flow_tpu_torch.kernels import fem as kfem
from manifold_flow_tpu_torch.solve.cg import solve_cg
from manifold_flow_tpu_torch.solve.coarse import CoarseTables, make_two_level

# Inner tolerance schedule measured best for the bench problem by the JAX
# package (tight first step, looser later ones); the last entry repeats.
DEFAULT_INNER_TOL = (1e-3, 1e-2)


def as_inner_schedule(inner_tol) -> tuple:
    """Normalize an inner-tolerance spec to a non-empty tuple of floats.

    Accepts a scalar, a tuple/list schedule (last entry repeats), or a 0-/1-d
    tensor or array. Anything else (a matrix, an empty schedule) raises.
    """
    if isinstance(inner_tol, (tuple, list)):
        sched = tuple(inner_tol)
    elif hasattr(inner_tol, "ndim"):
        if inner_tol.ndim > 1:
            raise ValueError(
                f"inner_tol must be a scalar or 1-d schedule; got an array "
                f"of shape {tuple(inner_tol.shape)}")
        sched = tuple(inner_tol.reshape(-1).tolist())
    else:
        sched = (inner_tol,)
    if not sched:
        raise ValueError("inner_tol schedule must be non-empty")
    return tuple(float(t) for t in sched)


class RefineResult(NamedTuple):
    x: torch.Tensor           # (T, 2N) float64 solution
    iterations: int           # total inner CG iterations
    residual: torch.Tensor    # (T,) final |f - A x|
    converged: torch.Tensor   # (T,) bool
    outer_steps: int = 0      # refinement steps executed
    coarse_zeroed: int = 0    # coarse matrices of the inner two-level
                              # preconditioner whose inverse was zeroed


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(kfem.pcg_dot(v, v))


def refine_loop(mesh: TriMesh, op64: FlowOperator, f: torch.Tensor,
                tol: float = 1e-8, inner_tol=DEFAULT_INNER_TOL,
                max_iter: int = 2000, refine_steps: int = 8,
                coarse_tables: CoarseTables | None = None,
                coarse_a1: str = "full") -> RefineResult:
    """The refinement iteration given the f64 operator and RHS f (T, 2N)."""
    # The f32 operator is the f64 one rounded to f32, as in the JAX package,
    # and so is the inner preconditioner's.
    op32 = op64.astype(torch.float32)
    if coarse_tables is not None:
        pre32 = make_two_level(mesh, op32.g, op32.lambda_, coarse_tables,
                               a1_mode=coarse_a1)
        zeroed = int(pre32.zeroed.sum())
    else:
        pre32 = block_jacobi_inverse(mesh, op32.g, op32.lambda_)
        zeroed = 0
    # JAX takes the target from the f32 norm of the DF high part of f; here
    # the f64 norm is cast to f32, which moves the stopping point by at most
    # the last ulp of the target.
    tiny = torch.finfo(torch.float32).tiny
    target = (tol * torch.clamp_min(_norm(f), tiny)).to(torch.float32).double()
    sched = as_inner_schedule(inner_tol)

    x = torch.zeros_like(f)
    r = f
    total_iters = 0
    step = 0
    while step < refine_steps and bool(torch.any(_norm(r) > target)):
        step_tol = sched[min(step, len(sched) - 1)]
        inner = solve_cg(op32, r.to(torch.float32), pre32, tol=step_tol,
                         max_iter=max_iter)
        x = x + inner.x.double()
        r = op64.residual(f, x)
        total_iters += inner.iterations
        step += 1
    rn = _norm(r)
    return RefineResult(x=x, iterations=total_iters, residual=rn,
                        converged=rn <= target, outer_steps=step,
                        coarse_zeroed=zeroed)


def solve_refined(mesh: TriMesh, g: torch.Tensor, f: torch.Tensor,
                  lambda_: float = 0.01, tol: float = 1e-8,
                  inner_tol=DEFAULT_INNER_TOL, max_iter: int = 2000,
                  refine_steps: int = 8,
                  coarse_tables: CoarseTables | None = None,
                  coarse_a1: str = "full") -> RefineResult:
    """Solve (a1_k + lambda a2) x_k = f_k for all frames to f64 accuracy.

    Args:
      mesh: TriMesh built in float64.
      g: (T, M, 3, 2) float64 a1 factors and f: (T, 2N) float64 right-hand
        sides, as `kernels.fem.frame_factors_rhs` builds them (the JAX
        `solve_refined` takes the movie and builds its DF operator inside).
      tol: outer relative residual target |f - A x| / |f|.
      inner_tol: relative tolerance of each float32 PCG correction solve;
        a sequence gives per-outer-step tolerances (the last entry repeats).
      max_iter: per-inner-solve iteration cap.
      refine_steps: outer iteration cap; the loop exits as soon as every
        frame passes `tol`.
      coarse_tables: solve.coarse.build_tables(mesh) for the two-level
        inner preconditioner; None uses block-Jacobi.
      coarse_a1: the coarse data term, 'full' or 'mean' (solve.coarse).
    """
    if g.dtype != torch.float64 or f.dtype != torch.float64:
        raise ValueError(
            f"solve_refined needs float64 inputs; got {g.dtype} and {f.dtype}")
    return refine_loop(mesh, make_operator(mesh, g, lambda_), f, tol=tol,
                       inner_tol=inner_tol, max_iter=max_iter,
                       refine_steps=refine_steps, coarse_tables=coarse_tables,
                       coarse_a1=coarse_a1)
