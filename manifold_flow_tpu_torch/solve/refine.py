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
operator as the JAX package builds it.

The temporal warm start (`anchor_stride` s > 1) first refines every s-th
frame and the last one (the anchors) to a relaxed tolerance, interpolates
their solutions piecewise-linearly over the frame index and starts the
whole movie's refinement from there: the same kernels (K1-K4, and K8-K11
under two-level) on the anchor frames, then on all of them.

The inner solves are the gated loop of one `solve.cg.PreparedCG` a call,
on op32 and pre32: on CUDA, replays of CUDA graphs captured at the key's
first window, with one convergence read a segment. The op32 and pre32
tensors are copied into the graphs' once a call, at the first outer step;
the segments of step i start from the iteration count of step i in the
previous call of the same shapes. The mesh axis (`comm`) and CPU tensors
run the same gated loop uncaptured.

Spans (utils.profiling): `solve.setup` (the f32 operator and the inner
preconditioner, with its `sync.solve.zeroed` read), each outer step's
`solve.refine_step` around the inner `solve.cg` (its `sync.solve.cg` reads
and counts, solve.cg) and the f64 `solve.residual`; each outer loop test is
a `sync.solve.refine` wait, and `solve.outer_steps` counts the steps.
"""

from __future__ import annotations

import numbers
from typing import NamedTuple

import torch

from manifold_flow_tpu_torch.fem.operator import (
    FlowOperator,
    block_jacobi_inverse,
    make_operator,
)
from manifold_flow_tpu_torch.geometry.mesh import TriMesh
from manifold_flow_tpu_torch.kernels import fem as kfem
from manifold_flow_tpu_torch.solve.cg import PreparedCG, any_above
from manifold_flow_tpu_torch.solve.coarse import CoarseTables, make_two_level
from manifold_flow_tpu_torch.utils import profiling

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


def _norm(v: torch.Tensor, comm=None) -> torch.Tensor:
    """Per-frame |v|, over every shard's rows with `comm`."""
    vv = kfem.pcg_dot(v, v)
    if comm is not None:
        comm.all_reduce_(vv)
    return torch.sqrt(vv)


def refine_loop(mesh: TriMesh, op64: FlowOperator, f: torch.Tensor,
                tol: float = 1e-8, inner_tol=DEFAULT_INNER_TOL,
                max_iter: int = 2000, refine_steps: int = 8,
                coarse_tables: CoarseTables | None = None,
                coarse_a1: str = "full",
                x0: torch.Tensor | None = None, comm=None,
                precond_fn=None) -> RefineResult:
    """The refinement iteration given the f64 operator and RHS f (T, 2N),
    from x0 (T, 2N) float64 (the temporal warm start) or from zero.

    `comm` and `precond_fn` serve one mesh shard's rows (parallel.halo):
    `comm` (parallel.comm.AxisComm) all-reduces the norms and the inner
    PCG's dots, and op64 exchanges its halo in `residual`;
    `precond_fn(op32)` returns the inner preconditioner and its count of
    zeroed coarse matrices in place of the one built here from `mesh`."""
    # The f32 operator is the f64 one rounded to f32, as in the JAX package,
    # and so is the inner preconditioner's.
    with profiling.span("solve.setup"):
        op32 = op64.astype(torch.float32)
        if precond_fn is not None:
            pre32, zeroed = precond_fn(op32)
        elif coarse_tables is not None:
            pre32 = make_two_level(mesh, op32.g, op32.lambda_, coarse_tables,
                                   a1_mode=coarse_a1)
            with profiling.wait("sync.solve.zeroed"):
                zeroed = int(pre32.zeroed.sum())
        else:
            pre32 = block_jacobi_inverse(mesh, op32.g, op32.lambda_)
            zeroed = 0
        inner_cg = PreparedCG(op32, pre32, comm=comm)
    # JAX takes the target from the f32 norm of the DF high part of f; here
    # the f64 norm is cast to f32, which moves the stopping point by at most
    # the last ulp of the target.
    tiny = torch.finfo(torch.float32).tiny
    target = (tol * torch.clamp_min(_norm(f, comm), tiny)).to(torch.float32).double()
    sched = as_inner_schedule(inner_tol)

    if x0 is None:
        x, r = torch.zeros_like(f), f
    else:
        with profiling.span("solve.residual"):
            x, r = x0, op64.residual(f, x0)
    total_iters = 0
    step = 0
    while step < refine_steps and any_above(_norm(r, comm), target, "sync.solve.refine"):
        with profiling.span("solve.refine_step"):
            step_tol = sched[min(step, len(sched) - 1)]
            inner = inner_cg.solve(r.to(torch.float32), tol=step_tol, max_iter=max_iter)
            x = x + inner.x.double()
            with profiling.span("solve.residual"):
                r = op64.residual(f, x)
        total_iters += inner.iterations
        step += 1
    profiling.count("solve.outer_steps", step)
    rn = _norm(r, comm)
    return RefineResult(x=x, iterations=total_iters, residual=rn,
                        converged=rn <= target, outer_steps=step,
                        coarse_zeroed=zeroed)


def check_anchor_stride(anchor_stride) -> int:
    """`anchor_stride` as an int >= 1; anything else raises ValueError
    (the JAX package takes a stride below 2 as "no warm start" whatever it
    is)."""
    if (isinstance(anchor_stride, bool) or not isinstance(anchor_stride, numbers.Integral)
            or anchor_stride < 1):
        raise ValueError(f"anchor_stride must be an integer >= 1; got {anchor_stride!r}")
    return int(anchor_stride)


def anchor_frames(n_sys: int, stride: int) -> torch.Tensor:
    """The anchor frames 0, s, 2s, ... and the last frame n_sys - 1 (int64),
    as min(arange(0, n_sys + s - 1, s), n_sys - 1)."""
    return torch.clamp_max(torch.arange(0, n_sys + stride - 1, stride), n_sys - 1)


def interpolate_anchors(xa: torch.Tensor, n_sys: int, stride: int) -> torch.Tensor:
    """(T, 2N) piecewise-linear interpolation over the frame index of the
    anchor solutions xa (A, 2N). The last anchor sits at frame n_sys - 1,
    not at i0 * s: the final segment's weight is rescaled so that the
    interpolant is exact at both of its ends (JAX refine.py:173-178)."""
    last = xa.shape[0] - 1
    k = torch.arange(n_sys, device=xa.device)
    pos = k.double() / stride
    i0 = torch.clamp(torch.floor(pos).long(), 0, last)
    i1 = torch.clamp_max(i0 + 1, last)
    w = (pos - i0).to(xa.dtype)
    past = i1 * stride > n_sys - 1
    seg_len = torch.where(past, torch.clamp_min((n_sys - 1) - i0 * stride, 1),
                          torch.full_like(i0, stride))
    w = torch.where(past, ((k - i0 * stride).double() / seg_len).to(xa.dtype), w)[:, None]
    return (1.0 - w) * xa[i0] + w * xa[i1]


def solve_refined(mesh: TriMesh, g: torch.Tensor, f: torch.Tensor,
                  lambda_: float = 0.01, tol: float = 1e-8,
                  inner_tol=DEFAULT_INNER_TOL, max_iter: int = 2000,
                  refine_steps: int = 8,
                  coarse_tables: CoarseTables | None = None,
                  coarse_a1: str = "full", anchor_stride: int = 1) -> RefineResult:
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
      anchor_stride: the temporal warm start. With s > 1 and more than s
        frames, the anchor frames (`anchor_frames`) are refined first, on
        their own operator and preconditioner, to max(tol, 1e-4) (they need
        only the accuracy of the interpolation they seed); the whole movie
        then starts from their piecewise-linear interpolant. `iterations`
        counts both solves' inner iterations, `coarse_zeroed` both
        preconditioners' zeroed matrices. 1 (the default) starts from zero.
    """
    if g.dtype != torch.float64 or f.dtype != torch.float64:
        raise ValueError(
            f"solve_refined needs float64 inputs; got {g.dtype} and {f.dtype}")
    stride = check_anchor_stride(anchor_stride)
    kwargs = dict(inner_tol=inner_tol, max_iter=max_iter, refine_steps=refine_steps,
                  coarse_tables=coarse_tables, coarse_a1=coarse_a1)
    n_sys = f.shape[0]
    x0, anchor_iters, anchor_zeroed = None, 0, 0
    if stride > 1 and n_sys > stride:
        anchors = anchor_frames(n_sys, stride).to(f.device)
        res_a = refine_loop(mesh, make_operator(mesh, g[anchors].contiguous(), lambda_),
                            f[anchors].contiguous(), tol=max(tol, 1e-4), **kwargs)
        x0 = interpolate_anchors(res_a.x, n_sys, stride)
        anchor_iters, anchor_zeroed = res_a.iterations, res_a.coarse_zeroed
    res = refine_loop(mesh, make_operator(mesh, g, lambda_), f, tol=tol, x0=x0, **kwargs)
    return res._replace(iterations=res.iterations + anchor_iters,
                        coarse_zeroed=res.coarse_zeroed + anchor_zeroed)
