"""Batched preconditioned conjugate gradients, matrix-free.

Counterpart of manifold_flow_tpu/solve/cg.py. All frames solve at once: the
iterate is (T, 2N). One iteration is the `fem_matvec` kernel and the three
PCG kernels (`pcg_dot`, `pcg_update`, `pcg_direction`), all launched without
waiting; the host then reads whether any frame is still above its tolerance,
one synchronization per iteration, so the iteration count matches the JAX
`lax.while_loop`. Converged frames keep iterating harmlessly, as in JAX;
the zero guards on pAp and r.z keep them (and an all-zero right-hand side)
finite. Each call is a `solve.cg` span (utils.profiling), each of those
reads a `sync.solve.cg` wait (the iterations and one more a call), and the
count `solve.inner_iters` gains the call's iterations.

The preconditioner is block-Jacobi, applied inside `pcg_update`, or the
two-level `solve.coarse.TwoLevelPrecond`: then `pcg_update`'s z = D^-1 r
and its r.z miss the coarse term, and `TwoLevelPrecond.correct` (K9-K11)
adds P A_c^-1 P^T r to z and overwrites r.z, before the direction update
and for the first z, in the order of the JAX loop (solve/cg.py:71-98).

`precise_dots` forms every per-frame dot of a float32 solve in float64 and
rounds it to float32 once, as the JAX `_dot(..., precise=True)` does: |f|,
the loop's |r|, p.Ap, r.z and the final |r|. The dots are then the float64-
accumulating instances of the same kernels (`pcg_dot<float,double>`,
`pcg_update<float,double>`, `coarse_prolong_dot<float,double>`); in float64
the option changes nothing.

`comm` (a `parallel.comm.AxisComm`) solves one mesh shard's rows of a
vertex-partitioned system (parallel.halo), as the JAX `psum_axis` does: the
kernels form this shard's partial dots, which are all-reduced over the axis
before they are used (|f|^2; p.Ap before `pcg_update`; its r.z and r.r
before `pcg_direction` and the convergence test; under two-level, the
restriction and K11's r.z, in `TwoLevelPrecond.correct`). Every rank of the
axis then holds the same scalars and runs the same iterations. With
comm=None nothing changes: the same launches, iterations and results.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from manifold_flow_tpu_torch.fem.operator import FlowOperator
from manifold_flow_tpu_torch.kernels import fem as kfem
from manifold_flow_tpu_torch.solve.coarse import TwoLevelPrecond
from manifold_flow_tpu_torch.utils import profiling


def _reduce_update(comm, two_level: bool, rz: torch.Tensor, rr: torch.Tensor) -> None:
    """All-reduce pcg_update's partial r.r, and its r.z unless the two-level
    correction overwrites it."""
    if comm is not None:
        if two_level:
            comm.all_reduce_(rr)
        else:
            comm.all_reduce_(rz, rr)


def any_above(values: torch.Tensor, target: torch.Tensor, wait: str) -> bool:
    """Whether any frame's value is above its target: a convergence loop's
    one read of the device a test, timed and counted as the wait `wait`
    (utils.profiling)."""
    above = torch.any(values > target)
    with profiling.wait(wait):
        return bool(above)


class CGResult(NamedTuple):
    x: torch.Tensor          # (T, 2N) solution
    iterations: int          # iterations executed
    residual: torch.Tensor   # (T,) final recurrence residual norm |r|
    converged: torch.Tensor  # (T,) bool


def solve_cg(operator: FlowOperator, f: torch.Tensor,
             precond: torch.Tensor | TwoLevelPrecond, tol: float = 1e-10,
             max_iter: int = 2000, precise_dots: bool = False,
             comm=None) -> CGResult:
    """Solve A_k x_k = f_k for all frames k with PCG.

    Args:
      operator: batched FlowOperator (T frames) in f's dtype.
      f: (T, 2N) right-hand sides.
      precond: (T, N, 2, 2) inverted block-Jacobi blocks
        (fem.operator.block_jacobi_inverse), or a TwoLevelPrecond
        (solve.coarse.make_two_level) in f's dtype.
      tol: relative tolerance on |r| / |f| per frame.
      max_iter: iteration cap.
      precise_dots: float64 sums for every per-frame dot of a float32 solve.
      comm: the mesh axis's parallel.comm.AxisComm when f holds one shard's
        rows (operator.matvec then exchanges the halo); None on one device.
    """
    with profiling.span("solve.cg"):
        f = f.contiguous()
        two_level = isinstance(precond, TwoLevelPrecond)
        dinv = precond.diag if two_level else precond
        ff = kfem.pcg_dot(f, f, precise_dots)
        if comm is not None:
            comm.all_reduce_(ff)
        fnorm = torch.sqrt(ff)
        target = tol * torch.clamp_min(fnorm, torch.finfo(f.dtype).tiny)

        x = torch.zeros_like(f)
        r = f.clone()
        z = torch.empty_like(f)
        p = torch.zeros_like(f)
        ap = torch.zeros_like(f)
        zero = torch.zeros_like(fnorm)
        rz, rz_new, rr = torch.empty_like(zero), torch.empty_like(zero), torch.empty_like(zero)
        # With pAp = 0 the update leaves x and r alone and only forms
        # z0 = D^-1 r0 with r0.z0 and r0.r0: the JAX loop's initial state.
        kfem.pcg_update(x, r, z, p, ap, dinv, zero, zero, rz, rr, precise_dots)
        _reduce_update(comm, two_level, rz, rr)
        if two_level:
            precond.correct(r, z, rz, precise_dots, comm=comm)
        p.copy_(z)

        it = 0
        while it < max_iter and any_above(torch.sqrt(rr), target, "sync.solve.cg"):
            ap = operator.matvec(p)
            pap = kfem.pcg_dot(p, ap, precise_dots)
            if comm is not None:
                comm.all_reduce_(pap)
            kfem.pcg_update(x, r, z, p, ap, dinv, rz, pap, rz_new, rr, precise_dots)
            _reduce_update(comm, two_level, rz_new, rr)
            if two_level:
                precond.correct(r, z, rz_new, precise_dots, comm=comm)
            kfem.pcg_direction(p, z, rz_new, rz)
            rz, rz_new = rz_new, rz
            it += 1
        profiling.count("solve.inner_iters", it)
        rn = torch.sqrt(rr)
        return CGResult(x=x, iterations=it, residual=rn, converged=rn <= target)
