"""Batched preconditioned conjugate gradients, matrix-free.

Counterpart of manifold_flow_tpu/solve/cg.py. All frames solve at once: the
iterate is (T, 2N). One iteration is the `fem_matvec` kernel, the three PCG
kernels (`pcg_dot`, `pcg_update`, `pcg_direction`) and `pcg_gate`, the
loop's convergence test on the device: active = (count < max_iter) and any
frame's |r| above its target, the JAX `lax.while_loop`'s condition; count
+= active; and where not active, rz = 0, so that the next iteration's
update takes alpha = 0 and leaves x, r and r.r as they are. An iteration
run after the loop has stopped (a frozen one) therefore changes no result,
and the host need not test before each iteration: it runs a segment of
iterations, then reads the gate's (count, active) once, a `sync.solve.cg`
wait, and stops when active is 0. x, `iterations` (the count), `residual`
and `converged` are equal to those of a loop that tests before every
iteration, as the JAX loop does. Converged frames keep iterating harmlessly
until every frame passes, as in JAX; the zero guards on pAp and r.z keep
them (and an all-zero right-hand side) finite.

`PreparedCG` is the loop for one operator and preconditioner, solving any
number of right-hand sides (a `refine_loop` window's outer steps);
`solve_cg` prepares one for a single solve. On CUDA tensors with comm=None
the start (|f|, the targets, the first z and p, the first gate) is a CUDA
graph, and a segment is replays of graphs of GRAPH_LENGTHS gated
iterations, all captured at a key's first solve (the key: device, dtype,
the shape of f, the dtype and shape of every tensor of the operator and
the preconditioner and their other fields, such as lambda and K1's tile
sizes, `precise_dots`, and the calling thread and stream) and kept for
MAX_PLANS keys, the oldest evicted. The graphs read the operator and the
preconditioner from tensors of their own, into which the first solve of a
PreparedCG copies them (once a window; its inputs must not change while it
is in use), the loop's state from tensors of their own too (`x` is
returned as a copy), and their sums' `slice_workspace` pair from the plan,
which takes it out of the shared ones. A solve writes f, tol and max_iter
into the loop's tensors (`_set`: three launches), replays the start, then
the segments. Capture runs on a side stream, after one uncaptured start
and iteration there that load the kernels
(`capture_error_mode="thread_local"`: other threads, such as `run_batch`'s
writers, may use the device meanwhile). CPU tensors and the mesh axis
(`comm`, whose collectives a graph cannot hold) run the same gated start
and body uncaptured.

Segment lengths come from what the loop has seen (`_segment`): the count
of the same solve (by order: the same outer step) of the key's previous
window less a margin (the count // MARGIN_SHARE, at least 1), then a third
of the margin a read (at least 1) up to the margin past that count, then
an eighth of the iterations done; with no such count (a key's first
window, a step past the previous window's last, and always on the mesh
axis, whose ranks must run the same segments), FIRST_SEGMENT, then a
quarter of the iterations done. A `solve_cg` call is a window of one
solve, so repeated calls on one key start from the previous call's count.

Each solve is a `solve.cg` span (utils.profiling), each read a
`sync.solve.cg` wait; the counts `solve.inner_iters` (the solve's
iterations), `solve.frozen_iters` (the gated no-op ones),
`solve.graph_replays` (the start's too) and `solve.graph_captures` (one a
graph, at a key's first solve). `kernels.LAUNCHES` counts every launch
that runs, frozen iterations included: a replay adds the launches its
graph holds (a capture runs none, and takes back what its wrappers
counted), and the capture's uncaptured start and iteration count as they
run. After a solve of `it` iterations and `frozen` frozen ones (none at
capture), `pcg_direction` has counted it + frozen, and `pcg_gate`
it + frozen + 1.

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
before `pcg_direction` and the gate; under two-level, the restriction and
K11's r.z, in `TwoLevelPrecond.correct`). Every rank of the axis then holds
the same scalars and runs the same iterations. With comm=None nothing
changes: the same launches, iterations and results.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
from typing import NamedTuple

import torch

from manifold_flow_tpu_torch.fem.operator import FlowOperator
from manifold_flow_tpu_torch.kernels import LAUNCHES
from manifold_flow_tpu_torch.kernels import fem as kfem
from manifold_flow_tpu_torch.kernels._lib import take_slice_workspace
from manifold_flow_tpu_torch.solve.coarse import TwoLevelPrecond
from manifold_flow_tpu_torch.utils import profiling

# Iterations of the captured graphs: a segment of L iterations replays L's
# binary digits, the largest graphs as often as L needs.
GRAPH_LENGTHS = (1, 2, 4, 8, 16, 32)
MAX_PLANS = 4       # keys whose graphs and counts are kept
FIRST_SEGMENT = 8   # iterations before the first read with no count to go by
MARGIN_SHARE = 16   # the previous count over its margin, the iterations short of it


def _reduce_update(comm, two_level: bool, rz: torch.Tensor, rr: torch.Tensor) -> None:
    """All-reduce pcg_update's partial r.r, and its r.z unless the two-level
    correction overwrites it."""
    if comm is not None:
        if two_level:
            comm.all_reduce_(rr)
        else:
            comm.all_reduce_(rz, rr)


def any_above(values: torch.Tensor, target: torch.Tensor, wait: str) -> bool:
    """Whether any frame's value is above its target, read on the host and
    timed and counted as the wait `wait` (utils.profiling): the refinement's
    outer test. The inner PCG loop tests on the device instead (`pcg_gate`)
    and reads the result once a segment."""
    above = torch.any(values > target)
    with profiling.wait(wait):
        return bool(above)


class CGResult(NamedTuple):
    x: torch.Tensor          # (T, 2N) solution
    iterations: int          # iterations executed
    residual: torch.Tensor   # (T,) final recurrence residual norm |r|
    converged: torch.Tensor  # (T,) bool


@dataclasses.dataclass
class _Loop:
    """The PCG state and what an iteration reads: rz is the r.z the next
    update divides by (0 once the gate has stopped the loop), ctl the gate's
    (count, active, max_iter)."""

    operator: FlowOperator
    precond: torch.Tensor | TwoLevelPrecond
    precise: bool
    comm: object
    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    rz_new: torch.Tensor
    rr: torch.Tensor
    target: torch.Tensor
    tol: torch.Tensor
    ctl: torch.Tensor

    @property
    def two_level(self) -> bool:
        return isinstance(self.precond, TwoLevelPrecond)

    @property
    def dinv(self) -> torch.Tensor:
        return self.precond.diag if self.two_level else self.precond


def _new_loop(operator, precond, like: torch.Tensor, precise: bool, comm) -> _Loop:
    vectors = [torch.zeros_like(like) for _ in range(4)]
    scalars = [like.new_zeros(like.shape[0]) for _ in range(4)]
    tol = like.new_zeros(())
    ctl = torch.zeros(3, dtype=torch.int64, device=like.device)
    return _Loop(operator, precond, precise, comm, *vectors, *scalars, tol, ctl)


def _set(lp: _Loop, f: torch.Tensor, tol: float, max_iter: int) -> None:
    """A call's inputs into the loop's tensors: r = f, tol and max_iter."""
    lp.r.copy_(f)
    lp.tol.fill_(tol)
    lp.ctl[2].fill_(max(0, min(int(max_iter), 2**62)))


def _begin(lp: _Loop) -> None:
    """From r = f: the targets, the state before the first iteration (x =
    0, z = M^-1 r, p = z) and the gate of the first iteration."""
    ff = kfem.pcg_dot(lp.r, lp.r, lp.precise)
    if lp.comm is not None:
        lp.comm.all_reduce_(ff)
    tiny = torch.finfo(lp.r.dtype).tiny
    torch.mul(torch.clamp_min(torch.sqrt(ff), tiny), lp.tol, out=lp.target)
    lp.x.zero_()
    lp.p.zero_()
    lp.rz.zero_()
    lp.ctl[:2].zero_()
    # With pAp = 0 the update leaves x and r alone and only forms
    # z0 = D^-1 r0 with r0.z0 and r0.r0: the JAX loop's initial state.
    kfem.pcg_update(lp.x, lp.r, lp.z, lp.p, lp.p, lp.dinv, lp.rz, lp.rz, lp.rz_new,
                    lp.rr, lp.precise)
    _reduce_update(lp.comm, lp.two_level, lp.rz_new, lp.rr)
    if lp.two_level:
        lp.precond.correct(lp.r, lp.z, lp.rz_new, lp.precise, comm=lp.comm)
    lp.p.copy_(lp.z)
    kfem.pcg_gate(lp.rr, lp.target, lp.ctl, lp.rz_new, lp.rz)


def _iterate(lp: _Loop, k: int) -> None:
    """k gated iterations, launched without waiting."""
    for _ in range(k):
        ap = lp.operator.matvec(lp.p)
        pap = kfem.pcg_dot(lp.p, ap, lp.precise)
        if lp.comm is not None:
            lp.comm.all_reduce_(pap)
        kfem.pcg_update(lp.x, lp.r, lp.z, lp.p, ap, lp.dinv, lp.rz, pap, lp.rz_new,
                        lp.rr, lp.precise)
        _reduce_update(lp.comm, lp.two_level, lp.rz_new, lp.rr)
        if lp.two_level:
            lp.precond.correct(lp.r, lp.z, lp.rz_new, lp.precise, comm=lp.comm)
        kfem.pcg_direction(lp.p, lp.z, lp.rz_new, lp.rz)
        kfem.pcg_gate(lp.rr, lp.target, lp.ctl, lp.rz_new, lp.rz)


def _segment(expected: int | None, done: int) -> int:
    """Iterations to run before the next read, `done` having run, where the
    same solve in the key's previous window took `expected` (None: unknown)."""
    if expected is not None:
        margin = max(1, expected // MARGIN_SHARE)
        if done == 0:
            return max(expected - margin, 1)
        if done < expected + margin:
            return max(1, min(margin // 3, expected + margin - done))
        return max(1, done // 8)
    return max(FIRST_SEGMENT, done // 4)


def _fields(obj) -> list:
    """The values of a dataclass's fields or a tuple's items; [] for
    anything else."""
    if dataclasses.is_dataclass(obj):
        return [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    return list(obj) if isinstance(obj, tuple) else []


def _tensors(obj) -> list[torch.Tensor]:
    """Every tensor that obj is or holds in its fields, nested, in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    return [t for v in _fields(obj) for t in _tensors(v)]


def _signature(obj) -> tuple:
    """What a graph bakes in of obj: each tensor's dtype and shape, and the
    value of every other field (lambda, K1's tile sizes, ...)."""
    if isinstance(obj, torch.Tensor):
        return (obj.dtype, tuple(obj.shape))
    if dataclasses.is_dataclass(obj) or isinstance(obj, tuple):
        return tuple(_signature(v) for v in _fields(obj))
    return obj


def _empty_like(obj):
    """obj with every tensor it holds replaced by a new contiguous one."""
    if isinstance(obj, torch.Tensor):
        return torch.empty_like(obj, memory_format=torch.contiguous_format)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _empty_like(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        items = map(_empty_like, obj)
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return obj


class _Graph:
    """A captured CUDA graph and the launches it holds, which each replay
    counts in LAUNCHES (the capture launched nothing and counts nothing)."""

    def __init__(self, pool, fn, *args):
        self.graph = torch.cuda.CUDAGraph()
        before = dict(LAUNCHES)
        try:
            self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                fn(*args)
            finally:
                self.graph.capture_end()
        finally:
            self.launches = {key: n - before[key] for key, n in LAUNCHES.items()
                             if n != before[key]}
            for key, n in self.launches.items():
                LAUNCHES[key] -= n

    def replay(self) -> None:
        self.graph.replay()
        for key, n in self.launches.items():
            LAUNCHES[key] += n


class _Plan:
    """One key's iteration counts by solve and, on CUDA, its graphs: the
    loop state and the copies of the operator and preconditioner they
    read, the start's graph and the iterations', and the sums' workspace."""

    def __init__(self):
        self.window = None   # the number of the PreparedCG whose window this is
        self.history: list[int] = []   # the previous window's counts
        self.calls: list[int] = []     # this window's
        self.loop: _Loop | None = None
        self.inputs = None   # (operator, precond): the graphs' copies
        self.begin: _Graph | None = None
        self.graphs: dict[int, _Graph] = {}
        self.workspace = None

    def open(self, window: int, operator, precond) -> None:
        """A new window: its solves' inputs into the graphs' tensors, and
        the last window's counts kept as the history."""
        self.history = self.calls or self.history
        self.calls = []
        self.window = window
        if self.inputs is not None:
            for dst, src in zip(_tensors(self.inputs), _tensors((operator, precond))):
                dst.copy_(src)

    def expected(self) -> int | None:
        """The count of this solve's counterpart in the previous window."""
        i = len(self.calls)
        return self.history[i] if i < len(self.history) else None

    def capture(self, operator, precond, f: torch.Tensor, precise: bool) -> None:
        """The loop state, the input tensors and the graphs of this key."""
        inputs = _empty_like((operator, precond))
        for dst, src in zip(_tensors(inputs), _tensors((operator, precond))):
            dst.copy_(src)
        lp = _new_loop(*inputs, f, precise, None)
        device = f.device
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        pool = torch.cuda.graph_pool_handle()
        with torch.cuda.stream(stream):
            # One uncaptured start and iteration: they load the kernels and
            # make the stream's slice workspace, which the graphs then keep.
            _begin(lp)
            _iterate(lp, 1)
            torch.cuda.synchronize(device)
            begin = _Graph(pool, _begin, lp)
            graphs = {k: _Graph(pool, _iterate, lp, k) for k in GRAPH_LENGTHS}
        torch.cuda.current_stream(device).wait_stream(stream)
        self.workspace = take_slice_workspace(device, stream.cuda_stream)
        # A capture that raised is made again at the next solve.
        self.inputs, self.loop, self.begin, self.graphs = inputs, lp, begin, graphs
        profiling.count("solve.graph_captures", 1 + len(GRAPH_LENGTHS))

    def replay(self, length: int) -> None:
        """`length` iterations as replays of the graphs."""
        replays = 0
        for k in reversed(GRAPH_LENGTHS):
            while length >= k:
                self.graphs[k].replay()
                length -= k
                replays += 1
        profiling.count("solve.graph_replays", replays)


_PLANS: collections.OrderedDict = collections.OrderedDict()
_PLANS_LOCK = threading.Lock()
_WINDOWS = itertools.count()


def _plan(operator: FlowOperator, precond, f: torch.Tensor, precise: bool) -> _Plan:
    """The key's plan, made where there is none; the least recently used
    plan beyond MAX_PLANS is dropped with its graphs. The key holds the
    calling thread and, on CUDA, its current stream: a plan's tensors are
    used in one stream's order."""
    stream = torch.cuda.current_stream(f.device).cuda_stream if f.is_cuda else None
    key = (threading.get_ident(), stream, f.device, f.dtype, tuple(f.shape), precise,
           _signature(operator), _signature(precond))
    with _PLANS_LOCK:
        plan = _PLANS.pop(key, None) or _Plan()
        _PLANS[key] = plan
        while len(_PLANS) > MAX_PLANS:
            _PLANS.popitem(last=False)
    return plan


class PreparedCG:
    """The PCG loop for one operator and preconditioner, any number of
    right-hand sides: a window, whose solves' counts the key's next window
    starts from, and whose first solve on CUDA copies the inputs into the
    key's graphs. The operator's and preconditioner's tensors must not
    change while it is in use.

    Args:
      operator: batched FlowOperator (T frames) in the solves' dtype.
      precond: (T, N, 2, 2) inverted block-Jacobi blocks
        (fem.operator.block_jacobi_inverse), or a TwoLevelPrecond
        (solve.coarse.make_two_level) in the solves' dtype.
      precise_dots: float64 sums for every per-frame dot of a float32 solve.
      comm: the mesh axis's parallel.comm.AxisComm when the right-hand sides
        hold one shard's rows (operator.matvec then exchanges the halo);
        None on one device.
    """

    def __init__(self, operator: FlowOperator, precond: torch.Tensor | TwoLevelPrecond,
                 precise_dots: bool = False, comm=None):
        self.operator = operator
        self.precond = precond
        self.precise_dots = precise_dots
        self.comm = comm
        self.window = next(_WINDOWS)

    def solve(self, f: torch.Tensor, tol: float = 1e-10, max_iter: int = 2000) -> CGResult:
        """Solve A_k x_k = f_k for all frames k of f (T, 2N) to |r| / |f| <=
        tol a frame, in at most max_iter iterations."""
        with profiling.span("solve.cg"):
            f = f.contiguous()
            precise = self.precise_dots and f.dtype == torch.float32
            plan = None
            if self.comm is None:
                plan = _plan(self.operator, self.precond, f, precise)
                if plan.window != self.window:
                    plan.open(self.window, self.operator, self.precond)
            graphs = plan is not None and f.is_cuda
            if graphs:
                if plan.loop is None:
                    plan.capture(self.operator, self.precond, f, precise)
                lp = plan.loop
            else:
                lp = _new_loop(self.operator, self.precond, f, precise, self.comm)
            expected = None if plan is None else plan.expected()
            _set(lp, f, tol, max_iter)
            if graphs:
                plan.begin.replay()
                profiling.count("solve.graph_replays")
            else:
                _begin(lp)
            done = 0
            while True:
                length = _segment(expected, done)
                if graphs:
                    plan.replay(length)
                else:
                    _iterate(lp, length)
                done += length
                with profiling.wait("sync.solve.cg"):
                    it, active = lp.ctl[:2].tolist()
                if not active:
                    break
            if plan is not None:
                plan.calls.append(it)
            profiling.count("solve.inner_iters", it)
            profiling.count("solve.frozen_iters", done - it)
            rn = torch.sqrt(lp.rr)
            x = lp.x.clone() if graphs else lp.x
            return CGResult(x=x, iterations=it, residual=rn, converged=rn <= lp.target)


def solve_cg(operator: FlowOperator, f: torch.Tensor,
             precond: torch.Tensor | TwoLevelPrecond, tol: float = 1e-10,
             max_iter: int = 2000, precise_dots: bool = False,
             comm=None) -> CGResult:
    """Solve A_k x_k = f_k for all frames k with PCG: one solve of a
    `PreparedCG` (its arguments there).

    Args:
      operator: batched FlowOperator (T frames) in f's dtype.
      f: (T, 2N) right-hand sides.
      precond: the preconditioner in f's dtype.
      tol: relative tolerance on |r| / |f| per frame.
      max_iter: iteration cap.
      precise_dots: float64 sums for every per-frame dot of a float32 solve.
      comm: the mesh axis's AxisComm, or None on one device.
    """
    return PreparedCG(operator, precond, precise_dots, comm).solve(f, tol, max_iter)
