"""The PCG loop's device-side gate and its segments (solve.cg).

solve_cg runs segments of gated iterations and reads the gate once a
segment; an iteration past the loop's end changes nothing. Its x,
iterations, residual and converged must therefore equal, with ==, those of
the loop that tests on the host before every iteration (`reference_cg`,
the loop as it ran before the gate), whatever the segments: forced here to
k iterations each, and as the default policy picks them over windows.

The `cuda` cases need an NVIDIA GPU and nvcc and skip without one: the
kernel `pcg_gate` against its plain version, the captured graphs against
the uncaptured loop, captures flat over windows of one shape, windows of
one key in turns, the plan's own slice workspace, and the launch counts. This file imports no JAX, so on a machine with a GPU and no
JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cg_gate.py
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from manifold_flow_tpu_torch.fem.operator import block_jacobi_inverse, make_operator
from manifold_flow_tpu_torch.geometry import synthetic
from manifold_flow_tpu_torch.kernels import LAUNCHES, reset_launches
from manifold_flow_tpu_torch.kernels import fem as kfem
from manifold_flow_tpu_torch.solve import cg, coarse, refine
from manifold_flow_tpu_torch.solve.api import build_rhs
from manifold_flow_tpu_torch.utils import profiling

PRECONDS = ["jacobi", "two_level"]
# (dtype, precise_dots, tol): the float32 inner solve of the refinement,
# with and without float64 dots, and the float64 cg.
MODES = {"f32": (torch.float32, False, 1e-5), "f32-precise": (torch.float32, True, 1e-5),
         "f64": (torch.float64, False, 1e-10)}


def _problem(device, n_frames=6):
    mesh = synthetic.plane_patch(
        nx=12, ny=12, lx=6.0, ly=6.0, device=device,
        height=lambda x, y: 0.8 * np.exp(-((x - 3.0) ** 2 + (y - 3.0) ** 2) / 4.0))
    pot, times = synthetic.plane_wave_movie(mesh, n_frames=n_frames)
    pot = pot + 0.05 * torch.from_numpy(
        np.random.default_rng(0).standard_normal(tuple(pot.shape))).to(device)
    g, f = build_rhs(mesh, pot, times)
    return mesh, g, f


def _system(mesh, g, f, precond, dtype):
    op = make_operator(mesh, g, 0.01).astype(dtype)
    if precond == "two_level":
        pre = coarse.make_two_level(mesh, op.g, op.lambda_, coarse.build_tables(mesh))
    else:
        pre = block_jacobi_inverse(mesh, op.g, op.lambda_)
    return op, f.to(dtype), pre


def reference_cg(op, f, pre, tol, max_iter, precise=False) -> cg.CGResult:
    """PCG with the host's test before every iteration, on the same kernels."""
    f = f.contiguous()
    two_level = isinstance(pre, coarse.TwoLevelPrecond)
    dinv = pre.diag if two_level else pre
    fnorm = torch.sqrt(kfem.pcg_dot(f, f, precise))
    target = tol * torch.clamp_min(fnorm, torch.finfo(f.dtype).tiny)
    x, r, z = torch.zeros_like(f), f.clone(), torch.empty_like(f)
    p, ap = torch.zeros_like(f), torch.zeros_like(f)
    zero = torch.zeros_like(fnorm)
    rz, rz_new, rr = torch.empty_like(zero), torch.empty_like(zero), torch.empty_like(zero)
    kfem.pcg_update(x, r, z, p, ap, dinv, zero, zero, rz, rr, precise)
    if two_level:
        pre.correct(r, z, rz, precise)
    p.copy_(z)
    it = 0
    while it < max_iter and bool(torch.any(torch.sqrt(rr) > target)):
        ap = op.matvec(p)
        pap = kfem.pcg_dot(p, ap, precise)
        kfem.pcg_update(x, r, z, p, ap, dinv, rz, pap, rz_new, rr, precise)
        if two_level:
            pre.correct(r, z, rz_new, precise)
        kfem.pcg_direction(p, z, rz_new, rz)
        rz, rz_new = rz_new, rz
        it += 1
    rn = torch.sqrt(rr)
    return cg.CGResult(x=x, iterations=it, residual=rn, converged=rn <= target)


def _assert_equal(got, want):
    assert got.iterations == want.iterations
    for a, b in ((got.x, want.x), (got.residual, want.residual),
                 (got.converged, want.converged)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert bool((a == b).all())


@pytest.fixture
def fresh_plans(monkeypatch):
    """Empty solve.cg plans: no count from an earlier test's windows."""
    monkeypatch.setattr(cg, "_PLANS", collections.OrderedDict())


def _segments_of(monkeypatch, k):
    monkeypatch.setattr(cg, "_segment", lambda expected, done: k)


@pytest.fixture(scope="module")
def cpu_problem():
    return _problem("cpu")


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("precond", PRECONDS)
def test_segments_of_k_equal_the_per_iteration_loop(cpu_problem, fresh_plans, monkeypatch,
                                                    precond, mode, k):
    mesh, g, f = cpu_problem
    dtype, precise, tol = MODES[mode]
    op, fd, pre = _system(mesh, g, f, precond, dtype)
    want = reference_cg(op, fd, pre, tol, 2000, precise)
    assert want.iterations > 8 and bool(want.converged.all())
    _segments_of(monkeypatch, k)
    with profiling.record() as rec:
        got = cg.solve_cg(op, fd, pre, tol=tol, max_iter=2000, precise_dots=precise)
    _assert_equal(got, want)
    counts = rec.summary()["counts"]
    # A read after each segment; the one that reaches the last iteration
    # finds the loop stopped.
    reads = -(-want.iterations // k)
    assert counts["sync.solve.cg"] == reads
    assert counts["solve.frozen_iters"] == reads * k - want.iterations
    assert counts["solve.inner_iters"] == want.iterations


@pytest.mark.parametrize("k,max_iter", [(5, 7), (4, 8), (3, 1), (6, 0)])
@pytest.mark.parametrize("precond", PRECONDS)
def test_max_iter_inside_a_segment(cpu_problem, fresh_plans, monkeypatch, precond, k,
                                   max_iter):
    mesh, g, f = cpu_problem
    op, fd, pre = _system(mesh, g, f, precond, torch.float64)
    want = reference_cg(op, fd, pre, 1e-12, max_iter)
    assert want.iterations == max_iter and not bool(want.converged.all())
    _segments_of(monkeypatch, k)
    _assert_equal(cg.solve_cg(op, fd, pre, tol=1e-12, max_iter=max_iter), want)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("precond", PRECONDS)
def test_zero_right_hand_side_runs_no_iteration(cpu_problem, fresh_plans, monkeypatch,
                                                precond, k):
    mesh, g, f = cpu_problem
    op, fd, pre = _system(mesh, g, f, precond, torch.float32)
    zero = torch.zeros_like(fd)
    want = reference_cg(op, zero, pre, 1e-5, 2000)
    assert want.iterations == 0
    _segments_of(monkeypatch, k)
    got = cg.solve_cg(op, zero, pre, tol=1e-5, max_iter=2000)
    _assert_equal(got, want)
    assert bool((got.x == 0).all()) and bool(got.converged.all())


def test_partly_zero_right_hand_side(cpu_problem, fresh_plans, monkeypatch):
    """Frames with f = 0 iterate beside the others, finite and at x = 0."""
    mesh, g, f = cpu_problem
    op, fd, pre = _system(mesh, g, f, "two_level", torch.float32)
    fd = fd.clone()
    fd[1] = 0
    want = reference_cg(op, fd, pre, 1e-5, 2000)
    _segments_of(monkeypatch, 5)
    got = cg.solve_cg(op, fd, pre, tol=1e-5, max_iter=2000)
    _assert_equal(got, want)
    assert bool((got.x[1] == 0).all())


@pytest.mark.parametrize("precond", PRECONDS)
def test_refined_solve_equals_the_per_iteration_loop(cpu_problem, fresh_plans, monkeypatch,
                                                     precond):
    """The float32 inner solves of the refinement, default segments, against
    the refinement run on the per-iteration loop."""
    mesh, g, f = cpu_problem
    tables = coarse.build_tables(mesh) if precond == "two_level" else None
    kw = dict(tol=1e-10, coarse_tables=tables)
    got = refine.solve_refined(mesh, g, f, **kw)

    class PerIteration:
        def __init__(self, op, pre, precise_dots=False, comm=None):
            self.op, self.pre, self.precise = op, pre, precise_dots

        def solve(self, f, tol=1e-10, max_iter=2000):
            return reference_cg(self.op, f, self.pre, tol, max_iter, self.precise)
    monkeypatch.setattr(refine, "PreparedCG", PerIteration)
    want = refine.solve_refined(mesh, g, f, **kw)
    assert got.outer_steps == want.outer_steps and got.outer_steps > 1
    _assert_equal(got, want)


def _policy(expected, n) -> tuple[int, int]:
    """(reads, iterations run) of `cg._segment`'s segments for a solve of n
    iterations whose counterpart took `expected`."""
    done, reads = 0, 0
    while done < n or reads == 0:
        done += cg._segment(expected, done)
        reads += 1
    return reads, done


def test_default_segments_over_windows(cpu_problem, fresh_plans):
    """Windows of one shape, a PreparedCG each: the first reads from
    FIRST_SEGMENT on, the next start from the previous window's counts,
    solve by solve; every result equal to the per-iteration loop's."""
    mesh, g, f = cpu_problem
    reads, frozen, iters = [], [], []
    for w in range(3):
        # Another window: new factors (a scaled movie), so a new operator.
        op, fd, pre = _system(mesh, g * (1.0 + 0.1 * w), f, "jacobi", torch.float32)
        prepared = cg.PreparedCG(op, pre)
        for tol in (1e-3, 1e-2, 1e-2):
            want = reference_cg(op, fd, pre, tol, 2000)
            with profiling.record() as rec:
                got = prepared.solve(fd, tol=tol, max_iter=2000)
            _assert_equal(got, want)
            counts = rec.summary()["counts"]
            reads.append(counts["sync.solve.cg"])
            frozen.append(counts["solve.frozen_iters"])
            iters.append(got.iterations)
    assert len(set(iters[:3])) > 1
    for w in range(3):
        for i in range(3):
            e, m = (None if w == 0 else iters[3 * (w - 1) + i]), iters[3 * w + i]
            assert (reads[3 * w + i], frozen[3 * w + i] + m) == _policy(e, m)
    assert sum(frozen[3:]) == 0


def test_solve_cg_calls_start_from_the_previous_call(cpu_problem, fresh_plans):
    """solve_cg calls on one key (method='cg' over windows, or many
    right-hand sides on one operator) are windows of one solve: each starts
    from the previous call's count, and the plan keeps one count."""
    mesh, g, f = cpu_problem
    op, fd, pre = _system(mesh, g, f, "two_level", torch.float32)
    iters, reads, frozen = [], [], []
    for c in range(4):
        rhs = fd * (1.0 + 0.5 * c)
        want = reference_cg(op, rhs, pre, 1e-4, 2000)
        with profiling.record() as rec:
            got = cg.solve_cg(op, rhs, pre, tol=1e-4, max_iter=2000)
        _assert_equal(got, want)
        counts = rec.summary()["counts"]
        iters.append(got.iterations)
        reads.append(counts["sync.solve.cg"])
        frozen.append(counts["solve.frozen_iters"])
    for c, m in enumerate(iters):
        assert (reads[c], frozen[c] + m) == _policy(iters[c - 1] if c else None, m)
    (plan,) = cg._PLANS.values()
    assert plan.calls == iters[-1:] and plan.history == iters[-2:-1]


def test_plan_key_and_copies_hold_every_field(cpu_problem):
    """The graphs' copies hold every tensor of the operator and the
    preconditioner, nested fields too, and the key tells apart what a graph
    bakes in beside them."""
    mesh, g, f = cpu_problem
    for precond in PRECONDS:
        op, fd, pre = _system(mesh, g, f, precond, torch.float32)
        inputs = (op, pre)
        copies = cg._empty_like(inputs)
        held = [v for v in vars(op).values() if isinstance(v, torch.Tensor)]
        held += [v for v in op.tiles if isinstance(v, torch.Tensor)]
        held += [pre] if precond == "jacobi" else [
            v for v in vars(pre).values() if isinstance(v, torch.Tensor)]
        srcs, dsts = cg._tensors(inputs), cg._tensors(copies)
        assert len(srcs) == len(held) == len(dsts)
        assert all(any(t is h for t in srcs) for h in held)
        assert all(d.shape == t.shape and d.dtype == t.dtype and d is not t
                   and d.is_contiguous() for d, t in zip(dsts, srcs))
        assert cg._signature(op) == cg._signature(cg._empty_like(op))
        assert cg._signature(op) != cg._signature(dataclasses.replace(op, lambda_=0.5))
        assert cg._signature(op) != cg._signature(op.astype(torch.float64))


def _gate(fn, rr, target, ctl, rz_new):
    ctl, rz = ctl.clone(), torch.full_like(rz_new, 7.0)
    fn(rr, target, ctl, rz_new, rz)
    return ctl, rz


GATE_CASES = {
    # (rr, target, count, max_iter): active?
    "one above": ([1e-6, 4.0, 1e-6], [1.0, 1.0, 1.0], 3, 10),
    "all below": ([0.25, 0.81, 0.0], [1.0, 1.0, 1.0], 3, 10),
    "at the target": ([1.0, 4.0], [1.0, 2.0], 0, 10),
    "at max_iter": ([4.0, 4.0], [1.0, 1.0], 10, 10),
    "NaN below": ([float("nan"), 0.0], [1.0, 1.0], 0, 10),
    "no frames": ([], [], 0, 10),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_gate_is_its_definition(case, dtype):
    rr, target, count, max_iter = GATE_CASES[case]
    rr = torch.tensor(rr, dtype=dtype)
    target = torch.tensor(target, dtype=dtype)
    rz_new = torch.arange(1, rr.shape[0] + 1, dtype=dtype)
    ctl, rz = _gate(kfem.plain_pcg_gate, rr, target,
                    torch.tensor([count, 1, max_iter]), rz_new)
    active = count < max_iter and bool(torch.any(torch.sqrt(rr) > target))
    assert ctl.tolist() == [count + active, int(active), max_iter]
    assert torch.equal(rz, rz_new if active else torch.zeros_like(rz_new))


# ---------------------------------------------------------------- on a GPU
@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def gpu_problem():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return _problem(torch.device("cuda", 0))


@pytest.mark.cuda
@pytest.mark.parametrize("n_frames", [1, 97, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gate_kernel_matches_plain(gpu, dtype, n_frames):
    gen = torch.Generator().manual_seed(n_frames)
    target = torch.rand(n_frames, generator=gen, dtype=torch.float64).to(gpu, dtype)
    rz_new = torch.randn(n_frames, generator=gen, dtype=torch.float64).to(gpu, dtype)
    below = 0.25 * target ** 2
    last_above = torch.where(torch.arange(n_frames, device=gpu) == n_frames - 1,
                             4.0 * target ** 2, below)
    key = f"pcg_gate<{'float' if dtype == torch.float32 else 'double'}>"
    for rr, count, max_iter in ((below, 0, 5), (last_above, 4, 5), (last_above, 5, 5),
                                (target ** 2, 0, 5)):
        ctl = torch.tensor([count, 0, max_iter], device=gpu)
        before = LAUNCHES[key]
        got = _gate(kfem.pcg_gate, rr, target, ctl, rz_new)
        assert LAUNCHES[key] == before + 1
        want = _gate(kfem.plain_pcg_gate, rr, target, ctl, rz_new)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("precond", PRECONDS)
def test_graph_replays_equal_the_uncaptured_loop(gpu_problem, fresh_plans, precond, mode):
    """Three windows of one shape through the graphs (first-window segments,
    then the previous window's counts) against the per-iteration loop on
    the same kernels, and against the uncaptured gated body."""
    mesh, g, f = gpu_problem
    dtype, precise, tol = MODES[mode]
    for w in range(3):
        op, fd, pre = _system(mesh, g * (1.0 + 0.1 * w), f, precond, dtype)
        want = reference_cg(op, fd, pre, tol, 2000, precise)
        got = cg.solve_cg(op, fd, pre, tol=tol, max_iter=2000, precise_dots=precise)
        _assert_equal(got, want)
        lp = cg._new_loop(op, pre, fd, precise, None)
        cg._set(lp, fd, tol, 2000)
        cg._begin(lp)
        cg._iterate(lp, want.iterations + 3)
        assert lp.ctl.tolist() == [want.iterations, 0, 2000]
        assert torch.equal(lp.x, want.x)
        assert torch.equal(torch.sqrt(lp.rr), want.residual)


@pytest.mark.cuda
def test_graph_captures_flat_over_windows(gpu_problem, fresh_plans):
    mesh, g, f = gpu_problem
    captures, replays = [], []
    for w in range(4):
        op, fd, pre = _system(mesh, g * (1.0 + 0.05 * w), f, "two_level", torch.float32)
        with profiling.record() as rec:
            for tol in (1e-3, 1e-2):
                cg.solve_cg(op, fd, pre, tol=tol, max_iter=2000)
        counts = rec.summary()["counts"]
        captures.append(counts.get("solve.graph_captures", 0))
        replays.append(counts["solve.graph_replays"])
    assert captures == [1 + len(cg.GRAPH_LENGTHS), 0, 0, 0]
    assert min(replays) >= 2
    assert len(cg._PLANS) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("precond", PRECONDS)
def test_launches_count_every_launch(gpu_problem, fresh_plans, precond):
    """Replays count the launches their graphs hold, frozen iterations
    included; the capture counts the uncaptured start and iteration it
    runs, and nothing for the graphs it records."""
    mesh, g, f = gpu_problem
    op, fd, pre = _system(mesh, g, f, precond, torch.float32)
    for call in range(3):
        reset_launches()
        with profiling.record() as rec:
            res = cg.PreparedCG(op, pre).solve(fd * (1.0 + call), tol=1e-5, max_iter=2000)
        counts = rec.summary()["counts"]
        warm = 1 if counts.get("solve.graph_captures", 0) else 0
        assert warm == (call == 0)
        run = res.iterations + counts["solve.frozen_iters"] + warm
        starts = 1 + warm
        ran = {k: v for k, v in LAUNCHES.items() if v}
        want = {"fem_matvec<float>": run, "pcg_dot<float>": run + starts,
                "pcg_update<float>": run + starts, "pcg_direction<float>": run,
                "pcg_gate<float>": run + starts}
        if precond == "two_level":
            want.update({f"coarse_{k}<float>": run + starts
                         for k in ("restrict", "gemv", "prolong_dot")})
        assert ran == want


@pytest.mark.cuda
def test_graphs_count_their_iterations(gpu_problem, fresh_plans):
    """Each graph of k iterations holds k iterations' launches."""
    mesh, g, f = gpu_problem
    op, fd, pre = _system(mesh, g, f, "two_level", torch.float32)
    cg.solve_cg(op, fd, pre, tol=1e-5, max_iter=2000)
    (plan,) = cg._PLANS.values()
    one = plan.graphs[1].launches
    assert one == {key: 1 for key in (
        "fem_matvec<float>", "pcg_dot<float>", "pcg_update<float>", "pcg_direction<float>",
        "pcg_gate<float>", "coarse_restrict<float>", "coarse_gemv<float>",
        "coarse_prolong_dot<float>")}
    for k, graph in plan.graphs.items():
        assert graph.launches == {key: k * n for key, n in one.items()}


@pytest.mark.cuda
def test_windows_of_one_key_interleaved(gpu_problem, fresh_plans):
    """Two PreparedCGs of one key, solved in turns: each solve reads its
    own operator and preconditioner, copied into the graphs when the other
    window used them last."""
    mesh, g, f = gpu_problem
    systems = [_system(mesh, g * s, f, "two_level", torch.float32) for s in (1.0, 1.3)]
    prepared = [cg.PreparedCG(op, pre) for op, _, pre in systems]
    for turn in (0, 1, 0, 0, 1):
        op, fd, pre = systems[turn]
        _assert_equal(prepared[turn].solve(fd, tol=1e-5, max_iter=2000),
                      reference_cg(op, fd, pre, 1e-5, 2000))
    assert len(cg._PLANS) == 1


@pytest.mark.cuda
def test_plan_owns_its_slice_workspace(gpu_problem, fresh_plans):
    """The graphs' slice workspace is the plan's, out of the shared pairs
    that later launches on a stream of the same handle would use."""
    from manifold_flow_tpu_torch.kernels import _lib

    mesh, g, f = gpu_problem
    op, fd, pre = _system(mesh, g, f, "jacobi", torch.float32)
    cg.solve_cg(op, fd, pre, tol=1e-5, max_iter=2000)
    (plan,) = cg._PLANS.values()
    part, ticket = plan.workspace
    assert all(part is not ws[0] and ticket is not ws[1]
               for ws in _lib._SLICE_WORKSPACE.values())
    assert bool((ticket == 0).all())
