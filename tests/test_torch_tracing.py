"""The port's spans and counts (utils.profiling) inside the solve and the
stages: what a record() scope sums, how its spans nest, that they cost no
profiler range when nothing records, and that they lie on a profiler's
timeline with the block's first events.

This file imports no JAX; its `cuda` case runs on a machine with a GPU as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""

import collections
import json

import numpy as np
import pytest
import torch

from manifold_flow_tpu_torch.geometry import synthetic
from manifold_flow_tpu_torch.pipeline import stages
from manifold_flow_tpu_torch.pipeline.config import PipelineConfig
from manifold_flow_tpu_torch.solve import api, cg
from manifold_flow_tpu_torch.utils import profiling

# A 9-frame movie (8 velocity frames) in two windows of 4.
CHUNK = 4


def _problem(device="cpu"):
    mesh = synthetic.plane_patch(nx=12, ny=12, lx=8.0, ly=8.0,
                                 height=lambda x, y: 0.4 * np.sin(x) * np.cos(y),
                                 device=device)
    pot, times, _ = synthetic.two_source_movie(mesh, sources=((2.0, 2.0), (6.0, 6.0)),
                                               n_frames=2 * CHUNK + 1)
    return mesh, pot, times


@pytest.fixture(scope="module")
def problem():
    return _problem()


@pytest.fixture
def two_windows(monkeypatch):
    """frame_chunk='auto' (the velocity stage's) cuts the 8 velocity frames
    into two windows of CHUNK."""
    monkeypatch.setattr(api, "FRAME_CHUNK_SIZE", CHUNK)
    monkeypatch.setattr(api, "FRAME_CHUNK_AUTO_MIN", CHUNK)


def _config(method):
    cfg = PipelineConfig()
    cfg.solver.method = method
    cfg.solver.tol = 1e-10
    return cfg


def _window_iterations(mesh, pot, times, method, precond):
    """compute_velocity_fields' iterations on each window of the chunked
    solve, solved alone."""
    t_v = pot.shape[0] - 1
    iters = []
    for j in range(-(-t_v // CHUNK)):
        start = min(j * CHUNK, t_v - CHUNK)
        iters.append(api.compute_velocity_fields(
            mesh, pot[start: start + CHUNK + 1], times[start: start + CHUNK + 1],
            method=method, tol=1e-10, precond=precond, frame_chunk=None).iterations)
    return iters


def _spy_calls(monkeypatch) -> list:
    """Record (window, iterations) of every inner solve the solve makes,
    from empty plans (solve.cg's counts by key): the window is the
    solve.cg.PreparedCG, one a refine_loop call or a solve_cg call."""
    monkeypatch.setattr(cg, "_PLANS", collections.OrderedDict())
    calls = []
    solve = cg.PreparedCG.solve

    def spy(self, *args, **kwargs):
        res = solve(self, *args, **kwargs)
        calls.append((self, res.iterations))
        return res
    monkeypatch.setattr(cg.PreparedCG, "solve", spy)
    return calls


def _reads(calls) -> tuple[int, int]:
    """(reads, iterations run) of solve_cg's loop over `calls`, one key:
    each solve's segments (`cg._segment`) from the count of the same solve
    in the previous window, until a segment reaches the solve's iterations;
    one read a segment."""
    history, current, window = [], [], None
    reads = run = 0
    for prepared, n in calls:
        if prepared is not window:
            history, current, window = current or history, [], prepared
        expected = history[len(current)] if len(current) < len(history) else None
        done = 0
        while True:
            done += cg._segment(expected, done)
            reads += 1
            if done >= n:
                break
        run += done
        current.append(n)
    return reads, run


@pytest.mark.parametrize("method,precond", [("refined", "jacobi"),
                                            ("refined", "two_level"),
                                            ("cg", "two_level")])
def test_velocity_stage_record_sums_the_windows(problem, two_windows, monkeypatch,
                                                method, precond):
    mesh, pot, times = problem
    if precond == "two_level":
        monkeypatch.setattr(api, "TWO_LEVEL_MIN_VERTICES", 0)
    spied = _spy_calls(monkeypatch)
    with profiling.record() as rec:
        vel = stages.velocity_stage(mesh, pot, times, _config(method))
    calls = list(spied)
    assert vel.converged
    summary = rec.summary()
    spans, counts = summary["spans"], summary["counts"]
    inner = counts["solve.inner_iters"]
    assert inner == sum(_window_iterations(mesh, pot, times, method, precond))
    assert inner >= vel.iterations
    assert spans["solve.window"]["count"] == 2
    # One read a segment of gated iterations: the count the policy gives
    # for these calls, each of its segments run whole.
    assert len(calls) == spans["solve.cg"]["count"]
    assert inner == sum(n for _, n in calls)
    reads, run = _reads(calls)
    assert counts["sync.solve.cg"] == reads
    assert counts["solve.frozen_iters"] == run - inner
    assert spans["sync.solve.cg"]["count"] == counts["sync.solve.cg"]
    assert counts.get("sync.solve.zeroed", 0) == (2 if precond == "two_level" else 0)
    if method == "refined":
        # Each window's refine loop tests |f - A x| once a step and once more.
        assert counts["sync.solve.refine"] == counts["solve.outer_steps"] + 2
        assert spans["solve.refine_step"]["count"] == counts["solve.outer_steps"]
        assert spans["solve.cg"]["count"] == counts["solve.outer_steps"]
    else:
        assert "sync.solve.refine" not in counts and spans["solve.cg"]["count"] == 2
    assert counts["sync.velocity.flags"] == 1
    assert spans["velocity.recombine"]["count"] == 1
    for name, s in spans.items():
        assert 0.0 <= s["self_s"] <= s["total_s"], name
    # Every span lies within its parent; the loop's waits inside solve.cg,
    # every solve.cg inside a solve.window.
    by_slot = rec.spans
    for name, parent, t0, t1 in by_slot:
        assert t0 <= t1, name
        if parent >= 0:
            _, _, p0, p1 = by_slot[parent]
            assert p0 <= t0 and t1 <= p1, (name, by_slot[parent][0])

    def ancestors(slot):
        while slot >= 0:
            slot = by_slot[slot][1]
            if slot >= 0:
                yield by_slot[slot][0]
    for slot, (name, parent, _, _) in enumerate(by_slot):
        if name == "sync.solve.cg":
            assert by_slot[parent][0] == "solve.cg"
        if name == "solve.cg":
            assert "solve.window" in set(ancestors(slot))


def test_stage_timings_carry_the_record(problem, two_windows):
    """A stage given `timings` leaves its record there; one dict handed to
    two stages holds the sum of both records."""
    mesh, pot, times = problem
    cfg = _config("refined")
    timings: dict = {}
    vel = stages.velocity_stage(mesh, pot, times, cfg, timings=timings)
    first = timings["trace"]
    assert first["counts"]["solve.inner_iters"] >= vel.iterations
    stages.singularity_stage(mesh, vel.v_world, cfg, classify=True, timings=timings)
    both = timings["trace"]
    assert both["spans"]["solve.window"] == first["spans"]["solve.window"]
    assert both["counts"]["sync.analysis.codes"] == 2
    for name in ("analysis.detect", "analysis.compact", "analysis.classify",
                 "analysis.labels", "analysis.rows", "sync.analysis.rows"):
        assert both["spans"][name]["count"] == 1, name
    modes: dict = {}
    stages.decompose_stage(vel.v_k, cfg, timings=modes, device="cpu")
    assert modes["trace"]["spans"]["svd.library"]["count"] == 1


def test_spans_enter_no_profiler_range_when_nothing_records(problem, monkeypatch):
    """With no record() scope and no profiler a span enters no
    record_function; its time still reaches the registry."""
    def no_range(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", no_range)
    mesh, pot, times = problem
    profiling.reset()
    cfg = _config("refined")
    vel = stages.velocity_stage(mesh, pot, times, cfg)
    stages.singularity_stage(mesh, vel.v_world, cfg, classify=True)
    stages.decompose_stage(vel.v_k, cfg, device="cpu")
    report, counts = profiling.report(), profiling.counts()
    profiling.reset()
    assert report["solve.window"]["count"] == 1 and report["svd.library"]["count"] == 1
    assert counts["sync.solve.cg"] == report["sync.solve.cg"]["count"]
    assert counts["solve.inner_iters"] >= vel.iterations


def test_registry_keeps_a_count_and_a_total_a_name():
    profiling.reset()
    for _ in range(1000):
        with profiling.span("tiny"):
            pass
    profiling.count("things", 3)
    profiling.count("things")
    assert len(profiling._REGISTRY["tiny"]) == 2
    (entry,) = profiling.report().values()
    assert entry["count"] == 1000
    assert entry["mean_s"] == pytest.approx(entry["total_s"] / 1000)
    assert profiling.counts() == {"things": 4}
    profiling.reset()
    assert profiling.report() == {} and profiling.counts() == {}


def test_worker_threads_add_nothing_to_a_record():
    import threading

    def elsewhere():
        with profiling.span("elsewhere"):
            profiling.count("elsewhere")

    with profiling.record() as rec:
        worker = threading.Thread(target=elsewhere)
        worker.start()
        worker.join(timeout=10)
        with profiling.wait("sync.here"):
            pass
    assert not worker.is_alive()
    assert set(rec.summary()["spans"]) == {"sync.here"}
    assert rec.summary()["counts"] == {"sync.here": 1}


def _events(log_dir):
    (path,) = log_dir.iterdir()
    return [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]


def _within(inner, outer):
    return outer["ts"] <= inner["ts"] and (inner["ts"] + inner["dur"]
                                           <= outer["ts"] + outer["dur"])


def test_spans_lie_on_the_profiler_timeline(problem, two_windows, tmp_path):
    mesh, pot, times = problem
    with profiling.trace(str(tmp_path)):
        api.compute_velocity_fields(mesh, pot, times, method="refined", tol=1e-10)
    ranges = [e for e in _events(tmp_path) if e.get("cat") == "user_annotation"]
    windows = [e for e in ranges if e["name"] == "solve.window"]
    assert len(windows) == 2
    for name in ("solve.cg", "sync.solve.cg", "solve.refine_step", "solve.residual"):
        mine = [e for e in ranges if e["name"] == name]
        assert mine, name
        assert all(any(_within(e, w) for w in windows) for e in mine), name


@pytest.fixture
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device(request.param)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)],
                         indirect=True)
def test_trace_drops_its_warm_up_step_and_keeps_the_first_events(device, tmp_path):
    """profiling.trace's warm-up step is dropped: the trace holds the
    block's first span, on CUDA its first launch (K4) and that launch's
    kernel, and no event from before the block."""
    mesh, pot, times = _problem(device)
    solve = dict(method="refined" if device.type == "cuda" else "cg", tol=1e-8)
    api.compute_velocity_fields(mesh, pot, times, **solve)  # kernels built
    with profiling.trace(str(tmp_path)):
        api.compute_velocity_fields(mesh, pot, times, **solve)
    events = _events(tmp_path)
    names = [e["name"] for e in events]
    assert "ProfilerStep#0" not in names
    (step,) = [e for e in events if e["name"] == "ProfilerStep#1"]
    host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")]
    assert all(_within(e, step) for e in host if e is not step)
    spans = sorted((e for e in host if e.get("cat") == "user_annotation" and e is not step),
                   key=lambda e: e["ts"])
    assert spans[0]["name"] == "solve.window"
    if device.type == "cuda":
        assert "frame_factors_rhs<double>" in names
        assert any("frame_factors_rhs" in e["name"] for e in events
                   if e.get("cat") == "kernel")


def _electrodes(mesh, n=16, n_samples=300, seed=5):
    rng = np.random.default_rng(seed)
    coords = mesh.points.numpy()[rng.choice(mesh.n_vertices, n, replace=False)]
    t = np.arange(n_samples)[:, None] / 128.0
    movie = np.cos(2 * np.pi * (8.0 * t - coords[None, :, 0] / 4.0))
    return coords, movie + 0.1 * rng.standard_normal(movie.shape)


@pytest.mark.parametrize("phases", [False, True], ids=["amplitude", "phases"])
def test_interpolate_stage_records_its_spans(problem, phases):
    """S2 given `timings` leaves its record: one `s2.fit` and one `s2.eval`,
    and for phases one `s2.hilbert`; on CPU tensors the fit takes no
    workspace, so `s2.fit_workspace` is not counted."""
    mesh = problem[0]
    coords, movie = _electrodes(mesh)
    timings: dict = {}
    stages.interpolate_stage(mesh, coords, movie, PipelineConfig(), sfreq=128.0,
                             phases=phases, timings=timings)
    rec = timings["trace"]
    want = {"s2.fit", "s2.eval"} | ({"s2.hilbert"} if phases else set())
    assert set(rec["spans"]) == want
    assert all(rec["spans"][name]["count"] == 1 for name in want)
    assert "s2.fit_workspace" not in rec["counts"]


def test_interpolate_spans_lie_on_the_profiler_timeline(problem, tmp_path):
    """Under a profiler the S2 spans are host ranges inside the traced step,
    in their order: the Hilbert transform, the fit, the evaluation."""
    mesh = problem[0]
    coords, movie = _electrodes(mesh)
    with profiling.trace(str(tmp_path)):
        stages.interpolate_stage(mesh, coords, movie, PipelineConfig(), sfreq=128.0,
                                 phases=True)
    events = _events(tmp_path)
    (step,) = [e for e in events if e["name"] == "ProfilerStep#1"]
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("s2."):
            assert e["name"] not in ranges, e["name"]
            ranges[e["name"]] = e
    assert set(ranges) == {"s2.hilbert", "s2.fit", "s2.eval"}
    assert all(_within(e, step) for e in ranges.values())
    hilbert, fit, ev = ranges["s2.hilbert"], ranges["s2.fit"], ranges["s2.eval"]
    assert hilbert["ts"] + hilbert["dur"] <= fit["ts"] and fit["ts"] + fit["dur"] <= ev["ts"]


def test_velocity_stage_counts_the_cells_k1s_tiles_list():
    """Each operator build counts the cells K1's tiles list
    (`solve.tile_cells`) and the mesh's (`solve.cells`). On S1's surface of
    the benchmark's 8 x 8 grid the solve's renumbered mesh lists under 1.3x
    the cells (2.3x in the surface's own order)."""
    from pathlib import Path

    from flowbench import inputs
    from manifold_flow_tpu_torch.geometry.mesh import build_mesh

    config = json.loads((Path(__file__).resolve().parent.parent / "flowbench" / "configs"
                         / "recon3k.json").read_text())
    points, tris, _ = inputs.surface_and_electrodes(config)
    mesh = build_mesh(points, tris, device="cpu")
    p = mesh.points.numpy()
    t = np.arange(3) / 512.0
    pot = torch.tensor(np.sin(0.3 * p[None, :, 0] - 40.0 * t[:, None]))
    timings: dict = {}
    stages.velocity_stage(mesh, pot, torch.tensor(t), _config("cg"), timings=timings)
    counts = timings["trace"]["counts"]
    assert counts["solve.cells"] == mesh.n_triangles
    assert counts["solve.tile_cells"] / counts["solve.cells"] < 1.3
