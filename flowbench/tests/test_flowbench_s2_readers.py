"""The readers of S2's device work (stages.trial.s2_fit_ms,
kernels.s2_roofline) on a synthetic traced run: their values from the
trace's operations and ranges, and nothing where the trace holds none."""

from __future__ import annotations

import pytest

from conftest import REPO

from flowbench import bounds, harness, traces

SHAPES = {"frames": 391, "velocity_frames": 390, "n_vertices": 15957, "n_cells": 31808,
          "n_electrodes": 256, "n_samples": 10240}
FIT = "void mf::rbf_fit_kernel<double, false>(double const*, double const*)"
EVAL = "void mf::rbf_eval_kernel<double, true, 7>(double const*, double const*)"


def _trace(n_requests, ops):
    """`n_requests` request ranges of 10 ms, each with a 'request/s2' range
    in its first 4 ms and a 'request/solve' range after it; `ops` are
    (name, range, dur us), each launched in every request."""
    ranges, out = [], []
    for i in range(n_requests):
        t0 = 1e4 * i
        ranges += [("request", t0, t0 + 1e4), ("request/s2", t0, t0 + 4e3),
                   ("request/solve", t0 + 4e3, t0 + 1e4)]
        out += [traces.Op(name, t0 + 10.0 * k, dur, rng)
                for k, (name, rng, dur) in enumerate(ops)]
    return traces.Trace(out, (0.0, 1e4 * n_requests), ranges)


def _run(trace):
    return harness.Run(cell=None, shapes=dict(SHAPES), trace=trace)


def _read(name, run):
    return harness.load_reader(REPO, name)(run)


OPS = [(FIT, "request/s2", 300.0), (FIT, "request/s2", 500.0), (EVAL, "request/s2", 200.0),
       ("void fft_kernel", "request/s2", 100.0), ("pcg_update", "request/solve", 900.0)]


def test_s2_fit_ms_sums_the_fit_kernels_a_request():
    assert _read("stages.trial.s2_fit_ms", _run(_trace(3, OPS))) == pytest.approx(0.8)


def test_s2_roofline_is_the_bound_over_the_s2_device_time():
    want = 100.0 * bounds.fields_bound_s(SHAPES, ["interpolate", "interpolate_phases"]) / 1.1e-3
    got = _read("kernels.s2_roofline", _run(_trace(2, OPS)))
    assert got == pytest.approx(want) and 0.0 < got < 100.0


@pytest.mark.parametrize("name", ["stages.trial.s2_fit_ms", "kernels.s2_roofline"])
def test_s2_readers_say_nothing_without_s2_work(name):
    """No trace (a run at --trace 0), no request, or no S2 operation."""
    assert _read(name, _run(None)) is None
    assert _read(name, _run(_trace(0, OPS))) is None
    assert _read(name, _run(_trace(2, [("pcg_update", "request/solve", 900.0)]))) is None


@pytest.mark.parametrize("name", ["stages.trial.s2_fit_ms", "kernels.s2_roofline"])
def test_each_s2_reader_is_a_metric_of_every_trial_cell(name):
    bench = harness.load_json(REPO / "BENCHMARK.json")
    (metric,) = [m for m in bench["per_layer"] if m["name"] == name]
    trials = [w["name"] for w in bench["workloads"] if w["traffic"] == "trial"]
    assert metric["workloads"] == trials and metric["source"] == "device_trace"
    assert metric["moves"] == "trial_frames_per_s"
