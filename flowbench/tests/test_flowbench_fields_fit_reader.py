"""The reader of S2's fit in a field request (stages.fields.s2_fit_ms) on a
synthetic traced run: K17's fit in the 'request/s2' ranges, a request's
mean, and nothing where the trace holds no fit."""

from __future__ import annotations

import pytest

from conftest import REPO

from flowbench import harness, traces

SHAPES = {"frames": 391, "velocity_frames": 390, "n_vertices": 65081, "n_cells": 130048,
          "n_electrodes": 1024, "n_samples": 10240}
FIT = "void mf::rbf_fit_kernel<double, true>(double const*, double const*)"
EVAL = "void mf::rbf_eval_kernel<double, true, 7>(double const*, double const*)"
NAME = "stages.fields.s2_fit_ms"


def _trace(n_requests, ops):
    """`n_requests` request ranges of 10 ms, each with a 'request/s2' range
    in its first 4 ms and a 'request/svd' range after it; `ops` are
    (name, range, dur us), each launched in every request."""
    ranges, out = [], []
    for i in range(n_requests):
        t0 = 1e4 * i
        ranges += [("request", t0, t0 + 1e4), ("request/s2", t0, t0 + 4e3),
                   ("request/svd", t0 + 4e3, t0 + 1e4)]
        out += [traces.Op(name, t0 + 10.0 * k, dur, rng)
                for k, (name, rng, dur) in enumerate(ops)]
    return traces.Trace(out, (0.0, 1e4 * n_requests), ranges)


def _read(trace):
    return harness.load_reader(REPO, NAME)(harness.Run(cell=None, shapes=dict(SHAPES),
                                                       trace=trace))


OPS = [(FIT, "request/s2", 300.0), (FIT, "request/s2", 500.0), (EVAL, "request/s2", 200.0),
       ("void fft_kernel", "request/s2", 100.0), ("jacobi_svd_kernel", "request/svd", 900.0)]


def test_fields_s2_fit_ms_sums_the_fit_kernels_launched_in_s2():
    """A fit kernel launched outside 'request/s2' is not S2's, and the
    other S2 operations are not the fit's."""
    ops = OPS + [(FIT, "request/svd", 700.0)]
    assert _read(_trace(3, ops)) == pytest.approx(0.8)


@pytest.mark.parametrize("case", ["untraced", "no_request", "no_fit"])
def test_fields_s2_fit_ms_says_nothing_without_a_fit(case):
    """No trace (a run at --trace 0), no request, or no fit operation."""
    trace = {"untraced": None, "no_request": _trace(0, OPS),
             "no_fit": _trace(2, [op for op in OPS if op[0] != FIT])}[case]
    assert _read(trace) is None


def test_fields_s2_fit_is_a_metric_of_the_fields_cells():
    bench = harness.load_json(REPO / "BENCHMARK.json")
    (metric,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    fields = [w["name"] for w in bench["workloads"] if w["traffic"] == "fields"]
    assert metric["workloads"] == fields and metric["source"] == "device_trace"
    assert metric["moves"] == "fields_frames_per_s" and metric["layer"] == "stages"
