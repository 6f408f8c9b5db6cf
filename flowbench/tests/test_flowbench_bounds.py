"""The roofline counts depend on shapes and counts alone, and the trace
reduction attributes device time to the host range that launched it."""

from __future__ import annotations

import pytest

from flowbench import bounds, peaks, traces

SHAPES = {"solve_window": 104, "n_vertices": 12544, "n_cells": 24642, "two_level": True,
          "n_coarse": 197, "frames": 391, "velocity_frames": 390, "n_electrodes": 64,
          "n_samples": 10240}


def test_solve_bound_is_linear_in_the_counts():
    one = bounds.solve_bound_s(SHAPES, 1, 0)
    assert bounds.solve_bound_s(SHAPES, 7, 0) == pytest.approx(7 * one)
    assert bounds.solve_bound_s(SHAPES, 7, 3) == pytest.approx(
        7 * one + 3 * bounds.solve_residual_bytes(SHAPES) / peaks.HBM_BYTES_S)
    jacobi = dict(SHAPES, two_level=False)
    assert bounds.solve_bound_s(jacobi, 1, 0) < one


def test_solve_iteration_bytes_by_hand():
    t, n, m, nc = 104, 12544, 24642, 2 * 197
    want = (t * m * 24 + m * 12 + m * 84 + t * n * 12 + 6 * t * 2 * n * 4
            + t * nc * (nc + 1) // 2 * 4 + n * 4 + n * 16)
    assert bounds.solve_iteration_bytes(SHAPES) == want


def test_fields_bound_grows_with_the_stages_and_the_surface():
    base = bounds.fields_bound_s(SHAPES, ["interpolate"])
    more = bounds.fields_bound_s(SHAPES, ["interpolate", "interpolate_phases", "decompose",
                                          "wavespeed"])
    assert 0 < base < more
    bigger = dict(SHAPES, n_vertices=2 * SHAPES["n_vertices"])
    assert bounds.fields_bound_s(bigger, ["decompose"]) > bounds.fields_bound_s(SHAPES, ["decompose"])


def test_svd_and_hilbert_bounds_are_chip_smokes():
    ms, by, nbytes, ops = peaks.svd_bound((390, 25088), 8)
    assert by == "operations" and ops == 9 * 390 ** 3 + 4 * 390 ** 2 * 25088
    assert nbytes == (2 * 390 * 25088 + 390 * 390) * 8 + 390 * 8
    ms, by, nbytes, _ = peaks.hilbert_bound((10240, 64), 8)
    assert nbytes == 10240 * 64 * 24


def _ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_reduction():
    events = [
        _ev("request", "user_annotation", 0, 100),
        _ev("request/solve", "user_annotation", 0, 60),
        _ev("request/svd", "user_annotation", 60, 40),
        _ev("cudaLaunchKernel", "cuda_runtime", 5, 1, corr=1),
        _ev("cudaLaunchKernel", "cuda_runtime", 65, 1, corr=2),
        _ev("fem", "kernel", 10, 20, corr=1),
        _ev("svd", "kernel", 70, 10, corr=2),
        _ev("copy", "gpu_memcpy", 75, 10, corr=2),
    ]
    tr = traces.reduce_trace(events)
    assert tr.window_s == pytest.approx(100e-6) and tr.n_requests == 1
    assert tr.busy_s == pytest.approx(35e-6)
    assert tr.device_s("request/solve") == pytest.approx(20e-6)
    assert tr.device_s("request/svd") == pytest.approx(20e-6)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["fem", pytest.approx(20e-6)]
    assert b["idle_gaps"][0] == ["request/solve", pytest.approx(40e-6)]
