"""The readers of the port's span records (timings 'trace' of the velocity
and singularity stages) on a synthetic run: their values from the records,
and nothing where the stages keep no record, as on a port without them."""

from __future__ import annotations

import pytest

from conftest import REPO

from flowbench import harness

READERS = ("solve.host_syncs", "solve.inner_iters_total", "solve.sync_wait_ms",
           "solve.host_us_per_iter", "stages.trial.analysis_wait_ms")


def _span(count, total_s, self_s=None):
    return {"count": count, "total_s": total_s,
            "self_s": total_s if self_s is None else self_s}


def _velocity(iters, cg_calls, cg_s, wait_s, refine_tests, zeroed):
    """A velocity stage's timings with a record: `cg_calls` solve_cg calls of
    `iters` inner iterations in all, each loop test a sync.solve.cg wait."""
    syncs = iters + cg_calls
    return {"dispatch": 0.1, "artifact_starts": 0.0, "solve_wait": 0.01,
            "artifact_submits": 0.0,
            "trace": {"spans": {"solve.window": _span(4, 0.2, 0.01),
                                "solve.cg": _span(cg_calls, cg_s, cg_s - wait_s),
                                "sync.solve.cg": _span(syncs, wait_s),
                                "sync.solve.refine": _span(refine_tests, 0.002),
                                "sync.solve.zeroed": _span(zeroed, 0.001)},
                      "counts": {"solve.inner_iters": iters, "sync.solve.cg": syncs,
                                 "sync.solve.refine": refine_tests,
                                 "sync.solve.zeroed": zeroed, "solve.outer_steps": 8,
                                 "sync.velocity.flags": 1}}}


def _singularities(counts_s, codes_s, rows_s):
    return {"detect": 0.004, "classify": 0.006,
            "trace": {"spans": {"analysis.detect": _span(1, 0.001),
                                "sync.analysis.counts": _span(1, counts_s),
                                "sync.analysis.codes": _span(2, codes_s),
                                "analysis.labels": _span(1, 0.0005),
                                "sync.analysis.rows": _span(1, rows_s)},
                      "counts": {"sync.analysis.counts": 1, "sync.analysis.codes": 2,
                                 "sync.analysis.rows": 1}}}


def _run(timings):
    return harness.Run(cell=None, shapes={}, timings=timings, iterations=[90] * len(timings))


def _read(name, run):
    return harness.load_reader(REPO, name)(run)


@pytest.fixture
def traced():
    return _run([
        {"velocity": _velocity(340, 8, 0.150, 0.060, 12, 4),
         "singularities": _singularities(0.002, 0.003, 0.001)},
        {"velocity": _velocity(360, 8, 0.170, 0.080, 12, 4),
         "singularities": _singularities(0.004, 0.003, 0.001)},
    ])


@pytest.mark.parametrize("name,want", [
    ("solve.host_syncs", ((340 + 8 + 12 + 4) + (360 + 8 + 12 + 4)) / 2),
    ("solve.inner_iters_total", 350.0),
    ("solve.sync_wait_ms", ((0.060 + 0.003) + (0.080 + 0.003)) / 2 * 1e3),
    ("solve.host_us_per_iter", ((0.150 - 0.060) / 340 + (0.170 - 0.080) / 360) / 2 * 1e6),
    ("stages.trial.analysis_wait_ms", ((0.002 + 0.003 + 0.001) + (0.004 + 0.003 + 0.001))
     / 2 * 1e3),
])
def test_readers_take_the_mean_over_the_trials(traced, name, want):
    assert _read(name, traced) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_readers_say_nothing_without_a_record(name):
    """A run of a port whose stages keep no record, and a window with no
    completed trial."""
    parent = _run([{"velocity": {"dispatch": 0.1, "artifact_starts": 0.0,
                                 "solve_wait": 0.01, "artifact_submits": 0.0},
                    "singularities": {"detect": 0.004, "classify": 0.006}}])
    assert _read(name, parent) is None
    assert _read(name, _run([])) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_is_a_metric_of_the_trial_cell(name):
    bench = harness.load_json(REPO / "BENCHMARK.json")
    (metric,) = [m for m in bench["per_layer"] if m["name"] == name]
    assert metric["workloads"] == ["patch12k.trial"]
    assert metric["moves"] == "trial_frames_per_s"
