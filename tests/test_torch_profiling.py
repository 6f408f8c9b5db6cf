"""utils.profiling of the PyTorch port held against the JAX package's:
the same spans and timers give the same report keys and counts, and
frames_per_second and trace run on CPU tensors (the profiler records the
CPU activity alone where there is no GPU)."""

import json
import logging
import time
from typing import NamedTuple

import pytest
import torch

from manifold_flow_tpu.utils import profiling as jax_profiling
from manifold_flow_tpu_torch.kernels import _lib
from manifold_flow_tpu_torch.kernels import fem as kfem
from manifold_flow_tpu_torch.utils import profiling


def _drive(mod):
    """One sequence of spans and timers through `mod`; its report and the
    timer's count and mean."""
    mod.reset()
    for name in ("solve", "detect", "solve", "write", "solve"):
        with mod.span(name):
            pass
    with pytest.raises(RuntimeError):
        with mod.span("failed"):
            raise RuntimeError("the span still closes")
    timer = mod.Timer("t")
    for _ in range(3):
        with timer:
            pass
    report = mod.report()
    mod.reset()
    return report, timer


def test_spans_and_timers_match_jax():
    got, timer = _drive(profiling)
    want, jax_timer = _drive(jax_profiling)
    assert set(got) == set(want) == {"solve", "detect", "write", "failed"}
    for name, entry in got.items():
        assert set(entry) == set(want[name]) == {"count", "total_s", "mean_s"}
        assert entry["count"] == want[name]["count"]
        assert entry["mean_s"] == pytest.approx(entry["total_s"] / entry["count"])
        assert entry["total_s"] >= 0.0
    assert got["solve"]["count"] == 3
    assert (timer.name, timer.count) == (jax_timer.name, jax_timer.count) == ("t", 3)
    assert timer.mean_s == pytest.approx(timer.total_s / 3)
    assert profiling.Timer().mean_s == jax_profiling.Timer().mean_s == 0.0
    assert profiling.report() == {}


def test_span_logs_when_asked(caplog):
    with caplog.at_level(logging.INFO, logger="manifold_flow_tpu_torch"):
        with profiling.span("logged", log=True):
            pass
    assert any(r.getMessage().startswith("logged: ") for r in caplog.records)
    profiling.reset()


class _Pair(NamedTuple):
    a: torch.Tensor
    b: list


def test_frames_per_second_warms_up_once_then_takes_the_best(monkeypatch):
    """fn runs repeats + 1 times (one warm-up); results with CPU tensors,
    NamedTuples and lists included, are not waited for on any device."""
    calls = []

    def fn(x):
        calls.append(x)
        time.sleep(0.002)
        return _Pair(torch.zeros(2), [torch.ones(1), {"k": torch.ones(1)}])

    def no_sync(*args):
        raise AssertionError("CPU tensors need no device wait")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    fps = profiling.frames_per_second(97, fn, 7, repeats=4)
    assert calls == [7] * 5
    assert 0 < fps <= 97 / 0.002


def test_trace_writes_a_chrome_trace_of_cpu_work(tmp_path):
    """A trace of the plain K3 dot on CPU tensors: one JSON file in
    log_dir naming the work; no launch is recorded (nothing ran on a GPU).
    Launches are named only inside the trace."""
    a = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert not _lib._NAMED_LAUNCHES
    with profiling.trace(str(tmp_path / "trace")) as prof:
        assert _lib._NAMED_LAUNCHES  # launches would sit in named host ranges
        kfem.pcg_dot(a, a)
    assert not _lib._NAMED_LAUNCHES
    (path,) = (tmp_path / "trace").iterdir()
    assert path.name.startswith("trace_") and path.suffix == ".json"
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert any(str(n).startswith("aten::") for n in names)
    assert not any(str(n).startswith("pcg_dot<") for n in names)
    assert any(e.key.startswith("aten::") for e in prof.key_averages())
