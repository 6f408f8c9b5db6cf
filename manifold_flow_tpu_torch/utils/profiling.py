"""Tracing, timing and metrics.

Counterpart of manifold_flow_tpu/utils/profiling.py, with the same names and
semantics, and the port's own spans and counts:

  * `span(name)` / `Timer`: wall-clock spans with a process-wide registry;
    `report()` returns {name: {count, total_s, mean_s}}, `reset()` clears it.
    The registry keeps a count and a total a name, however many spans close.
  * `count(name, n)` adds to a named count (`counts()` reads the registry's);
    `wait(name)` is a span and a count of 1 around a blocking device-to-host
    read (names `sync.<layer>.<what>`). `count_device(name, t)` is a count
    whose value lies on the device: the active `record()` scope keeps the
    tensor and reads it in `summary()` (a wait), which a stage takes after
    it has synchronised; outside a scope nothing is kept or read.
  * `record()`: a scope in which every span and count of the current context
    (not of other threads) is also kept, each span with its parent and its
    start and end on `time.perf_counter_ns`'s clock; `summary()` gives
    {"spans": {name: {count, total_s, self_s}}, "counts": {name: n}}, where
    self_s is the span's time less the time its child spans cover.
  * While a torch profiler records, each span is also a host range of that
    name (`record_function`) on the trace's timeline, so the device work
    launched inside it, and the device's idle gaps, can be charged to it.
    With no scope and no profiler a span costs a check of each and two clock
    reads.
  * `trace(log_dir)`: a `torch.profiler` trace (CPU activity, and CUDA
    activity where a GPU is present) written into `log_dir` as a Chrome
    trace. Every kernel launch in it sits inside a host range named after
    its `kernels.LAUNCHES` key ("fem_matvec<float>", ...), the device
    kernel under it (the profiler draws the range on the device timeline
    too: a sum of device times over all its events counts the kernel
    twice); the PCG loop's kernels replayed from CUDA graphs (solve.cg)
    sit under the replay's `cudaGraphLaunch` instead.
  * `frames_per_second(n_frames, fn, *args)`: best-of-k frames/s of a call
    after one warm-up call, each call waited for on the devices of the CUDA
    tensors it returns.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

logger = logging.getLogger("manifold_flow_tpu_torch")

# name -> [count, total seconds] of the spans; name -> n of the counts.
_REGISTRY: dict[str, list] = {}
_COUNTS: dict[str, int] = {}
_LOCK = threading.Lock()
# The record() scope of the current context, or None. A new thread starts
# with the default, so worker threads never add to a stage's record.
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "manifold_flow_tpu_torch.profiling.record", default=None)
# torch's own flag of a running profiler, a module attribute that it keeps
# for fast checks from Python: one attribute read a span.
_TORCH_PROFILER = torch.autograd.profiler


class span:
    """Time a code span: `with span(name): ...`. Its seconds accumulate in
    the process registry, it joins the active `record()` scope, and while a
    torch profiler records it is a host range named `name`."""

    __slots__ = ("name", "log", "_t0", "_rec", "_slot", "_range")
    _counted = False  # a wait also counts itself

    def __init__(self, name: str, log: bool = False):
        self.name = name
        self.log = log

    def __enter__(self):
        if _TORCH_PROFILER._is_profiler_enabled:
            self._range = _TORCH_PROFILER.record_function(self.name)
            self._range.__enter__()
        else:
            self._range = None
        self._rec = rec = _ACTIVE.get()
        self._t0 = t0 = time.perf_counter_ns()
        if rec is not None:
            self._slot = rec._open(self.name, t0)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        name = self.name
        rec = self._rec
        if rec is not None:
            rec._close(self._slot, t1)
            if self._counted:
                rec.counts[name] = rec.counts.get(name, 0) + 1
        if self._range is not None:
            self._range.__exit__(*exc)
        dt = (t1 - self._t0) * 1e-9
        with _LOCK:
            entry = _REGISTRY.get(name)
            if entry is None:
                _REGISTRY[name] = [1, dt]
            else:
                entry[0] += 1
                entry[1] += dt
            if self._counted:
                _COUNTS[name] = _COUNTS.get(name, 0) + 1
        if self.log:
            logger.info("%s: %.3f s", name, dt)
        return False


def count(name: str, n: int = 1) -> None:
    """Add `n` to the count `name`, in the registry and the active scope."""
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n
    rec = _ACTIVE.get()
    if rec is not None:
        rec.counts[name] = rec.counts.get(name, 0) + n


def count_device(name: str, value: torch.Tensor) -> None:
    """Add the device integer `value` to the active scope's count `name`
    when its summary is taken; no read here, and none outside a scope (the
    registry never sees it)."""
    rec = _ACTIVE.get()
    if rec is not None:
        rec.device_counts.append((name, value))


class wait(span):
    """A span around one blocking device-to-host read, counted once."""

    __slots__ = ()
    _counted = True


class record:
    """`with record() as rec: ...` keeps the spans and counts of the block's
    context; `rec.summary()` sums them by name. Scopes nest: the inner one
    takes the spans until it closes."""

    __slots__ = ("spans", "counts", "device_counts", "_open_slots", "_token")

    def __init__(self):
        self.spans: list = []      # [name, parent slot or -1, start_ns, end_ns]
        self.counts: dict = {}
        self.device_counts: list = []  # [(name, device integer tensor)]
        self._open_slots: list = []

    def __enter__(self):
        self._token = _ACTIVE.set(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.reset(self._token)
        return False

    def _open(self, name: str, t0: int) -> int:
        parent = self._open_slots[-1] if self._open_slots else -1
        self.spans.append([name, parent, t0, None])
        slot = len(self.spans) - 1
        self._open_slots.append(slot)
        return slot

    def _close(self, slot: int, t1: int) -> None:
        self.spans[slot][3] = t1
        self._open_slots.pop()

    def summary(self) -> dict:
        """{"spans": {name: {count, total_s, self_s}}, "counts": {name: n}}
        of the closed spans. The device counts are read here, in one wait
        `sync.profiling.device_counts`, counted in the registry and in the
        scope active at the call, not in this summary."""
        covered = [0] * len(self.spans)
        for _, parent, t0, t1 in self.spans:
            if parent >= 0 and t1 is not None:
                covered[parent] += t1 - t0
        spans: dict = {}
        for (name, _, t0, t1), inner in zip(self.spans, covered):
            if t1 is None:
                continue
            s = spans.setdefault(name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
            s["count"] += 1
            s["total_s"] += (t1 - t0) * 1e-9
            s["self_s"] += (t1 - t0 - inner) * 1e-9
        counts = dict(self.counts)
        if self.device_counts:
            with wait("sync.profiling.device_counts"):
                for name, value in self.device_counts:
                    counts[name] = counts.get(name, 0) + int(value.sum())
        return {"spans": spans, "counts": counts}


def merge(into: dict | None, summary: dict) -> dict:
    """The sum of two `record.summary()`s (`into` may be None)."""
    if into is None:
        return summary
    spans = {name: dict(s) for name, s in into["spans"].items()}
    for name, s in summary["spans"].items():
        mine = spans.setdefault(name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        for key in mine:
            mine[key] += s[key]
    counts = dict(into["counts"])
    for name, n in summary["counts"].items():
        counts[name] = counts.get(name, 0) + n
    return {"spans": spans, "counts": counts}


def report() -> dict:
    with _LOCK:
        return {name: {"count": n, "total_s": total, "mean_s": total / n}
                for name, (n, total) in _REGISTRY.items()}


def counts() -> dict:
    """The registry's counts, {name: n}."""
    with _LOCK:
        return dict(_COUNTS)


def reset() -> None:
    with _LOCK:
        _REGISTRY.clear()
        _COUNTS.clear()


@dataclass
class Timer:
    """Reusable named timer: `with timer: ...`; totals in `.total_s`."""

    name: str = "timer"
    total_s: float = 0.0
    count: int = 0
    _t0: float = field(default=0.0, repr=False)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.total_s += dt
        self.count += 1
        return False

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)


@contextlib.contextmanager
def trace(log_dir: str, host_profiling: bool = False):
    """Capture a `torch.profiler` trace of the block into `log_dir`
    (created), as `trace_<pid>_<ns>.json` in the Chrome trace format
    (chrome://tracing, Perfetto). CUDA activity is recorded where
    `torch.cuda.is_available()`; `host_profiling` adds the host side's
    shapes and Python stacks. The profiler first runs one warm-up step,
    dropped from the trace (a small device operation and a wait): the
    device tracing loses events while it starts, and would otherwise lose
    the block's first kernels. Wrap the steady-state region only (after the
    kernels are built) for readable traces. Yields the profiler, whose
    `key_averages()` summarize the block once it has closed; each launch's
    host range and each `span` are in them too."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from manifold_flow_tpu_torch.kernels._lib import named_launches

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, record_shapes=host_profiling,
                 with_stack=host_profiling,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        if cuda:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        prof.step()
        with named_launches():
            yield prof
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _wait_for(result) -> None:
    """Wait for the devices of every CUDA tensor in `result` (tensors,
    NamedTuples, tuples, lists and dicts of them); CPU tensors need no
    wait."""
    devices = set()
    stack = [result]
    while stack:
        item = stack.pop()
        if isinstance(item, torch.Tensor):
            if item.is_cuda:
                devices.add(item.device)
        elif isinstance(item, dict):
            stack.extend(item.values())
        elif isinstance(item, (tuple, list)):
            stack.extend(item)
    for device in devices:
        torch.cuda.synchronize(device)


def frames_per_second(n_frames: int, fn, *args, repeats: int = 3) -> float:
    """Best-of-`repeats` frames/s of `fn(*args)` after one warm-up call (the
    kernels' build and the per-mesh caches); each call is timed until the
    devices of the CUDA tensors it returns are done."""
    _wait_for(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        _wait_for(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return n_frames / best
