"""Tracing, timing and metrics.

Counterpart of manifold_flow_tpu/utils/profiling.py, with the same names and
semantics:

  * `span(name)` / `Timer`: wall-clock spans with a process-wide registry;
    `report()` returns {name: {count, total_s, mean_s}}, `reset()` clears it.
  * `trace(log_dir)`: a `torch.profiler` trace (CPU activity, and CUDA
    activity where a GPU is present) written into `log_dir` as a Chrome
    trace. Every kernel launch in it sits inside a host range named after
    its `kernels.LAUNCHES` key ("fem_matvec<float>", ...), the device
    kernel under it (the profiler draws the range on the device timeline
    too: a sum of device times over all its events counts the kernel
    twice).
  * `frames_per_second(n_frames, fn, *args)`: best-of-k frames/s of a call
    after one warm-up call, each call waited for on the devices of the CUDA
    tensors it returns.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

import torch

logger = logging.getLogger("manifold_flow_tpu_torch")

_REGISTRY: dict[str, list[float]] = defaultdict(list)


@contextlib.contextmanager
def span(name: str, log: bool = False):
    """Time a code span; durations accumulate in the process registry."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _REGISTRY[name].append(dt)
        if log:
            logger.info("%s: %.3f s", name, dt)


def report() -> dict:
    return {
        name: {
            "count": len(vals),
            "total_s": sum(vals),
            "mean_s": sum(vals) / len(vals),
        }
        for name, vals in _REGISTRY.items()
    }


def reset() -> None:
    _REGISTRY.clear()


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
    shapes and Python stacks. Wrap the steady-state region only (after the
    kernels are built) for readable traces. Yields the profiler, whose
    `key_averages()` summarize the block once it has closed; each launch's
    host range is in them too."""
    from torch.profiler import ProfilerActivity, profile

    from manifold_flow_tpu_torch.kernels._lib import named_launches

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, record_shapes=host_profiling,
                 with_stack=host_profiling) as prof, named_launches():
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
