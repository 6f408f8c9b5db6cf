"""The traced stretch: torch.profiler over a few requests, and the reduction
of its trace to device busy time, device time by host range and by kernel,
and the idle gaps by what the host was doing.

One traced warm-up request is dropped (the profiler's own first-step
costs), then `n` requests are traced, each inside a host range "request"
and its stages inside "request/<stage>" ranges. A device operation (kernel,
copy or set) belongs to the range in which the host launched it, matched
through the launch's correlation id. The traced window runs from the first
traced request's start to the last one's end, on the trace's host clock.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Op:
    name: str
    start: float    # us, trace clock
    dur: float      # us
    range: str      # innermost request range of its launch, or "" outside one


@dataclass
class Trace:
    ops: list
    window: tuple            # (start, end) us
    ranges: list             # (name, start, end) us, host request ranges

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> list:
        lo, hi = self.window
        ivs = sorted((max(o.start, lo), min(o.start + o.dur, hi)) for o in self.ops
                     if o.start + o.dur > lo and o.start < hi)
        merged = []
        for a, b in ivs:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def n_requests(self) -> int:
        return sum(1 for name, _, _ in self.ranges if name == "request")

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def device_s(self, prefix: str) -> float:
        """Device seconds of the operations launched inside ranges whose
        name starts with `prefix`."""
        return sum(o.dur for o in self.ops if o.range.startswith(prefix)) * 1e-6

    def range_at(self, ts: float) -> str:
        """The innermost request range at host time `ts`, or "host"."""
        return innermost(self.ranges, ts) or (
            "request" if any(a <= ts < b for _, a, b in self.ranges) else "host")

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for o in self.ops:
            by_name[o.name] = by_name.get(o.name, 0.0) + o.dur * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        gaps = [(self.range_at(a), (b - a) * 1e-6)
                for (_, a), (b, _) in zip(busy[:-1], busy[1:])]
        if busy:
            gaps += [(self.range_at(self.window[0]), (busy[0][0] - self.window[0]) * 1e-6),
                     (self.range_at(busy[-1][1]), (self.window[1] - busy[-1][1]) * 1e-6)]
        gaps = sorted(gaps, key=lambda g: -g[1])[:top]
        return {"device_ops": [[n[:96], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def innermost(ranges: list, ts: float) -> str:
    """The innermost "request/<stage>" range holding `ts`, or ""."""
    inner = ""
    for name, a, b in ranges:
        if a <= ts < b and name != "request":
            inner = name
    return inner


def reduce_trace(events: list) -> Trace:
    """A Trace of a Chrome trace's events."""
    ranges = sorted((e["name"], e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and (e["name"] == "request" or e["name"].startswith("request/")))
    launch_ts = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
    ops = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            ts = launch_ts.get(e.get("args", {}).get("correlation"))
            ops.append(Op(e["name"], e["ts"], e.get("dur", 0),
                          "" if ts is None else innermost(ranges, ts)))
    tops = [(a, b) for name, a, b in ranges if name == "request"]
    window = (min(a for a, _ in tops), max(b for _, b in tops)) if tops else (0.0, 0.0)
    return Trace(ops, window, ranges)


def profile(step, n: int, sync, workdir: Path) -> Trace:
    """Trace requests 1..n of `step(k)` (k = 0, the warm-up, is dropped)."""
    import torch
    from torch.profiler import ProfilerActivity, schedule

    workdir.mkdir(parents=True, exist_ok=True)
    path = workdir / "trace.json"
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                schedule=schedule(wait=0, warmup=1, active=n, repeat=1),
                                on_trace_ready=lambda p: p.export_chrome_trace(str(path))
                                ) as prof:
        for k in range(n + 1):
            if k:
                with torch.autograd.profiler.record_function("request"):
                    step(k)
            else:
                step(k)
            sync()
            prof.step()
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    path.unlink()
    return reduce_trace(events)
