"""One run of one cell: set-up, warm-up, the measured window, the traced
stretch, the check against the reference, and the result line.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell is found by name under the checkout's `flowbench/`:
`configs/<config>.json`, `traffic/<traffic>.json`, `metrics/<metric>.py`
and `limits/<workload>.json`; `BENCHMARK.json` at the checkout's root names
them. Nothing here imports JAX or the JAX package.

The traffic is a closed loop with one client: request i runs the traffic's
stage list on pool item i mod P, all inputs on the device since set-up, and
the next request starts when the last output of the previous one is on the
device (a synchronisation). A request's latency is that whole span.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from flowbench import check, inputs

ROOT = Path(__file__).resolve().parent.parent
# Top-level module names that the port's process may not hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "manifold_flow_tpu")
# Host ranges of the traced run, by stage.
RANGE_OF = {"interpolate": "request/s2", "interpolate_phases": "request/s2",
            "velocity": "request/solve", "singularities": "request/analysis",
            "decompose": "request/svd", "wavespeed": "request/s5"}


def load_json(path: Path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@dataclass
class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic and
    limits, all read from their files under `root`."""

    root: Path
    bench: dict
    spec: dict
    config: dict
    traffic: dict
    limits: dict

    @classmethod
    def load(cls, workload: str, root: Path = ROOT) -> "Cell":
        bench = load_json(root / "BENCHMARK.json")
        specs = [w for w in bench["workloads"] if w["name"] == workload]
        if not specs:
            raise SystemExit(f"no workload {workload!r} in {root / 'BENCHMARK.json'}")
        spec = specs[0]
        conf = [c for c in bench["configs"] if c["name"] == spec["config"]][0]
        limits_path = root / "flowbench" / "limits" / f"{workload}.json"
        return cls(root, bench, spec, load_json(root / conf["file"]),
                   load_json(root / "flowbench" / "traffic" / f"{spec['traffic']}.json"),
                   load_json(limits_path) if limits_path.exists() else {})

    def metrics(self, key: str) -> list[dict]:
        """The cell's metrics of BENCHMARK.json's `key` ('end_to_end' or
        'per_layer'): those that list it, or list no cells."""
        return [m for m in self.bench[key]
                if self.spec["name"] in m.get("workloads", [self.spec["name"]])]


@dataclass
class Run:
    """What the window and the traced stretch recorded; the per-layer
    readers (metrics/<name>.py) read it."""

    cell: Cell
    shapes: dict
    latencies: list = field(default_factory=list)
    timings: list = field(default_factory=list)      # per request: {stage: {...}}
    iterations: list = field(default_factory=list)   # per trial: VelocityStage.iterations
    trace: object = None                             # traces.Trace of the traced stretch
    launches: dict = field(default_factory=dict)     # launch counts of the traced stretch


def pipeline_config(pipe: dict):
    """The port's PipelineConfig with the configuration file's settings."""
    from manifold_flow_tpu_torch.pipeline.config import PipelineConfig

    cfg = PipelineConfig()
    for section, values in pipe.items():
        if not isinstance(values, dict):
            setattr(cfg, section, values)
            continue
        for key, value in values.items():
            setattr(getattr(cfg, section), key,
                    tuple(value) if isinstance(value, list) else value)
    return cfg


class Context:
    """The port, the surface and the pool of requests on the device."""

    def __init__(self, cell: Cell, seed: int, device: str):
        import torch

        from manifold_flow_tpu_torch.solve import api, coarse
        from manifold_flow_tpu_torch.utils.cache import build_mesh_cached

        traffic = cell.traffic
        self.torch = torch
        self.device = torch.device(device)
        self.stages = traffic["stages"]
        self.pool = traffic["pool"]
        self.inputs = inp = inputs.Inputs.make(cell.config, traffic, seed)
        self.sfreq = inp.sfreq
        self.cfg = pipeline_config(inp.pipeline)
        cache = cell.root / ".cache" / "flowbench" / "geometry"
        self.mesh = build_mesh_cached(inp.points, inp.tris, cache_dir=cache,
                                      device=self.device)
        self.coords = torch.as_tensor(inp.coords, device=self.device)
        self.epochs = torch.as_tensor(inp.epochs, device=self.device)
        self.times = torch.as_tensor(inp.times, device=self.device)
        self.vmovies = None
        if "decompose" in self.stages and "velocity" not in self.stages:
            self.vmovies = inp.velocity_movies(self.device, seed, traffic["velocity_noise"])
        start, stop = inp.window
        frames = stop - start
        two_level = api.resolve_precond(self.mesh, "auto") == "two_level"
        self.shapes = {
            "n_vertices": int(inp.points.shape[0]), "n_cells": int(inp.tris.shape[0]),
            "n_electrodes": int(inp.coords.shape[0]), "n_samples": int(inp.epochs.shape[1]),
            "frames": frames, "velocity_frames": frames - 1,
            "solve_window": (api.FRAME_CHUNK_SIZE if frames - 1 > api.FRAME_CHUNK_AUTO_MIN
                             else frames - 1),
            "two_level": two_level,
            "n_coarse": coarse.build_tables(self.mesh).n_coarse if two_level else 0,
            "n_modes": self.cfg.analysis.n_modes}
        count = traffic["count"]
        self.frames_per_request = self.shapes[count]

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def request(self, item: int, timings: dict | None = None, ranges: bool = False) -> dict:
        """Run the traffic's stages on pool item `item`; outputs by stage."""
        from manifold_flow_tpu_torch.pipeline import stages

        torch = self.torch
        out = {}
        mesh, cfg = self.mesh, self.cfg

        def t(name):
            if timings is None:
                return None
            return timings.setdefault(name, {})

        for name in self.stages:
            rng = (torch.autograd.profiler.record_function(RANGE_OF[name]) if ranges
                   else contextlib.nullcontext())
            with rng:
                if name == "interpolate":
                    out["amp"] = stages.interpolate_stage(
                        mesh, self.coords, self.epochs[item], cfg, sfreq=self.sfreq,
                        timings=t(name))
                elif name == "interpolate_phases":
                    out["phase"] = stages.interpolate_stage(
                        mesh, self.coords, self.epochs[item], cfg, sfreq=self.sfreq,
                        phases=True, timings=t(name))
                elif name == "velocity":
                    out["vel"] = stages.velocity_stage(mesh, out["amp"], self.times, cfg,
                                                       timings=t(name))
                elif name == "singularities":
                    vel = out["vel"]
                    out["sing"] = stages.singularity_stage(
                        mesh, vel.v_world, cfg, classify=True, speed=vel.speed,
                        v_max=vel.v_max, timings=t(name))
                elif name == "decompose":
                    movie = out["vel"].v_k if "vel" in out else self.vmovies[item]
                    out["svd_input"] = movie
                    out["modes"] = stages.decompose_stage(movie, cfg, mode="concat",
                                                          timings=t(name))
                elif name == "wavespeed":
                    out["wave"] = stages.wavespeed_stage(mesh, out["phase"], 1.0 / self.sfreq,
                                                         method="phase", timings=t(name))
                else:
                    raise ValueError(f"unknown stage {name!r}")
        self.sync()
        return out


def read_launches() -> dict:
    from manifold_flow_tpu_torch.kernels import LAUNCHES

    return dict(LAUNCHES)


def host_outputs(ctx: Context, out: dict, frames: list[int]) -> dict:
    """The judged outputs of one request, on the host as numpy."""
    res = {}
    for key in ("amp", "phase", "wave", "svd_input"):
        if key in out:
            res[key] = out[key].detach().cpu().numpy()
    if "modes" in out:
        m = out["modes"]
        res["modes"] = (m.u.cpu().numpy(), m.sigma.cpu().numpy(), m.vt.cpu().numpy())
    if "vel" in out:
        v = out["vel"].v_world
        res["v_world"] = {k: v[k].cpu().numpy() for k in frames}
        pts, labels = out["sing"]
        res["sing"] = {k: (np.asarray(pts[k]).reshape(-1, 3), np.asarray(labels[k]))
                       for k in frames}
    return res


def solve_ok(out: dict) -> bool:
    return out["vel"].converged if "vel" in out else True


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, log=sys.stderr) -> dict:
    """One run; returns the result line's object (without printing it)."""
    import torch

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_ctx = time.perf_counter()
    ctx = Context(cell, seed, device)
    t_warm = time.perf_counter()
    traffic = cell.traffic
    pool = ctx.pool
    order = np.random.default_rng([seed, 1]).permutation(pool)

    # Warm-up: every pool item once, then on until the latest latency is
    # within the traffic's tolerance of the median of the last pool's.
    warm = []
    wcfg = traffic["warmup"]
    i = 0
    while True:
        t0 = time.perf_counter()
        ctx.request(int(order[i % pool]))
        warm.append(time.perf_counter() - t0)
        i += 1
        if i >= pool and (abs(warm[-1] - np.median(warm[-pool:])) <= wcfg["tolerance"]
                          * np.median(warm[-pool:]) or i >= wcfg["max_requests"]):
            break
    gc.collect()
    gc.freeze()
    gc.disable()
    setup_s = time.perf_counter() - t_start
    print(f"flowbench: set-up {setup_s:.3f} s: {t_ctx - t_start:.3f} s to the cell (imports, "
          f"CUDA), {t_warm - t_ctx:.3f} s inputs, surface and kernels, {sum(warm):.3f} s "
          f"warm-up in {len(warm)} requests (the last {1e3 * warm[-1]:.2f} ms)", file=log)

    rec = Run(cell, ctx.shapes)
    chk = traffic["check"]
    pick = np.random.default_rng([seed, 2])
    reservoir: list = []
    attempted = failed = 0
    frames_done = 0
    first_error = None
    begin = time.perf_counter()
    deadline = begin + seconds
    end = begin
    n = 0
    while time.perf_counter() < deadline:
        item = int(order[n % pool])
        timings = {} if trace else None
        t0 = time.perf_counter()
        attempted += 1
        try:
            out = ctx.request(item, timings)
            ok = solve_ok(out)
        except Exception:  # a failed request counts, and the loop goes on
            out, ok = None, False
            first_error = first_error or traceback.format_exc()
        end = time.perf_counter()
        n += 1
        if not ok:
            failed += 1
            continue
        rec.latencies.append(end - t0)
        frames_done += ctx.frames_per_request
        if trace:
            rec.timings.append(timings)
            if "vel" in out:
                rec.iterations.append(out["vel"].iterations)
        # A uniform sample of the completed requests, drawn from the seed.
        done = len(rec.latencies)
        if len(reservoir) < chk["requests"]:
            reservoir.append((item, out))
        else:
            j = int(pick.integers(done))
            if j < chk["requests"]:
                reservoir[j] = (item, out)
    gc.enable()
    window_s = end - begin
    if first_error:
        print(first_error, file=log)

    result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": {},
              "device": device_info(torch, device)}
    if trace:
        from flowbench import traces

        before = {}

        def step(k):
            nonlocal before
            if k == 1:
                ctx.sync()
                before = read_launches()
            ctx.request(int(order[k % pool]), ranges=True)

        rec.trace = traces.profile(step, traffic["trace_requests"], ctx.sync,
                                   cell.root / ".cache" / "flowbench" / "trace")
        after = read_launches()
        rec.launches = {k: after[k] - before.get(k, 0) for k in after}
        result["device"]["busy_s"] = rec.trace.busy_s
        result["device"]["window_s"] = rec.trace.window_s
        result["metrics"] = per_layer(cell, rec)
        result["breakdown"] = rec.trace.breakdown()
    else:
        result["metrics"] = end_to_end(cell, rec, frames_done, window_s, setup_s)

    # Frames checked against the reference's solve: one from each of
    # chk["frames"] equal stretches of the movie, so every solve window is in.
    edges = np.linspace(0, ctx.shapes["velocity_frames"], chk["frames"] + 1).astype(int)
    frames = ([int(pick.integers(lo, hi)) for lo, hi in zip(edges[:-1], edges[1:])]
              if "velocity" in ctx.stages else [])
    sampled = [(item, host_outputs(ctx, out, frames)) for item, out in reservoir]
    inp, stage_list = ctx.inputs, ctx.stages
    del ctx, reservoir
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.judge(inp, stage_list, sampled, frames)
    print(f"flowbench: window {window_s:.3f} s, {len(rec.latencies)} requests; "
          f"check {time.perf_counter() - t_check:.3f} s", file=log)
    verdict = check.verdict(numbers, cell.limits)
    result["correct"] = bool(verdict["correct"] and failed == 0 and attempted > 0)
    result["check"] = verdict["numbers"]
    return result


def device_info(torch, device: str) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def end_to_end(cell: Cell, rec: Run, frames: int, window_s: float, setup_s: float) -> dict:
    lat_ms = np.asarray(rec.latencies) * 1e3
    values = {"setup_s": setup_s}
    if len(lat_ms):
        kind = cell.traffic["kind"]
        values[f"{kind}_frames_per_s"] = frames / window_s
        values[f"{kind}_p95_ms"] = float(np.percentile(lat_ms, 95))
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.metrics("end_to_end") if m["name"] in values}


def load_reader(root: Path, name: str):
    path = root / "flowbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("flowbench_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def per_layer(cell: Cell, rec: Run) -> dict:
    out = {}
    for m in cell.metrics("per_layer"):
        value = load_reader(cell.root, m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))
