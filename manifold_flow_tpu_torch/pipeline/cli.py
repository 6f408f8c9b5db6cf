"""The command line: the `flow` (S3), `streamline` (S6) and `winding` (S7)
subcommands.

Counterpart of manifold_flow_tpu/pipeline/cli.py, with the same arguments
for these subcommands plus `--device`, the explicit counterpart of the JAX
package's JAX_PLATFORMS: `cuda` (the default) runs the hand-written kernels
on the GPU and raises when there is none; `cpu` runs their plain torch
versions.

    python -m manifold_flow_tpu_torch.pipeline.cli flow --surface s.ply \\
        --potentials p.csv --sfreq 512 --out-dir results/ [--classify]
    python -m manifold_flow_tpu_torch.pipeline.cli streamline --surface s.ply \\
        --e e.csv --v-k V_k.csv [--start 0 --end -1] --out-dir results/
    python -m manifold_flow_tpu_torch.pipeline.cli winding --surface s.ply \\
        --e e.csv --v-k V_k.csv --singularities singularity_points.pkl \\
        --out-dir results/

`flow` writes e.csv, V_k.csv, wave_velocity_opticalflow.pkl.bz2 and
singularity_points.pkl (and singularity_points_classification.pkl with
--classify); `streamline` writes t_velocityfields_streamlines_{frame}.pkl.bz2
per frame; `winding` writes winding_lines.pkl.bz2. Each prints one JSON
line: its JAX counterpart's keys plus `device` and `timings`. The other
subcommands are ROADMAP Queue A item 14.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def _load_config(args):
    from manifold_flow_tpu_torch.pipeline.config import PipelineConfig

    if getattr(args, "config", None):
        return PipelineConfig.from_yaml(args.config)
    return PipelineConfig()


def _load_movie(path):
    from manifold_flow_tpu_torch.utils import io

    path = str(path)
    if path.endswith(".csv"):
        return io.load_indexed_csv(path)
    if path.endswith(".npy"):
        return np.load(path)
    raise SystemExit(f"unsupported movie format: {path} (want .csv or .npy)")


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"--device {name}: want cpu or cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name} needs an NVIDIA GPU and torch.cuda.is_available() "
            "is False; pass --device cpu to run the plain torch versions on "
            "the CPU")
    return device


def _add_common(sp):
    sp.add_argument("--config", help="YAML config (accepts the reference's "
                    "config.yaml layout)")
    sp.add_argument("--out-dir", default=".", help="artifact directory")
    sp.add_argument("--device", default="cuda",
                    help="cuda (default: the CUDA kernels; raises without a "
                         "GPU) or cpu (their plain torch versions)")


def cmd_flow(args):
    """S3: velocity fields + singularity detection/classification."""
    from manifold_flow_tpu_torch.pipeline import stages

    device = _device(args.device)
    cfg = _load_config(args)
    if args.tol:
        cfg.solver.tol = args.tol
    if args.method:
        cfg.solver.method = args.method
    mesh = stages.load_surface(args.surface, device=device)
    movie = _load_movie(args.potentials)
    if cfg.solver.time_steps and movie.shape[0] > cfg.solver.time_steps:
        movie = movie[: cfg.solver.time_steps]
    times = (np.arange(movie.shape[0]) / args.sfreq if args.sfreq
             else np.arange(movie.shape[0], dtype=np.float64))

    out = Path(args.out_dir)
    timings: dict = {}
    t0 = time.perf_counter()
    vel = stages.velocity_stage(
        mesh, movie, times, cfg,
        e_path=out / "e.csv", v_k_path=out / "V_k.csv",
        speed_path=out / "wave_velocity_opticalflow.pkl.bz2",
        timings=timings)
    t1 = time.perf_counter()
    pts, _ = stages.singularity_stage(
        mesh, vel.v_world, cfg, classify=args.classify,
        save_path=out / "singularity_points.pkl",
        classification_path=(out / "singularity_points_classification.pkl"
                             if args.classify else None),
        speed=vel.speed, v_max=vel.v_max, timings=timings)
    timings["singularity_stage"] = time.perf_counter() - t1
    print(json.dumps({
        "stage": "flow", "device": str(device),
        "frames": int(vel.v_k.shape[0]), "n_dof": int(vel.v_k.shape[1]),
        "solve_seconds": round(t1 - t0, 3),
        "iterations": vel.iterations, "converged": vel.converged,
        "singularities_per_frame": [len(p) for p in pts],
        "timings": timings,
    }))
    return 0


def _velocity_movie(args, device):
    """The mesh of --surface and the world velocity movie of --v-k on --e's
    bases (K5 on the GPU), both on `device`."""
    from manifold_flow_tpu_torch.ops.recombine import velocity_to_world
    from manifold_flow_tpu_torch.pipeline import stages
    from manifold_flow_tpu_torch.utils import io

    mesh = stages.load_surface(args.surface, device=device)
    e = torch.as_tensor(io.load_e_csv(args.e), device=device)
    v_k = torch.as_tensor(io.load_indexed_csv(args.v_k), device=device)
    return mesh, velocity_to_world(v_k, e)


def cmd_streamline(args):
    """S6: streamlines of frames [--start, --end) of a V_k movie."""
    from manifold_flow_tpu_torch.pipeline import stages

    device = _device(args.device)
    cfg = _load_config(args)
    t0 = time.perf_counter()
    mesh, v_world = _velocity_movie(args, device)
    frames = range(args.start, args.end if args.end >= 0 else v_world.shape[0])
    fmt = str(Path(args.out_dir) / "t_velocityfields_streamlines_{frame}.pkl.bz2")
    timings: dict = {"load": time.perf_counter() - t0}
    lines = stages.streamline_stage(mesh, v_world, cfg, frames=frames,
                                    save_path_fmt=fmt, timings=timings)
    print(json.dumps({"stage": "streamline", "device": str(device),
                      "lines_per_frame": {k: len(v) for k, v in lines.items()},
                      "timings": timings}))
    return 0


def cmd_winding(args):
    """S7: winding lines around the singularities of a pickle; the points
    snap to vertices again on the host."""
    from manifold_flow_tpu_torch.pipeline import stages
    from manifold_flow_tpu_torch.utils import io

    device = _device(args.device)
    cfg = _load_config(args)
    t0 = time.perf_counter()
    mesh, v_world = _velocity_movie(args, device)
    sing = io.load_pickle(args.singularities)
    t1 = time.perf_counter()
    out = Path(args.out_dir) / "winding_lines.pkl.bz2"
    lines = stages.winding_stage(mesh, v_world, sing, cfg, save_path=out)
    timings = {"load": t1 - t0, "winding": time.perf_counter() - t1}
    print(json.dumps({"stage": "winding", "device": str(device),
                      "frames_with_lines": len(lines), "out": str(out),
                      "timings": timings}))
    return 0


def build_parser():
    p = argparse.ArgumentParser(
        prog="manifold_flow_tpu_torch",
        description="Manifold optical flow on an NVIDIA GPU (PyTorch/CUDA port)")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("flow", help="S3: velocity fields + singularities")
    _add_common(sp)
    sp.add_argument("--surface", required=True)
    sp.add_argument("--potentials", required=True)
    sp.add_argument("--sfreq", type=float, default=None)
    sp.add_argument("--method", default=None,
                    choices=[None, "cg", "cholesky", "refined"])
    sp.add_argument("--tol", type=float, default=None)
    sp.add_argument("--classify", action="store_true")
    sp.set_defaults(func=cmd_flow)

    sp = sub.add_parser("streamline", help="S6: streamline extraction")
    _add_common(sp)
    sp.add_argument("--surface", required=True)
    sp.add_argument("--e", required=True)
    sp.add_argument("--v-k", required=True)
    sp.add_argument("--start", type=int, default=0)
    sp.add_argument("--end", type=int, default=-1)
    sp.set_defaults(func=cmd_streamline)

    sp = sub.add_parser("winding", help="S7: winding-line analysis")
    _add_common(sp)
    sp.add_argument("--surface", required=True)
    sp.add_argument("--e", required=True)
    sp.add_argument("--v-k", required=True)
    sp.add_argument("--singularities", required=True)
    sp.set_defaults(func=cmd_winding)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
