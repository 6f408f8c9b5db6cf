"""The command line: the `flow` subcommand (S3).

Counterpart of manifold_flow_tpu/pipeline/cli.py, with the same arguments
for `flow` plus `--device`, the explicit counterpart of the JAX package's
JAX_PLATFORMS: `cuda` (the default) runs the hand-written kernels on the
GPU and raises when there is none; `cpu` runs their plain torch versions.

    python -m manifold_flow_tpu_torch.pipeline.cli flow --surface s.ply \\
        --potentials p.csv --sfreq 512 --out-dir results/ [--device cpu]

It writes e.csv, V_k.csv, wave_velocity_opticalflow.pkl.bz2 and
singularity_points.pkl, and prints one JSON line. Not ported yet, and
raising NotImplementedError: --classify (ROADMAP Queue A item 10). The
other subcommands are item 14.
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


def cmd_flow(args):
    """S3: velocity fields + singularity detection."""
    from manifold_flow_tpu_torch.pipeline import stages

    if args.classify:
        raise NotImplementedError(stages.CLASSIFY_NOT_PORTED)
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
        mesh, vel.v_world, cfg, save_path=out / "singularity_points.pkl",
        speed=vel.speed, v_max=vel.v_max)
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


def build_parser():
    p = argparse.ArgumentParser(
        prog="manifold_flow_tpu_torch",
        description="Manifold optical flow on an NVIDIA GPU (PyTorch/CUDA port)")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("flow", help="S3: velocity fields + singularities")
    sp.add_argument("--config", help="YAML config (accepts the reference's "
                    "config.yaml layout)")
    sp.add_argument("--out-dir", default=".", help="artifact directory")
    sp.add_argument("--surface", required=True)
    sp.add_argument("--potentials", required=True)
    sp.add_argument("--sfreq", type=float, default=None)
    sp.add_argument("--method", default=None,
                    choices=[None, "cg", "cholesky", "refined"])
    sp.add_argument("--tol", type=float, default=None)
    sp.add_argument("--classify", action="store_true")
    sp.add_argument("--device", default="cuda",
                    help="cuda (default: the CUDA kernels; raises without a "
                         "GPU) or cpu (their plain torch versions)")
    sp.set_defaults(func=cmd_flow)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
