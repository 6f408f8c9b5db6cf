"""The command line: the `preprocess` (S0), `reconstruct` (S1),
`interpolate` (S2), `flow` (S3), `decompose` (S4), `wavespeed` (S5),
`streamline` (S6), `winding` (S7), `visualize`, `batch` and `demo`
subcommands.

Counterpart of manifold_flow_tpu/pipeline/cli.py, with the same arguments
for these subcommands plus `--device`, the explicit counterpart of the JAX
package's JAX_PLATFORMS: `cuda` (the default) runs the hand-written kernels
on the GPU and raises when there is none; `cpu` runs their plain torch
versions.

    python -m manifold_flow_tpu_torch.pipeline.cli preprocess \\
        --subject-dir bids/sub-01 --out-dir results/ [--runs 021448]
    python -m manifold_flow_tpu_torch.pipeline.cli reconstruct \\
        --electrodes sub-01_electrodes.tsv --out-dir results/sub-01
    python -m manifold_flow_tpu_torch.pipeline.cli interpolate --surface s.ply \\
        --electrodes electrodes.tsv --data movie.csv --sfreq 512 [--phases] \\
        --out-dir results/
    python -m manifold_flow_tpu_torch.pipeline.cli flow --surface s.ply \\
        --potentials p.csv --sfreq 512 --out-dir results/ [--classify]
    python -m manifold_flow_tpu_torch.pipeline.cli decompose --v-k V_k.csv \\
        [--mode concat|complex] [--render-modes 4 --surface s.ply \\
        [--pial lh.pial rh.pial]] --out-dir results/
    python -m manifold_flow_tpu_torch.pipeline.cli wavespeed --surface s.ply \\
        --movie phases.csv --sfreq 512 [--method phase|amplitude] --out-dir results/
    python -m manifold_flow_tpu_torch.pipeline.cli streamline --surface s.ply \\
        --e e.csv --v-k V_k.csv [--start 0 --end -1] --out-dir results/
    python -m manifold_flow_tpu_torch.pipeline.cli winding --surface s.ply \\
        --e e.csv --v-k V_k.csv --singularities singularity_points.pkl \\
        --out-dir results/
    python -m manifold_flow_tpu_torch.pipeline.cli visualize --surface s.ply \\
        --e e.csv --v-k V_k.csv [--frame 0 | --gif [--sfreq 512]] \\
        [--scalars movie.csv] [--singularities singularity_points.pkl] \\
        --out-dir results/
    python -m manifold_flow_tpu_torch.pipeline.cli batch --root results/ \\
        [--stages interpolate flow streamline decompose wavespeed winding]
    python -m manifold_flow_tpu_torch.pipeline.cli demo --out-dir /tmp/demo [--gif]

`preprocess` needs MNE-Python and raises ImportError naming it without;
`reconstruct` writes reconstructed_surface.ply; `interpolate` writes
interpolation_data.csv (interpolation_phases_data.csv with --phases);
`flow` writes e.csv, V_k.csv, wave_velocity_opticalflow.pkl.bz2 and
singularity_points.pkl (and singularity_points_classification.pkl with
--classify); `decompose` writes data_01.npz (and spatial_mode_{k}.png for
the leading modes with --render-modes, over a --pial underlay where given;
as in JAX, `--pial` alone is read by nothing and ignored); `wavespeed`
writes wave_velocity_{method}.pkl.bz2; `streamline` writes
t_velocityfields_streamlines_{frame}.pkl.bz2 per frame; `winding` writes
winding_lines.pkl.bz2; `visualize` writes velocity_frame_{frame}.png, or
with --gif velocity_fields.gif (true_vs_detected.gif with
--true-singularities), recombining V_k on the device; `batch` runs the
stages over every trial of a results tree in one process (pipeline.batch)
and returns 1 when a trial failed; `demo` runs the flow stage on a
synthetic two-source movie and scores the detections against the true
sources (and with --gif animates them, true_vs_detected.gif). Each prints
one JSON line: its JAX counterpart's keys plus `device` (and `timings`).
The renderings need matplotlib (viz.fields). Under torchrun, `batch
--frame-shards N` runs every trial on N ranks, their frames sharded
(parallel), and `batch --distributed` splits the trials over the ranks; the
two together raise, and so does either without a process group of a
fitting size.
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


def cmd_preprocess(args):
    """S0: BIDS iEEG -> epochs and per-site evokeds (needs MNE-Python)."""
    from manifold_flow_tpu_torch.pipeline import preprocess

    device = _device(args.device)
    cfg = _load_config(args)
    done = preprocess.process_subject(args.subject_dir, args.out_dir,
                                      cfg.preprocess, runs=args.runs)
    print(json.dumps({"stage": "preprocess", "device": str(device),
                      "runs_done": done}))
    return 0


def cmd_reconstruct(args):
    """S1: the grid electrodes of an electrodes.tsv -> a surface PLY."""
    from manifold_flow_tpu_torch.pipeline import stages
    from manifold_flow_tpu_torch.utils import io

    device = _device(args.device)
    cfg = _load_config(args)
    t0 = time.perf_counter()
    coords = io.load_grid_electrodes(args.electrodes, group=args.group)
    out = Path(args.out_dir) / "reconstructed_surface.ply"
    res = stages.reconstruct_stage(coords, cfg, save_path=out, device=device)
    print(json.dumps({"stage": "reconstruct", "device": str(device),
                      "n_vertices": int(res.mesh.n_vertices),
                      "n_triangles": int(res.mesh.n_triangles),
                      "surface": str(out),
                      "timings": {"reconstruct": time.perf_counter() - t0}}))
    return 0


def cmd_interpolate(args):
    """S2: an electrode movie (or its phases) onto the surface's vertices."""
    from manifold_flow_tpu_torch.pipeline import stages
    from manifold_flow_tpu_torch.utils import io

    device = _device(args.device)
    cfg = _load_config(args)
    t0 = time.perf_counter()
    mesh = stages.load_surface(args.surface, device=device)
    coords = io.load_grid_electrodes(args.electrodes, group=args.group,
                                     exclude=args.exclude)
    data = _load_movie(args.data)
    timings: dict = {"load": time.perf_counter() - t0}
    suffix = "phases_data" if args.phases else "data"
    out = Path(args.out_dir) / f"interpolation_{suffix}.csv"
    movie = stages.interpolate_stage(mesh, coords, data, cfg, sfreq=args.sfreq,
                                     phases=args.phases, save_path=out,
                                     timings=timings)
    print(json.dumps({"stage": "interpolate", "device": str(device),
                      "shape": list(movie.shape), "out": str(out),
                      "timings": timings}))
    return 0


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


def cmd_decompose(args):
    """S4: the spatiotemporal SVD of a V_k movie."""
    from manifold_flow_tpu_torch.pipeline import stages
    from manifold_flow_tpu_torch.utils import io

    device = _device(args.device)
    cfg = _load_config(args)
    t0 = time.perf_counter()
    v_k = torch.as_tensor(io.load_indexed_csv(args.v_k), device=device)
    timings: dict = {"load": time.perf_counter() - t0}
    modes = stages.decompose_stage(v_k, cfg, mode=args.mode,
                                   npz_path=Path(args.out_dir) / "data_01.npz",
                                   timings=timings)
    (sigma,) = io.to_numpy(modes.sigma)
    rendered = []
    if args.render_modes:  # --pial is an underlay of the rendering only
        import matplotlib.pyplot as plt

        from manifold_flow_tpu_torch.viz import fields

        if not args.surface:
            raise SystemExit("--render-modes requires --surface")
        t0 = time.perf_counter()
        mesh = stages.load_surface(args.surface, device=device)
        underlay = fields.load_pial_surfaces(*args.pial) if args.pial else None
        fmt = str(Path(args.out_dir) / "spatial_mode_{mode}.png")
        figs = fields.plot_spatial_modes(mesh, modes, n_modes=args.render_modes,
                                         underlay=underlay, save_path_fmt=fmt)
        rendered = [fmt.format(mode=i + 1) for i in range(len(figs))]
        plt.close("all")
        timings["render"] = time.perf_counter() - t0
    print(json.dumps({"stage": "decompose", "device": str(device), "mode": args.mode,
                      "energy_pct": list(np.round(
                          100 * sigma**2 / (sigma**2).sum(), 3)[:8]),
                      "rendered_modes": rendered, "timings": timings}))
    return 0


def cmd_wavespeed(args):
    """S5: wave speeds of an amplitude or phase movie."""
    from manifold_flow_tpu_torch.pipeline import stages

    device = _device(args.device)
    _load_config(args)
    t0 = time.perf_counter()
    mesh = stages.load_surface(args.surface, device=device)
    movie = _load_movie(args.movie)
    timings: dict = {"load": time.perf_counter() - t0}
    out = Path(args.out_dir) / f"wave_velocity_{args.method}.pkl.bz2"
    ws = stages.wavespeed_stage(mesh, movie, dt=1.0 / args.sfreq, method=args.method,
                                save_path=out, timings=timings)
    print(json.dumps({"stage": "wavespeed", "device": str(device),
                      "method": args.method, "shape": list(ws.shape), "out": str(out),
                      "timings": timings}))
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


def cmd_visualize(args):
    """Glyph plot of one frame, or a GIF of every frame, from the flow
    stage's artifacts: V_k and e go to the device, K5 recombines them there,
    and the world vectors reach the host once."""
    from manifold_flow_tpu_torch.utils import io
    from manifold_flow_tpu_torch.viz import fields

    device = _device(args.device)
    _load_config(args)
    t0 = time.perf_counter()
    mesh, v_world = _velocity_movie(args, device)
    scalars = _load_movie(args.scalars) if args.scalars else None
    sing = io.load_pickle(args.singularities) if args.singularities else None
    true_sing = (io.load_pickle(args.true_singularities)
                 if args.true_singularities else None)
    underlay = fields.load_pial_surfaces(*args.pial) if args.pial else None
    hm = fields.host_mesh(mesh)
    (v_world,) = io.to_numpy(v_world)
    timings = {"load": time.perf_counter() - t0}
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    t1 = time.perf_counter()
    if args.gif:
        name = ("true_vs_detected.gif" if true_sing is not None
                else "velocity_fields.gif")
        path = out / name
        times = (np.arange(v_world.shape[0]) / args.sfreq
                 if args.sfreq else None)
        fields.animate_velocity_fields(
            hm, v_world, path, scalars=scalars,
            singularities_per_frame=sing,
            true_singularities_per_frame=true_sing, times=times,
            scaling=args.scaling, stride=args.stride, underlay=underlay)
        timings["render"] = time.perf_counter() - t1
        print(json.dumps({"stage": "visualize", "device": str(device), "gif": str(path),
                          "frames": int(v_world.shape[0]), "timings": timings}))
    else:
        import matplotlib.pyplot as plt

        k = args.frame
        path = out / f"velocity_frame_{k}.png"
        fig = fields.plot_velocity_frame(
            hm, v_world[k],
            scalars=scalars[k] if scalars is not None else None,
            singularities=np.asarray(sing[k]) if sing else None,
            true_singularities=(np.asarray(true_sing[k])
                                if true_sing else None),
            scaling=args.scaling, stride=args.stride,
            title=f"frame {k}", underlay=underlay)
        fig.savefig(path, dpi=120)
        plt.close(fig)
        timings["render"] = time.perf_counter() - t1
        print(json.dumps({"stage": "visualize", "device": str(device), "png": str(path),
                          "frame": k, "timings": timings}))
    return 0


def cmd_demo(args):
    """End to end on synthetic data: surface -> two-source movie -> flow ->
    detection, scored against the true sources."""
    from manifold_flow_tpu_torch.geometry import synthetic
    from manifold_flow_tpu_torch.ops import validation
    from manifold_flow_tpu_torch.pipeline import stages
    from manifold_flow_tpu_torch.utils import io

    device = _device(args.device)
    cfg = _load_config(args)
    cfg.solver.tol = 1e-8
    t0 = time.perf_counter()
    mesh = synthetic.plane_patch(
        nx=args.nx, ny=args.nx, lx=20.0, ly=20.0,
        height=lambda x, y: 1.5 * np.sin(x / 4.0) * np.cos(y / 5.0), device=device)
    pot, times, true_pts = synthetic.two_source_movie(
        mesh, sources=((5.0, 5.0), (15.0, 15.0)), n_frames=args.frames)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    points, triangles, truth = io.to_numpy(mesh.points, mesh.triangles, true_pts)
    io.write_ply(out / "simulated_surface.ply", points, triangles)
    t1 = time.perf_counter()
    vel = stages.velocity_stage(mesh, pot, times, cfg, e_path=out / "e.csv",
                                v_k_path=out / "V_k.csv")
    t2 = time.perf_counter()
    pts, _ = stages.singularity_stage(mesh, vel.v_world, cfg,
                                      save_path=out / "singularity_points.pkl",
                                      speed=vel.speed, v_max=vel.v_max)
    t3 = time.perf_counter()
    report = validation.score_all_frames(
        mesh, pts, [truth] * len(pts), threshold=cfg.analysis.threshold,
        turning_point=len(pts) + 1)
    timings = {"setup": t1 - t0, "flow": t2 - t1, "singularity_stage": t3 - t2,
               "score": time.perf_counter() - t3}
    gif_path = None
    if args.gif:
        # The reference's simulated-data visual validation: detected (red)
        # vs true (blue) singularities animated over the velocity movie
        # (draw_optical_flow_field.py:258-319).
        from manifold_flow_tpu_torch.viz import fields

        t4 = time.perf_counter()
        gif_path = out / "true_vs_detected.gif"
        fields.animate_velocity_fields(
            mesh, vel.v_world, gif_path, scalars=pot[:-1],
            singularities_per_frame=[np.asarray(p) for p in pts],
            true_singularities_per_frame=[truth] * len(pts),
            times=times[:-1], stride=4, dpi=60)
        timings["gif"] = time.perf_counter() - t4
    print(json.dumps({
        "stage": "demo", "device": str(device), "frames": int(vel.v_k.shape[0]),
        "converged": vel.converged,
        "matched": report.matched, "missed": report.missed,
        "spare": report.spare, "err_max": report.err_max,
        "gif": str(gif_path) if gif_path else None, "out_dir": str(out),
        "timings": timings}))
    return 0


def cmd_batch(args):
    """Batch runs over a subjects/runs/trials results tree (the
    reference's argv-sharded Slurm loops, S2:79-102, S5:264-300,
    S7:205-261), with resume by artifact presence and host sharding;
    returns 1 when any trial failed."""
    from manifold_flow_tpu_torch.pipeline import batch

    device = _device(args.device)
    cfg = _load_config(args)
    device_mesh = None
    if args.frame_shards:
        if args.distributed:
            raise ValueError(batch.MESH_AND_DISTRIBUTED)
        from manifold_flow_tpu_torch.parallel import make_device_mesh, multihost

        multihost.initialize()
        device_mesh = make_device_mesh(args.frame_shards, 1, device=device)
    report = batch.run_batch(
        args.root, cfg, stages=tuple(args.stages),
        subjects=args.subjects or None, sfreq=args.sfreq,
        overwrite=args.overwrite, num_shards=args.num_shards,
        shard_index=args.shard_index, distributed=args.distributed,
        cache_dir=args.cache_dir, device_mesh=device_mesh, device=device)
    print(json.dumps({"stage": "batch", "device": str(device), **report}))
    return 1 if report["errors"] else 0


def build_parser():
    p = argparse.ArgumentParser(
        prog="manifold_flow_tpu_torch",
        description="Manifold optical flow on an NVIDIA GPU (PyTorch/CUDA port)")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("preprocess", help="S0: BIDS iEEG -> epochs/evokeds")
    _add_common(sp)
    sp.add_argument("--subject-dir", required=True)
    sp.add_argument("--runs", nargs="*", default=None)
    sp.set_defaults(func=cmd_preprocess)

    sp = sub.add_parser("reconstruct", help="S1: electrodes.tsv -> surface.ply")
    _add_common(sp)
    sp.add_argument("--electrodes", required=True)
    sp.add_argument("--group", default="grid")
    sp.set_defaults(func=cmd_reconstruct)

    sp = sub.add_parser("interpolate", help="S2: electrode movie -> vertex movie")
    _add_common(sp)
    sp.add_argument("--surface", required=True)
    sp.add_argument("--electrodes", required=True)
    sp.add_argument("--data", required=True, help="(T, E) movie .csv/.npy")
    sp.add_argument("--sfreq", type=float, default=None)
    sp.add_argument("--phases", action="store_true")
    sp.add_argument("--exclude", nargs="*", default=None,
                    help="electrode names to drop (e.g. the stimulated pair, "
                         "S2_interpolate.py:125-135)")
    sp.add_argument("--group", default="grid")
    sp.set_defaults(func=cmd_interpolate)

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

    sp = sub.add_parser("decompose", help="S4: spatiotemporal SVD")
    _add_common(sp)
    sp.add_argument("--v-k", required=True)
    sp.add_argument("--mode", default="concat", choices=["concat", "complex"])
    sp.add_argument("--render-modes", type=int, default=0,
                    help="render the leading K spatial modes as glyph PNGs "
                         "(extract_modes, S4_...ComplexMatrices .py:145-162); "
                         "requires --surface")
    sp.add_argument("--surface", default=None)
    sp.add_argument("--pial", nargs="*", default=None,
                    help="FreeSurfer pial surface(s) for the translucent "
                         "context underlay of --render-modes (S4_..."
                         "ConcatMatrices .py:147-158; ignored without it)")
    sp.set_defaults(func=cmd_decompose)

    sp = sub.add_parser("wavespeed", help="S5: wave speeds from a movie")
    _add_common(sp)
    sp.add_argument("--surface", required=True)
    sp.add_argument("--movie", required=True)
    sp.add_argument("--sfreq", type=float, required=True)
    sp.add_argument("--method", default="phase", choices=["phase", "amplitude"])
    sp.set_defaults(func=cmd_wavespeed)

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

    sp = sub.add_parser("visualize", help="glyph plot / GIF from V_k artifacts")
    _add_common(sp)
    sp.add_argument("--surface", required=True)
    sp.add_argument("--e", required=True)
    sp.add_argument("--v-k", required=True)
    sp.add_argument("--scalars", default=None,
                    help="(T, N) potentials/phases movie for the colormap")
    sp.add_argument("--singularities", default=None,
                    help="singularity_points.pkl to overlay (red)")
    sp.add_argument("--true-singularities", default=None,
                    help="ground-truth points pkl for the true-vs-detected "
                         "overlay/GIF (draw_optical_flow_field.py:258-319)")
    sp.add_argument("--pial", nargs="*", default=None,
                    help="FreeSurfer pial surface(s) underlay")
    sp.add_argument("--frame", type=int, default=0)
    sp.add_argument("--gif", action="store_true")
    sp.add_argument("--sfreq", type=float, default=None,
                    help="adds time-stamped GIF titles")
    sp.add_argument("--scaling", default="scaled", choices=["raw", "scaled"])
    sp.add_argument("--stride", type=int, default=1)
    sp.set_defaults(func=cmd_visualize)

    sp = sub.add_parser("batch",
                        help="walk a results tree; run the stages of every "
                             "trial with resume and host sharding")
    _add_common(sp)
    sp.add_argument("--root", required=True,
                    help="results tree root: <root>/<subject>/run-*/<trial>/")
    sp.add_argument("--stages", nargs="*",
                    default=["flow", "streamline", "decompose", "wavespeed",
                             "winding"],
                    choices=["interpolate", "flow", "decompose", "wavespeed",
                             "streamline", "winding", "wavespeed_amplitude"],
                    help="'interpolate' adds the S2 sweep: evokeds + TSVs "
                         "-> interpolated movies (stim pair auto-excluded)")
    sp.add_argument("--subjects", nargs="*", default=None)
    sp.add_argument("--sfreq", type=float, default=None,
                    help="overrides the BIDS sidecar SamplingFrequency")
    sp.add_argument("--overwrite", action="store_true",
                    help="re-run stages whose artifacts already exist")
    sp.add_argument("--num-shards", type=int, default=None)
    sp.add_argument("--shard-index", type=int, default=None)
    sp.add_argument("--distributed", action="store_true",
                    help="derive the shard from the process group's rank "
                         "and size (launch under torchrun)")
    sp.add_argument("--cache-dir", default=None,
                    help="geometry cache directory")
    sp.add_argument("--frame-shards", type=int, default=None,
                    help="run each trial on this many ranks (launch under "
                         "torchrun with as many processes), the frame axis of "
                         "the solve and analysis stages sharded over them "
                         "(parallel); streamlines and the SVD run on every "
                         "rank, rank 0 writes")
    sp.set_defaults(func=cmd_batch)

    sp = sub.add_parser("demo", help="synthetic end-to-end run + validation")
    _add_common(sp)
    sp.add_argument("--nx", type=int, default=24)
    sp.add_argument("--frames", type=int, default=12)
    sp.add_argument("--gif", action="store_true",
                    help="also render the true-vs-detected validation GIF")
    sp.set_defaults(func=cmd_demo)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
