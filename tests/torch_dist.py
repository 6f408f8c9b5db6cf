"""Rank bodies for the distributed tests of the PyTorch port.

The ranks are processes spawned by `parallel.multihost.spawn` (up to 4),
joined in a gloo process group through a FileStore in a temporary
directory, with one CPU thread each. A spawned child unpickles its target by
module, so the bodies live here: this module imports numpy, torch and the
port only, never JAX (the tests that compare with JAX do so in the parent).
Inputs are made with numpy from fixed seeds and synthetic meshes, results
come back as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

SEED = 0


# ---------------------------------------------------------------- problems
def solve_mesh(device="cpu"):
    """tests/test_parallel.py's problem mesh (14 x 14 bumped patch)."""
    from manifold_flow_tpu_torch.geometry import synthetic

    return synthetic.plane_patch(nx=14, ny=14, lx=7.0, ly=7.0,
                                 height=lambda x, y: 0.2 * np.sin(x) * np.cos(y),
                                 device=device)


def solve_movie(mesh, n_frames: int = 7):
    from manifold_flow_tpu_torch.geometry import synthetic

    pot, times = synthetic.plane_wave_movie(mesh, n_frames=n_frames)
    return np.asarray(pot), np.asarray(times)


def analysis_mesh(device="cpu"):
    """tests/test_parallel.py's analysis mesh (16 x 16, two sources)."""
    from manifold_flow_tpu_torch.geometry import synthetic

    return synthetic.plane_patch(nx=16, ny=16, lx=10.0, ly=10.0,
                                 height=lambda x, y: 0.3 * np.sin(0.8 * x) * np.cos(0.6 * y),
                                 device=device)


def _result(res) -> dict:
    return {"v_k": res.v_k.numpy(), "iterations": int(res.iterations),
            "converged": res.converged.numpy(), "residual": res.residual.numpy()}


# ---------------------------------------------------------------- rank bodies
def solve_layouts(rank: int, world: int, layouts) -> dict:
    """Each (name, nf, nm, n_frames, kwargs) of `layouts` whose nf * nm is the
    world: sharded_compute_velocity_fields on the solve problem."""
    from manifold_flow_tpu_torch.parallel import make_device_mesh, sharded_compute_velocity_fields

    mesh = solve_mesh()
    out = {}
    meshes = {}
    for name, nf, nm, n_frames, kwargs in layouts:
        if (nf, nm) not in meshes:
            meshes[(nf, nm)] = make_device_mesh(nf, nm, device="cpu")
        pot, times = solve_movie(mesh, n_frames)
        res = sharded_compute_velocity_fields(mesh, pot, times, meshes[(nf, nm)], **kwargs)
        out[name] = _result(res)
    return out


def halo_matvec(rank: int, world: int, nm: int) -> dict:
    """One halo matvec on random vectors against the global operator's, and
    the exchange's staged byte count (0 for CPU tensors)."""
    from manifold_flow_tpu_torch.fem.operator import make_operator
    from manifold_flow_tpu_torch.parallel import comm as pcomm
    from manifold_flow_tpu_torch.parallel import halo
    from manifold_flow_tpu_torch.parallel.partition import make_device_mesh
    from manifold_flow_tpu_torch.solve.api import build_rhs

    mesh = solve_mesh()
    pot, times = solve_movie(mesh, 4)
    dm = make_device_mesh(world // nm, nm, device="cpu")
    part = halo.build_partition(mesh, nm)
    block = halo.local_block(part, dm.coordinate[1])
    geom = halo._local_geometry(mesh, part, block, torch.float64)
    g, f = halo._local_factors(geom, torch.as_tensor(pot), torch.as_tensor(times),
                               block.vertex_ids, 3)
    op = halo._halo_operator(geom, g, 0.01, part, dm.comm("mesh"))
    x = torch.as_tensor(np.random.default_rng(SEED).standard_normal((3, mesh.n_dof)))
    x_loc = halo.global_to_owned(part, x)[:, dm.coordinate[1]]       # (T, 2Vo)
    full = x.new_zeros((3, 2, part.v_local))
    full[:, :, :part.v_owned] = x_loc.view(3, 2, part.v_owned)
    pcomm.reset_staged()
    y = op.matvec(full.reshape(3, -1))
    plain = op.reduce_owned(op.local_contributions(op.exchange(full.reshape(3, -1))))
    g_glob, f_glob = build_rhs(mesh, torch.as_tensor(pot), torch.as_tensor(times))
    want = make_operator(mesh, g_glob, 0.01).matvec(x)
    want_loc = halo.global_to_owned(part, want)[:, dm.coordinate[1]]
    f_loc = halo.global_to_owned(part, f_glob)[:, dm.coordinate[1]]
    vo = part.v_owned
    got = y.view(3, 2, -1)[:, :, :vo].reshape(3, -1)
    return {"y": got.numpy(), "want": want_loc.numpy(), "plain": plain.numpy(),
            "y_local": y.numpy(),
            "f": f.view(3, 2, -1)[:, :, :vo].reshape(3, -1).numpy(), "f_want": f_loc.numpy(),
            "off_owned": float(y.view(3, 2, -1)[:, :, vo:].abs().max()),
            "staged": dict(pcomm.STAGED_BYTES)}


def analysis_layout(rank: int, world: int) -> dict:
    """The sharded analysis ops on a (world, 1) mesh against the port's
    single-device ops, on the analysis problem (7 velocity frames)."""
    from manifold_flow_tpu_torch.geometry import synthetic
    from manifold_flow_tpu_torch.ops import singularity as sing_ops
    from manifold_flow_tpu_torch.ops import winding
    from manifold_flow_tpu_torch.ops.recombine import velocity_to_world
    from manifold_flow_tpu_torch.parallel import analysis as pa
    from manifold_flow_tpu_torch.parallel import make_device_mesh
    from manifold_flow_tpu_torch.solve.api import compute_velocity_fields

    mesh = analysis_mesh()
    pot, times, _ = synthetic.two_source_movie(mesh, n_frames=8)
    res = compute_velocity_fields(mesh, pot, times, method="cg", tol=1e-10)
    v3 = velocity_to_world(res.v_k, mesh.basis)
    dm = make_device_mesh(world, 1, device="cpu")
    field, counts = pa.sharded_detect_with_counts(mesh, v3, dm)
    plain = pa.sharded_detect(mesh, v3, dm)
    phase = np.angle(np.exp(1j * np.asarray(pot)))
    cap = sing_ops.compact_capacity(field)
    det = sing_ops.compact_detected(mesh, field, capacity=cap)
    valid = det.interior_valid.numpy()
    pts = np.where(valid[..., None], det.interior_points.numpy(), 0.0)
    centers = det.interior_centers.numpy()
    wind = pa.sharded_winding_movie(mesh, v3, pts, valid, dm, max_level=6, centers=centers)
    want_w = winding.analyze_singularities_movie(mesh, v3, pts, valid, max_level=6,
                                                 centers=centers)
    return {
        "v3": v3.numpy(), "pot": np.asarray(pot),
        "field": [leaf.numpy() for leaf in field], "counts": counts.numpy(),
        "field_plain": [leaf.numpy() for leaf in plain],
        "phase": pa.sharded_wave_velocity(mesh, phase, 1e-3, dm, method="phase").numpy(),
        "amplitude": pa.sharded_wave_velocity(mesh, pot, 1e-3, dm,
                                              method="amplitude").numpy(),
        "winding": [x.numpy() for x in wind], "winding_single": [x.numpy() for x in want_w],
        "winding_inputs": (pts, valid, centers),
    }


def stages_layout(rank: int, world: int) -> dict:
    """The four stages with device_mesh on a (world, 1) mesh against the same
    stages on one device, and which ranks wrote their artifacts."""
    import tempfile as _tmp
    from pathlib import Path

    from manifold_flow_tpu_torch.geometry import synthetic
    from manifold_flow_tpu_torch.parallel import make_device_mesh
    from manifold_flow_tpu_torch.pipeline import stages as S
    from manifold_flow_tpu_torch.pipeline.config import PipelineConfig

    mesh = analysis_mesh()
    pot, times, _ = synthetic.two_source_movie(mesh, n_frames=8)
    cfg = PipelineConfig()
    cfg.solver.method = "cg"
    cfg.solver.tol = 1e-12
    dm = make_device_mesh(world, 1, device="cpu")
    out = {}
    with _tmp.TemporaryDirectory() as tmp:
        d = Path(tmp)
        for tag, mesh_arg in (("single", None), ("sharded", dm)):
            vel = S.velocity_stage(mesh, pot, times, cfg, v_k_path=d / f"{tag}_V_k.csv",
                                   device_mesh=mesh_arg)
            pts, _, centers = S.singularity_stage(
                mesh, vel.v_world, cfg, save_path=d / f"{tag}_sing.pkl", return_centers=True,
                speed=vel.speed, v_max=vel.v_max, device_mesh=mesh_arg)
            ws = S.wavespeed_stage(mesh, np.angle(np.exp(1j * pot)), 1e-3, method="phase",
                                   save_path=d / f"{tag}_ws.pkl", device_mesh=mesh_arg)
            wl = S.winding_stage(mesh, vel.v_world, [list(p) for p in pts], cfg,
                                 save_path=d / f"{tag}_wind.pkl", centers=centers,
                                 device_mesh=mesh_arg)
            out[tag] = {"v_k": vel.v_k.numpy(), "iterations": vel.iterations,
                        "points": [np.asarray(p) for p in pts], "wavespeed": ws.numpy(),
                        "winding": {k: [[np.asarray(r[0]), r[1], r[2]] for r in v]
                                    for k, v in wl.items()}}
        dm.comm("frames").barrier()
        out["written"] = sorted(p.name for p in d.iterdir())
    return out


def failing_writes(rank: int, world: int, root: str, config: str) -> dict:
    """run_batch over `root` on a (world, 1) device mesh, with rank 0's
    V_k.csv writes raising OSError (rank 0 alone writes, so it alone sees
    the failure): this rank's report."""
    from manifold_flow_tpu_torch.parallel import make_device_mesh
    from manifold_flow_tpu_torch.pipeline import batch
    from manifold_flow_tpu_torch.pipeline.config import PipelineConfig
    from manifold_flow_tpu_torch.utils import io

    save = io.save_indexed_csv

    def failing(path, *args, **kwargs):
        if str(path).endswith("V_k.csv"):
            raise OSError("no space left on device")
        return save(path, *args, **kwargs)
    if rank == 0:
        io.save_indexed_csv = failing
    try:
        return batch.run_batch(root, PipelineConfig.from_yaml(config),
                               device_mesh=make_device_mesh(world, 1, device="cpu"),
                               device="cpu")
    finally:
        io.save_indexed_csv = save


def batch_layout(rank: int, world: int, root: str, argv_root: str, shards_root: str,
                 fail_root: str, config: str) -> dict:
    """run_batch(distributed=True) over `root`, the batch CLI with
    --distributed over `argv_root` and with --frame-shards over
    `shards_root`, and `failing_writes` over `fail_root` (device cpu), on
    `world` ranks, with the YAML `config`."""
    import contextlib
    import io as _io
    import json

    from manifold_flow_tpu_torch.pipeline import batch
    from manifold_flow_tpu_torch.pipeline import cli
    from manifold_flow_tpu_torch.pipeline.config import PipelineConfig

    report = batch.run_batch(root, PipelineConfig.from_yaml(config), distributed=True,
                             device="cpu")
    outs = {}
    for name, tree, flag in (("distributed", argv_root, ["--distributed"]),
                             ("frame_shards", shards_root, ["--frame-shards", str(world)])):
        buf = _io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["batch", "--root", tree, "--device", "cpu", "--config", config,
                           *flag])
        outs[name] = (rc, json.loads(buf.getvalue().strip().splitlines()[-1]))
    return {"report": report, "cli": outs,
            "failing": failing_writes(rank, world, fail_root, config)}


def four_ranks(rank: int, world: int, layouts) -> dict:
    """Everything the 4-rank tests read, from one spawn: the solve layouts,
    the halo matvec at (1, 4) and (2, 2), the analysis ops and the stages."""
    return {"solve": solve_layouts(rank, world, layouts),
            "matvec": {nm: halo_matvec(rank, world, nm) for nm in (4, 2)},
            "analysis": analysis_layout(rank, world),
            "stages": stages_layout(rank, world)}
