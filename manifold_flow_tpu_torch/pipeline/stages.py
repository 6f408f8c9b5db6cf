"""Pipeline stages of S3: the velocity stage and the singularity stage.

Counterpart of the S3 part of manifold_flow_tpu/pipeline/stages.py. Each
stage computes on the mesh's device and writes the reference's artifact
formats (utils.io). The JAX package's fused flow program, which exists to
save remote dispatches, and its f64-to-f32 analysis cast, which exists
because the TPU emulates f64, have no counterpart: on the H100 the solve,
recombination and detection run eagerly in the movie's dtype.

The other stages (S0-S2, S4-S7) and `pipeline/batch.py` are not ported yet:
ROADMAP Queue A item 14 (and items 11-13 for their analysis ops).
"""

from __future__ import annotations

import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from manifold_flow_tpu_torch.geometry.mesh import TriMesh, build_mesh
from manifold_flow_tpu_torch.ops import singularity as sing_ops
from manifold_flow_tpu_torch.ops.recombine import velocity_to_world_and_speed
from manifold_flow_tpu_torch.pipeline.config import PipelineConfig
from manifold_flow_tpu_torch.solve.api import compute_velocity_fields
from manifold_flow_tpu_torch.utils import io

CLASSIFY_NOT_PORTED = (
    "singularity classification (classify=True, the CLI's --classify) is not "
    "ported yet: ROADMAP Queue A item 10 (ops/singularity.py "
    "classify_detected, kernel B9)")


def load_surface(path, cache_dir=None, pad: bool = False,
                 device="cpu") -> TriMesh:
    """Load a (reference-produced or own) PLY surface into a TriMesh on
    `device`. The JAX package's geometry cache (`cache_dir`) and shape
    padding (`pad`) are not ported and raise."""
    if cache_dir is not None:
        raise NotImplementedError(
            "load_surface(cache_dir=...) needs the geometry cache "
            "(utils/cache.py), which is not ported yet: ROADMAP Queue A item 14")
    if pad:
        raise NotImplementedError(
            "load_surface(pad=True) needs pad_mesh, which is not ported yet: "
            "ROADMAP Queue A item 2 (port it only if CUDA graphs need static "
            "shapes)")
    pts, tris = io.read_ply(path)
    return build_mesh(pts, tris, device=device)


class ConvergenceWarning(UserWarning):
    """A velocity-solve frame failed its residual tolerance."""


class VelocityStage(NamedTuple):
    """v_k / v_world / speed / v_max are tensors on the mesh's device;
    downstream stages consume them there."""

    v_k: torch.Tensor               # (T-1, 2N)
    e: np.ndarray                   # (N, 2, 3)
    v_world: torch.Tensor           # (T-1, N, 3)
    speed: torch.Tensor             # (T-1, N) optical-flow speed map (C12)
    iterations: int
    converged: bool
    v_max: torch.Tensor             # (T-1,) per-frame max speed


def _unconverged_detail(res, conv: np.ndarray) -> tuple[int, str]:
    bad = np.where(~conv)[0]
    resid = res.residual.cpu().numpy()[bad]
    detail = ", ".join(
        f"frame {int(k)}: |r|={r:.3e}" for k, r in zip(bad[:8], resid[:8]))
    if len(bad) > 8:
        detail += f", ... ({len(bad)} frames total)"
    return len(bad), detail


def velocity_stage(mesh: TriMesh, potentials, times, config: PipelineConfig,
                   e_path=None, v_k_path=None, speed_path=None, writer=None,
                   timings: dict | None = None) -> VelocityStage:
    """S3 core: velocity fields + recombination + speed map (+ artifacts).

    Non-convergence is loud: any frame still above `tol` at `max_iter` is
    reported by index and residual via warnings.warn, and (solver.escalate,
    default on) a float64 movie is re-solved with the refined method (f32
    inner PCG, f64 residual) — one bad frame would otherwise quietly corrupt
    every downstream artifact. method='auto' resolves here as in
    compute_velocity_fields ('refined' for float64 movies on CUDA, else
    'cg'), so the escalation compares against the method that ran.

    `timings`, when given, receives seconds: 'dispatch' (the solve, whose
    host loop waits on the device every iteration, and the K5 launch),
    'artifact_starts' (starting the artifacts' device-to-host copies),
    'solve_wait' (until the converged flags reach the host, which also
    waits for those copies), 'artifact_submits' (queueing the writes, or
    writing them when `writer` is None).
    """
    potentials = torch.as_tensor(potentials, device=mesh.device)
    is_f64 = potentials.dtype == torch.float64
    method = config.solver.method
    if method == "auto":
        method = "refined" if mesh.device.type == "cuda" and is_f64 else "cg"

    def run(method):
        res = compute_velocity_fields(
            mesh, potentials, times, lambda_=config.solver.lambda_,
            method=method, tol=config.solver.tol,
            inner_tol=config.solver.inner_tol, max_iter=config.solver.max_iter)
        return (res, *velocity_to_world_and_speed(res.v_k, mesh.basis))

    def start_artifacts(res, speed):
        """Start the device-to-host copy of each artifact tensor, once."""
        arts = {}
        if e_path is not None:
            arts["e"] = mesh.basis
        if v_k_path is not None:
            arts["v_k"] = res.v_k
        if speed_path is not None:
            arts["speed"] = speed
        return dict(zip(arts, io.start_host_copy(*arts.values())))

    t0 = time.perf_counter()
    res, v_world, speed, v_max = run(method)
    tp = time.perf_counter()
    arts = start_artifacts(res, speed)
    t1 = time.perf_counter()
    # A blocking read on the stream the copies were queued on: once the
    # flags are here, the artifact copies are complete too.
    conv = res.converged.cpu().numpy()
    t2 = time.perf_counter()
    if timings is not None:
        timings["dispatch"] = tp - t0
        timings["artifact_starts"] = t1 - tp
        timings["solve_wait"] = t2 - t1
    if not conv.all():
        n_bad, detail = _unconverged_detail(res, conv)
        can_escalate = (config.solver.escalate
                        and method not in ("refined", "cholesky") and is_f64)
        if can_escalate:
            warnings.warn(
                f"velocity solve failed tol={config.solver.tol} on "
                f"{n_bad} frame(s) [{detail}]; escalating to the refined "
                "solver", ConvergenceWarning, stacklevel=2)
            res, v_world, speed, v_max = run("refined")
            arts = start_artifacts(res, speed)  # supersedes the 1st pass
            conv = res.converged.cpu().numpy()
        if not conv.all():
            n_bad, detail = _unconverged_detail(res, conv)
            warnings.warn(
                f"velocity solve NOT converged to tol={config.solver.tol} on "
                f"{n_bad} frame(s) [{detail}]; downstream singularity/"
                "streamline/winding artifacts may be unreliable — raise "
                "max_iter or loosen tol", ConvergenceWarning, stacklevel=2)
    t3 = time.perf_counter()
    host = {name: t.numpy() for name, t in arts.items()}
    if e_path is not None:
        io.submit_write(writer, io.save_e_csv, e_path, host["e"])
    if v_k_path is not None:
        io.submit_write(writer, io.save_indexed_csv, v_k_path, host["v_k"])
    if speed_path is not None:
        io.submit_write(writer, io.save_pickle, speed_path, host["speed"])
    if timings is not None:
        timings["artifact_submits"] = time.perf_counter() - t3
    e = host["e"] if "e" in host else io.to_numpy(mesh.basis)[0]
    return VelocityStage(v_k=res.v_k, e=e, v_world=v_world, speed=speed,
                         iterations=int(res.iterations),
                         converged=bool(conv.all()), v_max=v_max)


def singularity_stage(mesh: TriMesh, v_world, config: PipelineConfig,
                      classify: bool = False, save_path=None,
                      classification_path=None, writer=None,
                      return_centers: bool = False,
                      speed: torch.Tensor | None = None,
                      v_max: torch.Tensor | None = None):
    """S3 detection: per-frame singularity lists.

    Returns (points_per_frame, None) and saves the reference's pickle format
    (find_singularity_point.py:760-761). return_centers=True appends a third
    return: per-frame snapped center vertex ids (computed in the compaction
    kernel) for the winding stage. `speed` and `v_max` are the velocity
    stage's (VelocityStage.speed, .v_max): required on CUDA, computed from
    v_world on the CPU when left out. classify=True (labels, `classification_path`) is not ported yet
    and raises.

    The host waits on the device twice: once for the two candidate counts
    that size the compaction, once for the compacted rows.
    """
    if classify:
        raise NotImplementedError(CLASSIFY_NOT_PORTED)
    field, counts = sing_ops.detect_with_counts(
        mesh, torch.as_tensor(v_world, device=mesh.device),
        eps=config.solver.eps, speed=speed, v_max=v_max)
    cap = sing_ops.capacity_for(*counts.tolist())
    compacted = sing_ops.compact_all(mesh, field, capacity=cap,
                                     with_centers=True)
    points_per_frame = [c[0] for c in compacted]
    centers_per_frame = [c[3] for c in compacted]
    if save_path is not None:
        io.submit_write(writer, io.save_pickle, save_path,
                        [list(p) for p in points_per_frame])
    if return_centers:
        return points_per_frame, None, centers_per_frame
    return points_per_frame, None
