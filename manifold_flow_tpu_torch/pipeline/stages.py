"""Pipeline stages: S0 (preprocessing, host only), S1 (the surface from
the electrodes, on the host), S2 (RBF interpolation of the electrode movie
or its phases), S3 (velocity, singularities and their classification), S4
(the SVD modes), S5 (wave speeds), S6 (streamlines) and S7 (winding lines).

Counterpart of manifold_flow_tpu/pipeline/stages.py. Each device stage
computes on the mesh's device (S4 on the movie's, the GPU by default) and
writes the reference's artifact formats (utils.io). The JAX package's fused
flow program, which exists to save remote dispatches, and its f64-to-f32
analysis cast, which exists because the TPU emulates f64, have no
counterpart: on the H100 every stage runs eagerly in the movie's dtype.

The velocity, singularity, wave-speed and winding stages take a
`device_mesh` (parallel.make_device_mesh), as in JAX: every rank of the
mesh calls the stage with the same inputs, the frame axis (and with a mesh
axis the solve's vertex blocks) is sharded over the ranks, every rank gets
the whole result, and rank 0 alone writes the artifacts.
"""

from __future__ import annotations

import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from manifold_flow_tpu_torch.geometry import reconstruct
from manifold_flow_tpu_torch.geometry.mesh import TriMesh, build_mesh, resolve_device
from manifold_flow_tpu_torch.ops import interpolate as rbf_ops
from manifold_flow_tpu_torch.ops import phase as phase_ops
from manifold_flow_tpu_torch.ops import singularity as sing_ops
from manifold_flow_tpu_torch.ops import streamline as stream_ops
from manifold_flow_tpu_torch.ops import svd as svd_ops
from manifold_flow_tpu_torch.ops import wavespeed as wave_ops
from manifold_flow_tpu_torch.ops import winding as wind_ops
from manifold_flow_tpu_torch.ops.recombine import velocity_to_world_and_speed
from manifold_flow_tpu_torch.pipeline.config import PipelineConfig
from manifold_flow_tpu_torch.solve.api import compute_velocity_fields
from manifold_flow_tpu_torch.utils import io


def writes_artifacts(device_mesh) -> bool:
    """Whether this process writes a stage's artifacts: always on one
    device, rank 0 alone under a device mesh. The stages that take a
    `device_mesh` ask it themselves; a caller that runs the others on
    every rank (pipeline.batch.run_trial) asks it for them."""
    if device_mesh is None:
        return True
    from manifold_flow_tpu_torch.parallel import multihost

    return multihost.is_primary()


# ------------------------------------------------------------------- S0 ----
def preprocess_subject(subject_dir, results_dir, config: PipelineConfig):
    """S0: BrainVision -> filtered, re-referenced epochs + per-site evokeds.

    Requires MNE-Python (host-side, runs once per subject):
    pipeline.preprocess raises ImportError naming it otherwise. As
    process_subject (S0_preprocess.py:133-172): band-pass
    low_freq..high_freq, notch at the recording's PowerLineFrequency,
    ECOG/good/included channel pick, average reference, epochs on
    electrical_stimulation events with baseline correction,
    per-stimulation-site evoked averages.
    """
    from manifold_flow_tpu_torch.pipeline import preprocess

    return preprocess.process_subject(subject_dir, results_dir, config.preprocess)


# ------------------------------------------------------------------- S1 ----
class ReconstructionResult(NamedTuple):
    mesh: TriMesh            # on the device the caller asked for
    points: np.ndarray       # (N, 3) float64
    triangles: np.ndarray    # (M, 3) int32


def reconstruct_stage(electrode_coords, config: PipelineConfig, save_path=None,
                      device="cuda") -> ReconstructionResult:
    """S1: electrode point cloud -> smoothed, subdivided triangle surface,
    built on the host (geometry.reconstruct) and returned as a mesh on
    `device` (the GPU unless the caller passes device="cpu"); `save_path`
    writes it as PLY."""
    device = resolve_device(device)
    pts, tris = reconstruct.reconstruct_surface(
        electrode_coords,
        smooth_iters=config.reconstruction.smooth_iters,
        subdivisions=config.reconstruction.subdivisions,
    )
    if save_path is not None:
        io.ensure_dir(save_path)
        io.write_ply(save_path, pts, tris)
    return ReconstructionResult(build_mesh(pts, tris, device=device), pts, tris)


def load_surface(path, cache_dir=None, pad: bool = False,
                 device="cuda") -> TriMesh:
    """Load a (reference-produced or own) PLY surface into a TriMesh on
    `device` (the GPU unless the caller passes device="cpu").

    `cache_dir` enables the geometry cache keyed by the mesh's content
    (utils.cache), the realised version of the reference's commented-out
    processed_surface_path (config.yaml:18,27). The JAX package's shape
    padding (`pad`) raises: it exists so that XLA compiles one program for
    surfaces of different sizes, which eager CUDA launches do not need."""
    if pad:
        raise NotImplementedError(
            "load_surface(pad=True) needs pad_mesh, which is not ported: it "
            "exists to stop XLA from recompiling per surface (ROADMAP Queue A3: "
            "port it only if CUDA graphs need static shapes)")
    pts, tris = io.read_ply(path)
    if cache_dir is not None:
        from manifold_flow_tpu_torch.utils.cache import build_mesh_cached

        return build_mesh_cached(pts, tris, cache_dir=cache_dir, device=device)
    return build_mesh(pts, tris, device=device)


# ------------------------------------------------------------------- S2 ----
def interpolate_stage(mesh: TriMesh, electrode_coords, electrode_data,
                      config: PipelineConfig, sfreq: float | None = None,
                      phases: bool = False, save_path=None, writer=None,
                      timings: dict | None = None) -> torch.Tensor:
    """S2: electrode movie (T, E) -> vertex movie (T, N) on the mesh's
    device, by RBF interpolation (K17 on CUDA).

    With phases=True follows S2_interpolate_phases: the Hilbert phase of
    each electrode's signal, e^{i phi} interpolated, the angle of the
    interpolant. When `sfreq` is given, the movie is windowed to
    [start_time, end_time) seconds (S2_interpolate.py:19-20, 109-110), at
    one site, after the Hilbert transform: windowing first would change
    every frame's analytic signal.

    The Hilbert transform runs along time (axis=0) unless
    config.reference_quirks, which takes the reference's scipy default
    axis=-1, across the electrodes (S2_interpolate_phases.py:66).
    `timings`, when given, receives seconds: 'compute' (until the result is
    on the host) and 'write' (the CSV, or queueing it).
    """
    def window(movie):
        if sfreq is None:
            return movie
        s = int(config.interpolation.start_time * sfreq)
        e = int(config.interpolation.end_time * sfreq)
        return movie[s:e]

    t0 = time.perf_counter()
    coords = torch.as_tensor(electrode_coords, device=mesh.device)
    data = torch.as_tensor(electrode_data, device=mesh.device)
    interp = config.interpolation
    if phases:
        phi = phase_ops.instantaneous_phase(
            data, axis=-1 if config.reference_quirks else 0)
        out = rbf_ops.rbf_interpolate_phases(coords, window(phi), mesh.points,
                                             smooth=interp.smooth, kind=interp.kind)
    else:
        out = rbf_ops.rbf_interpolate(coords, window(data), mesh.points,
                                      smooth=interp.smooth, kind=interp.kind)
    if save_path is not None:
        (host,) = io.to_numpy(out)
        t1 = time.perf_counter()
        io.submit_write(writer, io.save_indexed_csv, save_path, host)
        if timings is not None:
            timings.update(compute=t1 - t0, write=time.perf_counter() - t1)
    elif timings is not None:
        _sync(out.device)
        timings.update(compute=time.perf_counter() - t0, write=0.0)
    return out


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
                   timings: dict | None = None, device_mesh=None) -> VelocityStage:
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

    `device_mesh` solves on every rank of the mesh
    (parallel.sharded_compute_velocity_fields: 'refined' stays refined,
    every other method is 'cg', as in JAX); rank 0 writes.
    """
    if not writes_artifacts(device_mesh):
        e_path = v_k_path = speed_path = None
    potentials = torch.as_tensor(potentials, device=mesh.device)
    is_f64 = potentials.dtype == torch.float64
    method = config.solver.method
    if method == "auto":
        method = "refined" if mesh.device.type == "cuda" and is_f64 else "cg"

    def run(method):
        if device_mesh is not None:
            from manifold_flow_tpu_torch.parallel import sharded_compute_velocity_fields

            res = sharded_compute_velocity_fields(
                mesh, potentials, times, device_mesh, lambda_=config.solver.lambda_,
                tol=config.solver.tol, max_iter=config.solver.max_iter,
                inner_tol=config.solver.inner_tol,
                method="refined" if method == "refined" else "cg")
        else:
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def singularity_stage(mesh: TriMesh, v_world, config: PipelineConfig,
                      classify: bool = False, save_path=None,
                      classification_path=None, writer=None,
                      return_centers: bool = False,
                      speed: torch.Tensor | None = None,
                      v_max: torch.Tensor | None = None,
                      timings: dict | None = None, device_mesh=None):
    """S3 detection and classification: per-frame singularity lists.

    Returns (points_per_frame, labels_per_frame) and saves the reference's
    pickle format (find_singularity_point.py:760-761). With classify=True
    the labels are the reference's class names ('Node', 'Focus', 'Saddle',
    'Indeterminate') of each point, in the same order, from the Jacobian of
    each compacted candidate (K12, `quirks` from config.reference_quirks);
    `classification_path` writes them (the reference config's
    singularity_points_classification_path). Without classify the labels
    are None. return_centers=True appends a third return: per-frame snapped
    center vertex ids (computed in the compaction kernel) for the winding
    stage. `speed` and `v_max` are the velocity stage's
    (VelocityStage.speed, .v_max): required on CUDA, computed from v_world
    on the CPU when left out. `timings`, when given, receives seconds:
    'detect' (until the candidate counts reach the host), 'classify' (K7
    and K12 until the compacted rows reach the host).

    The host waits on the device twice: once for the two candidate counts
    that size the compaction, once for the compacted rows (and codes).
    `device_mesh` shards the detection's frames (parallel); the compaction
    and classification run on every rank, rank 0 writes.
    """
    if not writes_artifacts(device_mesh):
        save_path = classification_path = None
    t0 = time.perf_counter()
    v_world = torch.as_tensor(v_world, device=mesh.device)
    if device_mesh is not None:
        from manifold_flow_tpu_torch.parallel import sharded_detect_with_counts

        field, counts = sharded_detect_with_counts(
            mesh, v_world, device_mesh, eps=config.solver.eps, speed=speed, v_max=v_max)
    else:
        field, counts = sing_ops.detect_with_counts(
            mesh, v_world, eps=config.solver.eps, speed=speed, v_max=v_max)
    cap = sing_ops.capacity_for(*counts.tolist())
    t1 = time.perf_counter()
    det = sing_ops.compact_detected(mesh, field, capacity=cap)
    labels_per_frame = None
    if classify:
        classes = sing_ops.classify_compacted(mesh, v_world, field.v_max, det,
                                              quirks=config.reference_quirks)
        vcodes, icodes = io.to_numpy(classes.vertex_codes, classes.interior_codes)
        vok, iok = io.to_numpy(det.vertex_valid, det.interior_valid)
        names = np.asarray(sing_ops.CLASS_NAMES)
        # Rows list the valid vertex slots, then the valid interior slots,
        # in slot order (compacted_rows): the labels follow that order.
        labels_per_frame = [
            names[np.concatenate([vcodes[k][vok[k]], icodes[k][iok[k]]])].tolist()
            for k in range(vcodes.shape[0])]
    compacted = sing_ops.compacted_rows(mesh, det, with_centers=True)
    if timings is not None:
        timings["detect"] = t1 - t0
        timings["classify"] = time.perf_counter() - t1
    points_per_frame = [c[0] for c in compacted]
    centers_per_frame = [c[3] for c in compacted]
    if save_path is not None:
        io.submit_write(writer, io.save_pickle, save_path,
                        [list(p) for p in points_per_frame])
    if classification_path is not None and classify:
        io.submit_write(writer, io.save_pickle, classification_path,
                        labels_per_frame)
    if return_centers:
        return points_per_frame, labels_per_frame, centers_per_frame
    return points_per_frame, labels_per_frame


# ------------------------------------------------------------------- S4 ----
def decompose_stage(v_k, config: PipelineConfig, mode: str = "concat",
                    npz_path=None, writer=None, device="cuda",
                    timings: dict | None = None) -> svd_ops.SVDModes:
    """S4: the spatiotemporal SVD of a velocity movie (T, 2N), in complex or
    concatenated-real form, on v_k's device (a tensor) or on `device` (the
    GPU unless the caller passes device="cpu"). `npz_path` writes the
    reference's data_01.npz (U, Sigma, VT, point_num). `timings`, when
    given, receives seconds: 'compute' (until the modes are on the host)
    and 'write'."""
    if mode not in ("complex", "concat"):
        raise ValueError(f"unknown SVD mode {mode!r}")
    t0 = time.perf_counter()
    v = (v_k if isinstance(v_k, torch.Tensor)
         else torch.as_tensor(v_k, device=resolve_device(device)))
    decompose = svd_ops.decompose_complex if mode == "complex" else svd_ops.decompose_concat
    modes = decompose(v, n_modes=config.analysis.n_modes)
    if npz_path is not None:
        u, sigma, vt = io.to_numpy(modes.u, modes.sigma, modes.vt)
        t1 = time.perf_counter()
        io.submit_write(writer, np.savez, npz_path, U=u, Sigma=sigma, VT=vt,
                        point_num=v.shape[-1] // 2)
        if timings is not None:
            timings.update(compute=t1 - t0, write=time.perf_counter() - t1)
    elif timings is not None:
        _sync(v.device)
        timings.update(compute=time.perf_counter() - t0, write=0.0)
    return modes


# ------------------------------------------------------------------- S5 ----
def wavespeed_stage(mesh: TriMesh, movie, dt: float, method: str = "phase",
                    save_path=None, writer=None, device_mesh=None,
                    timings: dict | None = None) -> torch.Tensor:
    """S5: wave speeds (T, N) from an amplitude or phase movie (T, N), on
    the mesh's device (K16 on CUDA): the phase method's |speed| / 1000 (the
    S5 script's unit conversion, S5:311-313) or the amplitude method's
    speed. `save_path` writes the reference's pickle of the float array.
    `timings`, when given, receives seconds: 'compute' (until the speeds
    are on the host) and 'write'. `device_mesh` shards the frames
    (parallel.sharded_wave_velocity); rank 0 writes."""
    if not writes_artifacts(device_mesh):
        save_path = None
    if device_mesh is not None:
        if method not in ("phase", "amplitude"):
            raise ValueError(f"unknown wavespeed method {method!r}")
        from manifold_flow_tpu_torch.parallel import sharded_wave_velocity

        def speed_of(mesh, movie, dt):
            return sharded_wave_velocity(mesh, movie, dt, device_mesh, method=method)
    elif method == "phase":
        speed_of = wave_ops.wave_velocity_phase_mm_per_ms
    elif method == "amplitude":
        speed_of = wave_ops.wave_velocity_amplitude
    else:
        raise ValueError(f"unknown wavespeed method {method!r}")
    t0 = time.perf_counter()
    ws = speed_of(mesh, movie, dt)
    if save_path is not None:
        (host,) = io.to_numpy(ws)
        t1 = time.perf_counter()
        io.submit_write(writer, io.save_pickle, save_path, host)
        if timings is not None:
            timings.update(compute=t1 - t0, write=time.perf_counter() - t1)
    elif timings is not None:
        _sync(ws.device)
        timings.update(compute=time.perf_counter() - t0, write=0.0)
    return ws


# ------------------------------------------------------------------- S6 ----
def streamline_stage(mesh: TriMesh, v_world, config: PipelineConfig,
                     frames=None, save_path_fmt=None, writer=None,
                     timings: dict | None = None):
    """S6: per-frame streamline sets {str(frame): [polyline, ...]}.

    Every requested frame is traced at once (K13 next hops, K14 walk
    lengths); only the walks of at least min_streamline_length vertices are
    packed on the device (K14) and cross to the host. Polyline coordinates
    are float32 unless config.reference_quirks pins the reference's float64
    bytes. `save_path_fmt` (with a {frame} field) writes one pickle per
    frame, each queued as soon as that frame's lines exist. `timings`, when
    given, receives seconds: 'trace' (until the walk lengths are computed),
    'compact' (packing, the copy to the host, polyline assembly) and
    'submit' (queueing the writes, or writing them when `writer` is None).
    """
    v = torch.as_tensor(v_world, device=mesh.device)
    all_frames = frames is None
    frames = list(range(v.shape[0])) if all_frames else list(frames)
    vsel = v if all_frames else v[torch.as_tensor(frames, dtype=torch.long,
                                                  device=v.device)]
    t0 = time.perf_counter()
    traced = stream_ops.trace_frames(
        mesh, vsel, max_steps=config.analysis.max_streamline_steps,
        quirks=config.reference_quirks, rows=False)
    if timings is not None:
        _sync(v.device)
    t1 = time.perf_counter()
    out = {}
    submit = 0.0

    def emit(i, lines):
        nonlocal submit
        k = frames[i]
        out[str(k)] = lines
        if save_path_fmt is not None:
            ts = time.perf_counter()
            io.submit_write(writer, io.save_pickle, save_path_fmt.format(frame=k),
                            {str(k): lines})
            submit += time.perf_counter() - ts

    stream_ops.compact_frames(
        mesh, traced, min_length=config.analysis.min_streamline_length,
        coord_dtype=None if config.reference_quirks else np.float32, emit=emit)
    if timings is not None:
        timings["trace"] = t1 - t0
        timings["compact"] = time.perf_counter() - t1 - submit
        timings["submit"] = submit
    return out


# ------------------------------------------------------------------- S7 ----
def winding_stage(mesh: TriMesh, v_world, singularity_points,
                  config: PipelineConfig, save_path=None, writer=None,
                  centers=None, device_mesh=None):
    """S7: winding-line extents {str(frame): [[coord, ring_count, type], ...]}
    for the frames with singularities, rows with a zero count left out.

    `centers` optionally carries the detection stage's per-frame snapped
    center vertex ids (singularity_stage(return_centers=True)); without
    them the points snap again on the host (the resume-from-pickle path).
    `device_mesh` shards the profiles' frames (parallel.
    sharded_winding_movie); rank 0 writes."""
    if not writes_artifacts(device_mesh):
        save_path = None
    v = torch.as_tensor(v_world, device=mesh.device)
    n_frames = min(len(singularity_points), v.shape[0])
    caps = [len(singularity_points[t]) for t in range(n_frames)]
    smax = max(caps, default=0)
    winding_lines = {}
    if smax:
        # The coordinates go into the artifact as the detection stage gave
        # them; float64 holds them exactly.
        pts_arr = np.zeros((n_frames, smax, 3), dtype=np.float64)
        valid = np.zeros((n_frames, smax), dtype=bool)
        centers_arr = None if centers is None else np.zeros((n_frames, smax), np.int32)
        for t in range(n_frames):
            if caps[t]:
                pts_arr[t, : caps[t]] = np.asarray(singularity_points[t])
                valid[t, : caps[t]] = True
                if centers_arr is not None:
                    centers_arr[t, : caps[t]] = np.asarray(centers[t])
        if device_mesh is not None:
            from manifold_flow_tpu_torch.parallel import sharded_winding_movie

            res = sharded_winding_movie(
                mesh, v[:n_frames], pts_arr, valid, device_mesh,
                max_level=config.analysis.max_winding_level, centers=centers_arr)
        else:
            res = wind_ops.analyze_singularities_movie(
                mesh, v[:n_frames], pts_arr, valid,
                max_level=config.analysis.max_winding_level, centers=centers_arr)
        counts, types = res.counts.numpy(), res.types.numpy()
        for t in range(n_frames):
            if caps[t]:
                winding_lines[str(t)] = [
                    [pts_arr[t, i], int(counts[t, i]), int(types[t, i])]
                    for i in range(caps[t]) if counts[t, i] != 0]
    if save_path is not None:
        io.submit_write(writer, io.save_pickle, save_path, winding_lines)
    return winding_lines
