"""Frames-sharded analysis stages: S3 detection, S5 wave speeds, S7 winding.

Counterpart of manifold_flow_tpu/parallel/analysis.py. Each frames rank runs
the single-device kernels on its block of the frame axis (padded with zero
frames to a multiple of the frame shards, as in JAX), and the per-frame
results are all-gathered over 'frames', so every rank returns the whole
movie's result, equal to the single-device op's:

  * detection: K6 (and K7's counts: the per-movie maximum of the gathered
    per-frame counts) on the rank's frames;
  * wave speeds: K16 on the rank's frames plus the +-2 neighbouring frames
    its temporal stencil reads, the neighbours' results dropped;
  * winding: the centers snap and dedup on the host once, K15 profiles the
    rank's frames of every distinct center, and the shared
    `select_slots_host` maps slots to their center's rows (one formulation,
    K15: the JAX package's grid/slots dispatch and its chunking under a TPU
    memory ceiling are not ported).

The JAX `_PROGRAM_CACHE` holds compiled XLA programs; eager launches need
none.
"""

from __future__ import annotations

import numpy as np
import torch

from manifold_flow_tpu_torch.geometry.mesh import TriMesh
from manifold_flow_tpu_torch.ops import singularity as sing_ops
from manifold_flow_tpu_torch.ops import wavespeed as wave_ops
from manifold_flow_tpu_torch.ops import winding as wind_ops
from manifold_flow_tpu_torch.ops.recombine import world_speed
from manifold_flow_tpu_torch.parallel.partition import (
    DeviceMesh,
    frame_block,
    gather_frames,
    pad_frames,
)


def _my_frames(x: torch.Tensor, device_mesh: DeviceMesh) -> torch.Tensor:
    """This frames rank's block of x (T, ...), zero frames past the end."""
    t = x.shape[0]
    lo, hi, tl = frame_block(t, device_mesh.shape["frames"], device_mesh.coordinate[0])
    return pad_frames(x[lo:hi], tl).contiguous()


def _detect(mesh, v_world, device_mesh, eps, speed, v_max):
    v = torch.as_tensor(v_world, device=mesh.device)
    if (speed is None) != (v_max is None):
        raise ValueError("pass speed and v_max together, or neither")
    if speed is None:
        speed = world_speed(v)
        v_max = speed.amax(dim=-1)
    t = v.shape[0]
    field, _ = sing_ops.detect_with_counts(
        mesh, _my_frames(v, device_mesh), eps=eps,
        speed=_my_frames(torch.as_tensor(speed, device=mesh.device), device_mesh),
        v_max=_my_frames(torch.as_tensor(v_max, device=mesh.device), device_mesh))
    comm = device_mesh.comm("frames")
    return sing_ops.SingularityField(*(gather_frames(comm, leaf, t) for leaf in field))


def sharded_detect(mesh: TriMesh, v_world, device_mesh: DeviceMesh,
                   eps: float = 1e-4, speed=None, v_max=None) -> sing_ops.SingularityField:
    """Frames-sharded singularity detection: each rank runs K6 on its frame
    block (per-frame normalization makes it a pure map), then the fields
    are gathered. speed (T, N) and v_max (T,) as in ops.singularity.detect:
    required on CUDA tensors, computed from v_world on CPU ones."""
    return _detect(mesh, v_world, device_mesh, eps, speed, v_max)


def sharded_detect_with_counts(mesh: TriMesh, v_world, device_mesh: DeviceMesh,
                               eps: float = 1e-4, speed=None, v_max=None):
    """Frames-sharded ops.singularity.detect_with_counts: (field, counts
    (2,) int32), the counts the maximum over the gathered real frames."""
    field = _detect(mesh, v_world, device_mesh, eps, speed, v_max)
    return field, sing_ops._movie_counts(field.counts)


def sharded_wave_velocity(mesh: TriMesh, movie, dt: float, device_mesh: DeviceMesh,
                          method: str = "phase") -> torch.Tensor:
    """Frames-sharded wave speeds (T, N), equal to the single-device stage's:
    method='phase' gives |speed| / 1000 (S5:311-313), 'amplitude' the raw
    amplitude speeds. Each rank runs K16 on its frames and the +-2 frames
    around them that the temporal stencil needs."""
    if method not in ("phase", "amplitude"):
        raise ValueError(f"unknown wavespeed method {method!r}")
    mv = torch.as_tensor(movie, device=mesh.device)
    t = mv.shape[0]
    if t < 3:
        raise ValueError("wave speeds need at least 3 frames")
    lo, hi, tl = frame_block(t, device_mesh.shape["frames"], device_mesh.coordinate[0])
    speed_of = (wave_ops.wave_velocity_phase_mm_per_ms if method == "phase"
                else wave_ops.wave_velocity_amplitude)
    if hi > lo:
        a, b = max(lo - 2, 0), min(hi + 2, t)
        ws = speed_of(mesh, mv[a:b], dt)[lo - a: hi - a]
    else:
        ws = mv.new_zeros((0, mv.shape[1]))
    return gather_frames(device_mesh.comm("frames"), pad_frames(ws, tl).contiguous(), t)


def sharded_winding_grid(mesh: TriMesh, v_world, centers_u, device_mesh: DeviceMesh,
                         max_level: int = 25):
    """(counts (U, T), types (U, T), winding numbers (U, T, L)) of every
    (center, frame) pair of the distinct centers `centers_u` (U,): K15 on
    the rank's frames, gathered over 'frames'."""
    v = torch.as_tensor(v_world, device=mesh.device)
    t = v.shape[0]
    centers = torch.as_tensor(np.asarray(centers_u), device=mesh.device)
    out = wind_ops.center_profiles(mesh, _my_frames(v, device_mesh), centers, max_level)
    comm = device_mesh.comm("frames")
    return tuple(gather_frames(comm, leaf.transpose(0, 1).contiguous(), t).transpose(0, 1)
                 for leaf in out)


def sharded_winding_movie(mesh: TriMesh, v_world, points, valid,
                          device_mesh: DeviceMesh, max_level: int = 25,
                          centers=None) -> wind_ops.WindingResult:
    """Frames-sharded ops.winding.analyze_singularities_movie: host center
    snap and dedup, the profiles of the rank's frames (K15), the shared host
    slot selection. Equal to the single-device op; CPU tensors."""
    from manifold_flow_tpu_torch.utils.io import to_numpy

    t, s = np.shape(points)[0], np.shape(points)[1]
    vmask = np.asarray(valid, dtype=bool)
    if t * s == 0 or not vmask.any():
        return wind_ops.WindingResult(
            counts=torch.zeros((t, s), dtype=torch.int32),
            types=torch.zeros((t, s), dtype=torch.int32),
            winding_numbers=torch.zeros((t, s, max_level), dtype=torch.float32))
    uniq, u_idx = wind_ops.snap_and_dedup_centers(mesh, points, vmask, centers=centers)
    cu, tu, wu = to_numpy(*sharded_winding_grid(mesh, v_world, uniq, device_mesh,
                                                max_level))
    return wind_ops.select_slots_host(cu, tu, wu, u_idx, vmask)
