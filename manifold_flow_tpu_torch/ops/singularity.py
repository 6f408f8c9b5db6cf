"""Singularity detection and classification on velocity movies.

Counterpart of manifold_flow_tpu/ops/singularity.py. Every vertex, triangle
and frame is tested at once with masks (K6, `kernels.analysis.
detect_singular`); the masks then compact to a fixed capacity per frame with
each interior zero snapped to its nearest vertex (K7, `kernels.analysis.
compact_detected`); `compact_all` / `compact_frame` turn the result into the
reference's per-frame Python lists on the host. Classification computes the
reference's finite-difference Jacobian at the compacted candidates and its
node / focus / saddle code (K12, `kernels.analysis.classify_candidates`);
`vertex_jacobians`, `interior_jacobians` and `classify` run the same kernel
over every vertex or triangle.

Everything runs in the velocity field's dtype: the mesh points (and bases)
are cast to it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from manifold_flow_tpu_torch.geometry.mesh import TriMesh
from manifold_flow_tpu_torch.geometry.topology import cells_across_edges
from manifold_flow_tpu_torch.kernels import analysis as kan
from manifold_flow_tpu_torch.kernels.analysis import (  # noqa: F401 (JAX names)
    FOCUS,
    INDETERMINATE,
    NODE,
    SADDLE,
    _nearest_edge,
    classify_jacobian,
)
from manifold_flow_tpu_torch.ops.recombine import world_speed
from manifold_flow_tpu_torch.utils import profiling

# Class names by code (classify_critical_point,
# utils/find_singularity_point.py:463-498; the finer stable/unstable branches
# there are dead code after the early returns).
CLASS_NAMES = ("Node", "Focus", "Saddle", "Indeterminate")


class SingularityField(NamedTuple):
    """Per-frame masked singularity data (leading axis = frames).

    vertex_mask    (T, N)  vertex singular (|v|/vmax <= eps)
    interior_mask  (T, M)  triangle-interior zero found
    interior_bary  (T, M, 2) (lam, mu) barycentric coords of the zero
    interior_point (T, M, 3) world coords of the interior zero
    v_max          (T,)    per-frame max |v| (the normalizer)
    counts         (T, 2)  int32 per-frame candidates (vertex, interior),
                           as the detection kernel counted them
    """

    vertex_mask: torch.Tensor
    interior_mask: torch.Tensor
    interior_bary: torch.Tensor
    interior_point: torch.Tensor
    v_max: torch.Tensor
    counts: torch.Tensor


def _movie_counts(counts: torch.Tensor) -> torch.Tensor:
    """(T, 2) per-frame counts -> (2,) maximum over frames; (0, 0) for a
    movie with no frames."""
    if counts.shape[0] == 0:
        return torch.zeros(2, dtype=torch.int32, device=counts.device)
    return counts.amax(dim=0)


def detect_with_counts(mesh: TriMesh, v_world: torch.Tensor, eps: float = 1e-4,
                       speed: torch.Tensor | None = None,
                       v_max: torch.Tensor | None = None):
    """`detect` and the per-movie maximum per-frame candidate counts, as
    (field, counts (2,) int32) on the field's device: reading the two ints
    is the one host sync that sizes the compaction.

    speed (T, N) and v_max (T,) are those of `velocity_to_world_and_speed`
    (the velocity stage has them already). On CPU tensors they may be left
    out and are then computed here from v_world; on CUDA tensors they are
    required (`recombine.world_speed` raises there).
    """
    if (speed is None) != (v_max is None):
        raise ValueError("pass speed and v_max together, or neither")
    v_world = v_world.contiguous()
    if speed is None:
        speed = world_speed(v_world)
        v_max = speed.amax(dim=-1)
    vertex_mask, interior_mask, bary, point, counts = kan.detect_singular(
        mesh.points.to(v_world.dtype).contiguous(), mesh.triangles, v_world,
        speed.contiguous(), v_max.contiguous(), eps)
    field = SingularityField(vertex_mask, interior_mask, bary, point, v_max,
                             counts)
    return field, _movie_counts(counts)


def detect(mesh: TriMesh, v_world: torch.Tensor, eps: float = 1e-4,
           speed: torch.Tensor | None = None,
           v_max: torch.Tensor | None = None) -> SingularityField:
    """Find singular vertices and triangle-interior zeros for all frames.

    v_world: (T, N, 3) world-frame velocity vectors (from velocity_to_world).
    eps: normalized-speed threshold (config.yaml:4).
    speed, v_max: as in `detect_with_counts`; required on CUDA tensors.

    Mirrors find_singularity_points (utils/find_singularity_point.py:140-189):
    speeds are normalized by the per-frame max; triangles touching a singular
    vertex are skipped; the interior test projects corner velocities onto the
    triangle plane and solves [VA-VC, VB-VC] [lam, mu]^T = -VC in the
    least-squares sense, accepting lam >= 0, mu >= 0, lam + mu <= 1.
    """
    return detect_with_counts(mesh, v_world, eps, speed, v_max)[0]


def detection_counts(field: SingularityField):
    """Per-movie maximum per-frame candidate counts (vertex, interior), as
    two int32 scalars, read from the detection kernel's counts; (0, 0) for a
    movie with no frames."""
    vc, ic = _movie_counts(field.counts)
    return vc, ic


class CompactDetections(NamedTuple):
    """Detections compacted to `capacity` slots per frame (device-side)."""

    vertex_ids: torch.Tensor        # (T, S) int32
    vertex_valid: torch.Tensor      # (T, S) bool
    interior_ids: torch.Tensor      # (T, S) int32
    interior_valid: torch.Tensor    # (T, S) bool
    interior_points: torch.Tensor   # (T, S, 3)
    interior_centers: torch.Tensor  # (T, S) nearest vertex per point


def compact_detected(mesh: TriMesh, field: SingularityField,
                     capacity: int = 16) -> CompactDetections:
    """Compact the detection masks to fixed-capacity id lists on the device.

    Ids stay in ascending order per frame (a stable argsort of the mask),
    matching np.where on the host. `interior_centers` snaps each compacted
    interior point to its nearest vertex, for the winding analysis (S7:130);
    vertex candidates snap to themselves (vertex_ids).
    """
    point = field.interior_point
    return CompactDetections(*kan.compact_detected(
        field.vertex_mask.contiguous(), field.interior_mask.contiguous(),
        point.contiguous(), mesh.points.to(point.dtype).contiguous(),
        capacity))


def capacity_for(vertex_count: int, interior_count: int) -> int:
    """The compaction capacity for per-frame maximum candidate counts: the
    larger, at least 1, rounded up to a multiple of 8."""
    cap = max(int(vertex_count), int(interior_count), 1)
    return -(-cap // 8) * 8


def compact_capacity(field: SingularityField) -> int:
    """Fixed per-frame candidate capacity for the movie (`capacity_for` of
    `detection_counts`)."""
    return capacity_for(*detection_counts(field))


class DetectedClasses(NamedTuple):
    """Class codes of the compacted candidates (ops/singularity.py:269), with
    K12's Jacobians of the same slots."""

    vertex_ids: torch.Tensor           # (T, S) candidate vertex ids (compacted)
    vertex_valid: torch.Tensor         # (T, S) bool
    vertex_codes: torch.Tensor         # (T, S) int32 class codes
    interior_ids: torch.Tensor         # (T, S) candidate triangle ids
    interior_valid: torch.Tensor       # (T, S) bool
    interior_codes: torch.Tensor       # (T, S) int32 class codes
    vertex_jacobians: torch.Tensor     # (T, S, 2, 2)
    interior_jacobians: torch.Tensor   # (T, S, 2, 2)


def _classify(mesh: TriMesh, v_world: torch.Tensor, v_max: torch.Tensor,
              vertex_ids, vertex_valid, interior_ids, interior_valid,
              interior_points, quirks: bool):
    """K12 on these candidate slots; velocities normalised by v_max."""
    dtype = v_world.dtype
    return kan.classify_candidates(
        mesh.points.to(dtype).contiguous(), mesh.basis.to(dtype).contiguous(),
        mesh.vertex_neighbors, mesh.triangles, cells_across_edges(mesh),
        v_world.contiguous(), v_max.to(dtype).contiguous(),
        vertex_ids.contiguous(), vertex_valid.contiguous(),
        interior_ids.contiguous(), interior_valid.contiguous(),
        interior_points.to(dtype).contiguous(), quirks=quirks)


def classify_compacted(mesh: TriMesh, v_world: torch.Tensor,
                       v_max: torch.Tensor, det: CompactDetections,
                       quirks: bool = False) -> DetectedClasses:
    """Classify the candidates that `compact_detected` (K7) compacted: their
    ids arrive in compacted order (ascending per frame), so nothing is
    sorted again."""
    vcodes, vjac, icodes, ijac = _classify(
        mesh, v_world, v_max, det.vertex_ids, det.vertex_valid,
        det.interior_ids, det.interior_valid, det.interior_points, quirks)
    return DetectedClasses(det.vertex_ids, det.vertex_valid, vcodes,
                           det.interior_ids, det.interior_valid, icodes,
                           vjac, ijac)


def classify_detected(mesh: TriMesh, v_world: torch.Tensor,
                      field: SingularityField, capacity: int = 64,
                      quirks: bool = False) -> DetectedClasses:
    """Classify only the detected candidates, at a fixed capacity per frame
    (ops/singularity.py:279): K7 compacts the masks to `capacity` slots, K12
    classifies the slots. `quirks` takes the reference's nearest-edge rule
    for interior candidates (`_nearest_edge`)."""
    det = compact_detected(mesh, field, capacity=capacity)
    return classify_compacted(mesh, v_world, field.v_max, det, quirks)


def _every(count: int, t: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    ids = torch.arange(count, dtype=torch.int32, device=device)
    ids = ids.expand(t, count).contiguous()
    return ids, torch.ones_like(ids, dtype=torch.bool)


def _nothing(t: int, v_world: torch.Tensor):
    ids = torch.zeros((t, 0), dtype=torch.int32, device=v_world.device)
    return ids, ids.bool(), torch.zeros((t, 0, 3), dtype=v_world.dtype,
                                        device=v_world.device)


def vertex_jacobians(mesh: TriMesh, v_world: torch.Tensor,
                     v_max: torch.Tensor) -> torch.Tensor:
    """2x2 Jacobians (T, N, 2, 2) at every vertex (ops/singularity.py:176),
    velocities normalised by the frame max; K12 over every vertex."""
    t = v_world.shape[0]
    ids, ok = _every(mesh.n_vertices, t, v_world.device)
    return _classify(mesh, v_world, v_max, ids, ok, *_nothing(t, v_world),
                     False)[1]


def interior_jacobians(mesh: TriMesh, v_world: torch.Tensor, v_max: torch.Tensor,
                       interior_point: torch.Tensor,
                       quirks: bool = False) -> torch.Tensor:
    """2x2 Jacobians (T, M, 2, 2) at every triangle's interior point
    (ops/singularity.py:196): the triangle's corners and those of the
    triangle across the nearest edge, on the flat triangle's basis; K12 over
    every triangle."""
    t = v_world.shape[0]
    ids, ok = _every(mesh.n_triangles, t, v_world.device)
    nothing = _nothing(t, v_world)[:2]
    return _classify(mesh, v_world, v_max, *nothing, ids, ok, interior_point,
                     quirks)[3]


def classify(mesh: TriMesh, v_world: torch.Tensor, field: SingularityField,
             quirks: bool = False):
    """Class codes for every vertex (T, N) and interior (T, M) candidate
    (ops/singularity.py:260), in one K12 call."""
    t = v_world.shape[0]
    vid, vok = _every(mesh.n_vertices, t, v_world.device)
    iid, iok = _every(mesh.n_triangles, t, v_world.device)
    codes_v, _, codes_i, _ = _classify(mesh, v_world, field.v_max, vid, vok, iid,
                                       iok, field.interior_point, quirks)
    return codes_v, codes_i


def compacted_rows(mesh: TriMesh, det: CompactDetections,
                   with_centers: bool = False):
    """Host-side: compacted detections -> reference-style lists per frame
    (see compact_all), in one wait for the device (`sync.analysis.rows`)."""
    from manifold_flow_tpu_torch.utils.io import to_numpy

    with profiling.wait("sync.analysis.rows"):
        vid, vok, iid, iok, ipts, icent, pts = to_numpy(*det, mesh.points)
    out = []
    for k in range(vid.shape[0]):
        vsel = vid[k][vok[k]]
        isel = iid[k][iok[k]]
        rows = np.concatenate([pts[vsel], ipts[k][iok[k]]], axis=0)
        kinds = ["vertex"] * len(vsel) + ["interior"] * len(isel)
        ids = list(vsel) + list(isel)
        if with_centers:
            centers = np.concatenate([vsel, icent[k][iok[k]]]).astype(np.int32)
            out.append((rows, kinds, ids, centers))
        else:
            out.append((rows, kinds, ids))
    return out


def compact_all(mesh: TriMesh, field: SingularityField,
                capacity: int | None = None, with_centers: bool = False):
    """Host-side: every frame's masked arrays -> reference-style lists.

    Returns a list over frames of (points (S, 3), kinds (S,) str
    'vertex'/'interior', ids (S,)), vertices first then interiors, matching
    the ordering of find_singularity_points_for_all_Vk
    (utils/find_singularity_point.py:550-556). The masks compact on the
    device first (`compact_detected`), so only ~capacity rows per frame
    cross to the host, in one wait.

    with_centers=True appends a 4th element per frame: the snapped center
    vertex id per singularity, the winding stage's input.
    """
    if capacity is None:
        capacity = compact_capacity(field)
    return compacted_rows(mesh, compact_detected(mesh, field, capacity=capacity),
                          with_centers)


def compact_frame(mesh: TriMesh, field: SingularityField, frame: int):
    """Host-side: one frame's masked arrays -> reference-style lists (see
    compact_all; prefer it when processing whole movies)."""
    from manifold_flow_tpu_torch.utils.io import to_numpy

    vm, im, pts, ipts = to_numpy(field.vertex_mask[frame],
                                 field.interior_mask[frame], mesh.points,
                                 field.interior_point[frame])
    out_pts = [pts[i] for i in np.where(vm)[0]]
    kinds = ["vertex"] * len(out_pts)
    ids = list(np.where(vm)[0])
    for m in np.where(im)[0]:
        out_pts.append(ipts[m])
        kinds.append("interior")
        ids.append(m)
    if out_pts:
        return np.stack(out_pts), kinds, ids
    return np.zeros((0, 3)), kinds, ids
