"""Winding-number ("winding line") analysis around singularities.

Counterpart of manifold_flow_tpu/ops/winding.py (reference:
S7_winding_line.py). Concentric vertex rings come from the breadth-first
levels of the center vertex; each ring's members are sorted by polar angle
on the center's tangent plane, and the ring's winding number is the sum of
the signed angles between consecutive members' velocity directions over
2 pi (S7:59-165). Ring 1 fixes the type (+1 node/focus, -1 saddle), and the
count runs while later rings keep |w - type| <= 0.001 (S7:104-158).

The ring tables depend on the mesh and the center only, so they are built
once per distinct center, in torch (`ring_tables`: the levels, one stable
argsort of the (level, angle) key, and searchsorted ring bounds); K15
(`kernels.winding.winding_profile`) then profiles every (center, frame)
pair. The JAX package's choice between a per-center grid and per-slot
profiles, and the limits that pick it, sized TPU gathers and intermediates;
here every profile comes from the kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from manifold_flow_tpu_torch.geometry.mesh import TriMesh
from manifold_flow_tpu_torch.geometry.tangent import position_diff_on_basis
from manifold_flow_tpu_torch.geometry.topology import bfs_levels, closest_vertex
from manifold_flow_tpu_torch.kernels import winding as kwi
from manifold_flow_tpu_torch.kernels.winding import _signed_angle


class WindingResult(NamedTuple):
    counts: torch.Tensor           # (..., S) rings with persistent winding number
    types: torch.Tensor            # (..., S) +1 node/focus, -1 saddle, 0 unmatched
    winding_numbers: torch.Tensor  # (..., S, L) per-ring winding numbers


def ring_winding_number(uv: torch.Tensor, vxy: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Winding number of the 2-D field `vxy` (N, 2) over the masked ring
    (ops/winding.py:47): members sorted by the polar angle of `uv` (N, 2),
    signed angles between consecutive unit vectors, closing pair included,
    over 2 pi."""
    key = torch.where(mask, torch.atan2(uv[:, 1], uv[:, 0]),
                      torch.full_like(uv[:, 0], 1e30))
    vs = vxy[torch.argsort(key, stable=True)]
    k = int(mask.sum())
    idx = torch.arange(mask.shape[0], device=uv.device)
    nxt = torch.where(idx + 1 < k, idx + 1, 0)
    nrm = torch.sqrt(vs[:, 0] * vs[:, 0] + vs[:, 1] * vs[:, 1])[:, None]
    us = vs / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    ang = _signed_angle(us[:, 0], us[:, 1], us[nxt, 0], us[nxt, 1])
    return torch.where(idx < k, ang, torch.zeros_like(ang)).sum() / (2.0 * math.pi)


class RingTables(NamedTuple):
    """Frame-independent per-center tables (ops/winding.py:87 _RingTables),
    one row per center, truncated to the ring members."""

    order: torch.Tensor   # (U, R) int32 members sorted by (ring, angle); R the
    #                       most ring members of any center (entries past a
    #                       center's bounds[-1] are never read)
    bounds: torch.Tensor  # (U, L+1) int32 ring r is order[:, b[r]:b[r+1]]
    e1: torch.Tensor      # (U, 3) the center's tangent basis
    e2: torch.Tensor      # (U, 3)


def ring_tables(mesh: TriMesh, centers: torch.Tensor, max_level: int,
                dtype: torch.dtype) -> RingTables:
    """Ring tables of `centers` (U,) (ops/winding.py:100 `_ring_tables`,
    batched): one stable argsort of the key level + (theta + pi) /
    (2 pi + 1e-6), formed in `dtype`, groups each ring contiguously in
    anticlockwise order; ring bounds come from one searchsorted. The order
    is cut at the end of ring max_level: only ring members are read."""
    centers = centers.to(mesh.device).long()
    levels = bfs_levels(mesh.vertex_neighbors, centers, max_level)   # (U, N)
    e1 = mesh.basis[centers, 0].to(dtype)
    e2 = mesh.basis[centers, 1].to(dtype)
    pts = mesh.points.to(dtype)
    uv = position_diff_on_basis(pts[centers][:, None], pts[None], e1[:, None],
                                e2[:, None])
    theta = torch.atan2(uv[..., 1], uv[..., 0])
    in_ring = (levels >= 1) & (levels <= max_level)
    frac = (theta + math.pi) / (2.0 * math.pi + 1e-6)
    key = torch.where(in_ring, levels.to(dtype) + frac,
                      torch.full_like(frac, math.inf))
    order = torch.argsort(key, dim=-1, stable=True)
    lvl = torch.gather(torch.where(in_ring, levels, max_level + 1), 1, order)
    rings = torch.arange(1, max_level + 2, dtype=lvl.dtype, device=lvl.device)
    bounds = torch.searchsorted(lvl.contiguous(),
                                rings.expand(lvl.shape[0], -1).contiguous())
    width = int(bounds[:, -1].max()) if bounds.shape[0] else 0
    return RingTables(order=order[:, :width].to(torch.int32).contiguous(),
                      bounds=bounds.to(torch.int32).contiguous(),
                      e1=e1.contiguous(), e2=e2.contiguous())


def center_profiles(mesh: TriMesh, v_world: torch.Tensor, centers: torch.Tensor,
                    max_level: int = 25):
    """(counts (U, T), types (U, T), winding numbers (U, T, L)) of every
    (center, frame) pair: the ring tables of `centers` (U,), then K15."""
    tabs = ring_tables(mesh, centers, max_level, v_world.dtype)
    return kwi.winding_profile(v_world.contiguous(), tabs.order, tabs.bounds,
                               tabs.e1, tabs.e2)


def winding_profile(mesh: TriMesh, v_world_frame: torch.Tensor, center,
                    max_level: int = 25) -> torch.Tensor:
    """Winding numbers (max_level,) for rings 1..max_level around vertex
    `center`, of one frame's (N, 3) field (ops/winding.py:162)."""
    center = torch.as_tensor(center, device=mesh.device).reshape(1)
    return center_profiles(mesh, v_world_frame[None], center, max_level)[2][0, 0]


def scale_map(mesh: TriMesh, singularity_points, counts) -> torch.Tensor:
    """Per-vertex winding-line 'scale' field (N,) float32 for visualization
    (ops/winding.py:187; calculate_scale_values, S7:167-183): the snapped
    center of singularity i gets counts[i] + 1, its k-th ring (k = 1..
    counts[i]) gets counts[i] - (k - 1); later singularities overwrite
    earlier ones where their value is nonzero."""
    device = mesh.device
    pts = torch.as_tensor(np.asarray(singularity_points), device=device)
    counts = torch.as_tensor(np.asarray(counts), device=device)
    if pts.shape[0] == 0:
        return torch.zeros((mesh.n_vertices,), dtype=torch.float32, device=device)
    max_level = max(int(counts.max()), 1)
    centers = closest_vertex(mesh.points, pts.to(mesh.points.dtype))
    levels = bfs_levels(mesh.vertex_neighbors, centers, max_level)   # (S, N)
    c = counts[:, None].to(torch.float32)
    ring = torch.where((levels >= 1) & (levels <= counts[:, None]),
                       c - (levels.to(torch.float32) - 1.0), torch.zeros_like(c))
    rows = torch.arange(pts.shape[0], device=device)
    ring[rows, centers.long()] = counts.to(torch.float32) + 1.0
    written = ring != 0.0
    last = torch.where(written, rows[:, None], -1).argmax(dim=0)      # (N,)
    out = torch.gather(ring, 0, last[None])[0]
    return torch.where(written.any(dim=0), out, torch.zeros_like(out))


def analyze_singularities(mesh: TriMesh, v_world_frame: torch.Tensor,
                          points: torch.Tensor, valid: torch.Tensor,
                          max_level: int = 25) -> WindingResult:
    """Winding analysis for one frame's singularity list
    (ops/winding.py:236): points (S, 3) snap to their closest vertex; an
    invalid slot gets count 0, type 0 and zero winding numbers."""
    valid = torch.as_tensor(valid, device=mesh.device)
    points = torch.as_tensor(points, device=mesh.device).to(mesh.points.dtype)
    centers = closest_vertex(mesh.points, points)
    counts, types, ws = center_profiles(mesh, v_world_frame[None], centers, max_level)
    zero = torch.zeros_like(counts[:, 0])
    return WindingResult(
        counts=torch.where(valid, counts[:, 0], zero),
        types=torch.where(valid, types[:, 0], zero),
        winding_numbers=torch.where(valid[:, None], ws[:, 0],
                                    torch.zeros_like(ws[:, 0])))


def snap_and_dedup_centers(mesh: TriMesh, points, valid, centers=None):
    """Host-side center snap and dedup (ops/winding.py:264).

    points (T, S, 3) fixed-capacity singularity coordinates, valid (T, S).
    `centers` (T, S) optionally supplies the snapped center vertex ids (the
    detection stage's, `singularity.compact_detected`); without them the
    points snap on the host through the float32 GEMM expansion
    argmin_p (|p|^2 - 2 q.p), as the JAX package does. Returns (uniq (U,)
    int32 distinct snapped centers of the valid slots, ascending, and u_idx
    (T, S) int32 mapping each slot to its row; invalid slots map
    arbitrarily). JAX pads uniq to a multiple of 8 for XLA shape buckets;
    the port does not."""
    from manifold_flow_tpu_torch.utils.io import to_numpy

    q = np.asarray(points, dtype=np.float64)
    t, s = q.shape[0], q.shape[1]
    vmask = np.asarray(valid, dtype=bool)
    if centers is not None:
        centers = np.asarray(centers, dtype=np.int32).reshape(t, s)
    else:
        (pts,) = to_numpy(mesh.points)
        pts32 = np.asarray(pts, dtype=np.float64).astype(np.float32)
        q32 = q.reshape(-1, 3).astype(np.float32)
        pn = (pts32 * pts32).sum(-1)
        score = pn[None, :] - 2.0 * (q32 @ pts32.T)
        centers = score.argmin(axis=1).astype(np.int32).reshape(t, s)
    uniq = np.unique(centers[vmask]).astype(np.int32)
    u_idx = np.searchsorted(uniq, centers.reshape(-1)).clip(0, max(len(uniq) - 1, 0))
    return uniq, u_idx.astype(np.int32).reshape(t, s)


def select_slots_host(cu, tu, wu, u_idx, vmask) -> WindingResult:
    """Map each (frame, slot) to its unique center's row of the per-center
    movie results (cu, tu (U, T), wu (U, T, L), numpy), masking invalid
    slots to zero (ops/winding.py:308); returns CPU tensors."""
    t = u_idx.shape[0]
    ti = np.arange(t)[:, None]
    counts = np.where(vmask, cu[u_idx, ti], 0).astype(np.int32)
    types = np.where(vmask, tu[u_idx, ti], 0).astype(np.int32)
    ws = np.where(vmask[..., None], wu[u_idx, ti], 0.0)
    return WindingResult(counts=torch.from_numpy(counts),
                         types=torch.from_numpy(types),
                         winding_numbers=torch.from_numpy(ws))


def analyze_singularities_movie(mesh: TriMesh, v_world, points, valid,
                                max_level: int = 25,
                                centers=None) -> WindingResult:
    """Winding analysis of the whole movie (ops/winding.py:325).

    points (T, S, 3) fixed-capacity singularity coordinates per frame,
    valid (T, S), `centers` (T, S) optional snapped center ids (see
    `snap_and_dedup_centers`). Singularities persist across frames, so the
    T*S slots snap to a few distinct centers: ring tables are built once
    per distinct center and K15 profiles every (center, frame) pair; the
    slots then select their center's row on the host. Returns CPU tensors
    with (T, S) leading dims, in v_world's dtype."""
    from manifold_flow_tpu_torch.utils.io import to_numpy

    t, s = np.shape(points)[0], np.shape(points)[1]
    vmask = np.asarray(valid, dtype=bool)
    if t * s == 0 or not vmask.any():
        return WindingResult(
            counts=torch.zeros((t, s), dtype=torch.int32),
            types=torch.zeros((t, s), dtype=torch.int32),
            winding_numbers=torch.zeros((t, s, max_level), dtype=torch.float32))
    uniq, u_idx = snap_and_dedup_centers(mesh, points, vmask, centers=centers)
    v = torch.as_tensor(v_world, device=mesh.device)
    cu, tu, wu = to_numpy(*center_profiles(mesh, v, torch.from_numpy(uniq),
                                           max_level))
    return select_slots_host(cu, tu, wu, u_idx, vmask)
