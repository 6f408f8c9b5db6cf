"""Wrappers of the flow stage's analysis kernels (K5-K7), with their plain
torch versions.

As in `kernels.fem`: CPU tensors take the plain version; CUDA tensors launch
the kernel from `csrc/analysis_kernels.cu` or raise. Nothing falls back.
Each wrapper checks dtype, device, shape and contiguity first, allocates its
outputs with `torch.empty`, and counts its launches in the shared `LAUNCHES`.

The plain versions evaluate every sum and product as a separate torch
operation, in the JAX expression order, and the kernels round each
operation on its own in the same order (no fused multiply-adds). So on the
same inputs the two agree bit for bit in the threshold decisions: masks,
counts, compacted ids and snapped centers are equal, not merely close.

Shapes below are given at the bench problem (T=97 frames, N=3136 vertices,
M=6050 triangles, S the compaction capacity, a multiple of 8). Every kernel
here is bound by memory traffic at a few flops per byte, far below what the
H100 can feed; the whole working set fits in the 50 MB L2.
"""

from __future__ import annotations

import torch

from manifold_flow_tpu_torch.geometry.topology import closest_vertex
from manifold_flow_tpu_torch.kernels._lib import (
    _check,
    _float_dtype,
    _launch,
    _on_cuda,
)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a0 b0 + a1 b1) + a2 b2 over the last axis, each operation separate."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u x w over the last axis, in jnp.cross's component order."""
    return torch.stack([u[..., 1] * w[..., 2] - u[..., 2] * w[..., 1],
                        u[..., 2] * w[..., 0] - u[..., 0] * w[..., 2],
                        u[..., 0] * w[..., 1] - u[..., 1] * w[..., 0]], dim=-1)


def plain_speed(v_world: torch.Tensor) -> torch.Tensor:
    """|v| = sqrt(x^2 + y^2 + z^2) over the last axis."""
    return torch.sqrt(_dot3(v_world, v_world))


# ------------------------------------------------------------------ K5
def recombine_speed(v_k: torch.Tensor, basis: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5 `recombine_speed<T>`: world vectors v_world (T, N, 3), speeds
    (T, N) and the per-frame max speed v_max (T,) of velocity DOFs v_k
    (T, 2N) on the tangent bases basis (N, 2, 3).

    Replaces ops/recombine.py:20 `velocity_to_world` and :36 `world_speed`
    with the max of ops/singularity.py:72 (B8). Bound by memory traffic,
    ~12 MB in f64 at the bench shapes: it reads v_k (4.9 MB) and the bases
    (0.15 MB) and writes v_world (7.3 MB) and the speeds (2.4 MB). Design:
    one thread per (frame, vertex), blocks of one frame each; the block's max
    goes to v_max by an atomicMax on the bit pattern (speeds are >= +0),
    which is exact in any order.
    """
    dtype = _float_dtype("v_k", v_k)
    if v_k.dim() != 2:
        raise ValueError(f"v_k must be (T, 2N); got {tuple(v_k.shape)}")
    t, n = v_k.shape[0], basis.shape[0]
    _check("v_k", v_k, dtype, (t, 2 * n))
    _check("basis", basis, dtype, (n, 2, 3))
    if not _on_cuda(v_k, basis):
        return plain_recombine_speed(v_k, basis)
    v_world = torch.empty((t, n, 3), dtype=dtype, device=v_k.device)
    speed = torch.empty((t, n), dtype=dtype, device=v_k.device)
    v_max = torch.empty((t,), dtype=dtype, device=v_k.device)
    _launch("recombine_speed", dtype, v_k.device, v_k.data_ptr(),
            basis.data_ptr(), v_world.data_ptr(), speed.data_ptr(),
            v_max.data_ptr(), t, n)
    return v_world, speed, v_max


def plain_recombine_speed(v_k, basis):
    """Plain torch version of `recombine_speed`."""
    n = basis.shape[0]
    v_world = v_k[:, :n, None] * basis[:, 0] + v_k[:, n:, None] * basis[:, 1]
    speed = plain_speed(v_world)
    return v_world, speed, speed.amax(dim=-1)


# ------------------------------------------------------------------ K6
def detect_singular(points: torch.Tensor, triangles: torch.Tensor,
                    v_world: torch.Tensor, speed: torch.Tensor,
                    v_max: torch.Tensor, eps: float):
    """K6 `detect_singular<T>`: singular vertices and triangle-interior
    zeros of every frame, with per-frame counts.

    points (N, 3) and v_world (T, N, 3) in one dtype; triangles (M, 3)
    int32; speed (T, N) and v_max (T,) as `recombine_speed` gives them.
    Returns vertex_mask (T, N) bool, interior_mask (T, M) bool,
    interior_bary (T, M, 2), interior_point (T, M, 3) and counts (T, 2)
    int32 (singular vertices, interior zeros).

    Replaces ops/singularity.py:54 `detect`, :356 `detection_counts` and
    :371 `detect_with_counts` (B8). Bound by memory traffic, ~30 MB in f64
    at the bench shapes: v_world gathered three times per triangle (7.3 MB
    each pass, mostly from L2), the interior points (14.1 MB) and
    barycentric pairs (9.4 MB) written for every triangle, as in JAX.
    Design: one thread per (frame, vertex) for the vertex test and one per
    (frame, triangle) for the normal-equation solve, which re-derives its
    corners' vertex test from speed and v_max instead of reading the mask;
    each block counts its hits with __syncthreads_count and adds them to the
    frame's count with an integer atomicAdd (exact in any order).
    """
    dtype = _float_dtype("v_world", v_world)
    t, n = v_world.shape[0], points.shape[0]
    m = triangles.shape[0]
    _check("points", points, dtype, (n, 3))
    _check("triangles", triangles, torch.int32, (m, 3))
    _check("v_world", v_world, dtype, (t, n, 3))
    _check("speed", speed, dtype, (t, n))
    _check("v_max", v_max, dtype, (t,))
    if not _on_cuda(points, triangles, v_world, speed, v_max):
        return plain_detect_singular(points, triangles, v_world, speed, v_max, eps)
    device = v_world.device
    vertex_mask = torch.empty((t, n), dtype=torch.bool, device=device)
    interior_mask = torch.empty((t, m), dtype=torch.bool, device=device)
    bary = torch.empty((t, m, 2), dtype=dtype, device=device)
    point = torch.empty((t, m, 3), dtype=dtype, device=device)
    counts = torch.empty((t, 2), dtype=torch.int32, device=device)
    _launch("detect_singular", dtype, device, points.data_ptr(),
            triangles.data_ptr(), v_world.data_ptr(), speed.data_ptr(),
            v_max.data_ptr(), float(eps), vertex_mask.data_ptr(),
            interior_mask.data_ptr(), bary.data_ptr(), point.data_ptr(),
            counts.data_ptr(), t, n, m)
    return vertex_mask, interior_mask, bary, point, counts


def plain_detect_singular(points, triangles, v_world, speed, v_max, eps):
    """Plain torch version of `detect_singular` (ops/singularity.py:71-112)."""
    vertex_mask = (speed / v_max[:, None]) <= eps
    tri = triangles.long()
    p = points[tri]                                          # (M, 3, 3)
    nrm = _cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    nn = torch.sqrt(_dot3(nrm, nrm))
    nrm = (nrm / torch.where(nn > 0, nn, torch.ones_like(nn))[:, None])[None, :, None, :]
    vt = (v_world / v_max[:, None, None])[:, tri]            # (T, M, 3, 3)
    vproj = vt - _dot3(vt, nrm)[..., None] * nrm
    va, vb, vc = vproj.unbind(dim=-2)
    c1, c2 = va - vc, vb - vc
    a11, a12, a22 = _dot3(c1, c1), _dot3(c1, c2), _dot3(c2, c2)
    b1, b2 = -_dot3(c1, vc), -_dot3(c2, vc)
    det = a11 * a22 - a12 * a12
    solvable = det.abs() > 0
    safe = torch.where(solvable, det, torch.ones_like(det))
    lam = (b1 * a22 - b2 * a12) / safe
    mu = (a11 * b2 - a12 * b1) / safe
    inside = (lam >= 0) & (mu >= 0) & (lam + mu <= 1)
    touches = vertex_mask[:, tri].any(dim=-1)
    interior_mask = solvable & inside & ~touches
    w3 = 1.0 - lam - mu
    point = (lam[..., None] * p[:, 0] + mu[..., None] * p[:, 1]
             + w3[..., None] * p[:, 2])
    counts = torch.stack([vertex_mask.sum(dim=1), interior_mask.sum(dim=1)],
                         dim=-1).to(torch.int32)
    return (vertex_mask, interior_mask, torch.stack([lam, mu], dim=-1), point,
            counts)


# ------------------------------------------------------------------ K7
def compact_detected(vertex_mask: torch.Tensor, interior_mask: torch.Tensor,
                     interior_point: torch.Tensor, points: torch.Tensor,
                     capacity: int):
    """K7 `compact_detected<T>`: each frame's detections compacted to
    `capacity` slots, with every interior slot's point snapped to its
    nearest vertex.

    vertex_mask (T, N) and interior_mask (T, M) bool; interior_point
    (T, M, 3) and points (N, 3) in one dtype. Returns vertex_ids and
    vertex_valid (T, S_v), interior_ids and interior_valid (T, S_i),
    interior_points (T, S_i, 3) and interior_centers (T, S_i) int32, with
    S_v = min(capacity, N) and S_i = min(capacity, M), as slicing the JAX
    argsort gives. Ids are those of `argsort(~mask, stable=True)[:, :S]`:
    the masked ids ascending, then the lowest unmasked ids (invalid slots).

    Replaces ops/singularity.py:394 `compact_detected` and the snap of
    geometry/topology.py:26 `closest_vertex` (B8). Bound by the snap's
    reads: S_i slots times N vertices per frame, 24 bytes each in f64,
    mostly from L2 (1.2 MB per frame, 117 MB per call at S=16); the
    compaction reads the masks (0.9 MB) twice. Design: one block per frame;
    a block-wide prefix scan of each mask (warp ballot, then per-warp totals
    in shared memory) places each id in its slot; one warp per slot scans
    the vertices for the (d^2, index) minimum, ties to the lower index as
    argmin does.
    """
    dtype = _float_dtype("interior_point", interior_point)
    t, n = vertex_mask.shape[0], points.shape[0]
    m = interior_mask.shape[1] if interior_mask.dim() == 2 else -1
    _check("vertex_mask", vertex_mask, torch.bool, (t, n))
    _check("interior_mask", interior_mask, torch.bool, (t, m))
    _check("interior_point", interior_point, dtype, (t, m, 3))
    _check("points", points, dtype, (n, 3))
    if int(capacity) < 1:
        raise ValueError(f"capacity must be >= 1; got {capacity!r}")
    if not _on_cuda(vertex_mask, interior_mask, interior_point, points):
        return plain_compact_detected(vertex_mask, interior_mask,
                                      interior_point, points, capacity)
    cap_v, cap_i = min(int(capacity), n), min(int(capacity), m)
    device = interior_point.device
    out = (torch.empty((t, cap_v), dtype=torch.int32, device=device),
           torch.empty((t, cap_v), dtype=torch.bool, device=device),
           torch.empty((t, cap_i), dtype=torch.int32, device=device),
           torch.empty((t, cap_i), dtype=torch.bool, device=device),
           torch.empty((t, cap_i, 3), dtype=dtype, device=device),
           torch.empty((t, cap_i), dtype=torch.int32, device=device))
    _launch("compact_detected", dtype, device, vertex_mask.data_ptr(),
            interior_mask.data_ptr(), interior_point.data_ptr(),
            points.data_ptr(), *(o.data_ptr() for o in out), t, n, m, cap_v,
            cap_i)
    return out


def plain_compact_detected(vertex_mask, interior_mask, interior_point, points,
                           capacity):
    """Plain torch version of `compact_detected` (ops/singularity.py:413-426)."""
    def compact(mask):
        order = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)
        idx = order[:, :int(capacity)]
        return idx, torch.gather(mask, 1, idx)

    idx_v, valid_v = compact(vertex_mask)
    idx_i, valid_i = compact(interior_mask)
    pts_i = torch.gather(interior_point, 1, idx_i[..., None].expand(-1, -1, 3))
    return (idx_v.to(torch.int32), valid_v, idx_i.to(torch.int32), valid_i,
            pts_i, closest_vertex(points, pts_i))
