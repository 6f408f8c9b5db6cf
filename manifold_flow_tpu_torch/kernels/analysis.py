"""Wrappers of the flow stage's analysis kernels (K5-K7) and of the
classification kernel (K12), with their plain torch versions.

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
M=6050 triangles, S the compaction capacity, a multiple of 8), unless they
say otherwise. K5 and K6 are bound by memory traffic at a few flops per
byte, far below what the H100 can feed, K7 by its snap's float64
arithmetic, K12 by the latency of its chains of divisions; the whole
working set fits in the 50 MB L2.
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
    :371 `detect_with_counts` (B8). Bound by memory traffic, most of it
    writes: at 12.5k vertices x 97 frames in f64 it writes 99 MB (points,
    barycentric pairs, masks) and reads 39 MB (v_world, speeds), 41 us at
    3.35 TB/s; beside them run 34.8 M correctly rounded f64 divisions.
    Design: one launch. A thread takes a triangle (or a vertex) and 4
    consecutive frames, so the triangle's corners and unit normal are
    formed once for the 4; a frame's 12 corner values are all loaded before
    its first division; the (lam, mu) pair is one vector store; the
    registers are capped for 6 blocks of 128 threads an SM; each block
    counts a frame's hits by warp ballots and adds them to the frame's count
    with one integer atomic (exact in any order). Every output is bit for
    bit the first design's (one thread a (frame, element)). What holds it
    back now, the divisions' dependent chains, then the corner gathers and
    the stores, is in PERF.md.
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
    float64 arithmetic: T S_i N distances (dx^2 + dy^2) + dz^2, each of
    their 8 operations rounded on its own (no fused multiply-add, or the
    centers would move) and one comparison; 19.5 M distances at 12.5k
    vertices and S = 16, about 9.2 us at the rate of separate f64
    operations (the bound's 4.58 us counts 34 TFLOP/s, a fused
    multiply-add as two). Design: two launches on the caller's stream,
    counted as one. The compaction runs a block per (mask, frame): each
    thread counts the set bytes of a contiguous run of the row from
    16-byte loads, one block-wide scan places every run's ids, and only
    runs with a slot under S write ids and flags, from each 16-byte
    group's bit mask of set bytes; one thread a slot then copies the
    interior slots' points. The snap runs a block per (frame, 4 slots):
    its threads take the vertices in turn, each loading its next vertex
    while the current one's distances run, keep each slot's (d^2, index)
    minimum in registers, and merge them with warp shuffles, then across
    warps, in argmin's order (ties to the lower index, a NaN first). The
    first design ran a block per frame, and one warp per slot scanned the
    vertices in device memory.
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


# ------------------------------------------------------------------ K12
NODE, FOCUS, SADDLE, INDETERMINATE = 0, 1, 2, 3


def _project(v: torch.Tensor, n: torch.Tensor, nn: torch.Tensor) -> torch.Tensor:
    """v - where(n.n > 0, (v.n) / n.n, 0) n (geometry/tangent.py
    project_to_plane with n = e1 x e2 and nn = n.n), each operation
    separate."""
    pos = nn > 0
    s = torch.where(pos, _dot3(v, n) / torch.where(pos, nn, torch.ones_like(nn)),
                    torch.zeros_like(nn))
    return v - s[..., None] * n


def _reciprocal_or_zero(d: torch.Tensor) -> torch.Tensor:
    nz = d != 0
    return torch.where(nz, torch.ones_like(d) / torch.where(nz, d, torch.ones_like(d)),
                       torch.zeros_like(d))


def _jacobian_from_neighbors(origin, e1, e2, nb_points, nb_vel, nb_mask):
    """The reference's finite-difference 2x2 Jacobian (ops/singularity.py:115;
    compute_jacobian_matrix_for_vertex, utils/find_singularity_point.py:
    355-402): for each neighbor, (u, w) its velocity projected on (e1, e2)
    and (d1, d2) its projected offset from `origin`, J += [[u/d1, u/d2],
    [w/d1, w/d2]]; a zero offset contributes 0 (the reference would emit
    inf). Shapes: origin, e1, e2 (..., 1, 3); nb_points, nb_vel (..., D, 3);
    nb_mask (..., D). The masked contributions are added in neighbor order,
    one addition at a time, as K12 adds them."""
    n = _cross(e1, e2)
    nn = _dot3(n, n)
    vp = _project(nb_vel, n, nn)
    u = _dot3(vp, e1) / _dot3(e1, e1)
    w = _dot3(vp, e2) / _dot3(e2, e2)
    proj = _project(nb_points - origin, n, nn)
    i1 = _reciprocal_or_zero(_dot3(proj, e1))
    i2 = _reciprocal_or_zero(_dot3(proj, e2))
    c = torch.stack([u * i1, u * i2, w * i1, w * i2], dim=-1)        # (..., D, 4)
    c = torch.where(nb_mask[..., None], c, torch.zeros_like(c))
    jac = torch.zeros_like(c[..., 0, :])
    for d in range(c.shape[-2]):
        jac = jac + c[..., d, :]
    return jac.reshape(*jac.shape[:-1], 2, 2)


def classify_jacobian(jac: torch.Tensor) -> torch.Tensor:
    """Trace/determinant classification of (..., 2, 2) Jacobians -> int32
    codes NODE / FOCUS / SADDLE / INDETERMINATE (ops/singularity.py:166)."""
    tr = jac[..., 0, 0] + jac[..., 1, 1]
    det = jac[..., 0, 0] * jac[..., 1, 1] - jac[..., 0, 1] * jac[..., 1, 0]
    node_or_focus = torch.where(tr * tr > 4.0 * det, NODE, FOCUS)
    return torch.where(det > 0, node_or_focus,
                       torch.where(det < 0, SADDLE, INDETERMINATE)).to(torch.int32)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    nrm = torch.sqrt(_dot3(v, v))[..., None]
    ok = nrm > 0
    return torch.where(ok, v / torch.where(ok, nrm, torch.ones_like(nrm)),
                       torch.zeros_like(v))


def _tangent_basis(n: torch.Tensor):
    """geometry/tangent.py tangent_basis of unit normals (..., 3), as (e1, e2),
    each operation separate."""
    nx, ny, nz = n.unbind(-1)
    zero = torch.zeros_like(nx)
    cond = ((nx != 0) | (ny != 0))[..., None]
    e1 = _normalize(torch.where(cond, torch.stack([-ny, nx, zero], -1),
                                torch.stack([zero, -nz, ny], -1)))
    return e1, _normalize(_cross(n, e1))


def _nearest_edge(pt, pa, pb, pc, quirks: bool = False) -> torch.Tensor:
    """Index (0: AB, 1: BC, 2: CA) of the edge whose neighbor triangle joins
    an interior point's set (ops/singularity.py:133). quirks=False: the argmin
    of the true point-to-line distances. quirks=True: the reference's
    find_nearest_edge_and_vertices (utils/find_singularity_point.py:318-351),
    the argmin over the 9 |component| values of cross(P-A, B-A) / |B-A| and
    its two siblings, flat index mapped {0: AB, 1: BC, else: CA}."""
    parts = []
    for q, a, b in ((pt, pa, pb), (pt, pb, pc), (pt, pc, pa)):
        ab = b - a
        c = _cross(q - a, ab)
        den = torch.clamp_min(torch.sqrt(_dot3(ab, ab)), 1e-300)
        parts.append((c / den[..., None]).abs() if quirks
                     else (torch.sqrt(_dot3(c, c)) / den)[..., None])
    flat = torch.argmin(torch.cat(parts, dim=-1), dim=-1)
    if not quirks:
        return flat
    return torch.where(flat == 0, 0, torch.where(flat == 1, 1, 2))


def classify_candidates(points: torch.Tensor, basis: torch.Tensor,
                        vertex_neighbors: torch.Tensor, triangles: torch.Tensor,
                        across: torch.Tensor, v_world: torch.Tensor,
                        v_max: torch.Tensor, vertex_ids: torch.Tensor,
                        vertex_valid: torch.Tensor, interior_ids: torch.Tensor,
                        interior_valid: torch.Tensor,
                        interior_points: torch.Tensor, quirks: bool = False):
    """K12 `classify_candidates<T>`: the Jacobian and class code of each
    vertex and interior candidate slot of every frame.

    points (N, 3), basis (N, 2, 3), v_world (T, N, 3), v_max (T,) and
    interior_points (T, S_i, 3) in one dtype; vertex_neighbors (N, D),
    triangles and across (M, 3; `topology.cells_across_edges`) int32;
    vertex_ids (T, S_v) and interior_ids (T, S_i) int32 with their valid
    flags (bool), as K7 compacts them (either S may be 0). Returns
    vertex_codes (T, S_v) int32, vertex_jac (T, S_v, 2, 2), interior_codes
    (T, S_i) int32 and interior_jac (T, S_i, 2, 2); an invalid slot gets a
    zero Jacobian and INDETERMINATE.

    Replaces ops/singularity.py:279 `classify_detected` with :115, :133 and
    :166 (B9). Bound by latency: at the bench shapes (T=97, S=16) it reads
    a few hundred kB, the 1-ring velocities mostly from L2, but each
    neighbour's term is a chain of about nine correctly rounded divisions.
    Design: one launch, vertex blocks then interior blocks; 8 lanes a
    (frame, slot), one neighbour a lane, the lanes' terms added in table
    order through shuffles; an interior slot's lanes measure one edge each
    for the nearest edge. Every operation is rounded on its own, in this
    module's plain-version order, so codes and Jacobians equal the plain
    version's bit for bit.
    """
    dtype = _float_dtype("v_world", v_world)
    t, n = v_world.shape[0], points.shape[0]
    m, width = triangles.shape[0], vertex_neighbors.shape[-1]
    cap_v, cap_i = vertex_ids.shape[-1], interior_ids.shape[-1]
    _check("points", points, dtype, (n, 3))
    _check("basis", basis, dtype, (n, 2, 3))
    _check("vertex_neighbors", vertex_neighbors, torch.int32, (n, width))
    _check("triangles", triangles, torch.int32, (m, 3))
    _check("across", across, torch.int32, (m, 3))
    _check("v_world", v_world, dtype, (t, n, 3))
    _check("v_max", v_max, dtype, (t,))
    _check("vertex_ids", vertex_ids, torch.int32, (t, cap_v))
    _check("vertex_valid", vertex_valid, torch.bool, (t, cap_v))
    _check("interior_ids", interior_ids, torch.int32, (t, cap_i))
    _check("interior_valid", interior_valid, torch.bool, (t, cap_i))
    _check("interior_points", interior_points, dtype, (t, cap_i, 3))
    tensors = (points, basis, vertex_neighbors, triangles, across, v_world, v_max,
               vertex_ids, vertex_valid, interior_ids, interior_valid,
               interior_points)
    if not _on_cuda(*tensors):
        return plain_classify_candidates(*tensors, quirks=quirks)
    device = v_world.device
    out = (torch.empty((t, cap_v), dtype=torch.int32, device=device),
           torch.empty((t, cap_v, 2, 2), dtype=dtype, device=device),
           torch.empty((t, cap_i), dtype=torch.int32, device=device),
           torch.empty((t, cap_i, 2, 2), dtype=dtype, device=device))
    _launch("classify_candidates", dtype, device, *(x.data_ptr() for x in tensors),
            *(o.data_ptr() for o in out), t, n, width, cap_v, cap_i, int(quirks))
    return out


def plain_classify_candidates(points, basis, vertex_neighbors, triangles, across,
                              v_world, v_max, vertex_ids, vertex_valid,
                              interior_ids, interior_valid, interior_points,
                              quirks: bool = False):
    """Plain torch version of `classify_candidates`
    (ops/singularity.py:293-352)."""
    frame = torch.arange(v_world.shape[0], device=v_world.device)[:, None, None]
    vmax = v_max[:, None, None, None]

    ids = vertex_ids.long()
    nb = vertex_neighbors[ids]                                      # (T, S, D)
    mask = (nb != -1) & vertex_valid[..., None]
    nb = torch.where(mask, nb, torch.zeros_like(nb)).long()
    e = basis[ids]                                                  # (T, S, 2, 3)
    jac_v = _jacobian_from_neighbors(
        points[ids][..., None, :], e[..., None, 0, :], e[..., None, 1, :],
        points[nb], v_world[frame, nb] / vmax, mask)

    ids = interior_ids.long()
    tri = triangles[ids].long()                                     # (T, S, 3)
    p = points[tri]                                                 # (T, S, 3, 3)
    nrm = _cross(p[..., 1, :] - p[..., 0, :], p[..., 2, :] - p[..., 0, :])
    nl = torch.sqrt(_dot3(nrm, nrm))[..., None]
    e1, e2 = _tangent_basis(nrm / torch.where(nl > 0, nl, torch.ones_like(nl)))
    pt = interior_points
    edge = _nearest_edge(pt, p[..., 0, :], p[..., 1, :], p[..., 2, :], quirks)
    other = torch.gather(across[ids].long(), -1, edge[..., None])[..., 0]
    other = torch.where(other >= 0, other, ids)
    nb = torch.cat([tri, triangles[other].long()], dim=-1)          # (T, S, 6)
    first = [torch.ones_like(nb[..., 0], dtype=torch.bool)]
    for i in range(1, 6):
        first.append(~(nb[..., i:i + 1] == nb[..., :i]).any(dim=-1))
    mask = torch.stack(first, dim=-1) & interior_valid[..., None]
    jac_i = _jacobian_from_neighbors(
        pt[..., None, :], e1[..., None, :], e2[..., None, :], points[nb],
        v_world[frame, nb] / vmax, mask)
    return (classify_jacobian(jac_v), jac_v, classify_jacobian(jac_i), jac_i)
