"""Wrappers of the streamline kernels (K13 next hops, K14 walks), with their
plain torch versions.

As in `kernels.analysis`: CPU tensors take the plain version; CUDA tensors
launch the kernel from `csrc/stream_kernels.cu` or raise. Nothing falls
back. Each wrapper checks dtype, device, shape and contiguity first,
allocates its outputs with `torch.empty` (the pack entry writes into a
buffer the caller gives it), and counts its launches in `LAUNCHES`.

K13's plain version evaluates every sum and product as a separate torch
operation in the JAX expression order, and the kernel rounds each operation
on its own in the same order, so the next-hop graphs are equal, not merely
close. K14 works on integers only. Its plain version materialises each
walk's first max_steps + 1 vertices and finds the first repeat by sorting
(vertex, step) keys, as JAX's `_double_and_detect` does; the kernel finds
the same step by Brent's cycle detection without storing the walk.

Shapes below are given at the bench problem (T=97 frames, N=3136 vertices,
D the widest 1-ring, C the most cells at a vertex).
"""

from __future__ import annotations

import torch

from manifold_flow_tpu_torch.geometry.mesh import PAD_INDEX
from manifold_flow_tpu_torch.kernels._lib import (
    _check,
    _float_dtype,
    _launch,
    _on_cuda,
)
from manifold_flow_tpu_torch.kernels.analysis import _cross, _dot3

# Seeds per chunk of the plain walk-length version: a chunk holds
# (rows, max_steps + 1) int64 keys, 2^25 of them at most.
_PLAIN_KEYS = 1 << 25


# ------------------------------------------------------------------ K13
# The hop rule of a 1-ring slot whose vertex may advance with no triangle
# test (csrc/stream_kernels.cu kHopAdvance).
HOP_ADVANCE = -2


def next_hop(unit: torch.Tensor, v_world: torch.Tensor, neighbors: torch.Tensor,
             rules: torch.Tensor, corners: torch.Tensor, basis: torch.Tensor
             ) -> torch.Tensor:
    """K13 `next_hop<T>`: the next vertex (T, N) int32 of every (frame,
    vertex) walk step, a halting vertex pointing to itself.

    unit (N, D, 3) are the 1-ring edge vectors projected onto each vertex's
    tangent plane and normalised (`ops.streamline.unit_edges`); v_world
    (T, N, 3), corners (K, 4) and basis (N, 2, 3) share its dtype;
    neighbors (N, D) and rules (N, D) are int32. rules and corners are
    `hop_tables`' (whose `quirks` they carry).

    Replaces ops/streamline.py:133 `_next_hop_tables` and :242 `_hop_graph`
    (B10). Bound by memory traffic: at 12.5k vertices x 97 frames in f64 it
    reads v_world once (29.2 MB) and the 1-ring tables (2.4 MB) and writes
    next (4.9 MB), 10.8 us at 3.35 TB/s. Design: everything that does not
    depend on the frame is done once per mesh (`hop_tables`): the shared-
    cell scan of each boundary slot and its triangle's corners on the
    tangent basis. One thread per (vertex, 4 or 8 consecutive frames)
    loads the vertex's 1-ring ids, rules and unit edges into registers
    once, then per frame reads its velocity, takes the dot products and
    their argmax, and
    only where the chosen slot's rule names a row of `corners` takes the
    velocity on the tangent basis (two divisions) and three orientation
    tests. What holds it back now: the per-frame dot products and argmax
    of every slot, then the warps that wait for a boundary lane's test
    (PERF.md).
    """
    dtype = _float_dtype("v_world", v_world)
    t, n, width = v_world.shape[0], neighbors.shape[0], neighbors.shape[-1]
    _check("unit", unit, dtype, (n, width, 3))
    _check("v_world", v_world, dtype, (t, n, 3))
    _check("neighbors", neighbors, torch.int32, (n, width))
    _check("rules", rules, torch.int32, (n, width))
    _check("corners", corners, dtype, (corners.shape[0], 4))
    _check("basis", basis, dtype, (n, 2, 3))
    tensors = (unit, v_world, neighbors, rules, corners, basis)
    if not _on_cuda(*tensors):
        return plain_next_hop(*tensors)
    out = torch.empty((t, n), dtype=torch.int32, device=v_world.device)
    _launch("next_hop", dtype, v_world.device, *(x.data_ptr() for x in tensors),
            out.data_ptr(), t, n, width)
    return out


def hop_tables(points: torch.Tensor, triangles: torch.Tensor, basis: torch.Tensor,
               neighbors: torch.Tensor, cell_count: torch.Tensor,
               vertex_cells: torch.Tensor, quirks: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The frame-independent half of the walk rule's boundary test, for
    `next_hop`: the hop rule (N, D) int32 of each 1-ring slot and the
    corners (K, 4) of the triangles it names, in points' dtype, on the
    tables' device.

    A slot's rule is HOP_ADVANCE where the vertex is interior (6 cells or
    more) or shares at least 2 cells with the slot's neighbour; -1 where it
    shares none, the slot is padded, or their one shared triangle is
    degenerate on the tangent basis (orient = 0, where the test fails for
    every velocity); else a row k of `corners`: (bx, by, cx, cy), the
    triangle's other two corners on the vertex's tangent basis,
    counter-clockwise (ops/streamline.py:98-130, `quirks` taking the
    reference's index arithmetic). ops/streamline.py:166-177 compute it
    every frame.
    """
    padded = neighbors == PAD_INDEX
    rules = torch.where(padded, PAD_INDEX, HOP_ADVANCE).to(torch.int32)
    rows = torch.nonzero(cell_count < 6)[:, 0]
    if rows.numel() == 0:
        return rules, torch.zeros((0, 4), dtype=points.dtype, device=points.device)
    nb = neighbors[rows]
    safe = torch.where(nb != PAD_INDEX, nb, 0).long()
    count, first = _shared_cells(vertex_cells[rows].long()[:, None, :],
                                 vertex_cells[safe].long())
    tested = (count == 1) & (nb != PAD_INDEX)
    b_row, b_slot = torch.nonzero(tested, as_tuple=True)
    a = rows[b_row]
    *corner, solid = _triangle_corners(points, triangles, a, first[b_row, b_slot],
                                       basis[a, 0], basis[a, 1], quirks)
    rule = torch.where(count >= 2, HOP_ADVANCE, PAD_INDEX)
    rule[b_row, b_slot] = torch.where(solid, torch.arange(a.numel(), device=a.device),
                                      PAD_INDEX)
    rules[rows] = torch.where(padded[rows], PAD_INDEX, rule).to(torch.int32)
    return rules, torch.stack(corner, dim=-1).contiguous()


def _plane_coords(rel, e1, e2, n, nn):
    """(u, v) of `rel` on (e1, e2) after projecting it onto their plane
    (geometry/tangent.py position_diff_on_basis), each operation separate."""
    pos = nn > 0
    s = torch.where(pos, _dot3(rel, n) / torch.where(pos, nn, torch.ones_like(nn)),
                    torch.zeros_like(nn))
    proj = rel - s[..., None] * n
    return _dot3(proj, e1), _dot3(proj, e2)


def _scalar_posdiff(s, e1, e2, n, nn):
    """ops/streamline.py:88: the reference passes vertex indices where
    coordinates belong, so proj = s - s (n * n) / |n|^2 elementwise."""
    proj = s[..., None] - s[..., None] * (n * n) / nn[..., None]
    return _dot3(proj, e1), _dot3(proj, e2)


def _cross2(ax, ay, bx, by):
    return ax * by - ay * bx


def _triangle_corners(points, triangles, a, cell, e1, e2, quirks: bool):
    """The frame-independent half of ops/streamline.py:98
    `_boundary_triangle_test` for vertices `a` moving across triangles
    `cell` (any matching shapes): the triangle's other two corners (bx, by)
    and (cx, cy) on the tangent basis, counter-clockwise, and whether the
    triangle is not degenerate there (orient != 0; the test fails on a
    degenerate one)."""
    tri = triangles[cell.long()].long()
    t0, t1, t2 = tri.unbind(-1)
    a = a.long()
    b = torch.where(t0 == a, t1, torch.where(t1 == a, t0, t1))
    c = torch.where(t2 == a, t0, t2)
    n = _cross(e1, e2)
    nn = _dot3(n, n)
    if quirks:
        p1 = _scalar_posdiff((b - a).to(e1.dtype), e1, e2, n, nn)
        p2 = _scalar_posdiff((a - c).to(e1.dtype), e1, e2, n, nn)
    else:
        pa = points[a]
        p1 = _plane_coords(points[b] - pa, e1, e2, n, nn)
        p2 = _plane_coords(points[c] - pa, e1, e2, n, nn)
    orient = _cross2(*p1, *p2)
    ccw = orient >= 0
    return (torch.where(ccw, p1[0], p2[0]), torch.where(ccw, p1[1], p2[1]),
            torch.where(ccw, p2[0], p1[0]), torch.where(ccw, p2[1], p1[1]), orient != 0)


def _points_inside(corner, e1, e2, vel):
    """The per-frame half of the boundary test: the velocity on the tangent
    basis points strictly inside the triangle of `corner` (..., 4)."""
    bx, by, cx, cy = corner.unbind(-1)
    vx = _dot3(vel, e1) / _dot3(e1, e1)
    vy = _dot3(vel, e2) / _dot3(e2, e2)
    return ((_cross2(bx, by, vx, vy) > 0)
            & (_cross2(cx - bx, cy - by, vx - bx, vy - by) > 0)
            & (_cross2(-cx, -cy, vx - cx, vy - cy) > 0))


def _shared_cells(cells_a, cells_b):
    """ops/streamline.py:73 over leading axes: the number of `cells_a`
    entries that `cells_b` also lists, and the first of them (-1 if none)."""
    eq = ((cells_a[..., :, None] == cells_b[..., None, :])
          & (cells_a != PAD_INDEX)[..., :, None] & (cells_b != PAD_INDEX)[..., None, :])
    cells_a = cells_a.expand_as(cells_b)
    match = eq.any(dim=-1)
    count = match.sum(dim=-1)
    first = torch.gather(cells_a, -1, match.to(torch.uint8).argmax(dim=-1, keepdim=True))
    return count, torch.where(match.any(dim=-1), first[..., 0], PAD_INDEX)


def plain_next_hop(unit, v_world, neighbors, rules, corners, basis):
    """Plain torch version of `next_hop` (ops/streamline.py:149-185,
    :249-255)."""
    t, n = v_world.shape[0], neighbors.shape[0]
    mask = neighbors != PAD_INDEX
    safe = torch.where(mask, neighbors, 0).long()
    dots = _dot3(unit[None], v_world[:, :, None, :])                 # (T, N, D)
    dots = torch.where(mask, dots, torch.full_like(dots, -torch.inf))
    idx = dots.argmax(dim=-1, keepdim=True)
    cand = torch.gather(safe.expand(t, -1, -1), -1, idx)[..., 0]     # (T, N)
    dmax = torch.gather(dots, -1, idx)[..., 0]
    rule = torch.gather(rules.expand(t, -1, -1), -1, idx)[..., 0]
    ok = rule == HOP_ADVANCE
    frame, row = torch.nonzero(rule >= 0, as_tuple=True)
    if row.numel():
        ok[frame, row] = _points_inside(corners[rule[frame, row].long()], basis[row, 0],
                                        basis[row, 1], v_world[frame, row])
    vertex = torch.arange(n, device=v_world.device)
    return torch.where((dmax > 0) & ok, cand, vertex).to(torch.int32)


# ------------------------------------------------------------------ K14
def trace_walks(next_: torch.Tensor, max_steps: int) -> torch.Tensor:
    """K14 `trace_walks`: the length (T, N) int32 of the walk from every
    seed over the next-hop graph `next_` (T, N) int32: the first step whose
    vertex already occurred, capped at max_steps + 1.

    Replaces the length half of ops/streamline.py:268 `_double_and_detect`
    (with :351 `_trace_batched`, B11). Bound by the chain of dependent
    loads: the bytes are few (next 4.9 MB at 12.5k vertices x 97 frames,
    the lengths as much), but a walk's steps wait on each other, and a
    warp lasts as long as its longest walk. Design: a block takes a run of
    one frame's seeds, loads the frame's row of next_ into shared memory
    (16-byte loads; read from device memory instead where a row passes the
    227 KB a block may hold, N above about 58k) and runs Brent's cycle
    detection for each seed there (O(1) state, no stored path), in rounds
    that stop once a round as long as min(cap - 1, N) found no repeat;
    512 threads a block, 1024 seeds a block at 12.5k vertices and 512 at
    3.1k (from the SM count). The first design ran one thread per seed on
    next_ in device memory, an L2 round trip a step.
    """
    t, n = next_.shape[0], next_.shape[-1]
    _check("next", next_, torch.int32, (t, n))
    if int(max_steps) < 0:
        raise ValueError(f"max_steps must be >= 0; got {max_steps!r}")
    if not _on_cuda(next_):
        return plain_trace_walks(next_, max_steps)
    lengths = torch.empty((t, n), dtype=torch.int32, device=next_.device)
    _launch("trace_walks", None, next_.device, next_.data_ptr(), lengths.data_ptr(),
            t, n, int(max_steps))
    return lengths


def _global_hops(next_: torch.Tensor) -> torch.Tensor:
    """The (T * N,) int64 graph over global ids (frame k's vertex v is
    k * N + v)."""
    t, n = next_.shape
    offs = torch.arange(t, device=next_.device)[:, None] * n
    return (next_.long() + offs).reshape(-1)


def plain_trace_walks(next_, max_steps: int):
    """Plain torch version of `trace_walks`: each walk's first max_steps + 1
    vertices, then the first repeat from (vertex, step) keys sorted per
    walk, as ops/streamline.py:317-330 does."""
    t, n = next_.shape
    cap = int(max_steps) + 1
    f = _global_hops(next_)
    steps = torch.arange(cap, device=next_.device)
    out = torch.empty(t * n, dtype=torch.int32, device=next_.device)
    chunk = max(_PLAIN_KEYS // cap, 1)
    for lo in range(0, t * n, chunk):
        x = torch.arange(lo, min(lo + chunk, t * n), device=next_.device)
        seq = torch.empty((x.numel(), cap), dtype=torch.int64, device=next_.device)
        for j in range(cap):
            seq[:, j] = x
            x = f[x]
        key = torch.sort(seq * cap + steps, dim=1).values
        repeat = (key[:, 1:] // cap) == (key[:, :-1] // cap)
        first = torch.where(repeat, key[:, 1:] % cap, cap)
        first = torch.cat([first, torch.full((first.shape[0], 1), cap,
                                             dtype=first.dtype, device=first.device)], dim=1)
        out[lo:lo + seq.shape[0]] = first.min(dim=1).values.to(torch.int32)
    return out.reshape(t, n)


def pack_walks(next_: torch.Tensor, seeds: torch.Tensor, lengths: torch.Tensor,
               offsets: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """K14 `pack_walks`: write walk k (from the global seed id seeds[k] =
    frame * N + vertex, lengths[k] vertices, frame-local ids) into
    out[offsets[k]:offsets[k] + lengths[k]]; returns `out`.

    next_ (T, N) int32; seeds (K,) and offsets (K,) int64; lengths (K,)
    int32; out (L,) int32, written only at the walks' positions. Packed
    walks (offsets an exclusive cumsum of the lengths) are what
    ops/streamline.py:733 `_gather_packed` produced; rows (offsets
    seed * (max_steps + 1) into a buffer prefilled with PAD_INDEX) are
    `trace_frames`' (B11). Bound by the ids written (70.9 MB at 12.5k
    vertices, more than L2 holds) and the hop table read. Design: a block
    takes consecutive walks, loads each of their frames' rows of next_
    into shared memory (16-byte loads; read from device memory instead
    where a row passes the 227 KB a block may hold, N above about 54k) and
    chases one walk a thread there. Walks that lie back to back in `out`
    are staged in windows of 4096 ids and written with coalesced stores;
    elsewhere each thread stores its walk where it lies. Any seeds, lengths
    and offsets; seeds in frame order (the stage's) load each row once a
    block.
    """
    t, n = next_.shape[0], next_.shape[-1]
    k = seeds.shape[0]
    _check("next", next_, torch.int32, (t, n))
    _check("seeds", seeds, torch.int64, (k,))
    _check("lengths", lengths, torch.int32, (k,))
    _check("offsets", offsets, torch.int64, (k,))
    if out.dim() != 1:
        raise ValueError(f"out must be 1-D; got {tuple(out.shape)}")
    _check("out", out, torch.int32, (out.shape[0],))
    if not _on_cuda(next_, seeds, lengths, offsets, out):
        return plain_pack_walks(next_, seeds, lengths, offsets, out)
    _launch("pack_walks", None, next_.device, next_.data_ptr(), seeds.data_ptr(),
            lengths.data_ptr(), offsets.data_ptr(), out.data_ptr(), k, n)
    return out


def plain_pack_walks(next_, seeds, lengths, offsets, out):
    """Plain torch version of `pack_walks`."""
    n = next_.shape[-1]
    width = int(lengths.max()) if lengths.numel() else 0
    if width == 0:
        return out
    f = _global_hops(next_)
    seq = torch.empty((seeds.numel(), width), dtype=torch.int64, device=out.device)
    x = seeds
    for j in range(width):
        seq[:, j] = x
        x = f[x]
    col = torch.arange(width, device=out.device)
    keep = col < lengths[:, None]
    out[(offsets[:, None] + col)[keep]] = (seq % n)[keep].to(torch.int32)
    return out
