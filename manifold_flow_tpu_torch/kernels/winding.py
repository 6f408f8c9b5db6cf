"""Wrapper of the winding kernel (K15), with its plain torch version.

As in `kernels.analysis`: CPU tensors take the plain version; CUDA tensors
launch the kernel from `csrc/winding_kernels.cu` or raise. Nothing falls
back. The wrapper checks dtype, device, shape and contiguity first,
allocates its outputs with `torch.empty`, and counts its launches in
`LAUNCHES`.

The plain version evaluates every operation separately in the kernel's
order and adds each ring's angles in the kernel's order (`ring_sums`: the
lanes of a warp striding over the ring's members, then warp_sum's fixed
tree), so counts and types are equal and the winding numbers agree to
rounding (they are equal where both take the same arccos).
"""

from __future__ import annotations

import math

import torch

from manifold_flow_tpu_torch.kernels._lib import (
    _check,
    _float_dtype,
    _launch,
    _on_cuda,
)
from manifold_flow_tpu_torch.kernels.analysis import _cross, _dot3


def winding_profile(v_world: torch.Tensor, order: torch.Tensor,
                    bounds: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor):
    """K15 `winding_profile<T>`: per (unique center, frame), the winding
    numbers of rings 1..L and their ring-persistence count and type.

    v_world (T, N, 3), e1 and e2 (U, 3) in one dtype; order (U, R) int32
    ring members sorted by (ring, polar angle) and bounds (U, L + 1) int32
    (ring r is order[u, bounds[u, r]:bounds[u, r + 1]]), as
    `ops.winding.ring_tables` builds them. Returns counts (U, T) int32,
    types (U, T) int32 (+1 node/focus, -1 saddle, 0 unmatched) and winding
    numbers (U, T, L).

    Replaces ops/winding.py:127 `_profile_from_tables`, :173
    `_count_and_type` and their :458 `_grid_centers_program` (B12). Bound
    by f64 arithmetic: v_world is read once from device memory (7.3 MB in
    f64 at the bench shapes, about 2.5 us at 3.35 TB/s) and re-read from L2
    per center; each ring member costs five divisions, a square root and an
    arccos. Design: a block of 256 threads per (center, group of frames)
    spreads the work by member. The center's members (up to 2048 at once,
    in chunks beyond that) and each one's successor in its ring are staged
    in shared memory once for the group; for each frame thread i forms
    member i's unit direction, then its signed angle to its successor, and
    a warp per ring adds the ring's angles, its lanes striding over the
    members, closed by the fixed-order warp sum; thread 0 counts the
    persistent rings. The first design, a warp per (center, frame) with
    lane r walking ring r, left lanes idle and ran as long as the longest
    ring's serial chain.
    """
    dtype = _float_dtype("v_world", v_world)
    t, n = v_world.shape[0], v_world.shape[1] if v_world.dim() == 3 else -1
    u, width = order.shape[0], order.shape[-1]
    levels = bounds.shape[-1] - 1
    _check("v_world", v_world, dtype, (t, n, 3))
    _check("order", order, torch.int32, (u, width))
    _check("bounds", bounds, torch.int32, (u, levels + 1))
    _check("e1", e1, dtype, (u, 3))
    _check("e2", e2, dtype, (u, 3))
    if levels < 1:
        raise ValueError(f"bounds must cover at least one ring; got {tuple(bounds.shape)}")
    if not _on_cuda(v_world, order, bounds, e1, e2):
        return plain_winding_profile(v_world, order, bounds, e1, e2)
    device = v_world.device
    counts = torch.empty((u, t), dtype=torch.int32, device=device)
    types = torch.empty((u, t), dtype=torch.int32, device=device)
    w = torch.empty((u, t, levels), dtype=dtype, device=device)
    _launch("winding_profile", dtype, device, v_world.data_ptr(), order.data_ptr(),
            bounds.data_ptr(), e1.data_ptr(), e2.data_ptr(), counts.data_ptr(),
            types.data_ptr(), w.data_ptr(), u, t, n, width, levels)
    return counts, types, w


def _signed_angle(ax, ay, bx, by):
    """ops/winding.py:78: arccos(clip(a.b, -1, 1)), negated where the 2-D
    cross product is negative."""
    ang = torch.acos(torch.clamp(ax * bx + ay * by, -1.0, 1.0))
    return torch.where(ax * by - ay * bx < 0, -ang, ang)


def count_and_type(w: torch.Tensor):
    """Ring-persistence count and type (int32, ...) of winding profiles
    (..., L) (ops/winding.py:173): ring 1 within [0.99, 1.01] is +1, within
    [-1.01, -0.99] is -1, else 0; the count is 1 plus the consecutive rings
    from ring 2 within 0.001 of the type, 0 for type 0."""
    w0 = w[..., 0]
    pos = (w0 >= 0.99) & (w0 <= 1.01)
    neg = (w0 >= -1.01) & (w0 <= -0.99)
    typ = torch.where(pos, 1, torch.where(neg, -1, 0)).to(torch.int32)
    target = typ.to(w.dtype)[..., None]
    ok = ((w[..., 1:] >= target - 0.001) & (w[..., 1:] <= target + 0.001)
          & (typ != 0)[..., None])
    consec = torch.cumprod(ok.to(torch.int32), dim=-1).sum(dim=-1)
    count = torch.where(typ != 0, 1 + consec, 0)
    return count.to(torch.int32), typ


def ring_sums(angle: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Each ring's sum (U, T, L) of the per-member angles `angle` (U, T, R),
    in the kernel's order: lane l of the ring's warp adds the ring's
    members l, l + 32, ... in turn, then the 32 partial sums close in
    warp_sum's tree (common.cuh: lane i adds lane i + 16, then i + 8, ...,
    then lane 0 adds lane 1)."""
    u, t = angle.shape[0], angle.shape[1]
    first = bounds[:, :-1].long()
    size = bounds[:, 1:].long() - first                          # (U, L)
    levels = size.shape[1]
    lanes = torch.arange(32, device=angle.device)
    part = angle.new_zeros((u, t, levels, 32))
    n_steps = -(-int(size.max()) // 32) if size.numel() else 0
    for k in range(n_steps):
        pos = 32 * k + lanes                                      # (32,)
        valid = (pos < size[..., None])[:, None]                  # (U, 1, L, 32)
        idx = (first[..., None] + pos).clamp(0, max(angle.shape[-1] - 1, 0))
        a = torch.gather(angle, 2, idx.reshape(u, 1, -1).expand(-1, t, -1))
        part = torch.where(valid, part + a.reshape(u, t, levels, 32), part)
    for off in (16, 8, 4, 2, 1):
        part = part[..., :off] + part[..., off:2 * off]
    return part[..., 0]


def plain_winding_profile(v_world, order, bounds, e1, e2):
    """Plain torch version of `winding_profile` (ops/winding.py:138-158 and
    :173-184): every member's signed angle to its successor in its ring
    (the ring's first member for its last, none for a ring of one), each
    ring's angles added in the kernel's order (`ring_sums`)."""
    n_ = _cross(e1, e2)[:, None, None]                         # (U, 1, 1, 3)
    nn = _dot3(n_, n_)
    e1b, e2b = e1[:, None, None], e2[:, None, None]
    vs = v_world[:, order.long()].permute(1, 0, 2, 3)          # (U, T, R, 3)
    pos = nn > 0
    s = torch.where(pos, _dot3(vs, n_) / torch.where(pos, nn, torch.ones_like(nn)),
                    torch.zeros_like(vs[..., 0]))
    proj = vs - s[..., None] * n_
    a = _dot3(proj, e1b) / _dot3(e1b, e1b)
    b = _dot3(proj, e2b) / _dot3(e2b, e2b)
    nrm = torch.sqrt(a * a + b * b)
    den = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    ux, uy = a / den, b / den                                   # (U, T, R)
    u, width = order.shape
    t = v_world.shape[0]
    # Each member's ring r (first[r] <= j < end[r]) and its successor.
    j = torch.arange(width, device=order.device).expand(u, -1)
    end = bounds[:, 1:].long()
    ring = torch.searchsorted(end.contiguous(), j.contiguous(), right=True)
    ring = ring.clamp(max=max(end.shape[1] - 1, 0))
    succ = torch.where(j + 1 < torch.gather(end, 1, ring), j + 1,
                       torch.gather(bounds[:, :-1].long(), 1, ring))
    succ = succ.clamp(max=max(width - 1, 0))[:, None].expand(-1, t, -1)
    ang = _signed_angle(ux, uy, torch.gather(ux, 2, succ), torch.gather(uy, 2, succ))
    ang = torch.where(succ != j[:, None], ang, torch.zeros_like(ang))
    w = ring_sums(ang, bounds) / (2.0 * math.pi)
    counts, types = count_and_type(w)
    return counts, types, w
