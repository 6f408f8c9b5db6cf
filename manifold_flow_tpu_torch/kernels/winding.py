"""Wrapper of the winding kernel (K15), with its plain torch version.

As in `kernels.analysis`: CPU tensors take the plain version; CUDA tensors
launch the kernel from `csrc/winding_kernels.cu` or raise. Nothing falls
back. The wrapper checks dtype, device, shape and contiguity first,
allocates its outputs with `torch.empty`, and counts its launches in
`LAUNCHES`.

The plain version evaluates every operation separately in the kernel's
order and adds each ring's angles member by member in sorted order, as
the kernel does, so counts and types are equal and the winding numbers
agree to rounding (they are equal where both take the same arccos).
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
    by arithmetic latency: v_world is read once from device memory (7.3 MB
    in f64 at the bench shapes, about 2.5 us at 3.35 TB/s) and re-read from
    L2 per center; each ring member costs an arccos and two divisions.
    Design: one warp per (center, frame), lane r summing ring r in sorted
    order, lane 0 counting the persistent rings.
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


def plain_winding_profile(v_world, order, bounds, e1, e2):
    """Plain torch version of `winding_profile` (ops/winding.py:138-158 and
    :173-184, each ring's angles added member by member)."""
    levels = bounds.shape[-1] - 1
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
    first, end = bounds[:, :-1].long(), bounds[:, 1:].long()    # (U, L)
    size = end - first
    t = v_world.shape[0]

    def member(i):
        """Unit direction (U, T, L) of sorted member i (clamped into range)."""
        idx = i.clamp(0, max(order.shape[-1] - 1, 0))[:, None].expand(-1, t, -1)
        return torch.gather(ux, 2, idx), torch.gather(uy, 2, idx)

    total = torch.zeros((order.shape[0], t, levels), dtype=v_world.dtype,
                        device=v_world.device)
    if order.shape[-1]:
        fx, fy = member(first)
        px, py = fx, fy
        for j in range(1, int(size.max()) if size.numel() else 0):
            cx, cy = member(first + j)
            ang = _signed_angle(px, py, cx, cy)
            total = total + torch.where((j < size)[:, None], ang, torch.zeros_like(ang))
            inside = (j < size)[:, None]
            px, py = torch.where(inside, cx, px), torch.where(inside, cy, py)
        closure = _signed_angle(px, py, fx, fy)
        total = total + torch.where((size >= 2)[:, None], closure,
                                    torch.zeros_like(closure))
    w = total / (2.0 * math.pi)
    counts, types = count_and_type(w)
    return counts, types, w
