"""K4's frame factors and right-hand side in the kernel's order, each
operation rounded as the kernel rounds it, in numpy: the reference that the
cuda tests of K4 (tests/test_torch_kernels.py) hold the kernel to bit for
bit, and that the CPU tests (tests/test_torch_fem.py) hold to the plain
version.

The kernel (csrc/fem_kernels.cu frame_factors_rhs_kernel) forms each
three-term dot product as fma(a2, b2, fma(a0, b0, a1 b1)), the fused
multiply-adds nvcc formed from the first design's a0 b0 + a1 b1 + a2 b2;
every other operation is rounded on its own, and each vertex sums its
local RHS entries g * scale in gather_base's column order. A fused
multiply-add is emulated exactly: a b + c as a fraction, rounded once to
the inputs' type.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np


def _round32(exact: Fraction) -> np.float32:
    """`exact` rounded to the nearest float32, ties to even."""
    near = np.float32(float(exact))
    best = None
    for cand in (np.nextafter(near, np.float32(-np.inf)), near,
                 np.nextafter(near, np.float32(np.inf))):
        err = abs(Fraction(float(cand)) - exact)
        even = int(np.asarray(cand).view(np.uint32)) & 1 == 0
        if best is None or err < best[0] or (err == best[0] and even):
            best = (err, cand)
    return best[1]


def fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """a * b + c elementwise, rounded once to a's dtype (float32 or
    float64); the inputs are finite."""
    a, b, c = np.broadcast_arrays(a, b, c)
    dtype = a.dtype
    out = np.empty(a.shape, dtype=dtype)
    flat = out.reshape(-1)
    for i, (x, y, z) in enumerate(zip(a.reshape(-1).tolist(), b.reshape(-1).tolist(),
                                      c.reshape(-1).tolist())):
        exact = Fraction(x) * Fraction(y) + Fraction(z)
        flat[i] = float(exact) if dtype == np.float64 else _round32(exact)
    return out


def _dot3(a0, b0, a1, b1, a2, b2):
    return fma(a2, b2, fma(a0, b0, a1 * b1))


def ordered_frame_factors_rhs(potentials, potentials_next, times, triangles,
                              grad_w, basis, areas, gather_base):
    """g (T, M, 3, 2) and f (T, 2N) of K4 from numpy arrays of one float
    dtype (the tables int32), as `kernels.fem.frame_factors_rhs` takes them."""
    tri = triangles.astype(np.int64)
    pot, nxt = potentials[:-1], potentials_next[1:]
    step = times[1:] - times[:-1]
    val = pot[:, tri]                                   # (T, M, 3)
    di = (nxt[:, tri] - val) / step[:, None, None]
    gm = np.stack([_dot3(val[..., 0], grad_w[:, 0, d], val[..., 1], grad_w[:, 1, d],
                         val[..., 2], grad_w[:, 2, d]) for d in range(3)], axis=-1)
    e = basis[tri]                                      # (M, 3, 2, 3)
    g = _dot3(gm[:, :, None, None, 0], e[None, ..., 0], gm[:, :, None, None, 1],
              e[None, ..., 1], gm[:, :, None, None, 2], e[None, ..., 2])
    s = (di[..., 0] + di[..., 1]) + di[..., 2]
    w12 = areas / areas.dtype.type(12)
    scale = (di + s[..., None]) * w12[:, None]          # (T, M, 3)
    f_loc = (g * scale[..., None]).reshape(g.shape[0], -1)
    t, n = g.shape[0], gather_base.shape[0]
    sums = np.zeros((t, n, 2), dtype=g.dtype)
    for col in range(gather_base.shape[1]):
        base = gather_base[:, col].astype(np.int64)
        valid = (base >= 0) & (base < f_loc.shape[1])
        safe = np.where(valid, base, 0)
        for a in range(2):
            sums[..., a] = sums[..., a] + np.where(valid, f_loc[:, safe + a], 0)
    return g, np.concatenate([sums[..., 0], sums[..., 1]], axis=-1)
