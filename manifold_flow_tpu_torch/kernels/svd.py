"""Wrapper of K18, the one-sided Jacobi SVD of S4's small square factor,
with its plain torch version.

As in `kernels.fields`: CPU tensors take the plain version; CUDA tensors
launch the kernel from `csrc/svd_kernels.cu` or raise. Nothing falls back.

The factor G (m x m, m <= MAX_COLUMNS) is given by its columns, row j of
the tensor being column j of G, and so are the results: row c of `u` is
column c of U, row c of `w` column c of W, with G W = U diag(s) and s
descending. Both versions run the same rotations in the same order: the
columns cut into 2p blocks of b (`layout`), a round-robin tournament of the
blocks, p pairs of blocks a round (`schedule`), each pair's own columns in
each sweep's first round, then its b x b pairs across, b steps of b
disjoint pairs. They differ in the order of their sums, so their bits
differ while their sweep counts agree.
"""

from __future__ import annotations

import torch

from manifold_flow_tpu_torch.kernels._lib import _check, _launch, _on_cuda, _workspace

MAX_COLUMNS = 1024  # the largest m K18 takes (csrc/svd_kernels.cu, m <= 32 * 32)
MAX_SWEEPS = 30     # csrc/svd_kernels.cu kJacobiMaxSweeps
BLOCK = 8           # columns a block (csrc/svd_kernels.cu's kernel template B)


def layout(m: int) -> tuple[int, int]:
    """(b, p): blocks of b columns, 2p blocks covering m columns."""
    return BLOCK, max(1, -(-m // (2 * BLOCK)))


def tolerance(m: int) -> float:
    """A pair counts as orthogonal where |g_i.g_j| <= m eps |g_i| |g_j|
    (dgesvj's rule)."""
    return m * torch.finfo(torch.float64).eps


def _round_robin(n: int, r: int, k: int) -> tuple[int, int]:
    """Pair k of round r of the circle-method tournament of n (even) items
    (csrc/svd_kernels.cu round_robin)."""
    ring = n - 1
    return (ring, r) if k == 0 else ((r + k) % ring, (r - k) % ring)


def schedule(b: int, p: int) -> list[tuple[list[int], list[int]]]:
    """The steps of one sweep over 2p blocks of b columns, in order: each
    step's disjoint pairs (first columns, second columns)."""
    nblk = 2 * p
    steps = []
    for r in range(nblk - 1):
        if r == 0:
            for s in range(b - 1):
                pairs = [(q * b + i, q * b + j) for q in range(nblk)
                         for i, j in (_round_robin(b, s, k) for k in range(b // 2))]
                steps.append(tuple(map(list, zip(*pairs))))
        blocks = [_round_robin(nblk, r, k) for k in range(p)]
        for s in range(b):
            pairs = [(bx * b + w, by * b + (w + s) % b) for bx, by in blocks for w in range(b)]
            steps.append(tuple(map(list, zip(*pairs))))
    return steps


def _scales(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(2^-e, 2^e), float64 scalars on g's device with max |G| = f 2^e, f
    in [0.5, 1) (1 and 1 for a zero G): multiplying G by the first and the
    singular values by the second is exact, and keeps the squares of the
    column norms and their products in float64's range whatever G's scale.
    Made from the exponent's bits, with no host read."""
    e = torch.frexp(g.abs().amax()).exponent.to(torch.int64).clamp(-1021, 1022)
    return ((1023 - e) << 52).view(torch.float64), ((1023 + e) << 52).view(torch.float64)


def jacobi_svd(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """K18 `jacobi_svd<double>`: (u (m, m), s (m,), w (m, m), sweeps (1,)
    int32) of G (m, m) float64 given by its columns (see the module), s
    descending, sweeps the number of sweeps run (the last rotates nothing,
    unless MAX_SWEEPS cut the loop). A column that ends exactly zero gets
    the unit vector of its index for U. G is first scaled by a power of two
    to max |G| in [0.5, 1) (`_scales`), and s scaled back.

    Replaces cuSOLVER's gesvdj launches on S4's factor (B15; no TPU
    kernel). Bound: ~9 m^3 float64 operations a sweep; in fact its ~m
    dependent steps a sweep. Design: one cooperative launch; p CTAs of 32 b
    threads rotate G, a pair of blocks each in shared memory, and log their
    rotations; more CTAs hold W's rows and replay each round's log one
    round behind; a grid barrier a round, the convergence test on the
    device (csrc/svd_kernels.cu)."""
    if g.dim() != 2:
        raise ValueError(f"g must be (m, m); got {tuple(g.shape)}")
    m = g.shape[0]
    _check("g", g, torch.float64, (m, m))
    if not 0 < m <= MAX_COLUMNS:
        raise ValueError(f"jacobi_svd takes 1 to {MAX_COLUMNS} columns; got {m}")
    if not _on_cuda(g):
        return plain_jacobi_svd(g)
    device = g.device
    down, up = _scales(g)
    g = g * down
    b, p = layout(m)
    u = torch.empty((m, m), dtype=torch.float64, device=device)
    s = torch.empty(m, dtype=torch.float64, device=device)
    w = torch.empty((m, m), dtype=torch.float64, device=device)
    sweeps = torch.empty(1, dtype=torch.int32, device=device)
    work = _workspace("jacobi_svd", torch.float64, device, m, b, p)
    _launch("jacobi_svd", torch.float64, device, g.data_ptr(), u.data_ptr(), s.data_ptr(),
            w.data_ptr(), sweeps.data_ptr(), work.data_ptr(), m, b, p, tolerance(m))
    return u, s * up, w, sweeps


def _rotate(gw: torch.Tensor, i: torch.Tensor, j: torch.Tensor, m: int,
            tol: float) -> torch.Tensor:
    """One step: of the pairs (i[k], j[k]) of rows of gw (a column of G, m
    values, then the same column of W), those not yet orthogonal to `tol`
    rotated; which were."""
    x, y = gw.index_select(0, i), gw.index_select(0, j)
    xg, yg = x[:, :m], y[:, :m]
    xx, yy, xy = (torch.linalg.vecdot(xg, xg), torch.linalg.vecdot(yg, yg),
                  torch.linalg.vecdot(xg, yg))
    rot = xy * xy > tol * tol * (xx * yy)
    d, e = yy - xx, 2.0 * xy
    h = d.abs() + torch.sqrt(d * d + e * e)
    z = torch.rsqrt(h * h + e * e)
    cs = h * z
    sn = torch.where(rot, torch.copysign(torch.ones_like(d), d) * e * z, 0.0)[:, None]
    cs = torch.where(rot, cs, 1.0)[:, None]
    gw.index_copy_(0, i, cs * x - sn * y)
    gw.index_copy_(0, j, sn * x + cs * y)
    return rot


def plain_jacobi_svd(g: torch.Tensor):
    """Plain torch version of `jacobi_svd`: the same scaling and steps, each
    step a batch of disjoint pairs, W rotated with G; one host read a sweep."""
    down, up = _scales(g)
    g = g * down
    m = g.shape[0]
    b, p = layout(m)
    tol = tolerance(m)
    gw = g.new_zeros((2 * p * b, 2 * m))
    gw[:m, :m] = g
    gw[:m, m:] = torch.eye(m, dtype=g.dtype, device=g.device)
    steps = [(torch.tensor(i, device=g.device), torch.tensor(j, device=g.device))
             for i, j in schedule(b, p)]
    sweeps = 0
    while sweeps < MAX_SWEEPS:
        sweeps += 1
        if not bool(torch.cat([_rotate(gw, i, j, m, tol) for i, j in steps]).any()):
            break
    gc, wc = gw[:m, :m], gw[:m, m:]
    sigma = torch.linalg.vecdot(gc, gc).sqrt()
    order = torch.sort(sigma, descending=True, stable=True).indices
    unit = torch.eye(m, dtype=g.dtype, device=g.device)
    u = torch.where((sigma > 0)[:, None], gc / sigma[:, None], unit)
    return (u[order], sigma[order] * up, wc[order],
            torch.tensor([sweeps], dtype=torch.int32, device=g.device))
