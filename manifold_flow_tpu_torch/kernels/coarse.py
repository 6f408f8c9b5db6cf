"""Wrappers of the two-level preconditioner's hand-written CUDA kernels
(K8-K11), with their plain torch versions.

As in `kernels.fem`, each wrapper decides by the device of the tensors it is
given: CPU tensors take the plain version; CUDA tensors launch the kernel
(`csrc/coarse_kernels.cu`) or raise. `kernels.LAUNCHES` counts each launch.

Shapes below are given at the 12.5k-vertex surface of the JAX bench
(`bench.py:_mesh_12k`: T=97 frames, M=24642 triangles, N=12544 vertices,
Nc=196 aggregates of up to K=64 members, 2Nc=392). The coarse layout is
coarse dof = 2 * aggregate + component; the prolongation blocks r_blk are
(N, 2, 2) with R_v[a, b] = e_v^a . ebar^b (solve.coarse.prolongation_blocks).
"""

from __future__ import annotations

import torch

from manifold_flow_tpu_torch.kernels._lib import (
    _check,
    _float_dtype,
    _launch,
    _on_cuda,
    frame_slices,
    slice_workspace,
)
from manifold_flow_tpu_torch.kernels.fem import precise_sum


# ------------------------------------------------------------------ K8
def coarse_assemble(g: torch.Tensor, blocks2: torch.Tensor, r_blk: torch.Tensor,
                    triangles: torch.Tensor, w_scale: torch.Tensor,
                    lambda_: float, asm_ptr: torch.Tensor, asm_src: torch.Tensor,
                    asm_dst: torch.Tensor, n_coarse: int, mean: bool = False
                    ) -> torch.Tensor:
    """K8 `coarse_assemble<T>`: the dense coarse matrices
    A_c = P^T (a1_k + lambda a2) P, (T, 2Nc, 2Nc), or (1, 2Nc, 2Nc) with
    `mean` (the a1 part averaged over frames), without the ridge.

    g (T, M, 3, 2); blocks2 (M, 6, 6) a2 blocks; r_blk (N, 2, 2); triangles
    (M, 3) int32; w_scale (M,) = A/12. The contributions of triangle m are
    indexed s = m*36 + l*6 + l2 over local DOFs l = corner*2 + component;
    the CSR (solve.coarse.assembly_csr) lists, per non-zero coarse entry
    e, its flat target asm_dst[e] = row * 2Nc + col and its contributions
    asm_src[asm_ptr[e]:asm_ptr[e+1]] in ascending s. The entries come in
    sibling pairs (row, 2b), (row, 2b + 1) at indices 2p and 2p + 1, the
    second listing each of the first's (even) contributions plus one
    (solve.coarse.check_sibling_pairs); the kernel reads the first's list
    for both.

    Replaces solve/coarse.py:281 `coarse_matrices` with
    kernels/reduce.py:103 `apply_reduce` (B6), whose scatter-free plan
    exists because TPU scatter serialises. Bound on the H100 (f32, 12.5k
    shapes) by its gathers: every contribution of every frame reads two g
    pairs scattered over the triangles, beside ~180 MB of device memory (g,
    the zeroed and written output). Design: one warp per pair of sibling
    entries, in blocks of two warps (pairs differ in length, and a block
    keeps its SM's slots until its longest pair ends), first for the a2 part
    (one launch), then for each group of 4 frames in f32, 2 in f64: its
    lanes stride through the pair's CSR list, load each contribution's
    frame-independent part (indices, R_v, area) once for the group, then the
    group's g pairs (one 8- or 16-byte load each), used by both entries,
    before the multiply-adds; the fixed-order warp sum closes each entry and
    frame. The (T, M, 36) contributions (344 MB) never reach memory and the
    sum is deterministic. The first design, a warp per (frame, entry),
    loaded the frame-independent part again for every frame and each g pair
    for each entry; the matrices are bitwise that design's. `mean` runs one
    warp (and block) per pair over every frame. The output is zeroed
    (`torch.zeros`) before the launch: the kernel writes the ~3% of entries
    that are non-zero.
    """
    dtype = _float_dtype("g", g)
    t, m = g.shape[0], g.shape[1]
    n, nc2, nnz = r_blk.shape[0], 2 * int(n_coarse), asm_dst.shape[0]
    _check("g", g, dtype, (t, m, 3, 2))
    _check("blocks2", blocks2, dtype, (m, 6, 6))
    _check("r_blk", r_blk, dtype, (n, 2, 2))
    _check("triangles", triangles, torch.int32, (m, 3))
    _check("w_scale", w_scale, dtype, (m,))
    _check("asm_ptr", asm_ptr, torch.int32, (nnz + 1,))
    _check("asm_src", asm_src, torch.int32, (36 * m,))
    _check("asm_dst", asm_dst, torch.int32, (nnz,))
    if nnz % 2:
        raise ValueError(f"coarse_assemble: {nnz} coarse entries, not sibling pairs")
    if not _on_cuda(g, blocks2, r_blk, triangles, w_scale, asm_ptr, asm_src, asm_dst):
        return plain_coarse_assemble(g, blocks2, r_blk, triangles, w_scale, lambda_,
                                     asm_ptr, asm_src, asm_dst, n_coarse, mean)
    out = torch.zeros((1 if mean else t, nc2, nc2), dtype=dtype, device=g.device)
    a2c = torch.empty(nnz, dtype=dtype, device=g.device)
    _launch("coarse_assemble", dtype, g.device, g.data_ptr(), blocks2.data_ptr(),
            r_blk.data_ptr(), triangles.data_ptr(), w_scale.data_ptr(),
            asm_ptr.data_ptr(), asm_src.data_ptr(), asm_dst.data_ptr(),
            float(lambda_), a2c.data_ptr(), out.data_ptr(), t, m, nnz, nc2,
            int(bool(mean)))
    return out


def plain_coarse_assemble(g, blocks2, r_blk, triangles, w_scale, lambda_,
                          asm_ptr, asm_src, asm_dst, n_coarse, mean=False):
    """Plain torch version of `coarse_assemble`: the JAX package's
    triangle-local transform (solve/coarse.py:299-330), then a sum of each
    entry's contributions in CSR order."""
    t, m = g.shape[0], g.shape[1]
    nc2 = 2 * int(n_coarse)
    rc = r_blk[triangles.long()]                                   # (M, 3, 2, 2)
    b2 = blocks2.reshape(m, 3, 2, 3, 2)
    b2c = torch.einsum("mcax,mcadb,mdby->mcxdy", rc, b2, rc).reshape(-1)
    rg = torch.einsum("tmca,mcab->tmcb", g, rc)                    # (T, M, 3, 2)
    eye = torch.eye(3, dtype=g.dtype, device=g.device)
    w = (torch.ones_like(eye) + eye) * w_scale[:, None, None]      # (M, 3, 3)
    if mean:
        b1c = torch.einsum("tmxy,tmuv,mxu->mxyuv", rg, rg, w).reshape(1, -1) / t
    else:
        b1c = torch.einsum("tmxy,tmuv,mxu->tmxyuv", rg, rg, w).reshape(t, -1)
    src = asm_src.long()
    entry = torch.repeat_interleave(
        torch.arange(asm_dst.shape[0], device=g.device),
        (asm_ptr[1:] - asm_ptr[:-1]).long())
    a2c = b2c.new_zeros(asm_dst.shape[0]).index_add_(0, entry, b2c[src])
    a1c = b1c.new_zeros((b1c.shape[0], asm_dst.shape[0])).index_add_(
        1, entry, b1c[:, src])
    out = g.new_zeros((b1c.shape[0], nc2 * nc2))
    out[:, asm_dst.long()] = a1c + lambda_ * a2c
    return out.reshape(-1, nc2, nc2)


# ------------------------------------------------------------------ K9
def coarse_restrict(r: torch.Tensor, r_blk: torch.Tensor,
                    members: torch.Tensor) -> torch.Tensor:
    """K9 `coarse_restrict<T>`: rc = P^T r, (T, 2Nc), with
    rc[t, 2a+b] = sum over the members v of aggregate a of
    sum_a' R_v[a', b] r[t, v + N a'].

    r (T, 2N); r_blk (N, 2, 2); members (Nc, K) int32, padded with N.

    Replaces the restriction of solve/coarse.py:243 `TwoLevelPrecond.apply`
    (:254-266, B7). Bound by reading r, 9.7 MB per call in f32 at the 12.5k
    shapes, gathered by member. Design: a warp owns one aggregate for a
    group of frames (4 in f32, 2 in f64, the fastest on the card): its
    lanes stride through the K members, load each member's id and R_v once
    for the group, then issue the group's r loads before the multiply-adds;
    the fixed-order warp sum closes each frame.
    The first design, a warp per (frame, aggregate), fetched the
    frame-independent members and R_v again for every frame and had one
    load chain in flight a lane; rc is bitwise that design's.
    """
    dtype = _float_dtype("r", r)
    t, n_dof = r.shape
    n = n_dof // 2
    nc, k = members.shape
    _check("r", r, dtype, (t, 2 * n))
    _check("r_blk", r_blk, dtype, (n, 2, 2))
    _check("members", members, torch.int32, (nc, k))
    if not _on_cuda(r, r_blk, members):
        return plain_coarse_restrict(r, r_blk, members)
    rc = torch.empty((t, 2 * nc), dtype=dtype, device=r.device)
    _launch("coarse_restrict", dtype, r.device, r.data_ptr(), r_blk.data_ptr(),
            members.data_ptr(), rc.data_ptr(), t, n, nc, k)
    return rc


def plain_coarse_restrict(r, r_blk, members) -> torch.Tensor:
    """Plain torch version of `coarse_restrict` (solve/coarse.py:254-266)."""
    t, n = r.shape[0], r_blk.shape[0]
    r1, r2 = r[:, :n], r[:, n:]
    q1 = r_blk[:, 0, 0] * r1 + r_blk[:, 1, 0] * r2
    q2 = r_blk[:, 0, 1] * r1 + r_blk[:, 1, 1] * r2
    zero = r.new_zeros((t, 1))
    idx = members.long()
    rc1 = torch.cat([q1, zero], dim=1)[:, idx].sum(dim=2)
    rc2 = torch.cat([q2, zero], dim=1)[:, idx].sum(dim=2)
    return torch.stack([rc1, rc2], dim=-1).reshape(t, -1)


# ------------------------------------------------------------------ K10
def coarse_gemv(ac_inv: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """K10 `coarse_gemv<T>`: yc[t] = ac_inv[t] @ rc[t], (T, 2Nc); an
    `ac_inv` of one frame (coarse_a1='mean') is shared by every frame.

    ac_inv (T or 1, 2Nc, 2Nc); rc (T, 2Nc).

    Replaces the coarse solve of solve/coarse.py:267-271 (B7). The largest
    read of a PCG iteration: ac_inv, 59.6 MB in f32 at the 12.5k shapes
    (119 MB in f64). Design: a warp per (frame, row) and a fixed-order
    warp sum closing each row. In f32 with a matrix per frame the warp
    streams the row in 16-byte evict-first loads, a lane's whole share (16
    values) loaded before its multiply-adds, rc through the read-only
    cache; rows that start off a 16-byte boundary (2Nc = 2 mod 4) are
    handled in the kernel. In f64, and for the shared matrix (a frame
    stride of 0), each lane takes one value a step.
    """
    dtype = _float_dtype("rc", rc)
    t, nc2 = rc.shape
    tf = ac_inv.shape[0]
    if tf not in (1, t):
        raise ValueError(f"ac_inv must have 1 or {t} frames; got {tf}")
    _check("ac_inv", ac_inv, dtype, (tf, nc2, nc2))
    _check("rc", rc, dtype, (t, nc2))
    if not _on_cuda(ac_inv, rc):
        return plain_coarse_gemv(ac_inv, rc)
    yc = torch.empty_like(rc)
    _launch("coarse_gemv", dtype, rc.device, ac_inv.data_ptr(), rc.data_ptr(),
            yc.data_ptr(), t, nc2, 0 if tf == 1 else nc2 * nc2)
    return yc


def plain_coarse_gemv(ac_inv, rc) -> torch.Tensor:
    """Plain torch version of `coarse_gemv`."""
    return torch.sum(ac_inv * rc[:, None, :], dim=-1)


# ------------------------------------------------------------------ K11
def coarse_prolong_dot(z: torch.Tensor, r: torch.Tensor, yc: torch.Tensor,
                       r_blk: torch.Tensor, agg: torch.Tensor,
                       rz: torch.Tensor, precise: bool = False) -> None:
    """K11 `coarse_prolong_dot<T>`, in place: z += P yc, then rz = <r, z>
    per frame, with (P yc)[t, v + N a] = sum_b R_v[a, b] yc[t, 2 agg[v] + b].
    `precise` (float32; nothing changes in float64) sums r.z in float64,
    the slices' partials too, and rounds it once: the
    `coarse_prolong_dot<float,double>` instance; z is the same either way.

    z, r (T, 2N); yc (T, 2Nc); r_blk (N, 2, 2); agg (N,) int32; rz (T,).

    Replaces the prolongation of solve/coarse.py:272-278 and the r.z of
    solve/cg.py:98 (B7): after the Jacobi term of K3 `pcg_update`, whose
    r.z misses the coarse term, this forms the two-level z and its r.z in
    one pass. Bound by memory traffic, 29 MB per call in f32 at the 12.5k
    shapes (reads z, r, writes z). Design: as K3 `pcg_update`, a grid of
    `frame_slices(N)` blocks a frame, each thread loading z, r, R_v and agg
    of four (f32) or two (f64) vertices as 16-byte vectors before the
    arithmetic; the blocks' partial r.z close in slice order in the last
    block of each frame, found by an integer ticket in `slice_workspace`
    (no float atomics, repeated calls bitwise equal). z is the first
    design's expression, so it is bitwise that design's; only r.z's
    summation order changed. The first design, one block a frame, put 97
    blocks on 132 SMs with scalar loads.
    """
    dtype = _float_dtype("z", z)
    t, n_dof = z.shape
    n = n_dof // 2
    nc2 = yc.shape[1]
    _check("z", z, dtype, (t, 2 * n))
    _check("r", r, dtype, (t, 2 * n))
    _check("yc", yc, dtype, (t, nc2))
    _check("r_blk", r_blk, dtype, (n, 2, 2))
    _check("agg", agg, torch.int32, (n,))
    _check("rz", rz, dtype, (t,))
    precise = precise and dtype == torch.float32
    if not _on_cuda(z, r, yc, r_blk, agg, rz):
        plain_coarse_prolong_dot(z, r, yc, r_blk, agg, rz, precise)
        return
    n_slices = frame_slices(n, dtype)
    part, ticket = slice_workspace(z.device, torch.cuda.current_stream(z.device).cuda_stream,
                                   t, n_slices)
    _launch("coarse_prolong_dot", dtype, z.device, z.data_ptr(), r.data_ptr(),
            yc.data_ptr(), r_blk.data_ptr(), agg.data_ptr(), rz.data_ptr(),
            part.data_ptr(), ticket.data_ptr(), t, n, nc2 // 2, n_slices,
            precise=precise)


def plain_coarse_prolong_dot(z, r, yc, r_blk, agg, rz, precise: bool = False) -> None:
    """Plain torch version of `coarse_prolong_dot`."""
    t = yc.shape[0]
    ycr = yc.reshape(t, -1, 2)
    idx = agg.long()
    ya, yb = ycr[:, idx, 0], ycr[:, idx, 1]
    z1 = r_blk[:, 0, 0] * ya + r_blk[:, 0, 1] * yb
    z2 = r_blk[:, 1, 0] * ya + r_blk[:, 1, 1] * yb
    z.add_(torch.cat([z1, z2], dim=-1))
    rz.copy_(precise_sum(r, z) if precise else torch.sum(r * z, dim=-1))
