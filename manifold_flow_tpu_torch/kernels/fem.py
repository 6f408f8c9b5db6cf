"""Wrappers of the solve's hand-written CUDA kernels (K1-K4), with their
plain torch versions.

Each wrapper decides by the device of the tensors it is given: CPU tensors
take the plain version; CUDA tensors launch the kernel (built from
`csrc/*.cu` at first use by `kernels.build`) or raise. Nothing falls back.
Every wrapper checks dtype, device, shape and contiguity before either path,
allocates outputs and scratch with `torch.empty`, launches on the current
stream, and raises when the C entry point returns a CUDA error.

`kernels.LAUNCHES` (see `kernels._lib`, shared with `kernels.analysis`)
counts kernel launches by "name<ctype>"; a wrapper adds one where it
launches its kernel and nowhere else.

Shapes below are given at the bench problem (T=97 frames, M=6050 triangles,
N=3136 vertices, C=6 cells per vertex) and at 12.5k vertices (M=24642).
Byte counts are the device-memory traffic a call needs at those shapes, the
bound of every kernel here: each does a few flops per byte, far below what
the H100 can feed (tens of flops per byte). The solve's working set (~32 MB
in f32 at the bench shapes) fits the 50 MB L2, but the 12.5k one does not:
K1's g alone is 57 MB there. So K1 keeps its local products out of device
memory (a vertex tile per block, the products in shared memory), and K3's
update fills the card with several blocks a frame and 16-byte loads, enough
bytes in flight to stream at the memory's rate.
"""

from __future__ import annotations

import torch

from manifold_flow_tpu_torch.fem import assembly
from manifold_flow_tpu_torch.kernels._lib import (
    _check,
    _float_dtype,
    _launch,
    _on_cuda,
    _ptr,
    frame_slices,
    slice_workspace,
)


# ------------------------------------------------------------------ plain helpers
def invert_2x2_blocks(d: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of (..., 2, 2) blocks; singular blocks -> identity."""
    a, b = d[..., 0, 0], d[..., 0, 1]
    c, e = d[..., 1, 0], d[..., 1, 1]
    det = a * e - b * c
    nonsingular = torch.abs(det) > 0
    safe = torch.where(nonsingular, det, torch.ones_like(det))
    inv = torch.stack([torch.stack([e, -b], dim=-1),
                       torch.stack([-c, a], dim=-1)], dim=-2) / safe[..., None, None]
    eye = torch.eye(2, dtype=d.dtype, device=d.device).expand(inv.shape)
    return torch.where(nonsingular[..., None, None], inv, eye)


def apply_block_diag(diag: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Apply per-vertex 2x2 blocks (T, N, 2, 2) to DOF vectors r (T, 2N)."""
    n = diag.shape[1]
    r1, r2 = r[:, :n], r[:, n:]
    z1 = diag[:, :, 0, 0] * r1 + diag[:, :, 0, 1] * r2
    z2 = diag[:, :, 1, 0] * r1 + diag[:, :, 1, 1] * r2
    return torch.cat([z1, z2], dim=-1)


def local_contributions(x, dof, blocks2, g, w_scale, lambda_) -> torch.Tensor:
    """Per-triangle local products y_loc (T, M, 6) of A x (plain torch)."""
    t, m = x.shape[0], dof.shape[0]
    xg = x[:, dof.long()]                                   # (T, M, 6)
    y2 = torch.einsum("mij,tmj->tmi", blocks2, xg)
    s = torch.sum(g * xg.reshape(t, m, 3, 2), dim=-1)       # (T, M, 3)
    stot = torch.sum(s, dim=-1, keepdim=True)
    w = w_scale[:, None] * (s + stot)
    y1 = g * w[..., None]
    return lambda_ * y2 + y1.reshape(t, m, 6)


# ------------------------------------------------------------------ K1
# K1's frames a block (dof and the a2 blocks are read once for them): 4 in
# float32, 2 in float64, 70 KB of local products at the 12.5k tiles.
FEM_FRAMES = {torch.float32: 4, torch.float64: 2}
SMEM_BYTES = 227 * 1024  # shared memory a block can have on the H100


def fem_matvec(x: torch.Tensor, dof: torch.Tensor, blocks2: torch.Tensor,
               g: torch.Tensor, w_scale: torch.Tensor, lambda_: float,
               gather_base: torch.Tensor, tiles: assembly.VertexTiles,
               f: torch.Tensor | None = None) -> torch.Tensor:
    """K1 `fem_matvec<T>`: y = (a1_k + lambda a2) x for all frames, or the
    residual f - y when `f` is given.

    x, f (T, 2N); dof (M, 6) int32; blocks2 (M, 6, 6); g (T, M, 3, 2);
    w_scale (M,) = A/12; gather_base (N, C) int32 (assembly.gather_base_table);
    tiles (assembly.vertex_tiles of gather_base; the plain version reads
    gather_base instead).

    Replaces fem/operator.py:56 `local_contributions` + :69 `matvec` (B2) and,
    as the f64 instance with `f`, fem/df_operator.py:45 `DFFlowOperator.matvec`
    + :66 `residual` (B5). Bound by memory traffic: in f32 at the bench shapes
    a call reads g (14.1 MB), x (2.4 MB), the a2 blocks (0.9 MB) and the
    tables and writes y (2.4 MB), ~20 MB (g 57.4 MB of ~80 MB at 12.5k);
    twice that in f64. Design: one launch, a block per (tile of `tiles.size`
    consecutive vertices, FEM_FRAMES frames). Its threads compute the six
    local outputs of every cell incident to the tile (halo cells again in
    each tile that touches them) into shared memory, one thread a cell
    holding the cell's dof and a2 block in registers for all the block's
    frames, then sum each vertex's entries in gather_base's column order:
    the JAX package's order, no atomics, and the output of the first design
    (local products written to and read back from a (T, M, 6) y_loc in
    device memory, 2 x 14.1 MB more at the bench shapes) bit for bit. The
    products wait on their loads (latency-bound on the H100); csrc/
    fem_kernels.cu lists what was tried and lost.
    """
    dtype = _float_dtype("x", x)
    t, n_dof = x.shape
    m, n, c = dof.shape[0], n_dof // 2, gather_base.shape[1]
    _check("x", x, dtype, (t, 2 * n))
    _check("dof", dof, torch.int32, (m, 6))
    _check("blocks2", blocks2, dtype, (m, 6, 6))
    _check("g", g, dtype, (t, m, 3, 2))
    _check("w_scale", w_scale, dtype, (m,))
    _check("gather_base", gather_base, torch.int32, (n, c))
    if f is not None:
        _check("f", f, dtype, (t, 2 * n))
    if not _on_cuda(x, dof, blocks2, g, w_scale, gather_base, f):
        return plain_fem_matvec(x, dof, blocks2, g, w_scale, lambda_,
                                gather_base, f)
    n_tiles, n_listed = -(-n // tiles.size), tiles.cells.shape[0]
    _check("tiles.cell_ptr", tiles.cell_ptr, torch.int32, (n_tiles + 1,))
    _check("tiles.cells", tiles.cells, torch.int32, (n_listed,))
    _check("tiles.gather", tiles.gather, torch.int32, (n, c))
    _check("tiles.cell_dof", tiles.cell_dof, torch.int32, (6, n_listed))
    _check("tiles.blocks2", tiles.blocks2, dtype, (21, n_listed))
    _on_cuda(x, tiles.cell_ptr, tiles.cells, tiles.gather, tiles.cell_dof,
             tiles.blocks2)
    frames = FEM_FRAMES[dtype]  # fewer where the local products would overflow
    while frames > 1 and frames * tiles.max_cells * 6 * x.element_size() > SMEM_BYTES:
        frames //= 2
    out = torch.empty_like(x)
    _launch("fem_matvec", dtype, x.device, x.data_ptr(), tiles.cell_dof.data_ptr(),
            tiles.blocks2.data_ptr(), g.data_ptr(), w_scale.data_ptr(),
            float(lambda_), tiles.cell_ptr.data_ptr(), tiles.cells.data_ptr(),
            tiles.gather.data_ptr(), _ptr(f), out.data_ptr(), t, m, n, c,
            tiles.size, n_tiles, tiles.max_cells, n_listed, frames)
    return out


def plain_fem_matvec(x, dof, blocks2, g, w_scale, lambda_, gather_base,
                     f=None) -> torch.Tensor:
    """Plain torch version of `fem_matvec`."""
    y = assembly.reduce_table(
        local_contributions(x, dof, blocks2, g, w_scale, lambda_), gather_base)
    return y if f is None else f - y


# ------------------------------------------------------------------ K2
def jacobi_blocks(g: torch.Tensor, reg: torch.Tensor, areas: torch.Tensor,
                  lambda_: float, gather_base: torch.Tensor) -> torch.Tensor:
    """K2 `jacobi_blocks<T>`: inverted per-vertex 2x2 diagonal blocks
    (T, N, 2, 2) of A = a1_k + lambda a2.

    g (T, M, 3, 2); reg (M, 3, 2, 2) from assembly.corner_regularization;
    areas (M,) in g's dtype; gather_base (N, C) int32.

    Replaces fem/assembly.py:134 `diag_contributions` + :164 `diag_blocks`
    and fem/operator.py:113 `block_jacobi_inverse` + :119 `invert_2x2_blocks`
    (B3). Bound by memory traffic, ~19 MB in f32 at the bench shapes: g
    (14.1 MB, read through the vertex table), reg (0.3 MB) and the inverse
    blocks (4.9 MB); 78 MB at 12.5k, where g alone (57.4 MB) exceeds the
    50 MB L2. Design: a thread takes a vertex and 4 consecutive frames,
    reads each incident corner's table entry, A/6 and reg once for them,
    sums the corners in table order and writes each closed-form inverse as
    one 16-byte store (two in f64), so the (T, M, 3, 2, 2) per-corner
    contributions are never stored.
    """
    dtype = _float_dtype("g", g)
    t, m = g.shape[0], g.shape[1]
    n, c = gather_base.shape
    _check("g", g, dtype, (t, m, 3, 2))
    _check("reg", reg, dtype, (m, 3, 2, 2))
    _check("areas", areas, dtype, (m,))
    _check("gather_base", gather_base, torch.int32, (n, c))
    if not _on_cuda(g, reg, areas, gather_base):
        return plain_jacobi_blocks(g, reg, areas, lambda_, gather_base)
    dinv = torch.empty((t, n, 2, 2), dtype=dtype, device=g.device)
    _launch("jacobi_blocks", dtype, g.device, g.data_ptr(), reg.data_ptr(),
            areas.data_ptr(), float(lambda_), gather_base.data_ptr(),
            dinv.data_ptr(), t, m, n, c)
    return dinv


def plain_jacobi_blocks(g, reg, areas, lambda_, gather_base) -> torch.Tensor:
    """Plain torch version of `jacobi_blocks`."""
    contrib = lambda_ * reg[None] + assembly.corner_data(g, areas)
    return invert_2x2_blocks(assembly.sum_corners(contrib, gather_base))


# ------------------------------------------------------------------ K4
# K4's frames a block (a cell's geometry is read once for them): 2, the
# fastest of 1, 2 and 4 on the H100 in both types; 105 KB of g and scales
# in float64 at the 12.5k tiles, two blocks an SM.
RHS_FRAMES = 2


def frame_factors_rhs(potentials: torch.Tensor, potentials_next: torch.Tensor,
                      times: torch.Tensor, triangles: torch.Tensor,
                      grad_w: torch.Tensor, basis: torch.Tensor,
                      areas: torch.Tensor, gather_base: torch.Tensor,
                      tiles: assembly.CellTiles | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 `frame_factors_rhs<T>`: the a1 factors g (T, M, 3, 2) and the RHS
    f (T, 2N) of frames k = 0..T-1 from a (T+1, N) movie.

    g uses potentials[k]; f uses dI = (potentials_next[k+1] - potentials[k])
    / (times[k+1] - times[k]). triangles (M, 3) int32; grad_w (M, 3, 3);
    basis (N, 2, 3); areas (M,); gather_base (N, C) int32; tiles
    (assembly.cell_tiles of gather_base, built here where not given; the
    plain version reads gather_base instead).

    Replaces fem/assembly.py:61 `frame_factors` + :99 `rhs_vector` and their
    DF twins in fem/df_operator.py:181-235 (B1). Runs once per solve. Bound by
    memory traffic: in f64 it writes g (28.2 MB at the bench shapes, 114.7 MB
    at 12.5k) and f (4.9 / 19.5 MB) and reads the movie (2.5 / 9.8 MB; twice
    where potentials_next is another) and the mesh tables. Design: one
    launch, a block per (tile of
    `tiles.size` consecutive vertices, RHS_FRAMES frames), as K1's. Its
    threads compute every cell incident to the tile (halo cells again in
    each tile that touches them) into shared memory, one thread a cell
    holding the cell's geometry in registers for all the block's frames:
    the six g values and the three corner scales of the local RHS. Then
    each vertex sums g * scale over its entries in gather_base's column
    order, and the block writes g of the cells it owns (`tiles.owned`),
    consecutive threads on consecutive elements. g and f are, bit for bit,
    those of the first design, which wrote g and a (T, M, 6) local RHS to
    device memory, one thread per (frame, triangle), and summed the local
    RHS per vertex in a second launch.
    """
    dtype = _float_dtype("potentials", potentials)
    t1, n = potentials.shape
    m, c = triangles.shape[0], gather_base.shape[1]
    _check("potentials", potentials, dtype, (t1, n))
    _check("potentials_next", potentials_next, dtype, (t1, n))
    _check("times", times, dtype, (t1,))
    _check("triangles", triangles, torch.int32, (m, 3))
    _check("grad_w", grad_w, dtype, (m, 3, 3))
    _check("basis", basis, dtype, (n, 2, 3))
    _check("areas", areas, dtype, (m,))
    _check("gather_base", gather_base, torch.int32, (n, c))
    t = t1 - 1
    if not _on_cuda(potentials, potentials_next, times, triangles, grad_w,
                    basis, areas, gather_base):
        return plain_frame_factors_rhs(potentials, potentials_next, times,
                                       triangles, grad_w, basis, areas,
                                       gather_base)
    if tiles is None:
        tiles = assembly.cell_tiles(gather_base, m)
    n_tiles, n_listed = -(-n // tiles.size), tiles.cells.shape[0]
    _check("tiles.cell_ptr", tiles.cell_ptr, torch.int32, (n_tiles + 1,))
    _check("tiles.cells", tiles.cells, torch.int32, (n_listed,))
    _check("tiles.gather", tiles.gather, torch.int32, (n, c))
    _check("tiles.own_ptr", tiles.own_ptr, torch.int32, (n_tiles + 1,))
    _check("tiles.owned", tiles.owned, torch.int32, (m,))
    _on_cuda(potentials, tiles.cell_ptr, tiles.cells, tiles.gather, tiles.own_ptr,
             tiles.owned)
    frames = RHS_FRAMES  # 1 where the tables would overflow
    while frames > 1 and frames * tiles.max_cells * 9 * potentials.element_size() > SMEM_BYTES:
        frames //= 2
    device = potentials.device
    g = torch.empty((t, m, 3, 2), dtype=dtype, device=device)
    f = torch.empty((t, 2 * n), dtype=dtype, device=device)
    _launch("frame_factors_rhs", dtype, device, potentials.data_ptr(),
            potentials_next.data_ptr(), times.data_ptr(), triangles.data_ptr(),
            grad_w.data_ptr(), basis.data_ptr(), areas.data_ptr(),
            tiles.cell_ptr.data_ptr(), tiles.cells.data_ptr(), tiles.gather.data_ptr(),
            tiles.own_ptr.data_ptr(), tiles.owned.data_ptr(), g.data_ptr(),
            f.data_ptr(), t, m, n, c, tiles.size, n_tiles, tiles.max_cells, frames)
    return g, f


def plain_frame_factors_rhs(potentials, potentials_next, times, triangles,
                            grad_w, basis, areas, gather_base):
    """Plain torch version of `frame_factors_rhs`."""
    tri = triangles.long()
    pot = potentials[:-1]
    grad_m = torch.einsum("tmc,mcd->tmd", pot[:, tri], grad_w)
    g = torch.einsum("tmd,mcad->tmca", grad_m, basis[tri])
    di = (potentials_next[1:] - pot) / (times[1:] - times[:-1])[:, None]
    di_tri = di[:, tri]
    scale = (di_tri + di_tri.sum(dim=-1, keepdim=True)) * (areas / 12.0)[:, None]
    f_loc = (g * scale[..., None]).reshape(g.shape[0], -1, 6)
    return g, assembly.reduce_table(f_loc, gather_base)


# ------------------------------------------------------------------ K3
def pcg_dot(a: torch.Tensor, b: torch.Tensor, precise: bool = False) -> torch.Tensor:
    """K3(a) `pcg_dot<T>`: per-frame dot products (T,) of (T, n) tensors.

    `precise` (float32 operands; nothing changes in float64) forms every
    product and the sum in float64 and rounds the frame's sum to float32
    once: the `pcg_dot<float,double>` instance, solve/cg.py:30's
    `precise=True`. It reads the same bytes as `pcg_dot<float>`.

    Replaces solve/cg.py:30 `_dot` (B4): p.Ap each iteration, and the norms
    of the solve. Bound by reading both operands, 4.9 MB per call in f32 at
    the bench shapes (19.5 MB at 12.5k). Design: one block per frame
    streaming the row in 16-byte loads, four in flight a thread per
    operand, closed by the fixed-order block sum. One launch, no atomics,
    no scratch; any n (0 gives zeros) and any element offset of either
    operand.
    """
    dtype = _float_dtype("a", a)
    if a.dim() != 2:
        raise ValueError(f"a must be (T, n); got {tuple(a.shape)}")
    _check("a", a, dtype, a.shape)
    _check("b", b, dtype, a.shape)
    precise = precise and dtype == torch.float32
    if not _on_cuda(a, b):
        return plain_pcg_dot(a, b, precise)
    out = torch.empty(a.shape[0], dtype=dtype, device=a.device)
    _launch("pcg_dot", dtype, a.device, a.data_ptr(), b.data_ptr(),
            out.data_ptr(), a.shape[0], a.shape[1], precise=precise)
    return out


def precise_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) over the last axis, formed in float64 and rounded to a's
    dtype once (the plain versions' `precise` dots)."""
    return torch.sum(a.double() * b.double(), dim=-1).to(a.dtype)


def plain_pcg_dot(a, b, precise: bool = False) -> torch.Tensor:
    """Plain torch version of `pcg_dot`."""
    return precise_sum(a, b) if precise else torch.sum(a * b, dim=-1)


def pcg_update(x, r, z, p, ap, dinv, rz, pap, rz_new, rr, precise: bool = False) -> None:
    """K3(b) `pcg_update<T>`, in place: alpha = rz / pAp (0 where pAp == 0),
    x += alpha p, r -= alpha Ap, z = D^-1 r, then rz_new = r.z and rr = r.r.
    `precise` (float32; nothing changes in float64) sums r.z and r.r in
    float64, the slices' partials too, and rounds each once: the
    `pcg_update<float,double>` instance. x, r and z are the same either way.

    x, r, z, p, ap (T, 2N); dinv (T, N, 2, 2); rz, pap, rz_new, rr (T,).
    x, r, z, rz_new and rr are overwritten (the port updates the PCG state in
    place, where the JAX loop builds new arrays).

    Replaces the update half of the solve/cg.py:89-102 loop body with
    fem/operator.py:132 `apply_block_diag` fused in (B3/B4). Bound by memory
    traffic, 21.9 MB per call in f32 at the bench shapes and 87.6 MB at
    12.5k (reads x, r, p, Ap and D^-1, writes x, r, z). Design: a grid of
    `frame_slices(N)` blocks a frame, each thread with every operand of
    four (f32) or two (f64) vertices in flight as 16-byte vectors; the
    blocks' partial r.z and r.r close in slice order in the last block of
    each frame, found by an integer ticket in `slice_workspace` (no float
    atomics, repeated calls bitwise equal). The first design, one block a
    frame with scalar loads, kept about 0.8 MB in flight, where the card
    needs about 2 MB.
    """
    dtype = _float_dtype("x", x)
    t, n_dof = x.shape
    n = n_dof // 2
    for name, v in (("x", x), ("r", r), ("z", z), ("p", p), ("ap", ap)):
        _check(name, v, dtype, (t, 2 * n))
    _check("dinv", dinv, dtype, (t, n, 2, 2))
    for name, v in (("rz", rz), ("pap", pap), ("rz_new", rz_new), ("rr", rr)):
        _check(name, v, dtype, (t,))
    precise = precise and dtype == torch.float32
    if not _on_cuda(x, r, z, p, ap, dinv, rz, pap, rz_new, rr):
        plain_pcg_update(x, r, z, p, ap, dinv, rz, pap, rz_new, rr, precise)
        return
    n_slices = frame_slices(n, dtype)
    part, ticket = slice_workspace(x.device, torch.cuda.current_stream(x.device).cuda_stream,
                                   t, n_slices)
    _launch("pcg_update", dtype, x.device, x.data_ptr(), r.data_ptr(),
            z.data_ptr(), p.data_ptr(), ap.data_ptr(), dinv.data_ptr(),
            rz.data_ptr(), pap.data_ptr(), rz_new.data_ptr(), rr.data_ptr(),
            part.data_ptr(), ticket.data_ptr(), t, n, n_slices, precise=precise)


def plain_pcg_update(x, r, z, p, ap, dinv, rz, pap, rz_new, rr,
                     precise: bool = False) -> None:
    """Plain torch version of `pcg_update`."""
    nonzero = pap != 0
    alpha = torch.where(nonzero, rz / torch.where(nonzero, pap, torch.ones_like(pap)),
                        torch.zeros_like(pap))
    x.add_(alpha[:, None] * p)
    r.sub_(alpha[:, None] * ap)
    z.copy_(apply_block_diag(dinv, r))
    dot = precise_sum if precise else (lambda a, b: torch.sum(a * b, dim=-1))
    rz_new.copy_(dot(r, z))
    rr.copy_(dot(r, r))


def pcg_direction(p, z, rz_new, rz_old) -> None:
    """K3(c) `pcg_direction<T>`, in place: p = z + beta p with
    beta = rz_new / rz_old (0 where rz_old == 0).

    Replaces the direction update of solve/cg.py:99-101 (B4). Bound by
    memory traffic, 7.3 MB per call in f32 at the bench shapes. Design: one
    thread per element.
    """
    dtype = _float_dtype("p", p)
    t, n_dof = p.shape
    _check("p", p, dtype, (t, n_dof))
    _check("z", z, dtype, (t, n_dof))
    _check("rz_new", rz_new, dtype, (t,))
    _check("rz_old", rz_old, dtype, (t,))
    if not _on_cuda(p, z, rz_new, rz_old):
        plain_pcg_direction(p, z, rz_new, rz_old)
        return
    _launch("pcg_direction", dtype, p.device, p.data_ptr(), z.data_ptr(),
            rz_new.data_ptr(), rz_old.data_ptr(), t, n_dof)


def plain_pcg_direction(p, z, rz_new, rz_old) -> None:
    """Plain torch version of `pcg_direction`."""
    nonzero = rz_old != 0
    beta = torch.where(nonzero, rz_new / torch.where(nonzero, rz_old, torch.ones_like(rz_old)),
                       torch.zeros_like(rz_old))
    p.copy_(z + beta[:, None] * p)


def pcg_gate(rr, target, ctl, rz_new, rz) -> None:
    """K3(d) `pcg_gate<T>`, in place: the PCG loop's convergence test on
    the device, at the end of each iteration (solve/cg.py).

    active = ctl[0] < ctl[2] and any(sqrt(rr) > target), in rr's dtype and
    with the operations of the JAX loop's `cond` (solve/cg.py:84-87), which
    the port's loop once tested on the host each iteration; then ctl[0] += active, ctl[1] = active and rz =
    rz_new where active, else 0: the next `pcg_update` then takes alpha = 0
    and leaves x, r and rr as they are. rr, target, rz_new, rz (T,); ctl
    (3,) int64 = (count, active, max_iter).

    Bound by its launch: it reads 2T values and writes T + 2. Design: one
    block, an OR over the frames through the block's barrier
    (`__syncthreads_or`), which also orders every thread's read of the
    count before thread 0 writes it.
    """
    dtype = _float_dtype("rr", rr)
    t = rr.shape[0]
    for name, v in (("rr", rr), ("target", target), ("rz_new", rz_new), ("rz", rz)):
        _check(name, v, dtype, (t,))
    _check("ctl", ctl, torch.int64, (3,))
    if not _on_cuda(rr, target, ctl, rz_new, rz):
        plain_pcg_gate(rr, target, ctl, rz_new, rz)
        return
    _launch("pcg_gate", dtype, rr.device, rr.data_ptr(), target.data_ptr(),
            ctl.data_ptr(), rz_new.data_ptr(), rz.data_ptr(), t)


def plain_pcg_gate(rr, target, ctl, rz_new, rz) -> None:
    """Plain torch version of `pcg_gate`."""
    active = (ctl[0] < ctl[2]) & torch.any(torch.sqrt(rr) > target)
    rz.copy_(torch.where(active, rz_new, torch.zeros_like(rz_new)))
    ctl[0] += active.long()
    ctl[1] = active.long()

