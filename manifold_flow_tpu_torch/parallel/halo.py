"""Halo-exchange vertex-block partition: the mesh axis shards memory.

Counterpart of manifold_flow_tpu/parallel/halo.py. Vertices split into blocks
by recursive coordinate bisection; each mesh rank owns its block's DOF rows
and holds every triangle that touches an owned vertex, so an owned row of
the matvec, the RHS or the Jacobi diagonal is complete locally. The only
collective of a matvec is an all-gather of the block-boundary values into
the halo slots; the CG dots are all-reduced (solve.cg `comm`).

The partition tables (`build_partition`) are the JAX package's, entry for
entry, built on the host with numpy. Each rank then lays out its block as a
small mesh of its own, on which the single-device kernels run unchanged:

  * local vertex slots [0, Vo) hold the owned vertices (the shard's first
    n_owned), [Vo, Vo + Vh) the halo vertices; the rest are padding;
  * vectors are (T, 2 Vl) in the local DOF layout slot + Vl * component;
  * the K1/K2/K4 vertex table (`gather_base`) lists each owned vertex's
    incidences over the local triangles; halo and pad rows list none, so K1
    and K4 leave zeros there, and the Jacobi blocks of those rows are set
    to zero after K2 (K2 would invert a zero block);
  * r, Ap and z' = D^-1 r are then zero off the owned rows and every dot of
    the PCG sums owned rows only. A halo row of p or x holds whatever the
    last exchange or update left: the exchange overwrites it before K1
    reads it, and nothing else reads it.

Per matvec: `HaloOperator.exchange` (an index_select of the owned boundary
rows, the all-gather of (T, 2, B) values, an index_select into the halo
rows), then K1 on the local block. The RHS and the a1 factors are K4 on the
local block, the Jacobi blocks K2, the two-level correction K9-K11 on the
owned rows, and its coarse matrices K8 over the triangles this shard owns
for assembly (`asm_w`), all-reduced over the mesh axis before the
Cholesky inverse. `solve.coarse.TwoLevelPrecond` on the local rows, with
`correct(comm=)`, is the JAX package's `HaloTwoLevel`.

The refined solve keeps the port's refined semantics: f32 inner halo PCG,
then the f64 residual on K1 `<double>` after a float64 exchange. Not ported:
`HaloDFOperator` (the two-float32 residual; the H100 has native f64) and
`_stacked_reduce_plans` (it serves the scatter-free reduce plan that K8
replaces).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from manifold_flow_tpu_torch.fem import assembly
from manifold_flow_tpu_torch.fem.operator import FlowOperator
from manifold_flow_tpu_torch.geometry.mesh import TriMesh, mesh_cached
from manifold_flow_tpu_torch.kernels import coarse as kcoarse
from manifold_flow_tpu_torch.kernels import fem as kfem
from manifold_flow_tpu_torch.parallel.comm import AxisComm
from manifold_flow_tpu_torch.parallel.partition import (
    DeviceMesh,
    frame_block,
    gather_frames,
    pad_frames,
)
from manifold_flow_tpu_torch.solve import coarse
from manifold_flow_tpu_torch.solve.api import VelocityResult, check_movie, resolve_precond
from manifold_flow_tpu_torch.solve.cg import solve_cg
from manifold_flow_tpu_torch.solve.refine import DEFAULT_INNER_TOL, refine_loop


def partition_vertices(points: np.ndarray, n_shards: int) -> np.ndarray:
    """Owner shard per vertex via recursive coordinate bisection (a copy of
    the JAX package's): the widest bounding-box axis splits at the balanced
    quantile, recursing into floor/ceil halves."""
    points = np.asarray(points)
    owner = np.zeros(points.shape[0], dtype=np.int32)

    def rec(ids, lo, hi):
        k = hi - lo
        if k <= 1:
            owner[ids] = lo
            return
        k1 = k // 2
        pts = points[ids]
        ax = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        order = np.argsort(pts[:, ax], kind="stable")
        cut = int(round(len(ids) * k1 / k))
        rec(ids[order[:cut]], lo, lo + k1)
        rec(ids[order[cut:]], lo + k1, hi)

    rec(np.arange(points.shape[0]), 0, n_shards)
    return owner


@dataclasses.dataclass(frozen=True)
class HaloPartition:
    """Host partition tables, stacked (n_shards, ...), as the JAX package
    builds them (numpy arrays, equal entry for entry).

      owner        (N,)            owning shard per global vertex
      owned_slot   (N,)            owned-slot index per global vertex
      owned_ids    (S, Vo)         global vertex per owned slot (pad N)
      tri_ids      (S, Ml)         global triangle per local slot (pad M)
      tri_corners  (S, Ml, 3)      global corner ids (pad N)
      dof_local    (S, Ml, 6)      local DOF ids, slot + Vl * component (pad 0)
      base6        (S, Vo, C)      owned-vertex table over local
                                   (cell*6 + slot*2) positions (pad Ml*6)
      base3        (S, Vo, C)      ditto over (cell*3 + slot) (pad Ml*3)
      send_idx     (S, B)          owned slots published to the halo ring
      halo_src     (S, H)          flat (shard*B + pos) index per halo slot
                                   into the all-gathered buffer (pad S*B)
      asm_w        (S, Ml)         1.0 where this shard is the triangle's
                                   unique assembly owner, else 0.0
      n_triangles  M, the pad value of tri_ids
      key          content digest of the mesh and n_shards (cache key)
    """

    owner: np.ndarray
    owned_slot: np.ndarray
    owned_ids: np.ndarray
    tri_ids: np.ndarray
    tri_corners: np.ndarray
    dof_local: np.ndarray
    base6: np.ndarray
    base3: np.ndarray
    send_idx: np.ndarray
    halo_src: np.ndarray
    asm_w: np.ndarray
    n_shards: int = 1
    v_owned: int = 0
    v_halo: int = 0
    m_local: int = 0
    b_send: int = 0
    n_triangles: int = 0
    key: str = ""

    @property
    def v_local(self) -> int:
        return self.v_owned + self.v_halo


_PARTITION_CACHE: dict = {}
_CACHE_SIZE = 16


def _remember(cache: dict, key, value):
    cache[key] = value
    while len(cache) > _CACHE_SIZE:
        cache.pop(next(iter(cache)))
    return value


def _content_key(*arrays) -> str:
    """Content digest of host arrays: the cache keys do not use id(), which
    CPython recycles."""
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def build_partition(mesh: TriMesh, n_shards: int) -> HaloPartition:
    """Build (and cache, by the mesh's content and n_shards) the halo
    partition tables of `mesh`, on the host: the JAX `build_partition`."""
    points = _host(mesh.points)
    tris = _host(mesh.triangles)
    key = (_content_key(tris, points), int(n_shards))
    hit = _PARTITION_CACHE.get(key)
    if hit is not None:
        return hit
    n = points.shape[0]
    m = tris.shape[0]
    owner = partition_vertices(points, n_shards)

    owned_lists = [np.where(owner == s)[0] for s in range(n_shards)]
    vo = max(max(len(o) for o in owned_lists), 1)
    owned_slot = np.zeros(n, dtype=np.int32)
    for o in owned_lists:
        owned_slot[o] = np.arange(len(o), dtype=np.int32)

    tri_shard = owner[tris]                                  # (M, 3)
    tri_lists = [np.where((tri_shard == s).any(axis=1))[0]
                 for s in range(n_shards)]
    ml = max(max(len(tl) for tl in tri_lists), 1)
    asm_owner = tri_shard[:, 0]                              # unique owner

    halo_lists = []
    for s in range(n_shards):
        corners = np.unique(tris[tri_lists[s]])
        halo_lists.append(np.sort(corners[owner[corners] != s]))
    vh = max(max((len(h) for h in halo_lists), default=0), 1)
    vl = vo + vh

    # Send lists: owned vertices any other shard needs.
    needed = np.zeros(n, dtype=bool)
    for h in halo_lists:
        needed[h] = True
    send_lists = [owned_lists[s][needed[owned_lists[s]]] for s in range(n_shards)]
    b = max(max((len(sl) for sl in send_lists), default=0), 1)
    send_pos = np.full(n, -1, dtype=np.int64)                # flat buffer pos
    for s, sl in enumerate(send_lists):
        send_pos[sl] = s * b + np.arange(len(sl))

    owned_ids = np.full((n_shards, vo), n, dtype=np.int32)
    tri_ids = np.full((n_shards, ml), m, dtype=np.int32)
    tri_corners = np.full((n_shards, ml, 3), n, dtype=np.int32)
    dof_local = np.zeros((n_shards, ml, 6), dtype=np.int32)
    send_idx = np.zeros((n_shards, b), dtype=np.int32)
    halo_src = np.full((n_shards, vh), n_shards * b, dtype=np.int32)
    asm_w = np.zeros((n_shards, ml), dtype=np.float32)

    cmax = 1
    incid = []
    for s in range(n_shards):
        o, tl, h = owned_lists[s], tri_lists[s], halo_lists[s]
        owned_ids[s, : len(o)] = o
        tri_ids[s, : len(tl)] = tl
        tri_corners[s, : len(tl)] = tris[tl]
        local_of = np.full(n, 0, dtype=np.int32)             # pad target 0
        local_of[o] = np.arange(len(o), dtype=np.int32)
        local_of[h] = vo + np.arange(len(h), dtype=np.int32)
        corners_local = local_of[tris[tl]]                   # (Ms, 3)
        dof_local[s, : len(tl)] = (
            corners_local[:, :, None]
            + vl * np.arange(2, dtype=np.int32)).reshape(len(tl), 6)
        send_idx[s, : len(send_lists[s])] = owned_slot[send_lists[s]]
        halo_src[s, : len(h)] = send_pos[h]
        asm_w[s, : len(tl)] = (asm_owner[tl] == s).astype(np.float32)

        # Owned-vertex incidence over LOCAL triangle slots.
        inc = [[] for _ in range(len(o))]
        for j, tri in enumerate(tris[tl]):
            for slot, v in enumerate(tri):
                if owner[v] == s:
                    inc[owned_slot[v]].append((j, slot))
        incid.append(inc)
        cmax = max(cmax, max((len(x) for x in inc), default=1))

    base6 = np.full((n_shards, vo, cmax), ml * 6, dtype=np.int32)
    base3 = np.full((n_shards, vo, cmax), ml * 3, dtype=np.int32)
    for s in range(n_shards):
        for v, lst in enumerate(incid[s]):
            for c, (j, slot) in enumerate(lst):
                base6[s, v, c] = j * 6 + slot * 2
                base3[s, v, c] = j * 3 + slot

    part = HaloPartition(
        owner=owner, owned_slot=owned_slot, owned_ids=owned_ids, tri_ids=tri_ids,
        tri_corners=tri_corners, dof_local=dof_local, base6=base6, base3=base3,
        send_idx=send_idx, halo_src=halo_src, asm_w=asm_w, n_shards=int(n_shards),
        v_owned=vo, v_halo=vh, m_local=ml, b_send=b, n_triangles=m,
        key=f"{key[0]}/{key[1]}")
    return _remember(_PARTITION_CACHE, key, part)


def owned_to_global(part: HaloPartition, x_stacked: torch.Tensor,
                    n_vertices: int) -> torch.Tensor:
    """(T, S * 2 Vo) stacked owned vectors -> global (T, 2N) DOF layout."""
    t = x_stacked.shape[0]
    x3 = x_stacked.reshape(t, part.n_shards, 2, part.v_owned)
    sh = torch.as_tensor(part.owner, dtype=torch.long, device=x_stacked.device)
    sl = torch.as_tensor(part.owned_slot, dtype=torch.long, device=x_stacked.device)
    return torch.cat([x3[:, sh, 0, sl], x3[:, sh, 1, sl]], dim=-1)


def global_to_owned(part: HaloPartition, x: torch.Tensor) -> torch.Tensor:
    """Global (T, 2N) -> stacked owned (T, S, 2 Vo) (pads read zero)."""
    t = x.shape[0]
    n = part.owner.shape[0]
    xp = torch.cat([x, x.new_zeros((t, 1))], dim=1)
    ids = torch.as_tensor(part.owned_ids, dtype=torch.long, device=x.device)
    idx1 = torch.where(ids < n, ids, 2 * n)
    idx2 = torch.where(ids < n, ids + n, 2 * n)
    return torch.stack([xp[:, idx1], xp[:, idx2]], dim=2).reshape(
        t, part.n_shards, 2 * part.v_owned)


# --------------------------------------------------------------------------
# One shard's local block
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LocalBlock:
    """Shard `shard`'s local layout, host numpy (see the module docstring).

      vertex_ids   (Vl,)       global vertex per local slot (N on pads)
      tri_ids      (Ml_s,)     the shard's triangles (global ids)
      triangles    (Ml_s, 3)   their corners as local slots
      dof          (Ml_s, 6)   their local DOF ids
      gather_base  (Vl, C)     K1/K2/K4 vertex table over the local
                               triangles; halo and pad rows all padding
      owned_rows   (Vl,)       the owned slots: the shard's first n_owned
      asm          (Ml_s,)     the shard owns the triangle for assembly
      send_idx     (B,)        owned slots it publishes
      halo_src     (Vh,)       buffer position per halo slot (pad S*B)
    """

    shard: int
    vertex_ids: np.ndarray
    tri_ids: np.ndarray
    triangles: np.ndarray
    dof: np.ndarray
    gather_base: np.ndarray
    owned_rows: np.ndarray
    asm: np.ndarray
    send_idx: np.ndarray
    halo_src: np.ndarray


_BLOCK_CACHE: dict = {}


def local_block(part: HaloPartition, shard: int) -> LocalBlock:
    """Shard `shard`'s `LocalBlock`, from the partition tables (cached)."""
    key = (part.key, int(shard))
    hit = _BLOCK_CACHE.get(key)
    if hit is not None:
        return hit
    s = int(shard)
    n = part.owner.shape[0]
    owned = part.owned_ids[s].astype(np.int64)
    n_owned = int((owned < n).sum())
    # Halo slot j holds the vertex published at flat buffer position
    # halo_src[j] = shard * B + pos.
    b = part.b_send
    src = part.halo_src[s].astype(np.int64)
    real = src < part.n_shards * b
    halo = np.full(src.shape, n, dtype=np.int64)
    sh, pos = src[real] // b, src[real] % b
    halo[real] = part.owned_ids[sh, part.send_idx[sh, pos]]
    tl = part.tri_ids[s].astype(np.int64)
    m_s = int((tl < part.n_triangles).sum())
    dof = part.dof_local[s, :m_s]
    base = part.base6[s].astype(np.int64)
    base = np.where(base < 6 * m_s, base, 6 * m_s)
    gather = np.concatenate(
        [base, np.full((part.v_halo, base.shape[1]), 6 * m_s, dtype=np.int64)])
    block = LocalBlock(
        shard=s, vertex_ids=np.concatenate([owned, halo]),
        tri_ids=tl[:m_s], triangles=np.ascontiguousarray(dof[:, 0::2]),
        dof=np.ascontiguousarray(dof), gather_base=gather.astype(np.int32),
        owned_rows=np.arange(part.v_local) < n_owned, asm=part.asm_w[s, :m_s] > 0,
        send_idx=part.send_idx[s].astype(np.int64), halo_src=src)
    return _remember(_BLOCK_CACHE, key, block)


@dataclasses.dataclass(frozen=True)
class LocalGeometry:
    """One shard's triangle geometry and tables, as tensors on the mesh's
    device in one dtype."""

    triangles: torch.Tensor     # (Ml_s, 3) int32 local corners
    dof: torch.Tensor           # (Ml_s, 6) int32
    grad_w: torch.Tensor        # (Ml_s, 3, 3)
    areas: torch.Tensor         # (Ml_s,)
    basis: torch.Tensor         # (Vl, 2, 3), zero on pads
    blocks2: torch.Tensor       # (Ml_s, 6, 6) a2 blocks
    reg: torch.Tensor           # (Ml_s, 3, 2, 2) K2's regularization part
    gather_base: torch.Tensor   # (Vl, C) int32
    tiles: assembly.CellTiles   # K1's and K4's index tables
    owned_rows: torch.Tensor    # (Vl,) bool
    send_idx: torch.Tensor      # (B,) long
    halo_src: torch.Tensor      # (Vh,) long


def _local_geometry(mesh: TriMesh, part: HaloPartition, block: LocalBlock,
                    dtype: torch.dtype) -> LocalGeometry:
    """The shard's geometry gathered once from the mesh's tensors, in
    `dtype` (cached per mesh, partition, shard and dtype). The a2 blocks and
    K2's regularization part are the single-device ones' rows."""
    def build():
        dev = mesh.device
        tri = torch.as_tensor(block.tri_ids, dtype=torch.long, device=dev)
        vids = torch.as_tensor(block.vertex_ids, dtype=torch.long, device=dev)
        basis_pad = torch.cat([mesh.basis, mesh.basis.new_zeros((1, 2, 3))])
        gather = torch.as_tensor(block.gather_base, device=dev)
        return LocalGeometry(
            triangles=torch.as_tensor(block.triangles, dtype=torch.int32, device=dev),
            dof=torch.as_tensor(block.dof, dtype=torch.int32, device=dev),
            grad_w=mesh.grad_w[tri].to(dtype).contiguous(),
            areas=mesh.areas[tri].to(dtype).contiguous(),
            basis=basis_pad[vids].to(dtype).contiguous(),
            blocks2=assembly.a2_blocks(mesh)[tri].to(dtype).contiguous(),
            reg=assembly.corner_regularization(mesh, dtype)[tri].contiguous(),
            gather_base=gather,
            tiles=assembly.cell_tiles(gather, len(block.tri_ids)),
            owned_rows=torch.as_tensor(block.owned_rows, device=dev),
            send_idx=torch.as_tensor(block.send_idx, device=dev),
            halo_src=torch.as_tensor(block.halo_src, device=dev))

    return mesh_cached((mesh.points, mesh.triangles, mesh.basis, mesh.grad_w, mesh.areas),
                       ("halo_geometry", part.key, block.shard, dtype), build)


# --------------------------------------------------------------------------
# Shard-local operator
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HaloOperator:
    """A = a1 + lambda a2 on one vertex block, with halo exchange.

    `local` is the block's FlowOperator (K1's tables over the local
    triangles); vectors are (T, 2 Vl) in the local layout. `matvec` and
    `residual` fill the halo rows of x in place (`exchange`) and run K1.
    """

    local: FlowOperator
    send_idx: torch.Tensor   # (B,) owned slots published
    halo_src: torch.Tensor   # (Vh,) buffer position per halo slot
    v_owned: int
    v_halo: int
    comm: AxisComm

    @property
    def g(self) -> torch.Tensor:
        return self.local.g

    @property
    def lambda_(self) -> float:
        return self.local.lambda_

    def astype(self, dtype: torch.dtype) -> "HaloOperator":
        return dataclasses.replace(self, local=self.local.astype(dtype))

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        """Fill the halo rows of x (T, 2 Vl) in place with the owners'
        values, and return x: the owned boundary rows (T, 2, B) are
        all-gathered over the mesh axis, (S, T, 2, B), and each halo slot
        takes its position of that buffer (padding slots take 0)."""
        t = x.shape[0]
        vo, vl = self.v_owned, self.v_owned + self.v_halo
        xs = x.view(t, 2, vl)
        buf = self.comm.all_gather(xs.index_select(2, self.send_idx))
        buf = buf.permute(1, 2, 0, 3).reshape(t, 2, -1)
        buf = torch.cat([buf, buf.new_zeros((t, 2, 1))], dim=2)
        xs[:, :, vo:] = buf.index_select(2, self.halo_src)
        return x

    def local_contributions(self, x_full: torch.Tensor) -> torch.Tensor:
        """Per-triangle products (T, Ml_s, 6) of A x on the local block, x
        already exchanged (plain torch)."""
        return self.local.local_contributions(x_full)

    def reduce_owned(self, y_loc: torch.Tensor) -> torch.Tensor:
        """(T, Ml_s, 6) local contributions -> (T, 2 Vl), the owned rows
        summed through the vertex table, zero elsewhere (plain torch)."""
        return assembly.reduce_table(y_loc, self.local.gather_base)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.local.matvec(self.exchange(x))

    def residual(self, f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.local.residual(f, self.exchange(x))


def _halo_operator(geom: LocalGeometry, g: torch.Tensor, lambda_: float,
                   part: HaloPartition, comm: AxisComm) -> HaloOperator:
    local = FlowOperator(
        dof=geom.dof, blocks2=geom.blocks2, g=g.contiguous(),
        w_scale=geom.areas / 12.0, lambda_=float(lambda_),
        gather_base=geom.gather_base,
        tiles=assembly.vertex_tiles(geom.gather_base, geom.dof, geom.blocks2,
                                    index=geom.tiles))
    return HaloOperator(local=local, send_idx=geom.send_idx, halo_src=geom.halo_src,
                        v_owned=part.v_owned, v_halo=part.v_halo, comm=comm)


def _local_factors(geom: LocalGeometry, potentials: torch.Tensor, times: torch.Tensor,
                   vertex_ids: np.ndarray, tl: int):
    """The shard's a1 factors g (tl, Ml_s, 3, 2) and RHS f (tl, 2 Vl) from
    the rank's (n + 1, N) slice of the movie: K4 on the local block (the
    JAX `_local_factors` and `_rhs_owned` in one pass), zero frames past
    the movie's end. f is zero off the owned rows."""
    n = potentials.shape[0] - 1
    vl = len(vertex_ids)
    if n > 0:
        ids = torch.as_tensor(vertex_ids, dtype=torch.long, device=potentials.device)
        pot = torch.cat([potentials, potentials.new_zeros((n + 1, 1))], dim=1)[:, ids]
        pot = pot.contiguous()
        g, f = kfem.frame_factors_rhs(pot, pot, times.contiguous(), geom.triangles,
                                      geom.grad_w, geom.basis, geom.areas,
                                      geom.gather_base, geom.tiles)
    else:
        g = potentials.new_zeros((0, geom.triangles.shape[0], 3, 2))
        f = potentials.new_zeros((0, 2 * vl))
    return pad_frames(g, tl).contiguous(), pad_frames(f, tl).contiguous()


def _diag_owned(geom: LocalGeometry, g: torch.Tensor, lambda_: float) -> torch.Tensor:
    """Inverted Jacobi blocks (T, Vl, 2, 2) of the owned rows (K2 on the
    local block), zero on the halo and pad rows."""
    dinv = kfem.jacobi_blocks(g.contiguous(), geom.reg, geom.areas, lambda_,
                              geom.gather_base)
    return torch.where(geom.owned_rows[None, :, None, None], dinv,
                       torch.zeros_like(dinv))


# --------------------------------------------------------------------------
# Two-level preconditioner under the halo partition
# --------------------------------------------------------------------------
_COARSE_CACHE: dict = {}


def _coarse_partition_tables(mesh: TriMesh, part: HaloPartition, tables):
    """Owned-member restriction tables (members (S, Nc, Kl), owned slots
    with sentinel Vo; agg_owned (S, Vo)), on the host, cached: the JAX
    `_coarse_partition_tables` without its reduce plans (K8 assembles
    instead, `_coarse_assembly`)."""
    agg = _host(tables.agg).astype(np.int64)
    key = (_content_key(_host(mesh.triangles), agg), part.key)
    hit = _COARSE_CACHE.get(key)
    if hit is not None:
        return hit
    nc = int(tables.n_coarse)
    n = part.owner.shape[0]
    kl = 1
    members_list = []
    for s in range(part.n_shards):
        verts = np.where(part.owner == s)[0]                 # ascending
        order = np.argsort(agg[verts], kind="stable")
        counts = np.bincount(agg[verts], minlength=nc)
        kl = max(kl, int(counts.max(initial=1)))
        members_list.append((part.owned_slot[verts[order]], counts))
    members = np.full((part.n_shards, nc, kl), part.v_owned, dtype=np.int32)
    for s, (slots, counts) in enumerate(members_list):
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        col = np.arange(slots.size) - np.repeat(start, counts)
        members[s, np.repeat(np.arange(nc), counts), col] = slots
    agg_pad = np.concatenate([agg, [0]]).astype(np.int32)
    agg_owned = agg_pad[np.minimum(part.owned_ids.astype(np.int64), n)]
    return _remember(_COARSE_CACHE, key, (members, agg_owned))


@dataclasses.dataclass(frozen=True)
class _CoarseLocal:
    """One shard's two-level tables, on the mesh's device."""

    agg: torch.Tensor        # (Vl,) int32 aggregate per local slot (0 on pads)
    members: torch.Tensor    # (Nc, Kl) int32 owned slots, sentinel Vl (K9's)
    asm_ids: torch.Tensor    # (A,) long the shard's assembly triangles
    triangles: torch.Tensor  # (A, 3) int32 their local corners
    asm_ptr: torch.Tensor    # K8's CSR over those triangles
    asm_src: torch.Tensor
    asm_dst: torch.Tensor


def _coarse_local(mesh: TriMesh, part: HaloPartition, block: LocalBlock,
                  tables) -> _CoarseLocal:
    def build():
        dev = mesh.device
        members, _ = _coarse_partition_tables(mesh, part, tables)
        mem = members[block.shard].astype(np.int64)
        mem = np.where(mem == part.v_owned, part.v_local, mem)
        agg = np.concatenate([_host(tables.agg), [0]]).astype(np.int32)
        agg_l = agg[np.minimum(block.vertex_ids, part.owner.shape[0])]
        asm = np.where(block.asm)[0]
        tri = block.triangles[asm]
        ptr, src, dst = coarse.assembly_csr(tri, agg_l, tables.n_coarse)

        def put(a, dtype=torch.int32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

        return _CoarseLocal(agg=put(agg_l), members=put(mem), asm_ids=put(asm, torch.long),
                            triangles=put(tri), asm_ptr=put(ptr), asm_src=put(src),
                            asm_dst=put(dst))

    return mesh_cached((mesh.points, mesh.triangles, tables.agg),
                       ("halo_coarse", part.key, block.shard), build)


def _coarse_inverse_local(tables, geom: LocalGeometry, cl: _CoarseLocal,
                          g: torch.Tensor, lambda_: float, r_blk: torch.Tensor,
                          comm: AxisComm):
    """(ac_inv (T, 2Nc, 2Nc), zeroed (T,)): K8 over this shard's assembly
    triangles, the matrices all-reduced over the mesh axis, then the ridge
    and the single-device inverse (solve.coarse.invert_coarse)."""
    nc2 = 2 * tables.n_coarse
    if cl.asm_ids.numel():
        ids = cl.asm_ids
        ac = kcoarse.coarse_assemble(
            g[:, ids].contiguous(), geom.blocks2[ids].contiguous(), r_blk, cl.triangles,
            (geom.areas[ids] / 12.0).contiguous(), lambda_, cl.asm_ptr, cl.asm_src,
            cl.asm_dst, tables.n_coarse)
    else:
        ac = g.new_zeros((g.shape[0], nc2, nc2))
    comm.all_reduce_(ac)
    return coarse.invert_coarse(coarse.add_ridge(ac))


def _halo_two_level(mesh: TriMesh, part: HaloPartition, block: LocalBlock,
                    geom: LocalGeometry, tables, g: torch.Tensor, lambda_: float,
                    comm: AxisComm) -> coarse.TwoLevelPrecond:
    """The two-level preconditioner on the shard's rows (the JAX
    `HaloTwoLevel`): Jacobi blocks of the owned rows, prolongation blocks
    at every local vertex (K8 reads the halo corners' too; K11's z on halo
    rows is never read), members of the owned rows."""
    cl = _coarse_local(mesh, part, block, tables)
    r_blk = coarse.prolongation_blocks(mesh, tables, g.dtype)
    r_blk = torch.cat([r_blk, r_blk.new_zeros((1, 2, 2))])[
        torch.as_tensor(block.vertex_ids, dtype=torch.long, device=mesh.device)].contiguous()
    ac_inv, zeroed = _coarse_inverse_local(tables, geom, cl, g, lambda_, r_blk, comm)
    return coarse.TwoLevelPrecond(
        diag=_diag_owned(geom, g, lambda_), r_blk=r_blk, agg=cl.agg,
        members=cl.members, ac_inv=ac_inv.contiguous(), n_coarse=tables.n_coarse,
        zeroed=zeroed)


# --------------------------------------------------------------------------
# The solves
# --------------------------------------------------------------------------
def _setup(mesh: TriMesh, potentials, times, device_mesh: DeviceMesh, dtype_of_geom,
           method: str):
    potentials, times = check_movie(mesh, potentials, times, method)
    nf, nm = device_mesh.shape["frames"], device_mesh.shape["mesh"]
    fi, mi = device_mesh.coordinate
    part = build_partition(mesh, nm)
    block = local_block(part, mi)
    t = potentials.shape[0] - 1
    lo, hi, tl = frame_block(t, nf, fi)
    geom = _local_geometry(mesh, part, block, dtype_of_geom or potentials.dtype)
    g, f = _local_factors(geom, potentials[lo: hi + 1], times[lo: hi + 1],
                          block.vertex_ids, tl)
    return part, block, geom, g, f, t


def _gather_result(part: HaloPartition, device_mesh: DeviceMesh, mesh: TriMesh,
                   x, iterations: int, residual, converged, zeroed: int, t: int):
    """The global VelocityResult from each rank's local rows: the owned rows
    gathered over 'mesh' into the global layout, then the frame blocks over
    'frames'."""
    tl = x.shape[0]
    vo = part.v_owned
    owned = x.view(tl, 2, part.v_local)[:, :, :vo].reshape(tl, 2 * vo)
    stack = device_mesh.comm("mesh").all_gather(owned)            # (S, tl, 2Vo)
    x_glob = owned_to_global(part, stack.permute(1, 0, 2).reshape(tl, -1),
                             mesh.n_vertices)
    fc = device_mesh.comm("frames")
    return VelocityResult(
        v_k=gather_frames(fc, x_glob, t), e=mesh.basis,
        iterations=fc.max_int(iterations), residual=gather_frames(fc, residual, t),
        converged=gather_frames(fc, converged, t), coarse_zeroed=fc.sum_int(zeroed))


def halo_compute_velocity_fields(
    mesh: TriMesh,
    potentials,
    times,
    device_mesh: DeviceMesh,
    lambda_: float = 0.01,
    tol: float = 1e-10,
    max_iter: int = 2000,
    precond: str = "auto",
) -> VelocityResult:
    """Mesh-memory-sharded batched PCG velocity solve, in the movie's dtype.

    Frames split over 'frames'; the DOF space splits over 'mesh' in owned
    vertex blocks. Per iteration: one halo all-gather of boundary values,
    K1 on the local block, K3 on the local rows with all-reduced dots, and
    under two-level K9-K11 with the restriction and r.z all-reduced.

    precond: 'jacobi', 'two_level' (coarse matrices from K8 over each
    shard's assembly triangles, all-reduced), or 'auto' (two_level from
    solve.api.TWO_LEVEL_MIN_VERTICES vertices up). Returns a
    VelocityResult in the global DOF layout on every rank.
    """
    precond = resolve_precond(mesh, precond)
    comm = device_mesh.comm("mesh")
    part, block, geom, g, f, t = _setup(mesh, potentials, times, device_mesh, None, "cg")
    op = _halo_operator(geom, g, lambda_, part, comm)
    if precond == "two_level":
        pre = _halo_two_level(mesh, part, block, geom, coarse.build_tables(mesh), g,
                              lambda_, comm)
        zeroed = int(pre.zeroed.sum())
    else:
        pre, zeroed = _diag_owned(geom, g, lambda_), 0
    res = solve_cg(op, f, pre, tol=tol, max_iter=max_iter, comm=comm)
    return _gather_result(part, device_mesh, mesh, res.x, res.iterations, res.residual,
                          res.converged, zeroed, t)


def halo_refined_velocity_fields(
    mesh: TriMesh,
    potentials,
    times,
    device_mesh: DeviceMesh,
    lambda_: float = 0.01,
    tol: float = 1e-8,
    inner_tol=None,
    max_iter: int = 2000,
    refine_steps: int = 8,
    precond: str = "auto",
) -> VelocityResult:
    """Mesh-memory-sharded refined solve (solve.refine semantics on sharded
    DOF blocks): f32 inner halo PCG, then the f64 residual f - A x on K1
    `<double>` after a float64 exchange, with all-reduced norms. Needs
    float64 potentials."""
    precond = resolve_precond(mesh, precond)
    comm = device_mesh.comm("mesh")
    part, block, geom, g, f, t = _setup(mesh, potentials, times, device_mesh,
                                        torch.float64, "refined")
    op64 = _halo_operator(geom, g, lambda_, part, comm)
    tables = coarse.build_tables(mesh) if precond == "two_level" else None
    geom32 = _local_geometry(mesh, part, block, torch.float32)

    def precond_fn(op32):
        if tables is None:
            return _diag_owned(geom32, op32.g, op32.lambda_), 0
        pre = _halo_two_level(mesh, part, block, geom32, tables, op32.g, op32.lambda_,
                              comm)
        return pre, int(pre.zeroed.sum())

    res = refine_loop(mesh, op64, f, tol=tol,
                      inner_tol=DEFAULT_INNER_TOL if inner_tol is None else inner_tol,
                      max_iter=max_iter, refine_steps=refine_steps, comm=comm,
                      precond_fn=precond_fn)
    return _gather_result(part, device_mesh, mesh, res.x, res.iterations, res.residual,
                          res.converged, res.coarse_zeroed, t)
