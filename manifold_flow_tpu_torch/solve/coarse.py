"""Two-level preconditioner: block-Jacobi smoother + coarse-grid correction.

Counterpart of manifold_flow_tpu/solve/coarse.py. The systems
(a1_k + lambda a2) are ill-conditioned, and block-Jacobi PCG iteration
counts grow with mesh refinement, so from TWO_LEVEL_MIN_VERTICES up the
solve uses the additive two-level preconditioner

    M^{-1} r = D^{-1} r + P A_c^{-1} P^T r

with a tangent-aware aggregation prolongation P: each aggregate carries one
tangent vector in its seed vertex's basis, and the per-vertex 2x2 blocks of
P are the change-of-basis projections R_v[a, b] = e_v^a . ebar_s^b.

The aggregation runs on the host (numpy, cached per mesh), as in the JAX
package; its tables are equal to JAX's entry for entry. The numeric parts
run on the mesh's device: the coarse matrices through K8 `coarse_assemble`
(B6), their explicit inverses through `torch.linalg` (Cholesky, a
triangular solve against I, Linv^T Linv), and the correction of every PCG
iteration through K9 `coarse_restrict`, K10 `coarse_gemv` and K11
`coarse_prolong_dot` (B7). The JAX package's scatter-free reduce plan and
its pad-aggregate branch (for `pad_mesh`) are TPU workarounds with no
counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from manifold_flow_tpu_torch.fem import assembly
from manifold_flow_tpu_torch.fem.operator import block_jacobi_inverse
from manifold_flow_tpu_torch.geometry.mesh import TriMesh, mesh_cached
from manifold_flow_tpu_torch.geometry.order import MeshOrder
from manifold_flow_tpu_torch.kernels import coarse as kcoarse
from manifold_flow_tpu_torch.kernels import fem as kfem

# 'auto' pass count: keep aggregating until at most this many aggregates, so
# the dense (T, 2Nc, 2Nc) coarse correction stays a bounded read per
# iteration (the JAX package's values).
MAX_COARSE_SIZE = 512
_MAX_PASSES = 8

A1_MODES = ("full", "mean")


def aggregate_vertices(neighbors: np.ndarray, degrees: np.ndarray,
                       passes: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Greedy graph aggregation: (agg (N,) int32, seeds (Nc,) int32).

    Pass 1 sweeps vertices in index order; an unassigned vertex becomes a
    seed and absorbs its unassigned 1-ring. Leftovers join the aggregate of
    their first assigned neighbor (or become singleton seeds on isolated
    components). `passes > 1` re-runs the same procedure on the aggregate
    graph. Deterministic, O(N * max_degree). A copy of the JAX package's.
    """
    n = neighbors.shape[0]
    agg = np.full(n, -1, dtype=np.int64)
    seeds = []
    for v in range(n):
        if agg[v] >= 0:
            continue
        a = len(seeds)
        seeds.append(v)
        agg[v] = a
        for u in neighbors[v, : degrees[v]]:
            if u >= 0 and agg[u] < 0:
                agg[u] = a
    for v in range(n):
        if agg[v] >= 0:
            continue
        placed = False
        for u in neighbors[v, : degrees[v]]:
            if u >= 0 and agg[u] >= 0:
                agg[v] = agg[u]
                placed = True
                break
        if not placed:
            agg[v] = len(seeds)
            seeds.append(v)
    seeds_arr = np.asarray(seeds, dtype=np.int64)

    for _ in range(passes - 1):
        if len(seeds_arr) <= 8:
            break
        agg, seeds_arr = coarsen_once(neighbors, degrees, agg, seeds_arr)
    return agg.astype(np.int32), seeds_arr.astype(np.int32)


def coarsen_once(neighbors: np.ndarray, degrees: np.ndarray, agg: np.ndarray,
                 seeds: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One further pass of `aggregate_vertices`: aggregate the aggregate
    graph of (agg, seeds) and return the composed (agg, seeds)."""
    nc = len(seeds)
    # Aggregate-level adjacency from the fine edges.
    adj: list[set[int]] = [set() for _ in range(nc)]
    for v in range(neighbors.shape[0]):
        av = agg[v]
        for u in neighbors[v, : degrees[v]]:
            if u >= 0 and agg[u] != av:
                adj[av].add(int(agg[u]))
    max_deg = max((len(s) for s in adj), default=1) or 1
    cn = np.full((nc, max_deg), -1, dtype=np.int64)
    cd = np.zeros(nc, dtype=np.int64)
    for i, s in enumerate(adj):
        lst = sorted(s)
        cn[i, : len(lst)] = lst
        cd[i] = len(lst)
    agg2, seed_of_agg = aggregate_vertices(cn, cd, passes=1)
    return agg2[agg], seeds[seed_of_agg]


@dataclasses.dataclass(frozen=True)
class CoarseTables:
    """Host-built integer tables of one mesh, on the mesh's device.

      agg      (N,)        int32  aggregate id per vertex
      seeds    (Nc,)       int32  seed vertex per aggregate (its tangent basis)
      members  (Nc, K)     int32  member vertices per aggregate, ascending,
                                  padded with N (K9's restriction)
      n_coarse int                aggregate count Nc
      asm_ptr  (nnz+1,)    int32  K8's CSR over the non-zero coarse entries:
      asm_src  (36M,)      int32  contributions s = m*36 + l*6 + l2 of each
      asm_dst  (nnz,)      int32  entry, and its flat target row*2Nc + col
                                  (assembly_csr)
    """

    agg: torch.Tensor
    seeds: torch.Tensor
    members: torch.Tensor
    n_coarse: int
    asm_ptr: torch.Tensor
    asm_src: torch.Tensor
    asm_dst: torch.Tensor


def assembly_csr(triangles: np.ndarray, agg: np.ndarray, n_coarse: int):
    """K8's CSR of the triangle-local coarse contributions per coarse entry:
    (ptr (nnz+1,), src (36M,), dst (nnz,)), int32 numpy arrays.

    Contribution s = m*36 + l*6 + l2 (local DOFs l = corner*2 + component)
    lands on the flat entry (2 agg[v_l] + x_l) * 2Nc + (2 agg[v_l2] + x_l2).
    One stable argsort groups the contributions by entry, in ascending s
    within each entry: the fixed order K8 sums them in.
    """
    tris = np.asarray(triangles, dtype=np.int64)
    agg = np.asarray(agg, dtype=np.int64)
    nc2 = 2 * int(n_coarse)
    if nc2 * nc2 > np.iinfo(np.int32).max or 36 * tris.shape[0] > np.iinfo(np.int32).max:
        raise ValueError(f"coarse assembly too large for int32 tables "
                         f"(2Nc={nc2}, M={tris.shape[0]})")
    cdof = (2 * agg[tris][:, :, None] + np.arange(2)).reshape(-1, 6)   # (M, 6)
    flat = (cdof[:, :, None] * nc2 + cdof[:, None, :]).reshape(-1)
    src = np.argsort(flat, kind="stable")
    dst, counts = np.unique(flat[src], return_counts=True)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    ptr, src, dst = ptr.astype(np.int32), src.astype(np.int32), dst.astype(np.int32)
    check_sibling_pairs(ptr, src, dst)
    return ptr, src, dst


def check_sibling_pairs(ptr: np.ndarray, src: np.ndarray, dst: np.ndarray) -> None:
    """Raise ValueError unless K8's CSR lists its entries in sibling pairs.

    Contribution s + 1 is s with its second coarse component y = 1 (l2 odd),
    so every contribution to entry (row, 2b) has one to (row, 2b + 1), and
    the entries follow each other in flat order. K8 relies on that layout:
    entry 2p lists even contributions only, entry 2p + 1 targets the next
    flat slot and lists each of 2p's plus one, in the same order.
    """
    ptr, src, dst = (np.asarray(a, dtype=np.int64) for a in (ptr, src, dst))
    counts = np.diff(ptr)
    if dst.size % 2 or ptr.size != dst.size + 1:
        raise ValueError(f"coarse CSR: {dst.size} entries, not sibling pairs")
    second = np.repeat(np.arange(dst.size) % 2 == 1, counts)
    first_src, second_src = src[: ptr[-1]][~second], src[: ptr[-1]][second]
    if (np.any(counts[0::2] != counts[1::2]) or np.any(dst[1::2] != dst[0::2] + 1)
            or np.any(first_src % 2) or np.any(second_src != first_src + 1)):
        raise ValueError("coarse CSR: an entry has no sibling (row, 2b + 1) "
                         "listing its contributions plus one")


def tables_from_aggregation(mesh: TriMesh, agg: np.ndarray,
                            seeds: np.ndarray) -> CoarseTables:
    """CoarseTables from an aggregation (agg, seeds), on the mesh's device."""
    agg = np.asarray(agg, dtype=np.int32)
    seeds = np.asarray(seeds, dtype=np.int32)
    n, nc = agg.shape[0], int(seeds.shape[0])
    order = np.argsort(agg, kind="stable")
    counts = np.bincount(agg, minlength=nc)
    k = max(int(counts.max()), 1)
    members = np.full((nc, k), n, dtype=np.int32)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    for a in range(nc):
        span = order[offsets[a]: offsets[a + 1]]
        members[a, : span.size] = span
    ptr, src, dst = assembly_csr(mesh.triangles.cpu().numpy(), agg, nc)

    def dev(a):
        return torch.from_numpy(np.array(a)).to(mesh.device)

    return CoarseTables(agg=dev(agg), seeds=dev(seeds), members=dev(members),
                        n_coarse=nc, asm_ptr=dev(ptr), asm_src=dev(src),
                        asm_dst=dev(dst))


def relabelled_tables(mesh: TriMesh, tables: CoarseTables,
                      order: MeshOrder) -> CoarseTables:
    """`tables` of a mesh carried over to `mesh`, the same mesh renumbered
    by `order` (geometry.order): the same aggregates under the same ids,
    each with the same seed, its members under their new ids. Cached per
    mesh and tables (`mesh_cached`). Aggregating the renumbered graph
    instead would give other aggregates (`aggregate_vertices` sweeps in id
    order), and so another preconditioner."""
    def build():
        agg = tables.agg.cpu().numpy()[order.vertex_order]
        return tables_from_aggregation(mesh, agg,
                                       order.vertex_rank[tables.seeds.cpu().numpy()])
    return mesh_cached((mesh.triangles, tables.agg, tables.seeds), ("coarse_tables",),
                       build)


_TABLE_CACHE: dict = {}
_CACHE_SIZE = 8


def build_tables(mesh: TriMesh, passes: int | None = None) -> CoarseTables:
    """Aggregation tables for `mesh`, cached by mesh identity.

    `passes=None` (auto) aggregates until n_coarse <= MAX_COARSE_SIZE, one
    further pass at a time on the previous result (the JAX package restarts
    from pass 1 for each count, with the same tables as the outcome). The
    aggregation is host Python that costs more than a solve, so the tables
    are cached, as in the JAX package: the key is the identity of
    `mesh.vertex_neighbors`, whose tensor the entry pins (so the id cannot
    be recycled), in a FIFO of 8 entries.
    """
    key = (id(mesh.vertex_neighbors), passes)
    entry = _TABLE_CACHE.get(key)
    if entry is not None and entry[0] is mesh.vertex_neighbors:
        return entry[1]
    neighbors = mesh.vertex_neighbors.cpu().numpy()
    degrees = mesh.vertex_degree.cpu().numpy()
    if passes is None:
        agg, seeds = aggregate_vertices(neighbors, degrees, passes=1)
        n_passes = 1
        while seeds.shape[0] > MAX_COARSE_SIZE and n_passes < _MAX_PASSES:
            n_passes += 1
            agg, seeds = coarsen_once(neighbors, degrees, agg, seeds)
    else:
        agg, seeds = aggregate_vertices(neighbors, degrees, passes=passes)
    tables = tables_from_aggregation(mesh, agg, seeds)
    _TABLE_CACHE[key] = (mesh.vertex_neighbors, tables)
    while len(_TABLE_CACHE) > _CACHE_SIZE:
        _TABLE_CACHE.pop(next(iter(_TABLE_CACHE)))
    return tables


@dataclasses.dataclass(frozen=True)
class TwoLevelPrecond:
    """M^{-1} = block-Jacobi + tangent-aware coarse correction.

      diag     (T, N, 2, 2)         inverted per-vertex diagonal blocks
      r_blk    (N, 2, 2)            prolongation blocks R_v[a, b] = e_v^a . ebar^b
      agg      (N,)         int32   aggregate ids (prolongation)
      members  (Nc, K)      int32   member vertices per aggregate (restriction)
      ac_inv   (T|1, 2Nc, 2Nc)      explicit inverses of the coarse matrices
      n_coarse int
      zeroed   (T|1,)       bool    frames whose coarse factorization failed;
                                    their ac_inv is 0 (Jacobi alone)
    """

    diag: torch.Tensor
    r_blk: torch.Tensor
    agg: torch.Tensor
    members: torch.Tensor
    ac_inv: torch.Tensor
    n_coarse: int
    zeroed: torch.Tensor

    def correct(self, r: torch.Tensor, z: torch.Tensor, rz: torch.Tensor,
                precise: bool = False, comm=None) -> None:
        """Add the coarse correction P A_c^{-1} P^T r to z (T, 2N) in place
        and write rz = <r, z> per frame: K9, K10, then K11 (summing r.z in
        float64 with `precise`, as solve_cg's precise_dots asks).

        With `comm` (parallel.comm.AxisComm) the rows are one mesh shard's
        (parallel.halo): K9's partial restriction is all-reduced over the
        axis before K10, and K11's partial r.z after it (the JAX
        `HaloTwoLevel.apply`'s psum)."""
        rc = kcoarse.coarse_restrict(r, self.r_blk, self.members)
        if comm is not None:
            comm.all_reduce_(rc)
        yc = kcoarse.coarse_gemv(self.ac_inv, rc)
        kcoarse.coarse_prolong_dot(z, r, yc, self.r_blk, self.agg, rz, precise)
        if comm is not None:
            comm.all_reduce_(rz)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """Apply M^{-1} to residuals r (T, 2N) -> (T, 2N).

        The Jacobi term is K3 `pcg_update` with a zero step (as the PCG's
        first z is formed), then `correct` adds the coarse term.
        """
        r = r.contiguous()
        zero = r.new_zeros(r.shape[0])
        z = torch.empty_like(r)
        rz, rr = torch.empty_like(zero), torch.empty_like(zero)
        kfem.pcg_update(torch.zeros_like(r), r.clone(), z, torch.zeros_like(r),
                        torch.zeros_like(r), self.diag, zero, zero, rz, rr)
        self.correct(r, z, rz)
        return z


def prolongation_blocks(mesh: TriMesh, tables: CoarseTables,
                        dtype: torch.dtype) -> torch.Tensor:
    """R_v[a, b] = e_v^a . ebar^b (N, 2, 2) in `dtype`, with ebar the basis
    of v's aggregate seed; written as products and sums (no matmul, so no
    TF32 path applies)."""
    basis = mesh.basis.to(dtype)
    ebar = basis[tables.seeds.long()][tables.agg.long()]          # (N, 2, 3)
    return torch.sum(basis[:, :, None, :] * ebar[:, None, :, :], dim=-1)


def check_a1_mode(a1_mode: str) -> None:
    if a1_mode == "none":
        raise ValueError(
            "coarse_a1='none' (regularization-only coarse matrices) is not "
            f"ported: it over-corrects (docs/DESIGN.md); use one of {A1_MODES}")
    if a1_mode not in A1_MODES:
        raise ValueError(f"unknown coarse_a1 {a1_mode!r}; want one of {A1_MODES}")


def coarse_matrices(mesh: TriMesh, g: torch.Tensor, lambda_: float,
                    tables: CoarseTables, a1_mode: str = "full"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """A_c = P^T (a1_k + lambda a2) P + ridge for all frames, (T, 2Nc, 2Nc)
    ('full', exact per frame) or (1, 2Nc, 2Nc) ('mean', the data term
    averaged over frames: one shared matrix), and the prolongation blocks
    r_blk (N, 2, 2); in g's dtype.

    The assembly is K8 `coarse_assemble`; the ridge (1e-6 of each frame's
    largest diagonal entry, which keeps the factorization safe where some
    R_v is nearly singular) is added around it.
    """
    check_a1_mode(a1_mode)
    dtype = g.dtype
    r_blk = prolongation_blocks(mesh, tables, dtype)
    ac = kcoarse.coarse_assemble(
        g.contiguous(), assembly.a2_blocks(mesh).to(dtype).contiguous(), r_blk,
        mesh.triangles, mesh.areas.to(dtype) / 12.0, lambda_, tables.asm_ptr,
        tables.asm_src, tables.asm_dst, tables.n_coarse, mean=a1_mode == "mean")
    return add_ridge(ac), r_blk


def add_ridge(ac: torch.Tensor) -> torch.Tensor:
    """ac plus 1e-6 of each frame's largest |diagonal entry| on its diagonal."""
    scale = torch.amax(torch.abs(torch.diagonal(ac, dim1=-2, dim2=-1)), dim=-1)
    eye = torch.eye(ac.shape[-1], dtype=ac.dtype, device=ac.device)
    return ac + (1e-6 * scale)[:, None, None] * eye


def invert_coarse(ac: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(explicit inverses (T, 2Nc, 2Nc), zeroed (T,) bool) of the coarse
    matrices: Cholesky, a triangular solve against I, then Linv^T Linv. A
    frame whose factorization fails (`cholesky_ex` info, or NaN in the
    factor's inverse, the JAX package's test) gets a zero inverse."""
    chol, info = torch.linalg.cholesky_ex(ac)
    eye = torch.eye(ac.shape[-1], dtype=ac.dtype, device=ac.device).expand_as(ac)
    linv = torch.linalg.solve_triangular(chol, eye, upper=False)
    ac_inv = torch.matmul(linv.mT, linv)
    zeroed = (info != 0) | torch.isnan(linv).any(dim=-1).any(dim=-1)
    ac_inv = torch.where(zeroed[:, None, None], torch.zeros_like(ac_inv), ac_inv)
    return ac_inv, zeroed


def make_two_level(mesh: TriMesh, g: torch.Tensor, lambda_: float,
                   tables: CoarseTables, a1_mode: str = "full") -> TwoLevelPrecond:
    """Build the two-level preconditioner for the operator defined by g.

    The coarse inverse is explicit (`invert_coarse`), so the iteration only
    multiplies. A frame whose factorization fails gets a zero inverse: its
    correction is 0 and PCG runs on the Jacobi term alone, as in JAX.
    """
    diag = block_jacobi_inverse(mesh, g, lambda_)
    ac, r_blk = coarse_matrices(mesh, g, lambda_, tables, a1_mode=a1_mode)
    ac_inv, zeroed = invert_coarse(ac)
    return TwoLevelPrecond(diag=diag, r_blk=r_blk.contiguous(), agg=tables.agg,
                           members=tables.members, ac_inv=ac_inv.contiguous(),
                           n_coarse=tables.n_coarse, zeroed=zeroed)
