"""Triangle-batched FEM assembly for the manifold optical-flow system.

Counterpart of manifold_flow_tpu/fem/assembly.py, in plain torch. System per
frame k (reference equations 15/16/17, utils/compute_optical_flow.py:260,
275, 290):

    (a1_k + lambda * a2) V_k = f_k,   V_k in R^{2N}

with DOF layout dof = vertex + N * alpha (alpha in {0, 1} the tangent
component), and local DOF order l = corner * 2 + alpha within a triangle.

These functions are the plain versions the tests hold against the JAX
package. On the solve's main path the per-frame pieces go through the CUDA
kernels of `kernels.fem` instead (frame factors and RHS, the reduction, the
block-Jacobi build); only the frame-independent tables (`a2_blocks`,
`corner_regularization`, `gather_base_table`, K1's and K4's `cell_tiles`,
K1's `vertex_tiles`) are built here on every device.
The dense blocks and matrices (`a1_blocks`, `scatter_dense`, `dense_a2`)
serve the direct solver (solve.cholesky) on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from manifold_flow_tpu_torch.geometry.mesh import TriMesh, mesh_cached


def local_dof_indices(mesh: TriMesh) -> torch.Tensor:
    """Global DOF ids (M, 6) int32 for local DOFs l = corner * 2 + alpha."""
    alpha = torch.arange(2, dtype=torch.int32, device=mesh.device)
    dof = mesh.triangles[:, :, None] + mesh.n_vertices * alpha
    return dof.reshape(mesh.n_triangles, 6)


def corner_bases(mesh: TriMesh) -> torch.Tensor:
    """Tangent bases gathered at triangle corners: (M, 3, 2, 3)."""
    return mesh.basis[mesh.triangles.long()]


def a2_blocks(mesh: TriMesh) -> torch.Tensor:
    """Per-triangle regularization blocks (M, 6, 6)."""
    et = corner_bases(mesh)
    gg = torch.einsum("mid,mjd->mij", mesh.grad_w, mesh.grad_w)
    ee = torch.einsum("miad,mjbd->miajb", et, et)
    blocks = ee * gg[:, :, None, :, None] * mesh.areas[:, None, None, None, None]
    return blocks.reshape(mesh.n_triangles, 6, 6)


def frame_factors(mesh: TriMesh, potentials: torch.Tensor) -> torch.Tensor:
    """Per-frame a1 factors g = (grad_M I . e) : (T, M, 3, 2) from (T, N)."""
    i_tri = potentials[..., mesh.triangles.long()]                 # (T, M, 3)
    grad_m = torch.einsum("tmc,mcd->tmd", i_tri, mesh.grad_w)      # (T, M, 3)
    return torch.einsum("tmd,mcad->tmca", grad_m, corner_bases(mesh))


def gather_base_table(mesh: TriMesh) -> torch.Tensor:
    """Vertex -> flat (cell*6 + slot*2) local-DOF table (N, C) int32.

    Padded entries (vertex_cells < 0) hold 6M, the index of a zero slot
    appended after the local contributions; the CUDA kernels skip them.
    """
    pad = mesh.vertex_cells < 0
    base = mesh.vertex_cells * 6 + mesh.vertex_cell_slot * 2
    return torch.where(pad, 6 * mesh.n_triangles, base).to(torch.int32)


TILE_VERTICES = 256  # K1's vertices a tile (one block of kernels.fem)
UPPER = [l * 6 + j for l in range(6) for j in range(l, 6)]  # a 6x6 block's upper triangle


class CellTiles(NamedTuple):
    """The vertices cut into tiles of `size` consecutive ids, and the cells
    each tile needs: K1's and K4's index tables.

      size       int          vertices a tile (the last tile may hold fewer)
      cell_ptr   (K + 1,)     int32  tile k's cells are cells[cell_ptr[k]:cell_ptr[k+1]]
      cells      (L,)         int32  the cells incident to any vertex of the
                              tile, halo cells included, ascending in a tile
      gather     (N, C)       int32  gather_base rewritten to tile-local
                              cells: local_cell*6 + slot*2, -1 where padded
      max_cells  int          the most cells of any tile
      own_ptr    (K + 1,)     int32  tile k owns owned[own_ptr[k]:own_ptr[k+1]]
      owned      (M,)         int32  each tile's owned cells as indices into
                              its own cells, ascending: a cell is owned by
                              the first tile that lists it, so every cell
                              by exactly one (K4 writes each cell's g once)
    """

    size: int
    cell_ptr: torch.Tensor
    cells: torch.Tensor
    gather: torch.Tensor
    max_cells: int
    own_ptr: torch.Tensor
    owned: torch.Tensor


def cell_tiles(gather_base: torch.Tensor, n_triangles: int,
               size: int = TILE_VERTICES) -> CellTiles:
    """`CellTiles` from the vertex table `gather_base` (N, C) of a mesh of
    `n_triangles` cells, built on the host and placed on gather_base's
    device.

    Each gather row keeps its column order, so a vertex's sum runs over its
    cells in the order of `reduce_table`; a padded entry (6M) becomes -1.
    Raises ValueError when some cell is listed by no tile (a cell no
    vertex's row names), since no tile would write its g.
    """
    base = gather_base.cpu().numpy().astype(np.int64)
    n, c = base.shape
    valid = (base >= 0) & (base < 6 * n_triangles)
    tile = np.broadcast_to((np.arange(n) // size)[:, None], (n, c))
    key = tile * n_triangles + base // 6            # (tile, cell), sorted by tile
    uniq = np.unique(key[valid])
    n_tiles = -(-n // size)
    ptr = np.searchsorted(uniq, np.arange(n_tiles + 1) * n_triangles)
    local = np.searchsorted(uniq, key) - ptr[tile]
    gather = np.where(valid, local * 6 + base % 6, -1)
    cells = uniq % max(n_triangles, 1)
    # uniq is sorted by tile, so a cell's first entry is its first tile's.
    listed, first = np.unique(cells, return_index=True)
    if listed.size != n_triangles:
        raise ValueError(f"{n_triangles - listed.size} of {n_triangles} cells are "
                         "incident to no vertex of gather_base")
    first = np.sort(first)
    own_tile = np.searchsorted(ptr, first, side="right") - 1
    own_ptr = np.searchsorted(own_tile, np.arange(n_tiles + 1))
    dev = gather_base.device

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x).astype(np.int32)).to(dev)
    return CellTiles(
        size=size, cell_ptr=put(ptr), cells=put(cells), gather=put(gather),
        max_cells=int(np.diff(ptr).max(initial=0)), own_ptr=put(own_ptr),
        owned=put(first - ptr[own_tile]))


def mesh_cell_tiles(mesh: TriMesh) -> CellTiles:
    """`cell_tiles` of the mesh's vertex table, cached per mesh: K4 reads it
    before any operator exists, and the operator's K1 tables share it."""
    return mesh_cached((mesh.vertex_cells, mesh.vertex_cell_slot), ("cell_tiles",),
                       lambda: cell_tiles(gather_base_table(mesh), mesh.n_triangles))


class VertexTiles(NamedTuple):
    """K1's tables: `CellTiles`' index tables (size, cell_ptr, cells,
    gather, max_cells) and the cells' data.

      cell_dof  (6, L)       int32  dof[cells], local DOF first
      blocks2   (21, L)      the a2 blocks of `cells`, their 21 entries on
                             and above the diagonal (row by row) first, in
                             the operator's dtype

    cell_dof and blocks2 list the tiles' cells in table order with the
    local index first, so the kernel's threads, one a cell, read
    consecutive addresses whatever the mesh's triangle order. An a2 block
    is symmetric, exactly as `a2_blocks` computes it (each factor is a
    product of one vector with another in one order), so its upper
    triangle holds every entry.
    """

    size: int
    cell_ptr: torch.Tensor
    cells: torch.Tensor
    gather: torch.Tensor
    cell_dof: torch.Tensor
    blocks2: torch.Tensor
    max_cells: int


def vertex_tiles(gather_base: torch.Tensor, dof: torch.Tensor,
                 blocks2: torch.Tensor, size: int = TILE_VERTICES,
                 index: CellTiles | None = None) -> VertexTiles:
    """K1's tile tables (`VertexTiles`) from the vertex table `gather_base`
    (N, C), the DOF table `dof` (M, 6) and the a2 blocks (M, 6, 6); the
    index tables are `index` where given (`cell_tiles` of the same table
    and size), else built on the host."""
    n_triangles = dof.shape[0]
    if index is None:
        index = cell_tiles(gather_base, n_triangles, size)
    cells = index.cells.long()
    return VertexTiles(
        size=index.size, cell_ptr=index.cell_ptr, cells=index.cells,
        gather=index.gather, cell_dof=dof[cells].t().contiguous(),
        blocks2=blocks2.reshape(n_triangles, 36)[cells][:, UPPER].t().contiguous(),
        max_cells=index.max_cells)


def reduce_table(y_loc: torch.Tensor, gather_base: torch.Tensor) -> torch.Tensor:
    """Reduce local contributions (T, M, 6) -> (T, 2N) through the table."""
    t = y_loc.shape[0]
    y_flat = torch.cat([y_loc.reshape(t, -1),
                        y_loc.new_zeros((t, 2))], dim=1)
    base = gather_base.long()
    c0 = y_flat[:, base]                                           # (T, N, C)
    c1 = y_flat[:, base + 1]
    return torch.cat([c0.sum(-1), c1.sum(-1)], dim=-1)


def reduce_local(mesh: TriMesh, y_loc: torch.Tensor) -> torch.Tensor:
    """Reduce per-triangle local DOF contributions (T, M, 6) -> (T, 2N)."""
    return reduce_table(y_loc, gather_base_table(mesh))


def rhs_vector(mesh: TriMesh, g: torch.Tensor, dI: torch.Tensor) -> torch.Tensor:
    """RHS f (T, 2N) from factors g (T, M, 3, 2) and dI = (I_{k+1}-I_k)/dt (T, N)."""
    di_tri = dI[..., mesh.triangles.long()]                        # (T, M, 3)
    s = torch.sum(di_tri, dim=-1, keepdim=True)
    scale = (di_tri + s) * (mesh.areas / 12.0)[:, None]
    f_loc = g * scale[..., None]
    return reduce_local(mesh, f_loc.reshape(f_loc.shape[0], -1, 6))


def a1_blocks(mesh: TriMesh, g: torch.Tensor) -> torch.Tensor:
    """Dense per-frame data blocks (T, M, 6, 6): g_i^a g_j^b (A/12)(1 + delta_ij).

    As in the JAX package, the weights take the mesh's areas as they are, so
    the blocks come out in the promoted dtype of g and the mesh.
    """
    eye = torch.eye(3, dtype=g.dtype, device=g.device)
    w = (torch.ones_like(eye) + eye) * (mesh.areas[:, None, None] / 12.0)
    gw = g.to(w.dtype)
    blocks = torch.einsum("tmia,tmjb,mij->tmiajb", gw, gw, w)
    return blocks.reshape(g.shape[0], g.shape[1], 6, 6)


def scatter_dense(mesh: TriMesh, blocks: torch.Tensor) -> torch.Tensor:
    """Sum per-triangle blocks (..., M, 6, 6) into dense (..., 2N, 2N)."""
    dof = local_dof_indices(mesh).long()
    nd = mesh.n_dof
    flat_idx = (dof[:, :, None] * nd + dof[:, None, :]).reshape(-1)
    lead = blocks.shape[:-3]
    out = blocks.new_zeros((*lead, nd * nd))
    out.index_add_(-1, flat_idx, blocks.reshape(*lead, -1))
    return out.reshape(*lead, nd, nd)


def dense_a2(mesh: TriMesh) -> torch.Tensor:
    """Dense (2N, 2N) regularization matrix (the direct solver's)."""
    return scatter_dense(mesh, a2_blocks(mesh))


def corner_regularization(mesh: TriMesh, dtype: torch.dtype) -> torch.Tensor:
    """Frame-independent diagonal part (M, 3, 2, 2): (e_c^a . e_c^b)|grad_c|^2 A.

    Cast as the JAX package's `diag_contributions` casts it: bases and areas
    go to `dtype` first, |grad|^2 is taken in the mesh dtype and then cast.
    Written as products and sums, not a matmul, so no TF32 path applies.
    """
    et = corner_bases(mesh).to(dtype)                              # (M, 3, 2, 3)
    areas = mesh.areas.to(dtype)
    ee = torch.sum(et[:, :, :, None, :] * et[:, :, None, :, :], dim=-1)
    gg = torch.sum(mesh.grad_w * mesh.grad_w, dim=-1).to(dtype)    # (M, 3)
    return ee * (gg * areas[:, None])[:, :, None, None]


def corner_data(g: torch.Tensor, areas: torch.Tensor) -> torch.Tensor:
    """Per-frame diagonal part (T, M, 3, 2, 2): g_c^a g_c^b A/6."""
    return (g[..., :, None] * g[..., None, :]) * (areas / 6.0)[:, None, None, None]


def diag_contributions(mesh: TriMesh, g: torch.Tensor,
                       lambda_: float) -> torch.Tensor:
    """Per-triangle per-corner diagonal 2x2 contributions (T, M, 3, 2, 2):
    lambda * (e_c^a . e_c^b)|grad_c|^2 A  +  g_c^a g_c^b A/6, in g's dtype."""
    return (lambda_ * corner_regularization(mesh, g.dtype)[None]
            + corner_data(g, mesh.areas.to(g.dtype)))


def sum_corners(contrib: torch.Tensor, gather_base: torch.Tensor) -> torch.Tensor:
    """Sum per-corner blocks (T, M, 3, 2, 2) into per-vertex blocks
    (T, N, 2, 2) over each vertex's incident corners, in table order.

    The corner of table entry cell*6 + slot*2 is cell*3 + slot; padded
    entries (6M) map to 3M, a zero row appended here.
    """
    t, m = contrib.shape[0], contrib.shape[1]
    flat = torch.cat([contrib.reshape(t, m * 3, 4),
                      contrib.new_zeros((t, 1, 4))], dim=1)
    corner = torch.div(gather_base.long(), 2, rounding_mode="floor")
    return flat[:, corner].sum(dim=2).reshape(t, gather_base.shape[0], 2, 2)


def diag_blocks(mesh: TriMesh, g: torch.Tensor, lambda_: float) -> torch.Tensor:
    """Per-vertex 2x2 diagonal blocks of A = a1 + lambda a2: (T, N, 2, 2)."""
    return sum_corners(diag_contributions(mesh, g, lambda_),
                       gather_base_table(mesh))
