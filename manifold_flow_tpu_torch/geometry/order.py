"""A locality order of a mesh's vertices and cells, and the mesh renumbered
by it.

K1 and K4 (`fem.assembly.cell_tiles`) cut the vertices into tiles of
consecutive ids and list, per tile, every cell incident to one of its
vertices. On a surface whose ids carry no locality (S1's butterfly passes
append edge midpoints in edge order) a tile's vertices lie scattered, and
its list holds about every cell around each of them: 2.3x the cells on S1's
surfaces. The solve therefore runs on a renumbered copy of the mesh
(solve.api), in which each tile is a spatial patch:

  * vertices: recursive coordinate bisection of the points, each split
    along the longest extent of its part and placed at a multiple of the
    tile size, so that every tile is exactly one leaf; a leaf keeps its
    vertices in the mesh's own order;
  * cells: sorted stably by their smallest new vertex id, so that a tile's
    own cells lie together.

Every mesh takes this path; on a mesh of one tile the vertices keep their
ids and only the cells are sorted. Everything runs once per mesh on the
host with numpy.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from manifold_flow_tpu_torch.fem import assembly
from manifold_flow_tpu_torch.geometry.mesh import (
    TriMesh,
    edges_and_boundary,
    mesh_cached,
    vertex_adjacency,
)


@dataclasses.dataclass(frozen=True)
class MeshOrder:
    """A renumbering of a mesh: `*_order` maps new ids to old ones,
    `vertex_rank` old vertex ids to new ones (int64 numpy arrays)."""

    vertex_order: np.ndarray
    vertex_rank: np.ndarray
    cell_order: np.ndarray


def inverse(order: np.ndarray) -> np.ndarray:
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size, dtype=order.dtype)
    return rank


def bisection_order(points: np.ndarray, leaf: int) -> np.ndarray:
    """Vertex ids (new -> old) of a recursive coordinate bisection of
    `points` (N, D) into leaves of `leaf` consecutive ids (the last may hold
    fewer). A part of k leaves splits along its longest extent, with its
    first k // 2 leaves' worth of points (by that coordinate, ties in id
    order) on the left; a leaf lists its points in ascending id."""
    points = np.asarray(points, dtype=np.float64)
    perm = np.arange(points.shape[0], dtype=np.int64)
    parts = [(0, perm.size)]
    while parts:
        lo, hi = parts.pop()
        leaves = -(-(hi - lo) // leaf)
        if leaves <= 1:
            perm[lo:hi].sort()
            continue
        part = perm[lo:hi]
        pts = points[part]
        axis = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        perm[lo:hi] = part[np.argsort(pts[:, axis], kind="stable")]
        mid = lo + (leaves // 2) * leaf
        parts += [(lo, mid), (mid, hi)]
    return perm


def locality_order(points: np.ndarray, triangles: np.ndarray) -> MeshOrder:
    """The `MeshOrder` of a mesh for K1's tiles (`assembly.TILE_VERTICES`):
    vertices by `bisection_order`, cells sorted stably by their smallest new
    vertex id."""
    tris = np.asarray(triangles, dtype=np.int64).reshape(-1, 3)
    vertex_order = bisection_order(points, assembly.TILE_VERTICES)
    vertex_rank = inverse(vertex_order)
    cell_order = np.argsort(vertex_rank[tris].min(axis=1), kind="stable")
    return MeshOrder(vertex_order, vertex_rank, cell_order)


def renumbered(mesh: TriMesh, order: MeshOrder) -> TriMesh:
    """The mesh with its vertices and cells in `order`: every per-vertex and
    per-cell tensor gathered (the same values, bit for bit), the triangles'
    ids renamed with their corners in place, and the topology tables built
    anew from them by `vertex_adjacency` and `edges_and_boundary`, as
    `build_mesh` builds them."""
    dev = mesh.device
    v = torch.from_numpy(order.vertex_order).to(dev)
    c = torch.from_numpy(order.cell_order).to(dev)
    tris = mesh.triangles.cpu().numpy().astype(np.int64)[order.cell_order]
    tris = order.vertex_rank[tris].astype(np.int32)
    n = mesh.n_vertices
    vn, vc, vs, deg, ncell = vertex_adjacency(n, tris)
    edges, edge_cells, boundary = edges_and_boundary(n, tris)

    def put(a):
        return torch.from_numpy(a).to(dev)
    return TriMesh(
        points=mesh.points[v], triangles=put(tris), normals=mesh.normals[v],
        areas=mesh.areas[c], basis=mesh.basis[v], grad_w=mesh.grad_w[c],
        integrals=mesh.integrals[c], vertex_neighbors=put(vn), vertex_cells=put(vc),
        vertex_cell_slot=put(vs), vertex_degree=put(deg), vertex_cell_count=put(ncell),
        boundary_vertex=put(boundary), edges=put(edges), edge_cells=put(edge_cells))


class LocalMesh(NamedTuple):
    """A mesh renumbered for K1's tiles (`local_mesh`).

      mesh      TriMesh     the renumbered mesh
      order     MeshOrder
      vertices  (N,)  int64 new -> old vertex ids on the mesh's device:
                            movie[:, vertices] is a movie in the new order
      dofs      (2N,) int64 old -> new DOF ids (dof = vertex + N * alpha):
                            v[:, dofs] is a new-order field in the old order
    """

    mesh: TriMesh
    order: MeshOrder
    vertices: torch.Tensor
    dofs: torch.Tensor


def local_mesh(mesh: TriMesh) -> LocalMesh:
    """The mesh renumbered by its `locality_order`, built once per mesh
    (`mesh_cached`, pinned on the tensors it reads)."""
    def build():
        order = locality_order(mesh.points.cpu().numpy(), mesh.triangles.cpu().numpy())
        rank = torch.from_numpy(order.vertex_rank).to(mesh.device)
        return LocalMesh(renumbered(mesh, order), order,
                         torch.from_numpy(order.vertex_order).to(mesh.device),
                         torch.cat([rank, rank + mesh.n_vertices]))
    return mesh_cached(
        (mesh.points, mesh.triangles, mesh.normals, mesh.areas, mesh.basis,
         mesh.grad_w, mesh.integrals), ("local_mesh",), build)
