"""Topology queries over TriMesh.

Counterpart of manifold_flow_tpu/geometry/topology.py, which replaces the
reference's live PyVista/VTK calls:
  * `surface.find_closest_point`       -> closest_vertex
  * `surface.point_neighbors_levels`   -> bfs_levels
  * `surface.geodesic_distance`        -> geodesic_distance_matrix
  * `surface.find_cells_intersecting_line` on a shared mesh edge
                                       -> other_cell_across_edge, and its
                                          per-mesh table cells_across_edges

The tensor functions take any leading batch shape (the JAX package writes
them for one query and vmaps them). The port has no mesh padding, so
`closest_vertex` takes no valid-vertex count. `edge_graph_csr` and
`geodesic_distance_matrix` run on the host with scipy.
"""

from __future__ import annotations

import numpy as np
import torch

from manifold_flow_tpu_torch.geometry.mesh import PAD_INDEX, TriMesh, mesh_cached


def closest_vertex(points: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Index (int32) of the Euclidean-nearest vertex for each query (..., 3).

    The argmin of sum((q - p)^2), summed (dx^2 + dy^2) + dz^2 with each
    operation separate, as the K7 kernel does; ties go to the lowest index,
    as with jnp.argmin.
    """
    diff = queries[..., None, :] - points
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
          + diff[..., 2] * diff[..., 2])
    return torch.argmin(d2, dim=-1).to(torch.int32)


def bfs_levels(vertex_neighbors: torch.Tensor, source, max_level: int
               ) -> torch.Tensor:
    """Breadth-first ring levels (..., N) int32 from each `source` vertex
    (an int or a tensor of ids (...,)): 0 at the source, k on the k-th
    ring, -1 beyond `max_level`."""
    n = vertex_neighbors.shape[0]
    valid = vertex_neighbors != PAD_INDEX
    neigh = torch.where(valid, vertex_neighbors, 0).long()
    src = torch.as_tensor(source, device=vertex_neighbors.device).long()
    levels = torch.full((*src.shape, n), -1, dtype=torch.int32,
                        device=vertex_neighbors.device)
    levels.scatter_(-1, src[..., None], 0)
    for level in range(1, max_level + 1):
        frontier = levels == level - 1
        reached = (frontier[..., neigh] & valid).any(dim=-1)
        levels = torch.where(reached & (levels < 0), level, levels).to(torch.int32)
    return levels


def edge_lookup(edges: torch.Tensor, va, vb) -> torch.Tensor:
    """Index into the sorted unique-edge table of edge (va, vb), else -1."""
    va, vb = torch.as_tensor(va), torch.as_tensor(vb)
    lo = torch.minimum(va, vb)[..., None]
    hi = torch.maximum(va, vb)[..., None]
    match = (edges[:, 0] == lo) & (edges[:, 1] == hi)
    idx = torch.argmax(match.to(torch.uint8), dim=-1)
    return torch.where(match.any(dim=-1), idx, -1).to(torch.int32)


def other_cell_across_edge(edges: torch.Tensor, edge_cells: torch.Tensor,
                           cell_id, va, vb) -> torch.Tensor:
    """The triangle on the other side of edge (va, vb) from `cell_id`, or -1
    for a boundary or unknown edge: the deterministic form of the
    reference's `set(find_cells_intersecting_line(edge)) - {index}).pop()`
    (utils/find_singularity_point.py:434-437)."""
    eid = edge_lookup(edges, va, vb)
    cells = edge_cells[torch.clamp_min(eid, 0).long()]
    other = torch.where(cells[..., 0] == torch.as_tensor(cell_id),
                        cells[..., 1], cells[..., 0])
    return torch.where(eid < 0, -1, other).to(torch.int32)


def cells_across_edges(mesh: TriMesh) -> torch.Tensor:
    """(M, 3) int32 on the mesh's device: the triangle across edge k of each
    triangle, edges in corner order (0: corners 0-1, 1: 1-2, 2: 2-0, the
    codes of the nearest-edge test), or -1 for a boundary edge.

    Each entry equals `other_cell_across_edge(edges, edge_cells, m,
    tri[m, a], tri[m, b])`; the table is built once per mesh on the host, by
    a binary search of the sorted edge keys instead of that function's scan
    over every edge, and cached per mesh (`mesh_cached`).
    """
    def build():
        tris = mesh.triangles.cpu().numpy().astype(np.int64)
        edges = mesh.edges.cpu().numpy().astype(np.int64)
        edge_cells = mesh.edge_cells.cpu().numpy()
        n = max(mesh.n_vertices, 1)
        va, vb = tris, tris[:, [1, 2, 0]]
        query = np.minimum(va, vb) * n + np.maximum(va, vb)          # (M, 3)
        keys = np.where(edges[:, 0] >= 0, edges[:, 0] * n + edges[:, 1], -1)
        eid = np.clip(np.searchsorted(keys, query), 0, len(keys) - 1)
        found = keys[eid] == query
        cells = edge_cells[eid]                                      # (M, 3, 2)
        own = np.arange(tris.shape[0])[:, None]
        other = np.where(cells[..., 0] == own, cells[..., 1], cells[..., 0])
        table = torch.from_numpy(np.where(found, other, -1).astype(np.int32))
        return table.to(mesh.device)
    return mesh_cached((mesh.triangles, mesh.edges, mesh.edge_cells),
                       ("cells_across_edges",), build)


def edge_graph_csr(mesh: TriMesh):
    """Host-side sparse edge-length graph (scipy CSR) of the mesh."""
    import scipy.sparse as sp

    edges = mesh.edges.cpu().numpy()
    pts = mesh.points.cpu().numpy()
    edges = edges[edges[:, 0] != PAD_INDEX]
    w = np.linalg.norm(pts[edges[:, 0]] - pts[edges[:, 1]], axis=-1)
    n = mesh.n_vertices
    g = sp.coo_matrix(
        (np.concatenate([w, w]),
         (np.concatenate([edges[:, 0], edges[:, 1]]),
          np.concatenate([edges[:, 1], edges[:, 0]]))),
        shape=(n, n),
    )
    return g.tocsr()


def geodesic_distance_matrix(mesh: TriMesh, sources) -> np.ndarray:
    """Graph-geodesic distances (len(sources), N) along mesh edges: host-side
    Dijkstra, the same graph geodesic as VTK's `geodesic_distance`
    (utils/find_singularity_point.py:653)."""
    from scipy.sparse.csgraph import dijkstra

    return dijkstra(edge_graph_csr(mesh), directed=False,
                    indices=np.asarray(sources))
