"""TriMesh: the mesh container, as a frozen dataclass of torch tensors.

Counterpart of manifold_flow_tpu/geometry/mesh.py. The geometry is computed
once per surface on the CPU and then moved to the requested device; the
topology tables are built on the host with numpy, in the same layout and
entry order as the JAX package's tables. That order matters: the FEM matvec
sums each vertex's incident (cell, slot) entries in table order.

The JAX package's shape padding (`pad_mesh` and the unpad helpers) is not
ported: it exists to stop XLA from recompiling per surface.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from manifold_flow_tpu_torch.geometry.fem_quantities import (
    hat_gradients,
    mass_integrals,
    triangle_areas,
    vertex_normals_from_cells,
)
from manifold_flow_tpu_torch.geometry.tangent import tangent_basis

PAD_INDEX = -1

# Fields holding tensors, in declaration order.
ARRAY_FIELDS = (
    "points", "triangles", "normals", "areas", "basis", "grad_w", "integrals",
    "vertex_neighbors", "vertex_cells", "vertex_cell_slot", "vertex_degree",
    "vertex_cell_count", "boundary_vertex", "edges", "edge_cells",
)


@dataclasses.dataclass(frozen=True)
class TriMesh:
    """Triangulated 2-manifold with precomputed FEM and topology tensors.

      points           (N, 3)    float  vertex coordinates
      triangles        (M, 3)    int32  corner vertex ids
      normals          (N, 3)    float  unit vertex normals
      areas            (M,)      float  triangle areas
      basis            (N, 2, 3) float  tangent orthonormal bases ("e")
      grad_w           (M, 3, 3) float  P1 hat gradients per corner
      integrals        (M, 2)    float  [A/6, A/12] mass integrals
      vertex_neighbors (N, D)    int32  sorted 1-ring vertex ids, PAD_INDEX padded
      vertex_cells     (N, C)    int32  incident cell ids in ascending order,
                                        PAD_INDEX padded
      vertex_cell_slot (N, C)    int32  corner slot (0..2) of the vertex in
                                        each incident cell, PAD_INDEX padded
      vertex_degree    (N,)      int32  valid entries in vertex_neighbors
      vertex_cell_count(N,)      int32  valid entries in vertex_cells
      boundary_vertex  (N,)      bool   vertex on the mesh boundary
      edges            (E, 2)    int32  unique undirected edges (sorted pairs)
      edge_cells       (E, 2)    int32  incident cells per edge (PAD for boundary)
    """

    points: torch.Tensor
    triangles: torch.Tensor
    normals: torch.Tensor
    areas: torch.Tensor
    basis: torch.Tensor
    grad_w: torch.Tensor
    integrals: torch.Tensor
    vertex_neighbors: torch.Tensor
    vertex_cells: torch.Tensor
    vertex_cell_slot: torch.Tensor
    vertex_degree: torch.Tensor
    vertex_cell_count: torch.Tensor
    boundary_vertex: torch.Tensor
    edges: torch.Tensor
    edge_cells: torch.Tensor

    @property
    def n_vertices(self) -> int:
        return int(self.points.shape[0])

    @property
    def n_triangles(self) -> int:
        return int(self.triangles.shape[0])

    @property
    def n_dof(self) -> int:
        """Velocity DOF count 2N (two tangent components per vertex)."""
        return 2 * self.n_vertices

    @property
    def e(self) -> torch.Tensor:
        """Alias matching the reference's name for the tangent bases."""
        return self.basis

    @property
    def device(self) -> torch.device:
        return self.points.device

    @property
    def dtype(self) -> torch.dtype:
        return self.points.dtype

    def to(self, device) -> "TriMesh":
        """The same mesh with every tensor on `device`."""
        return dataclasses.replace(self, **{
            name: getattr(self, name).to(device) for name in ARRAY_FIELDS})


def vertex_adjacency(n_vertices: int, triangles: np.ndarray):
    """Vertex->vertex and vertex->(cell, corner-slot) incidence, padded.

    Returns (vertex_neighbors, vertex_cells, vertex_cell_slot, vertex_degree,
    vertex_cell_count) as int32 numpy arrays. Neighbors are sorted; each
    vertex's cells appear in ascending cell order, as in the JAX package.
    """
    tris = np.asarray(triangles, dtype=np.int64).reshape(-1, 3)
    n = int(n_vertices)
    # Corner k of the flat list is (cell k // 3, slot k % 3); a stable sort by
    # vertex keeps each vertex's corners in ascending cell order.
    corner_vertex = tris.reshape(-1)
    order = np.argsort(corner_vertex, kind="stable")
    ncell = np.bincount(corner_vertex, minlength=n)
    vc, vs = _fill_rows(n, corner_vertex[order], ncell,
                        (order // 3, order % 3))
    # Directed 1-ring pairs (v, u), deduplicated and sorted by (v, u).
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    src = np.concatenate([a, a, b, b, c, c])
    dst = np.concatenate([b, c, a, c, a, b])
    keys = np.unique(src * max(n, 1) + dst)
    src_u, dst_u = keys // max(n, 1), keys % max(n, 1)
    deg = np.bincount(src_u, minlength=n)
    (vn,) = _fill_rows(n, src_u, deg, (dst_u,))
    return vn, vc, vs, deg.astype(np.int32), ncell.astype(np.int32)


def _fill_rows(n: int, row_of: np.ndarray, counts: np.ndarray, values):
    """Scatter entries (grouped by row, in order) into PAD-padded (n, W) tables."""
    width = max(int(counts.max()) if counts.size else 0, 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    col = np.arange(row_of.size) - np.repeat(starts, counts)
    out = []
    for v in values:
        table = np.full((n, width), PAD_INDEX, dtype=np.int32)
        table[row_of, col] = v
        out.append(table)
    return out


def edges_and_boundary(n_vertices: int, triangles: np.ndarray):
    """Unique undirected edges, their incident cells, boundary vertices.

    Edges are sorted pairs in lexicographic order; each edge lists its first
    two incident cells in ascending cell order (PAD for a boundary edge).
    """
    tris = np.asarray(triangles, dtype=np.int64).reshape(-1, 3)
    n = max(int(n_vertices), 1)
    m = tris.shape[0]
    # Edges in appearance order: cell m gives (t0,t1), (t1,t2), (t2,t0).
    ea = tris[:, [0, 1, 2]].reshape(-1)
    eb = tris[:, [1, 2, 0]].reshape(-1)
    lo, hi = np.minimum(ea, eb), np.maximum(ea, eb)
    key = lo * n + hi
    cell = np.repeat(np.arange(m), 3)
    order = np.argsort(key, kind="stable")
    uniq, first, counts = np.unique(key[order], return_index=True,
                                    return_counts=True)
    n_edges = max(uniq.size, 1)
    edges = np.full((n_edges, 2), PAD_INDEX, dtype=np.int32)
    edge_cells = np.full((n_edges, 2), PAD_INDEX, dtype=np.int32)
    boundary = np.zeros(n_vertices, dtype=bool)
    if uniq.size:
        edges[: uniq.size, 0] = uniq // n
        edges[: uniq.size, 1] = uniq % n
        edge_cells[: uniq.size, 0] = cell[order[first]]
        two = counts >= 2
        edge_cells[: uniq.size][two, 1] = cell[order[first[two] + 1]]
        lone = edges[: uniq.size][counts == 1]
        boundary[lone.reshape(-1)] = True
    return edges, edge_cells, boundary


# Host-built per-mesh tables of the analysis ops (the cell across each edge,
# the walk rule's unit edges, the boundary rows), keyed by the identities of
# the mesh tensors each is computed from. An entry pins those tensors, so a
# recycled id never matches.
_MESH_CACHE: dict = {}
_MESH_CACHE_SIZE = 32


def mesh_cached(pins: tuple, key: tuple, build):
    """build(), cached under `key` while the entry pins the mesh tensors
    `pins`, every tensor build() reads (a FIFO of _MESH_CACHE_SIZE
    entries)."""
    key = (*(id(p) for p in pins), *key)
    entry = _MESH_CACHE.get(key)
    if entry is not None and all(a is b for a, b in zip(entry[0], pins)):
        return entry[1]
    value = build()
    _MESH_CACHE[key] = (tuple(pins), value)
    while len(_MESH_CACHE) > _MESH_CACHE_SIZE:
        _MESH_CACHE.pop(next(iter(_MESH_CACHE)))
    return value


def resolve_device(device) -> torch.device:
    """`device` as a torch.device, for the entry points that build meshes.

    They default to "cuda". Without a GPU that raises, naming the way to the
    CPU, instead of quietly running there.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs an NVIDIA GPU and "
            "torch.cuda.is_available() is False; pass device=\"cpu\" to run "
            "the plain torch versions on the CPU")
    return device


def build_mesh(points, triangles, normals=None, dtype=None,
               device="cuda") -> TriMesh:
    """Construct a TriMesh from raw arrays (runs once per surface).

    The geometry is computed on the CPU in the points' dtype (or `dtype`),
    then every tensor moves to `device` (the GPU unless the caller asks for
    the CPU; `resolve_device`). `normals` defaults to cell-normal-averaged
    vertex normals (the quantity the reference takes from
    `surface.point_normals`, utils/compute_optical_flow.py:349).
    """
    device = resolve_device(device)
    points = np.asarray(points)
    if dtype is not None:
        points = points.astype(dtype)
    pts = torch.from_numpy(np.array(points, order="C"))
    tris_np = np.array(triangles, dtype=np.int32, order="C")
    n_vertices = int(pts.shape[0])
    # The CUDA kernels index with these ids unchecked: validate them here.
    if pts.ndim != 2 or pts.shape[1] != 3 or tris_np.ndim != 2 or tris_np.shape[1] != 3:
        raise ValueError(f"want points (N, 3) and triangles (M, 3); got "
                         f"{tuple(pts.shape)} and {tris_np.shape}")
    if tris_np.size and (tris_np.min() < 0 or tris_np.max() >= n_vertices):
        raise ValueError(f"triangle vertex ids must lie in [0, {n_vertices})")
    tris = torch.from_numpy(tris_np)

    nrm = (vertex_normals_from_cells(pts, tris, n_vertices) if normals is None
           else torch.from_numpy(np.array(normals, dtype=points.dtype, order="C")))
    areas = triangle_areas(pts, tris)
    vn, vc, vs, deg, ncell = vertex_adjacency(n_vertices, tris_np)
    edges, edge_cells, boundary = edges_and_boundary(n_vertices, tris_np)
    mesh = TriMesh(
        points=pts,
        triangles=tris,
        normals=nrm,
        areas=areas,
        basis=tangent_basis(nrm),
        grad_w=hat_gradients(pts, tris),
        integrals=mass_integrals(areas),
        vertex_neighbors=torch.from_numpy(vn),
        vertex_cells=torch.from_numpy(vc),
        vertex_cell_slot=torch.from_numpy(vs),
        vertex_degree=torch.from_numpy(deg),
        vertex_cell_count=torch.from_numpy(ncell),
        boundary_vertex=torch.from_numpy(boundary),
        edges=torch.from_numpy(edges),
        edge_cells=torch.from_numpy(edge_cells),
    )
    return mesh.to(device)
