"""Frozen copy of the S1 surface reconstruction, for the benchmark's inputs.

Origin: manifold_flow_tpu_torch/geometry/reconstruct.py at commit 812b413
(itself a copy of manifold_flow_tpu/geometry/reconstruct.py), copied whole
and not to be edited: the benchmark builds the `recon*` configurations'
surfaces with it, so a later change to the port's S1 cannot change the
benchmark's inputs. Its original docstring follows.

Surface reconstruction from electrode point clouds, without VTK (S1).

A copy of manifold_flow_tpu/geometry/reconstruct.py, which is numpy and
scipy on the host and imports no JAX. It reimplements the reference's S1
pipeline (S1_reconstruct_surface.py:85-95):
    point cloud -> delaunay_2d -> smooth(100) -> butterfly subdivide(3)
    -> smooth(100)
with numpy/scipy equivalents of the VTK filters:

  * delaunay_2d: project onto the best-fit (PCA) plane, scipy Delaunay;
  * smooth: Laplacian relaxation (VTK vtkSmoothPolyDataFilter semantics:
    relaxation factor 0.01/iteration, boundary vertices relax only along
    the boundary);
  * butterfly subdivide: interpolating triangular subdivision with the
    modified-butterfly (Zorin) stencils — regular 8-point interior rule,
    valence-adapted rules at extraordinary vertices, 4-point boundary rule
    (VTK's vtkButterflySubdivisionFilter implements the same family).

The output feeds build_mesh. It runs once per subject; the subdivision
walks the edges in Python.
"""

from __future__ import annotations

import numpy as np


def _edge_map(triangles):
    edges = {}
    for m, tri in enumerate(triangles):
        for a, b in ((tri[0], tri[1]), (tri[1], tri[2]), (tri[2], tri[0])):
            edges.setdefault((min(a, b), max(a, b)), []).append(m)
    return edges


def delaunay_2d(points: np.ndarray) -> np.ndarray:
    """Triangulate a near-planar 3-D point cloud (VTK delaunay_2d analogue).

    Projects onto the two leading PCA axes and runs a planar Delaunay.
    """
    from scipy.spatial import Delaunay

    pts = np.asarray(points, dtype=np.float64)
    center = pts.mean(axis=0)
    _, _, vt = np.linalg.svd(pts - center, full_matrices=False)
    uv = (pts - center) @ vt[:2].T
    tri = Delaunay(uv)
    simplices = tri.simplices.astype(np.int32)
    # Orient consistently (positive area in the projection plane).
    a = uv[simplices[:, 1]] - uv[simplices[:, 0]]
    b = uv[simplices[:, 2]] - uv[simplices[:, 0]]
    flip = (a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]) < 0
    simplices[flip] = simplices[flip][:, [0, 2, 1]]
    return simplices


def laplacian_smooth(points: np.ndarray, triangles: np.ndarray,
                     n_iter: int = 100, relaxation: float = 0.01) -> np.ndarray:
    """VTK-style Laplacian smoothing.

    Each pass moves every vertex `relaxation` of the way toward the average
    of its connected neighbors; boundary vertices average only their two
    boundary neighbors (vtkSmoothPolyDataFilter with BoundarySmoothingOn,
    the default the reference uses via `mesh.smooth(n_iter=100)`, S1:92).
    """
    pts = np.asarray(points, dtype=np.float64).copy()
    n = len(pts)
    edges = _edge_map(np.asarray(triangles))
    neighbors = [[] for _ in range(n)]
    boundary_neighbors = [[] for _ in range(n)]
    for (a, b), cells in edges.items():
        neighbors[a].append(b)
        neighbors[b].append(a)
        if len(cells) == 1:
            boundary_neighbors[a].append(b)
            boundary_neighbors[b].append(a)
    is_boundary = np.array([len(bn) > 0 for bn in boundary_neighbors])
    nb_use = [boundary_neighbors[i] if is_boundary[i] else neighbors[i]
              for i in range(n)]
    max_deg = max((len(x) for x in nb_use), default=1) or 1
    table = np.zeros((n, max_deg), dtype=np.int64)
    weight = np.zeros((n, max_deg))
    for i, nb in enumerate(nb_use):
        table[i, : len(nb)] = nb
        if nb:
            weight[i, : len(nb)] = 1.0 / len(nb)
    movable = np.array([len(nb) > 0 for nb in nb_use])
    for _ in range(n_iter):
        avg = np.einsum("nk,nkd->nd", weight, pts[table])
        pts[movable] += relaxation * (avg[movable] - pts[movable])
    return pts


def _butterfly_position(points, triangles, edge, edge_cells, neighbors,
                        boundary_nb):
    """Interpolated position for the midpoint of one edge (modified
    butterfly stencils; Zorin et al. 1996)."""
    a, b = edge
    if len(edge_cells[edge]) == 1:
        # Boundary 4-point rule: 9/16 ends, -1/16 outer boundary neighbors.
        pa_out = [v for v in boundary_nb[a] if v != b]
        pb_out = [v for v in boundary_nb[b] if v != a]
        pos = 9.0 / 16.0 * (points[a] + points[b])
        pos -= 1.0 / 16.0 * (points[pa_out[0]] if pa_out else points[a])
        pos -= 1.0 / 16.0 * (points[pb_out[0]] if pb_out else points[b])
        return pos

    def ordered_ring(center, start):
        """1-ring of `center` ordered around it, starting from `start`."""
        ring = [start]
        ring_set = {start}
        cur = start
        while True:
            nxt = None
            for c in edge_cells.get((min(center, cur), max(center, cur)), []):
                tri = triangles[c]
                third = [v for v in tri if v != center and v != cur]
                if len(third) == 1 and third[0] not in ring_set:
                    nxt = third[0]
                    break
            if nxt is None:
                break
            ring.append(nxt)
            ring_set.add(nxt)
            cur = nxt
        return ring

    va, vb = len(neighbors[a]), len(neighbors[b])
    interior_a = len(boundary_nb[a]) == 0
    interior_b = len(boundary_nb[b]) == 0

    def irregular_stencil(center, other):
        ring = ordered_ring(center, other)
        k = len(ring)
        pos = 3.0 / 4.0 * points[center]
        if k == 3:
            w = [5.0 / 12.0, -1.0 / 12.0, -1.0 / 12.0]
        elif k == 4:
            w = [3.0 / 8.0, 0.0, -1.0 / 8.0, 0.0]
        else:
            w = [(0.25 + np.cos(2 * np.pi * j / k)
                  + 0.5 * np.cos(4 * np.pi * j / k)) / k for j in range(k)]
        for j, v in enumerate(ring):
            pos += w[j] * points[v]
        return pos

    def regular_stencil():
        """Classic 8-point butterfly: 1/2 ends, 1/8 wings, -1/16 far wings.
        A far wing is the third vertex of the triangle ACROSS edge (x, y)
        from the wing `opp`; where that triangle is missing (boundary), the
        endpoint substitutes so the stencil stays affine-invariant."""
        c0, c1 = edge_cells[edge]
        w1 = [v for v in triangles[c0] if v not in edge][0]
        w2 = [v for v in triangles[c1] if v not in edge][0]
        pos = 0.5 * (points[a] + points[b]) + 0.125 * (points[w1] + points[w2])
        for (x, y, opp) in ((a, w1, b), (a, w2, b), (b, w1, a), (b, w2, a)):
            key = (min(x, y), max(x, y))
            cells = [c for c in edge_cells.get(key, [])
                     if opp not in triangles[c]]
            if cells:
                far = [v for v in triangles[cells[0]] if v != x and v != y][0]
                pos -= 1.0 / 16.0 * points[far]
            else:
                pos -= 1.0 / 16.0 * points[x]
        return pos

    if not (interior_a and interior_b):
        # Interior edge with a boundary endpoint: Zorin's crease rules
        # require virtual reflected neighbors (and VTK parity is untestable
        # in this image); the regular stencil with endpoint substitution
        # for missing far-wing triangles is interpolating and affine-
        # invariant. The cos-weight ring rule must NOT be used here — a
        # boundary vertex's one-way ring walk is truncated, and the
        # truncated stencil does not sum to 1 (caught by
        # tests/test_butterfly.py::test_all_stencils_affine_invariant).
        return regular_stencil()
    if va == 6 and vb == 6:
        return regular_stencil()
    if va == 6:
        return irregular_stencil(b, a)
    if vb == 6:
        return irregular_stencil(a, b)
    # Both extraordinary: average the two stencils.
    return 0.5 * (irregular_stencil(a, b) + irregular_stencil(b, a))


def butterfly_subdivide(points: np.ndarray, triangles: np.ndarray,
                        n_subdiv: int = 1):
    """Interpolating butterfly subdivision (VTK `subdivide(n, 'butterfly')`
    analogue, S1:94). Each pass splits every triangle into four."""
    pts = np.asarray(points, dtype=np.float64)
    tris = np.asarray(triangles, dtype=np.int64)
    for _ in range(n_subdiv):
        edge_cells = _edge_map(tris)
        n = len(pts)
        neighbors = [set() for _ in range(n)]
        boundary_nb = [[] for _ in range(n)]
        for (a, b), cells in edge_cells.items():
            neighbors[a].add(b)
            neighbors[b].add(a)
            if len(cells) == 1:
                boundary_nb[a].append(b)
                boundary_nb[b].append(a)
        neighbors = [sorted(s) for s in neighbors]
        new_index = {}
        new_pts = [pts]
        for edge in sorted(edge_cells):
            new_index[edge] = n + len(new_index)
            new_pts.append(_butterfly_position(
                pts, tris, edge, edge_cells, neighbors, boundary_nb)[None])
        pts = np.concatenate(new_pts, axis=0)
        out = []
        for tri in tris:
            a, b, c = tri
            ab = new_index[(min(a, b), max(a, b))]
            bc = new_index[(min(b, c), max(b, c))]
            ca = new_index[(min(c, a), max(c, a))]
            out += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        tris = np.asarray(out, dtype=np.int64)
    return pts, tris.astype(np.int32)


def reconstruct_surface(electrode_points: np.ndarray, smooth_iters: int = 100,
                        subdivisions: int = 3):
    """Full S1 pipeline: triangulate, smooth, subdivide, smooth.

    Returns (points, triangles) ready for build_mesh / write_ply.
    """
    pts = np.asarray(electrode_points, dtype=np.float64)
    tris = delaunay_2d(pts)
    pts = laplacian_smooth(pts, tris, n_iter=smooth_iters)
    pts, tris = butterfly_subdivide(pts, tris, n_subdiv=subdivisions)
    pts = laplacian_smooth(pts, tris, n_iter=smooth_iters)
    return pts, tris
