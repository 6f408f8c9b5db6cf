"""Streamline extraction: greedy tangent-projected walks on the mesh graph.

Counterpart of manifold_flow_tpu/ops/streamline.py (reference:
S6_streamline.py:17-138). The walk rule chooses the next vertex from the
current vertex and its velocity only, so every (frame, vertex) has one next
hop, and a walk is a path in that functional graph that stops at its first
repeated vertex (a halting vertex points to itself):

  * K13 (`kernels.streams.next_hop`) builds the graph: the 1-ring
    neighbour whose tangent-projected unit edge maximises the dot product
    with the velocity, kept when that dot is positive and, at a boundary
    vertex (fewer than 6 cells), when the two share 2 cells or the velocity
    points inside their one shared triangle (S6:100-133; `quirks` takes the
    reference's index arithmetic there, as the JAX package documents);
  * K14 (`kernels.streams.trace_walks`, `pack_walks`) measures every walk
    and packs the kept ones into one flat id buffer.

The JAX package's pointer doubling, window planner, escalation overlay,
packed XLA gather and int16 walk ids exist to bound TPU gather volume and
link traffic, and are not ported: walk ids are int32, and the stage never
materialises (T, N, max_steps + 1) rows. `trace`/`trace_frames` still
return rows, written by the same pack kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from manifold_flow_tpu_torch.geometry.mesh import PAD_INDEX, TriMesh, mesh_cached
from manifold_flow_tpu_torch.kernels import streams as kst
from manifold_flow_tpu_torch.kernels.analysis import _dot3


class Streamlines(NamedTuple):
    vertices: torch.Tensor | None  # (..., N, L+1) int32 visited ids, PAD_INDEX
    #                                beyond length; None when traced without rows
    lengths: torch.Tensor          # (..., N) int32 points in each streamline
    # The JAX adaptive tracer's overlay: always None here (every walk is
    # traced to max_steps at once).
    overlay_ids: object | None = None
    overlay_vertices: object | None = None
    hops: torch.Tensor | None = None  # (..., N) int32 next-hop graph (K13)


def unit_edges(mesh: TriMesh, dtype: torch.dtype) -> torch.Tensor:
    """(N, D, 3) on the mesh's device: each 1-ring edge vector projected
    onto the vertex's tangent plane and normalised (zero for a padded slot
    or a zero projection), in `dtype` (ops/streamline.py:149-157). The walk
    rule dots these with the velocity; they do not depend on the frame, so
    they are computed once per mesh, on the host."""
    def build():
        pts, basis = mesh.points.cpu(), mesh.basis.cpu()
        nb = mesh.vertex_neighbors.cpu()
        safe = torch.where(nb != PAD_INDEX, nb, 0).long()
        e1, e2 = basis[:, None, 0], basis[:, None, 1]
        n = torch.linalg.cross(e1, e2, dim=-1)
        nn = _dot3(n, n)
        vec = pts[safe] - pts[:, None]
        pos = nn > 0
        s = torch.where(pos, _dot3(vec, n) / torch.where(pos, nn, torch.ones_like(nn)),
                        torch.zeros_like(nn))
        proj = vec - s[..., None] * n
        nrm = torch.sqrt(_dot3(proj, proj))[..., None]
        unit = proj / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
        return unit.to(dtype).contiguous().to(mesh.device)
    return mesh_cached((mesh.points, mesh.basis, mesh.vertex_neighbors),
                       ("unit_edges", dtype), build)


def boundary_indices(mesh: TriMesh) -> torch.Tensor:
    """int32 ids of the mesh's non-interior vertices (cell count < 6), on
    the mesh's device (ops/streamline.py:213, without its padding to a
    multiple of 8, which buckets XLA shapes). Only these rows run the
    boundary tests of the walk rule."""
    return mesh_cached((mesh.vertex_cell_count,), ("boundary_indices",),
                       lambda: torch.nonzero(mesh.vertex_cell_count < 6)[:, 0]
                       .to(torch.int32))


def hop_tables(mesh: TriMesh, dtype: torch.dtype, quirks: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The walk rule's frame-independent boundary tables on the mesh's
    device (`kernels.streams.hop_tables`: each 1-ring slot's hop rule and
    the corners of the triangles the rules name, in `dtype`); they depend
    on the mesh only, so they are computed once per mesh, on the host."""
    def build():
        rules, corners = kst.hop_tables(
            mesh.points.cpu().to(dtype), mesh.triangles.cpu(), mesh.basis.cpu().to(dtype),
            mesh.vertex_neighbors.cpu(), mesh.vertex_cell_count.cpu(),
            mesh.vertex_cells.cpu(), quirks)
        return rules.to(mesh.device), corners.to(mesh.device)
    return mesh_cached((mesh.points, mesh.triangles, mesh.basis, mesh.vertex_neighbors,
                        mesh.vertex_cell_count, mesh.vertex_cells),
                       ("hop_tables", dtype, bool(quirks)), build)


def next_hops(mesh: TriMesh, v_world: torch.Tensor, quirks: bool = False
              ) -> torch.Tensor:
    """The next-hop graph (T, N) int32 of every frame of v_world (T, N, 3):
    K13, in v_world's dtype."""
    dtype = v_world.dtype
    return kst.next_hop(unit_edges(mesh, dtype), v_world.contiguous(),
                        mesh.vertex_neighbors, *hop_tables(mesh, dtype, quirks),
                        mesh.basis.to(dtype).contiguous())


def _next_hop_tables(mesh: TriMesh, vel: torch.Tensor, quirks: bool = False):
    """One frame's next hop (N,) int32 and its advance mask (N,) bool
    (ops/streamline.py:133): a vertex advances unless it points to itself
    (no vertex is its own neighbour)."""
    nxt = next_hops(mesh, vel[None], quirks)[0]
    return nxt, nxt != torch.arange(mesh.n_vertices, device=nxt.device)


def _pack(hops: torch.Tensor, seeds: torch.Tensor, lengths: torch.Tensor,
          offsets: torch.Tensor, size: int, fill: int | None = None) -> torch.Tensor:
    """K14's pack entry into a new (size,) int32 buffer (prefilled with
    `fill` when given, else left unset where no walk writes)."""
    out = (torch.full((size,), fill, dtype=torch.int32, device=hops.device)
           if fill is not None else
           torch.empty((size,), dtype=torch.int32, device=hops.device))
    return kst.pack_walks(hops.contiguous(), seeds, lengths.contiguous(), offsets, out)


def trace_frames(mesh: TriMesh, v_world: torch.Tensor, max_steps: int = 128,
                 quirks: bool = False, rows: bool = True) -> Streamlines:
    """Trace one streamline from every vertex of every frame: (T, N, 3) ->
    Streamlines with lengths (T, N) and, with rows=True, vertices
    (T, N, max_steps + 1) (PAD_INDEX beyond each length), as JAX's
    trace_frames returns them. Seeds with zero velocity give length-1
    walks; callers filter by length (S6:29, S6:135-138).

    rows=False skips the rows (the streamline stage packs only the kept
    walks, `compact_frames`); `hops`, the next-hop graph, is always kept."""
    hops = next_hops(mesh, v_world, quirks)
    lengths = kst.trace_walks(hops, max_steps)
    vertices = None
    if rows:
        t, n = hops.shape
        width = int(max_steps) + 1
        seeds = torch.arange(t * n, dtype=torch.int64, device=hops.device)
        vertices = _pack(hops, seeds, lengths.reshape(-1), seeds * width,
                         t * n * width, fill=PAD_INDEX).reshape(t, n, width)
    return Streamlines(vertices=vertices, lengths=lengths, hops=hops)


def trace(mesh: TriMesh, v_world_frame: torch.Tensor, max_steps: int = 128,
          quirks: bool = False) -> Streamlines:
    """`trace_frames` of one frame (N, 3): vertices (N, max_steps + 1),
    lengths (N,) and hops (N,)."""
    sl = trace_frames(mesh, v_world_frame[None], max_steps, quirks)
    return Streamlines(vertices=sl.vertices[0], lengths=sl.lengths[0],
                       hops=sl.hops[0])


def trace_frames_adaptive(mesh: TriMesh, v_world: torch.Tensor,
                          max_steps: int = 128, quirks: bool = False) -> Streamlines:
    """ops/streamline.py:553, whose results equal trace_frames'. Its window
    planner and escalation retrace bound TPU gather volume; here it is
    `trace_frames` itself."""
    return trace_frames(mesh, v_world, max_steps, quirks)


def _packed_walks(sl: Streamlines, min_length: int):
    """The kept walks (length >= min_length) of a movie's Streamlines as
    host arrays: flat seed ids (frame * N + vertex, ascending), lengths,
    and every walk's vertex ids back to back. Only the kept ids cross to
    the host: K14 packs them on the device from the hop graph."""
    from manifold_flow_tpu_torch.utils.io import to_numpy

    t, n = sl.lengths.shape
    flat_len = sl.lengths.reshape(-1)
    kept = torch.nonzero(flat_len >= min_length)[:, 0]
    lens = flat_len[kept]
    offsets = torch.cumsum(lens, 0, dtype=torch.int64) - lens
    total = int(offsets[-1] + lens[-1]) if kept.numel() else 0
    flat = _pack(sl.hops.reshape(t, n), kept, lens, offsets, total)
    return to_numpy(kept, lens, flat)


def compact_frames(mesh: TriMesh, sl: Streamlines, min_length: int = 20,
                   coord_dtype=None, emit=None):
    """Host-side: a whole movie's walks -> per-frame polyline lists.

    Equivalent to per-frame `compact`, in frame-major order with ascending
    seeds; only the kept walks' Σ(lengths) ids reach the host (K14 packs
    them, `_packed_walks`). `coord_dtype` sets the polyline coordinate
    dtype (default: the mesh's). `emit(frame_index, lines)`, when given, is
    called once per frame as soon as its polylines exist, so a caller can
    queue each frame's write while later frames are assembled."""
    from manifold_flow_tpu_torch.utils.io import to_numpy

    (pts,) = to_numpy(mesh.points)
    if coord_dtype is not None:
        pts = pts.astype(coord_dtype)
    t, n = sl.lengths.shape
    kept, lens, flat = _packed_walks(sl, min_length)
    coords = np.take(pts, flat, axis=0)
    ends = np.cumsum(lens, dtype=np.int64)
    starts = (ends - lens).tolist()
    ends = ends.tolist()
    bounds = np.searchsorted(kept // n, np.arange(t + 1)).tolist()
    out = []
    for k in range(t):
        lines = [coords[starts[j]: ends[j]] for j in range(bounds[k], bounds[k + 1])]
        out.append(lines)
        if emit is not None:
            emit(k, lines)
    return out


def compact(mesh: TriMesh, sl: Streamlines, min_length: int = 20):
    """Host-side: one frame's walks -> list of coordinate polylines
    (S6:135-138)."""
    def one(x):
        return None if x is None else x[None]
    return compact_frames(mesh, Streamlines(vertices=one(sl.vertices),
                                            lengths=sl.lengths[None],
                                            hops=one(sl.hops)), min_length)[0]
