"""The port's streamline op (ops/streamline.py: K13 next hops, K14 walks and
their plain versions on the CPU) held against the JAX package.

The mesh is a generic bumpy patch (symmetric meshes put ties of the 1-ring
argmax and of the boundary tests on the last ulp) and the movie a seeded
mix of sources, sinks and vortices with noise, plus an all-zero frame. The
next-hop graph, the walks row by row, their lengths and the compacted
polylines must be equal, in both quirk modes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manifold_flow_tpu.geometry import synthetic as jax_synthetic
from manifold_flow_tpu.ops import streamline as jax_stream
from manifold_flow_tpu_torch import kernels, mesh_from_jax_arrays
from manifold_flow_tpu_torch.geometry.mesh import build_mesh
from manifold_flow_tpu_torch.ops import streamline as stream
from manifold_flow_tpu_torch.kernels import streams as kst
from tests.torch_parity import jax_arrays
from tests.torch_walks import around_the_cap

QUIRKS = pytest.mark.parametrize("quirks", [False, True], ids=["quirks_off", "quirks_on"])
MAX_STEPS = 64


@pytest.fixture(scope="module")
def problem():
    jmesh = jax_synthetic.plane_patch(
        nx=17, ny=15, lx=8.0, ly=7.0,
        height=lambda x, y: 0.45 * np.sin(1.1 * x + 0.3) * np.cos(0.8 * y - 0.5))
    pts = np.asarray(jmesh.points)
    rng = np.random.default_rng(5)
    frames = []
    for _ in range(4):
        c = rng.uniform([1.5, 1.5, 0.0], [6.5, 5.5, 0.0])
        d = pts - c
        swirl = np.stack([-d[:, 1], d[:, 0], np.zeros(len(d))], axis=-1)
        a, b = rng.uniform(-1.0, 1.0, size=2)
        frames.append(a * swirl + b * d + 0.3 * rng.standard_normal(d.shape))
    frames.append(np.zeros_like(pts))
    v = np.stack(frames)
    return jmesh, mesh_from_jax_arrays(jax_arrays(jmesh), device="cpu"), v


@QUIRKS
def test_next_hops_match_jax(problem, quirks):
    jmesh, tmesh, v = problem
    got = stream.next_hops(tmesh, torch.from_numpy(v), quirks=quirks).numpy()
    ids = np.arange(tmesh.n_vertices)
    for k in range(v.shape[0]):
        cand, ok = (np.asarray(a) for a in jax_stream._next_hop_tables(
            jmesh, v[k], quirks=quirks))
        np.testing.assert_array_equal(got[k], np.where(ok, cand, ids))
        nxt, adv = stream._next_hop_tables(tmesh, torch.from_numpy(v[k]), quirks)
        np.testing.assert_array_equal(adv.numpy(), ok)
        np.testing.assert_array_equal(nxt.numpy(), got[k])
    assert (got[-1] == ids).all()  # the zero frame halts everywhere
    # The boundary rows: some advance, some halt on their triangle test.
    bnd = stream.boundary_indices(tmesh).numpy()
    want = np.asarray(jax_stream.boundary_indices(jmesh))
    np.testing.assert_array_equal(bnd, np.unique(want))
    moved = got[:-1][:, bnd] != bnd
    assert moved.any() and not moved.all()


@pytest.mark.parametrize("n_frames", [1, 3, 5, 17])
@QUIRKS
def test_next_hops_match_jax_at_frame_group_edges(problem, quirks, n_frames):
    """next_hops against JAX's _hop_graph where the next-hop kernel's groups
    of frames have edges (one frame, groups cut short, 17 frames), the
    movie's frames cycled with their own scales and a last all-zero frame
    where n_frames > 1: `next` equal, frame by frame."""
    jmesh, tmesh, v = problem
    moving = v[:-1]
    frames = moving[np.arange(n_frames) % len(moving)] * (
        1.0 + 0.5 * np.arange(n_frames))[:, None, None]
    if n_frames > 1:
        frames[-1] = 0.0
    got = stream.next_hops(tmesh, torch.from_numpy(frames), quirks=quirks).numpy()
    n = tmesh.n_vertices
    graph = np.asarray(jax_stream._hop_graph(jmesh, jnp.asarray(frames), quirks))
    want = graph.reshape(n_frames, n) - (np.arange(n_frames) * n)[:, None]
    np.testing.assert_array_equal(got, want)
    if n_frames > 1:
        assert (got[-1] == np.arange(n)).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@QUIRKS
def test_hop_tables_hold_the_shared_cells_and_are_cached(problem, quirks, dtype):
    """The per-mesh hop rules equal the shared-cell scan of every
    (vertex, 1-ring slot): advance where the vertex is interior or shares 2
    cells, halt where it shares none (or the slot is padded), else the row
    of that one triangle's corners, which are the frame-independent half of
    the boundary test; the tables are built once per mesh, dtype and quirk
    mode."""
    _, tmesh, _ = problem
    rules, corners = stream.hop_tables(tmesh, dtype, quirks)
    assert stream.hop_tables(tmesh, dtype, quirks)[0] is rules
    assert stream.hop_tables(tmesh, dtype, not quirks)[0] is not rules
    assert rules.dtype == torch.int32 and corners.dtype == dtype
    solid = _hold_hop_tables(tmesh, dtype, quirks, rules, corners)
    assert bool(solid.any())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@QUIRKS
def test_hop_tables_halt_the_padded_slots_of_interior_rows(quirks, dtype):
    """On a mesh whose 1-rings differ in width (two fans, of 6 and of 8
    triangles), the hop rules of an interior vertex with fewer neighbours
    than the table is wide halt in its padded slots and advance elsewhere;
    every rule still equals the shared-cell scan."""
    tmesh = _two_fans()
    rules, corners = stream.hop_tables(tmesh, dtype, quirks)
    nb = tmesh.vertex_neighbors
    assert nb.shape[1] == 8
    hub = 0  # the 6-triangle fan's hub: interior, 2 padded slots
    assert int(tmesh.vertex_cell_count[hub]) == 6
    np.testing.assert_array_equal(rules[hub].numpy(), [kst.HOP_ADVANCE] * 6 + [-1] * 2)
    _hold_hop_tables(tmesh, dtype, quirks, rules, corners)


def _two_fans():
    """Two disjoint fans on bumped cones, of 6 and of 8 triangles around
    their hubs (vertices 0 and 7): interior hubs of 6 and 8 neighbours, rim
    vertices on the boundary with 3."""
    points, tris = [], []
    for spokes, shift in ((6, 0.0), (8, 3.0)):
        ang = 2.0 * np.pi * np.arange(spokes) / spokes
        rim = np.stack([shift + np.cos(ang), 0.8 * np.sin(ang),
                        0.3 + 0.1 * np.cos(3.0 * ang)], axis=-1)
        hub = sum(len(p) for p in points)
        points.append(np.concatenate([[[shift, 0.0, 0.0]], rim]))
        k = np.arange(spokes)
        tris.append(hub + np.stack([np.zeros(spokes, dtype=np.int64), 1 + k,
                                    1 + (k + 1) % spokes], axis=-1))
    return build_mesh(np.concatenate(points), np.concatenate(tris),
                      dtype=np.float64, device="cpu")


def _hold_hop_tables(tmesh, dtype, quirks, rules, corners):
    """Hold the hop rules and corners of `tmesh` to the shared-cell scan of
    every (vertex, 1-ring slot) and to the corners of each one shared
    triangle; returns which tested slots' triangles are not degenerate."""
    nb, cells = tmesh.vertex_neighbors, tmesh.vertex_cells.long()
    safe = torch.where(nb != -1, nb, 0).long()
    count, first = kst._shared_cells(cells[:, None, :], cells[safe])
    interior = (tmesh.vertex_cell_count >= 6)[:, None].expand_as(nb)
    advance = (interior | (count >= 2)) & (nb != -1)
    np.testing.assert_array_equal((rules == kst.HOP_ADVANCE).numpy(), advance.numpy())
    one = ~interior & (count == 1) & (nb != -1)
    assert bool(one.any()) and bool((~interior & (count >= 2)).any())
    v, slot = torch.nonzero(one, as_tuple=True)
    basis = tmesh.basis.to(dtype)
    *want, solid = kst._triangle_corners(tmesh.points.to(dtype), tmesh.triangles, v,
                                         first[v, slot], basis[v, 0], basis[v, 1], quirks)
    # A triangle degenerate on the tangent basis fails every test: halt.
    tested = torch.zeros_like(one)
    tested[v, slot] = solid
    np.testing.assert_array_equal((rules >= 0).numpy(), tested.numpy())
    np.testing.assert_array_equal((rules == -1).numpy(), (~advance & ~tested).numpy())
    np.testing.assert_array_equal(corners[rules[v, slot][solid].long()].numpy(),
                                  torch.stack(want, -1)[solid].numpy())
    return solid


@QUIRKS
def test_trace_frames_matches_jax(problem, quirks):
    jmesh, tmesh, v = problem
    want = jax_stream.trace_frames(jmesh, v, max_steps=MAX_STEPS, quirks=quirks)
    kernels.reset_launches()
    got = stream.trace_frames(tmesh, torch.from_numpy(v), max_steps=MAX_STEPS,
                              quirks=quirks)
    assert set(kernels.LAUNCHES.values()) == {0}
    assert got.vertices.dtype == torch.int32 and got.lengths.dtype == torch.int32
    assert got.vertices.shape == (v.shape[0], tmesh.n_vertices, MAX_STEPS + 1)
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.vertices.numpy(), np.asarray(want.vertices))
    lengths = got.lengths.numpy()
    assert lengths[:-1].max() >= 8 and (lengths[-1] == 1).all()
    # Walks that close a loop (mu + lambda with lambda > 1) are among them.
    last = np.take_along_axis(got.vertices.numpy(), (lengths - 1)[..., None], -1)[..., 0]
    assert (got.hops.numpy()[np.arange(v.shape[0])[:, None], last] != last).any()
    one = stream.trace(tmesh, torch.from_numpy(v[1]), max_steps=MAX_STEPS, quirks=quirks)
    np.testing.assert_array_equal(one.vertices.numpy(), got.vertices[1].numpy())
    np.testing.assert_array_equal(one.lengths.numpy(), got.lengths[1].numpy())
    adaptive = stream.trace_frames_adaptive(tmesh, torch.from_numpy(v), MAX_STEPS, quirks)
    assert torch.equal(adaptive.vertices, got.vertices)


def test_walks_cut_at_max_steps_match_jax(problem):
    jmesh, tmesh, v = problem
    want = jax_stream.trace_frames(jmesh, v, max_steps=3)
    got = stream.trace_frames(tmesh, torch.from_numpy(v), max_steps=3)
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.vertices.numpy(), np.asarray(want.vertices))
    assert (got.lengths.numpy() == 4).any()


@pytest.mark.parametrize("max_steps", [16, 64, 100])
def test_walk_lengths_around_the_cap_match_jax(max_steps):
    """Walks whose mu + lambda is cap - 1, cap or cap + 1 (cap = max_steps +
    1): the port's lengths (the plain version on the CPU) equal those of
    the JAX package's _double_and_detect, the length half of
    _trace_batched (its pairwise test up to 72 steps, its sort beyond)."""
    hops = around_the_cap(max_steps, seed=max_steps)
    t, n = hops.shape
    f = (hops + np.arange(t, dtype=np.int32)[:, None] * n).ravel()
    _, want, _ = jax_stream._double_and_detect(
        jnp.asarray(f), jnp.arange(t * n, dtype=jnp.int32), max_steps)
    got = kst.trace_walks(torch.from_numpy(hops), max_steps)
    np.testing.assert_array_equal(got.numpy().ravel(), np.asarray(want))
    assert {max_steps, max_steps + 1} <= set(got.flatten().tolist())

@QUIRKS
def test_compact_frames_matches_jax(problem, quirks):
    jmesh, tmesh, v = problem
    want_sl = jax_stream.trace_frames(jmesh, v, max_steps=MAX_STEPS, quirks=quirks)
    want = jax_stream.compact_frames(jmesh, want_sl, min_length=5,
                                     coord_dtype=np.float32)
    # Traced without rows (the stage's path): K14 packs the kept walks.
    packed = stream.trace_frames(tmesh, torch.from_numpy(v), MAX_STEPS, quirks,
                                 rows=False)
    assert packed.vertices is None
    emitted = []
    got = stream.compact_frames(tmesh, packed, min_length=5, coord_dtype=np.float32,
                                emit=lambda k, lines: emitted.append((k, len(lines))))
    assert [len(f) for f in got] == [len(f) for f in want]
    assert emitted == [(k, len(f)) for k, f in enumerate(want)]
    assert sum(len(f) for f in got) > 0 and len(got[-1]) == 0
    for fg, fw in zip(got, want):
        for a, b in zip(fg, fw):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    one = stream.compact(tmesh, stream.trace(tmesh, torch.from_numpy(v[0]), MAX_STEPS,
                                             quirks), min_length=5)
    wone = jax_stream.compact(jmesh, jax_stream.trace(jmesh, v[0], MAX_STEPS, quirks),
                              min_length=5)
    assert len(one) == len(wone)
    for a, b in zip(one, wone):
        np.testing.assert_array_equal(a, b)


def test_unit_edges_follow_the_mesh_geometry(problem):
    """The cached unit edges belong to the geometry they were computed
    from: a mesh that shares the neighbour table but moves its points gets
    its own, and its walks equal JAX's on the moved mesh."""
    import dataclasses

    jmesh, tmesh, v = problem
    first = stream.unit_edges(tmesh, torch.float64)
    assert stream.unit_edges(tmesh, torch.float64) is first
    pts = tmesh.points.numpy()
    bent = pts + np.stack([np.zeros(len(pts)), np.zeros(len(pts)),
                           0.3 * np.cos(0.9 * pts[:, 0])], axis=-1)
    moved = dataclasses.replace(tmesh, points=torch.from_numpy(bent))
    assert moved.vertex_neighbors is tmesh.vertex_neighbors
    assert not torch.equal(stream.unit_edges(moved, torch.float64), first)
    want = jax_stream.trace_frames(dataclasses.replace(jmesh, points=bent), v,
                                   max_steps=MAX_STEPS)
    got = stream.trace_frames(moved, torch.from_numpy(v), max_steps=MAX_STEPS)
    np.testing.assert_array_equal(got.vertices.numpy(), np.asarray(want.vertices))


def test_empty_movie_and_no_kept_walk(problem):
    _, tmesh, v = problem
    empty = stream.trace_frames(tmesh, torch.zeros((0, tmesh.n_vertices, 3),
                                                   dtype=torch.float64), MAX_STEPS)
    assert empty.lengths.shape == (0, tmesh.n_vertices)
    assert empty.vertices.shape == (0, tmesh.n_vertices, MAX_STEPS + 1)
    assert stream.compact_frames(tmesh, empty) == []
    zero = stream.trace_frames(tmesh, torch.from_numpy(v[-1:]), MAX_STEPS, rows=False)
    assert stream.compact_frames(tmesh, zero, min_length=2) == [[]]
    # float32 movies trace in float32 and give the same walks here.
    f32 = stream.trace_frames(tmesh, torch.from_numpy(v).float(), MAX_STEPS)
    f64 = stream.trace_frames(tmesh, torch.from_numpy(v), MAX_STEPS)
    assert (f32.lengths == f64.lengths).float().mean() > 0.95
