"""Recombination, singularity detection, compaction and topology of the
PyTorch port held against the JAX package, on the CPU.

The mesh is generic (the bumpy patch of tests/test_ops_singularity.py): on a
symmetric mesh the field's zeros sit exactly on edges and vertices and the
discrete outputs flip on last-ulp differences. The velocity field is the
JAX package's cg solve of the two-source movie plus one all-zero frame
(v_max = 0, where every test is NaN and nothing may be detected); both
packages get it as the same numpy array.

Tolerances: recombined vectors, speeds and v_max to 1e-12 of the largest
entry (the same float64 formulas, summed in another order); barycentric
coordinates and interior points of the detected triangles to 1e-10; masks,
counts, compacted ids, valid flags and snapped centers equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manifold_flow_tpu.geometry import synthetic as jax_synthetic
from manifold_flow_tpu.geometry import topology as jax_topology
from manifold_flow_tpu.ops import recombine as jax_recombine
from manifold_flow_tpu.ops import singularity as jax_sing
from manifold_flow_tpu.solve.api import compute_velocity_fields as jax_cvf
from manifold_flow_tpu_torch import compute_velocity_fields, kernels, mesh_from_jax_arrays
from manifold_flow_tpu_torch.geometry import topology
from manifold_flow_tpu_torch.kernels import analysis as kan
from manifold_flow_tpu_torch.ops import recombine
from manifold_flow_tpu_torch.ops import singularity as sing
from tests.torch_parity import jax_arrays, rel_err

FLOAT_TOL = 1e-12
POINT_TOL = 1e-10
EPS = 1e-4


@pytest.fixture(scope="module")
def problem():
    jmesh = jax_synthetic.plane_patch(
        nx=16, ny=16, lx=10.0, ly=10.0,
        height=lambda x, y: 0.3 * np.sin(0.9 * x) * np.cos(0.7 * y))
    pot, times, _ = jax_synthetic.two_source_movie(jmesh, n_frames=5)
    res = jax_cvf(jmesh, jnp.asarray(pot), jnp.asarray(times), method="cg",
                  tol=1e-12)
    v_k = np.concatenate([np.asarray(res.v_k),
                          np.zeros((1, 2 * jmesh.n_vertices))])
    return jmesh, mesh_from_jax_arrays(jax_arrays(jmesh), device="cpu"), v_k


@pytest.fixture(scope="module")
def fields(problem):
    jmesh, tmesh, v_k = problem
    jv = jax_recombine.velocity_to_world(jnp.asarray(v_k), jmesh.basis)
    jfield, jcounts = jax_sing.detect_with_counts(jmesh, jv, eps=EPS)
    tv, speed, v_max = recombine.velocity_to_world_and_speed(
        torch.from_numpy(v_k), tmesh.basis)
    tfield, tcounts = sing.detect_with_counts(tmesh, tv, eps=EPS, speed=speed,
                                              v_max=v_max)
    return jv, jfield, jcounts, tv, speed, tfield, tcounts


def test_recombine_matches_jax(problem, fields):
    jmesh, tmesh, v_k = problem
    jv, jfield, _, tv, speed, tfield, _ = fields
    tvk = torch.from_numpy(v_k)
    assert rel_err(tv.numpy(), np.asarray(jv)) <= FLOAT_TOL
    assert rel_err(speed.numpy(), np.asarray(jax_recombine.world_speed(jv))) <= FLOAT_TOL
    assert rel_err(recombine.world_speed(tv).numpy(), speed.numpy()) == 0.0
    np.testing.assert_allclose(tfield.v_max.numpy()[:-1], np.asarray(jfield.v_max)[:-1],
                               rtol=FLOAT_TOL, atol=0)
    assert float(tfield.v_max[-1]) == 0.0 == float(jfield.v_max[-1])
    batched = recombine.velocity_to_world(tvk[None], tmesh.basis)
    assert batched.shape == (1, *tv.shape) and torch.equal(batched[0], tv)
    np.testing.assert_array_equal(recombine.split_components(tvk).numpy(),
                                  np.asarray(jax_recombine.split_components(v_k)))
    np.testing.assert_array_equal(recombine.velocity_to_complex(tvk).numpy(),
                                  np.asarray(jax_recombine.velocity_to_complex(v_k)))


def test_detect_matches_jax(fields):
    _, jfield, jcounts, _, _, tfield, tcounts = fields
    jmask_v = np.asarray(jfield.vertex_mask)
    jmask_i = np.asarray(jfield.interior_mask)
    np.testing.assert_array_equal(tfield.vertex_mask.numpy(), jmask_v)
    np.testing.assert_array_equal(tfield.interior_mask.numpy(), jmask_i)
    assert jmask_i[:-1].sum(axis=1).min() > 0, "the field has interior zeros"
    for got, want in ((tfield.interior_bary, jfield.interior_bary),
                      (tfield.interior_point, jfield.interior_point)):
        got, want = got.numpy()[jmask_i], np.asarray(want)[jmask_i]
        np.testing.assert_allclose(got, want, rtol=POINT_TOL, atol=POINT_TOL)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert [int(c) for c in sing.detection_counts(tfield)] == [
        int(c) for c in jax_sing.detection_counts(jfield)]


def _frames(v_k, n_frames):
    """n_frames velocity frames cycled from the solve's (v_k without its
    zero frame), each scaled by its own factor, the last one all zero
    (v_max = 0) where n_frames > 1."""
    solved = v_k[:-1]
    scale = 1.0 + 0.25 * np.arange(n_frames)
    out = solved[np.arange(n_frames) % len(solved)] * scale[:, None]
    if n_frames > 1:
        out[-1] = 0.0
    return out


@pytest.mark.parametrize("n_frames", [1, 3, 5, 17])
def test_detect_matches_jax_at_frame_group_edges(problem, n_frames):
    """detect and detect_with_counts against JAX where the detection
    kernel's groups of frames have edges (one frame, groups cut short, 17
    frames): masks and counts equal, the detected triangles' barycentric
    pairs and points within POINT_TOL, nothing detected in the zero frame."""
    jmesh, tmesh, v_k = problem
    vk = _frames(v_k, n_frames)
    jv = jax_recombine.velocity_to_world(jnp.asarray(vk), jmesh.basis)
    jfield, jcounts = jax_sing.detect_with_counts(jmesh, jv, eps=EPS)
    tv, speed, v_max = recombine.velocity_to_world_and_speed(torch.from_numpy(vk),
                                                             tmesh.basis)
    tfield, tcounts = sing.detect_with_counts(tmesh, tv, eps=EPS, speed=speed, v_max=v_max)
    alone = sing.detect(tmesh, tv, eps=EPS, speed=speed, v_max=v_max)
    jmask_i = np.asarray(jfield.interior_mask)
    for field in (tfield, alone):
        np.testing.assert_array_equal(field.vertex_mask.numpy(), np.asarray(jfield.vertex_mask))
        np.testing.assert_array_equal(field.interior_mask.numpy(), jmask_i)
        for got, want in ((field.interior_bary, jfield.interior_bary),
                          (field.interior_point, jfield.interior_point)):
            np.testing.assert_allclose(got.numpy()[jmask_i], np.asarray(want)[jmask_i],
                                       rtol=POINT_TOL, atol=POINT_TOL)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(
        tfield.counts.numpy(),
        np.stack([np.asarray(jfield.vertex_mask).sum(1), jmask_i.sum(1)], -1))
    assert jmask_i[0].any(), "the first frame has interior zeros"
    if n_frames > 1:
        assert tfield.counts[-1].tolist() == [0, 0]


def test_detect_computes_speed_when_not_given(problem, fields):
    _, tmesh, _ = problem
    _, _, _, tv, _, tfield, _ = fields
    field = sing.detect(tmesh, tv, eps=EPS)
    for got, want in zip(field, tfield):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="together"):
        sing.detect(tmesh, tv, speed=recombine.world_speed(tv))


def test_speed_from_world_vectors_runs_on_the_cpu_only(problem, fields):
    """No kernel forms |v| from v_world alone (K5 forms it from the DOFs), so
    off the CPU `world_speed`, and `detect` without speed and v_max, raise
    instead of running the plain version there."""
    _, tmesh, _ = problem
    tv = fields[3].to("meta")
    with pytest.raises(ValueError, match="velocity_to_world_and_speed"):
        recombine.world_speed(tv)
    with pytest.raises(ValueError, match="velocity_to_world_and_speed"):
        sing.detect_with_counts(tmesh, tv)


def test_counts_come_from_the_detection_kernel(problem, fields):
    """`detection_counts`, `compact_capacity` and `compact_all` size the
    compaction from the field's per-frame counts (K6's on CUDA), not by
    counting the masks again."""
    _, tmesh, _ = problem
    tfield, tcounts = fields[5], fields[6]
    assert tfield.counts.shape == (tfield.vertex_mask.shape[0], 2)
    np.testing.assert_array_equal(
        tfield.counts.numpy(),
        np.stack([tfield.vertex_mask.sum(1), tfield.interior_mask.sum(1)], -1))
    assert [int(c) for c in sing.detection_counts(tfield)] == tcounts.tolist()
    bigger = tfield._replace(counts=tfield.counts + 9)
    assert [int(c) for c in sing.detection_counts(bigger)] == [
        c + 9 for c in tcounts.tolist()]
    assert sing.compact_capacity(bigger) == sing.capacity_for(
        *(c + 9 for c in tcounts.tolist()))
    rows = sing.compact_all(tmesh, bigger, with_centers=True)
    want = sing.compact_all(tmesh, tfield, with_centers=True)
    for got, ref in zip(rows, want):
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[3], ref[3])


def test_zero_frame_detects_nothing(problem, fields):
    _, tmesh, _ = problem
    _, _, _, _, _, tfield, _ = fields
    assert not tfield.vertex_mask[-1].any() and not tfield.interior_mask[-1].any()
    field, counts = sing.detect_with_counts(
        tmesh, torch.zeros((2, tmesh.n_vertices, 3), dtype=torch.float64))
    assert counts.tolist() == [0, 0]
    assert not field.vertex_mask.any() and not field.interior_mask.any()
    assert bool(torch.isnan(field.v_max / field.v_max).all())


def test_empty_movie_counts_zero(problem):
    _, tmesh, _ = problem
    field, counts = sing.detect_with_counts(
        tmesh, torch.zeros((0, tmesh.n_vertices, 3), dtype=torch.float64))
    assert counts.tolist() == [0, 0]
    assert [int(c) for c in sing.detection_counts(field)] == [0, 0]
    assert sing.compact_capacity(field) == 8
    assert sing.compact_all(tmesh, field) == []


@pytest.mark.parametrize("capacity", [8, None])
def test_compact_detected_matches_jax(problem, fields, capacity):
    jmesh, tmesh, _ = problem
    _, jfield, _, _, _, tfield, _ = fields
    if capacity is None:
        capacity = sing.compact_capacity(tfield)
        assert capacity == jax_sing.compact_capacity(jfield)
    got = sing.compact_detected(tmesh, tfield, capacity=capacity)
    want = jax_sing.compact_detected(jmesh, jfield, capacity=capacity)
    for name in ("vertex_ids", "vertex_valid", "interior_ids", "interior_valid",
                 "interior_centers"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got.interior_points.numpy(),
                               np.asarray(want.interior_points),
                               rtol=POINT_TOL, atol=POINT_TOL, equal_nan=True)


@pytest.mark.parametrize("case", ["ties", "nan_queries", "truncated"])
def test_compact_detected_edge_cases_match_jax(case):
    """Compaction and snap against the JAX package on a flat unit grid:
    interior points at edge midpoints and cell centers, two or four
    vertices at one distance (the lowest index wins); a last frame of NaN
    points with nothing detected, as a frame with v_max = 0 gives (every
    center is vertex 0); more detections than the capacity (the first
    `capacity` ids)."""
    nx, ny, t = 9, 7, 4
    jmesh = jax_synthetic.plane_patch(nx=nx, ny=ny, lx=nx - 1.0, ly=ny - 1.0)
    tmesh = mesh_from_jax_arrays(jax_arrays(jmesh), device="cpu")
    n, m = tmesh.n_vertices, tmesh.n_triangles
    rng = np.random.default_rng(sum(map(ord, case)))
    share = 0.4 if case == "truncated" else 0.05
    vmask, imask = rng.random((t, n)) < share, rng.random((t, m)) < share
    corner = np.stack([rng.integers(0, nx - 1, (t, m)), rng.integers(0, ny - 1, (t, m))],
                      axis=-1)
    ipoint = np.concatenate([corner + [0.5, 0.0], np.zeros((t, m, 1))], axis=-1)
    ipoint[..., 1] += 0.5 * (rng.random((t, m)) < 0.5)
    if case == "nan_queries":
        ipoint[-1] = np.nan
        vmask[-1] = imask[-1] = False
    capacity = 4 if case == "truncated" else 16
    bary, v_max = np.zeros((t, m, 2)), np.ones(t)
    jfield = jax_sing.SingularityField(*(jnp.asarray(a) for a in (
        vmask, imask, bary, ipoint, v_max)))
    counts = np.stack([vmask.sum(1), imask.sum(1)], axis=-1).astype(np.int32)
    tfield = sing.SingularityField(*(torch.from_numpy(a) for a in (
        vmask, imask, bary, ipoint, v_max, counts)))
    got = sing.compact_detected(tmesh, tfield, capacity=capacity)
    want = jax_sing.compact_detected(jmesh, jfield, capacity=capacity)
    for name in ("vertex_ids", "vertex_valid", "interior_ids", "interior_valid",
                 "interior_centers", "interior_points"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    pts, centers = got.interior_points.numpy(), got.interior_centers.numpy()
    finite = np.isfinite(pts[..., 0])
    low = np.floor(pts[finite]).astype(np.int64)   # plane_patch: id = ix * ny + iy
    np.testing.assert_array_equal(centers[finite], low[:, 0] * ny + low[:, 1])
    if case == "nan_queries":
        assert not finite[-1].any() and (centers[-1] == 0).all()
    if case == "truncated":
        assert got.vertex_valid.all() and got.interior_valid.all()


def test_compact_all_and_frame_match_jax(problem, fields):
    jmesh, tmesh, _ = problem
    _, jfield, _, _, _, tfield, _ = fields
    got = sing.compact_all(tmesh, tfield, with_centers=True)
    want = jax_sing.compact_all(jmesh, jfield, with_centers=True)
    assert len(got) == len(want) == tfield.vertex_mask.shape[0]
    for (gp, gk, gi, gc), (wp, wk, wi, wc) in zip(got, want):
        np.testing.assert_allclose(gp, wp, rtol=POINT_TOL, atol=POINT_TOL)
        assert gk == wk and [int(i) for i in gi] == [int(i) for i in wi]
        np.testing.assert_array_equal(gc, wc)
    for k in (0, len(got) - 1):
        gp, gk, gi = sing.compact_frame(tmesh, tfield, k)
        wp, wk, wi = jax_sing.compact_frame(jmesh, jfield, k)
        np.testing.assert_allclose(gp, wp, rtol=POINT_TOL, atol=POINT_TOL)
        assert gk == wk and [int(i) for i in gi] == [int(i) for i in wi]


def test_closest_vertex_matches_jax(problem):
    jmesh, tmesh, _ = problem
    pts = np.asarray(jmesh.points)
    rng = np.random.default_rng(5)
    queries = pts[rng.integers(0, len(pts), 40)] + 0.3 * rng.standard_normal((40, 3))
    queries[:3] = pts[:3]                        # exact hits
    queries[3] = 0.5 * (pts[0] + pts[1])         # a tie: both at one distance
    got = topology.closest_vertex(tmesh.points, torch.from_numpy(queries))
    want = jax_topology.closest_vertex(jnp.asarray(pts), jnp.asarray(queries))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and int(got[3]) == 0


def test_edge_queries_match_jax(problem):
    jmesh, tmesh, _ = problem
    tris = np.asarray(jmesh.triangles)
    cells = np.repeat(np.arange(len(tris)), 3)
    va = tris.reshape(-1)
    vb = tris[:, [1, 2, 0]].reshape(-1)
    va = np.concatenate([va, [0]])               # (0, last) is no edge
    vb = np.concatenate([vb, [jmesh.n_vertices - 1]])
    cells = np.concatenate([cells, [0]])
    want = jax.vmap(jax_topology.other_cell_across_edge,
                    in_axes=(None, None, 0, 0, 0))(
        jmesh.edges, jmesh.edge_cells, jnp.asarray(cells), jnp.asarray(va),
        jnp.asarray(vb))
    got = topology.other_cell_across_edge(
        tmesh.edges, tmesh.edge_cells, torch.from_numpy(cells),
        torch.from_numpy(va), torch.from_numpy(vb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[-1]) == -1 and (got.numpy() == -1).sum() > 1  # boundary edges
    want_e = jax.vmap(jax_topology.edge_lookup, in_axes=(None, 0, 0))(
        jmesh.edges, jnp.asarray(va), jnp.asarray(vb))
    got_e = topology.edge_lookup(tmesh.edges, torch.from_numpy(va), torch.from_numpy(vb))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))


def test_bfs_and_geodesics_match_jax(problem):
    jmesh, tmesh, _ = problem
    for source in (0, 37):
        want = jax_topology.bfs_levels(jmesh.vertex_neighbors, source, 5)
        got = topology.bfs_levels(tmesh.vertex_neighbors, source, 5)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(
        topology.geodesic_distance_matrix(tmesh, [0, 37]),
        jax_topology.geodesic_distance_matrix(jmesh, np.array([0, 37])),
        rtol=1e-12)


def test_analysis_wrappers_check_inputs_and_count_nothing_on_cpu(problem, fields):
    _, tmesh, v_k = problem
    _, _, _, tv, speed, tfield, _ = fields
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="shape"):
        kan.recombine_speed(torch.from_numpy(v_k)[:, :-1].contiguous(), tmesh.basis)
    with pytest.raises(TypeError, match="float32 or float64"):
        kan.recombine_speed(torch.from_numpy(v_k).int(), tmesh.basis)
    with pytest.raises(TypeError, match="torch.int32"):
        kan.detect_singular(tmesh.points, tmesh.triangles.long(), tv, speed,
                            tfield.v_max, EPS)
    with pytest.raises(ValueError, match="capacity"):
        kan.compact_detected(tfield.vertex_mask, tfield.interior_mask,
                             tfield.interior_point, tmesh.points, 0)
    with pytest.raises(ValueError, match="share one device"):
        kan.recombine_speed(torch.from_numpy(v_k), tmesh.basis.to("meta"))
    f32 = kan.recombine_speed(torch.from_numpy(v_k).float(), tmesh.basis.float())
    assert f32[0].dtype == torch.float32
    assert rel_err(f32[0].numpy(), tv.numpy()) <= 1e-6
    assert kernels.LAUNCHES == before


# ------------------------------------------------------ classification ----
# Jacobians are compared on JAX's own velocity field and interior points:
# the finite differences divide by vertex offsets, so the 1e-12 and 1e-10
# differences of the two packages' recombination and detection would reach
# the Jacobians amplified. Codes, ids and valid flags are compared end to
# end, each package on its own field.
JAC_TOL = 1e-12


def _jax_inputs(fields):
    """JAX's v_world and detection field as the port's tensors."""
    jv, jfield, _, _, _, tfield, _ = fields
    field = sing.SingularityField(*(torch.from_numpy(np.array(x)) for x in jfield),
                                  counts=tfield.counts)
    return torch.from_numpy(np.array(jv)), field


def test_cells_across_edges_match_other_cell_across_edge(problem):
    _, tmesh, _ = problem
    table = topology.cells_across_edges(tmesh)
    assert table.dtype == torch.int32 and table.shape == (tmesh.n_triangles, 3)
    tris = tmesh.triangles
    cells = torch.arange(tmesh.n_triangles).repeat_interleave(3)
    want = topology.other_cell_across_edge(
        tmesh.edges, tmesh.edge_cells, cells, tris.reshape(-1),
        tris[:, [1, 2, 0]].reshape(-1))
    np.testing.assert_array_equal(table.reshape(-1).numpy(), want.numpy())
    assert (table == -1).any() and topology.cells_across_edges(tmesh) is table


@pytest.mark.parametrize("quirks", [False, True], ids=["quirks_off", "quirks_on"])
def test_classify_detected_matches_jax(problem, fields, quirks):
    jmesh, tmesh, _ = problem
    jv, jfield, _, tv, _, tfield, _ = fields
    cap = sing.compact_capacity(tfield)
    got = sing.classify_detected(tmesh, tv, tfield, capacity=cap, quirks=quirks)
    want = jax_sing.classify_detected(jmesh, jv, jfield, capacity=cap, quirks=quirks)
    for name in want._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.interior_valid.sum() > 0
    codes = np.concatenate([got.vertex_codes.numpy()[got.vertex_valid.numpy()],
                            got.interior_codes.numpy()[got.interior_valid.numpy()]])
    assert len(set(codes.tolist()) - {sing.INDETERMINATE}) >= 2
    for ok, codes, jac in ((got.vertex_valid, got.vertex_codes, got.vertex_jacobians),
                           (got.interior_valid, got.interior_codes,
                            got.interior_jacobians)):
        assert (codes[~ok] == sing.INDETERMINATE).all() and not jac[~ok].any()

    # The Jacobians of the valid slots, against JAX's full-field ones.
    v, field = _jax_inputs(fields)
    same = sing.classify_detected(tmesh, v, field, capacity=cap, quirks=quirks)
    jjv = np.asarray(jax_sing.vertex_jacobians(jmesh, jv, jfield.v_max))
    jji = np.asarray(jax_sing.interior_jacobians(
        jmesh, jv, jfield.v_max, jfield.interior_point, quirks=quirks))
    frames = np.arange(tv.shape[0])[:, None]
    for ids, ok, jac, full in ((same.vertex_ids, same.vertex_valid,
                                same.vertex_jacobians, jjv),
                               (same.interior_ids, same.interior_valid,
                                same.interior_jacobians, jji)):
        ok = ok.numpy()
        if ok.any():
            assert rel_err(jac.numpy()[ok], full[frames, ids.numpy()][ok]) <= JAC_TOL


@pytest.mark.parametrize("quirks", [False, True], ids=["quirks_off", "quirks_on"])
def test_full_field_jacobians_and_codes_match_jax(problem, fields, quirks):
    jmesh, tmesh, _ = problem
    jv, jfield, _, tv, _, tfield, _ = fields
    v, field = _jax_inputs(fields)
    last = slice(0, -1)  # the all-zero frame gives NaN everywhere
    want_v = np.asarray(jax_sing.vertex_jacobians(jmesh, jv, jfield.v_max))[last]
    got_v = sing.vertex_jacobians(tmesh, v, field.v_max).numpy()[last]
    assert rel_err(got_v, want_v) <= JAC_TOL
    want_i = np.asarray(jax_sing.interior_jacobians(
        jmesh, jv, jfield.v_max, jfield.interior_point, quirks=quirks))[last]
    got_i = sing.interior_jacobians(tmesh, v, field.v_max, field.interior_point,
                                    quirks=quirks).numpy()[last]
    # Triangles whose zero lies inside them: elsewhere the "interior point"
    # of the 2x2 solve is far outside and its offsets ill-conditioned.
    inside = np.asarray(jfield.interior_mask)[last]
    assert inside.sum() > 10
    assert rel_err(got_i[inside], want_i[inside]) <= JAC_TOL
    wv, wi = jax_sing.classify(jmesh, jv, jfield, quirks=quirks)
    for inputs in ((v, field), (tv, tfield)):
        cv, ci = sing.classify(tmesh, *inputs, quirks=quirks)
        np.testing.assert_array_equal(cv.numpy()[last], np.asarray(wv)[last])
        np.testing.assert_array_equal(ci.numpy()[last][inside],
                                      np.asarray(wi)[last][inside])
    e = np.asarray(jmesh.points)[np.asarray(jmesh.triangles)]
    w = np.random.default_rng(11).dirichlet((1.0, 1.0, 1.0), size=len(e))
    q = np.einsum("mc,mcd->md", w, e)
    got = sing._nearest_edge(*(torch.from_numpy(a) for a in (q, e[:, 0], e[:, 1],
                                                              e[:, 2])), quirks)
    want = jax_sing._nearest_edge(q, e[:, 0], e[:, 1], e[:, 2], quirks=quirks)
    # Quirk mode takes the argmin of 9 cross-product components; on this
    # patch some are zero up to rounding (edges along the grid axes), and
    # those near-ties are left out: the two packages round them apart.
    a, b = e[:, [0, 1, 2]], e[:, [1, 2, 0]]
    c = np.cross(q[:, None] - a, b - a) / np.linalg.norm(b - a, axis=-1)[..., None]
    d = np.sort(np.abs(c).reshape(len(e), -1) if quirks
                else np.linalg.norm(c, axis=-1), axis=-1)
    clear = d[:, 1] - d[:, 0] > 1e-12
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got.numpy()[clear], np.asarray(want)[clear])


def _wheel(spokes: int = 14):
    """A hub of `spokes` neighbours inside two rings (the outer one twice as
    fine), on a bumped cone: the hub's 1-ring is wider than 8."""
    ang1 = 2.0 * np.pi * np.arange(spokes) / spokes
    ang2 = 2.0 * np.pi * (np.arange(2 * spokes) + 0.5) / (2 * spokes)
    ring = [np.stack([r * np.cos(a), 0.8 * r * np.sin(a),
                      0.3 * r + 0.1 * np.cos(3.0 * a)], axis=-1)
            for r, a in ((1.0, ang1), (2.1, ang2))]
    points = np.concatenate([np.zeros((1, 3)), *ring])
    k = np.arange(spokes)
    r1 = 1 + k
    r1n = 1 + (k + 1) % spokes
    r2 = 1 + spokes + 2 * k
    r2n = 1 + spokes + (2 * k + 1)
    r2nn = 1 + spokes + (2 * k + 2) % (2 * spokes)
    tris = np.concatenate([
        np.stack([np.zeros(spokes, dtype=np.int64), r1, r1n], axis=-1),
        np.stack([r1, r2, r2n], axis=-1), np.stack([r1, r2n, r1n], axis=-1),
        np.stack([r1n, r2n, r2nn], axis=-1)])
    return points, tris


@pytest.mark.parametrize("quirks", [False, True], ids=["quirks_off", "quirks_on"])
def test_classify_detected_on_wide_one_rings_matches_jax(quirks):
    """The plain classification (K12's plain version) against JAX's
    classify_detected on a mesh whose hub has 14 neighbours: random seeded
    velocities, the hub's set to zero in every other frame (a vertex
    candidate with the 14-neighbour ring); slots, codes and valid flags
    equal, and the valid slots' Jacobians within 1e-12 of JAX's full-field
    ones (the same float64 formulas, summed in another order)."""
    from manifold_flow_tpu.geometry.mesh import build_mesh as jax_build_mesh

    points, tris = _wheel()
    jmesh = jax_build_mesh(points, tris, dtype=np.float64)
    tmesh = mesh_from_jax_arrays(jax_arrays(jmesh), device="cpu")
    assert tmesh.vertex_neighbors.shape[1] == 14
    v = np.random.default_rng(14).standard_normal((8, tmesh.n_vertices, 3))
    v[::2, 0] = 0.0
    jv = jnp.asarray(v)
    jfield, _ = jax_sing.detect_with_counts(jmesh, jv, eps=EPS)
    tv = torch.from_numpy(v)
    tfield, _ = sing.detect_with_counts(tmesh, tv, eps=EPS)
    cap = sing.compact_capacity(tfield)
    got = sing.classify_detected(tmesh, tv, tfield, capacity=cap, quirks=quirks)
    want = jax_sing.classify_detected(jmesh, jv, jfield, capacity=cap, quirks=quirks)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    hub = (got.vertex_ids == 0) & got.vertex_valid
    assert int(hub.sum()) == 4 and int(got.interior_valid.sum()) > 0
    jjv = np.asarray(jax_sing.vertex_jacobians(jmesh, jv, jfield.v_max))
    jji = np.asarray(jax_sing.interior_jacobians(
        jmesh, jv, jfield.v_max, jfield.interior_point, quirks=quirks))
    frames = np.arange(v.shape[0])[:, None]
    for ids, ok, jac, full in ((got.vertex_ids, got.vertex_valid, got.vertex_jacobians, jjv),
                               (got.interior_ids, got.interior_valid,
                                got.interior_jacobians, jji)):
        ok = ok.numpy()
        assert rel_err(jac.numpy()[ok], full[frames, ids.numpy()][ok]) <= JAC_TOL


def test_classify_without_detections(problem):
    _, tmesh, _ = problem
    v = torch.zeros((2, tmesh.n_vertices, 3), dtype=torch.float64)
    field = sing.detect(tmesh, v)
    got = sing.classify_detected(tmesh, v, field, capacity=8)
    assert not got.vertex_valid.any() and not got.interior_valid.any()
    assert (got.vertex_codes == sing.INDETERMINATE).all()
    assert (got.interior_codes == sing.INDETERMINATE).all()
    empty = torch.zeros((0, tmesh.n_vertices, 3), dtype=torch.float64)
    got = sing.classify_detected(tmesh, empty, sing.detect(tmesh, empty), capacity=8)
    assert got.vertex_codes.shape == (0, 8) and got.interior_jacobians.shape == (0, 8, 2, 2)


def test_far_detections_come_from_the_method_not_the_port():
    """ROADMAP C11. On the bench problem's surface (bench.py:26-38, 3136
    vertices) the nearest detection lies up to ~7 grid cells from a true
    source in velocity frames 50-69 of the 98-frame two-source movie. On
    frames 63-69 both packages' refined solves (tol 1e-6, lambda 0.01) and
    detections give the same ids, kinds and snapped centers, points within
    1e-6 (the solves agree to ~1e-8), and the same distances from each true
    source to its nearest detection: the far-off detections are the
    method's, not the port's."""
    jmesh = jax_synthetic.plane_patch(
        nx=56, ny=56, lx=60.0, ly=60.0,
        height=lambda x, y: 6.0 * np.sin(x / 12.0) * np.cos(y / 15.0), dtype=np.float64)
    pot, times, truth = jax_synthetic.two_source_movie(
        jmesh, sources=((15.0, 15.0), (45.0, 45.0)), n_frames=98, speed=24.0,
        wavelength=24.0, dt=1.0 / 512.0, dtype=np.float64)
    pot, times, truth = np.asarray(pot)[63:71], np.asarray(times)[63:71], np.asarray(truth)
    kw = dict(lambda_=0.01, method="refined", tol=1e-6, max_iter=4000)
    jres = jax_cvf(jmesh, jnp.asarray(pot), jnp.asarray(times), **kw)
    jv = jax_recombine.velocity_to_world(jres.v_k, jmesh.basis)
    want = jax_sing.compact_all(jmesh, jax_sing.detect(jmesh, jv, eps=EPS), with_centers=True)
    tmesh = mesh_from_jax_arrays(jax_arrays(jmesh), device="cpu")
    tres = compute_velocity_fields(tmesh, torch.from_numpy(pot), torch.from_numpy(times), **kw)
    tv, speed, v_max = recombine.velocity_to_world_and_speed(tres.v_k, tmesh.basis)
    got = sing.compact_all(tmesh, sing.detect(tmesh, tv, eps=EPS, speed=speed, v_max=v_max),
                           with_centers=True)
    assert bool(np.asarray(jres.converged).all()) and bool(tres.converged.all())
    assert len(got) == len(want) == 7
    for (gp, gk, gi, gc), (wp, wk, wi, wc) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
        np.testing.assert_array_equal(np.asarray(gk), np.asarray(wk))
        np.testing.assert_array_equal(np.asarray(gc), np.asarray(wc))
        np.testing.assert_allclose(np.asarray(gp), np.asarray(wp), rtol=0, atol=1e-6)

    def nearest(rows):  # grid cells from each true source to its nearest detection
        return np.array([[np.linalg.norm(np.asarray(p).reshape(-1, 3) - src, axis=-1).min()
                          / (60.0 / 55.0) for src in truth] for p, *_ in rows])
    far = nearest(want)
    np.testing.assert_allclose(nearest(got), far, rtol=0, atol=1e-6)
    assert far.max() > 6.5
