"""The port's winding op (ops/winding.py: ring tables in torch, K15's plain
version on the CPU) held against the JAX package.

The mesh is a generic bumpy patch and the movie a seeded set of sources,
vortices, saddles and spirals with a little noise. Winding numbers agree to
1e-9 (the port adds each ring's angles in K15's order, a warp's lanes
striding over the ring and a fixed tree closing their sums; JAX differences
two prefix sums); ring counts, types and the scale map are equal. On
synthetic rings of 0 to 300 members the plain version's order is held
against math.fsum of the same angles.
"""

import math

import numpy as np
import pytest
import torch

from manifold_flow_tpu.geometry import synthetic as jax_synthetic
from manifold_flow_tpu.geometry import topology as jax_topology
from manifold_flow_tpu.ops import winding as jax_wind
from manifold_flow_tpu_torch import kernels, mesh_from_jax_arrays
from manifold_flow_tpu_torch.geometry.topology import bfs_levels, closest_vertex
from manifold_flow_tpu_torch.kernels import winding as kwi
from manifold_flow_tpu_torch.ops import winding as wind
from tests.torch_parity import jax_arrays
from tests.torch_rings import RING_SIZES, synthetic_rings

W_TOL = 1e-9
LEVELS = 6
# plain_winding_profile against math.fsum of the same angles, relative to
# max(1, |w|): a ring's sum of up to 300 angles in [-pi, pi] in the kernel's
# order rounds by at most ~300 ulp of its largest partial sum, and numpy's
# and torch's arccos may differ by an ulp.
SUM_TOL = 1e-12


@pytest.fixture(scope="module")
def problem():
    jmesh = jax_synthetic.plane_patch(
        nx=17, ny=15, lx=8.0, ly=7.0,
        height=lambda x, y: 0.45 * np.sin(1.1 * x + 0.3) * np.cos(0.8 * y - 0.5))
    pts = np.asarray(jmesh.points)
    rng = np.random.default_rng(9)
    frames, points = [], []
    for kind in ("source", "vortex", "saddle", "spiral"):
        c = rng.uniform([3.0, 2.8, 0.0], [5.0, 4.2, 0.0])
        d = pts - c
        zero = np.zeros(len(d))
        field = {"source": np.stack([d[:, 0], d[:, 1], zero], -1),
                 "vortex": np.stack([-d[:, 1], d[:, 0], zero], -1),
                 "saddle": np.stack([d[:, 0], -d[:, 1], zero], -1),
                 "spiral": np.stack([d[:, 0] - d[:, 1], d[:, 0] + d[:, 1], zero], -1)}
        frames.append(field[kind] + 0.02 * rng.standard_normal(d.shape))
        c[2] = pts[np.argmin(((pts[:, :2] - c[:2]) ** 2).sum(-1)), 2]
        points.append([c, pts[rng.integers(len(pts))] + 0.01, np.zeros(3)])
    v = np.stack(frames)
    points = np.asarray(points)
    valid = np.array([[True, True, False]] * len(frames))
    valid[1, 1] = False
    return jmesh, mesh_from_jax_arrays(jax_arrays(jmesh), device="cpu"), v, points, valid


def test_winding_profile_matches_jax(problem):
    jmesh, tmesh, v, points, _ = problem
    for k in range(v.shape[0]):
        center = int(closest_vertex(tmesh.points, torch.from_numpy(points[k, 0])))
        got = wind.winding_profile(tmesh, torch.from_numpy(v[k]), center, LEVELS)
        want = np.asarray(jax_wind.winding_profile(jmesh, v[k], center, LEVELS))
        assert np.abs(got.numpy() - want).max() <= W_TOL
        assert abs(abs(float(got[0])) - 1.0) < 0.01  # a real singularity


@pytest.mark.parametrize("with_centers", [False, True], ids=["host_snap", "centers"])
def test_analyze_singularities_movie_matches_jax(problem, with_centers):
    jmesh, tmesh, v, points, valid = problem
    centers = None
    if with_centers:
        centers = closest_vertex(tmesh.points, torch.from_numpy(points)).numpy()
    want = jax_wind.analyze_singularities_movie(jmesh, v, points, valid, LEVELS,
                                                centers=centers)
    kernels.reset_launches()
    got = wind.analyze_singularities_movie(tmesh, torch.from_numpy(v), points, valid,
                                           LEVELS, centers=centers)
    assert set(kernels.LAUNCHES.values()) == {0}
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.types.numpy(), np.asarray(want.types))
    assert np.abs(got.winding_numbers.numpy()
                  - np.asarray(want.winding_numbers)).max() <= W_TOL
    counts, types = got.counts.numpy(), got.types.numpy()
    assert counts[:, 0].min() >= 2 and set(types[:, 0].tolist()) == {1, -1}
    assert (counts[~valid] == 0).all() and (types[~valid] == 0).all()
    uniq, u_idx = wind.snap_and_dedup_centers(tmesh, points, valid, centers)
    wuniq, wu_idx = jax_wind.snap_and_dedup_centers(jmesh, points, valid, centers)
    np.testing.assert_array_equal(uniq, np.unique(np.asarray(wuniq)))
    np.testing.assert_array_equal(uniq[u_idx][valid], np.asarray(wuniq)[wu_idx][valid])


def test_single_frame_analysis_and_scale_map_match_jax(problem):
    jmesh, tmesh, v, points, valid = problem
    for k in (0, 2):
        got = wind.analyze_singularities(tmesh, torch.from_numpy(v[k]),
                                         torch.from_numpy(points[k]),
                                         torch.from_numpy(valid[k]), LEVELS)
        want = jax_wind.analyze_singularities(jmesh, v[k], points[k], valid[k], LEVELS)
        np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
        np.testing.assert_array_equal(got.types.numpy(), np.asarray(want.types))
        assert np.abs(got.winding_numbers.numpy()
                      - np.asarray(want.winding_numbers)).max() <= W_TOL
    counts = np.array([3, 0, 5, 2])
    got = wind.scale_map(tmesh, points[:, 0], counts)
    want = np.asarray(jax_wind.scale_map(jmesh, points[:, 0], counts))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int((got > 0).sum()) > 10
    empty = wind.scale_map(tmesh, np.zeros((0, 3)), np.zeros(0, np.int32))
    assert empty.shape == (tmesh.n_vertices,) and not empty.any()


def test_ring_tables_and_helpers_match_jax(problem):
    jmesh, tmesh, v, points, _ = problem
    centers = closest_vertex(tmesh.points, torch.from_numpy(points[:, 0]))
    tabs = wind.ring_tables(tmesh, centers, LEVELS, torch.float64)
    for i, c in enumerate(centers.tolist()):
        want = jax_wind._ring_tables(jmesh, c, LEVELS, np.float64)
        bounds = np.asarray(want.bounds)
        np.testing.assert_array_equal(tabs.bounds[i].numpy(), bounds)
        np.testing.assert_array_equal(tabs.order[i, :bounds[-1]].numpy(),
                                      np.asarray(want.order)[:bounds[-1]])
        np.testing.assert_array_equal(
            bfs_levels(tmesh.vertex_neighbors, centers, LEVELS)[i],
            bfs_levels(tmesh.vertex_neighbors, c, LEVELS))
        np.testing.assert_array_equal(
            bfs_levels(tmesh.vertex_neighbors, c, LEVELS).numpy(),
            np.asarray(jax_topology.bfs_levels(jmesh.vertex_neighbors, c, LEVELS)))
    # One ring by the reference's direct formula.
    rng = np.random.default_rng(3)
    uv, vxy = rng.standard_normal((2, 12, 2))
    mask = np.arange(12) < 9
    got = wind.ring_winding_number(*(torch.from_numpy(a) for a in (uv, vxy, mask)))
    want = jax_wind.ring_winding_number(uv, vxy, mask)
    assert abs(float(got) - float(want)) <= W_TOL
    w = torch.tensor([[1.0, 1.0005, 0.999, 1.01, 1.0], [-1.0, -1.0, -1.0, -1.0, -1.0],
                      [0.5, 1.0, 1.0, 1.0, 1.0], [0.995, 1.0, 1.0, 2.0, 1.0]],
                     dtype=torch.float64)
    count, typ = kwi.count_and_type(w)
    wc, wt = zip(*(jax_wind._count_and_type(row) for row in w.numpy()))
    np.testing.assert_array_equal(count.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(typ.numpy(), np.asarray(wt))


def test_movie_without_singularities(problem):
    _, tmesh, v, points, valid = problem
    res = wind.analyze_singularities_movie(tmesh, torch.from_numpy(v), points,
                                           np.zeros_like(valid), LEVELS)
    assert res.counts.shape == valid.shape and not res.counts.any()
    assert res.winding_numbers.shape == valid.shape + (LEVELS,)
    res = wind.analyze_singularities_movie(tmesh, torch.from_numpy(v[:0]),
                                           points[:0], valid[:0], LEVELS)
    assert res.counts.shape == (0, 3)
    with pytest.raises(ValueError, match="at least one ring"):
        kwi.winding_profile(torch.from_numpy(v), torch.zeros((1, 4), dtype=torch.int32),
                            torch.zeros((1, 1), dtype=torch.int32),
                            torch.zeros((1, 3), dtype=torch.float64),
                            torch.zeros((1, 3), dtype=torch.float64))


def _fsum_profile(v, order, bounds, e1, e2):
    """Winding numbers (U, T, L) of the ring tables by math.fsum of each
    ring's signed angles (member to member, the last to the first), the
    unit directions as ops/winding.py:138-151 forms them, in numpy."""
    n = np.cross(e1, e2)
    out = np.zeros((order.shape[0], v.shape[0], bounds.shape[1] - 1))
    for c in range(order.shape[0]):
        vs = v[:, order[c]]                                         # (T, R, 3)
        nn = n[c] @ n[c]
        s = (vs @ n[c]) / nn if nn > 0 else np.zeros(vs.shape[:2])
        proj = vs - s[..., None] * n[c]
        a = (proj @ e1[c]) / (e1[c] @ e1[c])
        b = (proj @ e2[c]) / (e2[c] @ e2[c])
        nrm = np.sqrt(a * a + b * b)
        den = np.where(nrm > 0, nrm, 1.0)
        ux, uy = a / den, b / den
        for r, (lo, hi) in enumerate(zip(bounds[c, :-1], bounds[c, 1:])):
            if hi - lo < 2:
                continue
            j = np.arange(lo, hi)
            k = np.roll(j, -1)
            dot = np.clip(ux[:, j] * ux[:, k] + uy[:, j] * uy[:, k], -1.0, 1.0)
            ang = np.arccos(dot)
            ang = np.where(ux[:, j] * uy[:, k] - uy[:, j] * ux[:, k] < 0, -ang, ang)
            out[c, :, r] = [math.fsum(row) / (2.0 * math.pi) for row in ang]
    return out


@pytest.mark.parametrize("levels", [1, 40])
def test_plain_ring_sums_match_fsum(levels):
    """Rings of 0, 1, 2, 31, 32, 33 and 300 members (one and more than one
    chunk of a warp's lanes), at 1 and 40 rings: w within SUM_TOL of fsum,
    counts and types those of the fsum profile."""
    args = synthetic_rings("cpu", torch.float64, levels, seed=80 + levels)
    assert {int(x) for x in (args[2][:, 1:] - args[2][:, :-1]).flatten()} <= set(RING_SIZES)
    counts, types, w = kwi.plain_winding_profile(*args)
    want = _fsum_profile(*(a.numpy() for a in args))
    assert (np.abs(w.numpy() - want) / np.maximum(1.0, np.abs(want))).max() <= SUM_TOL
    want_counts, want_types = kwi.count_and_type(torch.from_numpy(want))
    assert torch.equal(counts, want_counts) and torch.equal(types, want_types)
    assert types[:2, 0].tolist() == [1, -1]


def test_ring_sums_follow_the_kernel_order():
    """ring_sums adds in K15's order, bit for bit: lane l of a ring's warp
    adds its members l, l + 32, ... in turn, then lane i adds lane i + 16,
    i + 8, ..., i + 1 (common.cuh warp_sum), read at lane 0."""
    rng = np.random.default_rng(7)
    sizes = np.array([[0, 1, 2, 31, 32, 33, 300], [300, 33, 32, 31, 2, 1, 0]])
    bounds = np.concatenate([np.zeros((2, 1), int), np.cumsum(sizes, 1)], 1)
    angle = rng.uniform(-np.pi, np.pi, (2, 3, int(bounds[:, -1].max())))
    got = kwi.ring_sums(torch.from_numpy(angle), torch.from_numpy(bounds).to(torch.int32))
    for c in range(2):
        for f in range(3):
            for r in range(sizes.shape[1]):
                part = [0.0] * 32
                for j in range(sizes[c, r]):
                    part[j % 32] += float(angle[c, f, bounds[c, r] + j])
                for off in (16, 8, 4, 2, 1):
                    part = [part[i] + part[i + off] for i in range(off)]
                assert float(got[c, f, r]) == part[0]
