"""The solve on a locality-ordered copy of the mesh (geometry.order): the
order itself, the renumbered mesh and its coarse tables, and
compute_velocity_fields, which solves on that copy and hands the velocity
back in the mesh's own order.

Two meshes: the surface S1 reconstructs from the benchmark's curved 8 x 8
grid (`flowbench/configs/recon3k.json`: 3697 vertices, 15 tiles of K1, ids
in the butterfly passes' order) and a small bumped plane patch (1200
vertices, 5 tiles). This file imports no JAX.

Tolerances, each with its reason:
  * the renumbered solve against the same solve on the mesh as it is,
    which the test builds from build_rhs, make_operator, the
    preconditioner and solve_cg: 1e-9 of max|v| at tol 1e-12 in float64
    (4e-13 read on the S1 surface): the two are one system in two orders,
    whose sums round differently, and both stop within rounding of its
    solution;
  * their iteration counts within 2 (tests/test_torch_solve.py's slack):
    the reduction orders differ, which can move the last iteration's test;
    on the S1 surface a one-ulp change of f alone moves the two-level count
    by 2 at tol 1e-9;
  * the relabelled two-level preconditioner applied to a permuted residual
    against the original's applied to the residual: 1e-12 of max|z| (1.5e-15
    read): the same aggregates, seeds and coarse matrices, summed in other
    orders.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from flowbench import inputs
from manifold_flow_tpu_torch.fem import assembly
from manifold_flow_tpu_torch.fem.operator import block_jacobi_inverse, make_operator
from manifold_flow_tpu_torch.geometry import order, synthetic
from manifold_flow_tpu_torch.geometry.mesh import build_mesh
from manifold_flow_tpu_torch.solve import api, coarse
from manifold_flow_tpu_torch.solve.cg import solve_cg

REPO = Path(__file__).resolve().parent.parent
TILE = assembly.TILE_VERTICES
LAMBDA = 0.01
TOL = 1e-12
ITER_SLACK = 2


@pytest.fixture(scope="module")
def s1_surface():
    config = json.loads((REPO / "flowbench" / "configs" / "recon3k.json").read_text())
    points, tris, _ = inputs.surface_and_electrodes(config)
    return build_mesh(points, tris, device="cpu")


@pytest.fixture(scope="module")
def patch():
    return synthetic.plane_patch(
        nx=40, ny=30, lx=20.0, ly=15.0, device="cpu",
        height=lambda x, y: 0.8 * np.sin(0.5 * x + 0.3) * np.cos(0.4 * y - 0.1))


@pytest.fixture(params=["s1_surface", "patch"])
def mesh(request):
    return request.getfixturevalue(request.param)


def movie(mesh, n_frames):
    """Two plane waves crossing the surface at 512 Hz: (T, N) and (T,)."""
    p = mesh.points.numpy()
    t = np.arange(n_frames) / 512.0
    pot = (np.sin(0.3 * p[None, :, 0] - 40.0 * t[:, None])
           + 0.5 * np.cos(0.2 * p[None, :, 1] + 0.1 * p[None, :, 2] + 25.0 * t[:, None]))
    return torch.tensor(pot), torch.tensor(t)


def listing(mesh) -> float:
    """K1's listed cells over the mesh's: its tiles' listing factor."""
    return assembly.mesh_cell_tiles(mesh).cells.numel() / mesh.n_triangles


def new_dofs(local):
    n = local.vertices.numel()
    return torch.cat([local.vertices, local.vertices + n])


def test_order_is_a_permutation_into_leaves_of_a_tile(mesh):
    local = order.local_mesh(mesh)
    o = local.order
    n, m = mesh.n_vertices, mesh.n_triangles
    assert local.mesh is not mesh
    np.testing.assert_array_equal(np.sort(o.vertex_order), np.arange(n))
    np.testing.assert_array_equal(np.sort(o.cell_order), np.arange(m))
    np.testing.assert_array_equal(o.vertex_rank[o.vertex_order], np.arange(n))
    # Each tile is one leaf, which keeps the mesh's order: its old ids ascend.
    for start in range(0, n, TILE):
        tile = o.vertex_order[start: start + TILE]
        assert np.all(np.diff(tile) > 0), start
    # Cells by their smallest new vertex id.
    tris = local.mesh.triangles.numpy()
    assert np.all(np.diff(tris.min(axis=1)) >= 0)
    np.testing.assert_array_equal(local.vertices.numpy(), o.vertex_order)
    np.testing.assert_array_equal(local.dofs.numpy()[:n], o.vertex_rank)
    np.testing.assert_array_equal(local.dofs.numpy()[n:], o.vertex_rank + n)


@pytest.mark.parametrize("shape,leaf", [((16, 16), 16), ((8, 16), 8), ((23, 1), 5)])
def test_bisection_leaves_are_blocks_of_a_grid(shape, leaf):
    """On a shuffled grid every leaf is a compact block: splits along the
    longest extent, at multiples of the leaf size."""
    nx, ny = shape
    gx, gy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    grid = np.stack([gx.ravel(), gy.ravel()], axis=-1)
    shuffle = np.random.default_rng(7).permutation(grid.shape[0])
    points = np.concatenate([grid[shuffle], np.zeros((grid.shape[0], 1))], axis=1)
    perm = order.bisection_order(points, leaf)
    np.testing.assert_array_equal(np.sort(perm), np.arange(grid.shape[0]))
    # The block the splits cut for `leaf` grid points; the last leaf, the
    # only one that may hold fewer, a run of the line.
    block = {16: (4, 4), 8: (2, 4), 5: (1, 5)}[leaf]
    for start in range(0, perm.size, leaf):
        pts = points[perm[start: start + leaf], :2]
        extent = tuple(sorted(pts.max(axis=0) - pts.min(axis=0) + 1))
        assert extent == (block if len(pts) == leaf else (1, len(pts))), (start, extent)


def test_a_mesh_of_one_tile_keeps_its_vertex_ids():
    """One tile is one leaf: the vertices keep their ids, the cells are
    sorted by their smallest id, and the copy is built once per mesh."""
    small = synthetic.plane_patch(nx=16, ny=16, device="cpu")
    local = order.local_mesh(small)
    np.testing.assert_array_equal(local.order.vertex_order, np.arange(small.n_vertices))
    np.testing.assert_array_equal(
        local.mesh.triangles.numpy(),
        small.triangles.numpy()[np.argsort(small.triangles.numpy().min(axis=1),
                                           kind="stable")])
    assert torch.equal(local.mesh.points, small.points)
    assert order.local_mesh(small) is local


def test_renumbered_mesh_holds_the_same_values(mesh):
    local = order.local_mesh(mesh)
    o, new = local.order, local.mesh
    v, c = torch.from_numpy(o.vertex_order), torch.from_numpy(o.cell_order)
    for name in ("points", "normals", "basis"):
        assert torch.equal(getattr(new, name), getattr(mesh, name)[v]), name
    for name in ("areas", "grad_w", "integrals"):
        assert torch.equal(getattr(new, name), getattr(mesh, name)[c]), name
    # The same triangles, corners in place, under the new ids.
    np.testing.assert_array_equal(o.vertex_order[new.triangles.numpy()],
                                  mesh.triangles.numpy()[o.cell_order])
    assert torch.equal(new.boundary_vertex, mesh.boundary_vertex[v])
    assert torch.equal(new.vertex_degree, mesh.vertex_degree[v])
    assert torch.equal(new.vertex_cell_count, mesh.vertex_cell_count[v])
    assert new.edges.shape == mesh.edges.shape


def test_k1_tiles_list_few_cells_on_the_renumbered_s1_surface(s1_surface, patch):
    s1 = order.local_mesh(s1_surface).mesh
    assert listing(s1_surface) >= 2.0
    assert listing(s1) <= 1.3
    assert listing(order.local_mesh(patch).mesh) <= listing(patch)


def test_relabelled_aggregation_is_the_meshs_own(mesh):
    local = order.local_mesh(mesh)
    rank = local.order.vertex_rank
    tables = coarse.build_tables(mesh)
    moved = coarse.relabelled_tables(local.mesh, tables, local.order)
    agg, agg_new = tables.agg.numpy(), moved.agg.numpy()
    np.testing.assert_array_equal(agg_new[rank], agg)
    np.testing.assert_array_equal(moved.seeds.numpy(), rank[tables.seeds.numpy()])
    assert moved.n_coarse == tables.n_coarse
    for a in range(tables.n_coarse):
        members = tables.members.numpy()[a]
        members_new = moved.members.numpy()[a]
        assert (sorted(rank[members[members < mesh.n_vertices]])
                == list(members_new[members_new < mesh.n_vertices])), a
    assert coarse.relabelled_tables(local.mesh, tables, local.order) is moved


def test_relabelled_two_level_is_the_same_preconditioner(mesh):
    local = order.local_mesh(mesh)
    pot, times = movie(mesh, 4)
    dofs = new_dofs(local)
    g, _ = api.build_rhs(mesh, pot, times)
    g_new, _ = api.build_rhs(local.mesh, pot[:, local.vertices], times)
    tables = coarse.build_tables(mesh)
    pre = coarse.make_two_level(mesh, g, LAMBDA, tables)
    pre_new = coarse.make_two_level(
        local.mesh, g_new, LAMBDA,
        coarse.relabelled_tables(local.mesh, tables, local.order))
    r = torch.randn(3, mesh.n_dof, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    z = pre.apply(r)
    z_new = pre_new.apply(r[:, dofs])
    assert float((z_new - z[:, dofs]).abs().max()) <= 1e-12 * float(z.abs().max())


@pytest.mark.parametrize("precond", ["jacobi", "two_level"])
def test_velocity_comes_back_in_the_mesh_order(mesh, precond):
    pot, times = movie(mesh, 5)
    res = api.compute_velocity_fields(mesh, pot, times, lambda_=LAMBDA, method="cg",
                                      tol=TOL, max_iter=4000, precond=precond)
    # The same solve with the order left out.
    g, f = api.build_rhs(mesh, pot, times)
    pre = (block_jacobi_inverse(mesh, g, LAMBDA) if precond == "jacobi" else
           coarse.make_two_level(mesh, g, LAMBDA, coarse.build_tables(mesh)))
    want = solve_cg(make_operator(mesh, g, LAMBDA), f, pre, tol=TOL, max_iter=4000)
    assert bool(res.converged.all()) and bool(want.converged.all())
    assert res.e is mesh.basis
    assert abs(res.iterations - want.iterations) <= ITER_SLACK
    scale = float(want.x.abs().max())
    assert float((res.v_k - want.x).abs().max()) <= 1e-9 * scale
    assert torch.allclose(res.residual, want.residual, rtol=0.5, atol=0.0)


def test_chunked_movie_equals_its_windows(patch):
    """A movie of more than FRAME_CHUNK_AUTO_MIN velocity frames is solved
    in windows on the renumbered mesh: equal, bit for bit, to its windows
    solved one by one, each renumbered on its own."""
    pot, times = movie(patch, api.FRAME_CHUNK_AUTO_MIN + 3)
    t_v = pot.shape[0] - 1
    chunk = api.FRAME_CHUNK_SIZE
    kw = dict(lambda_=LAMBDA, method="cg", tol=1e-8, precond="two_level")
    whole = api.compute_velocity_fields(patch, pot, times, **kw)
    parts = []
    for j in range(-(-t_v // chunk)):
        start = min(j * chunk, t_v - chunk)
        res = api.compute_velocity_fields(patch, pot[start: start + chunk + 1],
                                          times[start: start + chunk + 1],
                                          frame_chunk=None, **kw)
        parts.append(res.v_k[j * chunk - start: min((j + 1) * chunk, t_v) - start])
    assert len(parts) == 2
    assert torch.equal(whole.v_k, torch.cat(parts))
    assert whole.e is patch.basis and bool(whole.converged.all())
