"""FEM assembly and operator of the PyTorch port held against the JAX package.

Both packages compute on one mesh (carried across with mesh_from_jax_arrays)
and one seeded movie. Tolerances, relative to the largest entry of the
reference output:
  * float64 assembly (frame factors, a2 blocks, RHS, Jacobi blocks): 1e-12,
    since both evaluate the same f64 formulas in other reduction orders;
  * the float64 matvec: 1e-13, for the same reason, with sums of at most six
    local contributions per vertex;
  * the float32 matvec: 1e-5 (a few f32 ulps of the largest output, from the
    einsum order of the 6x6 block product);
  * the float32 Jacobi inverse: 1e-5, as above;
  * the port's float64 residual f - A x against the JAX two-float32 residual:
    1e-12 of max|f| + max|Ax|, the DF arithmetic's own accuracy (~2^-48)
    with headroom, where the port computes in native f64.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manifold_flow_tpu.fem import assembly as jax_assembly
from manifold_flow_tpu.fem import operator as jax_operator
from manifold_flow_tpu.fem.df_operator import make_df_operator
from manifold_flow_tpu.kernels import df32
from manifold_flow_tpu.solve.api import build_rhs as jax_build_rhs
from manifold_flow_tpu_torch import kernels, mesh_from_jax_arrays
from manifold_flow_tpu_torch.fem import assembly, operator
from manifold_flow_tpu_torch.geometry import synthetic as torch_synthetic
from manifold_flow_tpu_torch.kernels import fem as kfem
from manifold_flow_tpu_torch.solve.api import build_rhs
from tests.torch_parity import LAMBDA, jax_arrays, jmesh, rel_err, wave  # noqa: F401

F64 = 1e-12
MATVEC_F64 = 1e-13
F32 = 1e-5


@pytest.fixture(scope="module")
def port_mesh(jmesh):  # noqa: F811
    return mesh_from_jax_arrays(jax_arrays(jmesh), device="cpu")


@pytest.fixture(scope="module")
def systems(jmesh, port_mesh, wave):  # noqa: F811
    """JAX operator and RHS, and the port's g, f and operator, in f64."""
    pot, times = wave
    jop = jax_operator.make_operator(jmesh, jnp.asarray(pot), LAMBDA)
    jf = jax_build_rhs(jmesh, jop, jnp.asarray(pot), jnp.asarray(times))
    g, f = build_rhs(port_mesh, torch.from_numpy(pot), torch.from_numpy(times))
    op = operator.make_operator(port_mesh, g, LAMBDA)
    return jop, np.asarray(jf), g, f, op


def test_tables_match_jax(jmesh, port_mesh):  # noqa: F811
    np.testing.assert_array_equal(assembly.local_dof_indices(port_mesh).numpy(),
                                  np.asarray(jax_assembly.local_dof_indices(jmesh)))
    np.testing.assert_array_equal(assembly.gather_base_table(port_mesh).numpy(),
                                  np.asarray(jax_assembly.gather_base_table(jmesh)))
    assert rel_err(assembly.a2_blocks(port_mesh).numpy(),
                   np.asarray(jax_assembly.a2_blocks(jmesh))) <= F64


def test_frame_factors_and_rhs_match_jax(jmesh, port_mesh, wave, systems):  # noqa: F811
    pot, times = wave
    jop, jf, g, f, _ = systems
    want_g = np.asarray(jax_assembly.frame_factors(jmesh, jnp.asarray(pot[:-1])))
    assert rel_err(g.numpy(), want_g) <= F64
    assert rel_err(g.numpy(), np.asarray(jop.g)) <= F64
    assert rel_err(f.numpy(), jf) <= F64
    # The plain assembly functions the kernel wrapper stands in for.
    tg = assembly.frame_factors(port_mesh, torch.from_numpy(pot[:-1]))
    assert rel_err(tg.numpy(), want_g) <= F64
    di = (pot[1:] - pot[:-1]) / (times[1:] - times[:-1])[:, None]
    tf = assembly.rhs_vector(port_mesh, tg, torch.from_numpy(di))
    assert rel_err(tf.numpy(), jf) <= F64
    f_loc = np.asarray(jop.g).reshape(g.shape[0], -1, 6)
    assert rel_err(assembly.reduce_local(port_mesh, torch.from_numpy(f_loc)).numpy(),
                   np.asarray(jax_assembly.reduce_local(jmesh, jnp.asarray(f_loc)))) <= F64


def test_potentials_next_rhs_matches_jax(jmesh, port_mesh, wave):  # noqa: F811
    pot, times = wave
    nxt = pot[::-1].copy()
    jop = jax_operator.make_operator(jmesh, jnp.asarray(pot), LAMBDA)
    want = jax_build_rhs(jmesh, jop, jnp.asarray(pot), jnp.asarray(times),
                         jnp.asarray(nxt))
    _, f = build_rhs(port_mesh, torch.from_numpy(pot), torch.from_numpy(times),
                     torch.from_numpy(nxt))
    assert rel_err(f.numpy(), np.asarray(want)) <= F64


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_jacobi_blocks_match_jax(jmesh, port_mesh, systems, dtype):  # noqa: F811
    jop, _, g, _, _ = systems
    jg = jnp.asarray(np.asarray(jop.g).astype(dtype))
    tg = torch.from_numpy(np.asarray(jop.g).astype(dtype))
    lam = np.asarray(LAMBDA, dtype=dtype)
    tol = F64 if dtype == "float64" else F32
    want_c = np.asarray(jax_assembly.diag_contributions(jmesh, jg, lam))
    assert rel_err(assembly.diag_contributions(port_mesh, tg, float(lam)).numpy(),
                   want_c) <= tol
    want_d = np.asarray(jax_assembly.diag_blocks(jmesh, jg, lam))
    assert rel_err(assembly.diag_blocks(port_mesh, tg, float(lam)).numpy(),
                   want_d) <= tol
    want_inv = np.asarray(jax_operator.block_jacobi_inverse(jmesh, jg, lam))
    got_inv = operator.block_jacobi_inverse(port_mesh, tg, float(lam))
    assert got_inv.dtype == tg.dtype
    assert rel_err(got_inv.numpy(), want_inv) <= tol


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_jacobi_blocks_of_singular_frames_match_jax(jmesh, port_mesh, systems, dtype):  # noqa: F811
    """The plain jacobi_blocks at lambda = 0 with a constant frame appended (its
    a1 factors g are zero): every block of that frame is singular and both
    packages give the identity; the other frames' blocks, g g^T A/6 alone,
    agree with JAX's to the file's tolerance."""
    jop = systems[0]
    g = np.asarray(jop.g).astype(dtype)
    g = np.concatenate([g, np.zeros_like(g[:1])])
    want = np.asarray(jax_operator.block_jacobi_inverse(jmesh, jnp.asarray(g),
                                                        np.asarray(0.0, dtype=dtype)))
    reg, areas, base = operator.jacobi_inputs(port_mesh, getattr(torch, dtype))
    got = kfem.jacobi_blocks(torch.from_numpy(g), reg, areas, 0.0, base)
    assert got.dtype == getattr(torch, dtype)
    eye = np.broadcast_to(np.eye(2, dtype=dtype), want[-1].shape)
    np.testing.assert_array_equal(want[-1], eye)
    np.testing.assert_array_equal(got[-1].numpy(), eye)
    assert rel_err(got[:-1].numpy(), want[:-1]) <= (F64 if dtype == "float64" else F32)


def test_jacobi_inputs_are_cached_per_mesh_and_dtype(port_mesh):
    """block_jacobi_inverse's per-mesh inputs are built once per mesh and
    dtype: a second call returns the same tensors, another dtype or a mesh
    with moved points gets its own, each equal to a fresh build."""
    from manifold_flow_tpu_torch.geometry.mesh import build_mesh

    moved = build_mesh(port_mesh.points.numpy() * 1.5, port_mesh.triangles.numpy(),
                       device="cpu")
    built = {}
    for mesh in (port_mesh, moved):
        for dtype in (torch.float64, torch.float32):
            first = operator.jacobi_inputs(mesh, dtype)
            assert all(a is b for a, b in zip(operator.jacobi_inputs(mesh, dtype), first))
            want = (assembly.corner_regularization(mesh, dtype), mesh.areas.to(dtype),
                    assembly.gather_base_table(mesh))
            for a, b in zip(first, want):
                assert a.dtype == b.dtype and torch.equal(a, b) and a.is_contiguous()
            built[id(mesh), dtype] = first
    assert len({id(x[0]) for x in built.values()}) == 4
    assert not torch.equal(built[id(moved), torch.float64][0],
                           built[id(port_mesh), torch.float64][0])


def test_invert_2x2_singular_blocks_become_identity():
    d = torch.tensor([[[2.0, 1.0], [1.0, 3.0]], [[1.0, 2.0], [2.0, 4.0]],
                      [[0.0, 0.0], [0.0, 0.0]]], dtype=torch.float64)
    want = np.asarray(jax_operator.invert_2x2_blocks(jnp.asarray(d.numpy())))
    got = operator.invert_2x2_blocks(d).numpy()
    np.testing.assert_array_equal(got[1:], np.broadcast_to(np.eye(2), (2, 2, 2)))
    assert rel_err(got, want) <= F64


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_matvec_matches_jax(systems, dtype):
    jop, _, _, _, op = systems
    rng = np.random.default_rng(1)
    x = rng.standard_normal((jop.g.shape[0], jop.n_dof)).astype(dtype)
    jdt = jnp.dtype(dtype)
    jop_d = dataclasses.replace(
        jop, blocks2=jop.blocks2.astype(jdt), g=jop.g.astype(jdt),
        w_scale=jop.w_scale.astype(jdt), lambda_=jop.lambda_.astype(jdt))
    op_d = op.astype(getattr(torch, dtype))
    want = np.asarray(jop_d.matvec(jnp.asarray(x)))
    got = op_d.matvec(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype)
    assert rel_err(got.numpy(), want) <= (MATVEC_F64 if dtype == "float64" else F32)
    want_loc = np.asarray(jop_d.local_contributions(jnp.asarray(x)))
    assert rel_err(op_d.local_contributions(torch.from_numpy(x)).numpy(),
                   want_loc) <= (MATVEC_F64 if dtype == "float64" else F32)


def test_f64_residual_matches_jax_df_residual(jmesh, wave, systems):  # noqa: F811
    pot, times = wave
    _, _, _, f, op = systems
    op_df, f_df = make_df_operator(jmesh, jnp.asarray(pot), jnp.asarray(times),
                                   LAMBDA)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(tuple(f.shape)) * 1e-2
    want = np.asarray(df32.to_f64(op_df.residual(f_df, df32.from_f64(jnp.asarray(x)))))
    got = op.residual(f, torch.from_numpy(x))
    ax = op.matvec(torch.from_numpy(x))
    scale = float(f.abs().max()) + float(ax.abs().max())
    assert rel_err(got.numpy(), want, scale=scale) <= F64
    # The fused residual is f - A x of the same kernel's matvec.
    assert rel_err(got.numpy(), (f - ax).numpy(), scale=scale) <= MATVEC_F64


def test_plain_kernels_count_no_launches(systems):
    jop, _, g, f, op = systems
    before = dict(kernels.LAUNCHES)
    op.matvec(f)
    op.residual(f, f)
    kfem.pcg_dot(f, f)
    assert kernels.LAUNCHES == before


def _tile_meshes():
    """A plane patch (valence up to 6, boundary rows padded) and a sphere
    patch (valence 5 and 6: padded gather_base entries inside)."""
    return {"plane": torch_synthetic.plane_patch(nx=23, ny=17, lx=6.0, ly=4.0,
                                                  device="cpu"),
            "sphere": torch_synthetic.sphere_patch(n_sub=2, device="cpu")}


@pytest.mark.parametrize("size", [7, 64, 256])
@pytest.mark.parametrize("name", ["plane", "sphere"])
def test_vertex_tiles_hold_every_gather_entry_once_in_order(name, size):
    """K1's tables: tiles cover every vertex; each tile lists the cells of
    its vertices once, ascending; each gather row names, column by column,
    the same (cell, slot) entry as gather_base, padded where it is."""
    mesh = _tile_meshes()[name]
    base = assembly.gather_base_table(mesh)
    dof, blocks2 = assembly.local_dof_indices(mesh), assembly.a2_blocks(mesh)
    tiles = assembly.vertex_tiles(base, dof, blocks2, size)
    n, m = mesh.n_vertices, mesh.n_triangles
    ptr, cells, gather = (v.numpy() for v in (tiles.cell_ptr, tiles.cells, tiles.gather))
    # Each listed cell's dof and a2 block, local index first.
    np.testing.assert_array_equal(tiles.cell_dof.numpy(), dof.numpy()[cells].T)
    upper = blocks2.numpy().reshape(m, 36)[cells][:, assembly.UPPER].T
    np.testing.assert_array_equal(tiles.blocks2.numpy(), upper)
    # The a2 blocks are exactly symmetric: the upper triangle is all of it.
    np.testing.assert_array_equal(blocks2.numpy(), blocks2.numpy().transpose(0, 2, 1))
    assert tiles.size == size and len(ptr) == -(-n // size) + 1 and ptr[0] == 0
    assert tiles.max_cells == int(np.diff(ptr).max())
    assert gather.shape == tuple(base.shape) and gather.dtype == np.int32
    padded = base.numpy() == 6 * m
    if name == "sphere":  # its 12 vertices of valence 5 have one padded entry
        assert (padded.sum(axis=1) == 1).sum() == 12
    np.testing.assert_array_equal(gather < 0, padded)
    tile = np.arange(n) // size
    for k in range(len(ptr) - 1):
        own = cells[ptr[k]:ptr[k + 1]]
        assert np.all(np.diff(own) > 0)                      # ascending, once
        rows = base.numpy()[tile == k]
        np.testing.assert_array_equal(own, np.unique(rows[rows < 6 * m] // 6))
    # Rebuilt through the tile tables, the vertex table comes back entry by
    # entry, in column order.
    local = np.where(gather < 0, 0, gather)
    rebuilt = cells[ptr[tile][:, None] + local // 6] * 6 + local % 6
    np.testing.assert_array_equal(np.where(padded, 6 * m, rebuilt), base.numpy())


def test_operator_carries_tiles_of_its_table(systems):
    """make_operator builds K1's tables from its gather_base; astype keeps
    them; summed through them in table order, the local products reduce as
    assembly.reduce_table reduces them (the kernel's arithmetic order)."""
    _, _, _, f, op = systems
    op32 = op.astype(torch.float32)
    assert op32.tiles.gather is op.tiles.gather
    assert op32.tiles.blocks2.dtype == torch.float32
    assert torch.equal(op32.tiles.blocks2, op.tiles.blocks2.to(torch.float32))
    want = assembly.vertex_tiles(op.gather_base, op.dof, op.blocks2)
    for a, b in zip(op.tiles, want):
        assert a == b if isinstance(a, int) else torch.equal(a, b)
    y_loc = op.local_contributions(f)                                # (T, M, 6)
    t, n = f.shape[0], f.shape[1] // 2
    tiles = op.tiles
    out = torch.zeros_like(f)
    for v in range(n):
        k = v // tiles.size
        cells = tiles.cells[tiles.cell_ptr[k]:tiles.cell_ptr[k + 1]].long()
        smem = y_loc[:, cells].reshape(t, -1)                        # tile-local
        for e in tiles.gather[v].tolist():
            if e >= 0:
                out[:, v] += smem[:, e]
                out[:, v + n] += smem[:, e + 1]
    want_y = assembly.reduce_table(y_loc, op.gather_base)
    assert rel_err(out.numpy(), want_y.numpy()) <= MATVEC_F64


@pytest.mark.parametrize("size", [7, 64, 256])
@pytest.mark.parametrize("name", ["plane", "sphere"])
def test_cell_tiles_own_every_cell_once(name, size):
    """K4's ownership: every cell is owned by exactly one tile, the first
    that lists it; a tile's owned cells are among its own, named by their
    index there, ascending; the index tables are K1's."""
    mesh = _tile_meshes()[name]
    base = assembly.gather_base_table(mesh)
    m = mesh.n_triangles
    ct = assembly.cell_tiles(base, m, size)
    k1 = assembly.vertex_tiles(base, assembly.local_dof_indices(mesh),
                               assembly.a2_blocks(mesh), size)
    for key in ("size", "cell_ptr", "cells", "gather", "max_cells"):
        a, b = getattr(ct, key), getattr(k1, key)
        assert a == b if isinstance(a, int) else torch.equal(a, b)
    ptr, cells = ct.cell_ptr.numpy(), ct.cells.numpy()
    own_ptr, owned = ct.own_ptr.numpy(), ct.owned.numpy()
    assert owned.shape == (m,) and own_ptr[0] == 0 and own_ptr[-1] == m
    assert len(own_ptr) == len(ptr) and np.all(np.diff(own_ptr) >= 0)
    owner = np.full(m, -1)
    for k in range(len(ptr) - 1):
        local = owned[own_ptr[k]:own_ptr[k + 1]]
        assert np.all(np.diff(local) > 0)
        assert np.all((local >= 0) & (local < ptr[k + 1] - ptr[k]))
        mine = cells[ptr[k] + local]
        assert np.all(owner[mine] == -1)                     # owned once
        owner[mine] = k
    assert np.all(owner >= 0)                                # every cell
    first = np.full(m, len(ptr))
    for k in range(len(ptr) - 2, -1, -1):
        first[cells[ptr[k]:ptr[k + 1]]] = k
    np.testing.assert_array_equal(owner, first)
    # The first tile to list a cell is its lowest vertex's.
    np.testing.assert_array_equal(owner, mesh.triangles.numpy().min(axis=1) // size)


def test_cell_tiles_reject_a_cell_no_vertex_names():
    mesh = _tile_meshes()["plane"]
    m = mesh.n_triangles
    base = assembly.gather_base_table(mesh)
    assembly.cell_tiles(base, m)
    unnamed = torch.where(base // 6 == 5, 6 * m, base)  # cell 5 padded away
    with pytest.raises(ValueError, match="1 of .* incident to no vertex"):
        assembly.cell_tiles(unnamed, m)


def test_mesh_cell_tiles_are_cached_and_shared_by_the_operator(port_mesh, systems):
    """build_rhs's tiles are cached per mesh and the operator's K1 tables
    take their index tensors."""
    _, _, _, _, op = systems
    ct = assembly.mesh_cell_tiles(port_mesh)
    assert assembly.mesh_cell_tiles(port_mesh) is ct
    assert op.tiles.cells is ct.cells and op.tiles.gather is ct.gather
    assert op.tiles.cell_ptr is ct.cell_ptr and op.tiles.max_cells == ct.max_cells


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ordered_reference_of_k4_matches_plain(port_mesh, wave, dtype):  # noqa: F811
    """K4's reference in the kernel's order (the cuda tests hold the kernel
    to it bit for bit) computes the plain version's g and f, to F64 / F32 of
    the largest entry, and the CPU wrapper, given tiles or not, is the
    plain version."""
    from tests.torch_ordered import ordered_frame_factors_rhs

    pot, times = (x.astype(dtype) for x in wave)
    mesh = port_mesh
    args = [torch.from_numpy(pot), torch.from_numpy(pot[::-1].copy()),
            torch.from_numpy(times), mesh.triangles,
            *(x.to(getattr(torch, dtype)) for x in (mesh.grad_w, mesh.basis, mesh.areas)),
            assembly.gather_base_table(mesh)]
    want = kfem.plain_frame_factors_rhs(*args)
    got = ordered_frame_factors_rhs(*(a.numpy() for a in args))
    tol = F64 if dtype == "float64" else F32
    for a, b in zip(got, want):
        assert a.dtype == np.dtype(dtype)
        assert rel_err(a, b.numpy()) <= tol
    with_tiles = kfem.frame_factors_rhs(*args, assembly.mesh_cell_tiles(mesh))
    for a, b in zip(with_tiles, want):
        assert torch.equal(a, b)
