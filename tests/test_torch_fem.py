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
