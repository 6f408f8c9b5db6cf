"""Solvers of the PyTorch port held against the JAX package and the scipy
oracle, on one mesh (carried across with mesh_from_jax_arrays) and one seeded
movie.

Tolerances (measured on this mesh in parentheses):
  * iteration counts within 2 of JAX's (equal): the arithmetic is the same,
    only reduction orders differ, which can move the last iteration's test;
  * solve_cg solutions: 1e-9 of max|x| in float64 at tol 1e-10 (2e-15) and
    1e-3 in float32 at tol 1e-5 (3e-7): a solve stopped one iteration
    earlier or later differs by up to tol * cond(A), and cond(A) ~ 1e2;
  * compute_velocity_fields against JAX, by the same bound: 1e-8 of max|v|
    for 'cg' at tol 1e-10 (2e-15) and 1e-6 for 'refined' at tol 1e-9
    (3e-13);
  * against the spsolve oracle: normalized RMSE below 1e-7 (8e-11 'cg',
    7e-10 'refined'), the gate the JAX package's own refined test uses;
  * frame-chunked solves (windows of 4 frames on a 12-frame movie) against
    JAX's chunked solve: 1e-8 of max|v| for 'cg' at tol 1e-12 (2e-15) and
    1e-6 for 'refined' at tol 1e-8 (3e-8); against the port's unchunked
    solve, by the bounds of the JAX package's own chunk test: 1e-8 for
    'cg' (7e-12) and 1e-5 for 'refined' (4e-9), since each window's f32
    inner solves take another path;
  * compute_velocity_fields on a 16 x 25 patch (two of K1's tiles, so
    the port solves on a copy renumbered by geometry.order), Jacobi and
    two-level, against JAX on the mesh as it is: the bounds above
    (iterations equal; 1.5e-15 'cg', 2.3e-13 'refined');
  * 'cholesky' (its factor is f64 on an f64 mesh, as JAX's is): 1e-10 of
    max|v| against JAX (1e-15), RMSE below 1e-7 against spsolve (3e-16),
    and 1e-8 against 'cg' at tol 1e-12 (7e-12).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manifold_flow_tpu.fem.operator import block_jacobi_inverse as jax_jacobi
from manifold_flow_tpu.fem.operator import make_operator as jax_make_operator
from manifold_flow_tpu.geometry import synthetic as jax_synthetic
from manifold_flow_tpu.solve import refine as jax_refine
from manifold_flow_tpu.solve.api import build_rhs as jax_build_rhs
from manifold_flow_tpu.solve.api import compute_velocity_fields as jax_cvf
from manifold_flow_tpu.solve.cg import solve_cg as jax_solve_cg
from manifold_flow_tpu_torch import compute_velocity_fields, mesh_from_jax_arrays
from manifold_flow_tpu_torch.fem import assembly
from manifold_flow_tpu_torch.fem.operator import block_jacobi_inverse, make_operator
from manifold_flow_tpu_torch.geometry import order
from manifold_flow_tpu_torch.solve import api as solve_api
from manifold_flow_tpu_torch.solve import refine
from manifold_flow_tpu_torch.solve.api import build_rhs
from manifold_flow_tpu_torch.solve.cg import solve_cg
from tests.oracle import reference_impl as ref
from tests.torch_parity import LAMBDA, jax_arrays, jmesh, movie, rel_err, wave  # noqa: F401

ITER_SLACK = 2
CASES = {"cg": (1e-10, 1e-8), "refined": (1e-9, 1e-6)}  # method: (tol, vs JAX)
ORACLE_RMSE = 1e-7


@pytest.fixture(scope="module")
def port_mesh(jmesh):  # noqa: F811
    return mesh_from_jax_arrays(jax_arrays(jmesh), device="cpu")


@pytest.fixture(scope="module")
def oracle(jmesh, wave):  # noqa: F811
    pot, times = wave
    v, _ = ref.velocity_fields_np(np.asarray(jmesh.points),
                                  np.asarray(jmesh.triangles),
                                  np.asarray(jmesh.normals), pot, times, LAMBDA)
    return v


@pytest.fixture(scope="module")
def jax_results(jmesh, wave):  # noqa: F811
    pot, times = wave
    out = {}
    for method, (tol, _) in CASES.items():
        res = jax_cvf(jmesh, jnp.asarray(pot), jnp.asarray(times), method=method,
                      tol=tol)
        out[method] = (np.asarray(res.v_k), int(res.iterations))
    return out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solve_cg_matches_jax(jmesh, port_mesh, wave, dtype):  # noqa: F811
    pot, times = wave
    jop = jax_make_operator(jmesh, jnp.asarray(pot), LAMBDA)
    jf = jax_build_rhs(jmesh, jop, jnp.asarray(pot), jnp.asarray(times))
    g, f = build_rhs(port_mesh, torch.from_numpy(pot), torch.from_numpy(times))
    tol = 1e-10 if dtype == "float64" else 1e-5
    if dtype == "float32":  # the refined solve's inner problem
        jop = dataclasses.replace(jop, blocks2=jop.blocks2.astype(jnp.float32),
                                  g=jop.g.astype(jnp.float32),
                                  w_scale=jop.w_scale.astype(jnp.float32),
                                  lambda_=jop.lambda_.astype(jnp.float32))
        jf = jf.astype(jnp.float32)
    want = jax_solve_cg(jop, jf, precond=jax_jacobi(jmesh, jop.g, jop.lambda_),
                        tol=tol, max_iter=2000)
    op = make_operator(port_mesh, g, LAMBDA).astype(getattr(torch, dtype))
    got = solve_cg(op, f.to(op.g.dtype), block_jacobi_inverse(port_mesh, op.g, op.lambda_),
                   tol=tol, max_iter=2000)
    assert abs(got.iterations - int(want.iterations)) <= ITER_SLACK
    assert bool(got.converged.all()) and bool(np.all(np.asarray(want.converged)))
    x_tol = 1e-9 if dtype == "float64" else 1e-3
    assert rel_err(got.x.numpy(), np.asarray(want.x)) <= x_tol


@pytest.mark.parametrize("method", sorted(CASES))
def test_velocity_fields_match_jax_and_oracle(port_mesh, wave, oracle,  # noqa: F811
                                              jax_results, method):
    pot, times = wave
    tol, vs_jax = CASES[method]
    res = compute_velocity_fields(port_mesh, pot, times, method=method, tol=tol)
    want_v, want_iters = jax_results[method]
    assert res.v_k.shape == (pot.shape[0] - 1, port_mesh.n_dof)
    assert res.v_k.dtype == torch.float64
    assert bool(res.converged.all())
    assert abs(res.iterations - want_iters) <= ITER_SLACK
    assert rel_err(res.v_k.numpy(), want_v) <= vs_jax
    rmse = np.sqrt(np.mean((res.v_k.numpy() - oracle) ** 2)) / np.abs(oracle).max()
    assert rmse < ORACLE_RMSE
    assert torch.equal(res.e, port_mesh.basis)


@pytest.fixture(scope="module")
def two_tile_meshes():
    """A bumped 16 x 25 patch in both packages: more than one K1 tile, cut
    across its ids' rows (the long side is y, ids run along it fastest)."""
    jm = jax_synthetic.plane_patch(
        nx=16, ny=25, lx=6.0, ly=12.0,
        height=lambda x, y: 0.8 * np.exp(-((x - 3.0) ** 2 + (y - 5.0) ** 2) / 6.0))
    return jm, mesh_from_jax_arrays(jax_arrays(jm), device="cpu")


@pytest.mark.parametrize("precond", ["jacobi", "two_level"])
@pytest.mark.parametrize("method", sorted(CASES))
def test_renumbered_solve_matches_jax(two_tile_meshes, method, precond):
    jm, pm = two_tile_meshes
    assert pm.n_vertices > assembly.TILE_VERTICES
    assert not np.array_equal(order.local_mesh(pm).order.vertex_order,
                              np.arange(pm.n_vertices))
    pot, times = movie(np.asarray(jm.points))
    tol, vs_jax = CASES[method]
    want = jax_cvf(jm, jnp.asarray(pot), jnp.asarray(times), method=method, tol=tol,
                   precond=precond)
    got = compute_velocity_fields(pm, pot, times, method=method, tol=tol,
                                  precond=precond)
    assert bool(got.converged.all()) and bool(np.all(np.asarray(want.converged)))
    assert abs(got.iterations - int(want.iterations)) <= ITER_SLACK
    assert rel_err(got.v_k.numpy(), np.asarray(want.v_k)) <= vs_jax
    assert got.e is pm.basis


def test_auto_is_cg_on_cpu(port_mesh, wave, jax_results):  # noqa: F811
    pot, times = wave
    res = compute_velocity_fields(port_mesh, pot, times, method="auto", tol=1e-10)
    assert res.iterations == compute_velocity_fields(
        port_mesh, pot, times, method="cg", tol=1e-10).iterations


def test_potentials_next_matches_jax(jmesh, port_mesh, wave):  # noqa: F811
    pot, times = wave
    nxt = pot + 0.01 * np.sin(np.arange(pot.shape[1]))[None, :]
    want = jax_cvf(jmesh, jnp.asarray(pot), jnp.asarray(times), method="cg",
                   tol=1e-10, potentials_next=jnp.asarray(nxt))
    got = compute_velocity_fields(port_mesh, pot, times, method="cg", tol=1e-10,
                                  potentials_next=nxt)
    assert rel_err(got.v_k.numpy(), np.asarray(want.v_k)) <= 1e-8


@pytest.mark.parametrize("method", ["cg", "refined"])
def test_constant_movie_gives_zero_field(port_mesh, method):
    pot = np.ones((4, port_mesh.n_vertices))
    times = np.arange(4) * 0.01
    res = compute_velocity_fields(port_mesh, pot, times, method=method)
    assert bool(res.converged.all())
    assert float(res.v_k.abs().max()) == 0.0
    assert bool(torch.isfinite(res.residual).all())


def test_float32_movie_on_float64_mesh_solves_in_float64(port_mesh, wave):  # noqa: F811
    pot, times = wave
    res = compute_velocity_fields(port_mesh, pot.astype(np.float32), times,
                                  method="cg", tol=1e-8)
    assert res.v_k.dtype == torch.float64 and bool(res.converged.all())


def test_bad_inputs_raise_value_error(port_mesh, wave):  # noqa: F811
    pot, times = wave
    n = port_mesh.n_vertices
    bad = [
        dict(potentials=pot, times=times, method="bogus"),
        dict(potentials=pot, times=times, precond="bogus"),
        dict(potentials=pot[:, :-1], times=times),
        dict(potentials=pot[0], times=times[:1]),
        dict(potentials=pot, times=times[:-1]),
        dict(potentials=pot[:1], times=times[:1]),
        dict(potentials=pot, times=times, potentials_next=pot[:-1]),
        dict(potentials=pot.astype(np.float32), times=times, method="refined"),
        dict(potentials=np.zeros((3, n), dtype=np.int64), times=times[:3]),
        dict(potentials=pot, times=times, frame_chunk=0),
        dict(potentials=pot, times=times, method="refined", inner_tol=np.ones((2, 2))),
    ]
    for kwargs in bad:
        with pytest.raises(ValueError):
            compute_velocity_fields(port_mesh, **kwargs)


@pytest.mark.parametrize("method, tol, vs_jax, vs_whole", [
    ("cg", 1e-12, 1e-8, 1e-8), ("refined", 1e-8, 1e-6, 1e-5)])
def test_chunked_solve_matches_jax_and_unchunked(jmesh, port_mesh, method,  # noqa: F811
                                                 tol, vs_jax, vs_whole):
    pot, times = movie(np.asarray(jmesh.points), n_frames=12)
    want = jax_cvf(jmesh, jnp.asarray(pot), jnp.asarray(times), method=method,
                   tol=tol, frame_chunk=4)
    got = compute_velocity_fields(port_mesh, pot, times, method=method, tol=tol,
                                  frame_chunk=4)
    whole = compute_velocity_fields(port_mesh, pot, times, method=method, tol=tol,
                                    frame_chunk=None)
    assert got.v_k.shape == whole.v_k.shape == (11, port_mesh.n_dof)
    assert bool(got.converged.all()) and got.residual.shape == (11,)
    assert abs(got.iterations - int(want.iterations)) <= ITER_SLACK
    assert rel_err(got.v_k.numpy(), np.asarray(want.v_k)) <= vs_jax
    assert rel_err(got.v_k.numpy(), whole.v_k.numpy()) <= vs_whole


def test_auto_chunks_long_movies_into_shifted_windows(port_mesh):
    """162 frames (161 velocity frames > 160) under 'auto': windows of 104
    starting at 0 and 57, the last shifted back to end at the movie's end;
    `iterations` is the larger window's count."""
    assert (solve_api.FRAME_CHUNK_SIZE, solve_api.FRAME_CHUNK_AUTO_MIN) == (104, 160)
    pot, times = movie(port_mesh.points.numpy(), n_frames=162)
    kw = dict(method="cg", tol=1e-10)
    got = compute_velocity_fields(port_mesh, pot, times, **kw)
    first = compute_velocity_fields(port_mesh, pot[:105], times[:105], **kw)
    last = compute_velocity_fields(port_mesh, pot[57:], times[57:], **kw)
    assert torch.equal(got.v_k[:104], first.v_k[:104])
    assert torch.equal(got.v_k[104:], last.v_k[47:])
    assert torch.equal(got.converged, torch.cat([first.converged[:104],
                                                 last.converged[47:]]))
    assert got.iterations == max(first.iterations, last.iterations)
    whole = compute_velocity_fields(port_mesh, pot, times, frame_chunk=None, **kw)
    assert rel_err(got.v_k.numpy(), whole.v_k.numpy()) <= 1e-8


def test_no_chunks_with_potentials_next(port_mesh, wave):  # noqa: F811
    pot, times = wave
    nxt = pot + 0.01
    kw = dict(method="cg", tol=1e-10, potentials_next=nxt)
    got = compute_velocity_fields(port_mesh, pot, times, frame_chunk=2, **kw)
    want = compute_velocity_fields(port_mesh, pot, times, frame_chunk=None, **kw)
    assert torch.equal(got.v_k, want.v_k) and got.iterations == want.iterations


def test_cholesky_matches_jax_oracle_and_cg(jmesh, port_mesh, wave, oracle):  # noqa: F811
    pot, times = wave
    want = jax_cvf(jmesh, jnp.asarray(pot), jnp.asarray(times), method="cholesky",
                   tol=1e-12)
    got = compute_velocity_fields(port_mesh, pot, times, method="cholesky",
                                  tol=1e-12)
    assert got.iterations == 0 and bool(got.converged.all())
    assert got.v_k.dtype == torch.float64
    assert rel_err(got.v_k.numpy(), np.asarray(want.v_k)) <= 1e-10
    rmse = np.sqrt(np.mean((got.v_k.numpy() - oracle) ** 2)) / np.abs(oracle).max()
    assert rmse < ORACLE_RMSE
    cg = compute_velocity_fields(port_mesh, pot, times, method="cg", tol=1e-12)
    assert rel_err(got.v_k.numpy(), cg.v_k.numpy()) <= 1e-8


@pytest.mark.parametrize("spec", [1e-3, (1e-3, 1e-2), [2e-3], np.array([1e-3, 1e-2])])
def test_inner_schedule_matches_jax(spec):
    assert refine.as_inner_schedule(spec) == pytest.approx(
        tuple(float(t) for t in jax_refine.as_inner_schedule(spec)))
    assert refine.DEFAULT_INNER_TOL == jax_refine.DEFAULT_INNER_TOL
