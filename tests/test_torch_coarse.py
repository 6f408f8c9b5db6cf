"""The two-level preconditioner of the PyTorch port (solve.coarse) held
against the JAX package's, on the 144-vertex curved mesh and a seeded movie
(tests/torch_parity.py). On CPU tensors K8-K11 run their plain versions.

Tolerances (measured on this mesh in parentheses):
  * aggregation tables and members: equal, entry for entry;
  * coarse matrices and prolongation blocks: 1e-12 of the largest entry in
    float64 (4e-16) and 1e-5 in float32 (3e-7): the same products, summed
    in another order;
  * the explicit coarse inverses and the preconditioner applied to seeded
    vectors: 1e-12 of the largest entry in float64 (2e-15): the inverse
    comes from another LAPACK path; symmetry of <v, M u> to 1e-10 relative
    (1e-15), where the JAX test asks 1e-5;
  * solve_cg with two-level: iterations within ITER_SLACK of JAX's (equal:
    25 in float64, 12 in float32), and x within the bounds of
    test_torch_solve.py (1e-9 of max|x| in float64 at tol 1e-10 (1e-15),
    1e-3 in float32 at tol 1e-5 (6e-7));
  * the refined solve with two-level: within 1e-6 of JAX's at tol 1e-9
    (3e-13), and a normalized RMSE below 1e-7 against spsolve (1e-10),
    JAX's own gate.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manifold_flow_tpu.fem.operator import make_operator as jax_make_operator
from manifold_flow_tpu.solve import coarse as jax_coarse
from manifold_flow_tpu.solve.api import build_rhs as jax_build_rhs
from manifold_flow_tpu.solve.api import compute_velocity_fields as jax_cvf
from manifold_flow_tpu.solve.cg import solve_cg as jax_solve_cg
from manifold_flow_tpu_torch import compute_velocity_fields, mesh_from_jax_arrays
from manifold_flow_tpu_torch.convert import coarse_tables_from_jax_arrays
from manifold_flow_tpu_torch.fem.operator import make_operator
from manifold_flow_tpu_torch.geometry import synthetic as torch_synthetic
from manifold_flow_tpu_torch.kernels import coarse as kco
from manifold_flow_tpu_torch.solve import api, coarse, refine
from manifold_flow_tpu_torch.solve.api import build_rhs
from manifold_flow_tpu_torch.solve.cg import solve_cg
from tests.oracle import reference_impl as ref
from tests.torch_parity import LAMBDA, jax_arrays, jmesh, rel_err, tmesh, wave  # noqa: F401

ITER_SLACK = 2
TOL = {"float64": 1e-12, "float32": 1e-5}


@pytest.fixture(scope="module")
def port_mesh(jmesh):  # noqa: F811
    return mesh_from_jax_arrays(jax_arrays(jmesh), device="cpu")


@pytest.fixture(scope="module")
def jop(jmesh, wave):  # noqa: F811
    return jax_make_operator(jmesh, jnp.asarray(wave[0]), LAMBDA)


def _jax_tables(jmesh, passes):  # noqa: F811
    return jax_coarse.build_tables(jmesh, passes=passes)


def _port_tables(jtables, mesh):
    return coarse_tables_from_jax_arrays(
        {"agg": np.asarray(jtables.agg), "seeds": np.asarray(jtables.seeds),
         "members": np.asarray(jtables.members), "n_coarse": jtables.n_coarse},
        mesh)


@pytest.mark.parametrize("passes", [1, 2, None])
def test_tables_equal_jax(jmesh, tmesh, passes):  # noqa: F811
    want = _jax_tables(jmesh, passes)
    got = coarse.build_tables(tmesh, passes=passes)  # the port's own topology
    assert got.n_coarse == want.n_coarse <= coarse.MAX_COARSE_SIZE
    for name in ("agg", "seeds", "members"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
        assert getattr(got, name).dtype == torch.int32
    assert coarse.build_tables(tmesh, passes=passes) is got  # cached
    # The CSR lists every triangle-local contribution once, grouped by entry.
    src = got.asm_src.numpy()
    assert np.array_equal(np.sort(src), np.arange(36 * tmesh.n_triangles))
    assert got.asm_ptr[-1] == src.size and np.all(np.diff(got.asm_dst.numpy()) > 0)


def test_tables_from_jax_check_their_mesh(jmesh, port_mesh):  # noqa: F811
    jt = _jax_tables(jmesh, 1)
    got = _port_tables(jt, port_mesh)
    want = coarse.build_tables(port_mesh, passes=1)
    for name in ("agg", "members", "asm_ptr", "asm_src", "asm_dst"):
        assert torch.equal(getattr(got, name), getattr(want, name))
    with pytest.raises(ValueError, match="do not match"):
        coarse_tables_from_jax_arrays(
            {"agg": np.asarray(jt.agg), "seeds": np.asarray(jt.seeds),
             "members": np.asarray(jt.members)[:, :-1], "n_coarse": jt.n_coarse},
            port_mesh)


def _break_odd_count(ptr, src, dst):
    return ptr[:-1], src, dst[:-1]


def _break_sizes(ptr, src, dst):
    ptr = ptr.copy()
    ptr[1] -= 1     # entry 0 gives its last contribution to entry 1
    return ptr, src, dst


def _break_target(ptr, src, dst):
    dst = dst.copy()
    dst[1] += 2
    return ptr, src, dst


def _break_parity(ptr, src, dst):
    src = src.copy()
    src[ptr[0]:ptr[2]] = src[ptr[1]:ptr[2]].tolist() + src[ptr[0]:ptr[1]].tolist()
    return ptr, src, dst


def _break_order(ptr, src, dst):
    src = src.copy()
    lo, hi = ptr[1], ptr[2]
    src[lo:hi] = src[lo:hi][::-1]
    return ptr, src, dst


@pytest.mark.parametrize("broken", [None, _break_odd_count, _break_sizes,
                                    _break_target, _break_parity, _break_order])
def test_assembly_csr_lists_sibling_pairs(tmesh, broken):  # noqa: F811
    """K8 serves entries 2p and 2p + 1 from 2p's list: assembly_csr's CSR
    holds that layout, and any table that breaks it is refused."""
    tables = coarse.build_tables(tmesh, passes=1)
    ptr, src, dst = (getattr(tables, k).numpy() for k in ("asm_ptr", "asm_src", "asm_dst"))
    assert np.diff(ptr)[0] > 1 and dst.size % 2 == 0
    if broken is None:
        coarse.check_sibling_pairs(ptr, src, dst)
        assert np.array_equal(src[ptr[1]:ptr[2]], src[ptr[0]:ptr[1]] + 1)
    else:
        with pytest.raises(ValueError, match="coarse CSR"):
            coarse.check_sibling_pairs(*broken(ptr, src, dst))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("a1_mode", ["full", "mean"])
def test_coarse_matrices_match_jax(jmesh, port_mesh, jop, dtype, a1_mode):  # noqa: F811
    jt = _jax_tables(jmesh, 1)
    g = np.asarray(jop.g).astype(dtype)
    lam = np.asarray(LAMBDA, dtype=dtype)
    want_ac, want_r = jax_coarse.coarse_matrices(jmesh, jnp.asarray(g), jnp.asarray(lam),
                                                 jt, a1_mode=a1_mode)
    got_ac, got_r = coarse.coarse_matrices(port_mesh, torch.from_numpy(g), float(lam),
                                           _port_tables(jt, port_mesh), a1_mode=a1_mode)
    assert got_ac.dtype == getattr(torch, dtype)
    assert got_ac.shape == want_ac.shape == ((1,) if a1_mode == "mean" else g.shape[:1]) + (
        2 * jt.n_coarse, 2 * jt.n_coarse)
    assert rel_err(got_r.numpy(), np.asarray(want_r)) <= TOL[dtype]
    assert rel_err(got_ac.numpy(), np.asarray(want_ac)) <= TOL[dtype]


@pytest.mark.parametrize("a1_mode", ["full", "mean"])
def test_apply_matches_jax(jmesh, port_mesh, jop, a1_mode):  # noqa: F811
    jt = _jax_tables(jmesh, 1)
    want = jax_coarse.make_two_level(jmesh, jop.g, jop.lambda_, jt, a1_mode=a1_mode)
    got = coarse.make_two_level(port_mesh, torch.from_numpy(np.asarray(jop.g)), LAMBDA,
                                _port_tables(jt, port_mesh), a1_mode=a1_mode)
    assert not bool(got.zeroed.any())
    assert rel_err(got.ac_inv.numpy(), np.asarray(want.ac_inv)) <= TOL["float64"]
    u = np.random.default_rng(3).standard_normal((jop.g.shape[0], port_mesh.n_dof))
    assert rel_err(got.apply(torch.from_numpy(u)).numpy(),
                   np.asarray(want.apply(jnp.asarray(u)))) <= TOL["float64"]


def test_apply_is_symmetric_positive_definite(port_mesh, jop):
    """M^{-1} must be SPD for CG to be valid (JAX test_coarse.py:27-47)."""
    pre = coarse.make_two_level(port_mesh, torch.from_numpy(np.asarray(jop.g)), LAMBDA,
                                coarse.build_tables(port_mesh, passes=1))
    rng = np.random.default_rng(0)
    shape = (jop.g.shape[0], port_mesh.n_dof)
    u, v = (torch.from_numpy(rng.normal(size=shape)) for _ in range(2))
    vmu = torch.sum(v * pre.apply(u), dim=-1)
    umv = torch.sum(u * pre.apply(v), dim=-1)
    torch.testing.assert_close(vmu, umv, rtol=1e-10, atol=0)
    assert bool((torch.sum(u * pre.apply(u), dim=-1) > 0).all())


def test_failed_coarse_factor_zeroes_that_frame(port_mesh, jop):
    g = torch.from_numpy(np.asarray(jop.g)).clone()
    g[1] = float("nan")
    pre = coarse.make_two_level(port_mesh, g, LAMBDA,
                                coarse.build_tables(port_mesh, passes=1))
    assert pre.zeroed.tolist() == [i == 1 for i in range(g.shape[0])]
    assert float(pre.ac_inv[1].abs().max()) == 0.0
    assert bool(torch.isfinite(pre.ac_inv[0]).all())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solve_cg_two_level_matches_jax(jmesh, port_mesh, wave, jop, dtype):  # noqa: F811
    pot, times = wave
    jt = _jax_tables(jmesh, 1)
    jf = jax_build_rhs(jmesh, jop, jnp.asarray(pot), jnp.asarray(times))
    g, f = build_rhs(port_mesh, torch.from_numpy(pot), torch.from_numpy(times))
    op = make_operator(port_mesh, g, LAMBDA).astype(getattr(torch, dtype))
    tol = 1e-10 if dtype == "float64" else 1e-5
    jop_d = jop
    if dtype == "float32":  # the refined solve's inner problem
        jop_d = dataclasses.replace(jop, blocks2=jop.blocks2.astype(jnp.float32),
                                    g=jop.g.astype(jnp.float32),
                                    w_scale=jop.w_scale.astype(jnp.float32),
                                    lambda_=jop.lambda_.astype(jnp.float32))
    want = jax_solve_cg(jop_d, jf.astype(dtype),
                        precond=jax_coarse.make_two_level(jmesh, jop_d.g, jop_d.lambda_, jt),
                        tol=tol, max_iter=2000)
    pre = coarse.make_two_level(port_mesh, op.g, op.lambda_, _port_tables(jt, port_mesh))
    got = solve_cg(op, f.to(op.g.dtype), pre, tol=tol, max_iter=2000)
    assert abs(got.iterations - int(want.iterations)) <= ITER_SLACK
    assert bool(got.converged.all()) and bool(np.all(np.asarray(want.converged)))
    assert rel_err(got.x.numpy(), np.asarray(want.x)) <= (1e-9 if dtype == "float64"
                                                          else 1e-3)


def test_refined_two_level_matches_jax_and_oracle(jmesh, port_mesh, wave):  # noqa: F811
    pot, times = wave
    kw = dict(method="refined", tol=1e-9, precond="two_level", coarse_passes=1)
    want = jax_cvf(jmesh, jnp.asarray(pot), jnp.asarray(times), **kw)
    got = compute_velocity_fields(port_mesh, pot, times, **kw)
    assert bool(got.converged.all())
    assert abs(got.iterations - int(want.iterations)) <= ITER_SLACK
    assert rel_err(got.v_k.numpy(), np.asarray(want.v_k)) <= 1e-6
    oracle, _ = ref.velocity_fields_np(np.asarray(jmesh.points), np.asarray(jmesh.triangles),
                                       np.asarray(jmesh.normals), pot, times, LAMBDA)
    rmse = np.sqrt(np.mean((got.v_k.numpy() - oracle) ** 2)) / np.abs(oracle).max()
    assert rmse < 1e-7


@pytest.mark.parametrize("method", ["cg", "refined"])
def test_solve_reports_zeroed_coarse_frames(port_mesh, wave, monkeypatch, method):  # noqa: F811
    """`coarse_zeroed` is read off the preconditioner the solve built: force
    frame 1's coarse inverse to zero and the count follows, windows summed."""
    make = coarse.make_two_level

    def failing(*args, **kwargs):
        pre = make(*args, **kwargs)
        zeroed = pre.zeroed.clone()
        zeroed[1] = True
        ac_inv = pre.ac_inv.clone()
        ac_inv[1] = 0.0
        return dataclasses.replace(pre, zeroed=zeroed, ac_inv=ac_inv)

    monkeypatch.setattr(coarse, "make_two_level", failing)
    monkeypatch.setattr(refine, "make_two_level", failing)
    pot, times = wave
    kw = dict(method=method, tol=1e-9, coarse_passes=1)
    got = compute_velocity_fields(port_mesh, pot, times, precond="two_level", **kw)
    assert got.coarse_zeroed == 1 and bool(got.converged.all())
    windows = compute_velocity_fields(port_mesh, pot, times, precond="two_level",
                                      frame_chunk=3, **kw)
    assert windows.coarse_zeroed == -(-(pot.shape[0] - 1) // 3)
    assert compute_velocity_fields(port_mesh, pot, times, precond="jacobi",
                                   **kw).coarse_zeroed == 0


@pytest.fixture(scope="module")
def big_mesh():
    """A patch above TWO_LEVEL_MIN_VERTICES whose first aggregation pass
    leaves more than MAX_COARSE_SIZE aggregates."""
    return torch_synthetic.plane_patch(nx=78, ny=78, lx=60.0, ly=60.0,
                                       height=lambda x, y: 0.5 * np.sin(x / 9.0),
                                       device="cpu")


def test_auto_passes_match_jax_restarts(big_mesh):
    """build_tables(passes=None) deepens one pass at a time; the JAX package
    re-aggregates from pass 1 for each count. The tables are the same."""
    nb = big_mesh.vertex_neighbors.numpy()
    deg = big_mesh.vertex_degree.numpy()
    got = coarse.build_tables(big_mesh, passes=None)
    for n in range(1, coarse._MAX_PASSES + 1):
        agg, seeds = jax_coarse.aggregate_vertices(nb, deg, passes=n)
        if seeds.shape[0] <= coarse.MAX_COARSE_SIZE:
            break
    assert n >= 2
    np.testing.assert_array_equal(got.agg.numpy(), agg)
    np.testing.assert_array_equal(got.seeds.numpy(), seeds)


def test_auto_takes_two_level_from_the_vertex_threshold(big_mesh, monkeypatch):
    calls = []
    build = coarse.build_tables

    def spy(mesh, passes=None):
        calls.append((mesh.n_vertices, passes))
        return build(mesh, passes=passes)

    monkeypatch.setattr(coarse, "build_tables", spy)
    big = big_mesh
    assert big.n_vertices >= api.TWO_LEVEL_MIN_VERTICES
    pot, times = torch_synthetic.plane_wave_movie(big, n_frames=3)
    kw = dict(method="cg", tol=1e-3, max_iter=200)
    auto = compute_velocity_fields(big, pot, times, **kw)
    assert calls == [(big.n_vertices, None)]
    two = compute_velocity_fields(big, pot, times, precond="two_level", **kw)
    assert auto.iterations == two.iterations and torch.equal(auto.v_k, two.v_k)
    assert bool(auto.converged.all())
    small = torch_synthetic.plane_patch(nx=12, ny=12, device="cpu")
    pot, times = torch_synthetic.plane_wave_movie(small, n_frames=3)
    compute_velocity_fields(small, pot, times, **kw)
    assert len(calls) == 2  # the explicit two_level call only


@pytest.mark.parametrize("a1", ["none", "bogus"])
def test_unsupported_coarse_a1_is_rejected(port_mesh, wave, a1):
    pot, times = wave
    with pytest.raises(ValueError, match="'none' .* is not ported" if a1 == "none"
                       else "unknown coarse_a1"):
        compute_velocity_fields(port_mesh, pot, times, precond="two_level",
                                coarse_a1=a1)


def test_coarse_assemble_refuses_an_odd_entry_count():
    """K8's wrapper takes the CSR in sibling pairs only: an odd entry count
    raises before any launch or plain sum."""
    f64 = torch.float64
    args = (torch.zeros(1, 1, 3, 2, dtype=f64), torch.zeros(1, 6, 6, dtype=f64),
            torch.zeros(3, 2, 2, dtype=f64), torch.tensor([[0, 1, 2]], dtype=torch.int32),
            torch.ones(1, dtype=f64), LAMBDA, torch.tensor([0, 36], dtype=torch.int32),
            torch.arange(36, dtype=torch.int32), torch.tensor([0], dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="not sibling pairs"):
        kco.coarse_assemble(*args)
