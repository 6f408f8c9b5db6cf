"""The solve's options `precise_dots` and `anchor_stride` in the PyTorch
port, held against the JAX package on the 144-vertex curved mesh and the
seeded movie of tests/torch_parity.py. On CPU tensors the kernels run their
plain versions (`precise=True`: float64 sums rounded to float32 once).

Tolerances (measured on this mesh in parentheses):
  * precise float32 cg (solve_cg, Jacobi and two-level, and
    compute_velocity_fields on a float32 mesh): iterations within
    ITER_SLACK of JAX's (equal), x within 1e-3 of max|x| at tol 1e-5
    (4e-7), the float32 cg bound of tests/test_torch_solve.py;
  * the plain precise dots against a numpy float64 sum rounded to float32:
    at most one float32 ulp of the result (equal);
  * precise_dots on float64 movies, and on the 'refined' and 'cholesky'
    methods: torch.equal to precise_dots=False;
  * anchor_stride 2 and 3 against JAX's refined solve at tol 1e-9:
    iterations within ITER_SLACK (equal), v_k within 1e-6 of max|v| (2e-13),
    the 'refined' bound of tests/test_torch_solve.py; against the port's
    own cold start within 1e-7 of max|v| (7e-9), the bound of the JAX
    package's own warm-start test (tests/test_solve.py:113-127);
  * stride 1 and strides that leave no anchors: torch.equal to no warm
    start.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manifold_flow_tpu.fem.operator import block_jacobi_inverse as jax_jacobi
from manifold_flow_tpu.fem.operator import make_operator as jax_make_operator
from manifold_flow_tpu.geometry import synthetic as jax_synthetic
from manifold_flow_tpu.solve import coarse as jax_coarse
from manifold_flow_tpu.solve.api import build_rhs as jax_build_rhs
from manifold_flow_tpu.solve.api import compute_velocity_fields as jax_cvf
from manifold_flow_tpu.solve.cg import solve_cg as jax_solve_cg
from manifold_flow_tpu_torch import compute_velocity_fields, mesh_from_jax_arrays
from manifold_flow_tpu_torch.convert import coarse_tables_from_jax_arrays
from manifold_flow_tpu_torch.fem.operator import block_jacobi_inverse, make_operator
from manifold_flow_tpu_torch.kernels import coarse as kco
from manifold_flow_tpu_torch.kernels import fem as kfem
from manifold_flow_tpu_torch.solve import api as solve_api
from manifold_flow_tpu_torch.solve import coarse, refine
from manifold_flow_tpu_torch.solve.api import build_rhs
from manifold_flow_tpu_torch.solve.cg import solve_cg
from tests.torch_parity import LAMBDA, bump, jax_arrays, jmesh, movie, rel_err, wave  # noqa: F401

ITER_SLACK = 2
F32_TOL, F32_X = 1e-5, 1e-3          # float32 cg: tol, bound on x against JAX
REFINED_TOL, REFINED_V = 1e-9, 1e-6  # refined: tol, bound on v_k against JAX
COLD_V = 1e-7                        # warm start against the cold start


@pytest.fixture(scope="module")
def port_mesh(jmesh):  # noqa: F811
    return mesh_from_jax_arrays(jax_arrays(jmesh), device="cpu")


def _f32_problems(jmesh, port_mesh, wave):  # noqa: F811
    """The float32 operator and RHS in both packages (the refined solve's
    inner problem), and the JAX tables of a one-pass aggregation."""
    pot, times = wave
    jop = jax_make_operator(jmesh, jnp.asarray(pot), LAMBDA)
    jf = jax_build_rhs(jmesh, jop, jnp.asarray(pot), jnp.asarray(times))
    jop = dataclasses.replace(jop, blocks2=jop.blocks2.astype(jnp.float32),
                              g=jop.g.astype(jnp.float32),
                              w_scale=jop.w_scale.astype(jnp.float32),
                              lambda_=jop.lambda_.astype(jnp.float32))
    g, f = build_rhs(port_mesh, torch.from_numpy(pot), torch.from_numpy(times))
    op = make_operator(port_mesh, g, LAMBDA).astype(torch.float32)
    return jop, jf.astype(jnp.float32), op, f.float()


@pytest.mark.parametrize("precond", ["jacobi", "two_level"])
def test_precise_cg_matches_jax(jmesh, port_mesh, wave, precond):  # noqa: F811
    """solve_cg(precise_dots=True) in float32 against JAX's: K3's dots and
    update (and K11 under two-level) through their precise plain versions."""
    jop, jf, op, f = _f32_problems(jmesh, port_mesh, wave)
    if precond == "jacobi":
        jpre = jax_jacobi(jmesh, jop.g, jop.lambda_)
        pre = block_jacobi_inverse(port_mesh, op.g, op.lambda_)
    else:
        jt = jax_coarse.build_tables(jmesh, passes=1)
        jpre = jax_coarse.make_two_level(jmesh, jop.g, jop.lambda_, jt)
        tables = coarse_tables_from_jax_arrays(
            {"agg": np.asarray(jt.agg), "seeds": np.asarray(jt.seeds),
             "members": np.asarray(jt.members), "n_coarse": jt.n_coarse}, port_mesh)
        pre = coarse.make_two_level(port_mesh, op.g, op.lambda_, tables)
    want = jax_solve_cg(jop, jf, precond=jpre, tol=F32_TOL, max_iter=2000,
                        precise_dots=True)
    got = solve_cg(op, f, pre, tol=F32_TOL, max_iter=2000, precise_dots=True)
    assert got.x.dtype == torch.float32
    assert abs(got.iterations - int(want.iterations)) <= ITER_SLACK
    assert bool(got.converged.all()) and bool(np.all(np.asarray(want.converged)))
    assert rel_err(got.x.numpy(), np.asarray(want.x)) <= F32_X
    assert rel_err(got.residual.numpy(), np.asarray(want.residual)) <= F32_X


def test_precise_dots_through_the_api_and_frame_windows(monkeypatch):
    """compute_velocity_fields(precise_dots=True) on a float32 mesh against
    JAX's, whole and in windows of 2 frames (the option reaches every
    window's solve_cg)."""
    jm = jax_synthetic.plane_patch(nx=12, ny=12, lx=6.0, ly=6.0, height=bump,
                                   dtype=np.float32)
    pm = mesh_from_jax_arrays(jax_arrays(jm), device="cpu")
    assert pm.dtype == torch.float32
    pot, times = movie(np.asarray(jm.points, dtype=np.float64))
    pot, times = pot.astype(np.float32), times.astype(np.float32)
    seen = []
    inner = solve_api.solve_cg

    def spy(*args, **kwargs):
        seen.append(kwargs["precise_dots"])
        return inner(*args, **kwargs)
    monkeypatch.setattr(solve_api, "solve_cg", spy)
    for chunk in (None, 2):
        kw = dict(method="cg", tol=F32_TOL, precise_dots=True, frame_chunk=chunk)
        want = jax_cvf(jm, jnp.asarray(pot), jnp.asarray(times), **kw)
        got = compute_velocity_fields(pm, pot, times, **kw)
        assert got.v_k.dtype == torch.float32 and bool(got.converged.all())
        assert abs(got.iterations - int(want.iterations)) <= ITER_SLACK
        assert rel_err(got.v_k.numpy(), np.asarray(want.v_k)) <= F32_X
    assert seen == [True] * 4  # one whole solve, then three windows


def test_plain_precise_dots_are_float64_sums_rounded_once():
    """The precise plain versions of K3's dot and update and of K11: every
    product and sum in float64, rounded to float32 once."""
    rng = np.random.default_rng(3)
    t, n = 4, 3000
    a, b = (rng.standard_normal((t, 2 * n)).astype(np.float32) for _ in range(2))
    want = np.sum(a.astype(np.float64) * b.astype(np.float64), axis=-1).astype(np.float32)

    def check(got, want):  # at most one float32 ulp apart
        assert got.dtype == torch.float32
        assert np.all(np.abs(got.numpy() - want) <= np.spacing(np.abs(want)))

    check(kfem.pcg_dot(torch.from_numpy(a), torch.from_numpy(b), precise=True), want)
    # pcg_update with pAp = 0: r and z = D^-1 r as given, then r.z and r.r.
    r = torch.from_numpy(a)
    dinv = torch.from_numpy(rng.standard_normal((t, n, 2, 2)).astype(np.float32))
    zero = torch.zeros(t)
    x, z, rz, rr = torch.zeros_like(r), torch.empty_like(r), torch.empty(t), torch.empty(t)
    kfem.pcg_update(x, r.clone(), z, r, r, dinv, zero, zero, rz, rr, precise=True)
    r64, z64 = r.double().numpy(), z.double().numpy()
    check(rz, np.sum(r64 * z64, axis=-1).astype(np.float32))
    check(rr, np.sum(r64 * r64, axis=-1).astype(np.float32))
    # K11: z += P yc, then r.z.
    agg = torch.from_numpy(rng.integers(0, 7, n).astype(np.int32))
    r_blk = torch.from_numpy(rng.standard_normal((n, 2, 2)).astype(np.float32))
    yc = torch.from_numpy(rng.standard_normal((t, 14)).astype(np.float32))
    zs, rz = torch.from_numpy(b.copy()), torch.empty(t)
    kco.coarse_prolong_dot(zs, r, yc, r_blk, agg, rz, precise=True)
    zd = torch.from_numpy(b.copy())
    kco.plain_coarse_prolong_dot(zd, r, yc, r_blk, agg, torch.empty(t))
    assert torch.equal(zs, zd)  # z does not depend on the option
    check(rz, np.sum(r64 * zs.double().numpy(), axis=-1).astype(np.float32))


@pytest.mark.parametrize("method", ["cg", "refined", "cholesky"])
def test_precise_dots_change_nothing_in_float64_and_off_cg(port_mesh, wave, method):  # noqa: F811
    """A no-op on float64 movies (every method), and 'refined' and
    'cholesky' ignore it, as in JAX."""
    pot, times = wave
    kw = dict(method=method, tol=1e-9)
    base = compute_velocity_fields(port_mesh, pot, times, **kw)
    got = compute_velocity_fields(port_mesh, pot, times, precise_dots=True, **kw)
    assert torch.equal(got.v_k, base.v_k) and got.iterations == base.iterations
    assert torch.equal(got.residual, base.residual)


@pytest.mark.parametrize("stride", [2, 3])
def test_anchor_stride_matches_jax_and_the_cold_start(jmesh, port_mesh, wave,  # noqa: F811
                                                       stride):
    """The temporal warm start against JAX's refined solve (5 velocity
    frames: anchors 0, 2, 4 at stride 2; 0, 3, 4 at stride 3, whose last
    segment's weight is rescaled), and against the port's cold start."""
    pot, times = wave
    kw = dict(method="refined", tol=REFINED_TOL)
    want = jax_cvf(jmesh, jnp.asarray(pot), jnp.asarray(times), anchor_stride=stride, **kw)
    got = compute_velocity_fields(port_mesh, pot, times, anchor_stride=stride, **kw)
    cold = compute_velocity_fields(port_mesh, pot, times, **kw)
    assert bool(got.converged.all())
    assert abs(got.iterations - int(want.iterations)) <= ITER_SLACK
    assert got.iterations > cold.iterations  # the anchors' inner iterations count
    assert rel_err(got.v_k.numpy(), np.asarray(want.v_k)) <= REFINED_V
    scale = float(cold.v_k.abs().max())
    assert float((got.v_k - cold.v_k).abs().max()) < COLD_V * scale


def test_anchor_stride_under_two_level_matches_jax(jmesh, port_mesh, wave):  # noqa: F811
    """The anchors' own two-level preconditioner, built from their frames."""
    pot, times = wave
    kw = dict(method="refined", tol=REFINED_TOL, precond="two_level", coarse_passes=1,
              anchor_stride=2)
    want = jax_cvf(jmesh, jnp.asarray(pot), jnp.asarray(times), **kw)
    got = compute_velocity_fields(port_mesh, pot, times, **kw)
    assert bool(got.converged.all()) and got.coarse_zeroed == 0
    assert abs(got.iterations - int(want.iterations)) <= ITER_SLACK
    assert rel_err(got.v_k.numpy(), np.asarray(want.v_k)) <= REFINED_V


@pytest.mark.parametrize("stride", [1, 5, 9])
def test_anchor_strides_without_anchors_change_nothing(port_mesh, wave, stride):  # noqa: F811
    """Stride 1, and strides of at least the 5 velocity frames, run no
    anchor solve."""
    pot, times = wave
    kw = dict(method="refined", tol=REFINED_TOL)
    base = compute_velocity_fields(port_mesh, pot, times, **kw)
    got = compute_velocity_fields(port_mesh, pot, times, anchor_stride=stride, **kw)
    assert torch.equal(got.v_k, base.v_k) and got.iterations == base.iterations


@pytest.mark.parametrize("stride", [0, -2, 2.5, True, "2"])
def test_bad_anchor_stride_raises(port_mesh, wave, stride):  # noqa: F811
    """Where JAX takes any stride below 2 as no warm start, the port
    raises (ROADMAP Queue C)."""
    pot, times = wave
    with pytest.raises(ValueError, match="anchor_stride"):
        compute_velocity_fields(port_mesh, pot, times, method="refined", anchor_stride=stride)


@pytest.mark.parametrize("n_sys, stride", [(5, 2), (5, 3), (12, 5), (97, 4), (97, 8)])
def test_anchor_interpolation_is_piecewise_linear_through_the_anchors(n_sys, stride):
    """The anchors' interpolant is np.interp over the frame index through
    (anchor frame, solution) pairs: exact at every anchor, the last one
    included."""
    anchors = refine.anchor_frames(n_sys, stride)
    assert anchors[0] == 0 and anchors[-1] == n_sys - 1
    assert torch.equal(anchors[:-1], torch.arange(0, n_sys - 1, stride)) or \
        torch.equal(anchors, torch.arange(0, n_sys, stride))
    xa = torch.from_numpy(np.random.default_rng(n_sys).standard_normal((anchors.numel(), 6)))
    got = refine.interpolate_anchors(xa, n_sys, stride).numpy()
    frames = anchors.numpy()
    keep = np.concatenate([[True], frames[1:] != frames[:-1]])
    want = np.stack([np.interp(np.arange(n_sys), frames[keep], xa.numpy()[keep, j])
                     for j in range(6)], axis=-1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)


def test_anchor_stride_reaches_every_window(port_mesh, monkeypatch):
    """anchor_stride is passed through the frame windows to each window's
    refined solve."""
    pot, times = movie(port_mesh.points.numpy(), n_frames=12)
    seen = []
    inner = solve_api.solve_refined

    def spy(*args, **kwargs):
        seen.append(kwargs["anchor_stride"])
        return inner(*args, **kwargs)
    monkeypatch.setattr(solve_api, "solve_refined", spy)
    got = compute_velocity_fields(port_mesh, pot, times, method="refined", tol=1e-8,
                                  anchor_stride=2, frame_chunk=4)
    assert seen == [2, 2, 2] and bool(got.converged.all())
