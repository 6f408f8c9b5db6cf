"""The port's field ops (phases, wave speeds, RBF interpolation, SVD modes,
validation scoring) held against the JAX package on the CPU.

Inputs are made with numpy from a seed on the 144-vertex bumped patch of
tests/conftest.py, with 12-40 electrodes picked among its vertices. JAX runs
on its CPU backend in float64; the port runs the plain torch versions of
K16 and K17 (CPU tensors). Tolerances: phases and Hilbert transforms to
1e-12; wave speeds and gradients to 1e-10 relative where |grad| is above
1e-8 of its largest value, with inf and NaN at the same places (the
quotient amplifies rounding where |grad| is small); interpolants to 1e-9 of
the output's largest value (multiquadric systems are ill-conditioned, so
the weights differ more than the interpolant); singular values and
concat-form modes to 1e-10 (the fixture spectrum is simple), complex modes
through gauge-invariant quantities (sigma, the rank-K reconstruction,
|u|); validation scores equal.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manifold_flow_tpu.ops import interpolate as jax_interp
from manifold_flow_tpu.ops import phase as jax_phase
from manifold_flow_tpu.ops import svd as jax_svd
from manifold_flow_tpu.ops import validation as jax_validation
from manifold_flow_tpu.ops import wavespeed as jax_wave
from manifold_flow_tpu_torch import mesh_from_jax_arrays
from manifold_flow_tpu_torch.kernels import LAUNCHES
from manifold_flow_tpu_torch.kernels import fields as kf
from manifold_flow_tpu_torch.ops import interpolate, phase, svd, validation, wavespeed
from manifold_flow_tpu_torch.utils import io
from tests.torch_parity import jax_arrays, jax_curved_mesh


def rel_err(got, want) -> float:
    """max |got - want| relative to max |want|, for real or complex arrays."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-300)


DT = 1.0 / 512.0


@pytest.fixture(scope="module")
def meshes():
    jmesh = jax_curved_mesh()
    return jmesh, mesh_from_jax_arrays(jax_arrays(jmesh), device="cpu")


def _movie(n_vertices, n_frames=9, seed=0):
    """A smooth travelling wave over the vertices plus seeded noise (T, N)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 4.0 * np.pi, n_vertices)
    t = np.arange(n_frames)[:, None] * 0.3
    return np.cos(x[None, :] - t) + 0.05 * rng.standard_normal((n_frames, n_vertices))


# -------------------------------------------------------------- phases ----
@pytest.mark.parametrize("n", [16, 17], ids=["even", "odd"])
@pytest.mark.parametrize("axis", [0, -1])
def test_hilbert_and_phase_match_jax(n, axis):
    x = np.random.default_rng(n).standard_normal((n, 11) if axis == 0 else (7, n))
    got = phase.hilbert(torch.from_numpy(x), axis=axis).numpy()
    want = np.asarray(jax_phase.hilbert(jnp.asarray(x), axis=axis))
    assert got.dtype == np.complex128
    assert rel_err(got, want) <= 1e-12
    got = phase.instantaneous_phase(torch.from_numpy(x), axis=axis).numpy()
    want = np.asarray(jax_phase.instantaneous_phase(jnp.asarray(x), axis=axis))
    assert float(np.abs(got - want).max()) <= 1e-12


def test_phase_wrap_at_pi_matches_jax():
    """angle_subtract wraps into [-pi, pi) as jnp.mod does: exactly at +-pi
    and at multiples of 2 pi too, bit for bit."""
    f1 = np.array([math.pi, -math.pi, 0.0, 3 * math.pi, -3 * math.pi, 2 * math.pi,
                   1.0, -2.5, math.pi - 1e-12])
    f2 = np.array([0.0, 0.0, math.pi, 0.0, 0.0, 0.0, -math.pi, math.pi, -math.pi])
    got = phase.angle_subtract(torch.from_numpy(f1), torch.from_numpy(f2)).numpy()
    want = np.asarray(jax_phase.angle_subtract(jnp.asarray(f1), jnp.asarray(f2)))
    np.testing.assert_array_equal(got, want)
    assert got[0] == got[1] == -math.pi
    assert (got >= -math.pi).all() and (got < math.pi).all()
    np.testing.assert_array_equal(
        phase.angle_subtract(torch.from_numpy(f1), torch.from_numpy(f2), False).numpy(),
        f1 - f2)


def test_temporal_gradients_match_jax():
    x = _movie(30, n_frames=7)
    for name in ("temporal_gradient_phase", "temporal_gradient_amplitude"):
        got = getattr(phase, name)(torch.from_numpy(x), DT).numpy()
        want = np.asarray(getattr(jax_phase, name)(jnp.asarray(x), DT))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


# --------------------------------------------------------- wave speeds ----
def _speeds_close(got, want, mag):
    got, want, mag = np.asarray(got), np.asarray(want), np.asarray(mag)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want) & (mag > 1e-8 * mag.max()) & (want != 0)
    assert ok.any()
    assert float((np.abs(got[ok] - want[ok]) / np.abs(want[ok])).max()) <= 1e-10


def test_vertex_gradients_and_magnitude_match_jax(meshes):
    jmesh, tmesh = meshes
    x = _movie(tmesh.n_vertices)
    got = wavespeed.vertex_gradients(tmesh, torch.from_numpy(x)).numpy()
    want = np.asarray(jax_wave.vertex_gradients(jmesh, jnp.asarray(x)))
    assert got.shape == (9, tmesh.n_vertices, 3) and rel_err(got, want) <= 1e-12
    got = wavespeed.tangential_gradient_magnitude(tmesh, torch.from_numpy(x)).numpy()
    want = np.asarray(jax_wave.tangential_gradient_magnitude(jmesh, jnp.asarray(x)))
    assert rel_err(got, want) <= 1e-12


@pytest.mark.parametrize("method", ["wave_velocity_amplitude", "wave_velocity_phase",
                                    "wave_velocity_phase_mm_per_ms"])
def test_wave_speeds_match_jax(meshes, method):
    """On a movie whose frames 3-5 are flat (zero), where |grad| = 0 gives
    inf (a non-zero time derivative) and NaN (0 / 0), as in JAX."""
    jmesh, tmesh = meshes
    x = _movie(tmesh.n_vertices)
    if "phase" in method:
        x = np.angle(np.exp(3j * x))
    x[3:6] = 0.0
    got = getattr(wavespeed, method)(tmesh, torch.from_numpy(x), DT).numpy()
    want = np.asarray(getattr(jax_wave, method)(jmesh, jnp.asarray(x), DT))
    mag = np.asarray(jax_wave.tangential_gradient_magnitude(jmesh, jnp.asarray(x)))
    _speeds_close(got, want, mag)
    assert np.isnan(got[4]).all() and np.isinf(got[3]).any()


@pytest.mark.parametrize("n_frames", [3, 17], ids=["end_stencils", "group_cut_short"])
@pytest.mark.parametrize("method", ["wave_velocity_amplitude", "wave_velocity_phase"])
def test_wave_speeds_at_frame_group_edges_match_jax(meshes, method, n_frames):
    """Movies whose length puts the K16 frame groups' edges where its
    one-sided stencils are (3 frames: every frame an end or beside one) and
    cuts the last group short (17 frames), with frame 1 flat (inf and NaN
    where |grad| = 0, as in JAX)."""
    jmesh, tmesh = meshes
    x = _movie(tmesh.n_vertices, n_frames=n_frames, seed=n_frames)
    if "phase" in method:
        x = np.angle(np.exp(3j * x))
    x[1] = 0.0
    got = getattr(wavespeed, method)(tmesh, torch.from_numpy(x), DT).numpy()
    want = np.asarray(getattr(jax_wave, method)(jmesh, jnp.asarray(x), DT))
    mag = np.asarray(jax_wave.tangential_gradient_magnitude(jmesh, jnp.asarray(x)))
    assert got.shape == (n_frames, tmesh.n_vertices)
    _speeds_close(got, want, mag)
    assert not np.isfinite(got[1]).any()


def test_short_movies_raise_where_jax_clamps(meshes):
    """np.gradient(edge_order=2), which the reference calls (S5:24), raises
    on fewer than 3 frames, and the phase differences need 2: the port
    raises. The JAX package clamps the out-of-range frame indices instead
    and returns numbers, two rows even for a one-frame phase movie (ROADMAP
    Queue C, C8)."""
    jmesh, tmesh = meshes
    x = _movie(tmesh.n_vertices, n_frames=2)
    with pytest.raises(ValueError):
        np.gradient(x, axis=0, edge_order=2)
    with pytest.raises(ValueError, match="at least 3 frames"):
        wavespeed.wave_velocity_amplitude(tmesh, torch.from_numpy(x), DT)
    clamped = np.asarray(jax_wave.wave_velocity_amplitude(jmesh, jnp.asarray(x), DT))
    assert clamped.shape == x.shape and np.isfinite(clamped).all()
    with pytest.raises(ValueError, match="at least 2 frames"):
        wavespeed.wave_velocity_phase(tmesh, torch.from_numpy(x[:1]), DT)
    assert np.asarray(jax_wave.wave_velocity_phase(jmesh, jnp.asarray(x[:1]), DT)).shape == (
        2, tmesh.n_vertices)
    two = wavespeed.wave_velocity_phase(tmesh, torch.from_numpy(x), DT).numpy()
    _speeds_close(two, np.asarray(jax_wave.wave_velocity_phase(jmesh, jnp.asarray(x), DT)),
                  np.asarray(jax_wave.tangential_gradient_magnitude(jmesh, jnp.asarray(x))))


def test_wave_wrapper_checks_and_counts_nothing_on_cpu(meshes):
    _, tmesh = meshes
    x = torch.from_numpy(_movie(tmesh.n_vertices))
    args = (tmesh.triangles, tmesh.grad_w, tmesh.areas, tmesh.vertex_cells, tmesh.basis)
    before = dict(LAUNCHES)
    kf.wave_speed(x, *args, DT, "phase")
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="unknown output"):
        kf.wave_speed(x, *args, DT, "speed")
    with pytest.raises(TypeError, match="grad_w must be torch.float32"):
        kf.wave_speed(x.float(), *args, DT, "phase")
    with pytest.raises(ValueError, match=r"movie must be \(T, N\)"):
        kf.wave_speed(x[None], *args, DT, "phase")


# ------------------------------------------------------- interpolation ----
def _electrodes(mesh, n, seed):
    sel = np.random.default_rng(seed).choice(mesh.n_vertices, n, replace=False)
    return np.asarray(mesh.points)[sel], sel


def test_default_epsilon_matches_jax(meshes):
    jmesh, _ = meshes
    for coords in (_electrodes(jmesh, 20, 1)[0],
                   np.c_[_electrodes(jmesh, 12, 2)[0][:, :2], np.zeros(12)]):
        got = float(interpolate.scipy_default_epsilon(torch.from_numpy(coords)))
        want = float(jax_interp.scipy_default_epsilon(jnp.asarray(coords)))
        assert got == pytest.approx(want, rel=1e-14)


@pytest.mark.parametrize("kind", sorted(kf.RBF_KINDS))
def test_rbf_interpolate_matches_jax(meshes, kind):
    jmesh, tmesh = meshes
    coords, sel = _electrodes(jmesh, 40, 3)
    values = _movie(jmesh.n_vertices, n_frames=6)[:, sel]
    got = interpolate.rbf_interpolate(torch.from_numpy(coords), torch.from_numpy(values),
                                      tmesh.points, kind=kind, smooth=0.01).numpy()
    want = np.asarray(jax_interp.rbf_interpolate(
        jnp.asarray(coords), jnp.asarray(values), jmesh.points, kind=kind, smooth=0.01))
    assert got.shape == (6, jmesh.n_vertices) and rel_err(got, want) <= 1e-9


def test_rbf_interpolate_phases_and_complex_match_jax(meshes):
    jmesh, tmesh = meshes
    coords, sel = _electrodes(jmesh, 12, 4)
    phi = np.angle(np.exp(2j * _movie(jmesh.n_vertices, n_frames=5)[:, sel]))
    got = interpolate.rbf_interpolate_phases(
        torch.from_numpy(coords), torch.from_numpy(phi), tmesh.points).numpy()
    want = np.asarray(jax_interp.rbf_interpolate_phases(
        jnp.asarray(coords), jnp.asarray(phi), jmesh.points))
    assert float(np.abs(np.angle(np.exp(1j * (got - want)))).max()) <= 1e-9
    z = np.exp(1j * phi)
    got = interpolate.rbf_interpolate(torch.from_numpy(coords), torch.from_numpy(z),
                                      tmesh.points).numpy()
    want = np.asarray(jax_interp.rbf_interpolate(jnp.asarray(coords), jnp.asarray(z),
                                                 jmesh.points))
    assert got.dtype == np.complex128 and rel_err(got, want) <= 1e-9


# (coordinates, values, JAX's result dtype, tolerance): the interpolant to
# 1e-9 of its largest value where both packages compute in float64, and to
# 1e-4 where the fit or the evaluation is float32 (float32 rounding times
# the system's conditioning: 6e-6 to 9e-6 on these inputs).
MIXED_DTYPES = [
    (np.float64, np.complex64, np.complex64, 1e-4),
    (np.float32, np.float64, np.float64, 1e-4),
    (np.float64, np.float32, np.float64, 1e-9),
    (np.float32, np.complex128, np.complex128, 1e-4),
]


@pytest.mark.parametrize("coord_dtype, value_dtype, want_dtype, tol", MIXED_DTYPES,
                         ids=["f64_c64", "f32_f64", "f64_f32", "f32_c128"])
def test_rbf_interpolate_mixed_dtypes_match_jax(meshes, coord_dtype, value_dtype,
                                                want_dtype, tol):
    """The result takes JAX's dtype: the system is solved in the
    coordinates' dtype, complex values are evaluated in their real dtype,
    real values in the promoted dtype of targets, coordinates and values."""
    jmesh, tmesh = meshes
    coords, sel = _electrodes(jmesh, 12, 4)
    movie = _movie(jmesh.n_vertices, n_frames=5)[:, sel]
    values = (np.exp(1j * movie) if np.issubdtype(value_dtype, np.complexfloating)
              else movie).astype(value_dtype)
    coords = coords.astype(coord_dtype)
    got = interpolate.rbf_interpolate(torch.from_numpy(coords), torch.from_numpy(values),
                                      tmesh.points, smooth=0.01).numpy()
    want = np.asarray(jax_interp.rbf_interpolate(
        jnp.asarray(coords), jnp.asarray(values), jmesh.points, smooth=0.01))
    assert got.dtype == want.dtype == want_dtype
    assert rel_err(got, want) <= tol


@pytest.mark.parametrize("n_frames", [1, 17], ids=["one_frame", "frames_17"])
@pytest.mark.parametrize("n_elec", [5, 65], ids=["e5", "e65"])
def test_rbf_interpolate_at_tile_edges_matches_jax(meshes, n_elec, n_frames):
    """Electrode counts on both sides of K17's 64-electrode chunk and frame
    counts that leave its 8-frame tiles part empty, on the 144 vertices
    (not a whole number of its 64-target blocks)."""
    jmesh, tmesh = meshes
    coords, sel = _electrodes(jmesh, n_elec, 10 + n_elec)
    values = _movie(jmesh.n_vertices, n_frames=n_frames, seed=n_frames)[:, sel]
    got = interpolate.rbf_interpolate(torch.from_numpy(coords), torch.from_numpy(values),
                                      tmesh.points, smooth=0.01).numpy()
    want = np.asarray(jax_interp.rbf_interpolate(
        jnp.asarray(coords), jnp.asarray(values), jmesh.points, smooth=0.01))
    assert got.shape == (n_frames, jmesh.n_vertices) and rel_err(got, want) <= 1e-9


@pytest.mark.parametrize("n_frames", [1, 17], ids=["one_frame", "frames_17"])
@pytest.mark.parametrize("n_elec", [5, 65], ids=["e5", "e65"])
def test_rbf_interpolate_phases_at_tile_edges_matches_jax(meshes, n_elec, n_frames):
    """rbf_interpolate_phases at the shapes of the test above: the angle
    of the complex interpolant, within 1e-9 rad of JAX's."""
    jmesh, tmesh = meshes
    coords, sel = _electrodes(jmesh, n_elec, 20 + n_elec)
    phi = np.angle(np.exp(2j * _movie(jmesh.n_vertices, n_frames=n_frames,
                                      seed=n_frames)[:, sel]))
    got = interpolate.rbf_interpolate_phases(
        torch.from_numpy(coords), torch.from_numpy(phi), tmesh.points, smooth=0.01).numpy()
    want = np.asarray(jax_interp.rbf_interpolate_phases(
        jnp.asarray(coords), jnp.asarray(phi), jmesh.points, smooth=0.01))
    assert got.shape == (n_frames, jmesh.n_vertices)
    assert float(np.abs(np.angle(np.exp(1j * (got - want)))).max()) <= 1e-9


# ------------------------------------------------------------- SVD -----
@pytest.fixture(scope="module")
def v_k(meshes):
    """A velocity movie (T, 2N) of a few dominant modes with a simple spectrum."""
    _, tmesh = meshes
    rng = np.random.default_rng(5)
    t, n2 = 10, tmesh.n_dof
    u = np.linalg.qr(rng.standard_normal((t, 4)))[0]
    v = np.linalg.qr(rng.standard_normal((n2, 4)))[0]
    return (u * [9.0, 5.0, 2.0, 1.0]) @ v.T + 1e-3 * rng.standard_normal((t, n2))


def test_decompose_concat_matches_jax(v_k):
    got = svd.decompose_concat(torch.from_numpy(v_k), n_modes=4)
    want = jax_svd.decompose_concat(jnp.asarray(v_k), n_modes=4)
    for name in ("u", "sigma", "vt"):
        assert rel_err(getattr(got, name).numpy(), np.asarray(getattr(want, name))) <= 1e-10
    for name in ("pct", "pct_squared"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert (got.u.mean(dim=0) >= 0).all()


def test_decompose_complex_matches_jax_up_to_gauge(meshes, v_k):
    """Complex modes keep a free phase each: compare sigma, the rank-K
    reconstruction, |u| and |vt|, and the sign convention's mean Re(u)."""
    _, tmesh = meshes
    got = svd.decompose_complex(torch.from_numpy(v_k), n_modes=3)
    want = jax_svd.decompose_complex(jnp.asarray(v_k), n_modes=3)
    assert got.u.dtype == torch.complex128 and got.vt.shape == (3, tmesh.n_vertices)
    assert rel_err(got.sigma.numpy(), np.asarray(want.sigma)) <= 1e-10
    np.testing.assert_array_equal(got.pct.numpy(), np.asarray(want.pct))
    rec = (got.u.numpy() * got.sigma.numpy()) @ got.vt.numpy()
    rec_want = (np.asarray(want.u) * np.asarray(want.sigma)) @ np.asarray(want.vt)
    assert rel_err(rec, rec_want) <= 1e-10
    assert rel_err(np.abs(got.u.numpy()), np.abs(np.asarray(want.u))) <= 1e-8
    assert rel_err(np.abs(got.vt.numpy()), np.abs(np.asarray(want.vt))) <= 1e-8
    assert (got.u.real.mean(dim=0) >= 0).all()


def test_mode_helpers_match_jax(meshes, v_k):
    jmesh, tmesh = meshes
    modes = svd.decompose_concat(torch.from_numpy(v_k), n_modes=2)
    cz = svd.concat_modes_to_complex(modes.vt)
    np.testing.assert_array_equal(cz.numpy(), np.asarray(jax_svd.concat_modes_to_complex(
        jnp.asarray(modes.vt.numpy()))))
    sv = modes.sigma[:, None] * cz
    got = svd.mode_to_world(sv, tmesh.basis).numpy()
    want = np.asarray(jax_svd.mode_to_world(jnp.asarray(sv.numpy()), jmesh.basis))
    assert got.shape == (2, tmesh.n_vertices, 3) and rel_err(got, want) <= 1e-14
    real = svd.mode_to_world(modes.vt[:, : tmesh.n_vertices], tmesh.basis).numpy()
    np.testing.assert_array_equal(real, np.asarray(jax_svd.mode_to_world(
        jnp.asarray(modes.vt[:, : tmesh.n_vertices].numpy()), jmesh.basis)))
    s = torch.tensor([3.0, 2.0, 1.0, 0.5], dtype=torch.float64)
    for g, w in zip(svd.mode_percentages(s), jax_svd.mode_percentages(jnp.asarray(s.numpy()))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------- validation ----
def test_score_all_frames_matches_jax(meshes):
    """Random detections near (and far from) two true sources, an empty
    frame and a frame past the turning point: every field equal."""
    jmesh, tmesh = meshes
    pts = np.asarray(jmesh.points)
    rng = np.random.default_rng(6)
    truth = pts[[20, 110]]
    detected = [pts[rng.choice(len(pts), k, replace=False)] + 0.05 * rng.standard_normal((k, 3))
                for k in (3, 1, 5, 2)]
    detected.insert(2, np.zeros((0, 3)))
    for threshold, turning in ((1.5, 4), (10.0, 10)):
        got = validation.score_all_frames(tmesh, detected, [truth] * 5, threshold, turning)
        want = jax_validation.score_all_frames(jmesh, detected, [truth] * 5, threshold,
                                               turning)
        assert got == want and got.matched > 0
    one = validation.frame_displacement_difference(tmesh, 2.0, detected[0], truth, 0, 5)
    assert one == jax_validation.frame_displacement_difference(jmesh, 2.0, detected[0],
                                                               truth, 0, 5)


# ------------------------------------------------------------------ IO ----
def test_load_grid_electrodes_matches_jax(tmp_path):
    """The csv-module reader keeps the JAX (pandas) reader's rows: the
    group filter, names, exclude, and rows with 'n/a' or NaN coordinates
    skipped."""
    from manifold_flow_tpu.utils import io as jax_io

    rows = ["name\tx\ty\tz\tsize\tgroup",
            "G1\t1.5\t-2.25\t3.0\t4.2\tgrid", "G2\tn/a\tn/a\tn/a\t4.2\tgrid",
            "G3\t0.125\t7\t-1e-3\t4.2\tgrid", "S1\t9\t9\t9\t1\tstrip",
            "G4\t2\tNaN\t1\t4.2\tgrid", "G5\t-0.5\t0.5\t12.75\t4.2\tgrid"]
    path = tmp_path / "electrodes.tsv"
    path.write_text("\n".join(rows) + "\n")
    for kw in ({}, {"group": "strip"}, {"group": None}, {"exclude": ["G3"]},
               {"names": ["G5", "G1", "S1"]}, {"with_names": True}):
        got, want = io.load_grid_electrodes(path, **kw), jax_io.load_grid_electrodes(path, **kw)
        if kw.get("with_names"):
            assert got[1] == want[1] == ["G1", "G3", "G5"]
            got, want = got[0], want[0]
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
