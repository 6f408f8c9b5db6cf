"""K17's fit (`kernels.fields.rbf_fit`) on the CPU: its plain version held
against the JAX package's `_rbf_solve`, the weights' layout and residual,
the wrapper's checks, and the zero pivot of coincident electrodes.

Inputs are made with numpy from a seed on the 144-vertex bumped patch of
tests/conftest.py, with 5 or 65 electrodes picked among its vertices (both
sides of `rbf_eval`'s 64-electrode chunk) and 1 or 17 frames (its 8-frame
tiles part empty), as the `rbf_interpolate` parity tests of
tests/test_torch_fields.py pick them. JAX runs on its CPU backend in
float64. Tolerances: the interpolant of the plain fit's weights to 1e-9 of
the output's largest value, as in those tests (the systems are
ill-conditioned, so the weights differ more than the interpolant); A W = B
to 1e-12 relative in float64 (max |A W - B| over max |A| |W|, the backward
error of an LU solve).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manifold_flow_tpu.ops import interpolate as jax_interp
from manifold_flow_tpu_torch.kernels import LAUNCHES
from manifold_flow_tpu_torch.kernels import fields as kf
from manifold_flow_tpu_torch.ops import interpolate
from tests.torch_parity import jax_curved_mesh

SHAPES = [(5, 1), (5, 17), (65, 1), (65, 17)]   # (electrodes, frames)


@pytest.fixture(scope="module")
def points():
    return np.array(jax_curved_mesh().points)


def _planes(points, n_elec, n_frames, n_planes, seed):
    """Electrode coordinates (E, 3) among the vertices and n_planes seeded
    (T, E) planes of values."""
    rng = np.random.default_rng(seed)
    coords = points[rng.choice(points.shape[0], n_elec, replace=False)]
    return coords, [rng.standard_normal((n_frames, n_elec)) for _ in range(n_planes)]


def _fit(coords, planes, kind, smooth, epsilon=None):
    c = torch.from_numpy(coords)
    eps = interpolate.scipy_default_epsilon(c) if epsilon is None else torch.tensor(epsilon)
    eps = eps.reshape(1).to(c.dtype)
    w, info = kf.rbf_fit(c, eps, [torch.from_numpy(p) for p in planes], kind, smooth)
    return c, eps, w, info


@pytest.mark.parametrize("n_planes", [1, 2])
@pytest.mark.parametrize("smooth", [0.0, 0.1])
@pytest.mark.parametrize("kind", sorted(kf.RBF_KINDS))
def test_plain_rbf_fit_matches_jax(points, kind, smooth, n_planes):
    """The interpolant at every vertex of plain_rbf_fit's weights against
    JAX's _rbf_solve (rbf_interpolate; two planes as one complex value's
    parts), at the electrode and frame counts of SHAPES."""
    for n_elec, n_frames in SHAPES:
        coords, planes = _planes(points, n_elec, n_frames, n_planes, n_elec + n_frames)
        c, eps, w, info = _fit(coords, planes, kind, smooth)
        assert int(info[0]) == 0 and w.shape == (n_planes, n_elec, n_frames)
        x = torch.from_numpy(points)
        got = [kf.plain_rbf_eval(x, c, eps, wi, kind).numpy() for wi in w]
        values = planes[0] if n_planes == 1 else planes[0] + 1j * planes[1]
        want = np.asarray(jax_interp.rbf_interpolate(
            jnp.asarray(coords), jnp.asarray(values), jnp.asarray(points),
            smooth=smooth, kind=kind))
        want = [want] if n_planes == 1 else [want.real, want.imag]
        for g, ref in zip(got, want):
            assert g.shape == (n_frames, points.shape[0])
            err = float(np.abs(g - ref).max()) / float(np.abs(ref).max())
            assert err <= 1e-9, (n_elec, n_frames, err)


@pytest.mark.parametrize("n_elec, n_frames, n_planes",
                         [(1, 3, 1), (24, 37, 1), (64, 98, 2), (65, 17, 2), (7, 0, 2),
                          (0, 5, 1)])
def test_rbf_fit_solves_the_system(points, n_elec, n_frames, n_planes):
    """W is (planes, E, T), each plane's (E, T) contiguous, and A W[i] =
    B_i^T to 1e-12 relative; an empty E or T gives empty weights and info 0.
    On CPU tensors nothing launches."""
    coords, planes = _planes(points, n_elec, n_frames, n_planes, 7)
    before = dict(LAUNCHES)
    c, eps, w, info = _fit(coords, planes, "multiquadric", 0.0, epsilon=1.3)
    assert LAUNCHES == before
    assert w.shape == (n_planes, n_elec, n_frames) and w.dtype == torch.float64
    assert info.dtype == torch.int32 and info.shape == (1,) and int(info[0]) == 0
    assert all(wi.is_contiguous() for wi in w)
    if w.numel() == 0:
        return
    a = kf.plain_rbf_basis(c, eps, "multiquadric")
    for wi, p in zip(w, planes):
        res = float((a @ wi - torch.from_numpy(p).T).abs().max())
        assert res <= 1e-12 * float((a.abs() @ wi.abs()).max())


def _bad_inputs():
    c = torch.rand(6, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    eps = torch.ones(1, dtype=torch.float64)
    plane = torch.rand(4, 6, dtype=torch.float64)
    return c, eps, plane


@pytest.mark.parametrize("case, error, match", [
    ("kind", ValueError, "unknown RBF kind"),
    ("dtype", TypeError, "must be torch.float64"),
    ("plane_shape", ValueError, r"must have shape \(4, 6\)"),
    ("plane_rank", ValueError, r"each plane must be \(T, E\)"),
    ("three_planes", ValueError, "one or two planes"),
    ("non_contiguous", ValueError, "must be contiguous"),
    ("pivots", ValueError, r"pivots must have shape \(6,\)"),
])
def test_rbf_fit_rejects_bad_input(case, error, match):
    """The wrapper's checks, on the CPU as on the card: the kind, the
    planes' dtype (TypeError, as every wrapper's dtype check), shape, rank,
    count and contiguity, and the pivots' shape."""
    c, eps, plane = _bad_inputs()
    kind, planes, pivots = "multiquadric", [plane], None
    if case == "kind":
        kind = "cubic"
    elif case == "dtype":
        planes = [plane.float()]
    elif case == "plane_shape":
        planes = [plane, plane[:, :5].contiguous()]
    elif case == "plane_rank":
        planes = [plane.reshape(-1)]
    elif case == "three_planes":
        planes = [plane] * 3
    elif case == "non_contiguous":
        planes = [torch.rand(6, 4, dtype=torch.float64).T]
    elif case == "pivots":
        pivots = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(error, match=match):
        kf.rbf_fit(c, eps, planes, kind, pivots=pivots)


@pytest.mark.parametrize("phases", [False, True], ids=["real", "phases"])
def test_coincident_electrodes_raise(points, phases):
    """Two electrodes at one place (smooth = 0) make the system singular:
    the fit's info word names the zero pivot and the interpolation raises
    ValueError, where the JAX package returns whatever its factorization
    gives (here finite values that interpolate nothing) without an error."""
    coords, (values,) = _planes(points, 12, 5, 1, 3)
    coords = np.concatenate([coords, coords[4:5]])
    values = np.concatenate([values, values[:, 4:5]], axis=1)
    c, eps, w, info = _fit(coords, [values], "multiquadric", 0.0)
    assert int(info[0]) > 0
    fn = interpolate.rbf_interpolate_phases if phases else interpolate.rbf_interpolate
    with pytest.raises(ValueError, match=f"pivot {int(info[0])} is zero .*coincide"):
        fn(torch.from_numpy(coords), torch.from_numpy(values), torch.from_numpy(points))
    want = np.asarray((jax_interp.rbf_interpolate_phases if phases
                       else jax_interp.rbf_interpolate)(
        jnp.asarray(coords), jnp.asarray(values), jnp.asarray(points)))
    assert want.shape == (5, points.shape[0])
