"""S4's QR + Jacobi route (ops/svd.py, kernels/svd.py K18) against numpy's
LAPACK SVD, on movies made to be hard for it: graded spectra down to 1e-12
of the largest singular value, repeated and clustered values, a
rank-deficient movie, odd m, a tall movie, and both n_modes. On the CPU the
route runs K18's plain version behind torch.geqrf / torch.ormqr.

Tolerances, over the largest singular value: each singular value within
1e-13; the residuals |A v - s u| and |A^T u - s v| and the vectors'
orthonormality within 1e-12 (one-sided Jacobi stops where every pair of
columns is orthogonal to m eps of their norms, so each u is orthogonal to
the others whatever its singular value). Two calls give the same bits.

This file imports no JAX; its `cuda` case (K18 against its plain version on
the card) runs on a machine with a GPU as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_svd_route.py
"""

import itertools

import numpy as np
import pytest
import torch

from manifold_flow_tpu_torch.kernels import svd as jsvd
from manifold_flow_tpu_torch.ops import svd
from manifold_flow_tpu_torch.utils import profiling

# The most sweeps any movie or factor below takes is 13 (the clustered movie).
SWEEP_BOUND = 16


def _orthonormal(rng, n, k):
    return np.linalg.qr(rng.standard_normal((n, k)))[0]


def _with_spectrum(rng, t, n2, sigma):
    k = len(sigma)
    return (_orthonormal(rng, t, k) * sigma) @ _orthonormal(rng, n2, k).T


def _movie(kind):
    rng = np.random.default_rng(["graded", "clustered", "rank_deficient", "odd_m",
                                 "tall"].index(kind) + 11)
    if kind == "graded":
        return _with_spectrum(rng, 40, 300, 10.0 ** -np.linspace(0.0, 12.0, 40))
    if kind == "clustered":
        sigma = np.concatenate([[5.0] * 6, [2.0] * 5, 1.0 + 1e-10 * np.arange(8),
                                0.5 + 1e-3 * rng.random(17)])
        return _with_spectrum(rng, 36, 240, sigma)
    if kind == "rank_deficient":
        return rng.standard_normal((30, 5)) @ rng.standard_normal((5, 200))
    if kind == "odd_m":
        return _with_spectrum(rng, 37, 250, np.geomspace(3.0, 1e-4, 37))
    return _with_spectrum(rng, 120, 50, np.geomspace(7.0, 1e-6, 50))  # tall: T > 2N


MOVIES = ["graded", "clustered", "rank_deficient", "odd_m", "tall"]


def _decomposed(a, n_modes):
    with profiling.record() as rec:
        modes = svd.decompose_concat(torch.from_numpy(a), n_modes=n_modes)
    return modes, rec.summary()


@pytest.mark.parametrize("n_modes", [4, None])
@pytest.mark.parametrize("kind", MOVIES)
def test_route_matches_lapack(kind, n_modes):
    a = _movie(kind)
    modes, summary = _decomposed(a, n_modes)
    u, s, vt = (x.numpy() for x in (modes.u, modes.sigma, modes.vt))
    want = np.linalg.svd(a, compute_uv=False)
    k = len(want) if n_modes is None else n_modes
    scale = want[0]
    assert u.shape == (a.shape[0], k) and vt.shape == (k, a.shape[1]) and s.shape == (k,)
    assert np.abs(s - want[:k]).max() <= 1e-13 * scale
    assert np.linalg.norm(a @ vt.T - u * s, axis=0).max() <= 1e-12 * scale
    assert np.linalg.norm(a.T @ u - vt.T * s, axis=0).max() <= 1e-12 * scale
    assert np.abs(u.T @ u - np.eye(k)).max() <= 1e-12
    assert np.abs(vt @ vt.T - np.eye(k)).max() <= 1e-12
    assert (u.mean(axis=0) >= 0).all()
    # The percentages of every singular value, as the library route gives them.
    pct, pct2 = svd.mode_percentages(torch.from_numpy(want))
    np.testing.assert_array_equal(modes.pct.numpy(), pct[:k].numpy())
    np.testing.assert_array_equal(modes.pct_squared.numpy(), pct2[:k].numpy())
    assert set(summary["spans"]) == {"svd.qr", "svd.jacobi", "svd.vectors"}
    assert 2 <= summary["counts"]["svd.jacobi_sweeps"] <= SWEEP_BOUND


@pytest.mark.parametrize("kind", ["graded", "clustered", "tall"])
def test_two_calls_give_the_same_bits(kind):
    a = torch.from_numpy(_movie(kind))
    first, second = svd.decompose_concat(a), svd.decompose_concat(a)
    for name in ("u", "sigma", "vt", "pct", "pct_squared"):
        assert torch.equal(getattr(first, name), getattr(second, name)), name


def test_other_movies_keep_the_library_svd():
    """Complex and float32 movies take torch.linalg.svd; no Jacobi span."""
    a = _movie("odd_m")
    for movie in (torch.from_numpy(a[:, :125] + 1j * a[:, 125:]),
                  torch.from_numpy(a).float()):
        with profiling.record() as rec:
            modes = svd._decompose(movie, 3)
        summary = rec.summary()
        assert set(summary["spans"]) == {"svd.library"} and not summary["counts"]
        assert modes.u.dtype == movie.dtype and modes.sigma.shape == (3,)


def test_jacobi_factors_its_matrix():
    """K18's plain version on a random triangle (G = R^T of the route, and
    the harder R itself): G W = U diag(s), U and W orthonormal, s
    descending, the sweep count within the bound."""
    rng = np.random.default_rng(3)
    r = np.triu(rng.standard_normal((45, 45)))
    for g in (r, r.T):
        u, s, w, sweeps = jsvd.jacobi_svd(torch.from_numpy(np.ascontiguousarray(g)))
        gm, um, wm = g.T, u.numpy().T, w.numpy().T  # the matrix, columns as columns
        s = s.numpy()
        assert np.abs(gm @ wm - um * s).max() <= 1e-13 * s[0]
        assert np.abs(um.T @ um - np.eye(45)).max() <= 1e-12
        assert np.abs(wm.T @ wm - np.eye(45)).max() <= 1e-12
        assert (np.diff(s) <= 0).all()
        assert np.abs(s - np.linalg.svd(gm, compute_uv=False)).max() <= 1e-13 * s[0]
        assert int(sweeps) <= SWEEP_BOUND


@pytest.mark.parametrize("scale", [2.0 ** -900, 1e-170, 2.0 ** 900])
def test_jacobi_takes_any_scale(scale):
    """A factor far outside the range in which the squares of its column
    norms and their products hold (|G| 1e-271 to 1e271) gives the unscaled
    factor's vectors and its singular values times the scale: the same bits
    where the scale is a power of two."""
    rng = np.random.default_rng(5)
    g = torch.from_numpy(np.triu(rng.standard_normal((21, 21))))
    u0, s0, w0, sweeps0 = jsvd.jacobi_svd(g)
    u, s, w, sweeps = jsvd.jacobi_svd(g * scale)
    assert int(sweeps) == int(sweeps0)
    if np.log2(scale).is_integer():
        assert torch.equal(u, u0) and torch.equal(w, w0) and torch.equal(s, s0 * scale)
    else:
        assert float((s / scale - s0).abs().max()) <= 1e-13 * float(s0[0])
        assert float((u - u0).abs().max()) <= 1e-10 and float((w - w0).abs().max()) <= 1e-10


def test_a_zero_factor_gives_the_identity():
    u, s, w, sweeps = jsvd.jacobi_svd(torch.zeros((5, 5), dtype=torch.float64))
    assert torch.equal(u, torch.eye(5, dtype=torch.float64))
    assert torch.equal(w, torch.eye(5, dtype=torch.float64))
    assert not s.any() and int(sweeps) == 1


@pytest.mark.parametrize("m", [1, 2, 15, 16, 17, 97, 390, 1024])
def test_schedule_meets_every_pair_once_a_sweep(m):
    """Each step's pairs are disjoint, and a sweep's steps hold every pair
    of the 2pb columns exactly once."""
    b, p = jsvd.layout(m)
    assert b % 2 == 0 and 2 * p * b >= m and 2 * (p - 1) * b < max(m, 1)
    seen = []
    for first, second in jsvd.schedule(b, p):
        cols = first + second
        assert len(set(cols)) == len(cols)
        seen += [tuple(sorted(pair)) for pair in zip(first, second)]
    assert sorted(seen) == list(itertools.combinations(range(2 * p * b), 2))


def test_jacobi_wrapper_checks_its_input():
    with pytest.raises(TypeError):
        jsvd.jacobi_svd(torch.zeros((4, 4), dtype=torch.float32))
    with pytest.raises(ValueError):
        jsvd.jacobi_svd(torch.zeros((4, 5), dtype=torch.float64))
    with pytest.raises(ValueError):
        jsvd.jacobi_svd(torch.zeros((1025, 1025), dtype=torch.float64))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K18 has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_jacobi_kernel_matches_plain(cuda):
    """K18 against its plain version on the factor of a (390, 7394) movie of
    a few waves over noise (the shape of recon3k.fields): the same sweep
    count, singular values within 1e-13 of the largest, G W = U diag(s),
    one launch a call, and two calls with the same bits."""
    from manifold_flow_tpu_torch import kernels

    rng = np.random.default_rng(7)
    a = _with_spectrum(rng, 390, 7394, [40.0, 25.0, 9.0, 6.0, 2.0, 1.0])
    a += 0.01 * rng.standard_normal(a.shape)
    q, _ = torch.geqrf(torch.from_numpy(a).to(cuda).mT)
    g = torch.triu(q[:390]).contiguous()
    before = kernels.LAUNCHES["jacobi_svd<double>"]
    got = jsvd.jacobi_svd(g)
    again = jsvd.jacobi_svd(g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["jacobi_svd<double>"] == before + 2
    want = jsvd.plain_jacobi_svd(g)
    assert int(got[3]) == int(want[3]) <= SWEEP_BOUND
    s = got[1]
    assert float((s - want[1]).abs().max()) <= 1e-13 * float(s[0])
    gm = g.T
    resid = gm @ got[2].T - got[0].T * s
    assert float(resid.abs().max()) <= 1e-13 * float(s[0])
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [5, 97, 600])
def test_jacobi_kernel_at_other_widths(cuda, m):
    """K18 at the other register widths (m <= 128 and m > 512, 2 to 38
    pairs of blocks) on a graded factor: sweep counts at most one apart
    from its plain version's (the last sweep's test sits on the tolerance),
    singular values within 1e-13 of the largest, G W = U diag(s), U and W
    orthonormal within 1e-12."""
    rng = np.random.default_rng(m)
    a = _with_spectrum(rng, m, 3 * m, np.geomspace(5.0, 1e-6, m))
    q, _ = torch.geqrf(torch.from_numpy(a).to(cuda).mT)
    g = torch.triu(q[:m]).contiguous()
    u, s, w, sweeps = jsvd.jacobi_svd(g)
    want = jsvd.plain_jacobi_svd(g)
    assert abs(int(sweeps) - int(want[3])) <= 1 and int(sweeps) <= SWEEP_BOUND
    assert float((s - want[1]).abs().max()) <= 1e-13 * float(s[0])
    assert float((g.T @ w.T - u.T * s).abs().max()) <= 1e-13 * float(s[0])
    eye = torch.eye(m, dtype=torch.float64, device=cuda)
    assert float((u @ u.T - eye).abs().max()) <= 1e-12
    assert float((w @ w.T - eye).abs().max()) <= 1e-12


@pytest.mark.cuda
def test_route_on_the_card(cuda, monkeypatch):
    """On the card a real float64 movie runs one K18 launch and never
    torch.linalg.svd, and matches LAPACK as on the CPU; a complex movie
    runs torch.linalg.svd."""
    from manifold_flow_tpu_torch import kernels

    a = _movie("graded")
    library_svd = torch.linalg.svd
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[0].dtype)
        return library_svd(*args, **kwargs)

    monkeypatch.setattr(torch.linalg, "svd", counted)
    before = kernels.LAUNCHES["jacobi_svd<double>"]
    modes = svd.decompose_concat(torch.from_numpy(a).to(cuda), n_modes=None)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["jacobi_svd<double>"] == before + 1 and not calls
    u, s, vt = (x.cpu().numpy() for x in (modes.u, modes.sigma, modes.vt))
    want = np.linalg.svd(a, compute_uv=False)
    assert np.abs(s - want).max() <= 1e-13 * want[0]
    assert np.linalg.norm(a @ vt.T - u * s, axis=0).max() <= 1e-12 * want[0]
    assert np.abs(u.T @ u - np.eye(len(s))).max() <= 1e-12
    svd.decompose_complex(torch.from_numpy(a).to(cuda), n_modes=3)
    assert calls == [torch.complex128]
