"""S2: RBF interpolation of an electrode movie onto the surface, and the
Hilbert phase of each electrode's signal.

scipy.interpolate.Rbf's semantics (the reference's S2_interpolate.py:22-53,
S2_interpolate_phases.py:22-68): the multiquadric kernel
sqrt((r/eps)^2 + 1), eps = (prod(nonzero bbox edges) / n)^(1/dim), the
system Phi - smooth I solved for every frame. Phases: the angle of the
analytic signal along time, e^{i phi} interpolated as its two real planes,
and the angle of the interpolant.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import scipy.signal


def default_epsilon(coords: np.ndarray) -> float:
    edges = coords.max(axis=0) - coords.min(axis=0)
    edges = edges[np.nonzero(edges)]
    return float(np.power(np.prod(edges) / coords.shape[0], 1.0 / edges.size))


def _phi(r, eps, kind):
    if kind != "multiquadric":
        raise ValueError(f"the reference implements the multiquadric kernel only; got {kind!r}")
    return np.sqrt((r / eps) ** 2 + 1)


def _dist(a, b):
    d = a[:, None, :] - b[None, :, :]
    return np.sqrt(np.sum(d * d, -1))


def fit_eval(coords, planes, targets, kind="multiquadric", smooth=0.0, dtype=np.float64):
    """Interpolants (T, P) at `targets` of each plane (T, E) of values."""
    dtype = np.dtype(dtype)
    coords = np.asarray(coords, dtype=dtype)
    targets = np.asarray(targets, dtype=dtype)
    eps = dtype.type(default_epsilon(coords))
    a = _phi(_dist(coords, coords), eps, kind) - np.eye(len(coords), dtype=dtype) * dtype.type(smooth)
    lu = scipy.linalg.lu_factor(a)
    basis = _phi(_dist(targets, coords), eps, kind)                        # (P, E)
    out = []
    for values in planes:
        w = scipy.linalg.lu_solve(lu, np.asarray(values, dtype=dtype).T)   # (E, T)
        out.append((basis @ w.astype(dtype)).T)
    return out


def amplitude(coords, movie, targets, kind="multiquadric", smooth=0.0, dtype=np.float64):
    (out,) = fit_eval(coords, [movie], targets, kind, smooth, dtype)
    return out


def hilbert_phase(signal, dtype=np.float64):
    """angle(hilbert(x)) along time (axis 0) of an (S, E) recording."""
    z = scipy.signal.hilbert(np.asarray(signal, dtype=dtype), axis=0)
    return np.angle(z).astype(dtype)


def phases(coords, phi, targets, kind="multiquadric", smooth=0.0, dtype=np.float64):
    re, im = fit_eval(coords, [np.cos(phi), np.sin(phi)], targets, kind, smooth, dtype)
    return np.arctan2(im, re)
