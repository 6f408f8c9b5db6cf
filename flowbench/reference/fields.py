"""S4's SVD modes and S5's phase wave speed.

S4 (S4_spatiotemporal_decomposition_ConcatMatrices.py:174-197): the thin
SVD of the (T, 2N) movie, its leading `n_modes` triplets, each negated where
the mean of its temporal mode is negative. S5 (S5_compute_wave_v.py:79-123,
136-171, 311-313): each vertex's gradient is the area-weighted mean of the
P1 gradients of its cells, its magnitude is taken on the vertex's tangent
basis, the wrap-aware time derivative of the phase (forward, central,
backward differences) is divided by it, and |speed| / 1000 is kept.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from flowbench.reference.geometry import Surface


def svd_modes(a: np.ndarray, n_modes: int):
    """(u (T, K), sigma (K,), vt (K, 2N)) with the reference's sign rule."""
    u, sig, vt = np.linalg.svd(a, full_matrices=False)
    u, sig, vt = u[:, :n_modes], sig[:n_modes], vt[:n_modes]
    sign = np.where(u.mean(axis=0) < 0, -1, 1).astype(a.dtype)
    return u * sign, sig, vt * sign[:, None]


def singular_values(a: np.ndarray, k: int) -> np.ndarray:
    return np.linalg.svd(a, compute_uv=False)[:k]


def _angle_subtract(a, b):
    return np.remainder(a - b + np.pi, 2 * np.pi) - np.pi


def wave_speed_phase(s: Surface, phi: np.ndarray, dt: float) -> np.ndarray:
    """|phase speed| / 1000 (T, N) of a (T, N) phase movie."""
    t = phi.shape[0]
    grad_m = np.einsum("tmc,mcd->tmd", phi[:, s.tris], s.grad_w)             # (T, M, 3)
    rows = s.tris.ravel()
    cols = np.repeat(np.arange(s.m), 3)
    w = sp.csr_matrix((np.repeat(s.areas, 3), (rows, cols)), shape=(s.n, s.m))
    total = np.asarray(w.sum(axis=1)).ravel()
    g = (w @ grad_m.transpose(1, 0, 2).reshape(s.m, t * 3)).reshape(s.n, t, 3)
    g = g.transpose(1, 0, 2) / total[None, :, None]                        # (T, N, 3)
    e1, e2 = s.basis[None, :, 0], s.basis[None, :, 1]
    mag = np.sqrt(np.sum(g * e1, -1) ** 2 + np.sum(g * e2, -1) ** 2)
    dphi = np.concatenate([
        _angle_subtract(phi[1], phi[0])[None] / dt,
        _angle_subtract(phi[2:], phi[:-2]) / (2 * dt),
        _angle_subtract(phi[-1], phi[-2])[None] / dt])
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.abs(dphi / mag) / 1000.0
