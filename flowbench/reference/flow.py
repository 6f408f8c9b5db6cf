"""S3: the P1-FEM optical-flow system of one frame, solved directly.

(a1_k + lambda a2) V_k = f_k, as the reference's utils/compute_optical_flow
.py builds it (a2 :60-93, 258-270; a1 :113-141, 273-285; f :288-311): DOF
i + N alpha is vertex i's coefficient on its tangent basis vector e_i^alpha.
One sparse LU solve (SuperLU) per frame, in the surface's dtype; the world
vectors V_k = c1 e1 + c2 e2 do not depend on the choice of the bases.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import spsolve

from flowbench.reference.geometry import Surface


def _dofs(s: Surface) -> np.ndarray:
    return s.tris[:, :, None] + s.n * np.arange(2)[None, None, :]    # (M, 3, 2)


def _scatter(s: Surface, blocks: np.ndarray) -> sp.csc_matrix:
    dof = _dofs(s)
    rows = np.broadcast_to(dof[:, :, :, None, None], blocks.shape).ravel()
    cols = np.broadcast_to(dof[:, None, None, :, :], blocks.shape).ravel()
    return sp.coo_matrix((blocks.ravel(), (rows, cols)), shape=(2 * s.n, 2 * s.n)).tocsc()


def regularization(s: Surface) -> sp.csc_matrix:
    """a2 (2N, 2N): sum over cells of (e_i^a . e_j^b)(grad_i . grad_j) A."""
    et = s.basis[s.tris]                                            # (M, 3, 2, 3)
    gg = np.einsum("mid,mjd->mij", s.grad_w, s.grad_w)
    ee = np.einsum("miad,mjbd->miajb", et, et)
    return _scatter(s, ee * gg[:, :, None, :, None] * s.areas[:, None, None, None, None])


def frame_system(s: Surface, i_k: np.ndarray, i_k1: np.ndarray, dt: float):
    """a1 (2N, 2N) and f (2N,) of one frame pair."""
    grad_m = np.einsum("mc,mcd->md", i_k[s.tris], s.grad_w)
    g = np.einsum("md,mcad->mca", grad_m, s.basis[s.tris])           # (M, 3, 2)
    w = (s.areas[:, None, None] / 12.0) * (np.ones((3, 3), s.dtype) + np.eye(3, dtype=s.dtype))
    a1 = _scatter(s, np.einsum("mia,mjb,mij->miajb", g, g, w))
    di = ((i_k1 - i_k) / s.dtype.type(dt))[s.tris]
    rhs = g * ((di + di.sum(axis=1, keepdims=True)) * s.areas[:, None] / 12.0)[:, :, None]
    f = np.zeros(2 * s.n, dtype=s.dtype)
    np.add.at(f, _dofs(s).ravel(), rhs.ravel())
    return a1, f


def solve_frame(s: Surface, a2, movie: np.ndarray, dt: float, frame: int,
                lambda_: float) -> np.ndarray:
    """(2N,) coefficients of velocity frame `frame` of a (T, N) movie."""
    a1, f = frame_system(s, movie[frame], movie[frame + 1], dt)
    return spsolve((a1 + s.dtype.type(lambda_) * a2).tocsc(), f)


def to_world(s: Surface, dofs: np.ndarray) -> np.ndarray:
    """(..., 2N) coefficients -> (..., N, 3) world vectors."""
    return dofs[..., :s.n, None] * s.basis[:, 0] + dofs[..., s.n:, None] * s.basis[:, 1]
