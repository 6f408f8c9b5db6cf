"""S3: singularities of one velocity frame and their classes.

The reference's utils/find_singularity_point.py: a vertex is singular where
|v| / max|v| <= eps (:140-160); a triangle touching no singular vertex holds
a zero where the corner velocities, normalised by max|v| and projected on
its plane, solve [VA-VC, VB-VC] [lam, mu]^T = -VC with lam, mu >= 0 and
lam + mu <= 1 (:161-189). The class of each point comes from the
finite-difference Jacobian over its neighbours (:355-402), projected on a
tangent basis: for a vertex its 1-ring on its own basis, for an interior
zero the corners of its triangle and of the triangle across the edge
nearest to it, on the flat triangle's basis; a neighbour at zero offset adds
nothing. Trace and determinant give Node / Focus / Saddle / Indeterminate
(:463-498). Rows list the singular vertices, then the interior zeros, each
in ascending id order.
"""

from __future__ import annotations

import numpy as np

from flowbench.reference.geometry import Surface, cell_normals, tangent_basis

CLASS_NAMES = np.array(["Node", "Focus", "Saddle", "Indeterminate"])


def _dot(a, b):
    return np.sum(a * b, axis=-1)


def _jacobian(origin, e1, e2, nb_points, nb_vel, mask):
    """(S, 2, 2) Jacobians; origin, e1, e2 (S, 3); neighbours (S, D, 3)."""
    n = np.cross(e1, e2)[:, None, :]
    nn = _dot(n, n)

    def project(v):
        return v - np.where(nn > 0, _dot(v, n) / np.where(nn > 0, nn, 1), 0)[..., None] * n

    vp = project(nb_vel)
    u = _dot(vp, e1[:, None]) / _dot(e1, e1)[:, None]
    w = _dot(vp, e2[:, None]) / _dot(e2, e2)[:, None]
    off = project(nb_points - origin[:, None])
    d1, d2 = _dot(off, e1[:, None]), _dot(off, e2[:, None])
    i1 = np.where(d1 != 0, 1 / np.where(d1 != 0, d1, 1), 0)
    i2 = np.where(d2 != 0, 1 / np.where(d2 != 0, d2, 1), 0)
    c = np.stack([u * i1, u * i2, w * i1, w * i2], -1) * mask[..., None]
    return c.sum(axis=1).reshape(-1, 2, 2)


def classify(jac: np.ndarray) -> np.ndarray:
    tr = jac[:, 0, 0] + jac[:, 1, 1]
    det = jac[:, 0, 0] * jac[:, 1, 1] - jac[:, 0, 1] * jac[:, 1, 0]
    code = np.where(det > 0, np.where(tr * tr > 4 * det, 0, 1), np.where(det < 0, 2, 3))
    return CLASS_NAMES[code]


def _nearest_edge(pt, pa, pb, pc):
    d = []
    for q, a, b in ((pt, pa, pb), (pt, pb, pc), (pt, pc, pa)):
        ab = b - a
        d.append(np.linalg.norm(np.cross(q - a, ab), axis=-1) / np.linalg.norm(ab, axis=-1))
    return np.argmin(np.stack(d, -1), axis=-1)


def singularities(s: Surface, v: np.ndarray, eps: float):
    """(points (S, 3), class names (S,)) of one frame's world vectors (N, 3)."""
    speed = np.linalg.norm(v, axis=-1)
    vmax = speed.max()
    vsing = np.nonzero(speed / vmax <= eps)[0]
    is_sing = np.zeros(s.n, bool)
    is_sing[vsing] = True
    p = s.points[s.tris]                                           # (M, 3, 3)
    nrm = cell_normals(s.points, s.tris)[:, None, :]
    vt = (v / vmax)[s.tris]
    vt = vt - _dot(vt, nrm)[..., None] * nrm
    va, vb, vc = vt[:, 0], vt[:, 1], vt[:, 2]
    c1, c2 = va - vc, vb - vc
    a11, a12, a22 = _dot(c1, c1), _dot(c1, c2), _dot(c2, c2)
    b1, b2 = -_dot(c1, vc), -_dot(c2, vc)
    det = a11 * a22 - a12 * a12
    ok = det != 0
    safe = np.where(ok, det, 1)
    lam = (b1 * a22 - b2 * a12) / safe
    mu = (a11 * b2 - a12 * b1) / safe
    inside = ok & (lam >= 0) & (mu >= 0) & (lam + mu <= 1) & ~is_sing[s.tris].any(axis=1)
    cells = np.nonzero(inside)[0]
    lam, mu = lam[cells, None], mu[cells, None]
    pc = p[cells]
    ipts = lam * pc[:, 0] + mu * pc[:, 1] + (1 - lam - mu) * pc[:, 2]
    vn = v / vmax

    nb = s.neighbors[vsing]
    vmask = nb >= 0
    nb = np.where(vmask, nb, 0)
    jv = _jacobian(s.points[vsing], s.basis[vsing, 0], s.basis[vsing, 1],
                   s.points[nb], vn[nb], vmask)

    e = tangent_basis(cell_normals(s.points, s.tris[cells]))
    edge = _nearest_edge(ipts, pc[:, 0], pc[:, 1], pc[:, 2])
    other = s.across[cells, edge]
    other = np.where(other >= 0, other, cells)
    nb = np.concatenate([s.tris[cells], s.tris[other]], axis=1)     # (S, 6)
    first = np.ones(nb.shape, bool)
    for i in range(1, 6):
        first[:, i] = ~(nb[:, i:i + 1] == nb[:, :i]).any(axis=1)
    ji = _jacobian(ipts, e[:, 0], e[:, 1], s.points[nb], vn[nb], first)

    points = np.concatenate([s.points[vsing], ipts])
    labels = np.concatenate([classify(jv), classify(ji)])
    return points, labels
