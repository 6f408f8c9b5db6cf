"""The surface's P1 quantities, from the points and triangles alone.

Formulas of the reference pipeline's utils/compute_optical_flow.py
(orthonormal bases :210-235, hat gradients :238-255) and of the port's
documented conventions (vertex normals: the normalised sum of the incident
unit cell normals; tangent bases: e1 = normalise([-ny, nx, 0]), or
[0, -nz, ny] where nx = ny = 0, e2 = normalise(n x e1)).
"""

from __future__ import annotations

import numpy as np


def _normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return np.where(n > 0, v / np.where(n > 0, n, 1), 0)


def cell_normals(points: np.ndarray, tris: np.ndarray) -> np.ndarray:
    p = points[tris]
    return _normalize(np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]))


def areas(points: np.ndarray, tris: np.ndarray) -> np.ndarray:
    p = points[tris]
    return 0.5 * np.linalg.norm(np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=-1)


def vertex_normals(points: np.ndarray, tris: np.ndarray) -> np.ndarray:
    acc = np.zeros_like(points)
    cn = cell_normals(points, tris)
    for c in range(3):
        np.add.at(acc, tris[:, c], cn)
    return _normalize(acc)


def tangent_basis(normals: np.ndarray) -> np.ndarray:
    """(..., 2, 3) orthonormal tangent bases of unit normals (..., 3)."""
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    zero = np.zeros_like(nx)
    cond = ((nx != 0) | (ny != 0))[..., None]
    e1 = _normalize(np.where(cond, np.stack([-ny, nx, zero], -1),
                             np.stack([zero, -nz, ny], -1)))
    e2 = _normalize(np.cross(normals, e1))
    return np.stack([e1, e2], axis=-2)


def hat_gradients(points: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """(M, 3, 3) gradient of each corner's hat function on its triangle."""
    p = points[tris]

    def grad(pi, pj, pk):
        v_jk = pk - pj
        v_ji = pi - pj
        perp = (np.sum(v_ji * v_jk, -1) / np.sum(v_jk * v_jk, -1))[:, None] * v_jk
        v_ih = pj - pi + perp
        return v_ih / np.sum(v_ih * v_ih, -1)[:, None]

    return np.stack([grad(p[:, 0], p[:, 1], p[:, 2]), grad(p[:, 1], p[:, 0], p[:, 2]),
                     grad(p[:, 2], p[:, 0], p[:, 1])], axis=1)


def vertex_neighbors(tris: np.ndarray, n: int) -> np.ndarray:
    """(N, D) padded 1-ring vertex ids, -1 past each vertex's degree."""
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    e = np.unique(np.sort(e, axis=1), axis=0)
    pairs = np.concatenate([e, e[:, ::-1]])
    pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    deg = np.bincount(pairs[:, 0], minlength=n)
    out = -np.ones((n, deg.max()), dtype=np.int64)
    start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    slot = np.arange(len(pairs)) - start[pairs[:, 0]]
    out[pairs[:, 0], slot] = pairs[:, 1]
    return out


def cells_across_edges(tris: np.ndarray) -> np.ndarray:
    """(M, 3): the triangle across edge 0 (AB), 1 (BC), 2 (CA), or -1."""
    m = len(tris)
    edges = np.stack([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]], axis=1)
    key = np.sort(edges, axis=-1).reshape(-1, 2)
    owner = np.repeat(np.arange(m), 3)
    order = np.lexsort((key[:, 1], key[:, 0]))
    ks, os_ = key[order], owner[order]
    out = -np.ones(3 * m, dtype=np.int64)
    same = np.all(ks[1:] == ks[:-1], axis=1)
    i = np.nonzero(same)[0]
    out[order[i]] = os_[i + 1]
    out[order[i + 1]] = os_[i]
    return out.reshape(m, 3)


class Surface:
    """Every P1 quantity of one surface, in one dtype."""

    def __init__(self, points: np.ndarray, tris: np.ndarray, dtype=np.float64):
        self.dtype = np.dtype(dtype)
        self.points = np.asarray(points, dtype=self.dtype)
        self.tris = np.asarray(tris, dtype=np.int64)
        self.n, self.m = len(self.points), len(self.tris)
        self.areas = areas(self.points, self.tris)
        self.normals = vertex_normals(self.points, self.tris)
        self.basis = tangent_basis(self.normals)
        self.grad_w = hat_gradients(self.points, self.tris)
        self.neighbors = vertex_neighbors(self.tris, self.n)
        self.across = cells_across_edges(self.tris)
        span = self.points.max(axis=0) - self.points.min(axis=0)
        self.diameter = float(np.linalg.norm(span))
