"""Synthetic surfaces and potential movies for tests and benchmarks.

Counterpart of manifold_flow_tpu/geometry/synthetic.py. Surfaces and movies
are generated with numpy (so both packages see the same numbers); meshes and
movies are returned as tensors on the requested device: the GPU unless the
caller passes device="cpu".
"""

from __future__ import annotations

import numpy as np
import torch

from manifold_flow_tpu_torch.geometry.mesh import TriMesh, build_mesh


def plane_patch(nx: int = 32, ny: int = 32, lx: float = 10.0, ly: float = 10.0,
                height=None, dtype=np.float64, device="cuda") -> TriMesh:
    """Triangulated rectangular patch, optionally warped by z = height(x, y)."""
    xs = np.linspace(0.0, lx, nx, dtype=dtype)
    ys = np.linspace(0.0, ly, ny, dtype=dtype)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    gz = np.zeros_like(gx) if height is None else np.asarray(height(gx, gy), dtype=dtype)
    points = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=-1)

    idx = np.arange(nx * ny).reshape(nx, ny)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[:-1, 1:].ravel()
    d = idx[1:, 1:].ravel()
    # Two consistently oriented triangles per quad.
    tris = np.concatenate(
        [np.stack([a, b, d], axis=-1), np.stack([a, d, c], axis=-1)], axis=0
    ).astype(np.int32)
    return build_mesh(points, tris, dtype=dtype, device=device)


def sphere_patch(n_sub: int = 3, radius: float = 5.0, dtype=np.float64,
                 device="cuda") -> TriMesh:
    """Icosphere: subdivided icosahedron — a closed curved test manifold."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
         [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
         [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]],
        dtype=dtype,
    )
    faces = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
        dtype=np.int64,
    )
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    for _ in range(n_sub):
        edge_mid: dict[tuple[int, int], int] = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in edge_mid:
                m = verts_list[i] + verts_list[j]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts_list)
                verts_list.append(m)
            return edge_mid[key]

        for (a, b, c) in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(verts_list, dtype=dtype)
        faces = np.array(new_faces, dtype=np.int64)
    return build_mesh(radius * verts, faces.astype(np.int32), dtype=dtype,
                      device=device)


def plane_wave_movie(mesh: TriMesh, n_frames: int = 16, wave_vector=(1.0, 0.5, 0.0),
                     omega: float = 2.0, dt: float = 0.01, dtype=np.float64):
    """Traveling plane wave I(x, t) = cos(k.x - omega t) sampled at vertices.

    Returns (potentials (T, N), times (T,)) on the mesh's device.
    """
    pts = mesh.points.cpu().numpy()
    k = np.asarray(wave_vector, dtype=dtype)
    times = np.arange(n_frames, dtype=dtype) * dt
    phase = pts @ k
    pot = np.cos(phase[None, :] - omega * times[:, None]).astype(dtype)
    return _to(mesh, pot), _to(mesh, times)


def two_source_movie(mesh: TriMesh, sources=((2.5, 2.5), (7.5, 7.5)),
                     n_frames: int = 16, speed: float = 4.0, wavelength: float = 4.0,
                     dt: float = 0.02, dtype=np.float64):
    """Two radially expanding waves — the two-source singularity benchmark.

    Returns (potentials (T, N), times (T,), true_singularities (S, 3)) on the
    mesh's device.
    """
    pts = mesh.points.cpu().numpy()
    times = np.arange(n_frames, dtype=dtype) * dt
    pot = np.zeros((n_frames, pts.shape[0]), dtype=dtype)
    truth = []
    for sx, sy in sources:
        center = np.array([sx, sy, 0.0], dtype=dtype)
        i_near = int(np.argmin(np.linalg.norm(pts - center, axis=-1)))
        truth.append(pts[i_near])
        r = np.linalg.norm(pts - pts[i_near], axis=-1)
        pot += np.cos(2.0 * np.pi * (r[None, :] - speed * times[:, None]) / wavelength)
    return _to(mesh, pot), _to(mesh, times), _to(mesh, np.stack(truth))


def _to(mesh: TriMesh, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)
