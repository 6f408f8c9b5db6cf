"""Geometry cache keyed by the mesh's content (SURVEY.md §5.4).

Counterpart of manifold_flow_tpu/utils/cache.py. The reference's
config.yaml carries a commented-out `processed_surface_path`
(config.yaml:18,27), a cache of the per-surface geometry (tangent bases,
hat gradients, areas, adjacency) that was never wired in. Here
`build_mesh_cached` hashes (points, triangles) with the JAX package's digest
and stores every tensor of the port's TriMesh in one .npz, so a repeat run
over the same surface skips the geometry and the topology tables.

The entries are named `torch_mesh_{key}_{dtype}.npz` and carry a format
tag, where the JAX package writes `mesh_{key}.npz` with its own fields: a
cache directory shared by both packages never hands either one the other's
entry. The points' dtype is in the name because the digest hashes the
points as float64: a float32 surface and its float64 copy share a key.
"""

from __future__ import annotations

import hashlib
import logging
from pathlib import Path

import numpy as np
import torch

from manifold_flow_tpu_torch.geometry.mesh import (
    ARRAY_FIELDS,
    TriMesh,
    build_mesh,
    resolve_device,
)

logger = logging.getLogger(__name__)

_CACHE_VERSION = 1                        # the JAX package's, in the digest
_FORMAT = "manifold_flow_tpu_torch.TriMesh/1"


def mesh_content_hash(points, triangles) -> str:
    """The JAX package's digest of a surface: the first 24 hex digits of
    the SHA-256 of its float64 points, int32 triangles and cache version."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(points, dtype=np.float64).tobytes())
    h.update(np.ascontiguousarray(triangles, dtype=np.int32).tobytes())
    h.update(str(_CACHE_VERSION).encode())
    return h.hexdigest()[:24]


def entry_path(cache_dir, key: str, dtype) -> Path:
    """The port's cache entry for digest `key` and points of `dtype` in
    `cache_dir`."""
    return Path(cache_dir) / f"torch_mesh_{key}_{np.dtype(dtype).name}.npz"


def save_mesh(path, mesh: TriMesh) -> None:
    """Every tensor of `mesh` (on whatever device) into one .npz."""
    arrays = {name: getattr(mesh, name).cpu().numpy() for name in ARRAY_FIELDS}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, format=np.array(_FORMAT), **arrays)


def load_mesh(path, device="cuda") -> TriMesh:
    """The TriMesh `save_mesh` wrote, on `device` (the GPU unless the
    caller passes device="cpu"). A file of another format raises
    ValueError."""
    device = resolve_device(device)
    with np.load(path) as z:
        if "format" not in z.files or str(z["format"]) != _FORMAT:
            raise ValueError(f"{path}: not a {_FORMAT} cache entry")
        tensors = {name: torch.from_numpy(np.array(z[name])) for name in ARRAY_FIELDS}
    return TriMesh(**tensors).to(device)


def build_mesh_cached(points, triangles, cache_dir=None, dtype=None,
                      device="cuda") -> TriMesh:
    """build_mesh with an on-disk cache keyed by the mesh content, on
    `device`. With cache_dir=None, builds directly (no caching). An entry
    that cannot be read is rebuilt and written again."""
    device = resolve_device(device)
    if cache_dir is None:
        return build_mesh(points, triangles, dtype=dtype, device=device)
    points = np.asarray(points)
    if dtype is not None:
        points = points.astype(dtype)
    path = entry_path(cache_dir, mesh_content_hash(points, triangles), points.dtype)
    if path.exists():
        try:
            return load_mesh(path, device=device)
        except Exception:  # a corrupt or foreign entry: rebuild
            logger.warning("mesh cache entry %s unreadable; rebuilding", path)
    mesh = build_mesh(points, triangles, device=device)
    save_mesh(path, mesh)
    return mesh
