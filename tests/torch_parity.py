"""Shared inputs for holding the PyTorch port against the JAX package.

One curved mesh (the 144-vertex bumped patch of tests/conftest.py) and one
movie, made with numpy from a fixed seed, are built in both packages. JAX
runs as the JAX package's own tests run it (CPU backend, x64, set by
tests/conftest.py); the port runs its plain torch versions on the CPU. Data
crosses between the two as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from manifold_flow_tpu.geometry import synthetic as jax_synthetic
from manifold_flow_tpu_torch.geometry import synthetic as torch_synthetic
from manifold_flow_tpu_torch.geometry.mesh import ARRAY_FIELDS

# The tier-1 run uses several xdist workers on one host: one thread each.
torch.set_num_threads(1)

SEED = 0
N_FRAMES = 6
LAMBDA = 0.01


def bump(x, y):
    """The gaussian bump of tests/conftest.py's curved_mesh."""
    return 0.8 * np.exp(-((x - 3.0) ** 2 + (y - 3.0) ** 2) / 4.0)


def jax_curved_mesh():
    return jax_synthetic.plane_patch(nx=12, ny=12, lx=6.0, ly=6.0, height=bump)


def torch_curved_mesh():
    return torch_synthetic.plane_patch(nx=12, ny=12, lx=6.0, ly=6.0, height=bump,
                                       device="cpu")


def jax_arrays(mesh) -> dict[str, np.ndarray]:
    """A JAX TriMesh's array leaves as numpy arrays."""
    return {name: np.asarray(getattr(mesh, name)) for name in ARRAY_FIELDS}


def movie(points: np.ndarray, n_frames: int = N_FRAMES, seed: int = SEED):
    """A plane wave plus seeded noise, (T, N) float64, and its times (T,)."""
    rng = np.random.default_rng(seed)
    times = np.arange(n_frames, dtype=np.float64) * 0.01
    phase = points @ np.array([1.0, 0.5, 0.0])
    pot = np.cos(phase[None, :] - 2.0 * times[:, None])
    return pot + 0.05 * rng.standard_normal(pot.shape), times


def rel_err(got, want, scale=None) -> float:
    """max |got - want| relative to max |want| (or to `scale`)."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    den = float(np.abs(want).max()) if scale is None else float(scale)
    return float(np.abs(got - want).max()) / max(den, 1e-300)


@pytest.fixture(scope="module")
def jmesh():
    return jax_curved_mesh()


@pytest.fixture(scope="module")
def tmesh():
    return torch_curved_mesh()


@pytest.fixture(scope="module")
def wave(jmesh):
    return movie(np.asarray(jmesh.points))
