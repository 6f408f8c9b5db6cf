"""Wave-speed estimation from amplitude or phase movies.

Counterpart of manifold_flow_tpu/ops/wavespeed.py (reference:
S5_compute_wave_v.py). wave speed = temporal derivative / |tangential
spatial gradient| (S5:56, 121); the phase method uses wrap-aware time
differences. Every function here is one call of K16 (`kernels.fields`):
on CUDA tensors the kernel computes the gradient, its tangent projection,
the time derivative and their quotient in one pass; CPU tensors take its
plain version, which composes the JAX package's operations
(`geometry.tangent`, `ops.phase`).
"""

from __future__ import annotations

import torch

from manifold_flow_tpu_torch.geometry.mesh import TriMesh
from manifold_flow_tpu_torch.kernels import fields as kf


def _wave(mesh: TriMesh, movie, dt: float, output: str) -> torch.Tensor:
    movie = torch.as_tensor(movie, device=mesh.device).contiguous()
    dtype = movie.dtype
    return kf.wave_speed(movie, mesh.triangles, mesh.grad_w.to(dtype).contiguous(),
                         mesh.areas.to(dtype), mesh.vertex_cells,
                         mesh.basis.to(dtype).contiguous(), dt, output)


def vertex_gradients(mesh: TriMesh, movie) -> torch.Tensor:
    """Per-vertex spatial gradients (T, N, 3): the area-weighted average of
    the P1 triangle gradients over each vertex's incident cells
    (compute_grad_M_I, S5:136-171)."""
    return _wave(mesh, movie, 1.0, "gradient")


def tangential_gradient_magnitude(mesh: TriMesh, movie) -> torch.Tensor:
    """|grad| after tangent-plane projection and basis expression (T, N)."""
    return _wave(mesh, movie, 1.0, "magnitude")


def wave_velocity_amplitude(mesh: TriMesh, potentials, dt: float) -> torch.Tensor:
    """Amplitude-method wave speeds (T, N) (wave_velocity_amplitude, S5:14-58)."""
    return _wave(mesh, potentials, dt, "amplitude")


def wave_velocity_phase(mesh: TriMesh, phases, dt: float) -> torch.Tensor:
    """Phase-method wave speeds (T, N) (wave_velocity_phase, S5:79-123)."""
    return _wave(mesh, phases, dt, "phase")


def wave_velocity_phase_mm_per_ms(mesh: TriMesh, phases, dt: float) -> torch.Tensor:
    """|wave speed| / 1000: the unit conversion and abs the S5 script applies
    before saving (S5:311-313)."""
    return _wave(mesh, phases, dt, "phase_mm_per_ms")
