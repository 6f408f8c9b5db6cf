"""Analytic-signal phases and wrap-aware angle arithmetic.

Counterpart of manifold_flow_tpu/ops/phase.py (reference:
S2_interpolate_phases.py:58-68, S5_compute_wave_v.py:60-77, :214-233). The
Hilbert transform is `torch.fft` in complex on the tensor's device: the JAX
package's real-I/O wrapping and its float32 downcast exist because the TPU
cannot hold complex128, and are not ported. The temporal derivatives here
are the plain versions that the wave-speed kernel (K16, `kernels.fields`)
fuses; they run as torch operations on any device.
"""

from __future__ import annotations

import math

import torch


def hilbert(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Analytic signal via FFT (the construction of scipy.signal.hilbert),
    complex, on x's device.

    The reference calls `hilbert(potentials)` without an axis
    (S2_interpolate_phases.py:66), i.e. scipy's default axis=-1, across the
    electrodes; pass axis=-1 to reproduce that. The default transforms
    along time (axis=0).
    """
    x = torch.as_tensor(x)
    n = x.shape[axis]
    xf = torch.fft.fft(x, dim=axis)
    h = torch.zeros(n, dtype=xf.real.dtype, device=x.device)
    h[0] = 1.0
    if n % 2 == 0:
        h[1:n // 2] = 2.0
        h[n // 2] = 1.0
    else:
        h[1:(n + 1) // 2] = 2.0
    shape = [1] * x.dim()
    shape[axis] = n
    return torch.fft.ifft(xf * h.reshape(shape), dim=axis)


def instantaneous_phase(potentials: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """np.angle(hilbert(x)) (compute_phase_from_potentials, S2_phases:58-68)."""
    z = hilbert(potentials, axis=axis)
    return torch.atan2(z.imag, z.real)


def angle_subtract(f1: torch.Tensor, f2: torch.Tensor,
                   angle_flag: bool = True) -> torch.Tensor:
    """Wrap-aware difference in [-pi, pi) (angle_subtract, S5:224-233).
    torch.remainder takes the divisor's sign as jnp.mod does, so the two
    agree bit for bit, at exactly +-pi too."""
    if angle_flag:
        return torch.remainder(f1 - f2 + math.pi, 2.0 * math.pi) - math.pi
    return f1 - f2


def temporal_gradient_phase(data: torch.Tensor, dt: float) -> torch.Tensor:
    """Wrap-aware time derivative of a (T, ...) phase movie: forward
    difference at the first frame, central differences inside, backward at
    the last (compute_temporal_gradient_phase, S5:60-77)."""
    fwd = angle_subtract(data[1], data[0]) / dt
    bwd = angle_subtract(data[-1], data[-2]) / dt
    mid = angle_subtract(data[2:], data[:-2]) / (2.0 * dt)
    return torch.cat([fwd[None], mid, bwd[None]], dim=0)


def temporal_gradient_amplitude(data: torch.Tensor, dt: float) -> torch.Tensor:
    """np.gradient(data, axis=0, edge_order=2) / dt (S5:24): second-order
    central differences with second-order one-sided stencils at the ends.
    Needs at least 3 frames, as np.gradient does."""
    if data.shape[0] < 3:
        raise ValueError(f"the amplitude derivative needs at least 3 frames "
                         f"(np.gradient edge_order=2); got {data.shape[0]}")
    first = (-3.0 * data[0] + 4.0 * data[1] - data[2]) / 2.0
    last = (3.0 * data[-1] - 4.0 * data[-2] + data[-3]) / 2.0
    mid = (data[2:] - data[:-2]) / 2.0
    return torch.cat([first[None], mid, last[None]], dim=0) / dt
