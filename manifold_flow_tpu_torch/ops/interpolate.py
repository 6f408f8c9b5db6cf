"""RBF interpolation: electrode samples -> surface vertices.

Counterpart of manifold_flow_tpu/ops/interpolate.py (reference: the
per-frame `scipy.interpolate.Rbf` fit and evaluation of
S2_interpolate.py:22-53 and S2_interpolate_phases.py:22-56). All frames
share the electrodes, so the E x E kernel system is factorized once and
every frame is one right-hand side. scipy's defaults: the multiquadric
kernel sqrt((r/eps)^2 + 1), eps = (prod(nonzero bbox edges)/n)^(1/dim),
smooth = 0.

On CUDA tensors the system matrix and the evaluation at the targets are
K17 (`kernels.fields`); the LU factorization and the multi-RHS solve are
`torch.linalg.lu_factor` / `lu_solve` in the coordinates' dtype (float64
on the pipeline's path), as the JAX package's are
`jax.scipy.linalg.lu_factor` on every backend. The JAX package's float32
factor with three refinement steps exists because a float64 LU does not
compile on the TPU, and is not ported.
"""

from __future__ import annotations

import torch

from manifold_flow_tpu_torch.kernels import fields as kf


def scipy_default_epsilon(coords: torch.Tensor) -> torch.Tensor:
    """scipy.interpolate.Rbf's default epsilon ("average distance between
    nodes" from the bounding-box volume), a 0-d tensor on coords' device."""
    edges = coords.amax(dim=0) - coords.amin(dim=0)
    nz = edges != 0
    prod = torch.prod(torch.where(nz, edges, torch.ones_like(edges)))
    dim = torch.clamp(nz.sum(), min=1).to(coords.dtype)
    return torch.pow(prod / coords.shape[0], 1.0 / dim)


def rbf_interpolate(coords: torch.Tensor, values: torch.Tensor, targets: torch.Tensor,
                    epsilon=None, smooth: float = 0.0,
                    kind: str = "multiquadric") -> torch.Tensor:
    """Interpolate values (T, E) sampled at coords (E, 3) onto targets
    (P, 3): (T, P). Complex values (the phases pipeline interpolates
    e^{i phi}) solve the real system once for both parts."""
    if torch.is_complex(values):
        re, im = _rbf_solve(coords, (values.real, values.imag), targets, epsilon,
                            smooth, kind)
        return torch.complex(re, im)
    (out,) = _rbf_solve(coords, (values,), targets, epsilon, smooth, kind)
    return out


def rbf_interpolate_phases(coords: torch.Tensor, phi: torch.Tensor,
                           targets: torch.Tensor, epsilon=None, smooth: float = 0.0,
                           kind: str = "multiquadric") -> torch.Tensor:
    """Phase interpolation (S2_interpolate_phases.py:52-56, 177-182): the
    unit-circle values e^{i phi} of phi (T, E) interpolated as complex, and
    the angle (T, P) of the interpolant, taken by K17 as it evaluates."""
    (out,) = _rbf_solve(coords, (torch.cos(phi), torch.sin(phi)), targets, epsilon,
                        smooth, kind, angle=True)
    return out


def _rbf_solve(coords, planes, targets, epsilon, smooth, kind, angle=False):
    """The interpolant (T, P) at targets of each real plane (T, E) of values,
    with one LU of the system for all planes; with angle=True the two planes
    are a complex value's parts and the one result is its angle."""
    coords = coords.contiguous()
    if epsilon is None:
        epsilon = scipy_default_epsilon(coords)
    eps = torch.as_tensor(epsilon, dtype=coords.dtype, device=coords.device).reshape(1)
    a = kf.rbf_basis(coords, eps, kind, smooth)
    lu, piv = torch.linalg.lu_factor(a)
    t = planes[0].shape[0]
    w = torch.linalg.lu_solve(lu, piv, torch.cat([p.T.to(a.dtype) for p in planes], dim=1))
    weights = [w[:, i * t:(i + 1) * t].contiguous() for i in range(len(planes))]
    x = targets.to(coords.dtype).contiguous()
    if angle:
        return (kf.rbf_eval(x, coords, eps, weights[0], kind, weights[1]),)
    return tuple(kf.rbf_eval(x, coords, eps, wi, kind) for wi in weights)
