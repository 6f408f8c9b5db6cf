"""RBF interpolation: electrode samples -> surface vertices.

Counterpart of manifold_flow_tpu/ops/interpolate.py (reference: the
per-frame `scipy.interpolate.Rbf` fit and evaluation of
S2_interpolate.py:22-53 and S2_interpolate_phases.py:22-56). All frames
share the electrodes, so the E x E kernel system is factorized once and
every frame is one right-hand side. scipy's defaults: the multiquadric
kernel sqrt((r/eps)^2 + 1), eps = (prod(nonzero bbox edges)/n)^(1/dim),
smooth = 0.

On CUDA tensors the fit (the system, its LU factorization with partial
pivoting and the solve of every frame of every plane) is one launch of K17
`rbf_fit`, and the evaluation at the targets K17 `rbf_eval`
(`kernels.fields`); on CPU tensors the fit is `torch.linalg.lu_factor_ex` /
`lu_solve`, as the JAX package's is `jax.scipy.linalg.lu_factor` on every
backend. The dtypes follow the JAX package's: the system is solved in the
coordinates' dtype, the weights are rounded to the values' (real) dtype,
and the evaluation runs in the promoted dtype of targets, coordinates and
values, or for complex values in their real dtype (all float64 on the
pipeline's path). The JAX package's float32 factor with three refinement
steps exists because a float64 LU does not compile on the TPU, and is not
ported.

A zero pivot (two electrodes at one place with smooth = 0, or a singular
kernel matrix) raises ValueError on both devices, naming the pivot. This
differs from the JAX package on purpose, which returns whatever its
factorization gives there (non-finite or meaningless values) without an
error (ROADMAP Queue C). The info word is read once, after the evaluation
is queued: the fit's only host sync.

The fit runs in a utils.profiling span `s2.fit`, the evaluation in one
`s2.eval`.
"""

from __future__ import annotations

import torch

from manifold_flow_tpu_torch.kernels import fields as kf
from manifold_flow_tpu_torch.utils import profiling


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
    e^{i phi}) solve the real system once for both parts and come back in
    the values' complex dtype; real values come back in the promoted dtype
    of targets, coords and values, as in the JAX package."""
    if torch.is_complex(values):
        rdt = values.real.dtype
        re, im = _rbf_solve(coords, (values.real, values.imag), targets, epsilon,
                            smooth, kind, rdt, rdt)
        return torch.complex(re, im)
    out_dtype = torch.promote_types(torch.promote_types(targets.dtype, coords.dtype),
                                    values.dtype)
    (out,) = _rbf_solve(coords, (values,), targets, epsilon, smooth, kind,
                        values.dtype, out_dtype)
    return out


def rbf_interpolate_phases(coords: torch.Tensor, phi: torch.Tensor,
                           targets: torch.Tensor, epsilon=None, smooth: float = 0.0,
                           kind: str = "multiquadric") -> torch.Tensor:
    """Phase interpolation (S2_interpolate_phases.py:52-56, 177-182): the
    unit-circle values e^{i phi} of phi (T, E) interpolated as complex, and
    the angle (T, P) of the interpolant in phi's dtype, taken by K17 as it
    evaluates."""
    (out,) = _rbf_solve(coords, (torch.cos(phi), torch.sin(phi)), targets, epsilon,
                        smooth, kind, phi.dtype, phi.dtype, angle=True)
    return out


def _rbf_solve(coords, planes, targets, epsilon, smooth, kind, weight_dtype,
               eval_dtype, angle=False):
    """The interpolant (T, P) at targets of each real plane (T, E) of values,
    with one fit for all planes in the coordinates' dtype, its weights
    rounded to `weight_dtype` and evaluated in `eval_dtype`; with angle=True
    the two planes are a complex value's parts and the one result is its
    angle."""
    coords = coords.contiguous()
    if epsilon is None:
        epsilon = scipy_default_epsilon(coords)
    eps = torch.as_tensor(epsilon, dtype=coords.dtype, device=coords.device).reshape(1)
    with profiling.span("s2.fit"):
        w, info = kf.rbf_fit(coords, eps,
                             [p.to(coords.dtype).contiguous() for p in planes], kind, smooth)
    w = [wi.to(weight_dtype).to(eval_dtype).contiguous() for wi in w]
    x = targets.to(eval_dtype).contiguous()
    c = coords.to(eval_dtype).contiguous()
    eps_eval = eps.to(eval_dtype)
    with profiling.span("s2.eval"):
        if angle:
            out = (kf.rbf_eval(x, c, eps_eval, w[0], kind, w[1]),)
        else:
            out = tuple(kf.rbf_eval(x, c, eps_eval, wi, kind) for wi in w)
    first = int(info[0])
    if first:
        raise ValueError(f"the RBF system of {coords.shape[0]} electrodes is singular: "
                         f"pivot {first} is zero (two electrodes coincide, or the "
                         f"{kind} kernel matrix is singular)")
    return out
