"""Spatiotemporal SVD mode decomposition of velocity movies.

Counterpart of manifold_flow_tpu/ops/svd.py. Both reference variants: the
complex form V1 + i V2 (S4_spatiotemporal_decomposition_ComplexMatrices
.py:19-46, 187), `decompose_complex`, and the concatenated real form
[Re | Im] (S4_..._ConcatMatrices .py:174-197), `decompose_concat`; the
mode-energy percentages (calculate_percentages) and the sign convention
(negate modes whose mean real temporal coefficient is negative,
ComplexMatrices:206-213).

The SVD is `torch.linalg.svd(full_matrices=False)` on the movie's device,
in complex128 / float64 for a float64 movie: the call the JAX package makes
on every backend but the TPU. Its TPU routes (the Gram-matrix
eigendecompositions, the real-I/O packing of complex results) exist because
the TPU compiler aborts on a complex SVD and cannot hold complex128; they
are not ported, and would lose the small singular values the exact SVD
keeps. Results are tensors on the movie's device, u and vt complex for
`decompose_complex`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from manifold_flow_tpu_torch.ops.recombine import velocity_to_complex


class SVDModes(NamedTuple):
    u: torch.Tensor            # (T, K) temporal modes
    sigma: torch.Tensor        # (K,) singular values
    vt: torch.Tensor           # (K, N) or (K, 2N) spatial modes
    pct: torch.Tensor          # (K,) sigma / sum(sigma) * 100
    pct_squared: torch.Tensor  # (K,) sigma^2 / sum(sigma^2) * 100


def mode_percentages(sigma: torch.Tensor):
    """(pct, pct^2) rounded to 2 decimals (calculate_percentages,
    ComplexMatrices:126-142), as jnp.round computes it once compiled:
    round-half-even of x * 100, times 0.01 (XLA turns the division by 100
    into that product), so the values equal the JAX package's."""
    def round2(x):
        return torch.round(x * 100.0) * 0.01

    s2 = torch.square(sigma)
    return (round2(sigma / torch.sum(sigma) * 100.0),
            round2(s2 / torch.sum(s2) * 100.0))


def fix_signs(u: torch.Tensor, vt: torch.Tensor, n_modes: int):
    """Negate leading modes whose mean Re(U) is negative
    (ComplexMatrices:206-213, ConcatMatrices:190-192)."""
    lead = u[:, :n_modes]
    sign = torch.where(torch.mean(lead.real, dim=0) < 0, -1.0, 1.0).to(u.real.dtype)
    u_fixed = torch.cat([lead * sign, u[:, n_modes:]], dim=1)
    vt_fixed = torch.cat([vt[:n_modes] * sign[:, None], vt[n_modes:]], dim=0)
    return u_fixed, vt_fixed


def _decompose(movie: torch.Tensor, n_modes: int | None) -> SVDModes:
    u, s, vt = torch.linalg.svd(movie, full_matrices=False)
    k = s.shape[0] if n_modes is None else n_modes
    u, vt = fix_signs(u, vt, k)
    pct, pct2 = mode_percentages(s)
    return SVDModes(u[:, :k], s[:k], vt[:k], pct[:k], pct2[:k])


def decompose_complex(v_k: torch.Tensor, n_modes: int | None = None) -> SVDModes:
    """SVD of the complex movie (T, N) = V1 + i V2 of velocity DOFs (T, 2N)."""
    return _decompose(velocity_to_complex(v_k), n_modes)


def decompose_concat(v_k: torch.Tensor, n_modes: int | None = None) -> SVDModes:
    """SVD of the real concatenated movie (T, 2N) = [Re | Im]."""
    return _decompose(v_k, n_modes)


def concat_modes_to_complex(vt: torch.Tensor) -> torch.Tensor:
    """Concat spatial modes (K, 2N) -> complex (K, N) (ConcatMatrices:194-197)."""
    n = vt.shape[-1] // 2
    return torch.complex(vt[..., :n], vt[..., n:])


def mode_to_world(sigma_vt: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Complex spatial mode (..., N) -> world vectors (..., N, 3)
    (calculate_V_k_from_complex, ComplexMatrices:49-69)."""
    imag = sigma_vt.imag if sigma_vt.is_complex() else torch.zeros_like(sigma_vt)
    return sigma_vt.real[..., None] * e[:, 0] + imag[..., None] * e[:, 1]
