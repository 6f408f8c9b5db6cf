"""Spatiotemporal SVD mode decomposition of velocity movies.

Counterpart of manifold_flow_tpu/ops/svd.py. Both reference variants: the
complex form V1 + i V2 (S4_spatiotemporal_decomposition_ComplexMatrices
.py:19-46, 187), `decompose_complex`, and the concatenated real form
[Re | Im] (S4_..._ConcatMatrices .py:174-197), `decompose_concat`; the
mode-energy percentages (calculate_percentages) and the sign convention
(negate modes whose mean real temporal coefficient is negative,
ComplexMatrices:206-213).

A real float64 movie A (T, 2N) with m = min(T, 2N) <= 1024 columns of its
short side takes the QR + Jacobi route: the thin QR of its tall side
(A^T, or A where T > 2N) by `torch.geqrf`, kept in Householder form; K18
(kernels.svd.jacobi_svd, one launch on CUDA) on G = R^T, G W = U Sigma, every
singular value in float64; then the kept modes' vectors Q W[:, :k] by
`torch.ormqr`. Spans `svd.qr`, `svd.jacobi`, `svd.vectors`, and the device
count `svd.jacobi_sweeps` (read only by a record() scope's summary). On CPU
tensors the route runs K18's plain version, as every kernel wrapper does,
so that the CPU tests run the card's algorithm: at (390, 7394) that is
~9x LAPACK's time (3.3 s against 0.37 s, 8 CPU threads). Every
other movie (complex, float32, or more than 1024 columns on each side)
takes `torch.linalg.svd(full_matrices=False)` in the span `svd.library`:
the call the JAX package makes on every backend but the TPU. Its TPU
routes (the Gram-matrix eigendecompositions, the real-I/O packing of
complex results) exist because the TPU compiler aborts on a complex SVD and
cannot hold complex128; they are not ported, and would lose the small
singular values both routes keep. Results are tensors on the movie's
device, u and vt complex for `decompose_complex`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from manifold_flow_tpu_torch.kernels import svd as jacobi
from manifold_flow_tpu_torch.ops.recombine import velocity_to_complex
from manifold_flow_tpu_torch.utils import profiling


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


def _qr_jacobi(movie: torch.Tensor, k: int):
    """(u (T, k), sigma (m,), vt (k, 2N)) of a real float64 movie by the
    thin QR of its tall side, K18 on G = R^T and Q W[:, :k]."""
    wide = movie.shape[0] <= movie.shape[1]
    tall = movie.mT if wide else movie
    m = tall.shape[1]
    with profiling.span("svd.qr"):
        a, tau = torch.geqrf(tall)
        g = torch.triu(a[:m]).contiguous()  # row j of R: column j of G = R^T
    with profiling.span("svd.jacobi"):
        u_g, s, w, sweeps = jacobi.jacobi_svd(g)
        profiling.count_device("svd.jacobi_sweeps", sweeps)
    with profiling.span("svd.vectors"):
        lead = a.new_zeros((tall.shape[0], k))
        lead[:m] = w[:k].T
        qw = torch.ormqr(a, tau, lead)  # Q W[:, :k]
    # A = G Q^T = U Sigma (Q W)^T where wide, A = Q G^T = (Q W) Sigma U^T where tall.
    return (u_g[:k].T, s, qw.T) if wide else (qw, s, u_g[:k])


def _decompose(movie: torch.Tensor, n_modes: int | None) -> SVDModes:
    m = min(movie.shape)
    k = m if n_modes is None else min(n_modes, m)
    # Up to K18's capacity: on an H100 the route took 0.40-0.68x the library's
    # time at every m from 390 to 1024 (2N = 7394 and 25088, PERF.md).
    if movie.dtype == torch.float64 and movie.dim() == 2 and 0 < m <= jacobi.MAX_COLUMNS:
        u, s, vt = _qr_jacobi(movie, k)
    else:
        with profiling.span("svd.library"):
            u, s, vt = torch.linalg.svd(movie, full_matrices=False)
    u, vt = fix_signs(u[:, :k], vt[:k], k)
    pct, pct2 = mode_percentages(s)
    return SVDModes(u, s[:k], vt, pct[:k], pct2[:k])


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
