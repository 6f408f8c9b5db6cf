"""Wrappers of the field kernels (K16 wave speeds, K17 RBF interpolation),
with their plain torch versions.

As in `kernels.analysis`: CPU tensors take the plain version; CUDA tensors
launch the kernel from `csrc/field_kernels.cu` or raise. Nothing falls back.
Each wrapper checks dtype, device, shape and contiguity first, allocates its
output with `torch.empty`, and counts its launches in `LAUNCHES`.

The plain versions compose the JAX package's operations one torch call at a
time: the gradient as its einsum and gather (ops/wavespeed.py:27-48), the
tangent plane through `geometry.tangent`, the time derivatives of
`ops.phase`, the distances in `_pairwise_dist`'s difference form (never
`torch.cdist`'s matrix form, which rounds otherwise), the fit as
`torch.linalg.lu_factor_ex` and `lu_solve`, and the evaluation as `b @ w`.
K17's fit pivots as LAPACK's dgetf2 does and sums in its own fixed order,
so its weights agree with the library's to the system's conditioning and
its backward error to rounding; its evaluation sums in another order
(float64 in the tensor cores' products, float32 in fused multiply-adds), so
the two agree to rounding; K16's outputs are the plain version's to
rounding too, and the same bits as its first design's.
"""

from __future__ import annotations

import torch

from manifold_flow_tpu_torch.geometry.tangent import express_on_basis, project_to_plane
from manifold_flow_tpu_torch.kernels._lib import (
    _check,
    _float_dtype,
    _launch,
    _on_cuda,
    _ptr,
    _workspace,
)
from manifold_flow_tpu_torch.ops.phase import (
    temporal_gradient_amplitude,
    temporal_gradient_phase,
)

# What `wave_speed` returns (the codes of csrc/field_kernels.cu WaveOutput).
WAVE_OUTPUTS = {"gradient": 0, "magnitude": 1, "amplitude": 2, "phase": 3,
                "phase_mm_per_ms": 4}
# The frames each time derivative needs: np.gradient(edge_order=2) three,
# the phase differences two (the JAX functions index data[2] and data[1]).
_MIN_FRAMES = {"amplitude": 3, "phase": 2, "phase_mm_per_ms": 2}
# ops/interpolate.py:34 _kernel's kinds (the codes of csrc rbf_phi).
RBF_KINDS = {"multiquadric": 0, "inverse_multiquadric": 1, "gaussian": 2,
             "linear": 3, "thin_plate": 4}


def wave_speed(movie: torch.Tensor, triangles: torch.Tensor, grad_w: torch.Tensor,
               areas: torch.Tensor, vertex_cells: torch.Tensor, basis: torch.Tensor,
               dt: float, output: str) -> torch.Tensor:
    """K16 `wave_speed<T>`: per (frame, vertex) of a (T, N) movie, one of
    WAVE_OUTPUTS: the area-weighted vertex gradient (T, N, 3), its tangential
    magnitude (T, N), or the wave speed (T, N) of the amplitude or phase
    method (the phase method's |speed| / 1000 for 'phase_mm_per_ms').

    Mesh tables as in TriMesh: triangles (M, 3) and vertex_cells (N, C)
    int32, grad_w (M, 3, 3), areas (M,) and basis (N, 2, 3) in the movie's
    dtype. Replaces ops/wavespeed.py:28, :52, :64, :72 and ops/phase.py:66,
    :78 (B13). Bound by bytes: the movie once, the output once and the mesh
    tables; in fact by the latency of its dependent loads. Design: one
    thread per (vertex, 4 consecutive frames), the vertex fastest, each
    cell's tables read once for the 4 frames; 128 threads a block, the
    registers capped for 5 blocks an SM."""
    if output not in WAVE_OUTPUTS:
        raise ValueError(f"unknown output {output!r}; want one of {sorted(WAVE_OUTPUTS)}")
    dtype = _float_dtype("movie", movie)
    if movie.dim() != 2:
        raise ValueError(f"movie must be (T, N); got {tuple(movie.shape)}")
    t, n = movie.shape
    m, width = triangles.shape[0], vertex_cells.shape[-1]
    _check("movie", movie, dtype, (t, n))
    _check("triangles", triangles, torch.int32, (m, 3))
    _check("grad_w", grad_w, dtype, (m, 3, 3))
    _check("areas", areas, dtype, (m,))
    _check("vertex_cells", vertex_cells, torch.int32, (n, width))
    _check("basis", basis, dtype, (n, 2, 3))
    if t < _MIN_FRAMES.get(output, 0):
        raise ValueError(f"the {output} time derivative needs at least "
                         f"{_MIN_FRAMES[output]} frames; got {t}")
    if not _on_cuda(movie, triangles, grad_w, areas, vertex_cells, basis):
        return plain_wave_speed(movie, triangles, grad_w, areas, vertex_cells, basis,
                                dt, output)
    device = movie.device
    out = torch.empty((t, n, 3) if output == "gradient" else (t, n), dtype=dtype,
                      device=device)
    _launch("wave_speed", dtype, device, movie.data_ptr(), triangles.data_ptr(),
            grad_w.data_ptr(), areas.data_ptr(), vertex_cells.data_ptr(),
            basis.data_ptr(), out.data_ptr(), t, n, width, float(dt), WAVE_OUTPUTS[output])
    return out


def plain_vertex_gradients(movie, triangles, grad_w, areas, vertex_cells):
    """ops/wavespeed.py:27-48: each cell's P1 gradient, weighted by its area,
    gathered over each vertex's incident cells and divided by their total
    area (T, N, 3)."""
    tri = triangles.long()
    gw, a = grad_w.to(movie.dtype), areas.to(movie.dtype)
    grad_m = torch.einsum("tmc,mcd->tmd", movie[:, tri], gw)          # (T, M, 3)
    weighted = grad_m * a[None, :, None]
    t, m = movie.shape[0], tri.shape[0]
    idx = torch.where(vertex_cells < 0, m, vertex_cells).long()       # (N, C)
    wpad = torch.cat([weighted, weighted.new_zeros((t, 1, 3))], dim=1)
    num = wpad[:, idx].sum(dim=2)                                     # (T, N, 3)
    den = torch.cat([a, a.new_zeros(1)])[idx].sum(dim=1)              # (N,)
    return num / torch.where(den > 0, den, torch.ones_like(den))[None, :, None]


def plain_wave_speed(movie, triangles, grad_w, areas, vertex_cells, basis, dt, output):
    """Plain torch version of `wave_speed` (ops/wavespeed.py:27-83)."""
    g = plain_vertex_gradients(movie, triangles, grad_w, areas, vertex_cells)
    if output == "gradient":
        return g
    e1, e2 = basis[None, :, 0], basis[None, :, 1]
    coef = express_on_basis(project_to_plane(g, e1, e2), e1, e2)
    mag = torch.sqrt(coef[..., 0] ** 2 + coef[..., 1] ** 2)
    if output == "magnitude":
        return mag
    if output == "amplitude":
        return temporal_gradient_amplitude(movie, dt) / mag
    speed = temporal_gradient_phase(movie, dt) / mag
    return torch.abs(speed) / 1000.0 if output == "phase_mm_per_ms" else speed


def _rbf_args(x, c, eps, kind):
    if kind not in RBF_KINDS:
        raise ValueError(f"unknown RBF kind: {kind!r}")
    dtype = _float_dtype("c", c)
    _check("x", x, dtype, (x.shape[0], 3))
    _check("c", c, dtype, (c.shape[0], 3))
    _check("eps", eps, dtype, (1,))
    return dtype


def rbf_fit(c: torch.Tensor, eps: torch.Tensor, planes, kind: str,
            smooth: float = 0.0,
            pivots: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K17 `rbf_fit<T>`: the RBF weights W (planes, E, T) of one or two
    planes of values (T, E) sampled at the electrodes c (E, 3), and an int32
    info word (1,): the first zero pivot, 1-based as LAPACK numbers it, or 0
    (else W holds no solution). Each W[i] is the contiguous (E, T) that
    `rbf_eval` takes. eps is a one-element tensor on the same device (no
    host read); `pivots`, where given, an int32 (E,) tensor that receives
    LAPACK's 1-based row interchanges.

    Replaces ops/interpolate.py:90-133 _rbf_solve's fit (B14): the system
    A = phi(|c_i - c_j| / eps) - smooth I, its LU factorization with partial
    pivoting (LAPACK dgetf2's: the first row of the largest |a_ik|, the
    column scaled by the pivot's reciprocal) and the solve of every frame of
    every plane, in one launch. Bound: the larger of 2/3 E^3 + 2 E^2 R
    operations (R = planes T) and the bytes of c, the planes and W; in fact
    its dependent chain of E pivot steps and E back-substitution steps.
    Design: a block for each group of at most 32 right-hand sides builds
    [A | B] in shared memory (in a workspace slice a block past E = 148 in
    float64, 219 in float32) and factors it alone in panels of 8 columns:
    warp 0 factors a panel with warp reductions and shuffles, no block
    barrier inside; the block then solves the panel's rows of U and applies
    its rank-1 updates below, B's columns too (the forward substitution),
    each element's updates in dgetf2's order; then a warp substitutes back
    through U for its 4 columns, 32 rows at a time in registers. No host
    sync: the caller reads info."""
    dtype = _rbf_args(c, c, eps, kind)
    planes = tuple(planes)
    if len(planes) not in (1, 2):
        raise ValueError(f"rbf_fit takes one or two planes of values; got {len(planes)}")
    if planes[0].dim() != 2:
        raise ValueError(f"each plane must be (T, E); got {tuple(planes[0].shape)}")
    e, t = c.shape[0], planes[0].shape[0]
    for i, plane in enumerate(planes):
        _check(f"planes[{i}]", plane, dtype, (t, e))
    if pivots is not None:
        _check("pivots", pivots, torch.int32, (e,))
    if not _on_cuda(c, eps, *planes, pivots):
        return plain_rbf_fit(c, eps, planes, kind, smooth, pivots)
    device = c.device
    w = torch.empty((len(planes), e, t), dtype=dtype, device=device)
    if e == 0:
        return w, torch.zeros(1, dtype=torch.int32, device=device)
    info = torch.empty(1, dtype=torch.int32, device=device)
    work = _workspace("rbf_fit", dtype, device, e, t, len(planes))
    _launch("rbf_fit", dtype, device, c.data_ptr(), eps.data_ptr(), planes[0].data_ptr(),
            _ptr(planes[1] if len(planes) == 2 else None), w.data_ptr(), info.data_ptr(),
            _ptr(pivots), _ptr(work), e, t, RBF_KINDS[kind], float(smooth))
    return w, info


def rbf_eval(x: torch.Tensor, c: torch.Tensor, eps: torch.Tensor, w: torch.Tensor,
             kind: str, w_im: torch.Tensor | None = None) -> torch.Tensor:
    """K17 `rbf_eval<T>`: the interpolant out[t, p] = sum_e phi(|x_p - c_e|
    / eps) w[e, t] (T, P) of weights w (E, T), without the (P, E) matrix; with
    w_im (E, T), the angle atan2(sum phi w_im, sum phi w) of the complex
    interpolant (ops/interpolate.py:69-71). Bound by its P E T multiply-adds;
    a block of 32 targets and a group of frames computes phi once a (target,
    electrode) into registers and forms the product on the float64 tensor
    cores (m16n8k8; float32 in FMAs, never TF32), the weights brought into
    shared memory by cp.async."""
    dtype = _rbf_args(x, c, eps, kind)
    e, t = c.shape[0], w.shape[-1]
    _check("w", w, dtype, (e, t))
    if w_im is not None:
        _check("w_im", w_im, dtype, (e, t))
    if not _on_cuda(x, c, eps, w, w_im):
        return plain_rbf_eval(x, c, eps, w, kind, w_im)
    out = torch.empty((t, x.shape[0]), dtype=dtype, device=x.device)
    _launch("rbf_eval", dtype, x.device, x.data_ptr(), c.data_ptr(), eps.data_ptr(),
            w.data_ptr(), _ptr(w_im), out.data_ptr(), x.shape[0], e, t, RBF_KINDS[kind])
    return out


def pairwise_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """ops/interpolate.py:48 _pairwise_dist (P, E): the squared differences
    summed over x, y, z in that order, clamped at 0, square-rooted."""
    d = a[:, None, :] - b[None, :, :]
    d2 = d[..., 0] ** 2 + d[..., 1] ** 2 + d[..., 2] ** 2
    return torch.sqrt(torch.clamp(d2, min=0.0))


def rbf_phi(r: torch.Tensor, epsilon, kind: str) -> torch.Tensor:
    """ops/interpolate.py:34 _kernel."""
    if kind == "multiquadric":
        return torch.sqrt((r / epsilon) ** 2 + 1.0)
    if kind == "inverse_multiquadric":
        return 1.0 / torch.sqrt((r / epsilon) ** 2 + 1.0)
    if kind == "gaussian":
        return torch.exp(-((r / epsilon) ** 2))
    if kind == "linear":
        return r
    if kind == "thin_plate":
        pos = r > 0
        return torch.where(pos, r ** 2 * torch.log(torch.where(pos, r, torch.ones_like(r))),
                           torch.zeros_like(r))
    raise ValueError(f"unknown RBF kind: {kind!r}")


def plain_rbf_basis(c, eps, kind, smooth=0.0):
    """The system matrix phi(|c_i - c_j| / eps) - smooth I (E, E)
    (ops/interpolate.py:93-94)."""
    a = rbf_phi(pairwise_dist(c, c), eps, kind)
    return a - smooth * torch.eye(c.shape[0], dtype=a.dtype, device=a.device)


def plain_rbf_fit(c, eps, planes, kind, smooth=0.0, pivots=None):
    """Plain torch version of `rbf_fit`: the system of `plain_rbf_basis`,
    `torch.linalg.lu_factor_ex` and `lu_solve` of the planes stacked as
    columns (E, planes T)."""
    e, t = c.shape[0], planes[0].shape[0]
    lu, piv, info = torch.linalg.lu_factor_ex(plain_rbf_basis(c, eps, kind, smooth))
    w = torch.linalg.lu_solve(lu, piv, torch.cat([p.T for p in planes], dim=1))
    if pivots is not None:
        pivots.copy_(piv)
    return w.reshape(e, len(planes), t).transpose(0, 1).contiguous(), info.reshape(1)


def plain_rbf_eval(x, c, eps, w, kind, w_im=None):
    """Plain torch version of `rbf_eval`: (b @ w).T of the (P, E) matrix b
    = phi(|x_p - c_e| / eps), and the angle of the complex interpolant with
    w_im."""
    b = rbf_phi(pairwise_dist(x, c), eps, kind)
    re = (b @ w).T
    if w_im is None:
        return re
    return torch.atan2((b @ w_im).T, re)
