"""The least device time of the traced work, from shapes and counts alone.

These count what any implementation of the algorithm must move or compute,
not what the port's kernels do, so fusing or splitting kernels leaves them
as they are, and no correct run can read above the peak.

The solve (S3): each inner PCG iteration (float32) reads the operator's
per-frame factors g (T, M, 3, 2), the mesh's triangles and the symmetric
6 x 6 regularisation block of each cell, the preconditioner's symmetric
2 x 2 Jacobi blocks (T, N) and, under the two-level preconditioner, the
symmetric coarse inverses (T, 2Nc, 2Nc), the aggregate map and the
prolongation blocks; and it reads and writes once the state that persists
between iterations, x, r and p (T, 2N). Temporaries a fused implementation
keeps on chip (Ap, z, partial dots) are not counted. Each outer residual
step (float64) reads g, the mesh tables, x and f and writes r.

The field stages (S2, S4, S5): the Hilbert transform of the epoch
(`peaks.hilbert_bound`), each RBF fit (the planes in, the weights out) and
evaluation (targets, electrodes and weights in, the movie out, 2 T N E
multiply-adds), the wave speed (the phase movie in, the speeds out, the
mesh tables), and the SVD (`peaks.svd_bound`).
"""

from __future__ import annotations

from flowbench import peaks

F32, F64, I32 = 4, 8, 4


def solve_iteration_bytes(shapes: dict) -> float:
    t, n, m = shapes["solve_window"], shapes["n_vertices"], shapes["n_cells"]
    mesh = m * 3 * I32 + m * 21 * F32
    nbytes = t * m * 6 * F32 + mesh + t * n * 3 * F32 + 6 * t * 2 * n * F32
    if shapes["two_level"]:
        nc = 2 * shapes["n_coarse"]
        nbytes += t * nc * (nc + 1) // 2 * F32 + n * I32 + n * 4 * F32
    return float(nbytes)


def solve_residual_bytes(shapes: dict) -> float:
    t, n, m = shapes["solve_window"], shapes["n_vertices"], shapes["n_cells"]
    return float(t * m * 6 * F64 + m * 3 * I32 + m * 21 * F64 + 3 * t * 2 * n * F64)


def solve_bound_s(shapes: dict, inner_iterations: int, residuals: int) -> float:
    """Seconds: the solve's bytes over the memory rate."""
    return (inner_iterations * solve_iteration_bytes(shapes)
            + residuals * solve_residual_bytes(shapes)) / peaks.HBM_BYTES_S


def fields_bound_s(shapes: dict, stages: list[str]) -> float:
    """Seconds: the least time of one request's field stages."""
    t, n, m = shapes["frames"], shapes["n_vertices"], shapes["n_cells"]
    e, s = shapes["n_electrodes"], shapes["n_samples"]
    ms = 0.0

    def rbf(planes):
        fit = peaks.bound_of((e * 3 + 2 * planes * t * e) * F64, 0.0, 0.0)[0]
        ev = peaks.bound_of((n * 3 + e * 3 + planes * t * e + t * n) * F64,
                            0.0, 2.0 * planes * t * n * e)[0]
        return fit + ev

    if "interpolate" in stages:
        ms += rbf(1)
    if "interpolate_phases" in stages:
        ms += peaks.hilbert_bound((s, e), F64)[0] + rbf(2)
    if "wavespeed" in stages:
        tables = m * 3 * I32 + m * 9 * F64 + m * F64 + 3 * m * I32 + n * 6 * F64
        ms += peaks.bound_of(2 * t * n * F64 + tables, 0.0, 0.0)[0]
    if "decompose" in stages:
        ms += peaks.svd_bound((shapes["velocity_frames"], 2 * n), F64)[0]
    return ms * 1e-3
