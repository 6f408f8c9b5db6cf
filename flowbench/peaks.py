"""The H100's peaks and the least-work bounds the roofline readers use.

Origin: chip_smoke.py at commit 812b413 (`HBM_BYTES_S`, `PEAK_OPS_S`,
`PEAK_MM_OPS_S`, `bound_of`, `svd_bound`, `hilbert_bound`, lines 267-274,
450-459 and 1811-1834). Frozen here so that the yardstick cannot move with
the program. The one change: `svd_bound` and `hilbert_bound` take a shape,
an element size and complexness instead of a tensor, so that this module
imports nothing but the standard library.

The bound of a kernel: the larger of its bytes over the device memory rate
and its operations over the peak rate of their type (H100 SXM, NVIDIA's
data sheet: 3.35 TB/s; 67 TFLOP/s float32 and 34 TFLOP/s float64 outside
the tensor cores). The multiply-adds of a matrix product count at the
product rate of their type: 67 TFLOP/s float64 on the tensor cores, and
float32's 67 outside them. Integer kernels are bound by their bytes.
"""

from __future__ import annotations

import math

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float": 67e12, "double": 34e12}
PEAK_MM_OPS_S = {"float": 67e12, "double": 67e12}


def bound_of(nbytes: int, ops: float, mm_ops: float, ctype: str = "double") -> tuple:
    """(bound ms, "bytes" or "operations", bytes, all operations): `nbytes`
    over the memory rate or `ops` and the product's `mm_ops` over the peak
    rates of `ctype`, whichever takes longer (bytes alone for integers)."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = (ops / PEAK_OPS_S[ctype] + mm_ops / PEAK_MM_OPS_S[ctype]
             if ctype in PEAK_OPS_S else 0.0)
    return (max(t_bytes, t_ops) * 1e3, "operations" if t_ops > t_bytes else "bytes",
            nbytes, ops + mm_ops)


def svd_bound(shape, itemsize: int, is_complex: bool = False) -> tuple:
    """The thin SVD of an (m, n) movie, m <= n, by its least work: the Gram
    matrix A A^H and V = A^H U Sigma^-1, m^2 n multiply-adds each, at the
    product rate (a complex multiply-add is four real ones), and the m x m
    eigenproblem, ~9 m^3 operations (x4 complex) outside it; bytes: A read
    once, U, sigma and V^H written once. `itemsize` is an element's bytes
    (16 for complex128)."""
    m, n = sorted(shape)
    c = 4 if is_complex else 1
    nbytes = (m * n + m * m + m * n) * itemsize + m * itemsize // (2 if is_complex else 1)
    return bound_of(nbytes, 9 * c * m ** 3, 2 * 2 * c * m * m * n)


def hilbert_bound(shape, itemsize: int) -> tuple:
    """The Hilbert transform of a real (N, E) movie along axis 0: an FFT and
    an inverse FFT of each column, 5 N log2 N operations each; bytes: the
    real input read once, the complex output written once."""
    length, cols = shape
    return bound_of(length * cols * itemsize * 3,
                    2 * 5 * length * math.log2(length) * cols, 0.0)
