"""The one kernel library shared by every wrapper module, and its launch counts.

`library()` builds `csrc/*.cu` (through `kernels.build`) and loads the result
with ctypes at first use; every C entry point is registered here with its
argument types, in float32 (`_f32`) and float64 (`_f64`) instances.
`LAUNCHES` counts kernel launches by "name<ctype>" across all wrapper
modules, so one counted run sees every kernel; `_launch` adds one where it
launches and nowhere else.

The helpers below are what every wrapper does before either path: check
dtype, shape and contiguity, and decide by the tensors' device (CPU: the
plain torch version; CUDA: the kernel, or raise).
"""

from __future__ import annotations

import ctypes

import torch

from manifold_flow_tpu_torch.kernels import build

_CTYPES = {torch.float32: ("float", "f32"), torch.float64: ("double", "f64")}

_P, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
_ARGTYPES = {
    # fem_kernels.cu, pcg_kernels.cu (kernels.fem)
    "fem_matvec": [_P] * 5 + [_D] + [_P] * 4 + [_I] * 4 + [_P],
    "jacobi_blocks": [_P] * 3 + [_D] + [_P] * 2 + [_I] * 4 + [_P],
    "frame_factors_rhs": [_P] * 11 + [_I] * 4 + [_P],
    "pcg_dot": [_P] * 3 + [_I] * 2 + [_P],
    "pcg_update": [_P] * 10 + [_I] * 2 + [_P],
    "pcg_direction": [_P] * 4 + [_I] * 2 + [_P],
    # analysis_kernels.cu (kernels.analysis)
    "recombine_speed": [_P] * 5 + [_I] * 2 + [_P],
    "detect_singular": [_P] * 5 + [_D] + [_P] * 5 + [_I] * 3 + [_P],
    "compact_detected": [_P] * 10 + [_I] * 5 + [_P],
    # coarse_kernels.cu (kernels.coarse)
    "coarse_assemble": [_P] * 8 + [_D] + [_P] * 2 + [_I] * 5 + [_P],
    "coarse_restrict": [_P] * 4 + [_I] * 4 + [_P],
    "coarse_gemv": [_P] * 3 + [_I] * 3 + [_P],
    "coarse_prolong_dot": [_P] * 6 + [_I] * 3 + [_P],
}

LAUNCHES: dict[str, int] = {f"{name}<{ctype}>": 0 for name in _ARGTYPES
                            for ctype, _ in _CTYPES.values()}

_LIB: ctypes.CDLL | None = None


def reset_launches() -> None:
    """Set every launch count to 0."""
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def library() -> ctypes.CDLL:
    """The kernel library, built and loaded on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build.build()))
        for name, argtypes in _ARGTYPES.items():
            for _, suffix in _CTYPES.values():
                fn = getattr(lib, f"mf_{name}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.mf_error_string.argtypes = [ctypes.c_int]
        lib.mf_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _on_cuda(*tensors: torch.Tensor | None) -> bool:
    """False when every tensor is on the CPU, True when all are on one CUDA
    device; anything else raises."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors must share one device; got {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cpu":
        return False
    if device.type == "cuda":
        return True
    raise ValueError(f"unsupported device {device}: want cpu or cuda")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}; got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}; got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _float_dtype(name: str, t: torch.Tensor) -> torch.dtype:
    if t.dtype not in _CTYPES:
        raise TypeError(f"{name} must be float32 or float64; got {t.dtype}")
    return t.dtype


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _launch(name: str, dtype: torch.dtype, device: torch.device, *args) -> None:
    ctype, suffix = _CTYPES[dtype]
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"mf_{name}_{suffix}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}<{ctype}> launch failed: CUDA error {err} "
                           f"({lib.mf_error_string(err).decode()})")
    LAUNCHES[f"{name}<{ctype}>"] += 1
