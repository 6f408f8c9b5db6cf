"""The one kernel library shared by every wrapper module, and its launch counts.

`library()` builds `csrc/*.cu` (through `kernels.build`) and loads the result
with ctypes at first use; every C entry point is registered here with its
argument types, in float32 (`_f32`) and float64 (`_f64`) instances, K3's
dot and update and K11 also in a float32 instance that sums in float64
(`_f32acc64`, solve_cg's precise_dots), and so are the entry points that
size a kernel's workspace (`_workspace`). `LAUNCHES` counts kernel launches
by "name<ctype>" ("name<float,double>" for the precise instances) across all
wrapper modules, so one counted run sees every kernel; `_launch` adds one
where it launches and nowhere else.

The helpers below are what every wrapper does before either path: check
dtype, shape and contiguity, and decide by the tensors' device (CPU: the
plain torch version; CUDA: the kernel, or raise). `frame_slices` and
`slice_workspace` serve the kernels that cut each frame into slices and
close their per-frame sums in slice order (K3 `pcg_update`, K11
`coarse_prolong_dot`; common.cuh `close_slices`).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from manifold_flow_tpu_torch.kernels import build

_CTYPES = {torch.float32: ("float", "f32"), torch.float64: ("double", "f64")}

_P, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
_ARGTYPES = {
    # fem_kernels.cu, pcg_kernels.cu (kernels.fem)
    "fem_matvec": [_P] * 5 + [_D] + [_P] * 5 + [_I] * 9 + [_P],
    "jacobi_blocks": [_P] * 3 + [_D] + [_P] * 2 + [_I] * 4 + [_P],
    "frame_factors_rhs": [_P] * 14 + [_I] * 8 + [_P],
    "pcg_dot": [_P] * 3 + [_I] * 2 + [_P],
    "pcg_update": [_P] * 12 + [_I] * 3 + [_P],
    "pcg_direction": [_P] * 4 + [_I] * 2 + [_P],
    # analysis_kernels.cu (kernels.analysis)
    "recombine_speed": [_P] * 5 + [_I] * 2 + [_P],
    "detect_singular": [_P] * 5 + [_D] + [_P] * 5 + [_I] * 3 + [_P],
    "compact_detected": [_P] * 10 + [_I] * 5 + [_P],
    "classify_candidates": [_P] * 16 + [_I] * 6 + [_P],
    # coarse_kernels.cu (kernels.coarse)
    "coarse_assemble": [_P] * 8 + [_D] + [_P] * 2 + [_I] * 5 + [_P],
    "coarse_restrict": [_P] * 4 + [_I] * 4 + [_P],
    "coarse_gemv": [_P] * 3 + [_I] * 3 + [_P],
    "coarse_prolong_dot": [_P] * 8 + [_I] * 4 + [_P],
    # stream_kernels.cu (kernels.streams)
    "next_hop": [_P] * 7 + [_I] * 3 + [_P],
    # winding_kernels.cu (kernels.winding)
    "winding_profile": [_P] * 8 + [_I] * 5 + [_P],
    # field_kernels.cu (kernels.fields)
    "wave_speed": [_P] * 7 + [_I] * 3 + [_D] + [_I] + [_P],
    "rbf_fit": [_P] * 8 + [_I] * 3 + [_D] + [_P],
    "rbf_eval": [_P] * 6 + [_I] * 4 + [_P],
}
# Entry points that read and write integers only, one int32 instance each
# (`_i32`, counted as "name<int>").
_INT_ARGTYPES = {
    "trace_walks": [_P] * 2 + [_I] * 3 + [_P],
    "pack_walks": [_P] * 5 + [_I] * 2 + [_P],
}
_INT = ("int", "i32")
# Float32 entry points with float64 per-frame sums (`_f32acc64`, counted as
# "name<float,double>"): the precise instances of solve_cg(precise_dots=True).
_PRECISE_NAMES = ("pcg_dot", "pcg_update", "coarse_prolong_dot")
_PRECISE = ("float,double", "f32acc64")
# Entry points that size a kernel's workspace in bytes (no launch), one a
# float type each: mf_<name>_workspace_<suffix>.
_WORKSPACE_ARGTYPES = {"rbf_fit": [_I] * 3}

LAUNCHES: dict[str, int] = {
    **{f"{name}<{ctype}>": 0 for name in _ARGTYPES for ctype, _ in _CTYPES.values()},
    **{f"{name}<{_PRECISE[0]}>": 0 for name in _PRECISE_NAMES},
    **{f"{name}<{_INT[0]}>": 0 for name in _INT_ARGTYPES}}

_LIB: ctypes.CDLL | None = None

# Inside `named_launches()` (utils.profiling.trace) each launch sits in a
# host range named after its LAUNCHES key, so a trace names the wrapper.
# Off elsewhere: the profiler shows such a range on the device timeline too,
# where other profiles' device-time sums would count its kernel twice.
_NAMED_LAUNCHES = False

MAX_SLICES = 128  # csrc/common.cuh kMaxSlices
_SLICE_WORKSPACE: dict = {}


@contextlib.contextmanager
def named_launches():
    """Put each launch inside the block in a host range named after its
    LAUNCHES key (for a profiler's trace)."""
    global _NAMED_LAUNCHES
    before, _NAMED_LAUNCHES = _NAMED_LAUNCHES, True
    try:
        yield
    finally:
        _NAMED_LAUNCHES = before


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
        for name in _PRECISE_NAMES:
            fn = getattr(lib, f"mf_{name}_{_PRECISE[1]}")
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
        for name, argtypes in _INT_ARGTYPES.items():
            fn = getattr(lib, f"mf_{name}_{_INT[1]}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, argtypes in _WORKSPACE_ARGTYPES.items():
            for _, suffix in _CTYPES.values():
                fn = getattr(lib, f"mf_{name}_workspace_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int64
        lib.mf_error_string.argtypes = [ctypes.c_int]
        lib.mf_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def frame_slices(n_vert: int, dtype: torch.dtype) -> int:
    """Blocks a frame of the sliced kernels: one 16-byte group of vertices
    for each of a block's 256 threads (4 at the bench shapes in f32, 13 at
    12.5k; 7 and 25 in f64), at least 1 and at most MAX_SLICES."""
    per_block = 16 // (torch.finfo(dtype).bits // 8) * 256
    return max(1, min(MAX_SLICES, -(-n_vert // per_block)))


def slice_workspace(device: torch.device, stream: int, n_frames: int,
                    n_slices: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The partials (room for (T, S, 2) values of either float type, so for
    the float64 partials of the precise instances too) and the
    (T,) int32 tickets through which the sliced kernels close their sums,
    one pair per (device, stream) shared by those kernels and kept across
    calls: each kernel leaves every ticket at 0, and launches on one stream
    run in order. A pair too small for (n_frames, n_slices) is replaced."""
    key = (device, stream)
    ws = _SLICE_WORKSPACE.get(key)
    if ws is None or ws[0].numel() < 2 * n_frames * n_slices or ws[1].numel() < n_frames:
        ws = (torch.empty(2 * n_frames * n_slices, dtype=torch.float64, device=device),
              torch.zeros(n_frames, dtype=torch.int32, device=device))
        _SLICE_WORKSPACE[key] = ws
    return ws


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


def _workspace(name: str, dtype: torch.dtype, device: torch.device,
               *args) -> torch.Tensor | None:
    """The scratch kernel `name` (its `dtype` instance) needs for `args`, as
    its entry point mf_<name>_workspace sizes it on `device`: a uint8
    tensor, or None where it needs none."""
    fn = getattr(library(), f"mf_{name}_workspace_{_CTYPES[dtype][1]}")
    with torch.cuda.device(device):
        nbytes = fn(*args)
    return torch.empty(nbytes, dtype=torch.uint8, device=device) if nbytes > 0 else None


def _launch(name: str, dtype: torch.dtype | None, device: torch.device, *args,
            precise: bool = False) -> None:
    """Launch entry point `name` (its `dtype` instance; None for the integer
    entry points; with `precise`, the float32 instance that sums in float64)
    on the current stream of `device`, raise on a CUDA error, and count the
    launch."""
    if precise and (name not in _PRECISE_NAMES or dtype != torch.float32):
        raise ValueError(f"{name} has no float64-accumulating {dtype} instance")
    ctype, suffix = (_PRECISE if precise else _INT if dtype is None
                     else _CTYPES[dtype])
    key = f"{name}<{ctype}>"
    lib = library()
    rng = (torch.autograd.profiler.record_function(key) if _NAMED_LAUNCHES
           else contextlib.nullcontext())
    with rng, torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"mf_{name}_{suffix}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{key} launch failed: CUDA error {err} "
                           f"({lib.mf_error_string(err).decode()})")
    LAUNCHES[key] += 1
