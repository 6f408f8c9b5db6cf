"""The card's correctness check of the PyTorch/CUDA port
(manifold_flow_tpu_torch), with each kernel's time against its bound.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Any failed check raises and the exit code is non-zero. End-to-end and
in-solve times are the benchmark's (flowbench/run.py --trace 1), not this
script's. Problems: the bench patch (3136 vertices, 98 frames of a
two-source movie, lambda 0.01) and the 12.5k patch (12544 vertices, 98
frames). RMSE is against scipy's spsolve over the first frames, over
max|v|, gated below 1e-5. Phases, in order:

- [device] needs CUDA; prints the card, its power limit, torch and CUDA.
- [build] nvcc builds csrc/*.cu for sm_90a; prints the library.
- [kernels] each kernel against its plain version on the same inputs, at
  the bench shapes (K5-K7 and K12-K17 after [slice], on its field), and in
  later phases at 12.5k ('@12.5k'), on the reconstructed surface ('@recon')
  and in the float64-summing instances ('<float,double>'): float outputs within 1e-5 (f32) / 1e-12 (f64) of their scale, discrete outputs
  equal; K16's inf and NaN in place; K17's fit by its backward error (1e-5 /
  1e-13), its interpolant and its info word; K13's plain version also equal
  to mesh_next_hop on the raw mesh tables; K3's update, K9 and K11 equal
  over two calls. Each row prints its error, the wrapper's and the plain
  version's ms (CUDA events, 20 calls, median of 5), device_us (the
  kernel's own profiler events over 20 calls; windows retaken until two
  agree, else "not measured") and its bound (flowbench.peaks: bytes over
  the memory rate or operations over the peak rate) with bound/device. A
  row whose device time reads below its bound is retaken with the L2
  cleared before each call, and fails if it stays below.
- [slice] the refined solve (tol 1e-6) of the bench problem: every frame
  converged, K1-K4 launched, RMSE over 6 frames, 84 +- 2 inner iterations.
- [flow] the flow CLI on the bench surface: every frame converged, K1-K7
  launched, its four artifacts equal to the stages run in memory; prints
  the singularities a frame and each true source's nearest detection.
- [trial] `flow --classify`, `streamline`, `winding` through the CLI: as
  [flow], K12-K15 launched too; walks, class codes, next hops and ring
  counts equal to the plain versions' in both quirk modes.
- [fields] `interpolate` (+ --phases) of 64 electrodes, `wavespeed` (phase,
  amplitude), `decompose` (concat, complex), `demo`: K16 and K17 launched in
  the calls that run each variant, `rbf_fit` once a call, artifacts equal to
  the stages in memory, no LU library kernel in them, the SVD against
  numpy's (sigma 1e-10, rank-K reconstruction 1e-8), the demo matched.
  [fields12k] prints the LU kernels it finds: cuSOLVER's SVD of a
  (97, 25088) movie runs one of its own.
- [batch] run_batch over a two-subject tree of those inputs (and the
  `reconstruct` CLI's surface): no error, K1-K7 and K13-K17 launched,
  artifacts equal to the CLIs' (bitwise or within 1e-12; it says which), a
  resume that skips every stage and launches nothing, a profiled trial
  with no host-to-device copy of a velocity field, then [reconstructed]'s
  rows and the `batch` CLI in a fresh process.
- [cg] float64 cg at tol 1e-8: converged, RMSE, its kernels launched.
- [anchor] the refined solve at anchor_stride 1, 2 and 4: converged, RMSE.
- [profiling] utils.profiling.trace of one solve names fem_matvec.
- [twolevel] the 12.5k refined solve (precond 'auto'): converged, K8-K11
  launched, RMSE over 2 frames, 60 +- 2 inner iterations; both
  preconditioners at both sizes converged; float64 cg two-level at 12.5k.
- [precise] float32 cg with precise_dots at both sizes: converged, only the
  precise instances launched; then the default refined solve's launches
  equal REFINED_LAUNCHES (with its frozen iterations and captures).
- [flow12k], [trial12k], [fields12k] (no demo), [batch12k]: as at 3.1k on
  the 12.5k patch, K8-K11 launched too.
- [viz] `visualize` and `demo --gif` render where matplotlib imports, else
  `visualize` raises an ImportError naming it.
- [dist] the halo solves in a world of one over NCCL, then 2 and 4
  processes sharing the card over gloo (refined at four layouts, cg, the
  analysis ops, run_batch(distributed=True)): converged, RMSE, every rank
  the same result and its kernels launched, equal to one GPU's.
- [long] 392 frames in 104-frame windows and whole: converged, RMSE on 8
  frames across the seams, within 1e-5 max|v| of each other.
- [cholesky] method='cholesky': RMSE, its difference from cg.

Then every kernel must have launched in some phase, and the script prints
the kernels' JSON line (each row some phase launches: name, source,
replaces, launches, max_abs_err, ms, plain_ms, bound_ms, bound_by,
device_us, bound_over_device), the card's name and power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

# The H100's rates and a kernel's bound, from the benchmark's frozen copy.
from flowbench.peaks import PEAK_OPS_S, bound_of

ROOT = Path(__file__).resolve().parent
N_SAMPLE = 6          # frames checked against spsolve (as bench.py does)
RMSE_GATE = 1e-5
TOL_F32 = 1e-5        # kernel vs plain, relative to the output's max |value|
TOL_F64 = 1e-12
MAX_STEPS = 256       # AnalysisConfig's defaults (pipeline/config.py)
MIN_LENGTH = 20
LEVELS = 25


def scratch_dir(prefix: str, workdir: Path | None):
    """A temporary directory, or `workdir` (created) kept for a later phase."""
    if workdir is None:
        return tempfile.TemporaryDirectory(prefix=prefix)
    workdir.mkdir(parents=True, exist_ok=True)
    return contextlib.nullcontext(str(workdir))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Time per call of fn() in ms: CUDA events around `reps` back-to-back
    calls, the median over `rounds`, after a warm-up (calls slower than 5 ms:
    about 50 ms of calls a round, 3 rounds). A call whose host side
    (Python, ctypes, allocation) outlasts its kernels is timed at the host's
    launch rate; `device_us` gives the kernels' own device time."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    if first > 0.005:  # a slow call (a plain version at 12.5k): fewer of them
        reps, rounds = max(1, min(reps, int(0.05 / first))), 3
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def own_kernel(name: str) -> bool:
    """A device event of the package's own kernels (namespace mf), by its
    demangled or mangled name."""
    return "mf::" in name or "_ZN2mf" in name


# Profiler windows `device_us` takes at most beyond its first two, when a
# window falls short of the calls' launches or two whole windows disagree.
DEVICE_US_RETAKES = 6
# Retakes of a kernel row whose device time reads below its bound, each with
# the L2 cleared before every call (`KernelChecks.compare`).
BELOW_BOUND_RETAKES = 2
_L2_FLUSH: list = []


def clear_l2() -> None:
    """Read a 128 MiB buffer (more than the H100's 50 MB L2): the lines it
    leaves are clean, so nothing is written back inside a timed kernel."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.ones(32 << 20, dtype=torch.float32, device="cuda"))
    _L2_FLUSH[0].sum()


def device_events(prof) -> list:
    """The device's own events of a closed profile (`key_averages()`): its
    kernels, copies and sets. The host ranges that the profiler also draws
    on the device timeline (the schedule's "ProfilerStep#", the package's
    utils.profiling spans, named launches) are no device work and are left
    out."""
    return [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and not e.key.startswith("ProfilerStep")
            and not getattr(e, "is_user_annotation", False)]


@contextlib.contextmanager
def profiled():
    """torch.profiler (CPU and CUDA) over the block, after one traced
    warm-up step that is dropped (a small device operation and a wait): the
    device tracing loses events while it starts."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        yield prof


def device_us(fn, calls: int = 20, mine=None, before=None, label: str = "",
              retakes: int = DEVICE_US_RETAKES) -> float | None:
    """Device time per call of fn() in µs: torch.profiler's
    self_device_time_total of the device kernels over `calls` back-to-back
    calls (after two warm calls), divided by `calls`; only those whose name
    `mine` accepts, where given (a kernel's own time, not its wrapper's
    allocations). Back to back, inputs that fit the 50 MB L2 stay there;
    `before()`, where given, runs before each call (`mine` must then leave
    its kernels out).

    The profiler loses the device events of a window's first calls while
    its device tracing starts (5 of 20 calls at times), which then read
    low. So each window runs the calls twice, as a warm-up step that is
    traced and dropped and then the measured step (torch.profiler's
    schedule), and the kept events are counted against what the calls
    launched: each of the package's kernels must show `calls` times the
    launches of its wrapper in the second warm call (LAUNCHES), and every
    other kernel a multiple of `calls`, the same in two windows. A window
    that falls short is retaken, at most `retakes` times beyond the first
    two, each retake printed. The reading is the mean of two whole windows
    that agree; None (not measured, printed) where there are no two."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from manifold_flow_tpu_torch.kernels import LAUNCHES

    fn()
    torch.cuda.synchronize()
    start = dict(LAUNCHES)
    fn()
    torch.cuda.synchronize()
    per_call = {k: n - start[k] for k, n in LAUNCHES.items() if n > start[k]}
    whole: dict[tuple, float] = {}  # device µs of the whole windows, by events
    for window in range(2 + retakes):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(calls):
                    if before is not None:
                        before()
                    fn()
                torch.cuda.synchronize()
                prof.step()
        kept = [e for e in device_events(prof) if mine is None or mine(e.key)]
        counts: dict[str, int] = {}
        for e in kept:
            counts[e.key] = counts.get(e.key, 0) + e.count
        total = sum(e.self_device_time_total for e in kept)
        short = short_events(counts, calls, per_call, every_launch=mine is None)
        events = tuple(sorted(counts.items()))
        is_whole = bool(counts) and not short
        if is_whole and events in whole:
            return (whole[events] + total) / (2 * calls)
        if not is_whole or window >= 1:
            last = window + 1 == 2 + retakes
            why = (f"short: {'; '.join(short[:3]) or 'no events'}" if not is_whole
                   else "whole, but not as the whole windows before")
            print(f"[device_us] {label or 'a call'}: window {window + 1} of {calls} calls "
                  f"{why}; " + ("NOT MEASURED: no two whole windows agree" if last
                                else "retaken"), flush=True)
        if is_whole:
            whole[events] = total
    return None


def short_events(counts: dict, calls: int, per_call: dict, every_launch: bool) -> list:
    """What a profiler window of `calls` calls lacks, given its device
    events' `counts` by name and the LAUNCHES keys a call launches
    (`per_call`): a package kernel that shows other than `calls` times its
    wrapper's launches, another kernel that shows other than a multiple of
    `calls`, and, with `every_launch` (no kernel filtered out), a wrapper
    that launched with no event at all. Empty for a whole window."""
    short = []
    for name, n in counts.items():
        key = launch_key(name)
        want = calls * per_call[key] if key in per_call else None
        if (n != want) if want is not None else (n % calls != 0):
            short.append(f"{name[:60]} x{n}" + (f" (want {want})" if want else ""))
    if every_launch:
        seen = {launch_key(name) for name in counts}
        short += [f"{key}: no event (want {calls * n})" for key, n in per_call.items()
                  if key not in seen]
    return short


def launch_key(key: str) -> str | None:
    """The LAUNCHES key (wrapper<ctype>) of a device event of the package's
    kernels, None for another event."""
    hit = kernel_of(key)
    if hit is None or hit[0] not in WRAPPER_OF:
        return None
    # K14's kernels read integers; their template argument is a layout.
    ctype = "int" if hit[0] in ("trace_walks_kernel", "pack_walks_kernel") else hit[1]
    return f"{WRAPPER_OF[hit[0]]}<{ctype}>"


def fmt_us(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.2f} us"


# The package's device kernels (namespace mf) by the wrapper that launches
# them: `device_us` holds a window's events to the wrappers' launches.
WRAPPER_OF = {
    "fem_tile_kernel": "fem_matvec", "jacobi_kernel": "jacobi_blocks",
    "frame_factors_rhs_kernel": "frame_factors_rhs",
    "dot_kernel": "pcg_dot", "update_kernel": "pcg_update",
    "direction_kernel": "pcg_direction", "gate_kernel": "pcg_gate",
    "coarse_a2_kernel": "coarse_assemble",
    "assemble_kernel": "coarse_assemble", "assemble_mean_kernel": "coarse_assemble",
    "restrict_kernel": "coarse_restrict",
    "gemv_kernel": "coarse_gemv", "gemv_vectors_kernel": "coarse_gemv",
    "prolong_dot_kernel": "coarse_prolong_dot",
    "recombine_speed_kernel": "recombine_speed",
    "detect_singular_kernel": "detect_singular",
    "classify_candidates_kernel": "classify_candidates",
    "compact_detected_masks_kernel": "compact_detected",
    "compact_detected_snap_kernel": "compact_detected",
    "compact_detected_merge_kernel": "compact_detected",
    "next_hop_kernel": "next_hop", "trace_walks_kernel": "trace_walks",
    "pack_walks_kernel": "pack_walks", "winding_profile_kernel": "winding_profile",
    "wave_speed_kernel": "wave_speed", "rbf_fit_kernel": "rbf_fit",
    "rbf_eval_kernel": "rbf_eval"}


MANGLED_TYPES = {"f": "float", "d": "double", "i": "int"}


def kernel_of(key: str) -> tuple | None:
    """(kernel, ctype) of a device event of the package's kernels, named
    mf::<kernel><types> or, untemplated, by its first argument's type; or
    by its mangled name (_ZN2mf<len><kernel>I<types>... or E<pointer to
    type>...), which the profiler gives at times. None for other events.
    The ctype is the kernel's float type, or "float,double" where its
    template arguments are the two types of a precise instance (K3's
    <float, double>, whose sums are double); integer arguments (a frame
    count) are no type."""
    import re

    def ctype_of(types: list) -> str | None:
        types = [t for t in types if t in ("float", "double", "int")]
        if not types:
            return None
        return types[0] if len(set(types)) == 1 else ",".join(types)

    hit = re.search(r"mf::(\w+?)(?:<([\w, ]+)>|\((\w+))", key)
    if hit is not None:
        if hit.group(2) is not None:
            return hit.group(1), ctype_of([t.strip() for t in hit.group(2).split(",")])
        return hit.group(1), hit.group(3)
    hit = re.search(r"_ZN2mf(\d+)", key)
    if hit is None:
        return None
    name = key[hit.end():hit.end() + int(hit.group(1))]
    rest = key[hit.end() + len(name):]
    code = re.match(r"I([fdi]+)", rest) or re.match(r"EP?K?(\w)", rest)
    if code is None:
        return None
    return name, ctype_of([MANGLED_TYPES[c] for c in code.group(1)])


def build_problem(device, dtype=np.float64):
    """bench.py's problem (bench.py:26-38), built with the port on `device`
    in `dtype`: (mesh, potentials (98, N), times (98,), true sources (2, 3))."""
    from manifold_flow_tpu_torch.geometry import synthetic

    mesh = synthetic.plane_patch(
        nx=56, ny=56, lx=60.0, ly=60.0,
        height=lambda x, y: 6.0 * np.sin(x / 12.0) * np.cos(y / 15.0),
        dtype=dtype, device=device)
    return mesh, *synthetic.two_source_movie(
        mesh, sources=((15.0, 15.0), (45.0, 45.0)), n_frames=98,
        speed=24.0, wavelength=24.0, dt=1.0 / 512.0, dtype=dtype)


def build_problem_12k(device, dtype=np.float64):
    """bench.py:465-474's large surface (112x112 over 60x60, 12544 vertices)
    with bench.py:535-538's 98-frame two-source movie, on `device` in
    `dtype`."""
    from manifold_flow_tpu_torch.geometry import synthetic

    mesh = synthetic.plane_patch(
        nx=112, ny=112, lx=60.0, ly=60.0,
        height=lambda x, y: 6.0 * np.sin(x / 12.0) * np.cos(y / 15.0),
        dtype=dtype, device=device)
    return mesh, *synthetic.two_source_movie(
        mesh, sources=((15.0, 15.0), (45.0, 45.0)), n_frames=98,
        speed=24.0, wavelength=24.0, dt=1.0 / 512.0, dtype=dtype)


def spsolve_reference(mesh, pot, times, n_sample: int) -> np.ndarray:
    """First n_sample frames solved by SuperLU, as bench.py:777-799 does."""
    from scipy.sparse.linalg import spsolve

    from tests.oracle import reference_impl as ref

    points = mesh.points.cpu().numpy()
    triangles = mesh.triangles.cpu().numpy()
    pot = pot.cpu().numpy()
    times = times.cpu().numpy()
    e = ref.orthonormal_basis_np(mesh.normals.cpu().numpy())
    grad_w = ref.hat_gradients_np(points, triangles)
    areas = ref.triangle_areas_np(points, triangles)
    a2 = ref.assemble_a2_np(triangles, areas, e, grad_w)
    sols = []
    for k in range(n_sample):
        a1, f = ref.assemble_frame_np(pot[k], pot[k + 1], times[k + 1] - times[k],
                                      triangles, grad_w, e, areas)
        sols.append(spsolve((a1 + 0.01 * a2).tocsr(), f))
    return np.stack(sols)


def tensor_bytes(*tensors) -> int:
    """Bytes of the distinct tensors among `tensors` (anything else is
    ignored): each input is read once and each output written once."""
    seen, total = set(), 0
    for x in tensors:
        if isinstance(x, torch.Tensor) and (x.data_ptr(), x.numel()) not in seen:
            seen.add((x.data_ptr(), x.numel()))
            total += x.numel() * x.element_size()
    return total


class KernelChecks:
    """Each kernel against its plain version, timed beside its bound."""

    def __init__(self, card: str):
        self.card = card
        self.rows: dict[str, dict] = {}

    def compare(self, key: str, source: str, replaces: str, kernel, plain,
                tol: float, scales=None, timed=None, inputs=(), ops: float = 0.0,
                mm_ops: float = 0.0, nbytes: int | None = None,
                launches_key=None, measure=None) -> None:
        """Run kernel() and plain() on the same inputs and compare each
        output against its own scale (max |plain|, or `scales`), then time
        both, or the pair of calls `timed` (in-place kernels time without
        the copies their comparison needs). kernel and plain return a
        tuple of tensors. The bound counts the distinct `inputs` and the
        kernel's outputs (or `nbytes`, where the work depends on the data),
        `ops` operations and `mm_ops`, a matrix product's operations at the
        product rate. `launches_key` names the LAUNCHES entry (the
        key itself by default). `measure(got, want)`, where given, replaces
        the comparison and returns (max abs error, relative error, ok)."""
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        # Integer and bool outputs (masks, ids, counts, centers) must be
        # equal; float outputs agree to `tol` of their scale.
        exact = [torch.equal(a, b) for a, b in zip(got, want)
                 if not b.is_floating_point()]
        floats = [(a, b) for a, b in zip(got, want) if b.is_floating_point()]
        if measure is not None:
            err, rel, finite = measure(got, want)
        else:
            errs = [float((a - b).abs().max()) if a.numel() else 0.0 for a, b in floats]
            if scales is None:
                scales = [float(b.abs().max()) if b.numel() else 0.0 for _, b in floats]
            rel = max((e / max(sc, 1e-300) for e, sc in zip(errs, scales)), default=0.0)
            err = max(errs, default=0.0)
            finite = all(bool(torch.isfinite(a).all()) for a, _ in floats)
        ok = rel <= tol and all(exact) and finite
        time_kernel, time_plain = timed or (kernel, plain)
        ms = time_ms(time_kernel)
        plain_ms = time_ms(time_plain)
        # Device time per call: the kernel's own (the wrapper's allocations
        # and copies left out).
        dev_us = device_us(time_kernel, mine=own_kernel, label=key)
        moved = nbytes if nbytes is not None else tensor_bytes(*inputs, *got)
        # The accumulator's type rates the operations: "float,double" sums
        # in double.
        ctype = key.split("<")[1].split(">")[0].split(",")[-1]
        bound_ms, bound_by, _, _ = bound_of(moved, ops, mm_ops, ctype)
        # Back to back, inputs that fit the L2 can read faster than the
        # bound's one pass over device memory: such a row is retaken with
        # the L2 cleared before each call, and fails the phase if it stays
        # below.
        flushed = ""
        for retake in range(BELOW_BOUND_RETAKES + 1):
            if dev_us is None or dev_us >= bound_ms * 1e3:
                break
            if retake == BELOW_BOUND_RETAKES:
                raise AssertionError(
                    f"{key}: device {dev_us:.2f} us stays below its bound "
                    f"{bound_ms * 1e3:.2f} us with the L2 cleared before each call")
            print(f"[kernels] {key}: device {dev_us:.2f} us reads below its bound "
                  f"{bound_ms * 1e3:.2f} us: retake {retake + 1} with the L2 cleared "
                  f"before each call", flush=True)
            dev_us = device_us(time_kernel, mine=own_kernel, before=clear_l2, label=key)
            flushed = ", L2 cleared before each call"
        bound_over_device = bound_ms * 1e3 / dev_us if dev_us else None
        equal = f", {len(exact)} discrete outputs equal" if exact else ""
        share = (f"{bound_over_device:.3f}" if bound_over_device is not None
                 else "not measured")
        print(f"[kernels] {key}: max_rel_err {rel:.3e} (tol {tol:.0e}){equal} "
              f"kernel {ms:.4f} ms (device {fmt_us(dev_us)}{flushed}) plain {plain_ms:.4f} "
              f"ms bound {bound_ms:.5f} ms ({bound_by}: {moved} B, {ops:.4g} "
              f"ops, {mm_ops:.4g} product ops) bound/device {share} "
              f"{'ok' if ok else 'FAIL'} on {self.card}", flush=True)
        if not ok:
            raise AssertionError(f"{key} disagrees with its plain version: "
                                 f"relative error {rel:.3e} > {tol:.0e}, "
                                 f"discrete outputs equal: {exact}")
        self.rows[key] = {"source": source, "replaces": replaces,
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "device_us": dev_us, "bound_over_device": bound_over_device,
                          "launches_key": launches_key or key}


def check_kernels(mesh, pot, times, card: str) -> KernelChecks:
    from manifold_flow_tpu_torch.fem import assembly
    from manifold_flow_tpu_torch.fem.operator import make_operator
    from manifold_flow_tpu_torch.kernels import fem as kfem
    from manifold_flow_tpu_torch.solve import coarse
    from manifold_flow_tpu_torch.solve.api import build_rhs

    fem_cu = "manifold_flow_tpu_torch/csrc/fem_kernels.cu"
    pcg_cu = "manifold_flow_tpu_torch/csrc/pcg_kernels.cu"
    checks = KernelChecks(card)
    dev = pot.device
    # Operations are counted from each kernel's arithmetic per element (an
    # add, multiply, divide, square root, arccos or deciding comparison is
    # one): a lower bound, M triangles and N vertices a frame.
    n_tri, n_vert = mesh.n_triangles, mesh.n_vertices
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, dtype=torch.float64).to(dev, dtype)

    # K4 frame factors + RHS (f64, as the refined path runs it).
    check_rhs(checks, mesh, pot, times)

    g64, f64 = build_rhs(mesh, pot, times)
    t, n_dof = f64.shape
    n = n_dof // 2
    tables = coarse.build_tables(mesh)
    ops = {torch.float64: make_operator(mesh, g64, 0.01)}
    ops[torch.float32] = ops[torch.float64].astype(torch.float32)
    for dtype, ctype, tol in ((torch.float32, "float", TOL_F32),
                              (torch.float64, "double", TOL_F64)):
        op = ops[dtype]
        # K1: the inner solve's float32 matvec, the refinement's float64
        # residual f - A x.
        check_matvec(checks, mesh, op, rand(t, n_dof, dtype=dtype),
                     f64.to(dtype) if dtype == torch.float64 else None, tol)

        reg = assembly.corner_regularization(mesh, dtype).contiguous()
        jb = (op.g, reg, mesh.areas.to(dtype), op.lambda_, op.gather_base)
        checks.compare(f"jacobi_blocks<{ctype}>", fem_cu,
                       "manifold_flow_tpu/fem/assembly.py:164",
                       lambda: (kfem.jacobi_blocks(*jb),),
                       lambda: (kfem.plain_jacobi_blocks(*jb),), tol,
                       inputs=jb, ops=t * (48 * n_tri + 10 * n_vert))

        # PCG vector kernels on one iteration's worth of real state.
        dinv = kfem.plain_jacobi_blocks(*jb)
        p = rand(t, n_dof, dtype=dtype)
        mv = (op.dof, op.blocks2, op.g, op.w_scale, op.lambda_, op.gather_base)
        ap = kfem.plain_fem_matvec(p, *mv)
        checks.compare(f"pcg_dot<{ctype}>", pcg_cu,
                       "manifold_flow_tpu/solve/cg.py:30",
                       lambda: (kfem.pcg_dot(p, ap),),
                       lambda: (kfem.plain_pcg_dot(p, ap),), tol,
                       inputs=(p, ap), ops=2 * t * n_dof)
        rz = rand(t, dtype=dtype).abs()
        check_update(checks, p, ap, dinv, rz, rand, tol)
        z = rand(t, n_dof, dtype=dtype)
        rz_new = rand(t, dtype=dtype).abs()

        def direction(fn):
            q = p.clone()
            fn(q, z, rz_new, rz)
            return (q,)
        qs = [p.clone(), p.clone()]
        checks.compare(f"pcg_direction<{ctype}>", pcg_cu,
                       "manifold_flow_tpu/solve/cg.py:101",
                       lambda: direction(kfem.pcg_direction),
                       lambda: direction(kfem.plain_pcg_direction), tol,
                       timed=(lambda: kfem.pcg_direction(qs[0], z, rz_new, rz),
                              lambda: kfem.plain_pcg_direction(qs[1], z, rz_new, rz)),
                       inputs=(p, z, rz_new, rz), ops=2 * t * n_dof + 2 * t)
        # K3's gate on |r|^2 about its targets, half the frames above.
        target = rand(t, dtype=dtype).abs() + 0.5
        rr = (target * (0.75 + 0.5 * (torch.arange(t, device=dev) % 2))) ** 2
        ctl0 = torch.tensor([0, 0, 1 << 40], device=dev)

        def gate(fn):
            ctl, out = ctl0.clone(), torch.empty_like(rz)
            fn(rr, target, ctl, rz_new, out)
            return ctl, out
        gates = [(ctl0.clone(), torch.empty_like(rz)) for _ in range(2)]
        checks.compare(f"pcg_gate<{ctype}>", pcg_cu,
                       "manifold_flow_tpu/solve/cg.py:84-87",
                       lambda: gate(kfem.pcg_gate), lambda: gate(kfem.plain_pcg_gate), tol,
                       timed=(lambda: kfem.pcg_gate(rr, target, gates[0][0], rz_new,
                                                    gates[0][1]),
                              lambda: kfem.plain_pcg_gate(rr, target, gates[1][0], rz_new,
                                                          gates[1][1])),
                       inputs=(rr, target, ctl0, rz_new), ops=2 * t)
        # K8 at these shapes, which the two-level crossover runs (the
        # default path takes Jacobi below 6000 vertices): no launches.
        check_assemble(checks, mesh, tables, op, tol, suffix="@3.1k")
    return checks


FEM_CU = "manifold_flow_tpu_torch/csrc/fem_kernels.cu"
PCG_CU = "manifold_flow_tpu_torch/csrc/pcg_kernels.cu"


def check_rhs(checks: KernelChecks, mesh, pot, times, suffix: str = "") -> None:
    """K4 (f64, as the refined path runs it, on the mesh's cached tiles)
    against its plain version. Its bound counts the bytes the function
    needs: the movie (one tensor, read once), the mesh tables, g and f
    written; not the local RHS its first design stored and read back."""
    from manifold_flow_tpu_torch.fem import assembly
    from manifold_flow_tpu_torch.kernels import fem as kfem

    args = (pot, pot, times, mesh.triangles, mesh.grad_w, mesh.basis,
            mesh.areas, assembly.gather_base_table(mesh))
    tiles = assembly.mesh_cell_tiles(mesh)
    n_tri, n_vert = mesh.n_triangles, mesh.n_vertices
    checks.compare("frame_factors_rhs<double>" + suffix, FEM_CU,
                   "manifold_flow_tpu/fem/assembly.py:61",
                   lambda: kfem.frame_factors_rhs(*args, tiles),
                   lambda: kfem.plain_frame_factors_rhs(*args), TOL_F64,
                   inputs=args, ops=(pot.shape[0] - 1) * (75 * n_tri + 6 * n_vert),
                   launches_key="frame_factors_rhs<double>")
    # The float32 instance: no path launches it (the solves assemble in
    # float64); its row gives it a bound beside its time.
    pot32 = pot.to(torch.float32)
    args32 = (pot32, pot32, times.to(torch.float32), mesh.triangles,
              mesh.grad_w.to(torch.float32), mesh.basis.to(torch.float32),
              mesh.areas.to(torch.float32), args[-1])
    checks.compare("frame_factors_rhs<float>" + suffix, FEM_CU,
                   "manifold_flow_tpu/fem/assembly.py:61",
                   lambda: kfem.frame_factors_rhs(*args32, tiles),
                   lambda: kfem.plain_frame_factors_rhs(*args32), TOL_F32,
                   inputs=args32, ops=(pot.shape[0] - 1) * (75 * n_tri + 6 * n_vert),
                   launches_key="frame_factors_rhs<float>")


def check_matvec(checks: KernelChecks, mesh, op, x, f=None, tol=TOL_F32,
                 suffix: str = "") -> None:
    """K1 on operator `op` (one problem's shapes): the matvec A x, or the
    residual f - A x where `f` is given, against its plain version."""
    from manifold_flow_tpu_torch.kernels import fem as kfem

    ctype = "float" if x.dtype == torch.float32 else "double"
    t, n_dof = x.shape
    mv = (x, op.dof, op.blocks2, op.g, op.w_scale, op.lambda_, op.gather_base)
    tiles = op.tiles
    print(f"[kernels] fem_matvec<{ctype}>{suffix}: {tiles.cell_ptr.numel() - 1} tiles "
          f"of {tiles.size} vertices list {tiles.cells.numel()} cells "
          f"({tiles.cells.numel() / mesh.n_triangles:.3f} x {mesh.n_triangles}, at "
          f"most {tiles.max_cells} a tile)", flush=True)
    key = f"fem_matvec<{ctype}>"
    if f is None:
        checks.compare(key + suffix, FEM_CU, "manifold_flow_tpu/fem/operator.py:69",
                       lambda: (kfem.fem_matvec(*mv, op.tiles),),
                       lambda: (kfem.plain_fem_matvec(*mv),), tol,
                       inputs=mv, ops=t * 106 * mesh.n_triangles, launches_key=key)
    else:  # scaled by max|f| + max|Ax|
        scale = float(f.abs().max()) + float(kfem.plain_fem_matvec(*mv).abs().max())
        checks.compare(key + suffix, FEM_CU, "manifold_flow_tpu/fem/df_operator.py:66",
                       lambda: (kfem.fem_matvec(*mv, op.tiles, f=f),),
                       lambda: (kfem.plain_fem_matvec(*mv, f=f),), tol,
                       scales=[scale], inputs=(*mv, f),
                       ops=t * (106 * mesh.n_triangles + n_dof), launches_key=key)


def check_update(checks: KernelChecks, p, ap, dinv, rz, rand, tol=TOL_F32,
                 suffix: str = "", precise: bool = False) -> None:
    """K3's update on one iteration's worth of state (random x, r from
    `rand`; pAp = <p, Ap>) against its plain version; timed in place.
    `precise`: the float32 instance with float64 sums, `<float,double>`."""
    from manifold_flow_tpu_torch.kernels import fem as kfem

    ctype = "float,double" if precise else "float" if p.dtype == torch.float32 else "double"
    t, n_dof = p.shape
    state = [rand(t, n_dof, dtype=p.dtype) for _ in range(2)]  # x, r
    pap = kfem.plain_pcg_dot(p, ap)

    def update(fn):
        x, r = (s.clone() for s in state)
        z = torch.empty_like(x)
        rz_new, rr = torch.empty_like(rz), torch.empty_like(rz)
        fn(x, r, z, p, ap, dinv, rz, pap, rz_new, rr, precise)
        return x, r, z, rz_new, rr
    bufs = [[s.clone() for s in state] + [torch.empty_like(p)]
            + [torch.empty_like(rz) for _ in range(2)] for _ in range(2)]

    def update_in_place(fn, b):
        return lambda: fn(b[0], b[1], b[2], p, ap, dinv, rz, pap, b[3], b[4], precise)
    key = f"pcg_update<{ctype}>"
    checks.compare(key + suffix, PCG_CU, "manifold_flow_tpu/solve/cg.py:89",
                   lambda: update(kfem.pcg_update),
                   lambda: update(kfem.plain_pcg_update), tol,
                   timed=(update_in_place(kfem.pcg_update, bufs[0]),
                          update_in_place(kfem.plain_pcg_update, bufs[1])),
                   inputs=(*state, p, ap, dinv, rz, pap), ops=11 * t * n_dof,
                   launches_key=key)
    got = update(kfem.pcg_update)
    if not all(torch.equal(a, b) for a, b in zip(got, update(kfem.pcg_update))):
        raise AssertionError(f"{key}{suffix}: two calls on the same inputs differ")


def check_analysis_kernels(checks: KernelChecks, mesh, v_k, suffix: str = "",
                           dtypes=(torch.float64, torch.float32)) -> None:
    """K5-K7 against their plain versions on a real velocity field
    (the refined solve's v_k), in `dtypes`; `suffix` tags the rows of a
    second size."""
    from manifold_flow_tpu_torch.kernels import analysis as kan
    from manifold_flow_tpu_torch.ops.singularity import capacity_for

    cu = "manifold_flow_tpu_torch/csrc/analysis_kernels.cu"
    for dtype in dtypes:
        ctype, tol = (("double", TOL_F64) if dtype == torch.float64
                      else ("float", TOL_F32))
        vk, basis = v_k.to(dtype), mesh.basis.to(dtype)
        points = mesh.points.to(dtype)
        t, n_vert, n_tri = vk.shape[0], mesh.n_vertices, mesh.n_triangles
        checks.compare(f"recombine_speed<{ctype}>{suffix}", cu,
                       "manifold_flow_tpu/ops/recombine.py:20",
                       lambda: kan.recombine_speed(vk, basis),
                       lambda: kan.plain_recombine_speed(vk, basis), tol,
                       inputs=(vk, basis), ops=15 * t * n_vert,
                       launches_key=f"recombine_speed<{ctype}>")
        v_world, speed, v_max = kan.plain_recombine_speed(vk, basis)
        det = (points, mesh.triangles, v_world, speed, v_max, 1e-4)
        checks.compare(f"detect_singular<{ctype}>{suffix}", cu,
                       "manifold_flow_tpu/ops/singularity.py:54",
                       lambda: kan.detect_singular(*det),
                       lambda: kan.plain_detect_singular(*det), tol,
                       inputs=det, ops=t * (10 * n_vert + 60 * n_tri),
                       launches_key=f"detect_singular<{ctype}>")
        if dtype == torch.float64:
            # Beside K6's bound: the separately rounded f64 floor of its
            # correctly rounded quotients (14 a frame and triangle, one a
            # frame and vertex, a square root and 3 divisions a triangle's
            # normal), each at the 5 operations of a quotient through a
            # reciprocal its divisor shares (a product and 4 fused
            # multiply-adds), over the rate of separate f64 operations.
            quotients = t * (14 * n_tri + n_vert) + 4 * n_tri
            floor_us = quotients * 5 / (PEAK_OPS_S["double"] / 2) * 1e6
            print(f"[kernels] detect_singular<{ctype}>{suffix}: {quotients} correctly "
                  f"rounded quotients, their separately rounded f64 floor {floor_us:.2f} us "
                  f"(5 operations each at {PEAK_OPS_S['double'] / 2e12:.0f} T/s), beside "
                  f"the bound above", flush=True)
        vmask, imask, _, ipoint, counts = kan.plain_detect_singular(*det)
        cap = capacity_for(*counts.amax(dim=0).tolist())
        print(f"[kernels] {ctype}{suffix}: per-frame candidates max (vertex, interior)"
              f" {counts.amax(dim=0).tolist()}, capacity {cap}", flush=True)
        comp = (vmask, imask, ipoint, points, cap)
        # Bytes: the masks, the selected interior points, the vertices the
        # snap compares them with, the outputs; ops: the snap's distances.
        out = kan.plain_compact_detected(*comp)
        moved = (tensor_bytes(vmask, imask, points, *out)
                 + t * cap * 3 * points.element_size())
        checks.compare(f"compact_detected<{ctype}>{suffix}", cu,
                       "manifold_flow_tpu/ops/singularity.py:394",
                       lambda: kan.compact_detected(*comp),
                       lambda: kan.plain_compact_detected(*comp), tol,
                       nbytes=moved, ops=8 * t * cap * n_vert,
                       launches_key=f"compact_detected<{ctype}>")


def check_assemble(checks: KernelChecks, mesh, tables, op, tol: float,
                   suffix: str = "") -> None:
    """K8 against its plain version on the operator `op` (its dtype). A
    `suffix` row (another size) counts no launches."""
    from manifold_flow_tpu_torch.kernels import coarse as kco
    from manifold_flow_tpu_torch.solve import coarse

    dtype = op.g.dtype
    ctype = "double" if dtype == torch.float64 else "float"
    key = f"coarse_assemble<{ctype}>{suffix}"
    r_blk = coarse.prolongation_blocks(mesh, tables, dtype)
    asm = (op.g, op.blocks2, r_blk, mesh.triangles, mesh.areas.to(dtype) / 12.0,
           op.lambda_, tables.asm_ptr, tables.asm_src, tables.asm_dst, tables.n_coarse)
    checks.compare(key, "manifold_flow_tpu_torch/csrc/coarse_kernels.cu",
                   "manifold_flow_tpu/kernels/reduce.py:103",
                   lambda: (kco.coarse_assemble(*asm),),
                   lambda: (kco.plain_coarse_assemble(*asm),), tol,
                   inputs=asm, ops=16 * op.g.shape[0] * tables.asm_src.shape[0])


def check_coarse_kernels(checks: KernelChecks, mesh, pot, times) -> None:
    """K8-K11 against their plain versions at the 12.5k shapes, in
    float32 (the refined solve's inner preconditioner) and float64 (cg)."""
    from manifold_flow_tpu_torch.fem import assembly
    from manifold_flow_tpu_torch.fem.operator import make_operator
    from manifold_flow_tpu_torch.kernels import coarse as kco
    from manifold_flow_tpu_torch.kernels import fem as kfem
    from manifold_flow_tpu_torch.solve import coarse
    from manifold_flow_tpu_torch.solve.api import build_rhs

    cu = "manifold_flow_tpu_torch/csrc/coarse_kernels.cu"
    tables = coarse.build_tables(mesh)
    check_rhs(checks, mesh, pot, times, suffix="@12.5k")
    g64, f64 = build_rhs(mesh, pot, times)
    op64 = make_operator(mesh, g64, 0.01)
    t, n_dof = g64.shape[0], mesh.n_dof
    print(f"[kernels] coarse space at {mesh.n_vertices} vertices: "
          f"{tables.n_coarse} aggregates of up to {tables.members.shape[1]} "
          f"members, {tables.asm_dst.shape[0]} non-zero coarse entries, "
          f"{tables.asm_src.shape[0]} triangle-local contributions", flush=True)
    gen = torch.Generator().manual_seed(1)
    for dtype, ctype, tol in ((torch.float32, "float", TOL_F32),
                              (torch.float64, "double", TOL_F64)):
        op = op64.astype(dtype)
        check_assemble(checks, mesh, tables, op, tol)
        if dtype == torch.float32:  # the refined solve's Jacobi blocks
            jb = (op.g, assembly.corner_regularization(mesh, dtype).contiguous(),
                  mesh.areas.to(dtype), op.lambda_, op.gather_base)
            checks.compare("jacobi_blocks<float>@12.5k", FEM_CU,
                           "manifold_flow_tpu/fem/assembly.py:164",
                           lambda: (kfem.jacobi_blocks(*jb),),
                           lambda: (kfem.plain_jacobi_blocks(*jb),), tol, inputs=jb,
                           ops=t * (48 * mesh.n_triangles + 10 * mesh.n_vertices),
                           launches_key="jacobi_blocks<float>")
        pre = coarse.make_two_level(mesh, op.g, op.lambda_, tables)
        r, z = (torch.randn((t, n_dof), generator=gen, dtype=torch.float64)
                .to(pot.device, dtype) for _ in range(2))
        rc = kco.plain_coarse_restrict(r, pre.r_blk, pre.members)
        checks.compare(f"coarse_restrict<{ctype}>", cu,
                       "manifold_flow_tpu/solve/coarse.py:243",
                       lambda: (kco.coarse_restrict(r, pre.r_blk, pre.members),),
                       lambda: (kco.plain_coarse_restrict(r, pre.r_blk, pre.members),),
                       tol, inputs=(r, pre.r_blk, pre.members), ops=8 * t * mesh.n_vertices)
        checks.compare(f"coarse_gemv<{ctype}>", cu,
                       "manifold_flow_tpu/solve/coarse.py:267",
                       lambda: (kco.coarse_gemv(pre.ac_inv, rc),),
                       lambda: (kco.plain_coarse_gemv(pre.ac_inv, rc),), tol,
                       inputs=(pre.ac_inv, rc), mm_ops=2 * pre.ac_inv.numel())
        # One matrix shared by every frame (coarse_a1='mean'), from L2.
        shared = pre.ac_inv[:1].contiguous()
        checks.compare(f"coarse_gemv<{ctype}>+shared", cu,
                       "manifold_flow_tpu/solve/coarse.py:267",
                       lambda: (kco.coarse_gemv(shared, rc),),
                       lambda: (kco.plain_coarse_gemv(shared, rc),), tol,
                       inputs=(shared, rc), mm_ops=2 * t * shared.numel())
        # A row length of 2 mod 4: every other row of the matrix starts
        # 8 bytes past a 16-byte boundary (random entries).
        a394 = torch.randn((t, 394, 394), generator=gen, dtype=torch.float64).to(pot.device, dtype)
        x394 = torch.randn((t, 394), generator=gen, dtype=torch.float64).to(pot.device, dtype)
        checks.compare(f"coarse_gemv<{ctype}>+394", cu,
                       "manifold_flow_tpu/solve/coarse.py:267",
                       lambda: (kco.coarse_gemv(a394, x394),),
                       lambda: (kco.plain_coarse_gemv(a394, x394),), tol,
                       inputs=(a394, x394), mm_ops=2 * a394.numel())
        del a394, x394
        yc = kco.plain_coarse_gemv(pre.ac_inv, rc)

        def prolong(fn):
            zs, rz = z.clone(), torch.empty(t, dtype=dtype, device=z.device)
            fn(zs, r, yc, pre.r_blk, pre.agg, rz)
            return zs, rz
        bufs = [(z.clone(), torch.empty(t, dtype=dtype, device=z.device))
                for _ in range(2)]
        checks.compare(f"coarse_prolong_dot<{ctype}>", cu,
                       "manifold_flow_tpu/solve/coarse.py:272",
                       lambda: prolong(kco.coarse_prolong_dot),
                       lambda: prolong(kco.plain_coarse_prolong_dot), tol,
                       timed=(lambda: kco.coarse_prolong_dot(
                                  bufs[0][0], r, yc, pre.r_blk, pre.agg, bufs[0][1]),
                              lambda: kco.plain_coarse_prolong_dot(
                                  bufs[1][0], r, yc, pre.r_blk, pre.agg, bufs[1][1])),
                       inputs=(z, r, yc, pre.r_blk, pre.agg),
                       ops=t * (8 * mesh.n_vertices + 2 * n_dof))
        if not all(torch.equal(a, b) for a, b in zip(prolong(kco.coarse_prolong_dot),
                                                     prolong(kco.coarse_prolong_dot))):
            raise AssertionError(f"coarse_prolong_dot<{ctype}>: two calls on the same "
                                 f"inputs differ")
        if not torch.equal(kco.coarse_restrict(r, pre.r_blk, pre.members),
                           kco.coarse_restrict(r, pre.r_blk, pre.members)):
            raise AssertionError(f"coarse_restrict<{ctype}>: two calls on the same "
                                 f"inputs differ")

        # K3's p.Ap at the 12.5k shapes (97 x 25088), on the operator's Ap.
        ap = kfem.plain_fem_matvec(z, op.dof, op.blocks2, op.g, op.w_scale, op.lambda_,
                                   op.gather_base)
        checks.compare(f"pcg_dot<{ctype}>@12.5k",
                       "manifold_flow_tpu_torch/csrc/pcg_kernels.cu",
                       "manifold_flow_tpu/solve/cg.py:30",
                       lambda: (kfem.pcg_dot(z, ap),), lambda: (kfem.plain_pcg_dot(z, ap),),
                       tol, inputs=(z, ap), ops=2 * t * n_dof,
                       launches_key=f"pcg_dot<{ctype}>")
        # K3's direction p = z + (rz_new / rz) p at the 12.5k shapes, in place.
        rz_new, rz_old = (torch.rand(t, generator=gen, dtype=torch.float64).to(
            pot.device, dtype) + 0.5 for _ in range(2))

        def direction(fn):
            q = ap.clone()
            fn(q, z, rz_new, rz_old)
            return (q,)
        qs = [ap.clone(), ap.clone()]
        checks.compare(f"pcg_direction<{ctype}>@12.5k", PCG_CU,
                       "manifold_flow_tpu/solve/cg.py:101",
                       lambda: direction(kfem.pcg_direction),
                       lambda: direction(kfem.plain_pcg_direction), tol,
                       timed=(lambda: kfem.pcg_direction(qs[0], z, rz_new, rz_old),
                              lambda: kfem.plain_pcg_direction(qs[1], z, rz_new, rz_old)),
                       inputs=(ap, z, rz_new, rz_old), ops=2 * t * n_dof + 2 * t,
                       launches_key=f"pcg_direction<{ctype}>")

        # K1 (the float32 matvec, the float64 residual) and K3's update at
        # the 12.5k shapes.
        check_matvec(checks, mesh, op, r,
                     f64.to(dtype) if dtype == torch.float64 else None, tol,
                     suffix="@12.5k")
        reg = assembly.corner_regularization(mesh, dtype).contiguous()
        dinv = kfem.plain_jacobi_blocks(op.g, reg, mesh.areas.to(dtype), op.lambda_,
                                        op.gather_base)

        def rand(*shape, dtype):
            return torch.randn(*shape, generator=gen, dtype=torch.float64).to(
                pot.device, dtype)
        check_update(checks, z, ap, dinv, rand(t, dtype=dtype).abs(), rand, tol,
                     suffix="@12.5k")


FLOW_KERNELS = ("fem_matvec<float>", "fem_matvec<double>", "jacobi_blocks<float>",
                "frame_factors_rhs<double>", "pcg_dot<float>", "pcg_update<float>",
                "pcg_direction<float>", "pcg_gate<float>", "recombine_speed<double>",
                "detect_singular<double>", "compact_detected<double>")
TRIAL_KERNELS = FLOW_KERNELS + ("classify_candidates<double>", "next_hop<double>",
                                "trace_walks<int>", "pack_walks<int>",
                                "winding_profile<double>")


def check_trial_kernels(checks: KernelChecks, mesh, v_world, speed, v_max,
                        suffix: str = "") -> None:
    """K12-K15 against their plain versions on a real velocity field, in its
    dtype: K12 on the candidates K6/K7 compact, K13 on the field, K14 on
    K13's graph (MAX_STEPS, walks of at least MIN_LENGTH packed), K15 on
    the ring tables (LEVELS rings) of the detections' distinct snapped
    centers. `suffix` tags the rows of a second size."""
    from manifold_flow_tpu_torch.geometry.topology import cells_across_edges
    from manifold_flow_tpu_torch.kernels import analysis as kan
    from manifold_flow_tpu_torch.kernels import streams as kst
    from manifold_flow_tpu_torch.kernels import winding as kwi
    from manifold_flow_tpu_torch.ops import singularity as sing
    from manifold_flow_tpu_torch.ops import streamline as stream
    from manifold_flow_tpu_torch.ops import winding as wind

    dtype = v_world.dtype
    ctype = "double" if dtype == torch.float64 else "float"
    tol = TOL_F64 if dtype == torch.float64 else TOL_F32
    esz = v_world.element_size()
    t, n = v_world.shape[0], v_world.shape[1]
    width = mesh.vertex_neighbors.shape[1]
    field, counts = sing.detect_with_counts(mesh, v_world, speed=speed, v_max=v_max)
    det = sing.compact_detected(mesh, field, capacity=sing.capacity_for(*counts.tolist()))
    an_cu = "manifold_flow_tpu_torch/csrc/analysis_kernels.cu"
    st_cu = "manifold_flow_tpu_torch/csrc/stream_kernels.cu"
    wi_cu = "manifold_flow_tpu_torch/csrc/winding_kernels.cu"

    args = (mesh.points.to(dtype), mesh.basis.to(dtype), mesh.vertex_neighbors,
            mesh.triangles, cells_across_edges(mesh), v_world, v_max,
            det.vertex_ids, det.vertex_valid, det.interior_ids,
            det.interior_valid, det.interior_points)
    s_v, s_i = det.vertex_ids.shape[1], det.interior_ids.shape[1]
    out = kan.plain_classify_candidates(*args)
    # Bytes: the slots and the 1-ring velocity rows they read, the outputs.
    moved = (tensor_bytes(*args[6:], *out)
             + t * (s_v * width + s_i * 6) * 3 * esz)
    for quirks in (False, True):
        checks.compare(f"classify_candidates<{ctype}>" + ("+quirks" if quirks else "")
                       + suffix, an_cu, "manifold_flow_tpu/ops/singularity.py:279",
                       lambda: kan.classify_candidates(*args, quirks=quirks),
                       lambda: kan.plain_classify_candidates(*args, quirks=quirks),
                       tol, nbytes=moved,
                       ops=t * (40 * s_v * width + 340 * s_i),
                       # The main path runs without quirks: the quirks
                       # variant has a row of its own and no launches.
                       launches_key=None if quirks else f"classify_candidates<{ctype}>")

    nh = (stream.unit_edges(mesh, dtype), v_world, mesh.vertex_neighbors,
          *stream.hop_tables(mesh, dtype), mesh.basis.to(dtype))
    checks.compare(f"next_hop<{ctype}>{suffix}", st_cu,
                   "manifold_flow_tpu/ops/streamline.py:133",
                   lambda: (kst.next_hop(*nh),), lambda: (kst.plain_next_hop(*nh),),
                   tol, nbytes=next_hop_bytes(*nh),
                   ops=5 * t * int((mesh.vertex_neighbors != -1).sum()),
                   launches_key=f"next_hop<{ctype}>")
    if not torch.equal(kst.plain_next_hop(*nh), mesh_next_hop(mesh, v_world, False)):
        raise AssertionError(f"next_hop<{ctype}>{suffix}: the plain version on the hop "
                             "tables differs from the reference on the mesh tables")
    if dtype == torch.float64:  # K14 reads integers only: one instance
        hops = kst.next_hop(*nh)
        checks.compare(f"trace_walks<int>{suffix}", st_cu,
                       "manifold_flow_tpu/ops/streamline.py:268",
                       lambda: (kst.trace_walks(hops, MAX_STEPS),),
                       lambda: (kst.plain_trace_walks(hops, MAX_STEPS),), 0.0,
                       inputs=(hops,), launches_key="trace_walks<int>")
        lengths = kst.trace_walks(hops, MAX_STEPS).reshape(-1)
        seeds = torch.nonzero(lengths >= MIN_LENGTH)[:, 0]
        lens = lengths[seeds].contiguous()
        offsets = torch.cumsum(lens, 0, dtype=torch.int64) - lens
        total = int(lens.sum())
        bufs = [torch.empty(total, dtype=torch.int32, device=hops.device) for _ in range(2)]
        pk = (hops, seeds, lens, offsets)
        checks.compare(f"pack_walks<int>{suffix}", st_cu,
                       "manifold_flow_tpu/ops/streamline.py:733",
                       lambda: (kst.pack_walks(*pk, bufs[0]),),
                       lambda: (kst.plain_pack_walks(*pk, bufs[1]),), 0.0,
                       inputs=pk, launches_key="pack_walks<int>")
        print(f"[kernels] walks{suffix}: {lengths.numel()} seeds, "
              f"{float((lengths >= MIN_LENGTH).float().mean()):.4f} of them >= "
              f"{MIN_LENGTH} vertices, longest {int(lengths.max())}, {total} packed ids",
              flush=True)

    ok = torch.cat([det.vertex_valid.flatten(), det.interior_valid.flatten()])
    ids = torch.cat([det.vertex_ids.flatten(), det.interior_centers.flatten()])
    uniq = torch.unique(ids[ok])
    tabs = wind.ring_tables(mesh, uniq, LEVELS, dtype)
    wp = (v_world, tabs.order, tabs.bounds, tabs.e1, tabs.e2)
    members = int(tabs.bounds[:, -1].sum())
    col = torch.arange(tabs.order.shape[1], device=uniq.device)
    rows = torch.unique(tabs.order[col < tabs.bounds[:, -1:]]).numel()
    out = kwi.plain_winding_profile(*wp)
    # Bytes: the ring members' ids (not the padding of shorter centers),
    # the bounds and bases, the outputs, and v of each distinct member.
    moved = tensor_bytes(*wp[2:], *out) + members * 4 + t * rows * 3 * esz
    checks.compare(f"winding_profile<{ctype}>{suffix}", wi_cu,
                   "manifold_flow_tpu/ops/winding.py:127",
                   lambda: kwi.winding_profile(*wp), lambda: kwi.plain_winding_profile(*wp),
                   tol, nbytes=moved, ops=40 * t * members,
                   launches_key=f"winding_profile<{ctype}>")
    print(f"[kernels] winding{suffix}: {uniq.numel()} distinct centers, "
          f"{members} ring members over {LEVELS} rings, {rows} distinct vertices",
          flush=True)


def next_hop_bytes(unit, v_world, neighbors, rules, corners, basis) -> int:
    """The bytes K13's function needs on this data, each read once: v_world,
    the valid 1-ring slots' ids, hop rules and unit edges, and next written;
    and, for the slots whose rule names a row of `corners` and on which some
    frame would advance, that row and the vertex's basis."""
    from manifold_flow_tpu_torch.kernels.analysis import _dot3

    esz = v_world.element_size()
    t, n = v_world.shape[0], v_world.shape[1]
    mask = neighbors != -1
    total = tensor_bytes(v_world) + t * n * 4 + int(mask.sum()) * (4 + 4 + 3 * esz)
    if t == 0:
        return total
    dots = _dot3(unit[None], v_world[:, :, None, :])                   # (T, N, D)
    dots = torch.where(mask, dots, torch.full_like(dots, -torch.inf))
    idx = dots.argmax(dim=-1, keepdim=True)
    adv = torch.gather(dots, -1, idx)[..., 0] > 0
    rule = torch.gather(rules.expand(t, -1, -1), -1, idx)[..., 0]
    tested = adv & (rule >= 0)
    return (total + torch.unique(rule[tested]).numel() * 4 * esz
            + torch.unique(torch.nonzero(tested)[:, 1]).numel() * 6 * esz)


def mesh_next_hop(mesh, v_world, quirks: bool) -> torch.Tensor:
    """A check-only reference of K13's function that works from the raw
    mesh tables (1-ring ids, cell counts, vertex cells, triangles, points,
    basis) and not from the per-mesh hop tables that the kernel and its
    plain version share: each boundary vertex's shared-cell scan against
    its candidate, the shared triangle's corners on the tangent basis (the
    reference's index arithmetic with `quirks`) and its degenerate test are
    formed here for every frame, as ops/streamline.py:149-185 does. Each
    operation is rounded on its own in that order, so `next` is equal."""
    from manifold_flow_tpu_torch.kernels.analysis import _cross, _dot3
    from manifold_flow_tpu_torch.ops import streamline as stream

    def cross2(ax, ay, bx, by):
        return ax * by - ay * bx

    dtype = v_world.dtype
    t, n = v_world.shape[0], mesh.n_vertices
    nb = mesh.vertex_neighbors
    dots = _dot3(stream.unit_edges(mesh, dtype)[None], v_world[:, :, None, :])
    dots = torch.where(nb != -1, dots, torch.full_like(dots, -torch.inf))
    idx = dots.argmax(dim=-1, keepdim=True)
    cand = torch.gather(torch.where(nb != -1, nb, 0).long().expand(t, -1, -1), -1, idx)[..., 0]
    dmax = torch.gather(dots, -1, idx)[..., 0]
    ok = (mesh.vertex_cell_count >= 6).expand(t, n).clone()
    rows = torch.nonzero(mesh.vertex_cell_count < 6)[:, 0]
    if rows.numel():
        a = rows.expand(t, -1)                                        # (T, B)
        cells_a = mesh.vertex_cells[rows].long()[None, :, :, None]
        cells_b = mesh.vertex_cells[cand[:, rows]].long()[..., None, :]
        match = ((cells_a == cells_b) & (cells_a != -1) & (cells_b != -1)).any(dim=-1)
        count = match.sum(dim=-1)
        first = torch.gather(cells_a[..., 0].expand_as(match), -1,
                             match.to(torch.uint8).argmax(dim=-1, keepdim=True))[..., 0]
        t0, t1, t2 = mesh.triangles[first].long().unbind(-1)
        b = torch.where(t0 == a, t1, torch.where(t1 == a, t0, t1))
        c = torch.where(t2 == a, t0, t2)
        basis = mesh.basis.to(dtype)
        e1, e2 = basis[rows, 0][None], basis[rows, 1][None]
        nrm = _cross(e1, e2)
        nn = _dot3(nrm, nrm)
        pts = mesh.points.to(dtype)

        def on_basis(rel):
            if quirks:  # vertex indices where coordinates belong
                proj = rel[..., None] - rel[..., None] * (nrm * nrm) / nn[..., None]
            else:
                pos = nn > 0
                sc = torch.where(pos, _dot3(rel, nrm) / torch.where(pos, nn, torch.ones_like(nn)),
                                 torch.zeros_like(nn))
                proj = rel - sc[..., None] * nrm
            return _dot3(proj, e1), _dot3(proj, e2)

        if quirks:
            p1, p2 = on_basis((b - a).to(dtype)), on_basis((a - c).to(dtype))
        else:
            p1, p2 = on_basis(pts[b] - pts[a]), on_basis(pts[c] - pts[a])
        orient = cross2(*p1, *p2)
        ccw = orient >= 0
        bx, by = torch.where(ccw, p1[0], p2[0]), torch.where(ccw, p1[1], p2[1])
        cx, cy = torch.where(ccw, p2[0], p1[0]), torch.where(ccw, p2[1], p1[1])
        vel = v_world[:, rows]
        vx, vy = _dot3(vel, e1) / _dot3(e1, e1), _dot3(vel, e2) / _dot3(e2, e2)
        inside = ((cross2(bx, by, vx, vy) > 0)
                  & (cross2(cx - bx, cy - by, vx - bx, vy - by) > 0)
                  & (cross2(-cx, -cy, vx - cx, vy - cy) > 0) & (orient != 0))
        ok[:, rows] = (count >= 2) | (inside & match.any(dim=-1))
    vertex = torch.arange(n, device=v_world.device)
    return torch.where((dmax > 0) & ok, cand, vertex).to(torch.int32)


N_ELECTRODES = 64     # bench.py:203's field stages: 64 electrodes, 512 Hz
SFREQ = 512.0
# 2.4 s at 512 Hz: the default window [2.009, 2.2) s keeps samples 1028-1125,
# 98 frames, after the Hilbert transform.
FIELD_SAMPLES = 1229


def electrode_ids(n_vertices: int) -> np.ndarray:
    """bench.py:216-217's electrodes: 64 vertices drawn by default_rng(0)."""
    return np.random.default_rng(0).choice(n_vertices, N_ELECTRODES, replace=False)


def speed_measure(mag):
    """K16's comparison for wave speeds: inf and NaN at the same places;
    elsewhere, where |grad| (mag, the plain version's) is above 1e-8 of its
    largest value, the relative error scaled by |grad| / max|grad|, since
    the quotient amplifies the gradient's rounding by the inverse."""
    top = float(mag.max())

    def measure(got, want):
        (a,), (b,) = got, want
        same = (torch.equal(torch.isfinite(a), torch.isfinite(b))
                and torch.equal(torch.isnan(a), torch.isnan(b)))
        ok = torch.isfinite(b) & (mag > 1e-8 * top) & (b != 0)
        if not bool(ok.any()):
            return float("inf"), float("inf"), False
        diff = (a - b).abs()[ok]
        rel = float((diff / b.abs()[ok] * mag[ok] / top).max())
        return float(diff.max()), rel, same
    return measure


def phase_measure(b, w, w_im):
    """K17's comparison for phases: the interpolant z = (b w, b w_im) of the
    plain version against |z| e^(i angle) of the kernel's angle, relative to
    max (|b| |w| + |b| |w_im|), the sums' rounding scale."""
    z = torch.complex((b @ w).T, (b @ w_im).T)
    scale = float(((b.abs() @ w.abs()) + (b.abs() @ w_im.abs())).max())

    def measure(got, want):
        (a,), _ = got, want
        err = float((z.abs() * torch.exp(1j * a) - z).abs().max())
        return err, err / scale, bool(torch.isfinite(a).all())
    return measure


def check_field_kernels(checks: KernelChecks, mesh, pot, suffix: str = "") -> None:
    """K16 and K17 against their plain versions at the field stages' shapes
    (bench.py:203-232), in float64 and float32: K16 on the movie (amplitude)
    and its wrapped phase, 98 frames; K17 with the 64 electrodes of
    `electrode_ids`, their system matrix and the evaluation at every vertex
    of weights solved from the electrodes' samples of the movie (real) and
    of its phase (complex, the angle taken by the kernel)."""
    from manifold_flow_tpu_torch.kernels import fields as kf
    from manifold_flow_tpu_torch.ops.interpolate import scipy_default_epsilon

    cu = "manifold_flow_tpu_torch/csrc/field_kernels.cu"
    sel = torch.as_tensor(electrode_ids(mesh.n_vertices), device=pot.device)
    for dtype, ctype, tol in ((torch.float64, "double", TOL_F64),
                              (torch.float32, "float", TOL_F32)):
        amp = pot.to(dtype).contiguous()
        phase = torch.atan2(torch.sin(amp), torch.cos(amp))
        t, n, m = amp.shape[0], mesh.n_vertices, mesh.n_triangles
        tables = (mesh.triangles, mesh.grad_w.to(dtype).contiguous(), mesh.areas.to(dtype),
                  mesh.vertex_cells, mesh.basis.to(dtype).contiguous())
        ops = t * (18 * m + 4 * 3 * m + 60 * n)
        for output, movie, tag in (("phase_mm_per_ms", phase, ""),
                                   ("amplitude", amp, "+amplitude")):
            mag = kf.plain_wave_speed(movie, *tables, 1.0 / SFREQ, "magnitude")
            args = (movie, *tables, 1.0 / SFREQ, output)
            checks.compare(f"wave_speed<{ctype}>{tag}{suffix}", cu,
                           "manifold_flow_tpu/ops/wavespeed.py:72" if not tag
                           else "manifold_flow_tpu/ops/wavespeed.py:64",
                           lambda: (kf.wave_speed(*args),),
                           lambda: (kf.plain_wave_speed(*args),), tol,
                           inputs=(movie, *tables), ops=ops, measure=speed_measure(mag),
                           launches_key=f"wave_speed<{ctype}>{tag or '+phase'}")

        x = mesh.points.to(dtype).contiguous()
        c = x[sel].contiguous()
        eps = scipy_default_epsilon(c).reshape(1)
        e = c.shape[0]
        real = (amp[:, sel].contiguous(),)
        unit = (torch.cos(phase[:, sel]).contiguous(), torch.sin(phase[:, sel]).contiguous())
        for planes, tag in ((real, ""), (unit, "+phase")):
            check_fit(checks, cu, x, c, eps, planes, tag, suffix)
        (w,), _ = kf.plain_rbf_fit(c, eps, real, "multiquadric")
        (wr, wi), _ = kf.plain_rbf_fit(c, eps, unit, "multiquadric")
        b = kf.rbf_phi(kf.pairwise_dist(x, c), eps, "multiquadric")
        checks.compare(f"rbf_eval<{ctype}>{suffix}", cu,
                       "manifold_flow_tpu/ops/interpolate.py:133",
                       lambda: (kf.rbf_eval(x, c, eps, w, "multiquadric"),),
                       lambda: (kf.plain_rbf_eval(x, c, eps, w, "multiquadric"),), tol,
                       scales=[float((b.abs() @ w.abs()).max())],
                       inputs=(x, c, eps, w), ops=14 * n * e, mm_ops=2 * n * e * t,
                       launches_key=f"rbf_eval<{ctype}>+real")
        checks.compare(f"rbf_eval<{ctype}>+phase{suffix}", cu,
                       "manifold_flow_tpu/ops/interpolate.py:71",
                       lambda: (kf.rbf_eval(x, c, eps, wr, "multiquadric", wi),),
                       lambda: (kf.plain_rbf_eval(x, c, eps, wr, "multiquadric", wi),), tol,
                       inputs=(x, c, eps, wr, wi), ops=14 * n * e + 20 * n * t,
                       mm_ops=4 * n * e * t, measure=phase_measure(b, wr, wi),
                       launches_key=f"rbf_eval<{ctype}>+phase")


# K17 rbf_fit's gate: the relative backward error max|A W - B| / max(|A| |W|)
# of its weights (LU with partial pivoting is backward stable; the weights
# themselves differ from the library's by up to cond(A) times the rounding).
TOL_FIT = {"double": 1e-13, "float": 1e-5}


def fit_measure(x, c, eps, planes, ctype: str, label: str, kind: str = "multiquadric"):
    """K17 rbf_fit's comparison with plain_rbf_fit on the same tensors: its
    backward error (the reported relative error, within TOL_FIT), the
    interpolant of its weights at every vertex x against the plain
    weights', relative to max sum_e |phi| |w| (within the rbf_eval
    tolerance), and an equal info word; prints cond(A), max|dW| / max|W|
    and the pivot rows that differ from lu_factor's."""
    from manifold_flow_tpu_torch.kernels import fields as kf

    tol = TOL_F64 if ctype == "double" else TOL_F32
    a = kf.plain_rbf_basis(c, eps, kind)
    b = kf.rbf_phi(kf.pairwise_dist(x, c), eps, kind)

    def backward(w):
        res = max(float((a @ wi - p.T).abs().max()) for wi, p in zip(w, planes))
        return res / max(float((a.abs() @ wi.abs()).max()) for wi in w)

    def measure(got, want):
        (w, info), (wp, info_p) = got, want
        piv, piv_p = (torch.empty(c.shape[0], dtype=torch.int32, device=c.device)
                      for _ in range(2))
        kf.rbf_fit(c, eps, planes, kind, pivots=piv)
        kf.plain_rbf_fit(c, eps, planes, kind, pivots=piv_p)
        bw, bw_plain = backward(w), backward(wp)
        scale = max(float((b.abs() @ wi.abs()).max()) for wi in wp)
        interp = max(float((b @ wi - b @ wj).abs().max()) for wi, wj in zip(w, wp)) / scale
        dw = float((w - wp).abs().max())
        same_info = int(info[0]) == int(info_p[0])
        finite = bool(torch.isfinite(w).all())
        print(f"[kernels] {label}: backward error {bw:.3e} (plain {bw_plain:.3e}; gate "
              f"{TOL_FIT[ctype]:.0e}), interpolant at {x.shape[0]} vertices {interp:.3e} of "
              f"max sum|phi||w| (gate {tol:.0e}), info {int(info[0])} / {int(info_p[0])}, "
              f"cond(A) {float(torch.linalg.cond(a)):.3e}, max|dW|/max|W| "
              f"{dw / float(wp.abs().max()):.3e}, pivot rows differing from lu_factor's "
              f"{int((piv != piv_p).sum())} of {c.shape[0]}; chain {c.shape[0]} pivot steps "
              f"(the forward substitution in them) + {c.shape[0]} back-substitution steps",
              flush=True)
        return dw, bw, bw <= TOL_FIT[ctype] and interp <= tol and same_info and finite
    return measure


def check_fit(checks: KernelChecks, cu: str, x, c, eps, planes, tag: str,
              suffix: str) -> None:
    """K17 rbf_fit (one plane, or the two of the phases) against
    plain_rbf_fit. Its bound: 2/3 E^3 + 2 E^2 R operations (R = planes T)
    or the bytes of c, the planes and W."""
    from manifold_flow_tpu_torch.kernels import fields as kf

    ctype = "double" if c.dtype == torch.float64 else "float"
    e, r = c.shape[0], len(planes) * planes[0].shape[0]
    key = f"rbf_fit<{ctype}>{tag}{suffix}"
    checks.compare(key, cu, "manifold_flow_tpu/ops/interpolate.py:90",
                   lambda: kf.rbf_fit(c, eps, planes, "multiquadric"),
                   lambda: kf.plain_rbf_fit(c, eps, planes, "multiquadric"),
                   TOL_FIT[ctype], ops=2.0 / 3.0 * e ** 3 + 2.0 * e * e * r,
                   nbytes=tensor_bytes(c, *planes) + e * r * c.element_size(),
                   measure=fit_measure(x, c, eps, planes, ctype, key),
                   launches_key=f"rbf_fit<{ctype}>{tag or '+real'}")


def hold_to_plain(mesh, v_world, speed, v_max, cfg) -> dict:
    """The trial's analysis ops on the card against their plain versions on
    the same CUDA tensors, with cfg's quirks and limits: class codes, next
    hops, walk lengths, packed walks, ring counts and types must be equal.
    Returns a summary of the walks and classes."""
    from manifold_flow_tpu_torch.geometry.topology import cells_across_edges
    from manifold_flow_tpu_torch.kernels import analysis as kan
    from manifold_flow_tpu_torch.kernels import streams as kst
    from manifold_flow_tpu_torch.kernels import winding as kwi
    from manifold_flow_tpu_torch.ops import singularity as sing
    from manifold_flow_tpu_torch.ops import streamline as stream
    from manifold_flow_tpu_torch.ops import winding as wind

    q = cfg.reference_quirks
    an = cfg.analysis
    dtype = v_world.dtype
    field, counts = sing.detect_with_counts(mesh, v_world, eps=cfg.solver.eps,
                                            speed=speed, v_max=v_max)
    det = sing.compact_detected(mesh, field, capacity=sing.capacity_for(*counts.tolist()))
    classes = sing.classify_compacted(mesh, v_world, v_max, det, quirks=q)
    plain = kan.plain_classify_candidates(
        mesh.points.to(dtype), mesh.basis.to(dtype), mesh.vertex_neighbors,
        mesh.triangles, cells_across_edges(mesh), v_world, v_max, det.vertex_ids,
        det.vertex_valid, det.interior_ids, det.interior_valid, det.interior_points,
        quirks=q)
    sl = stream.trace_frames(mesh, v_world, an.max_streamline_steps, q, rows=False)
    nh = (stream.unit_edges(mesh, dtype), v_world, mesh.vertex_neighbors,
          *stream.hop_tables(mesh, dtype, q), mesh.basis.to(dtype))
    plain_hops = kst.plain_next_hop(*nh)
    plain_len = kst.plain_trace_walks(plain_hops, an.max_streamline_steps)
    kept, lens, flat = stream._packed_walks(sl, an.min_streamline_length)
    seeds = torch.as_tensor(kept, device=v_world.device)
    lens_t = torch.as_tensor(lens, device=v_world.device)
    plain_flat = kst.plain_pack_walks(
        plain_hops, seeds, lens_t, torch.cumsum(lens_t, 0, dtype=torch.int64) - lens_t,
        torch.empty(int(lens.sum()), dtype=torch.int32, device=v_world.device))
    ok = torch.cat([det.vertex_valid.flatten(), det.interior_valid.flatten()])
    ids = torch.cat([det.vertex_ids.flatten(), det.interior_centers.flatten()])
    uniq = torch.unique(ids[ok])
    tabs = wind.ring_tables(mesh, uniq, an.max_winding_level, dtype)
    wp = (v_world, tabs.order, tabs.bounds, tabs.e1, tabs.e2)
    got_w, want_w = kwi.winding_profile(*wp), kwi.plain_winding_profile(*wp)
    same = {
        "vertex codes": torch.equal(classes.vertex_codes, plain[0]),
        "interior codes": torch.equal(classes.interior_codes, plain[2]),
        "next hops": torch.equal(sl.hops, plain_hops),
        "next hops, mesh tables": torch.equal(plain_hops, mesh_next_hop(mesh, v_world, q)),
        "walk lengths": torch.equal(sl.lengths, plain_len),
        "packed walks": np.array_equal(flat, plain_flat.cpu().numpy()),
        "ring counts": torch.equal(got_w[0], want_w[0]),
        "ring types": torch.equal(got_w[1], want_w[1]),
    }
    if not all(same.values()):
        raise AssertionError(f"trial ops (quirks={q}) differ from their plain "
                             f"versions on the card: {same}")
    names = np.asarray(sing.CLASS_NAMES)
    codes = torch.cat([classes.vertex_codes[classes.vertex_valid],
                       classes.interior_codes[classes.interior_valid]]).cpu().numpy()
    return {"labels": {str(k): int(v) for k, v in
                       zip(*np.unique(names[codes], return_counts=True))},
            "kept": float(len(kept)) / sl.lengths.numel(),
            "longest": int(sl.lengths.max()), "centers": int(uniq.numel())}


def run_trial(mesh, pot, tag: str = "trial", workdir: Path | None = None) -> dict:
    """One trial's analysis path through the port's command line: `flow
    --classify`, then `streamline` and `winding` on its artifacts (default
    config), every launch count set to 0 just before. Checks that every
    frame converged, each kernel of TRIAL_KERNELS launched, the artifacts
    reload equal to the same stages run in memory, and that walks, classes
    and ring counts equal the plain versions' on the same CUDA tensors, then
    once more with reference_quirks=True; returns the launch counts. With
    `workdir` its inputs (surface.ply, movie.npy) and artifacts (out/) stay
    there for the batch phases."""
    from manifold_flow_tpu_torch.kernels import LAUNCHES, reset_launches
    from manifold_flow_tpu_torch.pipeline import cli, stages
    from manifold_flow_tpu_torch.pipeline.config import PipelineConfig
    from manifold_flow_tpu_torch.utils import io as mio

    def call(argv):
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            rc = cli.main(argv)
        report = json.loads(stdout.getvalue().strip().splitlines()[-1])
        if rc != 0 or report["device"] != str(mesh.device.type):
            raise AssertionError(f"{argv[0]} CLI: rc {rc}, report {report}")
        return report

    with scratch_dir("chip_smoke_trial_", workdir) as tmp:
        tmp = Path(tmp)
        mio.write_ply(tmp / "surface.ply", mesh.points.cpu().numpy(),
                      mesh.triangles.cpu().numpy())
        np.save(tmp / "movie.npy", pot.cpu().numpy())
        out = tmp / "out"
        surface = ["--surface", str(tmp / "surface.ply")]
        field = surface + ["--e", str(out / "e.csv"), "--v-k", str(out / "V_k.csv"),
                           "--out-dir", str(out)]
        with warnings.catch_warnings():
            warnings.simplefilter("error", stages.ConvergenceWarning)
            torch.cuda.synchronize()
            reset_launches()
            flow = call(["flow", *surface, "--potentials", str(tmp / "movie.npy"),
                         "--sfreq", "512", "--classify", "--out-dir", str(out)])
            call(["streamline", *field])
            call(["winding", *field, "--singularities", str(out / "singularity_points.pkl")])
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
        if not flow["converged"]:
            raise AssertionError(f"{tag}: flow did not converge: {flow}")
        idle = [k for k in TRIAL_KERNELS if launches[k] == 0]
        if idle:
            raise AssertionError(f"kernels of the {tag} path never launched: {idle}")

        # The same stages in memory, and their artifacts.
        cfg = PipelineConfig()
        fmesh = stages.load_surface(tmp / "surface.ply", device=mesh.device)
        movie = np.load(tmp / "movie.npy")
        vel = stages.velocity_stage(fmesh, movie, np.arange(movie.shape[0]) / 512.0, cfg)
        pts, labels, centers = stages.singularity_stage(
            fmesh, vel.v_world, cfg, classify=True, return_centers=True,
            speed=vel.speed, v_max=vel.v_max)
        lines = stages.streamline_stage(fmesh, vel.v_world, cfg)
        wl = stages.winding_stage(fmesh, vel.v_world, pts, cfg)
        wl_trial = stages.winding_stage(fmesh, vel.v_world, pts, cfg, centers=centers)
        t_v = movie.shape[0] - 1
        saved_lines = {}
        for k in range(t_v):
            saved_lines.update(mio.load_pickle(
                out / f"t_velocityfields_streamlines_{k}.pkl.bz2"))
        saved_w = mio.load_pickle(out / "winding_lines.pkl.bz2")

        def rows(w):
            return {k: [(r[1], r[2]) for r in v] for k, v in w.items()}
        same = {
            "classification": mio.load_pickle(
                out / "singularity_points_classification.pkl") == labels,
            "streamlines": list(saved_lines) == list(lines) and all(
                len(saved_lines[k]) == len(v) and all(
                    np.array_equal(a, b) for a, b in zip(saved_lines[k], v))
                for k, v in lines.items()),
            "winding_lines": rows(saved_w) == rows(wl) and all(
                np.array_equal(a[0], b[0]) for k in wl for a, b in zip(saved_w[k], wl[k])),
        }
        if not all(same.values()) or not vel.converged:
            raise AssertionError(f"{tag} artifacts differ from the in-memory run: {same}")
    # The CLI re-snaps the points on the host; the trial's stages take the
    # detection stage's centers: the rows that differ between the two.
    snap_diff = sum(a != b for k in wl for a, b in zip(rows(wl)[k], rows(wl_trial)[k]))

    summary = hold_to_plain(fmesh, vel.v_world, vel.speed, vel.v_max, cfg)
    qcfg = PipelineConfig()
    qcfg.reference_quirks = True
    quirks = hold_to_plain(fmesh, vel.v_world, vel.speed, vel.v_max, qcfg)
    qpts, qlabels = stages.singularity_stage(fmesh, vel.v_world, qcfg, classify=True,
                                             speed=vel.speed, v_max=vel.v_max)
    qlines = stages.streamline_stage(fmesh, vel.v_world, qcfg)
    qwl = stages.winding_stage(fmesh, vel.v_world, qpts, qcfg)

    per_frame = np.array([len(v) for v in lines.values()])
    print(f"[{tag}] {fmesh.n_vertices} vertices x {movie.shape[0]} frames: flow "
          f"--classify, streamline, winding through the CLI; all {t_v} frames "
          f"converged, artifacts reload equal to the in-memory run; launches "
          + ", ".join(f"{k}={launches[k]}" for k in TRIAL_KERNELS), flush=True)
    print(f"[{tag}] streamlines per frame min {per_frame.min()} median "
          f"{float(np.median(per_frame))} max {per_frame.max()}; walks >= "
          f"{MIN_LENGTH}: {summary['kept']:.4f} of {t_v * fmesh.n_vertices}, longest "
          f"{summary['longest']}; labels {summary['labels']}; frames with winding "
          f"lines {len(wl)} ({sum(len(v) for v in wl.values())} rows, "
          f"{summary['centers']} distinct centers; {snap_diff} rows differ with the "
          f"detection stage's centers); walks, classes and ring counts equal the "
          f"plain versions'", flush=True)
    print(f"[{tag}] quirks on, in memory: labels {quirks['labels']}, "
          f"{sum(len(v) for v in qlines.values())} streamlines, longest walk "
          f"{quirks['longest']}, {len(qwl)} frames with winding lines, "
          f"{sum(len(x) for x in qlabels)} labelled points; equal to the plain "
          f"versions", flush=True)
    return launches


FIELD_KERNELS = ("wave_speed<double>", "rbf_fit<double>", "rbf_eval<double>")


# The variants of K16 and K17 on the field path, each counted in the one
# CLI call that launches it: (launch count key, CLI call, LAUNCHES entry).
FIELD_VARIANTS = (
    ("rbf_fit<double>+real", "interpolate", "rbf_fit<double>"),
    ("rbf_fit<double>+phase", "interpolate --phases", "rbf_fit<double>"),
    ("rbf_eval<double>+real", "interpolate", "rbf_eval<double>"),
    ("rbf_eval<double>+phase", "interpolate --phases", "rbf_eval<double>"),
    ("wave_speed<double>+phase", "wavespeed phase", "wave_speed<double>"),
    ("wave_speed<double>+amplitude", "wavespeed amplitude", "wave_speed<double>"),
)


def run_fields(mesh, v_k_csv: Path, tag: str = "fields", demo: bool = True,
               lu_free: bool = True, workdir: Path | None = None) -> dict:
    """The field stages through the port's command line, every launch count
    set to 0 just before: `interpolate` of 64 electrodes' 1229-sample movie
    (electrodes.tsv, data.npy) with and without --phases, `wavespeed
    --method phase` on the interpolated phases and `--method amplitude` on
    the interpolated movie, `decompose --mode concat` and `--mode complex` on
    the flow CLI's V_k.csv, and, with `demo`, `demo` at its defaults (its
    own 24 x 24 patch, whatever the mesh). Checks that K16 and K17 launched,
    the artifacts reload equal to the same stages run in memory, under
    torch.profiler, which with `lu_free` must show no LU library kernel
    (getrf, getrs; those found are printed), the SVD's sigma against
    numpy's LAPACK SVD on the host (1e-10 of the largest) and its rank-K
    reconstruction (1e-8 of its largest entry), and the demo's report;
    returns the launch counts, with each FIELD_VARIANTS entry's. With
    `workdir` the inputs (surface.ply, electrodes.tsv, data.npy) and
    artifacts (out/) stay there."""
    from manifold_flow_tpu_torch.geometry import synthetic
    from manifold_flow_tpu_torch.kernels import LAUNCHES, reset_launches
    from manifold_flow_tpu_torch.pipeline import cli, stages
    from manifold_flow_tpu_torch.pipeline.config import PipelineConfig
    from manifold_flow_tpu_torch.utils import io as mio

    sel = electrode_ids(mesh.n_vertices)
    pot, _, _ = synthetic.two_source_movie(
        mesh, sources=((15.0, 15.0), (45.0, 45.0)), n_frames=FIELD_SAMPLES,
        speed=24.0, wavelength=24.0, dt=1.0 / SFREQ, dtype=np.float64)
    data = pot[:, torch.as_tensor(sel, device=pot.device)].cpu().numpy()
    coords = mesh.points.cpu().numpy()[sel]
    del pot

    per_call = {}

    def call(name, argv):
        stdout = io.StringIO()
        before = dict(LAUNCHES)
        with contextlib.redirect_stdout(stdout):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        per_call[name] = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        report = json.loads(stdout.getvalue().strip().splitlines()[-1])
        if rc != 0 or report["device"] != str(mesh.device.type):
            raise AssertionError(f"{argv[0]} CLI: rc {rc}, report {report}")
        return report

    with scratch_dir(f"chip_smoke_{tag}_", workdir) as tmp:
        tmp = Path(tmp)
        mio.write_ply(tmp / "surface.ply", mesh.points.cpu().numpy(),
                      mesh.triangles.cpu().numpy())
        lines = ["name\tx\ty\tz\tgroup"] + [
            f"E{i + 1:02d}\t{x!r}\t{y!r}\t{z!r}\tgrid" for i, (x, y, z) in
            enumerate(coords.tolist())]
        (tmp / "electrodes.tsv").write_text("\n".join(lines) + "\n")
        np.save(tmp / "data.npy", data)
        out = tmp / "out"
        surface = ["--surface", str(tmp / "surface.ply")]
        interp = [*surface, "--electrodes", str(tmp / "electrodes.tsv"),
                  "--data", str(tmp / "data.npy"), "--sfreq", "512"]
        amp_csv = out / "amp" / "interpolation_data.csv"
        phase_csv = out / "phase" / "interpolation_phases_data.csv"
        with warnings.catch_warnings():
            warnings.simplefilter("error", stages.ConvergenceWarning)
            torch.cuda.synchronize()
            reset_launches()
            argvs = {
                "interpolate": ["interpolate", *interp, "--out-dir", str(out / "amp")],
                "interpolate --phases": ["interpolate", *interp, "--phases",
                                         "--out-dir", str(out / "phase")],
                "wavespeed phase": ["wavespeed", *surface, "--movie", str(phase_csv),
                                    "--sfreq", "512", "--out-dir", str(out / "ws")],
                "wavespeed amplitude": ["wavespeed", *surface, "--movie", str(amp_csv),
                                        "--sfreq", "512", "--method", "amplitude",
                                        "--out-dir", str(out / "ws")],
                "decompose concat": ["decompose", "--v-k", str(v_k_csv),
                                     "--out-dir", str(out / "concat")],
                "decompose complex": ["decompose", "--v-k", str(v_k_csv), "--mode",
                                      "complex", "--out-dir", str(out / "complex")],
            }
            if demo:
                argvs["demo"] = ["demo", "--out-dir", str(out / "demo")]
            runs = {name: call(name, argv) for name, argv in argvs.items()}
            launches = dict(LAUNCHES)
        launches.update({key: per_call[name][entry] for key, name, entry in FIELD_VARIANTS})
        idle = [k for k in FIELD_KERNELS + tuple(v[0] for v in FIELD_VARIANTS)
                if launches[k] == 0]
        if idle:
            raise AssertionError(f"kernels of the {tag} path never launched: {idle}")
        fits = {name: per_call[name]["rbf_fit<double>"]
                for name in ("interpolate", "interpolate --phases")}
        if set(fits.values()) != {1}:
            raise AssertionError(f"{tag}: rbf_fit<double> must launch once a call: {fits}")

        # The same stages in memory, on the same inputs, under the profiler:
        # K17 fits the interpolants, no LU library kernel runs.
        cfg = PipelineConfig()
        fmesh = stages.load_surface(tmp / "surface.ply", device=mesh.device)
        ecoords = mio.load_grid_electrodes(tmp / "electrodes.tsv")
        amp_file, phase_file = mio.load_indexed_csv(amp_csv), mio.load_indexed_csv(phase_csv)
        v_k = mio.load_indexed_csv(v_k_csv)
        with profiled() as prof:
            amp = stages.interpolate_stage(fmesh, ecoords, data, cfg, sfreq=SFREQ)
            phase = stages.interpolate_stage(fmesh, ecoords, data, cfg, sfreq=SFREQ,
                                             phases=True)
            ws = {method: stages.wavespeed_stage(fmesh, movie, 1.0 / SFREQ, method=method)
                  for method, movie in (("phase", phase_file), ("amplitude", amp_file))}
            modes = {mode: stages.decompose_stage(torch.as_tensor(v_k, device=mesh.device),
                                                  cfg, mode=mode)
                     for mode in ("concat", "complex")}
            torch.cuda.synchronize()
        lu = [e.key for e in device_events(prof) if "getrf" in e.key or "getrs" in e.key]
        if lu and lu_free:
            raise AssertionError(f"{tag}: the field stages ran LU library kernels: {lu}")
        same = {"interpolation_data.csv": np.array_equal(amp_file, amp.cpu().numpy()),
                "interpolation_phases_data.csv": np.array_equal(phase_file,
                                                                phase.cpu().numpy())}
        for method, speeds in ws.items():
            same[f"wave_velocity_{method}.pkl.bz2"] = np.array_equal(
                mio.load_pickle(out / "ws" / f"wave_velocity_{method}.pkl.bz2"),
                speeds.cpu().numpy(), equal_nan=True)
        for mode, m in modes.items():
            with np.load(out / mode / "data_01.npz") as z:
                same[f"{mode}/data_01.npz"] = (
                    all(np.array_equal(z[k], x.cpu().numpy())
                        for k, x in (("U", m.u), ("Sigma", m.sigma), ("VT", m.vt)))
                    and int(z["point_num"]) == v_k.shape[1] // 2)
        if not all(same.values()):
            raise AssertionError(f"{tag} artifacts differ from the in-memory run: {same}")

    # The SVD against numpy's float64 LAPACK SVD on the host.
    n = v_k.shape[1] // 2
    svd_err = {}
    for mode, m in modes.items():
        movie = v_k if mode == "concat" else v_k[:, :n] + 1j * v_k[:, n:]
        u_np, s_np, vt_np = np.linalg.svd(movie, full_matrices=False)
        k = m.sigma.shape[0]
        sig = float(np.abs(m.sigma.cpu().numpy() - s_np[:k]).max()) / s_np[0]
        want = (u_np[:, :k] * s_np[:k]) @ vt_np[:k]
        got = ((m.u * m.sigma.to(m.u.dtype)) @ m.vt).cpu().numpy()
        rec = float(np.abs(got - want).max()) / float(np.abs(want).max())
        if not (sig <= 1e-10 and rec <= 1e-8):
            raise AssertionError(f"{tag} {mode} SVD against numpy: sigma {sig:.3e} "
                                 f"(gate 1e-10), rank-{k} reconstruction {rec:.3e} (gate 1e-8)")
        svd_err[mode] = (sig, rec, k)
    shown = runs["demo"] if demo else None
    if shown is not None and not (shown["converged"] and shown["matched"] > 0):
        raise AssertionError(f"demo: {shown}")
    finite = {method: float(torch.isfinite(s).float().mean()) for method, s in ws.items()}
    print(f"[{tag}] {fmesh.n_vertices} vertices, {N_ELECTRODES} electrodes x "
          f"{FIELD_SAMPLES} samples -> {tuple(amp.shape)} interpolated frames: "
          f"interpolate (+ --phases), wavespeed (phase, amplitude), decompose (concat, "
          f"complex) on V_k {tuple(v_k.shape)}{', demo' if demo else ''}; artifacts "
          f"reload equal to the in-memory run; LU library kernels in them: "
          f"{lu or 'none'}; launches " + ", ".join(
              f"{k}={launches[k]}" for k in FIELD_KERNELS + tuple(
                  v[0] for v in FIELD_VARIANTS)), flush=True)
    print(f"[{tag}] SVD against numpy LAPACK: " + "; ".join(
        f"{mode} sigma {s:.3e} of the largest (gate 1e-10), rank-{k} "
        f"reconstruction {r:.3e} (gate 1e-8)" for mode, (s, r, k) in svd_err.items())
        + f"; energy % (concat) {runs['decompose concat']['energy_pct']}; finite "
        f"speeds {finite}" + (
            f"; demo: frames {shown['frames']}, matched {shown['matched']}, missed "
            f"{shown['missed']}, spare {shown['spare']}, err_max {shown['err_max']:.4f}"
            if demo else ""), flush=True)
    return launches


def run_flow(mesh, pot, truth, tag: str = "flow", kernels=FLOW_KERNELS,
             cell: float = 60.0 / 55.0, keep_v_k: Path | None = None) -> dict:
    """The flow stage through the port's command line ([flow] on the bench
    problem, [flow12k] on the 12.5k surface); returns the launch counts of
    that run. `cell` is the grid spacing the source distances are given in;
    `keep_v_k` receives a copy of the V_k.csv it wrote."""
    from manifold_flow_tpu_torch.kernels import LAUNCHES, reset_launches
    from manifold_flow_tpu_torch.pipeline import cli, stages
    from manifold_flow_tpu_torch.pipeline.config import PipelineConfig
    from manifold_flow_tpu_torch.utils import io as mio

    with tempfile.TemporaryDirectory(prefix="chip_smoke_flow_") as tmp:
        tmp = Path(tmp)
        mio.write_ply(tmp / "surface.ply", mesh.points.cpu().numpy(),
                      mesh.triangles.cpu().numpy())
        np.save(tmp / "movie.npy", pot.cpu().numpy())
        out = tmp / "out"
        argv = ["flow", "--surface", str(tmp / "surface.ply"), "--potentials",
                str(tmp / "movie.npy"), "--sfreq", "512", "--out-dir", str(out)]
        stdout = io.StringIO()
        with warnings.catch_warnings():
            warnings.simplefilter("error", stages.ConvergenceWarning)
            torch.cuda.synchronize()
            reset_launches()
            with contextlib.redirect_stdout(stdout):
                rc = cli.main(argv)
            launches = dict(LAUNCHES)
        report = json.loads(stdout.getvalue().strip().splitlines()[-1])
        if (rc != 0 or not report["converged"]
                or not report["device"].startswith(mesh.device.type)):
            raise AssertionError(f"flow CLI: rc {rc}, report {report}")
        idle = [k for k in kernels if launches[k] == 0]
        if idle:
            raise AssertionError(f"kernels of the {tag} path never launched: {idle}")

        # The same stages in memory (the kernels are deterministic, so the
        # artifacts must reload equal to them).
        cfg = PipelineConfig()
        fmesh = stages.load_surface(tmp / "surface.ply", device=mesh.device)
        movie = np.load(tmp / "movie.npy")
        times = np.arange(movie.shape[0]) / 512.0
        vel = stages.velocity_stage(fmesh, movie, times, cfg)
        pts, _ = stages.singularity_stage(fmesh, vel.v_world, cfg,
                                          speed=vel.speed, v_max=vel.v_max)
        t_v = movie.shape[0] - 1
        v_k_file = mio.load_indexed_csv(out / "V_k.csv")
        if v_k_file.shape != (t_v, fmesh.n_dof):
            raise AssertionError(f"V_k.csv is {v_k_file.shape}")
        same = {
            "e.csv": np.array_equal(mio.load_e_csv(out / "e.csv"), vel.e),
            "V_k.csv": np.array_equal(v_k_file, vel.v_k.cpu().numpy()),
            "wave_velocity_opticalflow.pkl.bz2": np.array_equal(
                mio.load_pickle(out / "wave_velocity_opticalflow.pkl.bz2"),
                vel.speed.cpu().numpy()),
        }
        saved = mio.load_pickle(out / "singularity_points.pkl")
        same["singularity_points.pkl"] = len(saved) == len(pts) == t_v and all(
            np.array_equal(np.asarray(a).reshape(b.shape), b)
            for a, b in zip(saved, pts))
        if not all(same.values()) or not vel.converged:
            raise AssertionError(f"flow artifacts differ from the in-memory "
                                 f"run: {same}, converged {vel.converged}")
        if keep_v_k is not None:
            shutil.copy(out / "V_k.csv", keep_v_k)

    per_frame = np.array(report["singularities_per_frame"])
    if per_frame.shape != (t_v,) or not (per_frame == [len(p) for p in pts]).all():
        raise AssertionError(f"singularities per frame: {per_frame}")
    truth = truth.cpu().numpy()
    near = [[float(np.linalg.norm(p - src, axis=-1).min()) / cell if len(p)
             else float("inf") for p in pts] for src in truth]
    print(f"[{tag}] cli flow on {fmesh.n_vertices} vertices x {movie.shape[0]} "
          f"frames: all {t_v} frames converged, {report['iterations']} inner "
          f"iterations, V_k {v_k_file.shape}, artifacts reload equal to the "
          f"in-memory run; launches " + ", ".join(
              f"{k}={launches[k]}" for k in kernels), flush=True)
    print(f"[{tag}] singularities per frame: min {per_frame.min()} median "
          f"{float(np.median(per_frame))} max {per_frame.max()}; nearest "
          "detection to each true source, grid cells (median / max over "
          "frames): " + "; ".join(
              f"source {i}: {float(np.median(d)):.3f} / {max(d):.3f}"
              for i, d in enumerate(near)), flush=True)
    return launches


COARSE_KERNELS = ("coarse_assemble", "coarse_restrict", "coarse_gemv",
                  "coarse_prolong_dot")
FLOW12K_KERNELS = FLOW_KERNELS + tuple(f"{k}<float>" for k in COARSE_KERNELS)


def band(iterations: int, expected: int) -> str:
    """Inner iterations against the count earlier kernel designs gave: a
    change of summation order may move them by a step or two, not more."""
    if abs(iterations - expected) > 2:
        raise AssertionError(f"{iterations} inner iterations, outside {expected} +- 2")
    return f"inside {expected} +- 2"


def run_twolevel(mesh12, pot12, times12, v_ref12, mesh, pot, times) -> dict:
    """The 12.5k refined solve through compute_velocity_fields with
    precond='auto' (two-level), then both preconditioners at 12.5k and on
    the bench surface (Jacobi at 12.5k and two-level at 3.1k launch
    instances no other phase does), and a float64 cg two-level solve at
    12.5k. Returns the launch counts of that cg solve (the phase that
    drives the float64 coarse kernels)."""
    from manifold_flow_tpu_torch.solve import coarse
    from manifold_flow_tpu_torch.solve.api import TWO_LEVEL_MIN_VERTICES

    refined = dict(method="refined", tol=1e-6, max_iter=4000)
    t_v = pot12.shape[0] - 1
    res, launches = counted_solve(mesh12, pot12, times12, precond="auto", **refined)
    rmse = check_solution("twolevel 12.5k", res, v_ref12, t_v, mesh12.n_dof)
    idle = [k for k in COARSE_KERNELS if launches[f"{k}<float>"] == 0]
    if idle:
        raise AssertionError(f"coarse kernels of the 12.5k refined solve never "
                             f"launched: {idle}")
    tables = coarse.build_tables(mesh12)  # the cached tables the solve used
    print(f"[twolevel] {mesh12.n_vertices} vertices x {t_v} frames, refined tol "
          f"1e-6, precond 'auto' (two-level from {TWO_LEVEL_MIN_VERTICES}): "
          f"inner iterations {res.iterations} ({band(res.iterations, 60)}), all "
          f"frames converged, RMSE vs spsolve (2 frames) {rmse:.3e} (gate "
          f"{RMSE_GATE:.0e}); coarse space {tables.n_coarse} aggregates; frames with "
          f"a zeroed coarse inverse {res.coarse_zeroed}; launches " + ", ".join(
              f"{k}<float>={launches[f'{k}<float>']}" for k in COARSE_KERNELS),
          flush=True)

    rows = []
    for name, (m, p, tt) in (("12.5k", (mesh12, pot12, times12)),
                             ("3.1k", (mesh, pot, times))):
        for precond in ("two_level", "jacobi"):
            r = solve(m, p, tt, precond=precond, **refined)
            if not bool(r.converged.all()):
                raise AssertionError(f"{precond} at {name} did not converge")
            rows.append(f"{name} {precond}: {r.iterations} inner iterations")
    print("[twolevel] both preconditioners, refined tol 1e-6, every frame converged: "
          + "; ".join(rows), flush=True)

    res_cg, launches_cg = counted_solve(mesh12, pot12, times12, method="cg",
                                        tol=1e-8, max_iter=4000, precond="two_level")
    rmse_cg = check_solution("cg two-level 12.5k", res_cg, v_ref12, t_v, mesh12.n_dof)
    idle = [k for k in COARSE_KERNELS if launches_cg[f"{k}<double>"] == 0]
    if idle:
        raise AssertionError(f"coarse kernels of the 12.5k cg solve never "
                             f"launched: {idle}")
    print(f"[twolevel] float64 cg two-level at 12.5k, tol 1e-8: iterations "
          f"{res_cg.iterations}, all frames converged, RMSE vs spsolve "
          f"{rmse_cg:.3e}", flush=True)
    return launches_cg


def run_long(mesh) -> None:
    """A 392-frame two-source movie on the bench surface, solved
    in 104-frame windows (frame_chunk='auto', 4 windows) and whole.

    Both are held to the RMSE gate against spsolve on frames from every
    window and both sides of each seam. tol bounds each frame's relative
    residual, not its error, which may reach cond(A) * tol, so tol * max|v|
    bounds nothing; their largest difference is held instead to the
    accuracy both are gated at, RMSE_GATE * max|v|, in the max norm."""
    from manifold_flow_tpu_torch.geometry import synthetic
    from manifold_flow_tpu_torch.solve.api import FRAME_CHUNK_SIZE

    pot, times, _ = synthetic.two_source_movie(
        mesh, sources=((15.0, 15.0), (45.0, 45.0)), n_frames=392, speed=24.0,
        wavelength=24.0, dt=1.0 / 512.0, dtype=np.float64)
    t_v = pot.shape[0] - 1
    tol = 1e-6
    kw = dict(method="refined", tol=tol, max_iter=4000)
    out = {}
    for chunk in ("auto", None):
        res = solve(mesh, pot, times, frame_chunk=chunk, **kw)
        if tuple(res.v_k.shape) != (t_v, mesh.n_dof) or not bool(res.converged.all()):
            raise AssertionError(f"392 frames, frame_chunk={chunk!r}: "
                                 f"{int((~res.converged).sum())} frames did not "
                                 f"converge, v_k {tuple(res.v_k.shape)}")
        out[chunk] = res
    # The first and last frame, and both sides of each seam between the
    # windows that supply frames (starts 0, 104, 208 and 287).
    frames = (0, 103, 104, 207, 208, 311, 312, 390)
    v_ref = np.stack([spsolve_reference(mesh, pot[k: k + 2], times[k: k + 2], 1)[0]
                      for k in frames])
    rmse = {chunk: check_solution(f"long, frame_chunk={chunk!r}",
                                  res._replace(v_k=res.v_k[list(frames)]), v_ref,
                                  len(frames), mesh.n_dof)
            for chunk, res in out.items()}
    dv = float((out["auto"].v_k - out[None].v_k).abs().max())
    vmax = float(out[None].v_k.abs().max())
    if not dv <= RMSE_GATE * vmax:
        raise AssertionError(f"392 frames: chunked and whole differ by {dv:.3e} "
                             f"> RMSE_GATE * max|v| {RMSE_GATE * vmax:.3e}")
    print(f"[long] {mesh.n_vertices} vertices x {t_v} velocity frames, refined "
          f"tol {tol:g}: both converged; chunked ({-(-t_v // FRAME_CHUNK_SIZE)} "
          f"windows of {FRAME_CHUNK_SIZE}) "
          f"{out['auto'].iterations} inner iterations (largest window); "
          f"whole {out[None].iterations} inner iterations; RMSE "
          f"vs spsolve on {len(frames)} frames across the seams {rmse['auto']:.3e} "
          f"chunked, {rmse[None]:.3e} whole (gate {RMSE_GATE:.0e}); max |dv| "
          f"{dv:.3e} (bound RMSE_GATE * max|v| {RMSE_GATE * vmax:.3e}; tol * "
          f"max|v| {tol * vmax:.3e})", flush=True)


def run_cholesky(mesh, pot, times, v_ref, v_cg) -> dict:
    """method='cholesky' on the bench problem against spsolve and against
    the float64 cg solve at tol 1e-8; returns its launch counts."""
    t_v, n_dof = pot.shape[0] - 1, mesh.n_dof
    res, launches = counted_solve(mesh, pot, times, method="cholesky")
    rmse = check_solution("cholesky", res, v_ref, t_v, n_dof)
    idle = [k for k in ("fem_matvec<double>", "frame_factors_rhs<double>")
            if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels of the cholesky path never launched: {idle}")
    diff = float((res.v_k - v_cg).abs().max()) / float(v_cg.abs().max())
    print(f"[cholesky] {mesh.n_vertices} vertices x {t_v} frames (dense "
          f"{n_dof}x{n_dof} in f64, one frame at a time, 2 refinement steps): "
          f"all frames converged to tol 1e-10, RMSE vs spsolve {rmse:.3e} (gate "
          f"{RMSE_GATE:.0e}); max |v - v_cg| / max|v_cg| {diff:.3e} (cg tol "
          f"1e-8)", flush=True)
    return launches


def solve(mesh, pot, times, **kwargs):
    from manifold_flow_tpu_torch import compute_velocity_fields

    res = compute_velocity_fields(mesh, pot, times, lambda_=0.01, **kwargs)
    torch.cuda.synchronize()
    return res


def counted_solve(mesh, pot, times, **kwargs):
    """One solve with every launch count set to 0 just before it."""
    from manifold_flow_tpu_torch.kernels import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    res = solve(mesh, pot, times, **kwargs)
    return res, dict(LAUNCHES)


def check_solution(name, res, v_ref, t_v, n_dof) -> float:
    v = res.v_k
    if tuple(v.shape) != (t_v, n_dof) or v.dtype != torch.float64:
        raise AssertionError(f"{name}: v_k is {tuple(v.shape)} {v.dtype}")
    if not bool(torch.isfinite(v).all()):
        raise AssertionError(f"{name}: v_k has non-finite values")
    if not bool(res.converged.all()):
        raise AssertionError(
            f"{name}: {int((~res.converged).sum())} frames did not converge")
    scale = max(float(np.abs(v_ref).max()), 1e-30)
    n = v_ref.shape[0]
    rmse = float(np.sqrt(np.mean((v[:n].cpu().numpy() - v_ref) ** 2)) / scale)
    if not rmse < RMSE_GATE:
        raise AssertionError(f"{name}: RMSE vs spsolve {rmse:.3e} >= {RMSE_GATE}")
    return rmse


# ------------------------------------------------------ the solve's options ----
# The default refined bench solve's launches (84 inner iterations), with no
# graph captured and no frozen iteration; the solve's options must leave
# them as they are. Each frozen iteration (solve.cg) adds one launch of
# every kernel of REFINED_ITERATION, and a capture its uncaptured start
# (REFINED_START) and iteration.
REFINED_LAUNCHES = {
    "fem_matvec<double>": 3, "fem_matvec<float>": 84, "frame_factors_rhs<double>": 1,
    "jacobi_blocks<float>": 1, "pcg_direction<float>": 84, "pcg_dot<double>": 6,
    "pcg_dot<float>": 87, "pcg_gate<float>": 87, "pcg_update<float>": 87}
REFINED_ITERATION = ("fem_matvec<float>", "pcg_dot<float>", "pcg_update<float>",
                     "pcg_direction<float>", "pcg_gate<float>")
REFINED_START = ("pcg_dot<float>", "pcg_update<float>", "pcg_gate<float>")
PRECISE_KERNELS = ("pcg_dot<float,double>", "pcg_update<float,double>")
COARSE_CU = "manifold_flow_tpu_torch/csrc/coarse_kernels.cu"


def check_precise_kernels(checks: KernelChecks, mesh, pot, times, suffix: str = "") -> None:
    """K3's dot and update and (at 12.5k) K11 in their float32 instances
    with float64 sums against their precise plain versions, on one
    iteration's worth of float32 state of the problem (p, its A p, the
    Jacobi blocks; r, P A_c^-1 P^T r): the same bytes as the float rows, so
    the same bounds."""
    from manifold_flow_tpu_torch.fem import assembly
    from manifold_flow_tpu_torch.fem.operator import make_operator
    from manifold_flow_tpu_torch.kernels import coarse as kco
    from manifold_flow_tpu_torch.kernels import fem as kfem
    from manifold_flow_tpu_torch.solve import coarse
    from manifold_flow_tpu_torch.solve.api import build_rhs

    f32 = torch.float32
    g64, _ = build_rhs(mesh, pot, times)
    op = make_operator(mesh, g64, 0.01).astype(f32)
    t, n_dof = g64.shape[0], mesh.n_dof
    gen = torch.Generator().manual_seed(3)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, dtype=torch.float64).to(pot.device, dtype)
    p = rand(t, n_dof, dtype=f32)
    ap = kfem.plain_fem_matvec(p, op.dof, op.blocks2, op.g, op.w_scale, op.lambda_,
                               op.gather_base)
    key = "pcg_dot<float,double>"
    checks.compare(key + suffix, PCG_CU, "manifold_flow_tpu/solve/cg.py:30",
                   lambda: (kfem.pcg_dot(p, ap, precise=True),),
                   lambda: (kfem.plain_pcg_dot(p, ap, precise=True),), TOL_F32,
                   inputs=(p, ap), ops=2 * t * n_dof, launches_key=key)
    if not torch.equal(kfem.pcg_dot(p, ap, precise=True), kfem.pcg_dot(p, ap, precise=True)):
        raise AssertionError(f"{key}{suffix}: two calls on the same inputs differ")
    reg = assembly.corner_regularization(mesh, f32).contiguous()
    dinv = kfem.plain_jacobi_blocks(op.g, reg, mesh.areas.to(f32), op.lambda_, op.gather_base)
    check_update(checks, p, ap, dinv, rand(t, dtype=f32).abs(), rand, suffix=suffix,
                 precise=True)
    if not suffix:
        return
    pre = coarse.make_two_level(mesh, op.g, op.lambda_, coarse.build_tables(mesh))
    r, z = rand(t, n_dof, dtype=f32), rand(t, n_dof, dtype=f32)
    yc = kco.plain_coarse_gemv(pre.ac_inv, kco.plain_coarse_restrict(r, pre.r_blk, pre.members))

    def prolong(fn):
        zs, rz = z.clone(), torch.empty(t, dtype=f32, device=z.device)
        fn(zs, r, yc, pre.r_blk, pre.agg, rz, True)
        return zs, rz
    bufs = [(z.clone(), torch.empty(t, dtype=f32, device=z.device)) for _ in range(2)]
    key = "coarse_prolong_dot<float,double>"
    checks.compare(key + suffix, COARSE_CU, "manifold_flow_tpu/solve/coarse.py:272",
                   lambda: prolong(kco.coarse_prolong_dot),
                   lambda: prolong(kco.plain_coarse_prolong_dot), TOL_F32,
                   timed=(lambda: kco.coarse_prolong_dot(
                              bufs[0][0], r, yc, pre.r_blk, pre.agg, bufs[0][1], True),
                          lambda: kco.plain_coarse_prolong_dot(
                              bufs[1][0], r, yc, pre.r_blk, pre.agg, bufs[1][1], True)),
                   inputs=(z, r, yc, pre.r_blk, pre.agg),
                   ops=t * (8 * mesh.n_vertices + 2 * n_dof), launches_key=key)
    got = prolong(kco.coarse_prolong_dot)
    if not all(torch.equal(a, b) for a, b in zip(got, prolong(kco.coarse_prolong_dot))):
        raise AssertionError(f"{key}{suffix}: two calls on the same inputs differ")


def rmse_of(v: torch.Tensor, v_ref: np.ndarray) -> float:
    """RMSE of v's first frames against the spsolve reference, over its
    largest entry."""
    n = v_ref.shape[0]
    return float(np.sqrt(np.mean((v[:n].double().cpu().numpy() - v_ref) ** 2))
                 / max(float(np.abs(v_ref).max()), 1e-30))


def run_precise(problems: dict, refined: tuple) -> dict:
    """[precise]: float32 cg solves of the bench problem (Jacobi) and of the
    12.5k problem (two-level, precond 'auto') with precise_dots=True, each
    beside the same solve without it, every launch count set to 0 just
    before each; then the default refined bench solve `refined` again, whose
    launches must be REFINED_LAUNCHES with those of its frozen iterations
    and of a capture (its plan may have been evicted since [slice]).
    Returns the precise solves' launches, by size."""
    from manifold_flow_tpu_torch.solve import cg
    from manifold_flow_tpu_torch.utils import profiling

    launches_of = {}
    kw = dict(method="cg", tol=1e-5, max_iter=4000)
    for tag, (mesh, pot, times, v_ref) in problems.items():
        res_p, launches_p = counted_solve(mesh, pot, times, precise_dots=True, **kw)
        res_d, launches_d = counted_solve(mesh, pot, times, **kw)
        want = PRECISE_KERNELS + (("coarse_prolong_dot<float,double>",)
                                  if tag == "12.5k" else ())
        idle = [k for k in want if launches_p[k] == 0]
        leaked = {k: launches_p[k] for k in ("pcg_dot<float>", "pcg_update<float>",
                                             "coarse_prolong_dot<float>") if launches_p[k]}
        stray = {k: n for k, n in launches_d.items() if "," in k and n}
        if idle or leaked or stray:
            raise AssertionError(f"[precise] {tag}: precise instances idle {idle}, float "
                                 f"instances in the precise solve {leaked}, precise "
                                 f"instances in the default one {stray}")
        for name, res in (("precise", res_p), ("default", res_d)):
            if res.v_k.dtype != torch.float32 or not bool(res.converged.all()):
                raise AssertionError(f"[precise] {tag} {name}: {res.v_k.dtype}, "
                                     f"{int((~res.converged).sum())} frames unconverged")
        print(f"[precise] {tag} ({mesh.n_vertices} vertices, float32 cg tol 1e-5, "
              f"precond {'two-level' if tag == '12.5k' else 'Jacobi'}): precise_dots "
              f"iterations {res_p.iterations}, RMSE vs spsolve ({v_ref.shape[0]} frames) "
              f"{rmse_of(res_p.v_k, v_ref):.3e}; without {res_d.iterations}, "
              f"{rmse_of(res_d.v_k, v_ref):.3e}; max |dv| between them "
              f"{float((res_p.v_k - res_d.v_k).abs().max() / res_d.v_k.abs().max()):.3e} "
              f"of max|v|; precise launches " + ", ".join(
                  f"{k}={n}" for k, n in sorted(launches_p.items()) if n), flush=True)
        launches_of[tag] = launches_p
    with profiling.record() as rec:
        res, launches = counted_solve(*refined, method="refined", tol=1e-6, max_iter=4000)
    counts = rec.summary()["counts"]
    frozen = counts.get("solve.frozen_iters", 0)
    warm = counts.get("solve.graph_captures", 0) // (1 + len(cg.GRAPH_LENGTHS))
    ran = {k: n for k, n in launches.items() if n}
    want = {k: n + (frozen + warm) * (k in REFINED_ITERATION) + warm * (k in REFINED_START)
            for k, n in REFINED_LAUNCHES.items()}
    if ran != want:
        raise AssertionError(f"[precise] the default refined solve's launches moved: {ran}, "
                             f"want {want} ({frozen} frozen iterations, {warm} captures)")
    print(f"[precise] the default refined bench solve after them: {res.iterations} inner "
          f"iterations, {frozen} frozen, {warm} captures, launches as REFINED_LAUNCHES with "
          f"those and no precise instance: " + ", ".join(
              f"{k}={n}" for k, n in sorted(ran.items())), flush=True)
    return launches_of


def run_anchor(mesh, pot, times, v_ref) -> None:
    """[anchor]: the refined bench solve with anchor_stride 2 and 4 beside
    stride 1: every frame converged, RMSE under the gate, inner iterations
    (the anchors' included)."""
    t_v, n_dof = pot.shape[0] - 1, mesh.n_dof
    parts = []
    for stride in (1, 2, 4):
        kw = dict(method="refined", tol=1e-6, max_iter=4000, anchor_stride=stride)
        res, launches = counted_solve(mesh, pot, times, **kw)
        rmse = check_solution(f"anchor_stride={stride}", res, v_ref, t_v, n_dof)
        parts.append(f"stride {stride}: inner iterations {res.iterations} (84 at stride "
                     f"1), RMSE {rmse:.3e}, K1 <float> launches "
                     f"{launches['fem_matvec<float>']}, <double> "
                     f"{launches['fem_matvec<double>']}")
    print(f"[anchor] refined tol 1e-6 on the bench problem, every frame converged, "
          f"RMSE gate {RMSE_GATE:.0e}: " + "; ".join(parts), flush=True)


def run_profiling(mesh, pot, times) -> None:
    """[profiling]: utils.profiling.trace around one refined bench solve
    writes a Chrome trace naming the K1 wrapper's launches."""
    from manifold_flow_tpu_torch.utils import profiling

    solve(mesh, pot, times, method="refined", tol=1e-6, max_iter=4000)  # warm
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        with profiling.trace(tmp):
            solve(mesh, pot, times, method="refined", tol=1e-6, max_iter=4000)
        (path,) = Path(tmp).iterdir()
        text = path.read_text()
        ranges = sum(1 for e in json.loads(text)["traceEvents"]
                     if str(e.get("name", "")).startswith("fem_matvec<"))
        if "fem_matvec" not in text or ranges == 0:
            raise AssertionError(f"[profiling] the trace {path.name} names no fem_matvec")
        print(f"[profiling] utils.profiling.trace around one refined solve: {path.name}, "
              f"{len(text) >> 10} KiB, {ranges} fem_matvec host ranges", flush=True)


def run_viz(mesh, kept: Path) -> None:
    """[viz]: the renderers on the card's host, if matplotlib is installed
    there: `visualize` of a frame of the bench flow CLI's V_k.csv (`kept`)
    on its surface and bases (K5 recombines it on the card) and `demo
    --gif` at its defaults; without matplotlib, `visualize` must raise an
    ImportError naming it."""
    from manifold_flow_tpu_torch.kernels import LAUNCHES, reset_launches
    from manifold_flow_tpu_torch.pipeline import cli
    from manifold_flow_tpu_torch.utils import io as mio

    mio.write_ply(kept / "surface.ply", *mio.to_numpy(mesh.points, mesh.triangles))
    mio.save_e_csv(kept / "e.csv", mesh.basis.cpu().numpy())

    try:
        import matplotlib  # noqa: F401
        has_mpl = True
    except ImportError:
        has_mpl = False
    argv = ["visualize", "--surface", str(kept / "surface.ply"), "--e", str(kept / "e.csv"),
            "--v-k", str(kept / "V_k.csv"), "--frame", "48", "--out-dir", str(kept / "viz")]
    if not has_mpl:
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(argv)
        except ImportError as e:
            if "matplotlib" not in str(e):
                raise
            print(f"[viz] matplotlib does not import on this host: visualize raises "
                  f"ImportError({str(e)!r}); nothing rendered (a missing host library)",
                  flush=True)
            return
        raise AssertionError("[viz] visualize ran without matplotlib")
    from PIL import Image

    torch.cuda.synchronize()
    reset_launches()
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main(argv)
    k5 = LAUNCHES["recombine_speed<double>"]
    line = json.loads(stdout.getvalue().strip().splitlines()[-1])
    png = Path(line["png"])
    with Image.open(png) as im:
        size = im.size
    if rc != 0 or k5 != 1 or png.stat().st_size == 0:
        raise AssertionError(f"[viz] visualize: rc {rc}, K5 launches {k5}, {png}")
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main(["demo", "--gif", "--out-dir", str(kept / "demo_gif")])
    line = json.loads(stdout.getvalue().strip().splitlines()[-1])
    with Image.open(line["gif"]) as im:
        n_frames, gif_size = im.n_frames, im.size
    if rc != 0 or not line["converged"] or n_frames != line["frames"]:
        raise AssertionError(f"[viz] demo --gif: rc {rc}, {line}, {n_frames} GIF frames")
    print(f"[viz] matplotlib {matplotlib.__version__} on this host: visualize frame 48 of "
          f"the bench flow CLI's V_k.csv, K5 launched {k5}x, {png.name} {size[0]}x{size[1]} "
          f"px; demo --gif (24x24, 12 frames): {n_frames} GIF frames "
          f"{gif_size[0]}x{gif_size[1]} px, matched {line['matched']}", flush=True)


# -------------------------------------------------------- pipeline.batch ----
BATCH_KERNELS = FLOW_KERNELS + ("next_hop<double>", "trace_walks<int>", "pack_walks<int>",
                                "winding_profile<double>", "wave_speed<double>")
# Floats of a batch artifact against the CLI's for the same inputs: equal,
# or within this of the largest |value| (NaN and inf at the same places).
BATCH_TOL = 1e-12


def same_floats(got, want) -> str | None:
    """'bitwise', 'within tol', or None when `got` differs from `want`."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return None
    if np.array_equal(got, want, equal_nan=True):
        return "bitwise"
    fin = np.isfinite(want)
    if not np.array_equal(fin, np.isfinite(got)) or not np.array_equal(
            got[~fin], want[~fin], equal_nan=True):
        return None
    scale = float(np.abs(want[fin]).max()) if fin.any() else 0.0
    err = float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0
    return "within tol" if err <= BATCH_TOL * max(scale, 1e-300) else None


def compare_artifacts(pairs) -> dict:
    """{label: 'bitwise' | 'within tol' | None} for (label, kind, got, want)
    artifact paths: discrete parts (frame, line and row counts, ring counts
    and types) must be equal, floats as same_floats."""
    from manifold_flow_tpu_torch.utils import io as mio

    def lists(a, b):
        if len(a) != len(b):
            return None
        results = [same_floats(x, y) for x, y in zip(a, b)]
        return None if None in results else (
            "bitwise" if all(r == "bitwise" for r in results) else "within tol")

    out = {}
    for label, kind, got, want in pairs:
        if kind == "csv":
            out[label] = same_floats(mio.load_indexed_csv(got), mio.load_indexed_csv(want))
        elif kind == "array":
            out[label] = same_floats(mio.load_pickle(got), mio.load_pickle(want))
        elif kind == "points":
            out[label] = lists([np.asarray(p) for p in mio.load_pickle(got)],
                               [np.asarray(p) for p in mio.load_pickle(want)])
        elif kind == "lines":
            a, b = mio.load_pickle(got), mio.load_pickle(want)
            out[label] = lists(a[next(iter(a))], b[next(iter(b))]) if list(a) == list(b) else None
        elif kind == "winding":
            a = got if isinstance(got, dict) else mio.load_pickle(got)
            b = want if isinstance(want, dict) else mio.load_pickle(want)
            rows = {k: [(r[1], r[2]) for r in v] for k, v in a.items()}
            if rows != {k: [(r[1], r[2]) for r in v] for k, v in b.items()}:
                out[label] = None
            else:
                out[label] = lists([r[0] for k in a for r in a[k]],
                                   [r[0] for k in b for r in b[k]])
        elif kind == "npz":
            with np.load(got) as za, np.load(want) as zb:
                parts = [same_floats(za[k], zb[k]) for k in ("U", "Sigma", "VT")]
                same_n = int(za["point_num"]) == int(zb["point_num"])
            out[label] = None if None in parts or not same_n else (
                "bitwise" if all(r == "bitwise" for r in parts) else "within tol")
        else:
            raise ValueError(kind)
    return out


def make_results_tree(root: Path, subject: str, surface: Path, trials: dict) -> None:
    """<root>/<subject>/ in the reference layout: the surface as
    {subject}_reconstructed_surface.ply, SamplingFrequency 512 in a sidecar,
    and for each trial name its movie (and phases movie, where given) as
    sub-NN_run-001-<trial>-ave-interpolation_(phases_)data.csv."""
    from manifold_flow_tpu_torch.utils import io as mio

    subj = root / subject
    subj.mkdir(parents=True, exist_ok=True)
    if surface is not None:
        shutil.copy(surface, subj / f"{subject}_reconstructed_surface.ply")
    (subj / f"{subject}_ieeg.json").write_text(json.dumps({"SamplingFrequency": 512}))
    for trial, (movie, phases) in trials.items():
        tdir = subj / "run-001" / trial
        tdir.mkdir(parents=True)
        stem = f"{subject}_run-001-{trial}-ave"
        mio.save_indexed_csv(tdir / f"{stem}-interpolation_data.csv", movie)
        if isinstance(phases, Path):
            shutil.copy(phases, tdir / f"{stem}-interpolation_phases_data.csv")
        elif phases is not None:
            mio.save_indexed_csv(tdir / f"{stem}-interpolation_phases_data.csv", phases)


def trial_pairs(tdir: Path, prefix: str, subject_dir: Path, cli_trial: Path,
                cli_fields: Path, t_v: int) -> list:
    """The (label, kind, batch path, CLI path) pairs of one trial fed the
    CLI runs' movie ([trial]'s or [trial12k]'s) and [fields]' ([fields12k]')
    phases movie."""
    out = cli_trial / "out"
    pairs = [("e.csv", "csv", subject_dir / f"{subject_dir.name}_e.csv", out / "e.csv"),
             ("V_k.csv", "csv", tdir / f"{prefix}-V_k.csv", out / "V_k.csv"),
             ("wave_velocity_opticalflow", "array",
              tdir / f"{prefix}-wave_velocity_opticalflow.pkl.bz2",
              out / "wave_velocity_opticalflow.pkl.bz2"),
             ("singularity_points", "points", tdir / f"{prefix}-singularity_points.pkl",
              out / "singularity_points.pkl"),
             ("data_01.npz", "npz", tdir / "data_01.npz",
              cli_fields / "out" / "concat" / "data_01.npz"),
             ("wave_velocity (phase)", "array", tdir / f"{prefix}-wave_velocity.pkl.bz2",
              cli_fields / "out" / "ws" / "wave_velocity_phase.pkl.bz2")]
    pairs += [(f"streamlines_{k}", "lines",
               tdir / f"t_velocityfields_streamlines_{k}.pkl.bz2",
               out / f"t_velocityfields_streamlines_{k}.pkl.bz2") for k in range(t_v)]
    return pairs


def summarize(results: dict) -> str:
    bad = sorted(k for k, v in results.items() if v is None)
    if bad:
        raise AssertionError(f"batch artifacts differ from the CLI's: {bad}")
    loose = sorted(k for k, v in results.items() if v != "bitwise")
    return (f"{len(results)} artifacts equal, "
            + (f"bitwise but {loose} (within {BATCH_TOL:.0e})" if loose else "all bitwise"))


def winding_with_centers(surface: Path, movie_csv: Path, device):
    """The winding lines the batch's trial path makes: the detection stage's
    snapped centers, in memory (the CLI snaps the saved points again on the
    host, so rows can differ where a point lies between vertices)."""
    from manifold_flow_tpu_torch.pipeline import stages
    from manifold_flow_tpu_torch.pipeline.config import PipelineConfig
    from manifold_flow_tpu_torch.utils import io as mio

    cfg = PipelineConfig()
    fmesh = stages.load_surface(surface, device=device)
    movie = mio.load_indexed_csv(movie_csv)
    vel = stages.velocity_stage(fmesh, movie, np.arange(movie.shape[0]) / 512.0, cfg)
    pts, _, centers = stages.singularity_stage(fmesh, vel.v_world, cfg, return_centers=True,
                                               speed=vel.speed, v_max=vel.v_max)
    return stages.winding_stage(fmesh, vel.v_world, pts, cfg, centers=centers)


def no_velocity_uploads(trace: Path, t_v: int, n: int) -> tuple[int, int]:
    """From a torch.profiler chrome trace: (host-to-device copies, those the
    size of a velocity field, (T, 2N) or (T, N, 3) in float32 or float64)."""
    events = json.loads(trace.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    h2d = [e for e in events if "HtoD" in str(e.get("name", ""))
           and "memcpy" in str(e.get("cat", "")).lower()]
    sizes = {t_v * 2 * n * esz for esz in (4, 8)} | {t_v * n * 3 * esz for esz in (4, 8)}
    return len(h2d), sum(int(e.get("args", {}).get("bytes", -1)) in sizes for e in h2d)


def run_batch_phase(checks: KernelChecks, mesh, pot, keep: Path) -> dict:
    """[batch], [reconstructed] and the fresh-process `batch` CLI: a
    two-subject results tree through pipeline.batch.run_batch in this
    process, checked against [trial]'s and [fields]' CLI artifacts, resumed,
    one warm trial profiled, then K1 and K13 on the reconstructed surface;
    returns the reconstructed trial's launches."""
    from manifold_flow_tpu_torch.kernels import LAUNCHES, reset_launches
    from manifold_flow_tpu_torch.ops import phase as phase_ops
    from manifold_flow_tpu_torch.pipeline import batch, cli, stages
    from manifold_flow_tpu_torch.pipeline.config import PipelineConfig
    from manifold_flow_tpu_torch.utils import io as mio

    device = mesh.device
    cli_trial, cli_fields = keep / "trial", keep / "fields"
    t_v = pot.shape[0] - 1
    with tempfile.TemporaryDirectory(prefix="chip_smoke_batch_") as tmp:
        root = Path(tmp) / "results"
        movie = np.load(cli_trial / "movie.npy")
        phases_csv = cli_fields / "out" / "phase" / "interpolation_phases_data.csv"
        make_results_tree(root, "sub-01", cli_trial / "surface.ply",
                          {"T1": (movie, phases_csv), "T2": (movie, None)})
        # The third trial: [fields]' evoked movie of 64 electrodes, its
        # electrodes.tsv and a channels.tsv selecting all of them.
        sub1 = root / "sub-01"
        names = [r["name"] for r in mio.read_tsv(cli_fields / "electrodes.tsv")]
        shutil.copy(cli_fields / "electrodes.tsv", sub1 / "sub-01_electrodes.tsv")
        (sub1 / "sub-01_run-001_channels.tsv").write_text("\n".join(
            ["name\ttype\tstatus\tstatus_description\tgroup"]
            + [f"{n}\tECOG\tgood\tincluded\tgrid" for n in names]) + "\n")
        t3 = sub1 / "run-001" / "S1-S2"
        t3.mkdir(parents=True)
        mio.save_evoked_csv(t3 / "sub-01_run-001-S1-S2-ave.csv",
                            np.load(cli_fields / "data.npy"), names)
        # sub-02: the surface the reconstruct CLI makes from the same 64
        # electrodes, with one trial of the two-source movie on it.
        sub2 = root / "sub-02"
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            rc = cli.main(["reconstruct", "--electrodes", str(cli_fields / "electrodes.tsv"),
                           "--out-dir", str(sub2)])
        recon = json.loads(stdout.getvalue().strip().splitlines()[-1])
        if rc != 0 or recon["device"] != "cuda":
            raise AssertionError(f"reconstruct CLI: rc {rc}, report {recon}")
        mesh2 = stages.load_surface(sub2 / "reconstructed_surface.ply", device=device)
        from manifold_flow_tpu_torch.geometry import synthetic

        pot2, times2, _ = synthetic.two_source_movie(
            mesh2, sources=((15.0, 15.0), (45.0, 45.0)), n_frames=98, speed=24.0,
            wavelength=24.0, dt=1.0 / 512.0, dtype=np.float64)
        phi2 = phase_ops.instantaneous_phase(pot2, axis=0)
        make_results_tree(root, "sub-02", None,
                          {"T1": (pot2.cpu().numpy(), phi2.cpu().numpy())})

        cfg = PipelineConfig()
        stage_set = ("interpolate",) + batch.ALL_STAGES
        mesh_cache: dict = {}
        with warnings.catch_warnings():
            warnings.simplefilter("error", stages.ConvergenceWarning)
            torch.cuda.synchronize()
            reset_launches()
            report = batch.run_batch(root, cfg, stages=stage_set, mesh_cache=mesh_cache)
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
        keys = ["sub-01/run-001/S1-S2", "sub-01/run-001/T1", "sub-01/run-001/T2",
                "sub-02/run-001/T1"]
        want_status = {k: {s: "done" for s in batch.ALL_STAGES} for k in keys}
        want_status["sub-01/run-001/T2"]["wavespeed"] = "skipped"  # no phases movie
        if (report["errors"] or report["trials"] != want_status
                or report["interpolation"]["sub-01/run-001/S1-S2"]["status"] != "done"):
            raise AssertionError(f"batch: {report}")
        idle = [k for k in BATCH_KERNELS + ("rbf_fit<double>", "rbf_eval<double>")
                if launches[k] == 0]
        if idle:
            raise AssertionError(f"kernels of the batch path never launched: {idle}")

        # The 3.1k trial against [trial]'s and [fields]' CLI artifacts for
        # the same inputs; the interpolated trial against [fields]'.
        tdir = sub1 / "run-001" / "T1"
        pre = "sub-01_run-001-T1"
        pairs = trial_pairs(tdir, pre, sub1, cli_trial, cli_fields, t_v)
        t3pre = "sub-01_run-001-S1-S2"
        pairs += [("S1-S2 interpolation_data.csv", "csv",
                   t3 / f"{t3pre}-ave-interpolation_data.csv",
                   cli_fields / "out" / "amp" / "interpolation_data.csv"),
                  ("S1-S2 interpolation_phases_data.csv", "csv",
                   t3 / f"{t3pre}-ave-interpolation_phases_data.csv", phases_csv),
                  ("S1-S2 wave_velocity (phase)", "array",
                   t3 / f"{t3pre}-wave_velocity.pkl.bz2",
                   cli_fields / "out" / "ws" / "wave_velocity_phase.pkl.bz2"),
                  ("S1-S2 wave_velocity_amplitude", "array",
                   t3 / f"{t3pre}-wave_velocity_amplitude.pkl.bz2",
                   cli_fields / "out" / "ws" / "wave_velocity_amplitude.pkl.bz2")]
        results = compare_artifacts(pairs)
        fmesh = mesh_cache[sub1 / "sub-01_reconstructed_surface.ply"]
        amp = stages.wavespeed_stage(fmesh, movie, 1.0 / SFREQ, method="amplitude")
        results["wave_velocity_amplitude"] = same_floats(
            mio.load_pickle(tdir / f"{pre}-wave_velocity_amplitude.pkl.bz2"),
            amp.cpu().numpy())
        expected = winding_with_centers(cli_trial / "surface.ply",
                                        tdir / f"{pre}-ave-interpolation_data.csv", device)
        results["winding_lines"] = compare_artifacts(
            [("w", "winding", tdir / f"{pre}-winding_lines.pkl.bz2", expected)])["w"]
        cli_w = mio.load_pickle(cli_trial / "out" / "winding_lines.pkl.bz2")
        snap_diff = sum(a[1:] != b[1:] for k in expected
                        for a, b in zip(expected[k], cli_w.get(k, [])))
        verdict = summarize(results)

        # A second sweep: every stage skipped, no kernel launched.
        torch.cuda.synchronize()
        reset_launches()
        again = batch.run_batch(root, cfg, stages=stage_set, mesh_cache=mesh_cache)
        relaunched = {k: v for k, v in LAUNCHES.items() if v}
        statuses = {v for t in again["trials"].values() for v in t.values()} | {
            t["status"] for t in again["interpolation"].values()}
        if again["errors"] or statuses != {"skipped"} or relaunched:
            raise AssertionError(f"batch resume: statuses {statuses}, errors "
                                 f"{again['errors']}, launches {relaunched}")

        # One warm trial (the reconstructed surface's) under the profiler:
        # its launches, and no host-to-device copy of a velocity field
        # between its stages.
        (trial2,) = [t for t in batch.discover_trials(root) if t.subject == "sub-02"]
        torch.cuda.synchronize()
        reset_launches()
        with profiled() as prof:
            batch.run_trial(trial2, cfg, stages=batch.ALL_STAGES, overwrite=True,
                            mesh_cache=mesh_cache)
            torch.cuda.synchronize()
        recon_launches = dict(LAUNCHES)
        trace = Path(tmp) / "trial_trace.json"
        prof.export_chrome_trace(str(trace))
        n_h2d, n_velocity = no_velocity_uploads(trace, t_v, mesh2.n_vertices)
        if n_velocity:
            raise AssertionError(f"batch trial: {n_velocity} host-to-device copies the "
                                 "size of a velocity field")

        # [reconstructed]: K1 and K13 on the reconstructed surface.
        v_k2 = torch.as_tensor(mio.load_indexed_csv(
            sub2 / "run-001" / "T1" / "sub-02_run-001-T1-V_k.csv"),
            device=device).contiguous()
        check_reconstructed(checks, mesh2, pot2, times2, v_k2)

        # The batch CLI in a fresh process on the same tree, every stage
        # again: the process's first cuFFT / cuSOLVER use.
        argv = [sys.executable, "-m", "manifold_flow_tpu_torch.pipeline.cli", "batch",
                "--root", str(root), "--stages", *stage_set, "--overwrite"]
        proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        fresh = json.loads(lines[-1]) if lines else {}
        if proc.returncode != 0 or fresh.get("errors") != {} or fresh.get("trials") != want_status:
            raise AssertionError(f"batch CLI in a fresh process: rc {proc.returncode}, "
                                 f"report {fresh}, stderr {proc.stderr[-2000:]}")
        shutil.copytree(root, keep / "batch_tree")  # for [dist]'s distributed sweep

    print(f"[batch] run_batch(stages=('interpolate',) + ALL_STAGES) over 2 subjects, 4 "
          f"trials ({fmesh.n_vertices} and {mesh2.n_vertices} vertices x 98 frames; "
          f"reconstruct CLI {recon['n_vertices']} vertices, {recon['n_triangles']} "
          f"triangles): no errors, every stage done but T2's "
          f"wavespeed (no phases movie: skipped, as in JAX); launches " + ", ".join(
              f"{k}={launches[k]}" for k in BATCH_KERNELS + (
                  "rbf_fit<double>", "rbf_eval<double>")), flush=True)
    print(f"[batch] artifacts against [trial]'s and [fields]' CLI for the same inputs: "
          f"{verdict}; "
          f"winding lines equal the in-memory stage with the detection stage's centers "
          f"({snap_diff} rows differ from the CLI's, which snaps the saved points again "
          f"on the host); a second run_batch skipped every stage with 0 launches",
          flush=True)
    print(f"[batch] warm run_trial of sub-02 (reconstructed, {mesh2.n_vertices} vertices) "
          f"under the profiler: {n_h2d} host-to-device copies, {n_velocity} of a velocity "
          f"field's size ({t_v} x {2 * mesh2.n_vertices} or {t_v} x {mesh2.n_vertices} x "
          f"3); launches " + ", ".join(
              f"{k}={v}" for k, v in sorted(recon_launches.items()) if v), flush=True)
    print("[batch] the batch CLI in a fresh process (--overwrite, every stage): rc 0, "
          "no errors", flush=True)
    return recon_launches


def check_reconstructed(checks: KernelChecks, mesh, pot, times, v_k) -> None:
    """[reconstructed]: K1 (float32 matvec, float64 residual) and K13
    (float64) against their plain versions on the reconstructed surface,
    whose 1-rings are wider than the bench patches' (rows '@recon')."""
    from manifold_flow_tpu_torch.fem.operator import make_operator
    from manifold_flow_tpu_torch.kernels import analysis as kan
    from manifold_flow_tpu_torch.kernels import streams as kst
    from manifold_flow_tpu_torch.ops import streamline as stream
    from manifold_flow_tpu_torch.solve.api import build_rhs

    gen = torch.Generator().manual_seed(0)
    g64, f64 = build_rhs(mesh, pot, times)
    t, n_dof = f64.shape
    op = make_operator(mesh, g64, 0.01)
    for dtype, tol in ((torch.float32, TOL_F32), (torch.float64, TOL_F64)):
        x = torch.randn(t, n_dof, generator=gen, dtype=torch.float64).to(pot.device, dtype)
        check_matvec(checks, mesh, op.astype(dtype) if dtype == torch.float32 else op,
                     x, f64 if dtype == torch.float64 else None, tol, suffix="@recon")
    v_world, _, _ = kan.recombine_speed(v_k, mesh.basis)
    nh = (stream.unit_edges(mesh, torch.float64), v_world, mesh.vertex_neighbors,
          *stream.hop_tables(mesh, torch.float64), mesh.basis)
    checks.compare("next_hop<double>@recon", "manifold_flow_tpu_torch/csrc/stream_kernels.cu",
                   "manifold_flow_tpu/ops/streamline.py:133",
                   lambda: (kst.next_hop(*nh),), lambda: (kst.plain_next_hop(*nh),),
                   TOL_F64, nbytes=next_hop_bytes(*nh),
                   ops=5 * t * int((mesh.vertex_neighbors != -1).sum()),
                   launches_key="next_hop<double>")
    if not torch.equal(kst.plain_next_hop(*nh), mesh_next_hop(mesh, v_world, False)):
        raise AssertionError("next_hop<double>@recon: the plain version on the hop tables "
                             "differs from the reference on the mesh tables")
    cells = mesh.vertex_cell_count
    print(f"[reconstructed] {mesh.n_vertices} vertices, {mesh.n_triangles} triangles: "
          f"{int((cells > 6).sum())} vertices in more than 6 cells (at most "
          f"{int(cells.max())}), 1-rings up to {int(mesh.vertex_degree.max())} wide, "
          f"{int(mesh.boundary_vertex.sum())} on the boundary", flush=True)


def run_batch12k(pot, keep: Path) -> None:
    """[batch12k]: one 12.5k trial through run_batch (ALL_STAGES), its movie
    and phases those of [trial12k] and [fields12k], checked as in [batch]
    (K8-K11 launched too)."""
    from manifold_flow_tpu_torch.kernels import LAUNCHES, reset_launches
    from manifold_flow_tpu_torch.pipeline import batch, stages
    from manifold_flow_tpu_torch.pipeline.config import PipelineConfig
    from manifold_flow_tpu_torch.utils import io as mio

    cli_trial, cli_fields = keep / "trial12k", keep / "fields12k"
    t_v = pot.shape[0] - 1
    kernels = BATCH_KERNELS + tuple(f"{k}<float>" for k in COARSE_KERNELS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_batch12k_") as tmp:
        root = Path(tmp) / "results"
        movie = np.load(cli_trial / "movie.npy")
        phases_csv = cli_fields / "out" / "phase" / "interpolation_phases_data.csv"
        make_results_tree(root, "sub-01", cli_trial / "surface.ply",
                          {"T1": (movie, phases_csv)})
        mesh_cache: dict = {}
        with warnings.catch_warnings():
            warnings.simplefilter("error", stages.ConvergenceWarning)
            torch.cuda.synchronize()
            reset_launches()
            report = batch.run_batch(root, PipelineConfig(), stages=batch.ALL_STAGES,
                                     mesh_cache=mesh_cache)
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
        key = "sub-01/run-001/T1"
        if report["errors"] or report["trials"] != {key: {s: "done" for s in batch.ALL_STAGES}}:
            raise AssertionError(f"batch12k: {report}")
        idle = [k for k in kernels if launches[k] == 0]
        if idle:
            raise AssertionError(f"kernels of the batch12k path never launched: {idle}")
        sub1 = root / "sub-01"
        tdir = sub1 / "run-001" / "T1"
        pre = "sub-01_run-001-T1"
        results = compare_artifacts(trial_pairs(tdir, pre, sub1, cli_trial, cli_fields, t_v))
        fmesh = mesh_cache[sub1 / "sub-01_reconstructed_surface.ply"]
        amp = stages.wavespeed_stage(fmesh, movie, 1.0 / SFREQ, method="amplitude")
        results["wave_velocity_amplitude"] = same_floats(
            mio.load_pickle(tdir / f"{pre}-wave_velocity_amplitude.pkl.bz2"),
            amp.cpu().numpy())
        expected = winding_with_centers(cli_trial / "surface.ply",
                                        tdir / f"{pre}-ave-interpolation_data.csv",
                                        fmesh.device)
        results["winding_lines"] = compare_artifacts(
            [("w", "winding", tdir / f"{pre}-winding_lines.pkl.bz2", expected)])["w"]
        verdict = summarize(results)
    print(f"[batch12k] run_batch(ALL_STAGES), one trial on {fmesh.n_vertices} vertices "
          f"x 98 frames: no errors, every stage done; launches " + ", ".join(
              f"{k}={launches[k]}" for k in kernels)
          + f"; artifacts against [trial12k]'s and [fields12k]' CLI: {verdict}", flush=True)


# ------------------------------------------------------------------ [dist] ----
# The kernels every rank of a distributed 12.5k solve must launch: K1 (both
# instances), K2, K3, K4 and, under two-level, K8-K11.
DIST_REFINED_KERNELS = ("fem_matvec<float>", "fem_matvec<double>", "jacobi_blocks<float>",
                        "frame_factors_rhs<double>", "pcg_dot<float>", "pcg_update<float>",
                        "pcg_direction<float>", "coarse_assemble<float>",
                        "coarse_restrict<float>", "coarse_gemv<float>",
                        "coarse_prolong_dot<float>")
DIST_CG_KERNELS = tuple(k.replace("<float>", "<double>") for k in DIST_REFINED_KERNELS
                        if k != "fem_matvec<double>")
DIST_ANALYSIS_KERNELS = ("detect_singular<double>", "wave_speed<double>",
                         "winding_profile<double>")
DIST_LAYOUTS = {2: ((2, 1), (1, 2)), 4: ((1, 4), (2, 2))}
DIST_TIMEOUT_S = 420.0


def _gathered_launches(comm, names) -> list[dict]:
    """Every rank's launch counts of `names`, all-gathered (read on rank 0)."""
    from manifold_flow_tpu_torch.kernels import LAUNCHES

    counts = torch.tensor([LAUNCHES[k] for k in names], dtype=torch.int64)
    return [dict(zip(names, row.tolist())) for row in comm.all_gather(counts)]


def _counted_layout(comm, fn):
    """fn() after a barrier, with the launch and staged-byte counts set to 0
    just before: (result, staged bytes)."""
    from manifold_flow_tpu_torch.kernels import reset_launches
    from manifold_flow_tpu_torch.parallel import comm as pcomm

    comm.barrier()
    torch.cuda.synchronize()
    reset_launches()
    pcomm.reset_staged()
    res = fn()
    torch.cuda.synchronize()
    return res, sum(pcomm.STAGED_BYTES.values())


def _digest(x: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest()


def _dist_rank(rank: int, world: int, batch_root) -> dict:
    """One rank's work in [dist], on cuda:0 shared with the other ranks: the
    refined 12.5k solve at each layout of DIST_LAYOUTS[world]; with 4 ranks
    also the float64 cg at (1, 4) and the analysis ops at (4, 1) against the
    single-GPU ops; with a batch tree, run_batch(distributed=True)."""
    import torch.distributed as dist

    from manifold_flow_tpu_torch.kernels import library
    from manifold_flow_tpu_torch.parallel import make_device_mesh
    from manifold_flow_tpu_torch.parallel import sharded_compute_velocity_fields
    from manifold_flow_tpu_torch.parallel.comm import AxisComm

    library()
    device = torch.device("cuda", 0)
    mesh, pot, times = build_problem_12k(device)[:3]
    comm = AxisComm(dist.group.WORLD, world, rank)
    out: dict = {"layouts": {}}
    results = {}
    for nf, nm in DIST_LAYOUTS[world]:
        dm = make_device_mesh(nf, nm, device=device)
        res, staged = _counted_layout(comm, lambda: sharded_compute_velocity_fields(
            mesh, pot, times, dm, tol=1e-6, max_iter=4000, method="refined", precond="auto"))
        results[(nf, nm)] = res
        out["layouts"][(nf, nm)] = {
            "iterations": res.iterations, "converged": bool(res.converged.all()),
            "digest": _digest(res.v_k), "staged": staged,
            "launches": _gathered_launches(comm, DIST_REFINED_KERNELS),
            "v_k": res.v_k.cpu().numpy() if rank == 0 else None}
    if world == 4:
        dm = make_device_mesh(1, 4, device=device)
        res, staged = _counted_layout(comm, lambda: sharded_compute_velocity_fields(
            mesh, pot, times, dm, tol=1e-8, max_iter=4000, method="cg", precond="auto"))
        out["cg"] = {"iterations": res.iterations, "converged": bool(res.converged.all()),
                     "staged": staged, "digest": _digest(res.v_k),
                     "launches": _gathered_launches(comm, DIST_CG_KERNELS),
                     "v_k": res.v_k.cpu().numpy() if rank == 0 else None}
        out["analysis"] = _dist_analysis(comm, mesh, pot, results[(1, 4)].v_k)
    if batch_root is not None:
        from manifold_flow_tpu_torch.pipeline import batch
        from manifold_flow_tpu_torch.pipeline.config import PipelineConfig

        out["batch"], _ = _counted_layout(comm, lambda: batch.run_batch(
            batch_root, PipelineConfig(), stages=batch.ALL_STAGES, distributed=True))
    return out


def _dist_analysis(comm, mesh, pot, v_k) -> dict:
    """sharded_detect_with_counts, sharded_wave_velocity (phase, amplitude)
    and sharded_winding_movie at (4, 1) on the 12.5k refined field, against
    the single-GPU ops on the same inputs: {name: verdict} (discrete parts
    equal, floats as same_floats) and each rank's launches."""
    from manifold_flow_tpu_torch.ops import singularity as sing
    from manifold_flow_tpu_torch.ops import wavespeed as wave_ops
    from manifold_flow_tpu_torch.ops import winding
    from manifold_flow_tpu_torch.ops.recombine import velocity_to_world_and_speed
    from manifold_flow_tpu_torch.parallel import (
        make_device_mesh,
        sharded_detect_with_counts,
        sharded_wave_velocity,
        sharded_winding_movie,
    )

    dm = make_device_mesh(4, 1, device=v_k.device)
    v_world, speed, v_max = velocity_to_world_and_speed(v_k, mesh.basis)
    phase = torch.remainder(pot + np.pi, 2 * np.pi) - np.pi
    field1, counts1 = sing.detect_with_counts(mesh, v_world, speed=speed, v_max=v_max)
    det = sing.compact_detected(mesh, field1, sing.capacity_for(*counts1.tolist()))
    valid = det.interior_valid.cpu().numpy()
    pts = np.where(valid[..., None], det.interior_points.cpu().numpy(), 0.0)
    centers = det.interior_centers.cpu().numpy()
    single = {"phase": wave_ops.wave_velocity_phase_mm_per_ms(mesh, phase, 1.0 / SFREQ),
              "amplitude": wave_ops.wave_velocity_amplitude(mesh, pot, 1.0 / SFREQ),
              "winding": winding.analyze_singularities_movie(mesh, v_world, pts, valid,
                                                            centers=centers)}

    def sharded():
        field, counts = sharded_detect_with_counts(mesh, v_world, dm, speed=speed,
                                                   v_max=v_max)
        return (field, counts,
                sharded_wave_velocity(mesh, phase, 1.0 / SFREQ, dm, method="phase"),
                sharded_wave_velocity(mesh, pot, 1.0 / SFREQ, dm, method="amplitude"),
                sharded_winding_movie(mesh, v_world, pts, valid, dm, centers=centers))

    (field, counts, ph, amp, wind), _ = _counted_layout(comm, sharded)
    verdict = {
        "masks": all(torch.equal(a, b) for a, b in (
            (field.vertex_mask, field1.vertex_mask),
            (field.interior_mask, field1.interior_mask), (field.counts, field1.counts))),
        "counts": torch.equal(counts, counts1),
        "floats": [same_floats(a.cpu().numpy(), b.cpu().numpy()) for a, b in (
            (field.interior_bary, field1.interior_bary),
            (field.interior_point, field1.interior_point), (field.v_max, field1.v_max))],
        "phase": same_floats(ph.cpu().numpy(), single["phase"].cpu().numpy()),
        "amplitude": same_floats(amp.cpu().numpy(), single["amplitude"].cpu().numpy()),
        "winding_discrete": (torch.equal(wind.counts, single["winding"].counts)
                             and torch.equal(wind.types, single["winding"].types)),
        "winding_numbers": same_floats(wind.winding_numbers.numpy(),
                                       single["winding"].winding_numbers.numpy()),
        "rows": int(valid.sum()), "detections": int(field.counts.sum())}
    return {"verdict": verdict, "launches": _gathered_launches(comm, DIST_ANALYSIS_KERNELS)}


def tree_pairs(got_root: Path, want_root: Path) -> list:
    """(label, kind, got, want) for every artifact file of a results tree
    (inputs left out), by its name; the two trees must hold the same files."""
    inputs = (".ply", ".json", ".tsv")

    def artifacts(root):
        return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()
                and p.suffix not in inputs and "interpolation" not in p.name
                and not p.name.endswith("-ave.csv")}

    got, want = artifacts(got_root), artifacts(want_root)
    if got != want:
        raise AssertionError(f"[dist] artifact files differ: {sorted(got ^ want)[:10]}")
    kinds = (("_e.csv", "csv"), ("-V_k.csv", "csv"), ("singularity_points.pkl", "points"),
             ("winding_lines.pkl.bz2", "winding"), ("data_01.npz", "npz"),
             ("streamlines_", "lines"), ("wave_velocity", "array"))
    pairs = []
    for rel in sorted(want):
        kind = next((k for pat, k in kinds if pat in rel), None)
        if kind is None:
            raise AssertionError(f"[dist] no comparison for artifact {rel}")
        pairs.append((rel, kind, got_root / rel, want_root / rel))
    return pairs


def run_dist(mesh12, pot12, times12, v_ref12, res12, keep: Path) -> None:
    """[dist]: the multi-device layer (parallel) on one card. First, in this
    process, a world of 1 over NCCL: halo_compute_velocity_fields (float64,
    tol 1e-8) and halo_refined_velocity_fields (tol 1e-6) with a mesh axis
    of 1 on the 12.5k problem. Then 2 and 4 spawned ranks that share cuda:0
    over gloo (their collectives staged through pinned host memory): the
    refined solve (tol 1e-6, precond 'auto': two-level) at (frames, mesh) =
    (2, 1), (1, 2), (1, 4), (2, 2), the float64 cg at tol 1e-8 at (1, 4),
    the analysis ops at (4, 1) against the single-GPU ops, and
    run_batch(distributed=True) over 2 ranks on a copy of [batch]'s tree.
    Every frame must converge, the refined RMSE against spsolve (2 frames)
    stay under the gate, the cg iterations within 2 of the single GPU's,
    every rank hold the same result and launch K1-K4 and K8-K11, the
    analysis outputs equal the single-GPU ones and the batch artifacts
    [batch]'s. The ranks share one GPU, so nothing here speaks of scaling."""
    import torch.distributed as dist

    from manifold_flow_tpu_torch.kernels import LAUNCHES, reset_launches
    from manifold_flow_tpu_torch.parallel import (
        halo_compute_velocity_fields,
        halo_refined_velocity_fields,
        make_device_mesh,
        multihost,
    )
    from manifold_flow_tpu_torch.parallel import comm as pcomm

    v_single = res12.v_k.cpu().numpy()
    scale = float(np.abs(v_single).max())
    res_cg1 = solve(mesh12, pot12, times12, method="cg", tol=1e-8, max_iter=4000)
    v_cg1 = res_cg1.v_k.cpu().numpy()

    def gate(name, v, converged, want):
        if not converged:
            raise AssertionError(f"[dist] {name}: not every frame converged")
        rmse = float(np.sqrt(np.mean((v[: v_ref12.shape[0]] - v_ref12) ** 2))
                     / max(float(np.abs(v_ref12).max()), 1e-30))
        if not rmse < RMSE_GATE:
            raise AssertionError(f"[dist] {name}: RMSE vs spsolve {rmse:.3e} >= {RMSE_GATE}")
        return rmse, float(np.abs(v - want).max())

    # 1. A world of one over NCCL.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(str(Path(tmp) / "store"), 1),
                                rank=0, world_size=1)
        try:
            dm = make_device_mesh(1, 1, device=mesh12.device)
            if dm.comm("mesh").backend != "nccl":
                raise AssertionError(f"[dist] NCCL world: {dm.comm('mesh')}")
            lines = []
            for name, fn, kwargs, kernels, want, iters in (
                    ("halo cg float64 tol 1e-8", halo_compute_velocity_fields,
                     dict(tol=1e-8, max_iter=4000), DIST_CG_KERNELS, v_cg1,
                     res_cg1.iterations),
                    ("halo refined tol 1e-6", halo_refined_velocity_fields,
                     dict(tol=1e-6, max_iter=4000), DIST_REFINED_KERNELS, v_single,
                     res12.iterations)):
                torch.cuda.synchronize()
                reset_launches()
                pcomm.reset_staged()
                res = fn(mesh12, pot12, times12, dm, **kwargs)
                torch.cuda.synchronize()
                idle = [k for k in kernels if LAUNCHES[k] == 0]
                if idle or any(pcomm.STAGED_BYTES.values()):
                    raise AssertionError(f"[dist] NCCL {name}: kernels never launched "
                                         f"{idle}, staged {pcomm.STAGED_BYTES}")
                rmse, dv = gate(f"NCCL {name}", res.v_k.cpu().numpy(),
                                bool(res.converged.all()), want)
                lines.append(f"{name}: {res.iterations} iterations (one GPU {iters}), "
                             f"RMSE vs spsolve {rmse:.3e}, max|dv| vs one GPU {dv:.3e} "
                             f"(tol x max|v| {kwargs['tol'] * scale:.3e}), 0 bytes "
                             f"staged; launches " + ", ".join(
                                 f"{k}={LAUNCHES[k]}" for k in kernels))
        finally:
            dist.destroy_process_group()
    print(f"[dist] world of 1 over NCCL, (frames, mesh) = (1, 1), {mesh12.n_vertices} "
          f"vertices x {pot12.shape[0] - 1} frames: " + "; ".join(lines), flush=True)

    # 2-4. Ranks that share the card over gloo.
    tree = keep / "dist_tree"
    shutil.copytree(keep / "batch_tree", tree)
    for p in tree.rglob("*"):
        if p.is_file() and not (p.suffix in (".ply", ".json", ".tsv")
                                or "interpolation" in p.name or p.name.endswith("-ave.csv")):
            p.unlink()
    # Ranks share cuda:0 over gloo; a rank's exception, or a rank that
    # outlives DIST_TIMEOUT_S, fails the phase (every rank stopped first).
    two = multihost.spawn(_dist_rank, 2, (str(tree),), timeout=DIST_TIMEOUT_S, threads=2,
                          cuda_device=0)
    four = multihost.spawn(_dist_rank, 4, (None,), timeout=DIST_TIMEOUT_S, threads=2,
                           cuda_device=0)
    for ranks in (two, four):
        for (nf, nm), lay in ranks[0]["layouts"].items():
            tag = f"({nf}, {nm})"
            if any(r["layouts"][(nf, nm)]["digest"] != lay["digest"] for r in ranks):
                raise AssertionError(f"[dist] refined {tag}: ranks hold different results")
            idle = [(i, k) for i, counts in enumerate(lay["launches"])
                    for k, n in counts.items() if n == 0]
            if idle:
                raise AssertionError(f"[dist] refined {tag}: launched no time: {idle}")
            rmse, dv = gate(f"refined {tag}", lay["v_k"], lay["converged"], v_single)
            per_rank = "; ".join(
                f"rank {i}: " + ", ".join(f"{k}={n}" for k, n in counts.items())
                for i, counts in enumerate(lay["launches"]))
            print(f"[dist] refined tol 1e-6 at (frames, mesh) = {tag}, {len(ranks)} ranks "
                  f"sharing one GPU over gloo: every frame converged, inner iterations "
                  f"{lay['iterations']} (one GPU {res12.iterations}), RMSE vs spsolve "
                  f"{rmse:.3e} (gate {RMSE_GATE:.0e}), max|dv| vs one GPU {dv:.3e} "
                  f"(tol x max|v| {1e-6 * scale:.3e}), every rank the same v_k; staged "
                  f"through host {max(r['layouts'][(nf, nm)]['staged'] for r in ranks)} "
                  f"bytes a rank (most); launches {per_rank}", flush=True)
    cg = four[0]["cg"]
    if any(r["cg"]["digest"] != cg["digest"] for r in four):
        raise AssertionError("[dist] cg (1, 4): ranks hold different results")
    idle = [(i, k) for i, c in enumerate(cg["launches"]) for k, n in c.items() if n == 0]
    if idle or abs(cg["iterations"] - res_cg1.iterations) > 2:
        raise AssertionError(f"[dist] cg (1, 4): iterations {cg['iterations']} against "
                             f"{res_cg1.iterations}, idle {idle}")
    rmse, dv = gate("cg (1, 4)", cg["v_k"], cg["converged"], v_cg1)
    print(f"[dist] float64 cg tol 1e-8 at (1, 4): {cg['iterations']} iterations (one GPU "
          f"{res_cg1.iterations}, within 2), RMSE vs spsolve {rmse:.3e}, max|dv| vs one "
          f"GPU {dv:.3e} (tol x max|v| {1e-8 * scale:.3e}); staged "
          f"{max(r['cg']['staged'] for r in four)} bytes a rank; launches on every "
          f"rank: " + "; ".join(", ".join(f"{k}={n}" for k, n in c.items())
                                for c in cg["launches"][:1]), flush=True)
    an = four[0]["analysis"]
    v = an["verdict"]
    floats = [v["phase"], v["amplitude"], v["winding_numbers"], *v["floats"]]
    idle = [(i, k) for i, c in enumerate(an["launches"]) for k, n in c.items() if n == 0]
    if (not (v["masks"] and v["counts"] and v["winding_discrete"]) or None in floats
            or idle or any(r["analysis"]["verdict"] != v for r in four)):
        raise AssertionError(f"[dist] analysis at (4, 1): {v}, idle {idle}")
    print(f"[dist] analysis at (4, 1) on the 12.5k refined field: sharded_detect_with_counts "
          f"masks, per-frame and movie counts equal ({v['detections']} candidates), "
          f"bary / points / v_max {v['floats']}; sharded_wave_velocity phase {v['phase']}, "
          f"amplitude {v['amplitude']}; sharded_winding_movie ({v['rows']} slots) counts and "
          f"types equal, winding numbers {v['winding_numbers']} (floats within "
          f"{BATCH_TOL:.0e} of the largest); launches "
          + "; ".join(f"rank {i}: " + ", ".join(f"{k}={n}" for k, n in c.items())
                      for i, c in enumerate(an["launches"])), flush=True)
    reports = [r["batch"] for r in two]
    if any(rep["errors"] for rep in reports) or [rep["shard"] for rep in reports] != [
            [0, 2], [1, 2]]:
        raise AssertionError(f"[dist] run_batch(distributed=True): {reports}")
    mine = [sorted(rep["trials"]) for rep in reports]
    verdict = summarize(compare_artifacts(tree_pairs(tree, keep / "batch_tree")))
    print(f"[dist] run_batch(distributed=True, ALL_STAGES) over 2 ranks on a copy of "
          f"[batch]'s tree: rank 0 ran {mine[0]}, rank 1 {mine[1]}, no errors; artifacts "
          f"against [batch]'s: {verdict}", flush=True)

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from manifold_flow_tpu_torch.kernels import LAUNCHES, library
    from manifold_flow_tpu_torch.kernels import analysis as kan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"[build] {library()._name}", flush=True)

    mesh, pot, times, truth = build_problem(device)
    t_v, n_dof = pot.shape[0] - 1, mesh.n_dof
    print(f"[problem] {mesh.n_vertices} vertices, {mesh.n_triangles} triangles,"
          f" {t_v} velocity frames", flush=True)
    checks = check_kernels(mesh, pot, times, card)

    # [slice]: the refined solve through the public API
    v_ref = spsolve_reference(mesh, pot, times, N_SAMPLE)
    refined = dict(method="refined", tol=1e-6, max_iter=4000)
    res, launches = counted_solve(mesh, pot, times, **refined)
    rmse = check_solution("refined", res, v_ref, t_v, n_dof)
    idle = [k for k in ("fem_matvec<float>", "fem_matvec<double>",
                        "jacobi_blocks<float>", "frame_factors_rhs<double>",
                        "pcg_dot<float>", "pcg_update<float>",
                        "pcg_direction<float>") if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels of the refined path never launched: {idle}")
    print(f"[slice] refined: inner iterations {res.iterations} "
          f"({band(res.iterations, 84)}), all "
          f"{t_v} frames converged, RMSE vs spsolve ({N_SAMPLE} frames) "
          f"{rmse:.3e} (gate {RMSE_GATE:.0e}); launches "
          + ", ".join(f"{k}={launches[k]}" for k in sorted(launches) if launches[k]),
          flush=True)

    # The analysis kernels on the refined solve's field: K5-K7, then K12-K15
    # (f64 and f32; K14 on integers); K16-K17 at the field stages' shapes.
    check_analysis_kernels(checks, mesh, res.v_k)
    for dtype in (torch.float64, torch.float32):
        check_trial_kernels(checks, mesh, *kan.recombine_speed(
            res.v_k.to(dtype), mesh.basis.to(dtype)))
    check_field_kernels(checks, mesh, pot)

    # The stages through the command line, then the same inputs through
    # pipeline.batch in this process and the batch CLI in a fresh one.
    keep = tempfile.TemporaryDirectory(prefix="chip_smoke_v_k_")
    kept = Path(keep.name)
    flow_launches = run_flow(mesh, pot, truth, keep_v_k=kept / "V_k.csv")
    trial_launches = run_trial(mesh, pot, workdir=kept / "trial")
    fields_launches = run_fields(mesh, kept / "V_k.csv", workdir=kept / "fields")
    recon_launches = run_batch_phase(checks, mesh, pot, kept)

    # [cg]: the cg method in float64
    res_cg, launches_cg = counted_solve(mesh, pot, times, method="cg", tol=1e-8,
                                        max_iter=4000)
    rmse_cg = check_solution("cg", res_cg, v_ref, t_v, n_dof)
    idle = [k for k in ("fem_matvec<double>", "jacobi_blocks<double>",
                        "frame_factors_rhs<double>", "pcg_dot<double>",
                        "pcg_update<double>", "pcg_direction<double>")
            if launches_cg[k] == 0]
    if idle:
        raise AssertionError(f"kernels of the cg path never launched: {idle}")
    print(f"[cg] float64 cg: iterations {res_cg.iterations}, all frames converged,"
          f" RMSE vs spsolve {rmse_cg:.3e}", flush=True)

    run_anchor(mesh, pot, times, v_ref)
    run_profiling(mesh, pot, times)

    # The kernels at the 12.5k shapes
    mesh12, pot12, times12, truth12 = build_problem_12k(device)
    print(f"[problem] {mesh12.n_vertices} vertices, {mesh12.n_triangles} "
          f"triangles, {pot12.shape[0] - 1} velocity frames", flush=True)
    check_coarse_kernels(checks, mesh12, pot12, times12)
    res12 = solve(mesh12, pot12, times12, **refined)
    check_analysis_kernels(checks, mesh12, res12.v_k, suffix="@12.5k",
                           dtypes=(torch.float64,))
    check_trial_kernels(checks, mesh12, *kan.recombine_speed(res12.v_k, mesh12.basis),
                        suffix="@12.5k")
    check_field_kernels(checks, mesh12, pot12, suffix="@12.5k")

    v_ref12 = spsolve_reference(mesh12, pot12, times12, 2)
    twolevel_launches = run_twolevel(mesh12, pot12, times12, v_ref12, mesh, pot, times)

    # [precise]: K3's and K11's float32 instances with float64 sums, then
    # float32 cg solves through them at both sizes
    check_precise_kernels(checks, mesh, pot, times)
    check_precise_kernels(checks, mesh12, pot12, times12, suffix="@12.5k")
    precise_launches = run_precise(
        {"3.1k": (*build_problem(device, np.float32)[:3], v_ref),
         "12.5k": (*build_problem_12k(device, np.float32)[:3], v_ref12)},
        (mesh, pot, times))

    # The stages through the command line and pipeline.batch at 12.5k
    flow12k_launches = run_flow(mesh12, pot12, truth12, tag="flow12k",
                                kernels=FLOW12K_KERNELS, cell=60.0 / 111.0,
                                keep_v_k=kept / "V_k12.csv")
    trial12k_launches = run_trial(mesh12, pot12, tag="trial12k", workdir=kept / "trial12k")
    # At 12.5k cuSOLVER's float64 SVD of the (97, 25088) movie runs an LU
    # kernel of its own (getrf_square_cta, printed); the fit runs none.
    fields12k_launches = run_fields(mesh12, kept / "V_k12.csv", tag="fields12k",
                                    demo=False, lu_free=False, workdir=kept / "fields12k")
    run_batch12k(pot12, kept)
    run_viz(mesh, kept)
    run_dist(mesh12, pot12, times12, v_ref12, res12, kept)
    keep.cleanup()

    run_long(mesh)
    cholesky_launches = run_cholesky(mesh, pot, times, v_ref, res_cg.v_k)

    # Each row's launches: from the phases that run the default config (the
    # flow CLIs, the trials and the field stages, at the row's own size
    # first; each field variant counted in the call that launches it), else
    # from the precise solves (of the row's size first), [twolevel]'s
    # float64 cg, [cg] or [cholesky]. Every kernel must have launched in
    # some phase.
    default_3k = (flow_launches, trial_launches, fields_launches)
    default_12k = (flow12k_launches, trial12k_launches, fields12k_launches)
    others = (twolevel_launches, launches_cg, cholesky_launches)

    def phases_of(label: str) -> tuple:
        at_12k = label.endswith("@12.5k") or (label.startswith("coarse_")
                                              and not label.endswith("@3.1k"))
        sizes = ("12.5k", "3.1k") if at_12k else ("3.1k", "12.5k")
        if label.endswith("@recon"):  # the reconstructed surface's trial in [batch]
            first = (recon_launches,)
        else:
            first = default_12k + default_3k if at_12k else default_3k + default_12k
        return first + tuple(precise_launches[size] for size in sizes) + others

    driven = {k: next((c[row["launches_key"]] for c in phases_of(k)
                       if c.get(row["launches_key"], 0) > 0), 0)
              for k, row in checks.rows.items()}
    names = {row["launches_key"].split("<")[0] for k, row in checks.rows.items()
             if driven[k] > 0}
    every = {k.split("<")[0] for k in LAUNCHES}
    if names != every:  # K1-K17: K3, K14 and K17 are several entry points
        raise AssertionError(f"kernels never launched by any phase: {sorted(every - names)}")
    print("[kernels] rows whose device time is not measured (no two whole profiler "
          "windows; device_us and bound_over_device null in the JSON line): "
          + (", ".join(k for k, row in checks.rows.items() if row["device_us"] is None)
             or "none"), flush=True)
    print("[kernels] rows of instances no phase launches (0 launches, left out of the "
          "JSON line): " + (", ".join(k for k in checks.rows if driven[k] == 0)
                            or "none"), flush=True)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": row["source"],
         "replaces": row["replaces"], "launches": driven[k],
         "max_abs_err": row["max_abs_err"], "ms": row["ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "device_us": row["device_us"],
         "bound_over_device": row["bound_over_device"]}
        for k, row in checks.rows.items() if driven[k] > 0]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
