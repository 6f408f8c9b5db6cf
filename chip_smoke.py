"""Smoke run of the PyTorch/CUDA port (manifold_flow_tpu_torch) on one GPU.

Run from the repository root, on a machine with an NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:
  1. device: requires CUDA; prints the card, its power limit, torch and CUDA.
  2. build: compiles the CUDA kernels from csrc/ with nvcc.
  3. kernels: each kernel of the solve against its plain torch version on the
     bench problem's shapes, with the tolerance stated; kernel and plain
     times (CUDA events around 20 back-to-back calls, median of 5 rounds).
  4. slice: the bench problem (3136 vertices, 97 velocity frames, lambda
     0.01) through compute_velocity_fields(method='refined', tol=1e-6);
     every frame must converge, every kernel of the path must have launched,
     and the RMSE against scipy spsolve over the first 6 frames, normalised
     by max|v_spsolve|, must be below 1e-5. Frames/s is the best of 3 timed
     runs after a warm-up.
  5. analysis kernels: K5-K7 (recombination, detection, compaction and
     snap) against their plain versions on the refined solve's velocity
     field, in float64 and float32: masks, ids, valid flags, counts and
     centers equal, floats to 1e-12 (f64) / 1e-5 (f32) of their largest
     entry; kernel and plain times as in phase 3.
  6. flow: the S3 flow stage through the port's command line
     (`pipeline.cli.main(["flow", ...])`, default config: method 'auto',
     which is 'refined' on CUDA for a float64 movie, tol 1e-8, max_iter
     2000) on the bench surface written as PLY and its 98-frame movie as
     .npy, with ConvergenceWarning raised as an error and every launch count
     set to 0 just before; every frame must converge, each of K1-K7 must
     have launched, and the four artifacts must reload equal to the same
     stages run in memory. Prints the singularities per frame, the distance
     of each true source to its nearest detection in grid cells, and the
     flow wall time split into solve, detect + compact and artifact writes.
  7. s3: S3 end-to-end frames/s as bench.py:235-255 defines it (refined
     solve at tol 1e-6, then recombination, speed map and detection, in
     float64, ending in torch.cuda.synchronize(); best of 3 after a
     warm-up), beside the solve alone, timed in turns.
  8. cg: the same problem with method='cg' in float64 at tol=1e-8.
  9. profile: device time per kernel and the device's busy share over one
     S3 chain: the refined solve, recombination, detection and compaction
     (torch.profiler).
Then one JSON line for the kernels of the flow path (launch counts from the
flow phase), the card's name and power limit, and a last JSON line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_SAMPLE = 6          # frames checked against spsolve (as bench.py does)
RMSE_GATE = 1e-5
TOL_F32 = 1e-5        # kernel vs plain, relative to the output's max |value|
TOL_F64 = 1e-12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Time per call of fn() in ms: CUDA events around `reps` back-to-back
    calls, the median over `rounds`, after a warm-up. A call whose host side
    (Python, ctypes, allocation) outlasts its kernels is timed at the host's
    launch rate; the profile phase gives the kernels' own device time."""
    fn()
    torch.cuda.synchronize()
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


def build_problem(device):
    """bench.py's problem (bench.py:26-38), built with the port on `device`:
    (mesh, potentials (98, N), times (98,), true sources (2, 3))."""
    from manifold_flow_tpu_torch.geometry import synthetic

    mesh = synthetic.plane_patch(
        nx=56, ny=56, lx=60.0, ly=60.0,
        height=lambda x, y: 6.0 * np.sin(x / 12.0) * np.cos(y / 15.0),
        dtype=np.float64, device=device)
    return mesh, *synthetic.two_source_movie(
        mesh, sources=((15.0, 15.0), (45.0, 45.0)), n_frames=98,
        speed=24.0, wavelength=24.0, dt=1.0 / 512.0, dtype=np.float64)


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


class KernelChecks:
    """Phase 3: each kernel against its plain version at the bench shapes."""

    def __init__(self):
        self.rows: dict[str, dict] = {}

    def compare(self, key: str, source: str, replaces: str, kernel, plain,
                tol: float, scales=None, timed=None) -> None:
        """Run kernel() and plain() on the same inputs and compare each
        output against its own scale (max |plain|, or `scales`), then time
        both, or the pair of calls `timed` (in-place kernels time without
        the copies their comparison needs). kernel and plain return a tuple
        of tensors."""
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        # Integer and bool outputs (masks, ids, counts, centers) must be
        # equal; float outputs agree to `tol` of their scale.
        exact = [torch.equal(a, b) for a, b in zip(got, want)
                 if not b.is_floating_point()]
        floats = [(a, b) for a, b in zip(got, want) if b.is_floating_point()]
        errs = [float((a - b).abs().max()) for a, b in floats]
        if scales is None:
            scales = [float(b.abs().max()) for _, b in floats]
        rel = max(e / max(s, 1e-300) for e, s in zip(errs, scales))
        err = max(errs)
        ok = (rel <= tol and all(exact)
              and all(bool(torch.isfinite(a).all()) for a, _ in floats))
        time_kernel, time_plain = timed or (kernel, plain)
        ms = time_ms(time_kernel)
        plain_ms = time_ms(time_plain)
        equal = f", {len(exact)} discrete outputs equal" if exact else ""
        print(f"[kernels] {key}: max_rel_err {rel:.3e} (tol {tol:.0e}){equal} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{key} disagrees with its plain version: "
                                 f"relative error {rel:.3e} > {tol:.0e}, "
                                 f"discrete outputs equal: {exact}")
        self.rows[key] = {"source": source, "replaces": replaces,
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_kernels(mesh, pot, times) -> KernelChecks:
    from manifold_flow_tpu_torch.fem import assembly
    from manifold_flow_tpu_torch.fem.operator import make_operator
    from manifold_flow_tpu_torch.kernels import fem as kfem
    from manifold_flow_tpu_torch.solve.api import build_rhs

    fem_cu = "manifold_flow_tpu_torch/csrc/fem_kernels.cu"
    pcg_cu = "manifold_flow_tpu_torch/csrc/pcg_kernels.cu"
    checks = KernelChecks()
    dev = pot.device
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, dtype=torch.float64).to(dev, dtype)

    # K4 frame factors + RHS (f64, as the refined path runs it).
    args = (pot, pot, times, mesh.triangles, mesh.grad_w, mesh.basis,
            mesh.areas, assembly.gather_base_table(mesh))
    checks.compare("frame_factors_rhs<double>", fem_cu,
                   "manifold_flow_tpu/fem/assembly.py:61",
                   lambda: kfem.frame_factors_rhs(*args),
                   lambda: kfem.plain_frame_factors_rhs(*args), TOL_F64)

    g64, f64 = build_rhs(mesh, pot, times)
    t, n_dof = f64.shape
    n = n_dof // 2
    ops = {torch.float64: make_operator(mesh, g64, 0.01)}
    ops[torch.float32] = ops[torch.float64].astype(torch.float32)
    for dtype, ctype, tol in ((torch.float32, "float", TOL_F32),
                              (torch.float64, "double", TOL_F64)):
        op = ops[dtype]
        x = rand(t, n_dof, dtype=dtype)
        mv = (x, op.dof, op.blocks2, op.g, op.w_scale, op.lambda_, op.gather_base)
        if dtype == torch.float32:  # the inner-solve matvec
            checks.compare(f"fem_matvec<{ctype}>", fem_cu,
                           "manifold_flow_tpu/fem/operator.py:69",
                           lambda: (kfem.fem_matvec(*mv),),
                           lambda: (kfem.plain_fem_matvec(*mv),), tol)
        else:  # the refinement residual f - A x, scaled by max|f| + max|Ax|
            fr = f64.to(dtype)
            ax = kfem.plain_fem_matvec(*mv)
            scale = float(fr.abs().max()) + float(ax.abs().max())
            checks.compare(f"fem_matvec<{ctype}>", fem_cu,
                           "manifold_flow_tpu/fem/df_operator.py:66",
                           lambda: (kfem.fem_matvec(*mv, f=fr),),
                           lambda: (kfem.plain_fem_matvec(*mv, f=fr),), tol,
                           scales=[scale])

        reg = assembly.corner_regularization(mesh, dtype).contiguous()
        jb = (op.g, reg, mesh.areas.to(dtype), op.lambda_, op.gather_base)
        checks.compare(f"jacobi_blocks<{ctype}>", fem_cu,
                       "manifold_flow_tpu/fem/assembly.py:164",
                       lambda: (kfem.jacobi_blocks(*jb),),
                       lambda: (kfem.plain_jacobi_blocks(*jb),), tol)

        # PCG vector kernels on one iteration's worth of real state.
        dinv = kfem.plain_jacobi_blocks(*jb)
        p = rand(t, n_dof, dtype=dtype)
        ap = kfem.plain_fem_matvec(p, *mv[1:])
        checks.compare(f"pcg_dot<{ctype}>", pcg_cu,
                       "manifold_flow_tpu/solve/cg.py:30",
                       lambda: (kfem.pcg_dot(p, ap),),
                       lambda: (kfem.plain_pcg_dot(p, ap),), tol)
        state = [rand(t, n_dof, dtype=dtype) for _ in range(2)]  # x, r
        rz = rand(t, dtype=dtype).abs()
        pap = kfem.plain_pcg_dot(p, ap)

        def update(fn):
            x, r = (s.clone() for s in state)
            z = torch.empty_like(x)
            rz_new, rr = torch.empty_like(rz), torch.empty_like(rz)
            fn(x, r, z, p, ap, dinv, rz, pap, rz_new, rr)
            return x, r, z, rz_new, rr
        bufs = [[s.clone() for s in state] + [torch.empty_like(p)]
                + [torch.empty_like(rz) for _ in range(2)] for _ in range(2)]

        def update_in_place(fn, b):
            return lambda: fn(b[0], b[1], b[2], p, ap, dinv, rz, pap, b[3], b[4])
        checks.compare(f"pcg_update<{ctype}>", pcg_cu,
                       "manifold_flow_tpu/solve/cg.py:89",
                       lambda: update(kfem.pcg_update),
                       lambda: update(kfem.plain_pcg_update), tol,
                       timed=(update_in_place(kfem.pcg_update, bufs[0]),
                              update_in_place(kfem.plain_pcg_update, bufs[1])))
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
                              lambda: kfem.plain_pcg_direction(qs[1], z, rz_new, rz)))
    return checks


def check_analysis_kernels(checks: KernelChecks, mesh, v_k) -> None:
    """Phase 5: K5-K7 against their plain versions on a real velocity field
    (the refined solve's v_k), in float64 and float32."""
    from manifold_flow_tpu_torch.kernels import analysis as kan
    from manifold_flow_tpu_torch.ops.singularity import capacity_for

    cu = "manifold_flow_tpu_torch/csrc/analysis_kernels.cu"
    for dtype, ctype, tol in ((torch.float64, "double", TOL_F64),
                              (torch.float32, "float", TOL_F32)):
        vk, basis = v_k.to(dtype), mesh.basis.to(dtype)
        points = mesh.points.to(dtype)
        checks.compare(f"recombine_speed<{ctype}>", cu,
                       "manifold_flow_tpu/ops/recombine.py:20",
                       lambda: kan.recombine_speed(vk, basis),
                       lambda: kan.plain_recombine_speed(vk, basis), tol)
        v_world, speed, v_max = kan.plain_recombine_speed(vk, basis)
        det = (points, mesh.triangles, v_world, speed, v_max, 1e-4)
        checks.compare(f"detect_singular<{ctype}>", cu,
                       "manifold_flow_tpu/ops/singularity.py:54",
                       lambda: kan.detect_singular(*det),
                       lambda: kan.plain_detect_singular(*det), tol)
        vmask, imask, _, ipoint, counts = kan.plain_detect_singular(*det)
        cap = capacity_for(*counts.amax(dim=0).tolist())
        print(f"[kernels] {ctype}: per-frame candidates max (vertex, interior)"
              f" {counts.amax(dim=0).tolist()}, capacity {cap}", flush=True)
        comp = (vmask, imask, ipoint, points, cap)
        checks.compare(f"compact_detected<{ctype}>", cu,
                       "manifold_flow_tpu/ops/singularity.py:394",
                       lambda: kan.compact_detected(*comp),
                       lambda: kan.plain_compact_detected(*comp), tol)


FLOW_KERNELS = ("fem_matvec<float>", "fem_matvec<double>", "jacobi_blocks<float>",
                "frame_factors_rhs<double>", "pcg_dot<float>", "pcg_update<float>",
                "pcg_direction<float>", "recombine_speed<double>",
                "detect_singular<double>", "compact_detected<double>")


def run_flow(mesh, pot, truth, card: str) -> dict:
    """Phase 6: the flow stage through the port's command line on the bench
    problem; returns the launch counts of that run."""
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
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(stdout):
                rc = cli.main(argv)
            wall = time.perf_counter() - t0
            launches = dict(LAUNCHES)
        report = json.loads(stdout.getvalue().strip().splitlines()[-1])
        if (rc != 0 or not report["converged"]
                or not report["device"].startswith(mesh.device.type)):
            raise AssertionError(f"flow CLI: rc {rc}, report {report}")
        idle = [k for k in FLOW_KERNELS if launches[k] == 0]
        if idle:
            raise AssertionError(f"kernels of the flow path never launched: {idle}")

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
        if v_k_file.shape != (t_v, fmesh.n_dof):  # (97, 6272) at the bench size
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

    per_frame = np.array(report["singularities_per_frame"])
    if per_frame.shape != (t_v,) or not (per_frame == [len(p) for p in pts]).all():
        raise AssertionError(f"singularities per frame: {per_frame}")
    cell = 60.0 / 55.0
    truth = truth.cpu().numpy()
    near = [[float(np.linalg.norm(p - src, axis=-1).min()) / cell if len(p)
             else float("inf") for p in pts] for src in truth]
    tv = report["timings"]
    solve_s = tv["dispatch"] + tv["artifact_starts"] + tv["solve_wait"]
    print(f"[flow] cli flow on {fmesh.n_vertices} vertices x {movie.shape[0]} "
          f"frames: all {t_v} frames converged, {report['iterations']} inner "
          f"iterations, V_k {v_k_file.shape}, artifacts reload equal to the "
          f"in-memory run; launches " + ", ".join(
              f"{k}={launches[k]}" for k in FLOW_KERNELS), flush=True)
    print(f"[flow] singularities per frame: min {per_frame.min()} median "
          f"{float(np.median(per_frame))} max {per_frame.max()}; nearest "
          "detection to each true source, grid cells (median / max over "
          "frames): " + "; ".join(
              f"source {i}: {float(np.median(d)):.3f} / {max(d):.3f}"
              for i, d in enumerate(near)), flush=True)
    print(f"[flow] wall {wall * 1e3:.2f} ms (whole CLI call, PLY and movie "
          f"load included): solve + recombine {solve_s * 1e3:.2f} ms (dispatch "
          f"{tv['dispatch'] * 1e3:.2f}, copy starts "
          f"{tv['artifact_starts'] * 1e3:.3f}, wait {tv['solve_wait'] * 1e3:.2f}),"
          f" detect + compact + singularity_points.pkl "
          f"{tv['singularity_stage'] * 1e3:.2f} ms, writes of e.csv, V_k.csv "
          f"and the speed pickle {tv['artifact_submits'] * 1e3:.2f} ms; "
          f"on {card}", flush=True)
    return launches


def s3_end_to_end(mesh, pot, times, card: str) -> None:
    """Phase 7: bench.py:235-255's S3 end-to-end frames/s, in float64,
    beside the solve alone; the two are timed in turns, best of 3 each."""
    from manifold_flow_tpu_torch.ops import singularity as sing
    from manifold_flow_tpu_torch.ops.recombine import velocity_to_world_and_speed

    refined = dict(method="refined", tol=1e-6, max_iter=4000)

    def s3():
        res = solve(mesh, pot, times, **refined)
        v_world, speed, v_max = velocity_to_world_and_speed(res.v_k, mesh.basis)
        sing.detect(mesh, v_world, speed=speed, v_max=v_max)
        torch.cuda.synchronize()

    def solve_only():
        solve(mesh, pot, times, **refined)

    s3()
    best = {"s3": float("inf"), "solve": float("inf")}
    for _ in range(3):
        for name, fn in (("s3", s3), ("solve", solve_only)):
            t0 = time.perf_counter()
            fn()
            best[name] = min(best[name], time.perf_counter() - t0)
    t_v = pot.shape[0] - 1
    print(f"[s3] S3 end-to-end frames/s {t_v / best['s3']:.1f} (best of 3: "
          f"{best['s3'] * 1e3:.2f} ms: refined solve tol 1e-6 + recombine + "
          f"speed + detect, float64); solve alone {t_v / best['solve']:.1f} "
          f"frames/s ({best['solve'] * 1e3:.2f} ms); on {card}", flush=True)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from manifold_flow_tpu_torch.kernels import library

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # 2. build
    t0 = time.perf_counter()
    lib = library()
    print(f"[build] {lib._name} in {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernels against their plain versions
    mesh, pot, times, truth = build_problem(device)
    t_v, n_dof = pot.shape[0] - 1, mesh.n_dof
    print(f"[problem] {mesh.n_vertices} vertices, {mesh.n_triangles} triangles,"
          f" {t_v} velocity frames", flush=True)
    checks = check_kernels(mesh, pot, times)

    # 4. the slice: the refined solve through the public API
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
    print(f"[slice] refined: inner iterations {res.iterations}, all "
          f"{t_v} frames converged, RMSE vs spsolve ({N_SAMPLE} frames) "
          f"{rmse:.3e} (gate {RMSE_GATE:.0e}); launches "
          + ", ".join(f"{k}={launches[k]}" for k in sorted(launches) if launches[k]),
          flush=True)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        solve(mesh, pot, times, **refined)
        best = min(best, time.perf_counter() - t0)
    print(f"[slice] refined frames/s {t_v / best:.1f} (best of 3: {best * 1e3:.2f} ms"
          f" per solve) on {card}", flush=True)

    # 5. the analysis kernels against their plain versions
    check_analysis_kernels(checks, mesh, res.v_k)

    # 6. the flow stage through the command line
    flow_launches = run_flow(mesh, pot, truth, card)

    # 7. S3 end to end
    s3_end_to_end(mesh, pot, times, card)

    # 8. the cg method in float64
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

    # 9. where the time goes in one S3 chain
    from torch.profiler import ProfilerActivity, profile

    from manifold_flow_tpu_torch.ops import singularity as sing
    from manifold_flow_tpu_torch.ops.recombine import velocity_to_world_and_speed

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = solve(mesh, pot, times, **refined)
        v_world, speed, v_max = velocity_to_world_and_speed(res.v_k, mesh.basis)
        field, counts = sing.detect_with_counts(mesh, v_world, speed=speed,
                                                v_max=v_max)
        sing.compact_detected(mesh, field, sing.capacity_for(*counts.tolist()))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in events)
    if dev_us > 0:
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
        mine = [e for e in events if any(
            k in e.key for k in ("recombine_speed", "detect_", "compact_detected"))]
        print(f"[profile] S3 chain (refined solve tol 1e-6, recombine, detect, "
              f"compact): device busy {dev_us / wall_us:.3f} of "
              f"{wall_us / 1e3:.2f} ms wall (profiled run); by kernel: " + "; ".join(
                  f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                  for e in top) + "; analysis kernels: " + "; ".join(
                  f"{e.key[:40]} {e.self_device_time_total:.1f} us x{e.count}"
                  for e in mine), flush=True)
    else:
        print("[profile] the profiler recorded no device time: not measured",
              flush=True)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": row["source"],
         "replaces": row["replaces"], "launches": flow_launches[k],
         "max_abs_err": row["max_abs_err"], "ms": row["ms"],
         "plain_ms": row["plain_ms"]}
        for k, row in checks.rows.items() if flow_launches[k] > 0]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
