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
  9. kernels: K8-K11 (the two-level preconditioner) against their plain
     versions at the 12.5k-vertex shapes (bench.py:465-474's surface, 12544
     vertices, 98 frames of the two-source movie), float32 and float64,
     tolerances as in phase 3 (K8 reorders each entry's sum); times as in
     phase 3.
 10. twolevel: the 12.5k problem through compute_velocity_fields(method=
     'refined', tol=1e-6, max_iter=4000, precond='auto'): every frame
     converged, each of K8-K11 launched, RMSE against spsolve over 2 frames
     below 1e-5; prints inner iterations, the frames whose coarse inverse
     was zeroed, the cold call (aggregation included) and the warm best of
     3. Then the crossover: refined with two-level and with Jacobi at 12.5k
     and on the bench surface, and float64 cg with two-level at 12.5k.
 11. flow12k: the flow CLI with the default config on the 12.5k surface as
     PLY and its movie as .npy, checked as in phase 6, with K1-K11 launched.
 12. long: a 392-frame two-source movie on the bench surface, refined at tol
     1e-6 with frame_chunk='auto' (4 windows of 104) and None; both converge
     and meet the RMSE gate against spsolve on 8 frames across the windows'
     seams; max |dv| below 1e-5 * max|v|; prints the frames/s of each.
 13. cholesky: method='cholesky' on the bench problem: RMSE against
     spsolve, its largest difference from cg at tol 1e-8, its wall time.
 14. profile: device time per kernel and the device's busy share over one
     S3 chain: the refined solve, recombination, detection and compaction
     (torch.profiler); then the same over one warm 12.5k refined two-level
     solve.
Then one JSON line for the kernels (each launch count from the phase that
drives that kernel: the 12.5k flow CLI first), the card's name and power
limit, and a last JSON line {"ok": true, "device": {...}}.
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


def build_problem_12k(device):
    """bench.py:465-474's large surface (112x112 over 60x60, 12544 vertices)
    with bench.py:535-538's 98-frame two-source movie, on `device`."""
    from manifold_flow_tpu_torch.geometry import synthetic

    mesh = synthetic.plane_patch(
        nx=112, ny=112, lx=60.0, ly=60.0,
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


def check_coarse_kernels(checks: KernelChecks, mesh, pot, times) -> None:
    """Phase 9: K8-K11 against their plain versions at the 12.5k shapes, in
    float32 (the refined solve's inner preconditioner) and float64 (cg)."""
    from manifold_flow_tpu_torch.fem.operator import make_operator
    from manifold_flow_tpu_torch.kernels import coarse as kco
    from manifold_flow_tpu_torch.solve import coarse
    from manifold_flow_tpu_torch.solve.api import build_rhs

    cu = "manifold_flow_tpu_torch/csrc/coarse_kernels.cu"
    tables = coarse.build_tables(mesh)
    g64, _ = build_rhs(mesh, pot, times)
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
        r_blk = coarse.prolongation_blocks(mesh, tables, dtype)
        asm = (op.g, op.blocks2, r_blk, mesh.triangles,
               mesh.areas.to(dtype) / 12.0, op.lambda_, tables.asm_ptr,
               tables.asm_src, tables.asm_dst, tables.n_coarse)
        checks.compare(f"coarse_assemble<{ctype}>", cu,
                       "manifold_flow_tpu/kernels/reduce.py:103",
                       lambda: (kco.coarse_assemble(*asm),),
                       lambda: (kco.plain_coarse_assemble(*asm),), tol)
        pre = coarse.make_two_level(mesh, op.g, op.lambda_, tables)
        r, z = (torch.randn((t, n_dof), generator=gen, dtype=torch.float64)
                .to(pot.device, dtype) for _ in range(2))
        checks.compare(f"coarse_restrict<{ctype}>", cu,
                       "manifold_flow_tpu/solve/coarse.py:243",
                       lambda: (kco.coarse_restrict(r, pre.r_blk, pre.members),),
                       lambda: (kco.plain_coarse_restrict(r, pre.r_blk, pre.members),),
                       tol)
        rc = kco.plain_coarse_restrict(r, pre.r_blk, pre.members)
        checks.compare(f"coarse_gemv<{ctype}>", cu,
                       "manifold_flow_tpu/solve/coarse.py:267",
                       lambda: (kco.coarse_gemv(pre.ac_inv, rc),),
                       lambda: (kco.plain_coarse_gemv(pre.ac_inv, rc),), tol)
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
                                  bufs[1][0], r, yc, pre.r_blk, pre.agg, bufs[1][1])))


FLOW_KERNELS = ("fem_matvec<float>", "fem_matvec<double>", "jacobi_blocks<float>",
                "frame_factors_rhs<double>", "pcg_dot<float>", "pcg_update<float>",
                "pcg_direction<float>", "recombine_speed<double>",
                "detect_singular<double>", "compact_detected<double>")


def run_flow(mesh, pot, truth, card: str, tag: str = "flow",
             kernels=FLOW_KERNELS, cell: float = 60.0 / 55.0) -> dict:
    """The flow stage through the port's command line (phase 6 on the bench
    problem, phase 11 on the 12.5k surface); returns the launch counts of
    that run. `cell` is the grid spacing the source distances are given in."""
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

    per_frame = np.array(report["singularities_per_frame"])
    if per_frame.shape != (t_v,) or not (per_frame == [len(p) for p in pts]).all():
        raise AssertionError(f"singularities per frame: {per_frame}")
    truth = truth.cpu().numpy()
    near = [[float(np.linalg.norm(p - src, axis=-1).min()) / cell if len(p)
             else float("inf") for p in pts] for src in truth]
    tv = report["timings"]
    solve_s = tv["dispatch"] + tv["artifact_starts"] + tv["solve_wait"]
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
    print(f"[{tag}] wall {wall * 1e3:.2f} ms (whole CLI call, PLY and movie "
          f"load included): solve + recombine {solve_s * 1e3:.2f} ms (dispatch "
          f"{tv['dispatch'] * 1e3:.2f}, copy starts "
          f"{tv['artifact_starts'] * 1e3:.3f}, wait {tv['solve_wait'] * 1e3:.2f}),"
          f" detect + compact + singularity_points.pkl "
          f"{tv['singularity_stage'] * 1e3:.2f} ms, writes of e.csv, V_k.csv "
          f"and the speed pickle {tv['artifact_submits'] * 1e3:.2f} ms; "
          f"on {card}", flush=True)
    return launches


COARSE_KERNELS = ("coarse_assemble", "coarse_restrict", "coarse_gemv",
                  "coarse_prolong_dot")
FLOW12K_KERNELS = FLOW_KERNELS + tuple(f"{k}<float>" for k in COARSE_KERNELS)


def best_of(fn, runs: int = 3) -> float:
    """Best host wall time of fn() in seconds over `runs` calls."""
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def run_twolevel(mesh12, pot12, times12, mesh, pot, times, card: str) -> dict:
    """Phase 10: the 12.5k refined solve through compute_velocity_fields
    with precond='auto' (two-level), then the crossover: both
    preconditioners at 12.5k and on the bench surface, and a float64 cg
    two-level solve at 12.5k. Returns the launch counts of that cg solve
    (the phase that drives the float64 coarse kernels)."""
    from manifold_flow_tpu_torch.solve import coarse
    from manifold_flow_tpu_torch.solve.api import TWO_LEVEL_MIN_VERTICES

    refined = dict(method="refined", tol=1e-6, max_iter=4000)
    t_v = pot12.shape[0] - 1
    v_ref = spsolve_reference(mesh12, pot12, times12, 2)
    # The cold call builds the aggregation tables (host) of a mesh whose
    # tables are not cached yet.
    t0 = time.perf_counter()
    res, launches = counted_solve(mesh12, pot12, times12, precond="auto", **refined)
    cold = time.perf_counter() - t0
    rmse = check_solution("twolevel 12.5k", res, v_ref, t_v, mesh12.n_dof)
    idle = [k for k in COARSE_KERNELS if launches[f"{k}<float>"] == 0]
    if idle:
        raise AssertionError(f"coarse kernels of the 12.5k refined solve never "
                             f"launched: {idle}")
    tables = coarse.build_tables(mesh12)  # the cached tables the solve used
    warm = best_of(lambda: solve(mesh12, pot12, times12, precond="auto", **refined))
    print(f"[twolevel] {mesh12.n_vertices} vertices x {t_v} frames, refined tol "
          f"1e-6, precond 'auto' (two-level from {TWO_LEVEL_MIN_VERTICES}): "
          f"inner iterations {res.iterations}, all frames converged, RMSE vs "
          f"spsolve (2 frames) {rmse:.3e} (gate {RMSE_GATE:.0e}); coarse space "
          f"{tables.n_coarse} aggregates; frames with a zeroed coarse inverse "
          f"{res.coarse_zeroed}; cold call {cold * 1e3:.2f} ms (aggregation included), "
          f"warm best of 3 {warm * 1e3:.2f} ms, {t_v / warm:.1f} frames/s; "
          f"launches " + ", ".join(f"{k}<float>={launches[f'{k}<float>']}"
                                   for k in COARSE_KERNELS) + f"; on {card}",
          flush=True)

    rows = []
    for name, (m, p, tt) in (("12.5k", (mesh12, pot12, times12)),
                             ("3.1k", (mesh, pot, times))):
        for precond in ("two_level", "jacobi"):
            kw = dict(precond=precond, **refined)
            r = solve(m, p, tt, **kw)
            if not bool(r.converged.all()):
                raise AssertionError(f"{precond} at {name} did not converge")
            best = best_of(lambda: solve(m, p, tt, **kw))
            rows.append(f"{name} {precond}: {r.iterations} inner iterations, "
                        f"{(p.shape[0] - 1) / best:.1f} frames/s "
                        f"({best * 1e3:.2f} ms)")
    print("[twolevel] crossover, refined tol 1e-6, best of 3 after a warm-up: "
          + "; ".join(rows) + f"; on {card}", flush=True)

    res_cg, launches_cg = counted_solve(mesh12, pot12, times12, method="cg",
                                        tol=1e-8, max_iter=4000, precond="two_level")
    rmse_cg = check_solution("cg two-level 12.5k", res_cg, v_ref, t_v, mesh12.n_dof)
    idle = [k for k in COARSE_KERNELS if launches_cg[f"{k}<double>"] == 0]
    if idle:
        raise AssertionError(f"coarse kernels of the 12.5k cg solve never "
                             f"launched: {idle}")
    best = best_of(lambda: solve(mesh12, pot12, times12, method="cg", tol=1e-8,
                                 max_iter=4000, precond="two_level"))
    print(f"[twolevel] float64 cg two-level at 12.5k, tol 1e-8: iterations "
          f"{res_cg.iterations}, all frames converged, RMSE vs spsolve "
          f"{rmse_cg:.3e}, {t_v / best:.1f} frames/s", flush=True)
    return launches_cg


def run_long(mesh, card: str) -> None:
    """Phase 12: a 392-frame two-source movie on the bench surface, solved
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
    best = {"auto": float("inf"), None: float("inf")}
    for _ in range(3):
        for chunk in best:
            t0 = time.perf_counter()
            solve(mesh, pot, times, frame_chunk=chunk, **kw)
            best[chunk] = min(best[chunk], time.perf_counter() - t0)
    dv = float((out["auto"].v_k - out[None].v_k).abs().max())
    vmax = float(out[None].v_k.abs().max())
    if not dv <= RMSE_GATE * vmax:
        raise AssertionError(f"392 frames: chunked and whole differ by {dv:.3e} "
                             f"> RMSE_GATE * max|v| {RMSE_GATE * vmax:.3e}")
    print(f"[long] {mesh.n_vertices} vertices x {t_v} velocity frames, refined "
          f"tol {tol:g}: both converged; chunked ({-(-t_v // FRAME_CHUNK_SIZE)} "
          f"windows of {FRAME_CHUNK_SIZE}) "
          f"{out['auto'].iterations} inner iterations (largest window), "
          f"{t_v / best['auto']:.1f} frames/s ({best['auto'] * 1e3:.2f} ms); "
          f"whole {out[None].iterations} inner iterations, "
          f"{t_v / best[None]:.1f} frames/s ({best[None] * 1e3:.2f} ms); RMSE "
          f"vs spsolve on {len(frames)} frames across the seams {rmse['auto']:.3e} "
          f"chunked, {rmse[None]:.3e} whole (gate {RMSE_GATE:.0e}); max |dv| "
          f"{dv:.3e} (bound RMSE_GATE * max|v| {RMSE_GATE * vmax:.3e}; tol * "
          f"max|v| {tol * vmax:.3e}); best of 3, in turns, on {card}", flush=True)


def run_cholesky(mesh, pot, times, v_ref, v_cg, card: str) -> dict:
    """Phase 13: method='cholesky' on the bench problem against spsolve and
    against the float64 cg solve at tol 1e-8; returns its launch counts."""
    t_v, n_dof = pot.shape[0] - 1, mesh.n_dof
    t0 = time.perf_counter()
    res, launches = counted_solve(mesh, pot, times, method="cholesky")
    first = time.perf_counter() - t0
    rmse = check_solution("cholesky", res, v_ref, t_v, n_dof)
    idle = [k for k in ("fem_matvec<double>", "frame_factors_rhs<double>")
            if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels of the cholesky path never launched: {idle}")
    best = best_of(lambda: solve(mesh, pot, times, method="cholesky"), runs=2)
    diff = float((res.v_k - v_cg).abs().max()) / float(v_cg.abs().max())
    print(f"[cholesky] {mesh.n_vertices} vertices x {t_v} frames (dense "
          f"{n_dof}x{n_dof} in f64, one frame at a time, 2 refinement steps): "
          f"all frames converged to tol 1e-10, RMSE vs spsolve {rmse:.3e} (gate "
          f"{RMSE_GATE:.0e}); max |v - v_cg| / max|v_cg| {diff:.3e} (cg tol "
          f"1e-8); wall {first * 1e3:.2f} ms first call, {best * 1e3:.2f} ms "
          f"best of 2, {t_v / best:.1f} frames/s; on {card}", flush=True)
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
    from manifold_flow_tpu_torch.kernels import LAUNCHES, library

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
    best = best_of(lambda: solve(mesh, pot, times, **refined))
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

    # 9. the two-level kernels at the 12.5k shapes
    mesh12, pot12, times12, truth12 = build_problem_12k(device)
    print(f"[problem] {mesh12.n_vertices} vertices, {mesh12.n_triangles} "
          f"triangles, {pot12.shape[0] - 1} velocity frames", flush=True)
    check_coarse_kernels(checks, mesh12, pot12, times12)

    # 10. the 12.5k refined solve with two-level, and the crossover
    twolevel_launches = run_twolevel(*build_problem_12k(device)[:3], mesh, pot,
                                     times, card)

    # 11. the flow stage through the command line at 12.5k: the slice's path
    flow12k_launches = run_flow(mesh12, pot12, truth12, card, tag="flow12k",
                                kernels=FLOW12K_KERNELS, cell=60.0 / 111.0)

    # 12. a 392-frame movie, in windows and whole
    run_long(mesh, card)

    # 13. the direct solver
    cholesky_launches = run_cholesky(mesh, pot, times, v_ref, res_cg.v_k, card)

    # 14. where the time goes in one S3 chain, and in the 12.5k two-level solve
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
    solve(mesh12, pot12, times12, **refined)  # warm: tables cached, kernels built
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(mesh12, pot12, times12, **refined)
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in events)
    if dev_us > 0:
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:14]
        print(f"[profile] 12.5k refined two-level solve (tol 1e-6): device busy "
              f"{dev_us / wall_us:.3f} of {wall_us / 1e3:.2f} ms wall (profiled "
              f"run); by kernel: " + "; ".join(
                  f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                  for e in top), flush=True)
    else:
        print("[profile] the profiler recorded no device time: not measured",
              flush=True)
    # Each kernel's launches from the phase that drives it: the 12.5k flow
    # CLI (the slice's path) first, then the bench flow, the float64 cg
    # two-level solve, the cg phase and the direct solver. Instances no path
    # launches (the float32 analysis kernels) are left out.
    phases = (flow12k_launches, flow_launches, twolevel_launches, launches_cg,
              cholesky_launches)
    driven = {k: next((c[k] for c in phases if c[k] > 0), 0) for k in checks.rows}
    names = {k.split("<")[0] for k, n in driven.items() if n > 0}
    every = {k.split("<")[0] for k in LAUNCHES}
    if names != every:  # K1-K11: K3 is three launches, pcg_dot/update/direction
        raise AssertionError(f"kernels never launched by any phase: {sorted(every - names)}")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": row["source"],
         "replaces": row["replaces"], "launches": driven[k],
         "max_abs_err": row["max_abs_err"], "ms": row["ms"],
         "plain_ms": row["plain_ms"]}
        for k, row in checks.rows.items() if driven[k] > 0]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
