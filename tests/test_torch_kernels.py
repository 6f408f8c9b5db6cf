"""The port's CUDA kernels against their plain torch versions, on a GPU.

These tests need an NVIDIA GPU and nvcc (a CUDA kernel has no CPU mode) and
skip without one. They import no JAX, so on a machine with a GPU and no JAX
they run without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances, relative to each output's largest entry: 1e-5 in float32 (the
kernels contract a*b+c into fused multiply-adds and sum in another order)
and 1e-12 in float64. The analysis kernels (K5-K7) round every operation
separately, in the plain versions' order, so their masks, counts, ids and
snapped centers must be equal.
"""

import numpy as np
import pytest
import torch

from manifold_flow_tpu_torch import compute_velocity_fields, kernels
from manifold_flow_tpu_torch.fem import assembly
from manifold_flow_tpu_torch.fem.operator import make_operator
from manifold_flow_tpu_torch.geometry import synthetic
from manifold_flow_tpu_torch.kernels import analysis as kan
from manifold_flow_tpu_torch.kernels import fem as kfem
from manifold_flow_tpu_torch.ops import recombine
from manifold_flow_tpu_torch.ops import singularity as sing
from manifold_flow_tpu_torch.pipeline import stages
from manifold_flow_tpu_torch.pipeline.config import PipelineConfig
from manifold_flow_tpu_torch.solve.api import build_rhs

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _problem(device):
    mesh = synthetic.plane_patch(
        nx=12, ny=12, lx=6.0, ly=6.0, device=device,
        height=lambda x, y: 0.8 * np.exp(-((x - 3.0) ** 2 + (y - 3.0) ** 2) / 4.0))
    pot, times = synthetic.plane_wave_movie(mesh, n_frames=6)
    pot = pot + 0.05 * torch.from_numpy(
        np.random.default_rng(0).standard_normal(tuple(pot.shape))).to(device)
    return mesh, pot, times


def _assert_close(got, want, dtype):
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
        assert err <= TOL[dtype]


def _launched(name, dtype, fn):
    ctype = "float" if dtype == torch.float32 else "double"
    before = kernels.LAUNCHES[f"{name}<{ctype}>"]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[f"{name}<{ctype}>"] == before + 1
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_fem_kernels_match_plain(cuda, dtype):
    mesh, pot, times = _problem(cuda)
    base = assembly.gather_base_table(mesh)
    ff = (pot.to(dtype), pot.to(dtype), times.to(dtype), mesh.triangles,
          mesh.grad_w.to(dtype), mesh.basis.to(dtype), mesh.areas.to(dtype), base)
    got = _launched("frame_factors_rhs", dtype, lambda: kfem.frame_factors_rhs(*ff))
    _assert_close(got, kfem.plain_frame_factors_rhs(*ff), dtype)

    g, f = build_rhs(mesh, pot, times)
    op = make_operator(mesh, g, 0.01).astype(dtype)
    x = torch.randn(tuple(f.shape), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64).to(cuda, dtype)
    fd = f.to(dtype)
    mv = (x, op.dof, op.blocks2, op.g, op.w_scale, op.lambda_, op.gather_base)
    got = _launched("fem_matvec", dtype, lambda: kfem.fem_matvec(*mv))
    _assert_close([got], [kfem.plain_fem_matvec(*mv)], dtype)
    got = _launched("fem_matvec", dtype, lambda: kfem.fem_matvec(*mv, f=fd))
    want = kfem.plain_fem_matvec(*mv, f=fd)
    scale = float(fd.abs().max()) + float(kfem.plain_fem_matvec(*mv).abs().max())
    assert float((got - want).abs().max()) / scale <= TOL[dtype]

    jb = (op.g, assembly.corner_regularization(mesh, dtype).contiguous(),
          mesh.areas.to(dtype), op.lambda_, base)
    got = _launched("jacobi_blocks", dtype, lambda: kfem.jacobi_blocks(*jb))
    _assert_close([got], [kfem.plain_jacobi_blocks(*jb)], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pcg_kernels_match_plain(cuda, dtype):
    gen = torch.Generator().manual_seed(2)
    t, n = 5, 40

    def rand(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64).to(cuda, dtype)
    x, r, p, ap, z = (rand(t, 2 * n) for _ in range(5))
    dinv = rand(t, n, 2, 2)
    rz = rand(t).abs()
    pap = rand(t).abs()
    pap[1] = 0.0  # the zero guard
    got = _launched("pcg_dot", dtype, lambda: kfem.pcg_dot(p, ap))
    _assert_close([got], [kfem.plain_pcg_dot(p, ap)], dtype)

    outs = []
    for fn in (kfem.pcg_update, kfem.plain_pcg_update):
        xs, rs, zs = x.clone(), r.clone(), torch.empty_like(z)
        rz_new, rr = torch.empty_like(rz), torch.empty_like(rz)
        fn(xs, rs, zs, p, ap, dinv, rz, pap, rz_new, rr)
        outs.append((xs, rs, zs, rz_new, rr))
    torch.cuda.synchronize()
    _assert_close(outs[0], outs[1], dtype)
    torch.testing.assert_close(outs[0][0][1], x[1], rtol=0, atol=0)

    rz_old = rz.clone()
    rz_old[2] = 0.0  # the zero guard
    outs = []
    for fn in (kfem.pcg_direction, kfem.plain_pcg_direction):
        q = p.clone()
        fn(q, z, rz, rz_old)
        outs.append((q,))
    _assert_close(outs[0], outs[1], dtype)


@pytest.mark.parametrize("method", ["cg", "refined"])
def test_solve_on_cuda_matches_cpu(cuda, method):
    mesh, pot, times = _problem(cuda)
    kernels.reset_launches()
    got = compute_velocity_fields(mesh, pot, times, method=method, tol=1e-9)
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES[f"{k}<double>"] > 0
               for k in ("fem_matvec", "frame_factors_rhs", "pcg_dot"))
    want = compute_velocity_fields(mesh.to("cpu"), pot.cpu(), times.cpu(),
                                   method=method, tol=1e-9)
    assert bool(got.converged.all())
    assert abs(got.iterations - want.iterations) <= 2
    err = float((got.v_k.cpu() - want.v_k).abs().max()) / float(want.v_k.abs().max())
    assert err <= 1e-6


def test_auto_is_refined_on_cuda(cuda):
    mesh, pot, times = _problem(cuda)
    kernels.reset_launches()
    compute_velocity_fields(mesh, pot, times, method="auto", tol=1e-9)
    assert kernels.LAUNCHES["fem_matvec<float>"] > 0


def _flow_problem(device):
    """A generic (bumpy) surface: on a symmetric one the field's zeros sit on
    edges and vertices and detections flip on last-ulp differences."""
    mesh = synthetic.plane_patch(
        nx=16, ny=16, lx=10.0, ly=10.0, device=device,
        height=lambda x, y: 0.3 * np.sin(0.9 * x) * np.cos(0.7 * y))
    pot, times, _ = synthetic.two_source_movie(mesh, n_frames=5)
    return mesh, pot, times


def _assert_same(got, want, dtype):
    """Integer and bool outputs equal; floats within TOL of the largest
    finite entry, NaNs (the all-zero frame) in the same places."""
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if not a.is_floating_point():
            assert torch.equal(a, b)
            continue
        finite = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), finite) and finite.any()
        scale = max(float(b[finite].abs().max()), 1e-300)
        assert float((a[finite] - b[finite]).abs().max()) <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", DTYPES)
def test_analysis_kernels_match_plain(cuda, dtype):
    mesh, pot, times = _flow_problem(cuda)
    v_k = compute_velocity_fields(mesh, pot, times, method="cg", tol=1e-10).v_k
    v_k = torch.cat([v_k, torch.zeros_like(v_k[:1])]).to(dtype)  # + a zero frame
    basis, points = mesh.basis.to(dtype), mesh.points.to(dtype)
    got = _launched("recombine_speed", dtype, lambda: kan.recombine_speed(v_k, basis))
    want = kan.plain_recombine_speed(v_k, basis)
    _assert_same(got, want, dtype)
    assert float(got[2][-1]) == 0.0

    args = (points, mesh.triangles, *want, 1e-4)
    got = _launched("detect_singular", dtype, lambda: kan.detect_singular(*args))
    want = kan.plain_detect_singular(*args)
    _assert_same(got, want, dtype)
    vertex_mask, interior_mask, _, interior_point, counts = want
    assert int(counts[:-1, 1].min()) > 0 and int(counts[-1].abs().sum()) == 0

    for cap in (8, sing.capacity_for(*counts.amax(dim=0).tolist())):
        args = (vertex_mask, interior_mask, interior_point, points, cap)
        got = _launched("compact_detected", dtype, lambda: kan.compact_detected(*args))
        _assert_same(got, kan.plain_compact_detected(*args), dtype)


def test_flow_stage_on_cuda_matches_cpu(cuda):
    mesh, pot, times = _flow_problem(cuda)
    cfg = PipelineConfig()
    cfg.solver.tol = 1e-10
    cfg.solver.method = "refined"
    runs = []
    for m, p, t in ((mesh, pot, times), (mesh.to("cpu"), pot.cpu(), times.cpu())):
        kernels.reset_launches()
        vel = stages.velocity_stage(m, p, t, cfg)
        pts, _, centers = stages.singularity_stage(
            m, vel.v_world, cfg, speed=vel.speed, v_max=vel.v_max,
            return_centers=True)
        runs.append((vel, pts, centers, dict(kernels.LAUNCHES)))
    (vel, pts, centers, launches), (vel_c, pts_c, centers_c, launches_c) = runs
    assert all(launches[f"{k}<double>"] > 0 for k in (
        "recombine_speed", "detect_singular", "compact_detected", "fem_matvec"))
    assert set(launches_c.values()) == {0}
    assert vel.converged and vel_c.converged
    for a, b in ((vel.v_k, vel_c.v_k), (vel.v_world, vel_c.v_world),
                 (vel.speed, vel_c.speed)):
        assert float((a.cpu() - b).abs().max()) <= 1e-8 * float(b.abs().max())
    assert [len(p) for p in pts] == [len(p) for p in pts_c]
    assert sum(len(p) for p in pts) > 0
    for a, b, ca, cb in zip(pts, pts_c, centers, centers_c):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8)
        np.testing.assert_array_equal(ca, cb)


def test_public_ops_on_cuda_raise_or_launch(cuda):
    """Each public op of the flow stage, given CUDA tensors, launches its
    counted kernel or raises: none runs a plain version on the card. The
    counts that size the compaction are K6's own."""
    mesh, pot, times = _flow_problem(cuda)
    v_k = compute_velocity_fields(mesh, pot, times, method="cg", tol=1e-10).v_k

    def launched():
        torch.cuda.synchronize()
        out = {k: v for k, v in kernels.LAUNCHES.items() if v}
        kernels.reset_launches()
        return out

    kernels.reset_launches()
    v_world = recombine.velocity_to_world(v_k, mesh.basis)
    assert launched() == {"recombine_speed<double>": 1}
    v_world, speed, v_max = recombine.velocity_to_world_and_speed(v_k, mesh.basis)
    assert launched() == {"recombine_speed<double>": 1}
    with pytest.raises(ValueError, match="velocity_to_world_and_speed"):
        recombine.world_speed(v_world)
    with pytest.raises(ValueError, match="velocity_to_world_and_speed"):
        sing.detect(mesh, v_world)
    assert launched() == {}
    field, counts = sing.detect_with_counts(mesh, v_world, speed=speed,
                                            v_max=v_max)
    assert launched() == {"detect_singular<double>": 1}
    assert torch.equal(counts, field.counts.amax(dim=0))
    assert [int(c) for c in sing.detection_counts(field)] == counts.tolist()
    cap = sing.compact_capacity(field)
    assert cap == sing.capacity_for(*counts.tolist()) and launched() == {}
    rows = sing.compact_all(mesh, field, with_centers=True)
    assert launched() == {"compact_detected<double>": 1}
    assert len(rows) == v_k.shape[0] and sum(len(r[2]) for r in rows) > 0
    sing.compact_detected(mesh, field, capacity=cap)
    assert launched() == {"compact_detected<double>": 1}
