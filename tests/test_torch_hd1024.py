"""The port on the `hd1024` deployment (flowbench/configs/hd1024.json): a
1024-channel 32 x 32 thin-film grid at 2 mm pitch and the surface S1
reconstructs from it, held against the benchmark's plain reference
(flowbench/reference, numpy and scipy in float64).

On the CPU the surface is S1's with one butterfly subdivision instead of
three (about 4.1k vertices instead of 65k: the grid, its Delaunay cells and
the smoothing are the deployment's), and the epoch is sampled at 256 Hz
instead of 2048 (49 window frames), so each case takes seconds. The full
surface's sizes are checked from its configuration. The `cuda` case holds
K17's fit at 1024 electrodes against the plain fit; it runs on a machine
with a GPU as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_hd1024.py -m cuda

Tolerances, each with its reason:
  * S2 amplitude: max |port - ref| / max |ref| <= 1e-9. Both sides solve the
    same float64 1024 x 1024 multiquadric system (condition ~4.9e6, 26x
    hd256's) by LU with partial pivoting and evaluate it in float64, summing
    in other orders; the port reads 6.4e-12 here, the reference computed in
    float32 2.9e-3.
  * S2 phases: the largest wrapped angle gap <= 1e-8 rad: the same fit of
    the two planes of e^{i phi}, and an angle taken of their interpolant,
    which amplifies the planes' rounding where the interpolant is small
    (1.5e-11 read here; 6.5e-3 in float32).
  * S3 velocity: |port - ref| / |ref| of each sampled frame's world vectors
    <= 1e-8: the port's PCG stops at a relative residual of 1e-10 (the
    refined solve's outer loop at 1e-8), the reference solves directly, and
    the gap is that residual times the system's conditioning (5.4e-11 for
    `cg`, 2.7e-10 for `refined` read here).
  * K17 on the card: hd256's tolerances. A W = B to 1e-12 of max |A| |W|
    (the backward error of an LU solve in float64: the plain fit reads
    5.7e-17 here), and the interpolant of the kernel's weights against the
    plain fit's to 1e-12 of max sum_e |phi| |w|, its rounding scale: the
    two pivot alike and sum in other orders, and two LAPACK LUs of the
    system part by 3.2e-16 of that scale here (their weights by 3.7e-11).

The CPU cases run torch on one thread. In the test suite's processes, which
have loaded JAX, torch's elementwise CPU kernels on several threads have
been seen, in one call in a few, to compute one thread's share of the
1024 x 1024 system matrix off by 2e-11 relative (rows 512-767 at once),
which the system's conditioning turns into 1e-7 in the interpolant; on one
thread, and in a process without JAX, every call repeats bit for bit.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from flowbench import inputs
from flowbench.reference import flow, rbf
from flowbench.reference.geometry import Surface
from manifold_flow_tpu_torch.geometry.mesh import build_mesh
from manifold_flow_tpu_torch.kernels import fields as kf
from manifold_flow_tpu_torch.ops import interpolate
from manifold_flow_tpu_torch.pipeline import stages
from manifold_flow_tpu_torch.solve import api, coarse
from manifold_flow_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
CONFIG = json.loads((REPO / "flowbench" / "configs" / "hd1024.json").read_text())
TRIAL = json.loads((REPO / "flowbench" / "traffic" / "trial.json").read_text())
SFREQ = 256.0
SEED = 2 ** 33 + 28


def _small_config():
    return dict(CONFIG, surface=dict(CONFIG["surface"], subdivisions=1))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small():
    """The small S1 surface's inputs (one trial at 256 Hz), the port's mesh
    and PipelineConfig, and the reference's surface."""
    from flowbench.harness import pipeline_config

    inp = inputs.Inputs.make(_small_config(), dict(TRIAL, pool=1, sfreq=SFREQ), SEED)
    mesh = build_mesh(inp.points, inp.tris, device="cpu")
    return inp, mesh, pipeline_config(inp.pipeline), Surface(inp.points, inp.tris, np.float64)


@pytest.fixture(scope="module")
def amplitude(small):
    inp, mesh, cfg, _ = small
    return stages.interpolate_stage(mesh, inp.coords, inp.epochs[0], cfg, sfreq=SFREQ)


def test_hd1024_configuration_sizes():
    """The deployment's surface: S1 of the 32 x 32 grid, 65081 vertices and
    130048 triangles, 1024 electrodes, two-level under precond='auto' with
    the aggregate count the configuration's file states."""
    inp = inputs.Inputs.make(CONFIG, dict(TRIAL, pool=1), SEED)
    assert inp.points.shape == (65081, 3) and inp.tris.shape == (130048, 3)
    assert inp.coords.shape == (1024, 3) and inp.epochs.shape == (1, 10240, 1024)
    assert len(inp.times) == 391
    mesh = build_mesh(inp.points, inp.tris, device="cpu")
    assert api.resolve_precond(mesh, "auto") == "two_level"
    (stated,) = re.findall(r"(\d+) aggregates", CONFIG["about"])
    assert coarse.build_tables(mesh).n_coarse == int(stated) == 291


@pytest.mark.parametrize("phases", [False, True], ids=["amplitude", "phases"])
def test_interpolate_stage_with_1024_electrodes_matches_reference(small, amplitude, phases):
    """The plain fit at E = 1024 and rbf_eval's 16 chunks of 64 electrodes."""
    inp, mesh, cfg, surface = small
    start, stop = inp.window
    sig = inp.epochs[0]
    assert inp.coords.shape == (1024, 3)
    if phases:
        got = stages.interpolate_stage(mesh, inp.coords, sig, cfg, sfreq=SFREQ, phases=True)
        want = rbf.phases(inp.coords, rbf.hilbert_phase(sig)[start:stop], surface.points)
        err = float(np.max(np.abs(np.angle(np.exp(1j * (got.numpy() - want))))))
        assert err <= 1e-8, err
    else:
        got = amplitude
        want = rbf.amplitude(inp.coords, sig[start:stop], surface.points)
        err = float(np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)))
        assert err <= 1e-9, err
    assert got.shape == (stop - start, mesh.n_vertices) == (49, mesh.n_vertices)


@pytest.mark.parametrize("method, tol", [("cg", 1e-10), ("refined", 1e-8)])
def test_two_level_solve_on_s1_surface_matches_reference(small, amplitude, method, tol):
    """compute_velocity_fields with the two-level preconditioner on the
    1024-channel grid's S1 surface (291 aggregates at full size, about 224
    vertices each) against the reference's direct solve of each sampled
    frame."""
    inp, mesh, _, surface = small
    tables = coarse.build_tables(mesh)
    assert 1 < tables.n_coarse < mesh.n_vertices
    frames = (0, 23, 47)
    res = api.compute_velocity_fields(mesh, amplitude.to(torch.float64), inp.times,
                                      lambda_=0.01, method=method, tol=tol,
                                      precond="two_level")
    assert bool(np.all(np.asarray(res.converged)))
    n = mesh.n_vertices
    e = res.e.numpy()
    a2 = flow.regularization(surface)
    ref_movie = amplitude.numpy()
    for k in frames:
        v = res.v_k[k].numpy()
        got = v[:n, None] * e[:, 0] + v[n:, None] * e[:, 1]
        want = flow.to_world(surface, flow.solve_frame(
            surface, a2, ref_movie, float(inp.times[k + 1] - inp.times[k]), k, 0.01))
        err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        assert err <= 1e-8, (k, err)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_planes, blocks", [(1, 13), (2, 25)])
def test_rbf_fit_workspace_path_at_1024_electrodes(cuda, n_planes, blocks):
    """K17's fit at the deployment's 1024 electrodes and 391 frames (the
    workspace path) against the plain fit; its launch counts one workspace
    launch and ceil(planes 391 / 32) factorizations, one a block."""
    coords = inputs.curved_grid(CONFIG["electrodes"])
    rng = np.random.default_rng(SEED)
    planes = [rng.standard_normal((391, 1024)) for _ in range(n_planes)]
    c = torch.from_numpy(coords).to(cuda)
    eps = interpolate.scipy_default_epsilon(c).reshape(1)
    with profiling.record() as rec:
        w, info = kf.rbf_fit(c, eps, [torch.from_numpy(p).to(cuda) for p in planes],
                             "multiquadric")
    counts = rec.summary()["counts"]
    assert int(info[0]) == 0
    assert counts.get("s2.fit_workspace", 0) == 1
    assert counts.get("s2.fit_factorizations", 0) == blocks
    c_cpu, eps_cpu = c.cpu(), eps.cpu()
    w_plain, info_plain = kf.plain_rbf_fit(c_cpu, eps_cpu, [torch.from_numpy(p) for p in planes],
                                           "multiquadric")
    assert int(info_plain[0]) == 0
    a = kf.plain_rbf_basis(c_cpu, eps_cpu, "multiquadric")
    targets = torch.from_numpy(np.asarray(coords) + rng.normal(scale=1.0, size=coords.shape))
    b = kf.rbf_phi(kf.pairwise_dist(targets, c_cpu), eps_cpu, "multiquadric")
    for i, plane in enumerate(planes):
        wi = w[i].cpu()
        resid = float((a @ wi - torch.from_numpy(plane).T).abs().max())
        assert resid <= 1e-12 * float((a.abs() @ wi.abs()).max()), resid
        scale = float((b.abs() @ w_plain[i].abs()).max())
        assert float((b @ wi - b @ w_plain[i]).abs().max()) <= 1e-12 * scale
