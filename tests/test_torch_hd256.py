"""The port on the `hd256` deployment (flowbench/configs/hd256.json): a
256-channel 16 x 16 ECoG grid at 4 mm pitch and the surface S1 reconstructs
from it, held against the benchmark's plain reference (flowbench/reference,
numpy and scipy in float64).

On the CPU the surface is S1's with one butterfly subdivision instead of
three (about a quarter of the triangles: the grid, its Delaunay cells and
the smoothing are the deployment's), and the epoch is sampled at 256 Hz
instead of 2048 (49 window frames), so each case takes seconds. The full
surface's sizes are checked from its configuration. The `cuda` case holds
K17's fit at 256 electrodes, past the card's shared memory, against the
plain fit; it runs on a machine with a GPU as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_hd256.py -m cuda

Tolerances, each with its reason:
  * S2 amplitude: max |port - ref| / max |ref| <= 1e-9. Both sides solve the
    same float64 256 x 256 multiquadric system (condition ~2e5) by LU with
    partial pivoting and evaluate it in float64, summing in other orders;
    the port reads 2.3e-13 here, the reference computed in float32 1.1e-4.
  * S2 phases: the largest wrapped angle gap <= 1e-8 rad: the same fit of
    the two planes of e^{i phi}, and an angle taken of their interpolant,
    which amplifies the planes' rounding where the interpolant is small
    (1.1e-12 read here).
  * S3 velocity: |port - ref| / |ref| of each sampled frame's world vectors
    <= 1e-8: the port's PCG stops at a relative residual of 1e-10 (the
    refined solve's outer loop at 1e-8), the reference solves directly, and
    the gap is that residual times the system's conditioning (1.3e-10 for
    `cg`, 6.7e-10 for `refined` read here).
  * K17 on the card: the interpolant of the kernel's weights against the
    plain fit's to 1e-12 of max sum_e |phi| |w|, its rounding scale, and
    A W = B to 1e-12 of max |A| |W| (the backward error of an LU solve in
    float64), as tests/test_torch_kernels.py holds the fit up to 230
    electrodes: the grid's system is well conditioned (~2e5).
"""

import json
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
CONFIG = json.loads((REPO / "flowbench" / "configs" / "hd256.json").read_text())
TRIAL = json.loads((REPO / "flowbench" / "traffic" / "trial.json").read_text())
SFREQ = 256.0
SEED = 2 ** 33 + 24


def _small_config():
    return dict(CONFIG, surface=dict(CONFIG["surface"], subdivisions=1))


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


def test_hd256_configuration_sizes():
    """The deployment's surface: S1 of the 16 x 16 grid, 15957 vertices and
    31808 triangles, 256 electrodes, two-level under precond='auto'."""
    inp = inputs.Inputs.make(CONFIG, dict(TRIAL, pool=1), SEED)
    assert inp.points.shape == (15957, 3) and inp.tris.shape == (31808, 3)
    assert inp.coords.shape == (256, 3) and inp.epochs.shape == (1, 10240, 256)
    assert len(inp.times) == 391
    mesh = build_mesh(inp.points, inp.tris, device="cpu")
    assert api.resolve_precond(mesh, "auto") == "two_level"


@pytest.mark.parametrize("phases", [False, True], ids=["amplitude", "phases"])
def test_interpolate_stage_with_256_electrodes_matches_reference(small, amplitude, phases):
    inp, mesh, cfg, surface = small
    start, stop = inp.window
    sig = inp.epochs[0]
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
    """compute_velocity_fields with the two-level preconditioner on the S1
    surface (its aggregation over S1's vertex order, vertices in more than
    six cells) against the reference's direct solve of each sampled frame."""
    inp, mesh, _, surface = small
    tables = coarse.build_tables(mesh)
    assert 1 < tables.n_coarse < mesh.n_vertices
    assert int(mesh.vertex_cells.shape[1]) > 6
    frames = (0, 23, 47)
    movie = amplitude.to(torch.float64)
    res = api.compute_velocity_fields(mesh, movie, inp.times, lambda_=0.01, method=method,
                                      tol=tol, precond="two_level")
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


def _fit_count(c, planes):
    eps = interpolate.scipy_default_epsilon(c).reshape(1)
    with profiling.record() as rec:
        w, info = kf.rbf_fit(c, eps, planes, "multiquadric")
    return eps, w, info, rec.summary()["counts"].get("s2.fit_workspace", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_planes", [1, 2])
def test_rbf_fit_workspace_path_at_256_electrodes(cuda, n_planes):
    """K17's fit at the deployment's 256 electrodes and 391 frames (its
    working set past shared memory: the workspace path, counted once a
    launch) against the plain fit; at 64 electrodes the count stays 0."""
    coords = inputs.curved_grid(CONFIG["electrodes"])
    rng = np.random.default_rng(SEED)
    planes = [rng.standard_normal((391, 256)) for _ in range(n_planes)]
    c = torch.from_numpy(coords).to(cuda)
    eps, w, info, count = _fit_count(c, [torch.from_numpy(p).to(cuda) for p in planes])
    assert int(info[0]) == 0 and count == 1
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
    small_c = c[:64].contiguous()
    _, _, info64, count64 = _fit_count(small_c, [torch.from_numpy(p[:, :64].copy()).to(cuda)
                                                 for p in planes])
    assert int(info64[0]) == 0 and count64 == 0
