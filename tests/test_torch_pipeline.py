"""The port's S3 pipeline (config, velocity and singularity stages, the
`flow` command line, artifact IO) held against the JAX package on the CPU,
and the port's flow CLI against the golden artifact trees.

Tolerances: velocity DOFs, world vectors and speeds to 1e-8 of their largest
entry at tol 1e-10 (two cg solves that may stop an iteration apart, see
tests/test_torch_solve.py); singularity points to 1e-8; per-frame counts and
snapped centers equal. The golden trees are compared through
tests/golden_utils.compare_artifact, with the tolerances the JAX package's
own golden test uses.
"""

import dataclasses

import numpy as np
import pytest
import torch

from manifold_flow_tpu.geometry import synthetic as jax_synthetic
from manifold_flow_tpu.pipeline import stages as jax_stages
from manifold_flow_tpu.pipeline.config import PipelineConfig as JaxConfig
from manifold_flow_tpu_torch import kernels, mesh_from_jax_arrays
from manifold_flow_tpu_torch.pipeline import cli, stages
from manifold_flow_tpu_torch.pipeline.config import PipelineConfig
from manifold_flow_tpu_torch.solve.refine import DEFAULT_INNER_TOL
from manifold_flow_tpu_torch.utils import io
from tests import golden_utils as G
from tests.torch_parity import jax_arrays, rel_err

VS_JAX = 1e-8


@pytest.fixture(scope="module")
def demo():
    """The JAX pipeline tests' demo problem (tests/test_pipeline.py)."""
    jmesh = jax_synthetic.plane_patch(
        nx=14, ny=14, lx=8.0, ly=8.0,
        height=lambda x, y: 0.4 * np.sin(x) * np.cos(y))
    pot, times, _ = jax_synthetic.two_source_movie(
        jmesh, sources=((2.0, 2.0), (6.0, 6.0)), n_frames=6)
    return jmesh, mesh_from_jax_arrays(jax_arrays(jmesh)), pot, times


def _config(cls, **solver):
    cfg = cls()
    cfg.solver.tol = 1e-10
    for key, value in solver.items():
        setattr(cfg.solver, key, value)
    return cfg


# -------------------------------------------------------------- config ----
REFERENCE_YAML = (
    "general:\n  lambda_: 0.02\n  eps: 1e-4\n  time_steps: 50\n"
    "  tol: '1e-9'\n  inner_tol: [1e-3, '1e-2']\n  processes_num: 32\n"
    "  method: cg\n  reference_quirks: true\n"
    "analysis:\n  threshold: 3.0\n"
    "sub_01:\n  surface_path: /a/s.ply\n  threshold: 7.5\n  other: 1\n")


def test_config_from_yaml_matches_jax(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text(REFERENCE_YAML)
    got = PipelineConfig.from_yaml(path)
    want = JaxConfig.from_yaml(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.solver.eps == 1e-4 and got.solver.tol == 1e-9  # the '1e-4' quirk
    assert got.solver.inner_tol == (1e-3, 1e-2)
    assert dataclasses.asdict(PipelineConfig()) == dataclasses.asdict(JaxConfig())
    assert got.to_yaml() == want.to_yaml()
    assert tuple(PipelineConfig().solver.inner_tol) == DEFAULT_INNER_TOL


# -------------------------------------------------------------- stages ----
def test_velocity_stage_matches_jax(tmp_path, demo):
    jmesh, tmesh, pot, times = demo
    want = jax_stages.velocity_stage(jmesh, pot, times, _config(JaxConfig))
    timings: dict = {}
    got = stages.velocity_stage(
        tmesh, pot, times, _config(PipelineConfig),
        e_path=tmp_path / "e.csv", v_k_path=tmp_path / "V_k.csv",
        speed_path=tmp_path / "speed.pkl.bz2", timings=timings)
    assert got.converged and want.converged
    assert abs(got.iterations - want.iterations) <= 2
    for name in ("v_k", "v_world", "speed"):
        assert rel_err(getattr(got, name).numpy(),
                       np.asarray(getattr(want, name))) <= VS_JAX, name
    np.testing.assert_array_equal(got.e, np.asarray(want.e))
    assert torch.equal(got.v_max, got.speed.amax(dim=-1))
    assert set(timings) == {"dispatch", "artifact_starts", "solve_wait",
                            "artifact_submits"}
    # The artifacts reload to the in-memory results, exactly.
    np.testing.assert_array_equal(io.load_e_csv(tmp_path / "e.csv"), got.e)
    np.testing.assert_array_equal(io.load_indexed_csv(tmp_path / "V_k.csv"),
                                  got.v_k.numpy())
    np.testing.assert_array_equal(io.load_pickle(tmp_path / "speed.pkl.bz2"),
                                  got.speed.numpy())


def test_velocity_stage_escalates_like_jax(demo):
    """A starved cg solve warns, escalates to 'refined' and converges; with
    escalation off it only warns, loudly, as the JAX stage does."""
    jmesh, tmesh, pot, times = demo
    for package_stages, cls, mesh in ((jax_stages, JaxConfig, jmesh),
                                      (stages, PipelineConfig, tmesh)):
        cfg = _config(cls, method="cg", max_iter=8, tol=1e-9)
        with pytest.warns(package_stages.ConvergenceWarning, match="escalating"):
            res = package_stages.velocity_stage(mesh, pot, times, cfg)
        assert res.converged
        cfg.solver.escalate = False
        with pytest.warns(package_stages.ConvergenceWarning, match="NOT converged"):
            res = package_stages.velocity_stage(mesh, pot, times, cfg)
        assert not res.converged


def test_singularity_stage_matches_jax(tmp_path, demo):
    jmesh, tmesh, pot, times = demo
    jvel = jax_stages.velocity_stage(jmesh, pot, times, _config(JaxConfig))
    want_pts, want_labels, want_centers = jax_stages.singularity_stage(
        jmesh, jvel.v_world, _config(JaxConfig), return_centers=True)
    v_world = torch.from_numpy(np.array(jvel.v_world))
    got_pts, labels, got_centers = stages.singularity_stage(
        tmesh, v_world, _config(PipelineConfig), save_path=tmp_path / "s.pkl",
        return_centers=True)
    assert labels is None and want_labels is None
    assert [len(p) for p in got_pts] == [len(p) for p in want_pts]
    assert sum(len(p) for p in got_pts) > 0
    for g, w in zip(got_pts, want_pts):
        np.testing.assert_allclose(g, w, rtol=VS_JAX, atol=VS_JAX)
    for g, w in zip(got_centers, want_centers):
        np.testing.assert_array_equal(g, w)
    saved = io.load_pickle(tmp_path / "s.pkl")
    assert len(saved) == len(got_pts)
    for s, g in zip(saved, got_pts):
        np.testing.assert_array_equal(np.asarray(s).reshape(g.shape), g)
    # The velocity stage's speed and v_max give the same detections.
    vel = stages.velocity_stage(tmesh, pot, times, _config(PipelineConfig))
    a, _ = stages.singularity_stage(tmesh, vel.v_world, _config(PipelineConfig))
    b, _ = stages.singularity_stage(tmesh, vel.v_world, _config(PipelineConfig),
                                    speed=vel.speed, v_max=vel.v_max)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_unported_stage_options_raise(demo, tmp_path):
    _, tmesh, _, _ = demo
    with pytest.raises(NotImplementedError, match="item 10"):
        stages.singularity_stage(tmesh, torch.zeros((1, tmesh.n_vertices, 3)),
                                 PipelineConfig(), classify=True)
    with pytest.raises(NotImplementedError, match="item 2"):
        stages.load_surface(tmp_path / "none.ply", pad=True)
    with pytest.raises(NotImplementedError, match="item 14"):
        stages.load_surface(tmp_path / "none.ply", cache_dir=tmp_path)


# ----------------------------------------------------------------- IO ----
def test_io_roundtrips_match_jax(tmp_path, demo):
    from manifold_flow_tpu.utils import io as jax_io

    jmesh, _, pot, _ = demo
    pts, tris = np.asarray(jmesh.points), np.asarray(jmesh.triangles)
    for binary in (True, False):
        io.write_ply(tmp_path / "m.ply", pts, tris, binary=binary)
        got = io.read_ply(tmp_path / "m.ply")
        want = jax_io.read_ply(tmp_path / "m.ply")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    io.save_indexed_csv(tmp_path / "a.csv", pot)
    jax_io.save_indexed_csv(tmp_path / "b.csv", pot)
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()
    np.testing.assert_array_equal(io.load_indexed_csv(tmp_path / "a.csv"), pot)
    with io.ArtifactWriter(workers=2) as writer:
        io.submit_write(writer, io.save_pickle, tmp_path / "sub" / "p.pkl.bz2", pot)
    np.testing.assert_array_equal(jax_io.load_pickle(tmp_path / "sub" / "p.pkl.bz2"), pot)
    t = torch.from_numpy(pot)
    (host,) = io.to_numpy(t)
    np.testing.assert_array_equal(host, pot)


# ---------------------------------------------------------------- CLI ----
GOLDEN_FLOW = {  # golden artifact name -> the flow CLI's file name
    f"{G.SUBJECT}/{G.SUBJECT}_e.csv": "e.csv",
    f"{G.SUBJECT}/{G.RUN}/{G.TRIAL}/{G.STEM}-V_k.csv": "V_k.csv",
    f"{G.SUBJECT}/{G.RUN}/{G.TRIAL}/{G.STEM}-singularity_points.pkl":
        "singularity_points.pkl",
    f"{G.SUBJECT}/{G.RUN}/{G.TRIAL}/{G.STEM}-wave_velocity_opticalflow.pkl.bz2":
        "wave_velocity_opticalflow.pkl.bz2",
}


@pytest.mark.parametrize("quirks", [False, True], ids=["quirks_off", "quirks_on"])
def test_flow_cli_reproduces_golden_artifacts(tmp_path, quirks, capsys):
    golden = G.mode_dir(quirks)
    subject = golden / G.SUBJECT
    movie = subject / G.RUN / G.TRIAL / f"{G.STEM}-ave-interpolation_data.csv"
    rc = cli.main(["flow", "--surface",
                   str(subject / f"{G.SUBJECT}_reconstructed_surface.ply"),
                   "--potentials", str(movie), "--sfreq", "512",
                   "--tol", "1e-10", "--device", "cpu",
                   "--out-dir", str(tmp_path)])
    assert rc == 0
    assert '"converged": true' in capsys.readouterr().out
    for name, produced in GOLDEN_FLOW.items():
        G.compare_artifact(name, tmp_path / produced, golden / name)


def test_flow_cli_unported_options_raise(tmp_path, monkeypatch):
    base = ["flow", "--surface", "s.ply", "--potentials", "p.npy",
            "--out-dir", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="item 10"):
        cli.main(base + ["--device", "cpu", "--classify"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        cli.main(base)  # --device cuda is the default
    with pytest.raises(ValueError, match="want cpu or cuda"):
        cli.main(base + ["--device", "meta"])
    assert not list(tmp_path.iterdir())


def test_flow_cli_on_npy_movie_counts_no_launch_on_cpu(tmp_path, demo, capsys):
    jmesh, _, pot, _ = demo
    io.write_ply(tmp_path / "s.ply", np.asarray(jmesh.points),
                 np.asarray(jmesh.triangles))
    np.save(tmp_path / "p.npy", pot)
    kernels.reset_launches()
    cli.main(["flow", "--surface", str(tmp_path / "s.ply"), "--potentials",
              str(tmp_path / "p.npy"), "--sfreq", "50", "--device", "cpu",
              "--out-dir", str(tmp_path / "out")])
    assert set(kernels.LAUNCHES.values()) == {0}
    assert '"frames": 5' in capsys.readouterr().out
    v_k = io.load_indexed_csv(tmp_path / "out" / "V_k.csv")
    assert v_k.shape == (5, 2 * jmesh.n_vertices)


def test_flow_cli_cholesky_matches_cg(tmp_path, demo, capsys):
    jmesh, _, pot, _ = demo
    io.write_ply(tmp_path / "s.ply", np.asarray(jmesh.points),
                 np.asarray(jmesh.triangles))
    np.save(tmp_path / "p.npy", pot)
    runs = {}
    for method in ("cholesky", "cg"):
        rc = cli.main(["flow", "--surface", str(tmp_path / "s.ply"), "--potentials",
                       str(tmp_path / "p.npy"), "--sfreq", "50", "--device", "cpu",
                       "--method", method, "--tol", "1e-10",
                       "--out-dir", str(tmp_path / method)])
        assert rc == 0
        runs[method] = capsys.readouterr().out
        assert '"converged": true' in runs[method]
    assert '"iterations": 0' in runs["cholesky"]
    got = io.load_indexed_csv(tmp_path / "cholesky" / "V_k.csv")
    want = io.load_indexed_csv(tmp_path / "cg" / "V_k.csv")
    assert got.shape == (5, 2 * jmesh.n_vertices)
    assert rel_err(got, want) <= VS_JAX
