"""The port's pipeline (config; the velocity, singularity, streamline and
winding stages; the `flow`, `streamline` and `winding` command lines;
artifact IO) held against the JAX package on the CPU, and the port's CLIs
against the golden artifact trees.

Tolerances: velocity DOFs, world vectors and speeds to 1e-8 of their largest
entry at tol 1e-10 (two cg solves that may stop an iteration apart, see
tests/test_torch_solve.py); singularity points to 1e-8; per-frame counts,
snapped centers, class labels, streamlines, ring counts and types equal.
The golden trees are compared through tests/golden_utils.compare_artifact,
with the tolerances the JAX package's own golden test uses.
"""

import dataclasses
import json

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
    return jmesh, mesh_from_jax_arrays(jax_arrays(jmesh), device="cpu"), pot, times


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
                            "artifact_submits", "trace"}
    assert timings["trace"]["counts"]["solve.inner_iters"] >= got.iterations
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


@pytest.fixture(scope="module")
def jax_velocity(demo):
    jmesh, _, pot, times = demo
    jvel = jax_stages.velocity_stage(jmesh, pot, times, _config(JaxConfig))
    return jvel, torch.from_numpy(np.array(jvel.v_world))


def _quirks_config(cls, quirks):
    cfg = _config(cls)
    cfg.reference_quirks = quirks
    cfg.analysis.min_streamline_length = 3
    return cfg


QUIRKS = pytest.mark.parametrize("quirks", [False, True], ids=["quirks_off", "quirks_on"])


@QUIRKS
def test_singularity_stage_classifies_like_jax(tmp_path, demo, jax_velocity, quirks):
    jmesh, tmesh, _, _ = demo
    jvel, v_world = jax_velocity
    want_pts, want_labels = jax_stages.singularity_stage(
        jmesh, jvel.v_world, _quirks_config(JaxConfig, quirks), classify=True,
        classification_path=tmp_path / "want.pkl")
    timings: dict = {}
    got_pts, labels = stages.singularity_stage(
        tmesh, v_world, _quirks_config(PipelineConfig, quirks), classify=True,
        classification_path=tmp_path / "got.pkl", timings=timings)
    assert labels == want_labels
    assert [len(p) for p in got_pts] == [len(x) for x in labels]
    assert io.load_pickle(tmp_path / "got.pkl") == io.load_pickle(tmp_path / "want.pkl")
    assert len({name for frame in labels for name in frame}) >= 2
    assert set(timings) == {"detect", "classify", "trace"}
    assert timings["trace"]["counts"] == {"sync.analysis.counts": 1,
                                          "sync.analysis.codes": 2,
                                          "sync.analysis.rows": 1}


@QUIRKS
def test_streamline_and_winding_stages_match_jax(tmp_path, demo, jax_velocity, quirks):
    """S6 on a subset of frames, written per frame; S7 on the detection
    stage's snapped centers (the trial's path) and re-snapped on the host
    (the resume-from-pickle path)."""
    jmesh, tmesh, _, _ = demo
    jvel, v_world = jax_velocity
    jcfg, cfg = _quirks_config(JaxConfig, quirks), _quirks_config(PipelineConfig, quirks)
    fmt = str(tmp_path / "s_{frame}.pkl.bz2")
    want = jax_stages.streamline_stage(jmesh, jvel.v_world, jcfg, frames=[1, 3])
    timings: dict = {}
    got = stages.streamline_stage(tmesh, v_world, cfg, frames=[1, 3], save_path_fmt=fmt,
                                  timings=timings)
    assert set(timings) == {"trace", "compact", "submit"}
    assert list(got) == list(want) == ["1", "3"]
    assert sum(len(lines) for lines in got.values()) > 0
    for k in got:
        saved = io.load_pickle(fmt.format(frame=k))[k]
        assert len(got[k]) == len(want[k]) == len(saved)
        for a, b, c in zip(got[k], want[k], saved):
            assert a.dtype == (np.float64 if quirks else np.float32)
            np.testing.assert_array_equal(a, np.asarray(b))
            np.testing.assert_array_equal(c, a)

    jpts, _, jcenters = jax_stages.singularity_stage(jmesh, jvel.v_world, jcfg,
                                                     return_centers=True)
    pts, _, centers = stages.singularity_stage(tmesh, v_world, cfg, return_centers=True)
    for trial_centers in (True, False):
        want = jax_stages.winding_stage(jmesh, jvel.v_world, jpts, jcfg,
                                        centers=jcenters if trial_centers else None)
        got = stages.winding_stage(tmesh, v_world, pts, cfg,
                                   centers=centers if trial_centers else None,
                                   save_path=tmp_path / "w.pkl.bz2")
        assert sorted(got) == sorted(want) and sum(len(r) for r in got.values()) > 0
        for k in want:
            assert [r[1:] for r in got[k]] == [r[1:] for r in want[k]]
            for a, b in zip(got[k], want[k]):
                np.testing.assert_allclose(a[0], b[0], rtol=VS_JAX, atol=VS_JAX)
        saved = io.load_pickle(tmp_path / "w.pkl.bz2")
        assert {k: [r[1:] for r in v] for k, v in saved.items()} == {
            k: [r[1:] for r in v] for k, v in got.items()}


def test_unported_stage_options_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="A3"):
        stages.load_surface(tmp_path / "none.ply", pad=True)
    with pytest.raises(ValueError, match="unknown SVD mode"):
        stages.decompose_stage(np.zeros((3, 4)), PipelineConfig(), mode="real",
                               device="cpu")


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
GOLDEN_E = f"{G.SUBJECT}/{G.SUBJECT}_e.csv"
GOLDEN_FLOW = {  # golden artifact name -> the flow CLI's file name
    GOLDEN_E: "e.csv",
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


def _golden_inputs(quirks, tmp_path):
    """The golden tree's trial directory, its surface, and a config file
    with the tree's quirk mode (the settings the golden trees were made
    with, tests/golden_utils.py)."""
    golden = G.mode_dir(quirks)
    trial = golden / G.SUBJECT / G.RUN / G.TRIAL
    config = tmp_path / "config.yaml"
    config.write_text(f"general:\n  reference_quirks: {str(quirks).lower()}\n"
                      "  tol: 1.0e-10\nanalysis:\n  min_streamline_length: 3\n")
    surface = golden / G.SUBJECT / f"{G.SUBJECT}_reconstructed_surface.ply"
    return golden, trial, surface, config


@QUIRKS
def test_flow_cli_classify_matches_jax(tmp_path, quirks, capsys):
    _, trial, surface, config = _golden_inputs(quirks, tmp_path)
    movie = trial / f"{G.STEM}-ave-interpolation_data.csv"
    rc = cli.main(["flow", "--surface", str(surface), "--potentials", str(movie),
                   "--sfreq", "512", "--config", str(config), "--classify",
                   "--device", "cpu", "--out-dir", str(tmp_path)])
    assert rc == 0
    line = json.loads(capsys.readouterr().out)
    assert line["converged"] and line["device"] == "cpu" and "classify" in line["timings"]
    jcfg = JaxConfig.from_yaml(config)
    jmesh = jax_stages.load_surface(surface)
    pot = io.load_indexed_csv(movie)
    jvel = jax_stages.velocity_stage(jmesh, pot, np.arange(pot.shape[0]) / 512.0, jcfg)
    jax_stages.singularity_stage(jmesh, jvel.v_world, jcfg, classify=True,
                                 classification_path=tmp_path / "want.pkl")
    got = io.load_pickle(tmp_path / "singularity_points_classification.pkl")
    assert got == io.load_pickle(tmp_path / "want.pkl")
    assert [len(x) for x in got] == line["singularities_per_frame"]
    assert sum(len(x) for x in got) > 0


@QUIRKS
def test_streamline_and_winding_clis_reproduce_golden_artifacts(tmp_path, quirks, capsys):
    golden, trial, surface, config = _golden_inputs(quirks, tmp_path)
    out = tmp_path / "out"
    common = ["--surface", str(surface), "--e", str(golden / GOLDEN_E),
              "--v-k", str(trial / f"{G.STEM}-V_k.csv"), "--config", str(config),
              "--device", "cpu", "--out-dir", str(out)]
    kernels.reset_launches()
    assert cli.main(["streamline", *common]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["stage"] == "streamline" and line["device"] == "cpu"
    assert set(line["lines_per_frame"]) == {"0", "1", "2"}
    assert set(line["timings"]) == {"load", "trace", "compact", "submit"}
    sing = trial / f"{G.STEM}-singularity_points.pkl"
    assert cli.main(["winding", *common, "--singularities", str(sing)]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["stage"] == "winding" and line["frames_with_lines"] > 0
    assert set(line["timings"]) == {"load", "winding"}
    assert set(kernels.LAUNCHES.values()) == {0}
    for k in range(3):
        name = f"t_velocityfields_streamlines_{k}.pkl.bz2"
        G.compare_artifact(name, out / name, trial / name)
    name = f"{G.STEM}-winding_lines.pkl.bz2"
    G.compare_artifact(name, out / "winding_lines.pkl.bz2", trial / name)


def test_flow_cli_unported_options_raise(tmp_path, monkeypatch):
    base = ["flow", "--surface", "s.ply", "--potentials", "p.npy",
            "--out-dir", str(tmp_path)]
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


# ------------------------------------------------------- field stages ----
def _electrode_movie(jmesh, n_electrodes=16, n_samples=1229, seed=3):
    """Electrodes picked among the mesh's vertices and a 512 Hz movie of
    n_samples at them (T, E): the demo's two-source waves plus seeded noise."""
    rng = np.random.default_rng(seed)
    sel = rng.choice(jmesh.n_vertices, n_electrodes, replace=False)
    pts = np.asarray(jmesh.points)[sel]
    t = np.arange(n_samples)[:, None] / 512.0
    r = np.linalg.norm(pts[None] - np.array([2.0, 2.0, 0.0]), axis=-1)
    movie = np.cos(2 * np.pi * (r - 8.0 * t) / 3.0) + 0.1 * rng.standard_normal(r.shape)
    return pts, movie


@QUIRKS
@pytest.mark.parametrize("phases", [False, True], ids=["movie", "phases"])
def test_interpolate_stage_matches_jax(tmp_path, demo, quirks, phases):
    """S2 with the default window [2.009, 2.2) s at 512 Hz (98 frames, after
    the Hilbert transform for phases), both Hilbert axes."""
    jmesh, tmesh, _, _ = demo
    coords, movie = _electrode_movie(jmesh)
    jcfg, cfg = _quirks_config(JaxConfig, quirks), _quirks_config(PipelineConfig, quirks)
    want = jax_stages.interpolate_stage(jmesh, coords, movie, jcfg, sfreq=512.0,
                                        phases=phases)
    timings: dict = {}
    got = stages.interpolate_stage(tmesh, coords, movie, cfg, sfreq=512.0, phases=phases,
                                   save_path=tmp_path / "i.csv", timings=timings)
    assert got.shape == want.shape == (98, tmesh.n_vertices)
    if phases:
        assert float(np.abs(np.angle(np.exp(1j * (got.numpy() - want)))).max()) <= 1e-9
    else:
        assert rel_err(got.numpy(), want) <= 1e-9
    np.testing.assert_array_equal(io.load_indexed_csv(tmp_path / "i.csv"), got.numpy())
    assert set(timings) == {"compute", "write", "trace"}


@pytest.mark.parametrize("method", ["phase", "amplitude"])
def test_wavespeed_stage_matches_jax(tmp_path, demo, method):
    jmesh, tmesh, pot, _ = demo
    movie = np.angle(np.exp(2j * pot)) if method == "phase" else pot
    want = np.asarray(jax_stages.wavespeed_stage(jmesh, movie, 1.0 / 512, method=method))
    got = stages.wavespeed_stage(tmesh, movie, 1.0 / 512, method=method,
                                 save_path=tmp_path / "w.pkl.bz2")
    assert rel_err(got.numpy(), want) <= 1e-10
    np.testing.assert_array_equal(io.load_pickle(tmp_path / "w.pkl.bz2"), got.numpy())
    with pytest.raises(ValueError, match="unknown wavespeed method"):
        stages.wavespeed_stage(tmesh, movie, 1.0, method="group")


@pytest.mark.parametrize("mode", ["concat", "complex"])
def test_decompose_stage_matches_jax(tmp_path, jax_velocity, mode):
    """S4 on the demo's velocity movie: sigma, the percentages and the
    rank-K reconstruction (gauge-invariant for the complex form), and the
    npz reloading equal to the modes in memory."""
    jvel, _ = jax_velocity
    v_k = np.asarray(jvel.v_k)
    want = jax_stages.decompose_stage(v_k, JaxConfig(), mode=mode)
    got = stages.decompose_stage(v_k, PipelineConfig(), mode=mode, device="cpu",
                                 npz_path=tmp_path / "d.npz")
    assert rel_err(got.sigma.numpy(), np.asarray(want.sigma)) <= 1e-10
    np.testing.assert_array_equal(got.pct.numpy(), np.asarray(want.pct))
    rec = (got.u.numpy() * got.sigma.numpy()) @ got.vt.numpy()
    rec_want = (np.asarray(want.u) * np.asarray(want.sigma)) @ np.asarray(want.vt)
    assert float(np.abs(rec - rec_want).max()) <= 1e-10 * float(np.abs(rec_want).max())
    with np.load(tmp_path / "d.npz") as z:
        assert int(z["point_num"]) == v_k.shape[1] // 2
        for key, x in (("U", got.u), ("Sigma", got.sigma), ("VT", got.vt)):
            np.testing.assert_array_equal(z[key], x.numpy())


@QUIRKS
def test_wavespeed_and_decompose_clis_reproduce_golden_artifacts(tmp_path, quirks, capsys):
    golden, trial, surface, config = _golden_inputs(quirks, tmp_path)
    out = tmp_path / "out"
    kernels.reset_launches()
    for method, movie, name in (
            ("phase", "ave-interpolation_phases_data.csv", "wave_velocity.pkl.bz2"),
            ("amplitude", "ave-interpolation_data.csv", "wave_velocity_amplitude.pkl.bz2")):
        assert cli.main(["wavespeed", "--surface", str(surface), "--movie",
                         str(trial / f"{G.STEM}-{movie}"), "--sfreq", "512",
                         "--method", method, "--config", str(config), "--device", "cpu",
                         "--out-dir", str(out)]) == 0
        line = json.loads(capsys.readouterr().out)
        assert line["device"] == "cpu" and line["method"] == method
        assert set(line["timings"]) == {"load", "compute", "write"}
        G.compare_artifact(f"{G.STEM}-{name}", out / f"wave_velocity_{method}.pkl.bz2",
                           trial / f"{G.STEM}-{name}")
    assert cli.main(["decompose", "--v-k", str(trial / f"{G.STEM}-V_k.csv"),
                     "--config", str(config), "--device", "cpu",
                     "--out-dir", str(out)]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["mode"] == "concat" and line["rendered_modes"] == []
    assert sum(line["energy_pct"]) == pytest.approx(100.0, abs=0.01)
    G.compare_artifact("data_01.npz", out / "data_01.npz", trial / "data_01.npz")
    assert set(kernels.LAUNCHES.values()) == {0}


def test_interpolate_cli_matches_jax_stage(tmp_path, demo, capsys):
    """The interpolate CLI on an electrodes.tsv (16 grid rows, one strip row
    and one with 'n/a' coordinates, both skipped, and one excluded by name)
    against the JAX stage on the kept electrodes."""
    jmesh, _, _, _ = demo
    coords, movie = _electrode_movie(jmesh, n_electrodes=17)
    rows = ["name\tx\ty\tz\tgroup"] + [
        f"G{i}\t{x!r}\t{y!r}\t{z!r}\tgrid" for i, (x, y, z) in enumerate(coords.tolist())]
    rows += ["S0\t1.0\t1.0\t0.0\tstrip", "G99\tn/a\tn/a\tn/a\tgrid"]
    (tmp_path / "electrodes.tsv").write_text("\n".join(rows) + "\n")
    np.save(tmp_path / "data.npy", movie[:, 1:])
    io.write_ply(tmp_path / "s.ply", np.asarray(jmesh.points), np.asarray(jmesh.triangles))
    assert cli.main(["interpolate", "--surface", str(tmp_path / "s.ply"), "--electrodes",
                     str(tmp_path / "electrodes.tsv"), "--data", str(tmp_path / "data.npy"),
                     "--sfreq", "512", "--phases", "--exclude", "G0", "--device", "cpu",
                     "--out-dir", str(tmp_path / "out")]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["shape"] == [98, jmesh.n_vertices]
    assert set(line["timings"]) == {"load", "compute", "write", "trace"}
    jmesh_ply = jax_stages.load_surface(tmp_path / "s.ply")
    want = jax_stages.interpolate_stage(jmesh_ply, coords[1:], movie[:, 1:], JaxConfig(),
                                        sfreq=512.0, phases=True)
    got = io.load_indexed_csv(tmp_path / "out" / "interpolation_phases_data.csv")
    assert float(np.abs(np.angle(np.exp(1j * (got - want)))).max()) <= 1e-9


def test_demo_cli_matches_jax(tmp_path, capsys):
    """demo on the CPU: the JAX demo's frames, convergence and validation
    scores (the reference's matched / missed / spare quirks included)."""
    from manifold_flow_tpu.pipeline import cli as jax_cli

    argv = ["demo", "--nx", "10", "--frames", "4"]
    jax_args = jax_cli.build_parser().parse_args(argv + ["--out-dir", str(tmp_path / "j")])
    jax_args.func(jax_args)
    want = json.loads(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu", "--out-dir", str(tmp_path / "t")]) == 0
    got = json.loads(capsys.readouterr().out)
    for key in ("frames", "converged", "matched", "missed", "spare"):
        assert got[key] == want[key], key
    assert got["err_max"] == pytest.approx(want["err_max"], rel=1e-12)
    assert got["device"] == "cpu" and got["gif"] is None and got["matched"] > 0
    for name in ("simulated_surface.ply", "e.csv", "V_k.csv", "singularity_points.pkl"):
        assert (tmp_path / "t" / name).exists()


def test_field_cli_unported_options_raise(tmp_path, monkeypatch, capsys):
    """The rendering options, which raised until viz/fields.py was ported,
    now render: decompose --render-modes with and without a --pial
    underlay, and demo --gif (tests/test_torch_viz.py holds them against
    JAX). Every subcommand defaults to --device cuda and raises without a
    GPU before any work, visualize too."""
    from manifold_flow_tpu_torch.geometry import synthetic

    mesh = synthetic.plane_patch(nx=6, ny=6, lx=3.0, ly=3.0, device="cpu")
    art = tmp_path / "art"
    art.mkdir()
    io.write_ply(art / "s.ply", mesh.points.numpy(), mesh.triangles.numpy())
    io.save_indexed_csv(art / "V_k.csv", np.random.default_rng(0).normal(
        size=(4, mesh.n_dof)))
    io.write_freesurfer_surface(art / "lh.pial", mesh.points.numpy() * 2.0,
                                mesh.triangles.numpy())
    for pial in ([], ["--pial", str(art / "lh.pial")]):
        out = tmp_path / f"modes{len(pial)}"
        assert cli.main(["decompose", "--v-k", str(art / "V_k.csv"), "--render-modes", "2",
                         "--surface", str(art / "s.ply"), *pial, "--device", "cpu",
                         "--out-dir", str(out)]) == 0
        line = json.loads(capsys.readouterr().out)
        assert line["rendered_modes"] == [str(out / f"spatial_mode_{i}.png") for i in (1, 2)]
        assert all((out / f"spatial_mode_{i}.png").stat().st_size > 0 for i in (1, 2))
    assert cli.main(["demo", "--nx", "6", "--frames", "3", "--gif", "--device", "cpu",
                     "--out-dir", str(tmp_path / "demo")]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["gif"] == str(tmp_path / "demo" / "true_vs_detected.gif")
    assert (tmp_path / "demo" / "true_vs_detected.gif").stat().st_size > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    empty = tmp_path / "none"
    empty.mkdir()
    for argv in (["interpolate", "--surface", "s.ply", "--electrodes", "e.tsv",
                  "--data", "d.npy"],
                 ["wavespeed", "--surface", "s.ply", "--movie", "m.npy", "--sfreq", "512"],
                 ["decompose", "--v-k", "v.csv"], ["demo"],
                 ["visualize", "--surface", "s.ply", "--e", "e.csv", "--v-k", "v.csv"]):
        with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
            cli.main(argv + ["--out-dir", str(empty)])
    assert not list(empty.iterdir())


def test_decompose_cli_ignores_pial_without_render_modes(tmp_path, capsys):
    """As in JAX, --pial is read only under --render-modes: without it the
    call writes the same data_01.npz as the call without --pial (ROADMAP
    C9)."""
    _, trial, _, _ = _golden_inputs(False, tmp_path)
    v_k = str(trial / f"{G.STEM}-V_k.csv")
    for name, extra in (("plain", []), ("pial", ["--pial", str(tmp_path / "lh.pial")])):
        assert cli.main(["decompose", "--v-k", v_k, *extra, "--device", "cpu",
                         "--out-dir", str(tmp_path / name)]) == 0
        line = json.loads(capsys.readouterr().out)
        assert line["rendered_modes"] == []
    with np.load(tmp_path / "plain" / "data_01.npz") as want, \
            np.load(tmp_path / "pial" / "data_01.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key])
