"""The port's batch runs (pipeline/batch.py), its geometry cache
(utils/cache.py), the evoked CSV and FreeSurfer readers and the `batch`
command line, held against the JAX package on the CPU.

Each results tree is made once with numpy from a seed (surfaces from the
port's synthetic patches written as PLY, movies from numpy formulas) and
copied, so that both packages run on the same files; JAX runs on its CPU
backend with its default config (padded meshes), the port with
device="cpu". Reports must be equal (statuses and error keys); artifacts
are compared through tests/golden_utils.compare_artifact, with the
tolerances the JAX package's golden test uses: discrete outputs (frame
counts, streamline counts, ring counts and types) equal, floats within
1e-5 relative. The port's run_trial also reproduces both golden trees.
"""

import json
import logging
import shutil

import numpy as np
import pytest
import torch

from manifold_flow_tpu.pipeline import batch as jax_batch
from manifold_flow_tpu.pipeline.config import PipelineConfig as JaxConfig
from manifold_flow_tpu.utils import io as jax_io
from manifold_flow_tpu_torch import kernels
from manifold_flow_tpu_torch.geometry import synthetic
from manifold_flow_tpu_torch.geometry.mesh import ARRAY_FIELDS
from manifold_flow_tpu_torch.pipeline import batch, cli, stages
from manifold_flow_tpu_torch.pipeline.config import PipelineConfig
from manifold_flow_tpu_torch.utils import cache, io
from tests import golden_utils as G

# The tier-1 run uses several xdist workers on one host: one thread each.
torch.set_num_threads(1)

TRIALS = {"sub-01": (11, [("run-001", "E1-E2"), ("run-001", "E3-E4")]),
          "sub-02": (10, [("run-002", "F1-F2")])}
KEYS = ["sub-01/run-001/E1-E2", "sub-01/run-001/E3-E4", "sub-02/run-002/F1-F2"]


def bumpy(x, y):
    """A generic bumped surface: symmetric flat meshes flip discrete outputs
    on last-ulp changes (tests/golden_utils.py)."""
    return 0.35 * np.sin(1.3 * x + 0.4) * np.cos(0.9 * y - 0.2)


def write_surface(subject_dir, subject, nx):
    mesh = synthetic.plane_patch(nx=nx, ny=nx, lx=8.0, ly=8.0, height=bumpy,
                                 device="cpu")
    subject_dir.mkdir(parents=True, exist_ok=True)
    path = subject_dir / f"{subject}_reconstructed_surface.ply"
    io.write_ply(path, mesh.points.numpy(), mesh.triangles.numpy())
    return io.read_ply(path)[0]


def two_wave_movie(points, n_frames, rng):
    """Two circular waves over the surface at 512 Hz plus seeded noise."""
    t = np.arange(n_frames)[:, None] / 512.0
    r1 = np.linalg.norm(points[None, :, :2] - np.array([2.1, 2.3]), axis=-1)
    r2 = np.linalg.norm(points[None, :, :2] - np.array([5.9, 6.2]), axis=-1)
    pot = np.cos(2 * np.pi * (r1 - 40 * t) / 3.0) + np.cos(2 * np.pi * (r2 - 40 * t) / 3.5)
    return pot + 0.01 * rng.standard_normal(pot.shape)


def write_trial(trial_dir, points, rng, phases=False, n_frames=6, stem="sub_task"):
    trial_dir.mkdir(parents=True, exist_ok=True)
    pot = two_wave_movie(points, n_frames, rng)
    io.save_indexed_csv(trial_dir / f"{stem}-interpolation_data.csv", pot)
    if phases:
        io.save_indexed_csv(trial_dir / f"{stem}-interpolation_phases_data.csv",
                            rng.uniform(-np.pi, np.pi, pot.shape))


def make_tree(root, sidecar=True):
    """Two subjects, three trials; the first trial of each subject has a
    phases movie; SamplingFrequency 512 in each subject's sidecar."""
    rng = np.random.default_rng(0)
    for subject, (nx, trials) in TRIALS.items():
        points = write_surface(root / subject, subject, nx)
        if sidecar:
            (root / subject / f"{subject}_ieeg.json").write_text(
                json.dumps({"SamplingFrequency": 512}))
        for i, (run, trial) in enumerate(trials):
            write_trial(root / subject / run / trial, points, rng, phases=i == 0)
    return root


def outputs(root):
    """{relative path: path} of every file under `root` but the inputs."""
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*"))
            if p.is_file() and p.suffix not in (".ply", ".json")
            and "interpolation" not in p.name and not p.name.endswith("-ave.csv")
            and not p.name.endswith(".tsv")}


def assert_same_artifacts(got_root, want_root):
    got, want = outputs(got_root), outputs(want_root)
    assert sorted(got) == sorted(want)
    for name in want:
        G.compare_artifact(name, got[name], want[name])


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """One tree swept by JAX's run_batch and a copy by the port's, every
    stage (ALL_STAGES), with the port's launch counts and timings."""
    base = tmp_path_factory.mktemp("swept")
    port_root = make_tree(base / "port")
    jax_root = base / "jax"
    shutil.copytree(port_root, jax_root)
    jax_report = jax_batch.run_batch(jax_root, JaxConfig(), stages=jax_batch.ALL_STAGES)
    kernels.reset_launches()
    timings: dict = {}
    report = batch.run_batch(port_root, PipelineConfig(), stages=batch.ALL_STAGES,
                             device="cpu", timings=timings)
    return port_root, jax_root, report, jax_report, dict(kernels.LAUNCHES), timings


@pytest.fixture
def tree(tmp_path):
    return make_tree(tmp_path / "results")


# ------------------------------------------------------------ discovery ----
def test_discover_and_shard_match_jax(tree):
    trials = batch.discover_trials(tree)
    want = jax_batch.discover_trials(tree)
    assert [tuple(t) for t in trials] == [tuple(t) for t in want]
    assert [t.key for t in trials] == KEYS
    assert trials[0].phases_path is not None and trials[1].phases_path is None
    for n in (1, 2, 3):
        shards = [batch.shard_trials(trials, n, i) for i in range(n)]
        assert [[t.key for t in s] for s in shards] == [
            [t.key for t in jax_batch.shard_trials(want, n, i)] for i in range(n)]
        assert sorted(t.key for s in shards for t in s) == KEYS
    with pytest.raises(ValueError, match="outside"):
        batch.shard_trials(trials, 2, 2)
    assert [t.key for t in batch.discover_trials(tree, subjects=["sub-02"])] == KEYS[2:]
    assert batch.trial_prefix(trials[0]) == jax_batch.trial_prefix(want[0]) == "sub_task"
    assert batch.artifact_names("p") == jax_batch.artifact_names("p")
    for stage in batch.ALL_STAGES:
        assert batch.stage_artifacts(trials[0], stage) == jax_batch.stage_artifacts(
            want[0], stage)
    assert batch.DEVICE_STAGES == jax_batch.DEVICE_STAGES
    assert batch.ALL_STAGES == jax_batch.ALL_STAGES


# ------------------------------------------------------ full run, resume ----
def test_run_batch_matches_jax_then_resumes(swept):
    port_root, jax_root, report, jax_report, launches, _ = swept
    assert report == jax_report
    assert report["errors"] == {} and report["discovered"] == 3
    assert report["trials"][KEYS[0]] == {s: "done" for s in batch.ALL_STAGES}
    assert report["trials"][KEYS[1]]["wavespeed"] == "skipped"
    assert set(launches.values()) == {0}  # CPU tensors launch no kernel
    assert_same_artifacts(port_root, jax_root)
    # 6 movie frames -> 5 velocity frames -> 5 single-frame streamline files.
    tdir = port_root / KEYS[0]
    assert [list(io.load_pickle(tdir / f"t_velocityfields_streamlines_{k}.pkl.bz2"))
            for k in range(5)] == [[str(k)] for k in range(5)]
    assert (port_root / "sub-01" / "sub-01_e.csv").exists()
    again = batch.run_batch(port_root, PipelineConfig(), stages=batch.ALL_STAGES,
                            device="cpu")
    assert again["errors"] == {}
    for key, statuses in again["trials"].items():
        assert set(statuses.values()) == {"skipped"}, (key, statuses)


def test_run_batch_timings(swept):
    _, _, _, _, _, timings = swept
    assert set(timings) == set(KEYS) | {"drain"}
    first = timings[KEYS[0]]
    for s in batch.ALL_STAGES:
        assert first[s] >= 0.0, s
    assert set(first["flow_detail"]) == {"movie_load", "dispatch", "artifact_starts",
                                         "solve_wait", "artifact_submits", "detect"}
    assert set(first["streamline_detail"]) == {"trace", "compact", "submit"}
    for key in ("decompose_detail", "wavespeed_detail", "wavespeed_amplitude_detail"):
        assert set(first[key]) == {"compute", "write"}, key
    assert "wavespeed" not in timings[KEYS[1]] and "drain" not in first


def test_run_trial_records_timings(tree):
    cfg = PipelineConfig()
    trial = batch.discover_trials(tree)[0]
    timings: dict = {}
    res = batch.run_trial(trial, cfg, overwrite=True, timings=timings, device="cpu")
    assert res == {s: "done" for s in batch.DEVICE_STAGES}
    for s in batch.DEVICE_STAGES + ("drain",):
        assert timings[s] >= 0.0, s
    for k in ("movie_load", "dispatch", "artifact_starts", "solve_wait",
              "artifact_submits", "detect"):
        assert timings["flow_detail"][k] >= 0.0, k
    skipped: dict = {}
    assert set(batch.run_trial(trial, cfg, timings=skipped, device="cpu").values()) == {
        "skipped"}
    assert skipped == {}


@pytest.mark.parametrize("stage_set, shards", [
    (("flow",), (2, 1)), (("flow", "winding"), (1, 0)), (("decompose",), (3, 2))],
    ids=["flow_shard1of2", "flow_winding", "decompose_shard2of3"])
def test_stage_subsets_and_shards_match_jax(tmp_path, stage_set, shards):
    port_root = make_tree(tmp_path / "port")
    jax_root = tmp_path / "jax"
    shutil.copytree(port_root, jax_root)
    num, index = shards
    if stage_set == ("decompose",):
        # decompose alone needs V_k.csv: both trees get the flow stage first.
        batch.run_batch(port_root, PipelineConfig(), stages=("flow",), device="cpu")
        jax_batch.run_batch(jax_root, JaxConfig(), stages=("flow",))
    got = batch.run_batch(port_root, PipelineConfig(), stages=stage_set, num_shards=num,
                          shard_index=index, device="cpu")
    want = jax_batch.run_batch(jax_root, JaxConfig(), stages=stage_set, num_shards=num,
                               shard_index=index)
    assert got == want and got["shard"] == [index, num]
    assert list(got["trials"]) == [k for i, k in enumerate(KEYS) if i % num == index]
    assert_same_artifacts(port_root, jax_root)


def test_downstream_stages_resume_from_artifacts(tmp_path):
    """streamline, decompose and winding of a trial whose flow artifacts are
    on disk but not in memory (a fresh process): equal to JAX's resumed run,
    and to the port's run that kept the velocity movie on the device."""
    cfg = PipelineConfig()
    stage_set = ("streamline", "decompose", "winding")
    port_root = make_tree(tmp_path / "port")
    jax_root, kept_root = tmp_path / "jax", tmp_path / "kept"
    shutil.copytree(port_root, jax_root)
    shutil.copytree(port_root, kept_root)
    trial, jtrial, ktrial = (batch.discover_trials(r)[2]
                             for r in (port_root, jax_root, kept_root))
    batch.run_trial(ktrial, cfg, stages=("flow",) + stage_set, device="cpu")
    batch.run_trial(trial, cfg, stages=("flow",), device="cpu")
    jax_batch.run_trial(jtrial, JaxConfig(), stages=("flow",))
    res = batch.run_trial(trial, cfg, stages=stage_set, device="cpu")
    assert res == jax_batch.run_trial(jtrial, JaxConfig(), stages=stage_set)
    assert res == {s: "done" for s in stage_set}
    assert_same_artifacts(port_root, jax_root)
    assert_same_artifacts(port_root, kept_root)
    with pytest.raises(RuntimeError, match="include 'flow'"):
        batch.run_trial(batch.discover_trials(port_root)[0], cfg,
                        stages=("streamline",), device="cpu")


# ------------------------------------------------------------------- S2 ----
def write_interp_tree(root, trial_names, n_grid=8, bad=True, seed=1):
    """One subject with evoked-only trials (no movies yet), its
    electrodes.tsv (grid rows on mesh vertices, a bad channel and an 'n/a'
    row) and a run-matched channels.tsv; SamplingFrequency 16."""
    subj = root / "sub-01"
    points = write_surface(subj, "sub-01", 12)
    (subj / "sub-01_ieeg.json").write_text(json.dumps({"SamplingFrequency": 16}))
    sel = np.linspace(0, len(points) - 1, n_grid + 1).astype(int)
    names = [f"G{i + 1}" for i in range(n_grid)] + (["B1"] if bad else [])
    lines = ["name\tx\ty\tz\tgroup"] + [
        f"{n}\t" + "\t".join(repr(float(x)) for x in points[v]) + "\tgrid"
        for n, v in zip(names, sel)] + ["G99\tn/a\tn/a\tn/a\tgrid"]
    (subj / "sub-01_electrodes.tsv").write_text("\n".join(lines) + "\n")
    ch = ["name\ttype\tstatus\tstatus_description\tgroup"] + [
        f"{n}\tECOG\tgood\tincluded\tgrid" for n in names[:n_grid]]
    if bad:
        ch.append("B1\tECOG\tbad\texcluded\tgrid")
    (subj / "sub-01_run-001_channels.tsv").write_text("\n".join(ch) + "\n")
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, 16)
    for trial in trial_names:
        td = subj / "run-001" / trial
        td.mkdir(parents=True, exist_ok=True)
        data = np.sin(2 * np.pi * 3 * t)[:, None] + 0.1 * rng.normal(size=(16, len(names)))
        io.save_evoked_csv(td / f"sub-01_ses-1_task-SPESclin_run-001-{trial}-ave.csv",
                           data, names)
    return points, sel, names


def interp_config(cls, start=0.25, end=0.75):
    cfg = cls()
    cfg.interpolation.start_time = start
    cfg.interpolation.end_time = end
    cfg.analysis.min_streamline_length = 3
    return cfg


def same_report(got, want, got_root, want_root):
    assert json.dumps(got, sort_keys=True).replace(str(got_root), "ROOT") == json.dumps(
        want, sort_keys=True).replace(str(want_root), "ROOT")


def test_interpolate_batch_stage_matches_jax(tmp_path):
    """S2 as a batch stage: the stimulated pair G1-G2 parsed from the trial
    name and excluded, the channel predicate applied, both movies written
    under the reference's names, then the flow stage on them, in one
    run_batch call; a second sweep skips both."""
    port_root = tmp_path / "port"
    points, sel, _ = write_interp_tree(port_root, ["G1-G2"])
    jax_root = tmp_path / "jax"
    shutil.copytree(port_root, jax_root)
    stage_set = ("interpolate", "flow")
    got = batch.run_batch(port_root, interp_config(PipelineConfig), stages=stage_set,
                          device="cpu")
    want = jax_batch.run_batch(jax_root, interp_config(JaxConfig), stages=stage_set)
    same_report(got, want, port_root, jax_root)
    interp = got["interpolation"]["sub-01/run-001/G1-G2"]
    assert interp["status"] == "done" and interp["excluded"] == ["G1", "G2"]
    assert interp["n_electrodes"] == 6
    stem = "sub-01_ses-1_task-SPESclin_run-001-G1-G2"
    tdir = port_root / "sub-01" / "run-001" / "G1-G2"
    for suffix in ("interpolation_data.csv", "interpolation_phases_data.csv"):
        movie = io.load_indexed_csv(tdir / f"{stem}-ave-{suffix}")
        want_movie = jax_io.load_indexed_csv(jax_root / tdir.relative_to(port_root)
                                             / f"{stem}-ave-{suffix}")
        assert movie.shape == (8, len(points))  # [0.25, 0.75) s at 16 Hz
        if "phases" in suffix:
            assert float(np.abs(np.angle(np.exp(1j * (movie - want_movie)))).max()) <= 1e-9
        else:
            np.testing.assert_allclose(movie, want_movie, rtol=0, atol=1e-9 * float(
                np.abs(want_movie).max()))
    assert_same_artifacts(port_root, jax_root)
    again = batch.run_batch(port_root, interp_config(PipelineConfig), stages=stage_set,
                            device="cpu")
    assert again["interpolation"]["sub-01/run-001/G1-G2"]["status"] == "skipped"
    assert again["trials"]["sub-01/run-001/G1-G2"]["flow"] == "skipped"


def test_interpolate_sharded_trial_list_matches_jax(tmp_path):
    """With sharded interpolation every shard agrees on the post-S2 trial
    list while another shard's movies do not exist yet."""
    port_root = tmp_path / "port"
    write_interp_tree(port_root, ["G1-G2", "G3-G4"], n_grid=6, bad=False)
    jax_root = tmp_path / "jax"
    shutil.copytree(port_root, jax_root)
    stage_set = ("interpolate", "flow")
    for index in (0, 1):
        got = batch.run_batch(port_root, interp_config(PipelineConfig, 0.0, 1.0),
                              stages=stage_set, num_shards=2, shard_index=index,
                              device="cpu")
        want = jax_batch.run_batch(jax_root, interp_config(JaxConfig, 0.0, 1.0),
                                   stages=stage_set, num_shards=2, shard_index=index)
        same_report(got, want, port_root, jax_root)
        key = f"sub-01/run-001/G{2 * index + 1}-G{2 * index + 2}"
        assert got["discovered"] == 2 and got["errors"] == {}
        assert list(got["interpolation"]) == list(got["trials"]) == [key]
    assert_same_artifacts(port_root, jax_root)


def test_selected_channel_names_match_jax(tmp_path):
    rows = ["name\ttype\tstatus\tstatus_description\tgroup",
            "G1\tECOG\tgood\tincluded\tgrid", "G2\tECOG\tgood\tincluded\tstrip",
            "G3\tECOG\tbad\tincluded\tgrid", "G4\tSEEG\tgood\tincluded\tgrid",
            "G5\tECOG\tgood\texcluded\tgrid", "n/a\tECOG\tgood\tincluded\tgrid",
            "G7\tECOG\tgood\tincluded\tgrid", "G8\tECOG\tgood\tincluded\tgrid"]
    path = tmp_path / "channels.tsv"
    path.write_text("\n".join(rows) + "\n")
    for pair in ((), ("G1", "G8"), ("G7", "X1")):
        got = batch.selected_channel_names(path, pair)
        assert got == jax_batch.selected_channel_names(path, pair)
    assert batch.selected_channel_names(path, ("G1", "G8")) == (["G7"], ["G1", "G8"])
    # A table without the group column selects nothing, as in JAX.
    (tmp_path / "nogroup.tsv").write_text(
        "name\ttype\tstatus\tstatus_description\nG1\tECOG\tgood\tincluded\n")
    assert batch.selected_channel_names(tmp_path / "nogroup.tsv") == (
        jax_batch.selected_channel_names(tmp_path / "nogroup.tsv")) == ([], [])


def test_interpolation_fif_without_mne_is_recorded(tmp_path):
    """A .fif-only evoked needs MNE: the ImportError names it and lands in
    the report under the trial's interpolate key; the sweep goes on."""
    root = tmp_path / "results"
    write_interp_tree(root, ["G1-G2", "G3-G4"], n_grid=6, bad=False)
    td = root / "sub-01" / "run-001" / "G1-G2"
    csv_path = next(td.glob("*-ave.csv"))
    csv_path.rename(td / csv_path.name.replace("-ave.csv", "-ave.fif"))
    try:
        import mne  # noqa: F401
        pytest.skip("mne is installed")
    except ImportError:
        pass
    report = batch.run_batch(root, interp_config(PipelineConfig, 0.0, 1.0),
                             stages=("interpolate",), device="cpu")
    key = "interpolate:sub-01/run-001/G1-G2"
    assert list(report["errors"]) == [key]
    assert report["errors"][key].startswith("ImportError") and "MNE" in report["errors"][key]
    assert report["interpolation"]["sub-01/run-001/G3-G4"]["status"] == "done"


# ------------------------------------------------------- small contracts ----
def test_streamline_artifacts_single_frame_movie(tmp_path):
    """A movie of at most one frame has no velocity frame, hence no
    per-frame streamline file: the stage is trivially done."""
    trial_dir = tmp_path / "sub-01" / "run-001" / "T1"
    trial_dir.mkdir(parents=True)
    io.save_indexed_csv(trial_dir / "one-interpolation_data.csv", np.zeros((1, 9)))
    fields = dict(subject="sub-01", run="run-001", trial="T1", trial_dir=trial_dir,
                  surface_path=trial_dir / "unused.ply",
                  movie_path=trial_dir / "one-interpolation_data.csv", phases_path=None)
    trial = batch.TrialRef(**fields)
    assert batch.stage_artifacts(trial, "streamline") == [] == jax_batch.stage_artifacts(
        jax_batch.TrialRef(**fields), "streamline")
    assert batch.stage_done(trial, "streamline")
    with pytest.raises(ValueError, match="unknown batch stage"):
        batch.stage_artifacts(trial, "render")


def test_movie_frames_cached_by_stat(tree):
    trials = batch.discover_trials(tree)
    batch._FRAMES_CACHE.clear()
    n1 = batch._movie_frames(trials[0])
    assert n1 == jax_batch._movie_frames(jax_batch.discover_trials(tree)[0]) == 6
    assert len(batch._FRAMES_CACHE) == 1
    assert batch._movie_frames(trials[0]) == n1
    assert len(batch._FRAMES_CACHE) == 1  # the second call hit the cache
    cfg = PipelineConfig()
    cfg.solver.time_steps = 4
    assert batch._movie_frames(trials[0], cfg) == 4
    # A rewritten movie of another size is a new key: counted again.
    io.save_indexed_csv(trials[0].movie_path, np.zeros((9, 3)))
    assert batch._movie_frames(trials[0]) == 9
    assert len(batch._FRAMES_CACHE) == 2


def test_unit_dt_fallback_warns(tmp_path, caplog):
    """A missing SamplingFrequency warns, naming the trial, before times
    degrade to frame indices; the artifacts equal JAX's unit-dt run."""
    port_root = make_tree(tmp_path / "port", sidecar=False)
    jax_root = tmp_path / "jax"
    shutil.copytree(port_root, jax_root)
    trial = batch.discover_trials(port_root)[2]
    with caplog.at_level(logging.WARNING, logger="manifold_flow_tpu_torch"):
        batch.run_trial(trial, PipelineConfig(), stages=("flow",), device="cpu")
    assert any("SamplingFrequency" in r.getMessage() and trial.key in r.getMessage()
               for r in caplog.records)
    jax_batch.run_trial(jax_batch.discover_trials(jax_root)[2], JaxConfig(),
                        stages=("flow",))
    assert_same_artifacts(port_root, jax_root)


def test_per_trial_isolation_matches_jax(tmp_path):
    """A corrupt trial is recorded in errors; the sweep continues."""
    port_root = tmp_path / "port"
    points = write_surface(port_root / "sub-03", "sub-03", 10)
    write_trial(port_root / "sub-03" / "run-001" / "good", points,
                np.random.default_rng(5))
    bad = port_root / "sub-03" / "run-001" / "bad"
    bad.mkdir(parents=True)
    (bad / "x-interpolation_data.csv").write_text("not,a,movie\n1,2,oops\n")
    jax_root = tmp_path / "jax"
    shutil.copytree(port_root, jax_root)
    got = batch.run_batch(port_root, PipelineConfig(), stages=("flow",), device="cpu")
    want = jax_batch.run_batch(jax_root, JaxConfig(), stages=("flow",))
    assert list(got["errors"]) == list(want["errors"]) == ["sub-03/run-001/bad"]
    assert got["errors"]["sub-03/run-001/bad"].startswith("ValueError")
    assert got["trials"] == want["trials"] == {"sub-03/run-001/good": {"flow": "done"}}


def test_writer_failure_surfaces_in_the_report(tree, monkeypatch):
    """A failed write on the sweep's shared writer is not swallowed: it
    raises into the trial running when it surfaces, or at the final drain."""
    def fail(path, *args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(io, "save_pickle", fail)
    report = batch.run_batch(tree, PipelineConfig(), stages=("flow",), device="cpu")
    assert report["errors"]
    assert all("disk full" in message for message in report["errors"].values())


def test_winding_in_memory_handoff_matches_disk(tmp_path):
    """The winding stage fed this run's points and snapped centers in memory
    writes the artifact a resumed run writes from the pickle on disk."""
    roots = [make_tree(tmp_path / name) for name in ("same-run", "resumed")]
    cfg = PipelineConfig()
    t0, t1 = (batch.discover_trials(r)[0] for r in roots)
    batch.run_trial(t0, cfg, stages=("flow", "winding"), device="cpu")
    batch.run_trial(t1, cfg, stages=("flow",), device="cpu")
    batch.run_trial(t1, cfg, stages=("winding",), device="cpu")
    name = batch.artifact_names(batch.trial_prefix(t0))["winding"]
    a, b = io.load_pickle(t0.trial_dir / name), io.load_pickle(t1.trial_dir / name)
    assert list(a) == list(b) and sum(len(v) for v in a.values()) > 0
    for k in a:
        assert len(a[k]) == len(b[k])
        for ra, rb in zip(a[k], b[k]):
            np.testing.assert_array_equal(ra[0], rb[0])
            assert ra[1:] == rb[1:]


# ---------------------------------------------------------------- golden ----
@pytest.mark.parametrize("quirks", [False, True], ids=["quirks_off", "quirks_on"])
def test_run_trial_reproduces_golden_tree(tmp_path, quirks):
    """The port's run_trial(stages=ALL_STAGES) on the golden trees' inputs
    reproduces every artifact of the tree (tests/golden_utils.py)."""
    golden = G.mode_dir(quirks)
    root = tmp_path / "fresh"
    subj, tdir = root / G.SUBJECT, root / G.SUBJECT / G.RUN / G.TRIAL
    tdir.mkdir(parents=True)
    for name in (f"{G.SUBJECT}_reconstructed_surface.ply", f"{G.SUBJECT}_ieeg.json"):
        shutil.copy(golden / G.SUBJECT / name, subj / name)
    for suffix in ("interpolation_data.csv", "interpolation_phases_data.csv"):
        name = f"{G.STEM}-ave-{suffix}"
        shutil.copy(golden / G.SUBJECT / G.RUN / G.TRIAL / name, tdir / name)
    cfg = PipelineConfig()
    cfg.reference_quirks = quirks
    cfg.solver.tol = 1e-10
    cfg.analysis.min_streamline_length = 3
    (trial,) = batch.discover_trials(root)
    report = batch.run_trial(trial, cfg, stages=batch.ALL_STAGES, overwrite=True,
                             device="cpu")
    assert report == {s: "done" for s in batch.ALL_STAGES}
    got, want = G.artifact_files(root), G.artifact_files(golden)
    assert sorted(got) == sorted(want) and len(want) == 11
    for name in sorted(want):
        G.compare_artifact(name, got[name], want[name])


# ----------------------------------------------------------------- cache ----
@pytest.fixture
def surface(tmp_path):
    path = tmp_path / "s_reconstructed_surface.ply"
    write_surface(tmp_path, "s", 9)
    return path


def assert_same_mesh(got, want):
    for name in ARRAY_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_cache_digest_matches_jax(surface):
    from manifold_flow_tpu.utils import cache as jax_cache

    pts, tris = io.read_ply(surface)
    key = cache.mesh_content_hash(pts, tris)
    assert key == jax_cache.mesh_content_hash(pts, tris) and len(key) == 24
    assert cache.mesh_content_hash(pts.astype(np.float32), tris) == (
        jax_cache.mesh_content_hash(pts.astype(np.float32), tris))
    assert cache.mesh_content_hash(pts + 1e-9, tris) != key


def test_cache_round_trip_and_load_surface(surface, tmp_path):
    cache_dir = tmp_path / "cache"
    plain = stages.load_surface(surface, device="cpu")
    first = stages.load_surface(surface, cache_dir=cache_dir, device="cpu")
    (entry,) = cache_dir.iterdir()
    assert entry.name.startswith("torch_mesh_") and entry.name.endswith("_float64.npz")
    second = stages.load_surface(surface, cache_dir=cache_dir, device="cpu")
    assert_same_mesh(first, plain)
    assert_same_mesh(second, plain)
    assert_same_mesh(cache.load_mesh(entry, device="cpu"), plain)
    path = tmp_path / "m.npz"
    cache.save_mesh(path, plain)
    assert_same_mesh(cache.load_mesh(path, device="cpu"), plain)
    f32 = cache.build_mesh_cached(*io.read_ply(surface), cache_dir=cache_dir,
                                  dtype=np.float32, device="cpu")
    assert f32.points.dtype == torch.float32 and len(list(cache_dir.iterdir())) == 2


def test_corrupt_cache_entry_is_rebuilt(surface, tmp_path, caplog):
    cache_dir = tmp_path / "cache"
    plain = stages.load_surface(surface, cache_dir=cache_dir, device="cpu")
    (entry,) = cache_dir.iterdir()
    entry.write_bytes(b"not an npz")
    with caplog.at_level(logging.WARNING, logger="manifold_flow_tpu_torch"):
        mesh = stages.load_surface(surface, cache_dir=cache_dir, device="cpu")
    assert any("unreadable; rebuilding" in r.getMessage() for r in caplog.records)
    assert_same_mesh(mesh, plain)
    assert_same_mesh(cache.load_mesh(entry, device="cpu"), plain)  # written again


def test_jax_cache_entry_is_never_read(surface, tmp_path, caplog):
    """A cache directory shared with the JAX package: each package reads
    only its own entries, and a JAX file under the port's name is refused
    and rebuilt."""
    from manifold_flow_tpu.pipeline import stages as jax_stages

    cache_dir = tmp_path / "cache"
    jax_stages.load_surface(surface, cache_dir=cache_dir)
    (jax_entry,) = cache_dir.iterdir()
    plain = stages.load_surface(surface, device="cpu")
    mesh = stages.load_surface(surface, cache_dir=cache_dir, device="cpu")
    assert_same_mesh(mesh, plain)
    port_entry = cache.entry_path(cache_dir, cache.mesh_content_hash(*io.read_ply(surface)),
                                  np.float64)
    assert sorted(p.name for p in cache_dir.iterdir()) == sorted(
        [jax_entry.name, port_entry.name]) and jax_entry.name != port_entry.name
    jax_stages.load_surface(surface, cache_dir=cache_dir)  # JAX reads its own entry
    with pytest.raises(ValueError, match="cache entry"):
        cache.load_mesh(jax_entry, device="cpu")
    shutil.copy(jax_entry, port_entry)
    with caplog.at_level(logging.WARNING, logger="manifold_flow_tpu_torch"):
        mesh = stages.load_surface(surface, cache_dir=cache_dir, device="cpu")
    assert any("rebuilding" in r.getMessage() for r in caplog.records)
    assert_same_mesh(mesh, plain)


def test_batch_with_cache_dir_matches_without(tmp_path):
    port_root, plain_root = make_tree(tmp_path / "cached"), tmp_path / "plain"
    shutil.copytree(port_root, plain_root)
    cached = batch.run_batch(port_root, PipelineConfig(), cache_dir=tmp_path / "cache",
                             device="cpu")
    plain = batch.run_batch(plain_root, PipelineConfig(), device="cpu")
    assert cached == plain and cached["errors"] == {}
    assert len(list((tmp_path / "cache").iterdir())) == 2  # one entry a surface
    assert_same_artifacts(port_root, plain_root)


# ------------------------------------------------------------ host files ----
def test_evoked_csv_round_trip_matches_jax(tmp_path):
    """The portable evoked CSV: the bytes JAX writes, the data back exactly,
    the channel names in order."""
    rng = np.random.default_rng(2)
    data = rng.normal(size=(7, 4))
    names = ["G1", "G2", "LT3", "B1"]
    io.save_evoked_csv(tmp_path / "port-ave.csv", data, names)
    jax_io.save_evoked_csv(tmp_path / "jax-ave.csv", data, names)
    assert (tmp_path / "port-ave.csv").read_bytes() == (tmp_path / "jax-ave.csv").read_bytes()
    back, names_back = io.load_evoked_csv(tmp_path / "jax-ave.csv")
    want, want_names = jax_io.load_evoked_csv(tmp_path / "jax-ave.csv")
    assert names_back == want_names == names
    np.testing.assert_array_equal(back, data)
    np.testing.assert_array_equal(back, want)
    with pytest.raises(ValueError, match="channel names"):
        io.save_evoked_csv(tmp_path / "x-ave.csv", data, names[:3])


def test_freesurfer_surface_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    verts = rng.normal(size=(11, 3)) * 40.0
    faces = rng.integers(0, 11, size=(7, 3))
    io.write_freesurfer_surface(tmp_path / "lh.port", verts, faces, comment="port")
    jax_io.write_freesurfer_surface(tmp_path / "lh.jax", verts, faces, comment="port")
    assert (tmp_path / "lh.port").read_bytes() == (tmp_path / "lh.jax").read_bytes()
    got, want = io.read_freesurfer_surface(tmp_path / "lh.jax"), jax_io.read_freesurfer_surface(
        tmp_path / "lh.jax")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], verts.astype(np.float32).astype(np.float64))
    np.testing.assert_array_equal(got[1], faces)
    (tmp_path / "bad").write_bytes(b"\x00\x00\x01rest")
    with pytest.raises(ValueError, match="not a FreeSurfer"):
        io.read_freesurfer_surface(tmp_path / "bad")


# ------------------------------------------------------------------- CLI ----
def test_batch_cli_prints_the_report(swept, tmp_path, capsys, monkeypatch):
    """`batch --device cpu` on a copy of the swept tree: with --overwrite
    every stage runs again and the artifacts equal JAX's; without it every
    stage is skipped; a failing trial makes it return 1."""
    port_root, jax_root, report, _, _, _ = swept
    root = tmp_path / "tree"
    shutil.copytree(port_root, root)
    stage_args = ["--stages", *batch.ALL_STAGES]
    assert cli.main(["batch", "--root", str(root), *stage_args, "--overwrite",
                     "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["stage"] == "batch" and line["device"] == "cpu"
    assert {k: line[k] for k in report} == report
    assert_same_artifacts(root, jax_root)
    assert cli.main(["batch", "--root", str(root), *stage_args, "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out)
    assert all(set(v.values()) == {"skipped"} for v in line["trials"].values())
    (root / KEYS[1] / "sub_task-V_k.csv").unlink()
    (root / KEYS[1] / "sub_task-interpolation_data.csv").write_text("not,a\n1,x\n")
    assert cli.main(["batch", "--root", str(root), "--device", "cpu"]) == 1
    line = json.loads(capsys.readouterr().out)
    assert list(line["errors"]) == [KEYS[1]]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        cli.main(["batch", "--root", str(root)])  # --device cuda is the default
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        batch.run_batch(root, PipelineConfig())
