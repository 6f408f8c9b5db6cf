"""The port's S0 (pipeline/preprocess.py, preprocess_subject and the
`preprocess` command line) held against the JAX package on the CPU.

The port reads the BIDS tables with the csv module where JAX uses pandas:
the run bundles, channel lists, event arrays (dtype and values) and event
codes must be equal. The filtering and epoching need MNE-Python, which
neither this machine nor the GPU machine has: the only behaviour a test can
check there is the ImportError naming it.
"""

import dataclasses
import json

import numpy as np
import pytest

from manifold_flow_tpu.pipeline import preprocess as jax_preprocess
from manifold_flow_tpu_torch.pipeline import cli, preprocess, stages
from manifold_flow_tpu_torch.pipeline.config import PipelineConfig

CHANNELS = ("name\ttype\tstatus\tstatus_description\n"
            "G1\tECOG\tgood\tincluded\n"
            "G2\tECOG\tbad\tincluded\n"
            "G3\tECOG\tgood\texcluded\n"
            "EKG\tECG\tgood\tincluded\n"
            "G4\tECOG\tgood\tincluded\n")
EVENTS = ("onset\tsample_start\ttrial_type\telectrical_stimulation_site\n"
          "1.0\t2048\telectrical_stimulation\tG1-G2\n"
          "2.0\t4096\tartifact\tn/a\n"
          "3.0\t6144\telectrical_stimulation\tG3-G4\n"
          "4.0\t8192\telectrical_stimulation\tG1-G2\n")


@pytest.fixture
def bids_subject(tmp_path):
    """tests/test_preprocess.py's subject: two runs of one session."""
    subj = tmp_path / "sub-test01"
    ieeg = subj / "ses-1" / "ieeg"
    ieeg.mkdir(parents=True)
    for run in ("021448", "031516"):
        stem = f"sub-test01_ses-1_task-SPESclin_run-{run}"
        (ieeg / f"{stem}_ieeg.vhdr").write_text("")
        (ieeg / f"{stem}_ieeg.json").write_text(
            json.dumps({"PowerLineFrequency": 50, "SamplingFrequency": 2048}))
        (ieeg / f"{stem}_channels.tsv").write_text(CHANNELS)
        (ieeg / f"{stem}_events.tsv").write_text(EVENTS)
    return subj


def test_discover_runs_matches_jax(bids_subject):
    runs = preprocess.discover_runs(bids_subject)
    want = jax_preprocess.discover_runs(bids_subject)
    assert [dataclasses.asdict(r) for r in runs] == [dataclasses.asdict(r) for r in want]
    assert [r.run for r in runs] == ["021448", "031516"]
    assert runs[0].stem == want[0].stem == "sub-test01_ses-1_task-SPESclin_run-021448"
    assert runs[0].vhdr.exists()


@pytest.mark.parametrize("table", [
    CHANNELS,
    CHANNELS + "n/a\tECOG\tgood\tincluded\nG9\tECOG\tgood\tincluded\n",
    "name\ttype\tstatus\nG1\tECOG\tgood\n",
    "name\ttype\tstatus\tstatus_description\tgroup\n"
    "G1\tECOG\tgood\tincluded\tgrid\nG2\t\tgood\tincluded\tgrid\n"
    "G3\tECOG\tgood\tincluded\tstrip\n"],
    ids=["reference", "na_name", "no_description_column", "empty_type"])
def test_good_ecog_channels_match_jax(tmp_path, table):
    path = tmp_path / "channels.tsv"
    path.write_text(table)
    got = preprocess.good_ecog_channels(path)
    assert got == jax_preprocess.good_ecog_channels(path)
    if table == CHANNELS:
        assert got == ["G1", "G4"]  # ECOG & good & included (S0:65-77)


@pytest.mark.parametrize("table", [
    EVENTS,
    EVENTS.replace("2.0\t4096\tartifact", "2.0\tn/a\tartifact"),
    EVENTS + "5.0\t10240\telectrical_stimulation\tn/a\n"],
    ids=["reference", "na_sample", "na_site"])
def test_stimulation_events_match_jax(tmp_path, table):
    path = tmp_path / "events.tsv"
    path.write_text(table)
    events, event_id = preprocess.stimulation_events(path)
    want_events, want_id = jax_preprocess.stimulation_events(path)
    assert event_id == want_id
    assert events.dtype == want_events.dtype
    np.testing.assert_array_equal(events, want_events)
    if table == EVENTS:
        assert event_id == {"G1-G2": 0, "G3-G4": 1}
        np.testing.assert_array_equal(events, [[2048, 0, 0], [6144, 0, 1], [8192, 0, 0]])


def test_no_stimulation_events_raise_like_jax(tmp_path):
    path = tmp_path / "events.tsv"
    path.write_text("onset\tsample_start\ttrial_type\telectrical_stimulation_site\n"
                    "1.0\t2048\tartifact\tn/a\n")
    for module in (preprocess, jax_preprocess):
        with pytest.raises(ValueError, match="no electrical_stimulation events"):
            module.stimulation_events(path)


@pytest.mark.parametrize("sidecar, default", [
    ({"PowerLineFrequency": 50, "SamplingFrequency": 2048}, 60.0),
    ({"SamplingFrequency": 2048}, 60.0)], ids=["given", "default"])
def test_power_line_frequency_matches_jax(tmp_path, sidecar, default):
    path = tmp_path / "ieeg.json"
    path.write_text(json.dumps(sidecar))
    got = preprocess.power_line_frequency(path, default)
    assert got == jax_preprocess.power_line_frequency(path, default)
    assert got == sidecar.get("PowerLineFrequency", default)


@pytest.mark.parametrize("layout", ["no_session", "no_ieeg"])
def test_missing_session_raises_like_jax(tmp_path, layout):
    subj = tmp_path / "sub-empty"
    (subj / "ses-1" if layout == "no_ieeg" else subj).mkdir(parents=True)
    for module in (preprocess, jax_preprocess):
        with pytest.raises(FileNotFoundError):
            module.discover_runs(subj)


def test_preprocessing_without_mne_names_it(bids_subject, tmp_path, capsys):
    """process_subject, preprocess_run, preprocess_subject and the
    `preprocess` subcommand raise ImportError naming MNE-Python, before
    writing anything."""
    try:
        import mne  # noqa: F401
        pytest.skip("mne is installed")
    except ImportError:
        pass
    out = tmp_path / "results"
    runs = preprocess.discover_runs(bids_subject)
    calls = (lambda: preprocess.process_subject(bids_subject, out),
             lambda: preprocess.preprocess_run(runs[0], out),
             lambda: stages.preprocess_subject(bids_subject, out, PipelineConfig()),
             lambda: cli.main(["preprocess", "--subject-dir", str(bids_subject),
                               "--device", "cpu", "--out-dir", str(out)]))
    for call in calls:
        with pytest.raises(ImportError, match="MNE-Python"):
            call()
    assert not out.exists() and capsys.readouterr().out == ""
