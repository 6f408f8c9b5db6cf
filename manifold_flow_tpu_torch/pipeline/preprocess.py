"""S0: clinical iEEG (CCEP ECoG, BIDS ds004080) preprocessing.

Counterpart of manifold_flow_tpu/pipeline/preprocess.py. A host stage that
runs once per subject, with no device compute: BrainVision recordings are
band-passed, notch-filtered at the recording's power-line frequency,
restricted to good included ECOG channels, average-referenced, epoched on
electrical-stimulation events, and reduced to per-stimulation-site evoked
averages. Behaviour as the reference's S0_preprocess.py:53-172 (filter band
S0:17-19, channel predicate S0:65-77, event construction S0:84-105, epoch
window and baseline S0:107-117, artifact naming S0:119-130, per-run
exception isolation S0:159-172).

The BIDS tables are read with the csv module (utils.io.read_tsv), where
the JAX package uses pandas, with the same row rules and results: a column
the table lacks matches no row, and a name pandas reads as NaN is dropped. The filtering and epoching
need MNE-Python, imported only when they run: without it they raise
ImportError naming MNE.
"""

from __future__ import annotations

import json
import logging
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable

import numpy as np

from manifold_flow_tpu_torch.pipeline.config import PreprocessConfig
from manifold_flow_tpu_torch.utils import io

logger = logging.getLogger(__name__)

_RUN_PATTERN = re.compile(r"run-(\d{6})")
_TASK = "task-SPESclin"


def _require_mne():
    try:
        import mne
    except ImportError as e:
        raise ImportError(
            "the preprocessing stage requires MNE-Python; install it or start "
            "the pipeline from precomputed evokeds") from e
    return mne


@dataclass(frozen=True)
class RunFiles:
    """The BIDS sidecar bundle of one task run."""

    subject: str
    session: str
    run: str
    vhdr: Path
    sidecar_json: Path
    events_tsv: Path
    channels_tsv: Path

    @property
    def stem(self) -> str:
        return f"{self.subject}_{self.session}_{_TASK}_run-{self.run}"


def discover_runs(subject_dir: Path) -> list[RunFiles]:
    """Enumerate run bundles under <subject>/<first session>/ieeg.

    The dataset stores exactly one session per subject; the reference takes
    the first directory entry (S0_preprocess.py:140).
    """
    subject_dir = Path(subject_dir)
    sessions = sorted(p for p in subject_dir.iterdir() if p.is_dir())
    if not sessions:
        raise FileNotFoundError(f"no session directory under {subject_dir}")
    session = sessions[0].name
    ieeg = subject_dir / session / "ieeg"
    if not ieeg.is_dir():
        raise FileNotFoundError(f"no ieeg directory under {subject_dir/session}")
    runs = sorted({m.group(1) for f in ieeg.iterdir()
                   if (m := _RUN_PATTERN.search(f.name))})
    subject = subject_dir.name
    out = []
    for run in runs:
        stem = f"{subject}_{session}_{_TASK}_run-{run}"
        out.append(RunFiles(
            subject=subject, session=session, run=run,
            vhdr=ieeg / f"{stem}_ieeg.vhdr",
            sidecar_json=ieeg / f"{stem}_ieeg.json",
            events_tsv=ieeg / f"{stem}_events.tsv",
            channels_tsv=ieeg / f"{stem}_channels.tsv",
        ))
    return out


def good_ecog_channels(channels_tsv: Path) -> list[str]:
    """Channel names with type==ECOG, status==good, status_description==included
    (the reference's pick predicate, S0_preprocess.py:65-77)."""
    return [row["name"] for row in io.read_tsv(channels_tsv)
            if row.get("type") == "ECOG" and row.get("status") == "good"
            and row.get("status_description") == "included"
            and not io.is_na(row["name"])]


def stimulation_events(events_tsv: Path) -> tuple[np.ndarray, dict[str, int]]:
    """(events, event_id) for MNE from electrical_stimulation rows.

    Event codes are assigned per stimulation site in order of first
    appearance (S0_preprocess.py:84-105).
    """
    stim = [row for row in io.read_tsv(events_tsv)
            if row.get("trial_type") == "electrical_stimulation"]
    if not stim:
        raise ValueError(f"no electrical_stimulation events in {events_tsv}")
    event_id: dict[str, int] = {}
    rows = []
    for row in stim:
        site = row["electrical_stimulation_site"]
        code = event_id.setdefault("nan" if io.is_na(site) else site, len(event_id))
        rows.append((int(float(row["sample_start"])), 0, code))
    return np.asarray(rows, dtype=int), event_id


def power_line_frequency(sidecar_json: Path, default: float) -> float:
    with open(sidecar_json, "r", encoding="utf-8") as f:
        return float(json.load(f).get("PowerLineFrequency", default))


def preprocess_run(files: RunFiles, out_dir: Path,
                   config: PreprocessConfig | None = None):
    """One run: filter -> pick -> re-reference -> epoch -> per-site evokeds.

    Writes <stem>-epo.fif plus <stem>-<site>-ave.fif per stimulation site
    (both at the run root and in a per-site subdirectory, the reference's
    artifact layout, S0_preprocess.py:119-130), and beside each per-site
    .fif its portable CSV twin (utils.io.save_evoked_csv). Returns the
    epochs object. Needs MNE-Python.
    """
    mne = _require_mne()
    config = config or PreprocessConfig()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    raw = mne.io.read_raw_brainvision(str(files.vhdr), preload=True)
    raw.filter(l_freq=config.low_freq, h_freq=config.high_freq)
    raw.notch_filter(freqs=power_line_frequency(
        files.sidecar_json, config.power_line_default))

    wanted = good_ecog_channels(files.channels_tsv)
    present = [ch for ch in wanted if ch in raw.ch_names]
    if not present:
        raise ValueError(
            f"none of the {len(wanted)} selected channels exist in the "
            f"recording {files.vhdr.name}")
    raw.pick(present)
    raw, _ = mne.set_eeg_reference(raw, ref_channels="average", copy=False)

    events, event_id = stimulation_events(files.events_tsv)
    epochs = mne.Epochs(
        raw, events, event_id=event_id,
        tmin=config.tmin, tmax=config.tmax,
        baseline=tuple(config.baseline), preload=True)
    epochs.save(str(out_dir / f"{files.stem.replace('_ieeg', '')}-epo.fif"),
                overwrite=True)

    for site in event_id:
        evoked = epochs[site].average()
        name = f"{files.stem}-{site}-ave.fif"
        evoked.save(str(out_dir / name), overwrite=True)
        site_dir = out_dir / site
        site_dir.mkdir(exist_ok=True)
        evoked.save(str(site_dir / name), overwrite=True)
        io.save_evoked_csv(site_dir / name.replace("-ave.fif", "-ave.csv"),
                           evoked.get_data().T, evoked.ch_names)
    return epochs


def process_subject(subject_dir, results_dir,
                    config: PreprocessConfig | None = None,
                    runs: Iterable[str] | None = None) -> list[str]:
    """All runs of one subject; one failed run logs and continues
    (S0_preprocess.py:159-172). Returns the run ids that succeeded. Needs
    MNE-Python."""
    _require_mne()
    subject_dir = Path(subject_dir)
    results_dir = Path(results_dir)
    done = []
    for files in discover_runs(subject_dir):
        if runs is not None and files.run not in set(runs):
            continue
        out_dir = results_dir / subject_dir.name / f"run-{files.run}"
        try:
            preprocess_run(files, out_dir, config)
            done.append(files.run)
        except Exception:
            logger.exception("run %s of %s failed; continuing",
                             files.run, subject_dir.name)
    return done
