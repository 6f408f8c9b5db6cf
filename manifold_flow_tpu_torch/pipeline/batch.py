"""Batch runs over a subjects/runs/trials results tree.

Counterpart of manifold_flow_tpu/pipeline/batch.py. The reference's cluster
layer is argv-sharded loops over a shared results tree: one Slurm task per
subject walks run folders (S2_interpolate.py:79-102), and one task per
(subject, run, trial) runs each analysis script (S5_compute_wave_v.py:
264-300, S7_winding_line.py:205-261). A re-run recreates whatever artifacts
are missing.

This module is that layer as one process. It discovers trials under the
reference's tree layout

    <root>/<subject>/*reconstructed_surface.ply
    <root>/<subject>/run-<NNN>/<trial>/*interpolation_data.csv
    <root>/<subject>/run-<NNN>/<trial>/*interpolation_phases_data.csv  (opt.)

then, for each trial, runs the device stages S3 (flow + singularities), S6
(streamlines), S4 (SVD), S5 (wave speeds, when a phases movie exists) and
S7 (winding lines) on the GPU (device="cuda", the default) or the CPU,
writing artifacts next to the inputs and SKIPPING any stage whose artifacts
already exist (resume by presence). Trials are sharded round robin across
hosts from explicit shard arguments (trial i belongs to shard
i % num_shards). One failing trial is recorded and the sweep continues.
S2 is a batch stage too ('interpolate'): trials holding per-site evokeds
(+ BIDS TSVs) get their stimulated pair parsed from the trial name and
excluded, the reference's channel predicate applied, and both potentials
and phases movies written (discover_interpolation_tasks /
run_interpolation, as S2_interpolate.py:79-160).

In one process the stage inputs stay on the card: the velocity movie the
flow stage leaves on the mesh's device feeds the singularity, streamline,
SVD and winding stages as it lies; a resumed trial uploads its V_k.csv once.
Each surface is loaded once per sweep (`mesh_cache`), so the per-mesh
tables (hop tables, coarse tables, ring tables) are built once. Artifact
writes overlap the next stage and the next trial, and the next trial's
movie is parsed while this one computes.

Not ported: the JAX package's shape padding (`pad_meshes`), which exists so
that XLA compiles one program for every surface, and its float32 analysis
cast, which exists because the TPU emulates float64.

Several ranks (torch.distributed, one process each; parallel.multihost):
`distributed=True` splits the trials over the ranks (shard = rank, count =
world size), each rank a single-device sweep; a `device_mesh`
(parallel.make_device_mesh) runs every trial on all of its ranks, the frame
axis of the solve, detection, wave speeds and winding sharded over them,
and rank 0 writes the artifacts. The two do not combine: in one process
per rank, a rank cannot both own a trial alone and share every trial.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np
import torch

from manifold_flow_tpu_torch.geometry.mesh import resolve_device
from manifold_flow_tpu_torch.ops.recombine import velocity_to_world
from manifold_flow_tpu_torch.pipeline import stages as S
from manifold_flow_tpu_torch.utils import io

logger = logging.getLogger(__name__)

# Stage order within a trial: streamline runs right after flow so its
# per-frame pkl.bz2 compressions (the largest write burst) overlap the
# decompose, wavespeed and winding stages instead of the end-of-trial drain.
# Everything after flow needs only the velocity movie in memory.
DEVICE_STAGES = ("flow", "streamline", "decompose", "wavespeed", "winding")
# The amplitude wave-speed variant (S5_compute_wave_v.py:14-58) exists in the
# reference but is never wired into its main; it is opt-in here too.
ALL_STAGES = DEVICE_STAGES + ("wavespeed_amplitude",)

MESH_AND_DISTRIBUTED = (
    "distributed=True (--distributed) splits the trials over the ranks, a "
    "device_mesh (--frame-shards) runs every trial on all of them: pass one")


class TrialRef(NamedTuple):
    subject: str
    run: str
    trial: str
    trial_dir: Path
    surface_path: Path
    movie_path: Path            # interpolated potentials (T, N) csv
    phases_path: Path | None    # interpolated phases csv, if present

    @property
    def key(self) -> str:
        return f"{self.subject}/{self.run}/{self.trial}"


def _find_surface(subject_dir: Path) -> Path | None:
    hits = sorted(subject_dir.glob("*reconstructed_surface.ply"))
    return hits[0] if hits else None


def discover_trials(root, subjects: Sequence[str] | None = None):
    """Walk the results tree and return every runnable trial, sorted.

    As the reference's run-folder walk (S2_interpolate.py:79-102): subjects
    are the top-level folders, runs match run-*, and a trial is any run
    subfolder holding an interpolated movie."""
    root = Path(root)
    out = []
    for subject_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        if subjects and subject_dir.name not in subjects:
            continue
        surface = _find_surface(subject_dir)
        if surface is None:
            logger.warning("batch: %s has no reconstructed surface; skipped",
                           subject_dir.name)
            continue
        for run_dir in sorted(subject_dir.glob("run-*")):
            if not run_dir.is_dir():
                continue
            for trial_dir in sorted(p for p in run_dir.iterdir() if p.is_dir()):
                movies = sorted(trial_dir.glob("*interpolation_data.csv"))
                if not movies:
                    continue
                phases = sorted(trial_dir.glob("*interpolation_phases_data.csv"))
                out.append(TrialRef(
                    subject=subject_dir.name, run=run_dir.name,
                    trial=trial_dir.name, trial_dir=trial_dir,
                    surface_path=surface, movie_path=movies[0],
                    phases_path=phases[0] if phases else None))
    return out


def shard_trials(trials, num_shards: int, shard_index: int):
    """Round-robin assignment: trial i -> shard i % num_shards (the
    reference's manual one-argv-per-task split, made automatic)."""
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard_index {shard_index} outside [0, {num_shards})")
    return [t for i, t in enumerate(trials) if i % num_shards == shard_index]


def _find_sfreq_near(trial_dir: Path) -> float | None:
    """Sampling frequency from the nearest BIDS ieeg sidecar JSON (the
    reference reads SamplingFrequency per run, S5_compute_wave_v.py:301-305).
    Searches the trial, run, then subject directory."""
    for d in (trial_dir, trial_dir.parent, trial_dir.parent.parent):
        for j in sorted(d.glob("*.json")):
            try:
                info = json.loads(j.read_text())
            except (OSError, json.JSONDecodeError):
                continue
            if isinstance(info, dict) and "SamplingFrequency" in info:
                return float(info["SamplingFrequency"])
    return None


def _find_sfreq(trial: TrialRef) -> float | None:
    return _find_sfreq_near(trial.trial_dir)


# ------------------------------------------------------------------- S2 ----
# Stimulated-pair extraction from the trial folder name: the reference's
# pattern2 (S2_interpolate.py:97-102): 'G1-G2' stimulates G1 and G2, and
# both are removed from the interpolation inputs (S2:125-135).
_STIM_PAIR_PATTERN = re.compile(r"(.*?)-(.*)")


class InterpTask(NamedTuple):
    """One trial awaiting S2 interpolation: an evoked movie plus the BIDS
    sidecars needed to select and place its electrodes."""

    subject: str
    run: str
    trial: str
    trial_dir: Path
    surface_path: Path
    evoked_path: Path             # <stem>-ave.csv (portable) or -ave.fif
    electrodes_path: Path | None  # *_electrodes.tsv
    channels_path: Path | None    # *_channels.tsv (run-matched if present)

    @property
    def key(self) -> str:
        return f"{self.subject}/{self.run}/{self.trial}"


def _find_sidecar(trial_dir: Path, patterns) -> Path | None:
    """First match of any pattern in the trial, run, then subject directory
    (the reference reads the TSVs from the per-session ieeg folder,
    S2:112-113; a results-tree copy at any level works here)."""
    for d in (trial_dir, trial_dir.parent, trial_dir.parent.parent):
        for pat in patterns:
            hits = sorted(d.glob(pat))
            if hits:
                return hits[0]
    return None


def discover_interpolation_tasks(root, subjects: Sequence[str] | None = None):
    """Every trial with a per-site evoked movie, whether or not the
    interpolated movie exists yet (run_interpolation resumes by presence).

    As the reference's S2 walk (S2_interpolate.py:79-102): subjects ->
    run-* -> trial folders; the evoked is `<stem>-ave.fif` in the trial
    folder, or its portable `<stem>-ave.csv` twin, preferred because it
    needs no MNE."""
    root = Path(root)
    out = []
    for subject_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        if subjects and subject_dir.name not in subjects:
            continue
        surface = _find_surface(subject_dir)
        if surface is None:
            continue
        for run_dir in sorted(subject_dir.glob("run-*")):
            if not run_dir.is_dir():
                continue
            run_no = run_dir.name[len("run-"):]
            for trial_dir in sorted(p for p in run_dir.iterdir() if p.is_dir()):
                evoked = (sorted(trial_dir.glob("*-ave.csv"))
                          or sorted(trial_dir.glob("*-ave.fif")))
                if not evoked:
                    continue
                electrodes = _find_sidecar(trial_dir, ["*_electrodes.tsv"])
                channels = _find_sidecar(
                    trial_dir, [f"*_run-{run_no}_channels.tsv", "*_channels.tsv"])
                out.append(InterpTask(
                    subject=subject_dir.name, run=run_dir.name,
                    trial=trial_dir.name, trial_dir=trial_dir,
                    surface_path=surface, evoked_path=evoked[0],
                    electrodes_path=electrodes, channels_path=channels))
    return out


def selected_channel_names(channels_path, stim_pair=()):
    """Grid-ECoG channel names passing the reference's predicate, minus the
    stimulated pair.

    Conditions (S2_interpolate.py:116-123): type == ECOG, status == good,
    status_description == included, group == grid; a column the table lacks
    matches no row. The stimulated channels are then removed in order
    (S2:125-135). Returns (names, excluded)."""
    names = [row["name"] for row in io.read_tsv(channels_path)
             if row.get("type") == "ECOG" and row.get("status") == "good"
             and row.get("status_description") == "included"
             and row.get("group") == "grid" and not io.is_na(row["name"])]
    excluded = []
    for stim in stim_pair:
        if stim in names:
            names.remove(stim)
            excluded.append(stim)
    return names, excluded


def _read_evoked(path: Path):
    """(data (T, C), ch_names, sfreq | None) from a portable evoked CSV or
    an MNE .fif (S2:106-110); the .fif route needs MNE-Python and raises
    ImportError naming it otherwise."""
    if path.suffix == ".csv":
        data, names = io.load_evoked_csv(path)
        return data, names, None
    try:
        import mne
    except ImportError as e:
        raise ImportError(
            f"{path.name}: reading a .fif evoked requires MNE-Python (mne is "
            "not installed); give the trial its portable -ave.csv twin "
            "(utils.io.save_evoked_csv) instead") from e
    evoked = mne.read_evokeds(str(path), 0)
    return evoked.get_data().T, list(evoked.ch_names), float(evoked.info["sfreq"])


def interpolation_artifacts(task: InterpTask) -> tuple[Path, Path]:
    """(potentials, phases) movie paths run_interpolation will produce for
    `task`, known in advance, so shards can agree on the post-S2 trial list
    before every movie exists (see run_batch)."""
    name = task.evoked_path.name
    for suf in ("-ave.csv", "-ave.fif"):
        if name.endswith(suf):
            stem = name[: -len(suf)]
            break
    else:
        stem = task.evoked_path.stem
    return (task.trial_dir / f"{stem}-ave-interpolation_data.csv",
            task.trial_dir / f"{stem}-ave-interpolation_phases_data.csv")


def _mesh_for(surface_path, mesh_cache, cache_dir, device):
    if mesh_cache is not None and surface_path in mesh_cache:
        return mesh_cache[surface_path]
    mesh = S.load_surface(surface_path, cache_dir=cache_dir, device=device)
    if mesh_cache is not None:
        mesh_cache[surface_path] = mesh
    return mesh


def run_interpolation(task: InterpTask, config, overwrite: bool = False,
                      mesh_cache: dict | None = None, cache_dir=None,
                      device="cuda") -> dict:
    """S2 for one trial: evoked (T, E) -> interpolated vertex movies
    (potentials AND phases CSVs, the flow and wavespeed stages' inputs), on
    `device` (K17 on the GPU).

    The stimulated pair is parsed from the trial folder name and excluded
    (S2_interpolate.py:97-102,125-135); channel selection applies the
    reference's TSV predicate (selected_channel_names); the movie is
    windowed to [start_time, end_time) seconds by the evoked's (or the
    sidecar's) sampling frequency (S2:19-20,109-110). Artifacts follow the
    reference's names: `{stem}-ave-interpolation_data.csv` (S2:157) and
    `{stem}-ave-interpolation_phases_data.csv`. Returns a report dict;
    status 'skipped' when both artifacts already exist."""
    art, art_ph = interpolation_artifacts(task)
    if not overwrite and art.exists() and art_ph.exists():
        return {"status": "skipped", "artifact": str(art)}

    m = _STIM_PAIR_PATTERN.search(task.trial)
    stim_pair = (m.group(1), m.group(2)) if m else ()
    if task.channels_path is None or task.electrodes_path is None:
        raise FileNotFoundError(
            f"{task.key}: interpolation needs *_channels.tsv and "
            "*_electrodes.tsv near the trial (searched trial, run and "
            "subject directories)")
    names, excluded = selected_channel_names(task.channels_path, stim_pair)

    data, ch_names, sfreq = _read_evoked(task.evoked_path)
    if sfreq is None:
        sfreq = _find_sfreq_near(task.trial_dir)
    if sfreq is None:
        logger.warning(
            "batch: %s: no sampling frequency (evoked metadata or sidecar "
            "JSON); interpolating the FULL evoked without the "
            "[start_time, end_time) window", task.key)

    # Electrode coordinates keep the TSV's row order; the evoked's columns
    # are aligned to that order BY NAME (the reference assumes both files
    # list the channels in one order, S2:138-151).
    coords, kept = io.load_grid_electrodes(
        task.electrodes_path, group=None, names=names, with_names=True)
    no_coords = sorted(set(names) - set(kept))
    if no_coords:
        # A channel passing the channels.tsv predicate but absent (or 'n/a')
        # in electrodes.tsv shrinks the interpolation basis: say so.
        logger.warning(
            "batch: %s: channels %s have no coordinates in %s; "
            "interpolating from %d of %d selected electrodes",
            task.key, no_coords, task.electrodes_path.name, len(kept), len(names))
    missing = [n for n in kept if n not in ch_names]
    if missing:
        raise ValueError(
            f"{task.key}: channels {missing} selected by the TSVs are not "
            "in the evoked recording")
    cols = [ch_names.index(n) for n in kept]
    movie = data[:, cols]

    mesh = _mesh_for(task.surface_path, mesh_cache, cache_dir, device)
    S.interpolate_stage(mesh, coords, movie, config, sfreq=sfreq, save_path=art)
    S.interpolate_stage(mesh, coords, movie, config, sfreq=sfreq, phases=True,
                        save_path=art_ph)
    return {"status": "done", "artifact": str(art),
            "phases_artifact": str(art_ph), "n_electrodes": len(kept),
            "excluded": excluded}


def trial_prefix(trial: TrialRef) -> str:
    """Per-trial artifact-name stem, recovered from the movie filename.

    The reference derives every artifact name from one stem,
    `{subfolder}_{ses}_task-SPESclin_run-{run}-{trial}` (S3_compute_v_and_
    detection_singularity.py:44-53), and the interpolated movie is
    `{stem}-ave-interpolation_data.csv` (S2_interpolate.py:157), so the stem
    is the movie filename minus that suffix. Movies that don't follow the
    convention get bare artifact names."""
    name = trial.movie_path.name
    for suf in ("-ave-interpolation_data.csv", "-interpolation_data.csv"):
        if name.endswith(suf):
            return name[: -len(suf)]
    return ""


def artifact_names(prefix: str) -> dict:
    """The reference's artifact names for one trial (SURVEY.md §2.2):
    prefixed as S3/S5/S7 build them; data_01.npz and the per-frame
    streamline files are unprefixed in the reference too
    (S4_...ConcatMatrices .py:166, S6_streamline.py:260)."""
    p = f"{prefix}-" if prefix else ""
    return {
        "v_k": f"{p}V_k.csv",                                  # S3:47
        "singularity": f"{p}singularity_points.pkl",           # S3:49
        "speed": f"{p}wave_velocity_opticalflow.pkl.bz2",      # S3:53
        "decompose": "data_01.npz",                            # S4:166
        "wavespeed": f"{p}wave_velocity.pkl.bz2",              # S5:316
        "wavespeed_amplitude": f"{p}wave_velocity_amplitude.pkl.bz2",
        "streamline_fmt": "t_velocityfields_streamlines_{frame}.pkl.bz2",
        "winding": f"{p}winding_lines.pkl.bz2",                # S7:259
    }


_FRAMES_CACHE: dict = {}


def _movie_frames(trial: TrialRef, config=None) -> int:
    """Movie frame count (CSV data rows, capped by solver.time_steps),
    needed to enumerate the per-frame streamline artifacts. Cached by
    (path, mtime, size): stage_done runs per stage per sweep, and a no-op
    resume over a cohort must not re-read every movie CSV to count rows."""
    st = os.stat(trial.movie_path)
    key = (str(trial.movie_path), st.st_mtime_ns, st.st_size)
    rows = _FRAMES_CACHE.get(key)
    if rows is None:
        with open(trial.movie_path, "r", encoding="utf-8") as f:
            rows = max(sum(1 for _ in f) - 1, 0)  # minus header
        _FRAMES_CACHE[key] = rows
        while len(_FRAMES_CACHE) > 4096:
            _FRAMES_CACHE.pop(next(iter(_FRAMES_CACHE)))
    ts = getattr(getattr(config, "solver", None), "time_steps", None)
    return min(rows, ts) if ts else rows


def stage_artifacts(trial: TrialRef, stage: str, config=None):
    """Paths a stage produces; a stage is 'done' (skippable) when every one
    exists."""
    names = artifact_names(trial_prefix(trial))
    d = trial.trial_dir
    if stage == "flow":
        return [d / names["v_k"], d / names["singularity"], d / names["speed"]]
    if stage == "streamline":
        t = _movie_frames(trial, config)
        # t - 1 velocity frames -> t - 1 per-frame files; a movie of at most
        # one frame produces none, so the stage is trivially done.
        return [d / names["streamline_fmt"].format(frame=k)
                for k in range(max(t - 1, 0))]
    if stage in ("decompose", "wavespeed", "wavespeed_amplitude", "winding"):
        return [d / names[stage]]
    raise ValueError(f"unknown batch stage {stage!r}")


def stage_done(trial: TrialRef, stage: str, config=None) -> bool:
    return all(a.exists() for a in stage_artifacts(trial, stage, config))


def _step(device_mesh, fn, /, *args, **kwargs):
    """fn(*args, **kwargs). Under a device mesh every rank then learns
    whether any rank raised in it (parallel.multihost.agree), and all raise
    together, so that a rank that alone fails (rank 0's writes, a read)
    does not leave the others waiting in the next stage's collectives. A
    step is rank-local work, or a stage (its collectives, then rank 0's
    writes), never local work and then collectives: an exception inside
    a stage's collectives on one rank (out of memory in the middle of a
    solve) leaves the others waiting there until the process group's
    timeout."""
    if device_mesh is None:
        return fn(*args, **kwargs)
    from manifold_flow_tpu_torch.parallel import multihost

    error = value = None
    try:
        value = fn(*args, **kwargs)
    except Exception as e:  # raised on every rank by agree
        error = e
    multihost.agree(error)
    return value


def run_trial(trial: TrialRef, config, stages: Sequence[str] = DEVICE_STAGES,
              sfreq: float | None = None, overwrite: bool = False,
              mesh_cache: dict | None = None, cache_dir=None,
              timings: dict | None = None, movie_data=None,
              writer=None, device_mesh=None, device="cuda") -> dict:
    """Run the requested device stages for one trial on `device` (the GPU
    unless the caller passes device="cpu"); returns {stage: 'done' |
    'skipped'}. Artifacts land in the trial directory in the reference's
    formats.

    Stage inputs stay on the mesh's device: the flow stage's velocity movie
    (v_k and v_world) feeds the singularity, streamline, decompose and
    winding stages as it lies; on resume, get_velocity uploads V_k.csv once
    and recombines it there, and the winding stage snaps the saved points to
    vertices again on the host. This run's detection hands its points and
    snapped centers to the winding stage in memory.

    `timings`, when given, receives wall seconds per executed stage, a
    'flow_detail' sub-breakdown (movie load, solve dispatch and wait,
    artifact copy starts and submits, detection, and 'trace', the velocity
    stage's utils.profiling record: a dict of spans and counts, not
    seconds), 'streamline_detail' (trace, compact, submit: seconds),
    'decompose_detail' (compute, write, and the decompose stage's 'trace'
    record) and 'wavespeed_detail' / 'wavespeed_amplitude_detail' (compute,
    write), and, when the trial drains its own writer, 'drain'.

    `movie_data` optionally supplies the trial's potentials movie already
    parsed (a (T, N) array or a concurrent Future of one): run_batch parses
    the NEXT trial's CSV while this one computes.

    `writer` optionally supplies a sweep-shared io.ArtifactWriter: this
    trial's serialization then overlaps the next trial's compute, the
    caller owns the drain, and 'done' means the writes are queued. Without
    it the trial drains its own writer, so 'done' means the files are on
    disk.

    `config.pad_meshes` is not read: the JAX package pads surfaces to
    shared shapes so that XLA compiles one program for a cohort, and eager
    CUDA launches need no such thing.

    `device_mesh` (parallel.make_device_mesh) runs the trial on every rank
    of the mesh, each calling run_trial with the same arguments: the solve,
    detection, wave speeds and winding shard their frame axis; streamlines
    and the SVD run on every rank. Rank 0 alone writes; every rank returns
    the same statuses, since the ranks agree on the stages to run (read
    before a barrier that no rank passes until all have read), and an
    exception that one rank raises, every rank raises (a RankError naming
    that rank; see `_step`)."""
    result = {}
    todo = [s for s in stages if overwrite or not stage_done(trial, s, config)]
    if device_mesh is not None:
        from manifold_flow_tpu_torch.parallel import multihost

        multihost.sync_hosts()
    # The sharded stages decide who writes; the others are told.
    writes = S.writes_artifacts(device_mesh)

    def step(fn, /, *args, **kwargs):
        return _step(device_mesh, fn, *args, **kwargs)
    for s in stages:
        if s not in todo:
            result[s] = "skipped"
    if not todo:
        return result

    mesh = step(_mesh_for, trial.surface_path, mesh_cache, cache_dir, device)
    d = trial.trial_dir
    names = artifact_names(trial_prefix(trial))

    movie = None
    vel = None
    sing_pts = None
    sing_centers = None
    v_world_cache = None
    sfreq_cache = [sfreq, sfreq is not None]

    def get_sfreq():
        """Sampling frequency, warning loudly on the unit-dt fallback: times
        silently becoming frame indices is the seconds-vs-unit-dt ambiguity
        the reference itself carries between its S3 script and
        compute_optical_flow's __main__ (SURVEY.md §7.3)."""
        if not sfreq_cache[1]:
            sfreq_cache[0] = _find_sfreq(trial)
            sfreq_cache[1] = True
            if sfreq_cache[0] is None:
                logger.warning(
                    "batch: %s: no SamplingFrequency sidecar JSON found near "
                    "%s; falling back to unit dt (times = frame indices): "
                    "velocities and wave speeds will be in per-frame, not "
                    "per-second, units", trial.key, trial.trial_dir)
        return sfreq_cache[0]

    def get_movie():
        """The potentials movie on the mesh's device, uploaded once."""
        nonlocal movie
        if movie is None:
            raw = movie_data
            if raw is not None and hasattr(raw, "result"):
                raw = raw.result()  # a prefetch Future from run_batch
            if raw is None:
                raw = io.load_indexed_csv(trial.movie_path)
            raw = np.asarray(raw)
            if config.solver.time_steps and raw.shape[0] > config.solver.time_steps:
                raw = raw[: config.solver.time_steps]
            movie = torch.as_tensor(raw, device=mesh.device)
        return movie

    def get_times(n):
        f = get_sfreq()
        return np.arange(n) / f if f else np.arange(n, dtype=np.float64)

    def movie_and_times():
        m = get_movie()
        return m, get_times(m.shape[0])

    def get_velocity():
        """v_world (T-1, N, 3) on the mesh's device: the flow stage's of this
        run, or recombined (once) from the V_k.csv of a previous run."""
        nonlocal v_world_cache
        if v_world_cache is not None:
            return v_world_cache
        if vel is not None:
            v_world_cache = vel.v_world
        elif stage_done(trial, "flow", config) and "flow" not in todo:
            v_k = torch.as_tensor(io.load_indexed_csv(d / names["v_k"]),
                                  device=mesh.device)
            v_world_cache = velocity_to_world(v_k, mesh.basis)
        else:
            raise RuntimeError(
                f"{trial.key}: stage needs velocity fields but 'flow' "
                "neither ran nor left artifacts; include 'flow' in stages")
        return v_world_cache

    # One background writer per trial unless the caller shares one: the
    # serialization (CSV formatting, bz2 pickles) overlaps the next stage's
    # kernels. The phases CSV (wavespeed's input) is parsed on a second
    # thread meanwhile.
    with contextlib.ExitStack() as stack:
        phases_future = None
        if ("wavespeed" in todo and todo[0] != "wavespeed"
                and trial.phases_path is not None):
            pool = stack.enter_context(ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="artifact-prefetch"))
            phases_future = pool.submit(io.load_indexed_csv, trial.phases_path)
        own_writer = writer is None
        if own_writer:
            # Two workers: the per-frame streamline pickles are the largest
            # write burst; a second thread halves the drain after the last
            # stage.
            writer = stack.enter_context(io.ArtifactWriter(workers=2))
        for s in todo:
            t0 = time.perf_counter()
            if s == "flow":
                detail: dict = {}
                m, tm = step(movie_and_times)
                detail["movie_load"] = time.perf_counter() - t0
                # S3:46 writes e per subject, {subfolder}_e.csv, one file
                # shared by every trial of the subject: only a trial that
                # finds it missing (or an overwrite sweep) writes it; writes
                # are atomic (utils.io).
                e_path = trial.surface_path.parent / f"{trial.subject}_e.csv"
                vel = step(
                    S.velocity_stage, mesh, m, tm, config,
                    e_path=e_path if overwrite or not e_path.exists() else None,
                    v_k_path=d / names["v_k"], speed_path=d / names["speed"],
                    writer=writer, timings=detail, device_mesh=device_mesh)
                t_det = time.perf_counter()
                v_world = step(get_velocity)
                sing_pts, _, sing_centers = step(
                    S.singularity_stage, mesh, v_world, config,
                    save_path=d / names["singularity"], writer=writer,
                    return_centers=True, speed=vel.speed, v_max=vel.v_max,
                    device_mesh=device_mesh)
                detail["detect"] = time.perf_counter() - t_det
                if timings is not None:
                    timings["flow_detail"] = detail
            elif s == "decompose":
                ddetail: dict = {}

                def decompose():  # no collective: one step
                    if vel is not None:
                        v_k = vel.v_k
                    elif (d / names["v_k"]).exists():
                        v_k = torch.as_tensor(io.load_indexed_csv(d / names["v_k"]),
                                              device=mesh.device)
                    else:
                        raise RuntimeError(f"{trial.key}: decompose needs {names['v_k']}")
                    S.decompose_stage(v_k, config, mode="concat",
                                      npz_path=d / names["decompose"] if writes else None,
                                      writer=writer, timings=ddetail)
                step(decompose)
                if timings is not None:
                    timings["decompose_detail"] = ddetail
            elif s in ("wavespeed", "wavespeed_amplitude"):
                if s == "wavespeed":
                    if trial.phases_path is None:
                        result[s] = "skipped"
                        continue
                    m = step(lambda: phases_future.result() if phases_future is not None
                             else io.load_indexed_csv(trial.phases_path))
                    method = "phase"
                else:
                    m = step(get_movie)
                    method = "amplitude"
                f = get_sfreq()
                wdetail: dict = {}
                step(S.wavespeed_stage, mesh, m, dt=1.0 / f if f else 1.0, method=method,
                     save_path=d / names[s], writer=writer,
                     device_mesh=device_mesh, timings=wdetail)
                if timings is not None:
                    timings[f"{s}_detail"] = wdetail
            elif s == "streamline":
                # Per-frame files, the reference's layout (S6:258-262): one
                # dict {frame: lines} per frame.
                sdetail: dict = {}
                step(lambda: S.streamline_stage(  # no collective: one step
                    mesh, get_velocity(), config,
                    save_path_fmt=str(d / names["streamline_fmt"]) if writes else None,
                    writer=writer, timings=sdetail))
                if timings is not None:
                    timings["streamline_detail"] = sdetail
            elif s == "winding":
                # This run's detection hands its points and snapped centers
                # over in memory (the pickle may still be queued on the
                # writer); a resumed run reads the previous run's artifact
                # and snaps again on the host.
                pts, v_world = step(lambda: (
                    [list(p) for p in sing_pts] if sing_pts is not None
                    else io.load_pickle(d / names["singularity"]), get_velocity()))
                step(S.winding_stage, mesh, v_world, pts, config,
                     save_path=d / names["winding"], writer=writer,
                     centers=sing_centers, device_mesh=device_mesh)
            else:
                raise ValueError(f"unknown batch stage {s!r}")
            result[s] = "done"
            wall = time.perf_counter() - t0
            if timings is not None:
                timings[s] = wall
            logger.info("batch: %s %s done in %.2fs", trial.key, s, wall)
        if own_writer:
            t0 = time.perf_counter()
            step(writer.wait)
            if timings is not None:
                timings["drain"] = time.perf_counter() - t0
    return result


def run_batch(root, config, stages: Sequence[str] = DEVICE_STAGES,
              subjects: Sequence[str] | None = None,
              sfreq: float | None = None, overwrite: bool = False,
              num_shards: int | None = None, shard_index: int | None = None,
              distributed: bool = False, cache_dir=None,
              mesh_cache: dict | None = None, device_mesh=None,
              device="cuda", timings: dict | None = None) -> dict:
    """Run `stages` for every trial under `root` owned by this shard, on
    `device` (the GPU unless the caller passes device="cpu").

    Explicit num_shards / shard_index reproduce the reference's manual argv
    sharding. Returns {"trials": {key: {stage: status}}, "errors": {key:
    message}, "shard": [index, count], "discovered": n} (and
    "interpolation": {key: report} with the 'interpolate' stage).

    `mesh_cache` optionally keeps loaded TriMesh objects ACROSS calls: the
    per-mesh tables (hop tables, coarse tables, ring tables) are cached on
    the mesh's tensors, so a caller sweeping repeatedly should pass one
    dict. `timings`, when given, receives each trial's run_trial timings
    under its key, 'interpolate' ({key: seconds}) and 'drain' (the final
    wait on the sweep's writer).

    `distributed=True` joins the process group (parallel.multihost.
    initialize: torchrun's environment, or a group already up; ValueError
    naming torchrun without one) and takes the shard from the rank and the
    world size, over explicit num_shards / shard_index, as JAX does.
    `device_mesh` runs every trial of the shard on all of the mesh's ranks
    (run_trial); the 'interpolate' sweep then runs on rank 0 alone, and the
    other ranks wait for it. The two together raise ValueError.
    """
    from manifold_flow_tpu_torch.parallel import multihost

    if distributed and device_mesh is not None:
        raise ValueError(MESH_AND_DISTRIBUTED)
    if distributed:
        multihost.initialize()
        num_shards, shard_index = multihost.world_size(), multihost.rank()
    device = resolve_device(device)
    num_shards = num_shards or 1
    shard_index = shard_index or 0

    report = {"trials": {}, "errors": {}, "shard": [shard_index, num_shards]}
    if mesh_cache is None:
        mesh_cache = {}
    stages = tuple(stages)
    tasks = []
    if "interpolate" in stages:
        # S2 first: produce the interpolated movies the device stages
        # consume, sharded like trials (the same round robin over the sorted
        # task list).
        tasks = discover_interpolation_tasks(root, subjects=subjects)
        report["interpolation"] = {}
        interp_s = {}
        for i, task in enumerate(tasks):
            if i % num_shards != shard_index or (device_mesh is not None
                                                 and not multihost.is_primary()):
                continue
            t0 = time.perf_counter()
            try:
                report["interpolation"][task.key] = run_interpolation(
                    task, config, overwrite=overwrite, mesh_cache=mesh_cache,
                    cache_dir=cache_dir, device=device)
            except Exception as e:  # per-trial isolation
                logger.exception("batch: interpolation %s failed", task.key)
                # Namespaced: a later device-stage failure of the same trial
                # must not overwrite the interpolation error.
                report["errors"][f"interpolate:{task.key}"] = f"{type(e).__name__}: {e}"
            interp_s[task.key] = time.perf_counter() - t0
        if timings is not None:
            timings["interpolate"] = interp_s
        if device_mesh is not None:
            multihost.sync_hosts()  # the movies are on disk for every rank
        stages = tuple(s for s in stages if s != "interpolate")

    trials = discover_trials(root, subjects=subjects)
    # Index-based sharding needs every shard to agree on the trial list, but
    # discover_trials sees only the movies that exist now: merge in the
    # trials every evoked task will produce (paths known in advance). A
    # trial whose shard has not interpolated yet fails loudly and completes
    # on the next resume sweep.
    if tasks:
        have = {t.trial_dir for t in trials}
        for task in tasks:
            if task.trial_dir in have:
                continue
            movie, phases = interpolation_artifacts(task)
            trials.append(TrialRef(
                subject=task.subject, run=task.run, trial=task.trial,
                trial_dir=task.trial_dir, surface_path=task.surface_path,
                movie_path=movie, phases_path=phases))
        trials.sort(key=lambda t: t.key)
    mine = shard_trials(trials, num_shards, shard_index) if stages else []
    report["discovered"] = len(trials)

    def wants_movie(t):
        return "flow" in stages and (overwrite or not stage_done(t, "flow", config))

    # One sweep-shared writer: trial i's serialization overlaps trial i+1's
    # compute. It drains before run_batch returns, so the report still means
    # every artifact is on disk; a failed write raises into whichever trial
    # is running when it surfaces, or at the final drain.
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix="movie-prefetch") as pool, \
            io.ArtifactWriter(workers=2) as shared_writer:
        futures: dict = {}
        for i, trial in enumerate(mine):
            if i + 1 < len(mine) and wants_movie(mine[i + 1]):
                futures[mine[i + 1].key] = pool.submit(io.load_indexed_csv,
                                                       mine[i + 1].movie_path)
            fut = futures.pop(trial.key, None)
            trial_timings = {} if timings is not None else None
            try:
                report["trials"][trial.key] = run_trial(
                    trial, config, stages=stages, sfreq=sfreq, overwrite=overwrite,
                    mesh_cache=mesh_cache, cache_dir=cache_dir,
                    timings=trial_timings, movie_data=fut, writer=shared_writer,
                    device_mesh=device_mesh, device=device)
            except Exception as e:  # per-trial isolation: record + continue
                logger.exception("batch: trial %s failed", trial.key)
                report["errors"][trial.key] = f"{type(e).__name__}: {e}"
            if timings is not None:
                timings[trial.key] = trial_timings
        t0 = time.perf_counter()
        try:
            _step(device_mesh, shared_writer.wait)
        except Exception as e:
            logger.exception("batch: artifact write failed during drain")
            report["errors"]["artifact-writer"] = f"{type(e).__name__}: {e}"
        if timings is not None:
            timings["drain"] = time.perf_counter() - t0
    return report
