"""Artifact IO in the reference's on-disk formats (SURVEY.md §2.2).

Counterpart of manifold_flow_tpu/utils/io.py: the numpy-only readers and
writers are copies. The reference's inter-stage API is files: PLY surfaces,
CSVs with a header row + integer index column (pandas to_csv defaults),
pickle / bz2-pickle blobs. This module reads and writes those formats
without PyVista/VTK (own PLY codec), so artifacts interoperate both ways.

Writers take host (numpy) data only. `start_host_copy` and `to_numpy` move
tensors to the host: a stage moves each artifact tensor once and hands
numpy to the writer, so a writer thread never touches a CUDA tensor.
"""

from __future__ import annotations

import bz2
import csv
import math
import pickle
import struct
from pathlib import Path

import numpy as np
import torch


# ----------------------------------------------------------------- PLY ----
def read_ply(path):
    """Read an ascii or binary_little_endian triangle-mesh PLY.

    Returns (points (N, 3) float64, triangles (M, 3) int32). Covers the
    subset VTK writes for the reference's `*_reconstructed_surface.ply`
    artifacts (S1_reconstruct_surface.py:96-98).
    """
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_type, prop_name) | list-decl])
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PLY header")
            tok = line.strip().split()
            if not tok:
                continue
            if tok[0] == b"format":
                fmt = tok[1].decode()
            elif tok[0] == b"element":
                elements.append([tok[1].decode(), int(tok[2]), []])
            elif tok[0] == b"property":
                if tok[1] == b"list":
                    elements[-1][2].append(("list", tok[2].decode(),
                                            tok[3].decode(), tok[4].decode()))
                else:
                    elements[-1][2].append((tok[1].decode(), tok[2].decode()))
            elif tok[0] == b"end_header":
                break
        points, faces = None, []
        if fmt == "ascii":
            for name, count, props in elements:
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    names = [p[1] for p in props]
                    ix = [names.index(k) for k in ("x", "y", "z")]
                    points = np.array(
                        [[float(r[i]) for i in ix] for r in rows])
                elif name == "face":
                    for r in rows:
                        n = int(r[0])
                        faces.append([int(v) for v in r[1:1 + n]])
        elif fmt == "binary_little_endian":
            type_map = {"char": "b", "uchar": "B", "int8": "b", "uint8": "B",
                        "short": "h", "ushort": "H", "int16": "h",
                        "uint16": "H", "int": "i", "uint": "I", "int32": "i",
                        "uint32": "I", "float": "f", "float32": "f",
                        "double": "d", "float64": "d"}
            for name, count, props in elements:
                if name == "vertex":
                    fmt_s = "<" + "".join(type_map[p[0]] for p in props)
                    size = struct.calcsize(fmt_s)
                    names = [p[1] for p in props]
                    ix = [names.index(k) for k in ("x", "y", "z")]
                    data = np.empty((count, 3))
                    for i in range(count):
                        vals = struct.unpack(fmt_s, f.read(size))
                        data[i] = [vals[j] for j in ix]
                    points = data
                elif name == "face":
                    cnt_t = type_map[props[0][1]]
                    idx_t = type_map[props[0][2]]
                    cnt_sz = struct.calcsize(cnt_t)
                    idx_sz = struct.calcsize(idx_t)
                    for _ in range(count):
                        n = struct.unpack("<" + cnt_t, f.read(cnt_sz))[0]
                        vals = struct.unpack("<" + idx_t * n, f.read(idx_sz * n))
                        faces.append(list(vals))
                else:
                    # Skip unknown fixed-size elements.
                    fmt_s = "<" + "".join(type_map[p[0]] for p in props)
                    f.read(struct.calcsize(fmt_s) * count)
        else:
            raise ValueError(f"{path}: unsupported PLY format {fmt}")
    tris = [fc for fc in faces if len(fc) == 3]
    for fc in faces:
        if len(fc) == 4:  # split quads
            tris.append([fc[0], fc[1], fc[2]])
            tris.append([fc[0], fc[2], fc[3]])
    return points, np.asarray(tris, dtype=np.int32)


def write_ply(path, points, triangles, binary: bool = True):
    """Write a triangle mesh PLY (binary little-endian by default)."""
    points = np.asarray(points, dtype=np.float32)
    triangles = np.asarray(triangles, dtype=np.int32)
    header = (
        "ply\n"
        f"format {'binary_little_endian' if binary else 'ascii'} 1.0\n"
        f"element vertex {len(points)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(triangles)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(points.astype("<f4").tobytes())
            rec = np.empty(len(triangles),
                           dtype=[("n", "u1"), ("v", "<i4", (3,))])
            rec["n"] = 3
            rec["v"] = triangles
            f.write(rec.tobytes())
        else:
            for p in points:
                f.write(f"{p[0]} {p[1]} {p[2]}\n".encode())
            for t in triangles:
                f.write(f"3 {t[0]} {t[1]} {t[2]}\n".encode())


# ----------------------------------------------------------------- CSV ----
def save_indexed_csv(path, data):
    """Save (T, D) data as the reference's CSV format: header 0..D-1 plus an
    integer index column (pandas DataFrame.to_csv defaults, used by
    reshape_and_save_data, utils/compute_optical_flow.py:314-320).

    np.savetxt over pandas to_csv deliberately: with an explicit
    float_format pandas falls off its fast path and runs ~4x slower than
    numpy's writer at movie scale.
    Atomic (temp + rename) — sweep-shared writers may submit the same
    subject-level artifact (e.csv) from several trials."""
    data = np.asarray(data)
    data = data.reshape(data.shape[0], -1)
    header = "," + ",".join(str(i) for i in range(data.shape[1]))
    rows = np.concatenate(
        [np.arange(data.shape[0])[:, None], data], axis=1)
    fmt = ["%d"] + ["%.18g"] * data.shape[1]
    _atomic_write(path, lambda tmp: np.savetxt(
        tmp, rows, delimiter=",", header=header, comments="", fmt=fmt))


def load_indexed_csv(path):
    """Load a reference-format CSV (header row + index column) -> (T, D).

    np.loadtxt deliberately: its C tokenizer reads a reference-scale movie
    faster than pandas with the exact-roundtrip float parser
    (float_precision='round_trip', required so %.18g artifacts re-load
    bit-identically on resume)."""
    data = np.loadtxt(path, delimiter=",", skiprows=1)
    if data.ndim == 1:
        data = data[None]
    return data[:, 1:]


def save_evoked_csv(path, data, ch_names):
    """Portable per-site evoked movie: (T, C) data with CHANNEL NAMES as the
    header (plus the usual integer index column).

    The reference stores evokeds as MNE `.fif` (S0_preprocess.py:119-130;
    read back by S2_interpolate.py:106-147), which needs MNE to read. The
    preprocessing stage writes this CSV beside the .fif so the batch
    interpolation stage works without MNE; the format is the indexed CSV
    with names instead of 0..C-1 in the header."""
    data = np.asarray(data)
    ch_names = list(map(str, ch_names))
    if data.shape[1] != len(ch_names):
        raise ValueError(
            f"evoked data has {data.shape[1]} columns but {len(ch_names)} "
            "channel names")
    header = "," + ",".join(ch_names)
    rows = np.concatenate(
        [np.arange(data.shape[0])[:, None], data], axis=1)
    fmt = ["%d"] + ["%.18g"] * data.shape[1]
    np.savetxt(path, rows, delimiter=",", header=header, comments="",
               fmt=fmt)


def load_evoked_csv(path):
    """Read a portable evoked CSV -> (data (T, C) float64, ch_names)."""
    with open(path, "r", encoding="utf-8") as f:
        names = f.readline().strip().split(",")[1:]
    data = np.loadtxt(path, delimiter=",", skiprows=1)
    if data.ndim == 1:
        data = data[None]
    return data[:, 1:], names


def save_e_csv(path, e):
    """(N, 2, 3) tangent bases -> the reference's (N, 6) e.csv layout."""
    save_indexed_csv(path, np.asarray(e).reshape(len(e), -1))


def load_e_csv(path):
    return load_indexed_csv(path).reshape(-1, 2, 3)


# The strings pandas.read_csv reads as NaN by default: a coordinate spelled
# so is missing.
_NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def is_na(value: str) -> bool:
    """A table cell that pandas.read_csv reads as NaN by default."""
    return value in _NA_STRINGS


def _missing(value: str) -> bool:
    return is_na(value) or math.isnan(float(value))


def read_tsv(path) -> list[dict]:
    """The rows of a BIDS .tsv table as dicts of strings keyed by its
    header (the JAX package reads these tables with pandas)."""
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f, delimiter="\t"))


def load_grid_electrodes(path, group: str = "grid", names=None,
                         exclude=None, with_names: bool = False):
    """Electrode coordinates (E, 3) from a BIDS electrodes.tsv.

    Keeps rows whose `group` column matches (S1_reconstruct_surface.py:53-68);
    rows with a missing coordinate ('n/a' in BIDS, or NaN) are skipped.
    `names` restricts to an explicit channel list; `exclude` drops channels
    (the stimulated pair is removed before interpolation,
    S2_interpolate.py:125-135). The JAX package reads the table with pandas;
    this reads it with the csv module, with the same row rules.
    """
    rows = read_tsv(path)
    if group is not None and rows and "group" in rows[0]:
        rows = [r for r in rows if r["group"] == group]
    if names is not None:
        keep = set(map(str, names))
        rows = [r for r in rows if r["name"] in keep]
    if exclude is not None:
        drop = set(map(str, exclude))
        rows = [r for r in rows if r["name"] not in drop]
    coords, kept = [], []
    for row in rows:
        vals = [row["x"], row["y"], row["z"]]
        if any(_missing(v) for v in vals):
            continue
        coords.append([float(v) for v in vals])
        kept.append(row["name"])
    coords = np.asarray(coords, dtype=np.float64)
    return (coords, kept) if with_names else coords


# ------------------------------------------------- FreeSurfer surfaces ----
_FS_TRIANGLE_MAGIC = 0xFFFFFE  # 3-byte magic of binary triangle surfaces


def read_freesurfer_surface(path):
    """Read a FreeSurfer binary triangle surface (lh.pial / rh.pial).

    MNE-free equivalent of the `mne.read_surface` calls in the reference's
    pial-underlay plot (S4_...ConcatMatrices .py:147-158): 3-byte magic
    0xFFFFFE, a creation comment terminated by '\\n\\n', then big-endian
    int32 vertex/face counts, float32 xyz coordinates, and int32 triangle
    indices. Returns (verts (V, 3) float64, faces (F, 3) int64) like MNE.
    """
    raw = Path(path).read_bytes()
    magic = int.from_bytes(raw[:3], "big")
    if magic != _FS_TRIANGLE_MAGIC:
        raise ValueError(
            f"{path}: not a FreeSurfer binary triangle surface "
            f"(magic 0x{magic:06X}, want 0x{_FS_TRIANGLE_MAGIC:06X})")
    end = raw.index(b"\n\n", 3) + 2
    n_vert, n_face = struct.unpack(">ii", raw[end:end + 8])
    off = end + 8
    verts = np.frombuffer(raw, dtype=">f4", count=3 * n_vert, offset=off)
    off += 12 * n_vert
    faces = np.frombuffer(raw, dtype=">i4", count=3 * n_face, offset=off)
    return (verts.reshape(n_vert, 3).astype(np.float64),
            faces.reshape(n_face, 3).astype(np.int64))


def write_freesurfer_surface(path, verts, faces, comment: str = "created"):
    """Write the FreeSurfer binary triangle format `read_freesurfer_surface`
    reads (and that mne.read_surface and FreeSurfer itself accept)."""
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    with open(path, "wb") as f:
        f.write(_FS_TRIANGLE_MAGIC.to_bytes(3, "big"))
        f.write(comment.encode() + b"\n\n")
        f.write(struct.pack(">ii", verts.shape[0], faces.shape[0]))
        f.write(verts.astype(">f4").tobytes())
        f.write(faces.astype(">i4").tobytes())
    return path


def _atomic_target(path):
    """Unique sibling temp path for write-then-rename: concurrent writers
    of the SAME artifact (e.g. the per-subject e.csv submitted by several
    trials of one sweep) each complete a whole file and the last rename
    wins — never interleaved/truncated content."""
    import os
    import threading

    return f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"


def _atomic_write(path, write_fn):
    import os

    tmp = _atomic_target(path)
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):  # pragma: no cover - only on write failure
            os.unlink(tmp)


# -------------------------------------------------------------- pickles ----
def save_pickle(path, obj, compress: bool | None = None):
    """Pickle, with bz2 compression for .bz2 paths (the reference's
    `pkl.bz2` artifacts, e.g. S5:316-318). Atomic (temp + rename)."""
    if compress is None:
        compress = str(path).endswith(".bz2")
    opener = bz2.BZ2File if compress else open

    def write(tmp):
        with opener(tmp, "wb") as f:
            pickle.dump(obj, f)

    _atomic_write(path, write)


def load_pickle(path, compress: bool | None = None):
    if compress is None:
        compress = str(path).endswith(".bz2")
    opener = bz2.BZ2File if compress else open
    with opener(path, "rb") as f:
        return pickle.load(f)


def ensure_dir(path):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    return path


def start_host_copy(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """Start the device-to-host copies of `tensors` and return the CPU
    tensors they fill; CPU tensors come back as they are.

    The copies of CUDA tensors go to pinned memory on each tensor's current
    stream and are all started before any wait, so they overlap one
    another. Their contents are valid once that stream has been waited on:
    after any blocking read on it (such as `.cpu()` of a result computed
    later on the same stream) or `torch.cuda.synchronize()`.
    """
    return [t.to("cpu", non_blocking=True) if t.is_cuda else t for t in tensors]


def to_numpy(*tensors: torch.Tensor) -> list[np.ndarray]:
    """numpy copies of `tensors` with one wait for all of them."""
    host = start_host_copy(*tensors)
    for device in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.current_stream(device).synchronize()
    return [h.numpy() for h in host]


# ----------------------------------------------------- background writer ----
class ArtifactWriter:
    """Background artifact writer: overlaps host-side serialization with
    device compute.

    CSV formatting and bz2 compression (the reference's `pkl.bz2` formats)
    run in worker threads, in GIL-releasing C code, while the main thread
    launches the next stage's kernels.

    Jobs are dispatched FIFO; with `workers > 1` they complete in any
    order, so submitters must target distinct paths (stage artifacts do).
    `wait()` drains the queue and re-raises the first failure; the context
    manager calls it on exit, so a trial cannot report success with writes
    still pending. Callers pass host (numpy) data only: a worker never
    touches a CUDA tensor (see `start_host_copy`).
    """

    def __init__(self, workers: int = 1):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue()
        self._err = None
        self._workers = max(1, int(workers))
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"artifact-writer-{i}")
            for i in range(self._workers)]
        for th in self._threads:
            th.start()

    def _run(self):
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            fn, args, kwargs = job
            try:
                # Jobs are independent artifact writes: keep executing
                # after a failure (a sweep-shared writer queues LATER
                # TRIALS' artifacts — skipping them would silently lose
                # files for trials that report 'done'); the FIRST error is
                # kept and re-raised at submit()/wait().
                fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 - re-raised in wait()
                if self._err is None:
                    self._err = e
            finally:
                self._q.task_done()

    def submit(self, fn, *args, **kwargs):
        """Enqueue fn(*args, **kwargs); raises a previously queued write's
        error rather than silently accepting work after a failure."""
        if self._err is not None:
            self.wait()
        self._q.put((fn, args, kwargs))

    def wait(self):
        """Block until every submitted write finished; re-raise the first
        error (independent later jobs still executed — nothing is
        half-applied thanks to atomic temp+rename writes)."""
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self):
        self.wait()
        for _ in range(self._workers):
            self._q.put(None)
        self._q.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # On an exception in the body, still drain (artifacts already
        # queued stay consistent) but prefer the body's error.
        if exc_type is not None:
            try:
                self.close()
            except BaseException:
                pass
            return False
        self.close()
        return False


def submit_write(writer, fn, path, *args, **kwargs):
    """Write now (writer=None) or via the background writer: the single
    call every stage routes its artifact writes through. Creates the
    parent directory eagerly either way so enqueue-order never matters."""
    ensure_dir(path)
    if writer is None:
        fn(path, *args, **kwargs)
    else:
        writer.submit(fn, path, *args, **kwargs)
