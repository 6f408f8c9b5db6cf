"""Build the package's CUDA sources into one shared library, at first use.

`nvcc` compiles each `csrc/*.cu` for Hopper (`sm_90a`) into an object, all
sources at once in parallel processes, then links the objects into a shared
library with a plain C interface, which `kernels._lib` loads with ctypes. The
library lives in `kernels/_build/` under a name keyed by a hash of the
sources and the command line, so an edit rebuilds and an unchanged tree
reuses the last build. Nothing here runs at import.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
_CUDA_HOME_NVCC = Path("/usr/local/cuda/bin/nvcc")


def sources() -> list[Path]:
    """The CUDA translation units, in a fixed order."""
    return sorted(CSRC_DIR.glob("*.cu"))


def compile_command(nvcc: str, source: Path, obj: Path) -> list[str]:
    """The nvcc command line that compiles one source into object `obj`."""
    return [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(obj), str(source)]


def link_command(nvcc: str, objects: list[Path], output: Path) -> list[str]:
    """The nvcc command line that links the objects into library `output`."""
    return [nvcc, *NVCC_FLAGS, "-shared", "-o", str(output), *(str(o) for o in objects)]


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    if _CUDA_HOME_NVCC.exists():
        return str(_CUDA_HOME_NVCC)
    raise RuntimeError(
        "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc: the CUDA "
        "kernels of manifold_flow_tpu_torch are compiled from source at "
        "first use and need the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return BUILD_DIR / f"libmanifold_flow_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of the same sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # Objects and the library go to a temporary directory first, so a
    # concurrent or interrupted build never leaves a half-written library
    # under the final name.
    srcs = sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [Path(tmp) / f"{src.stem}.o" for src in srcs]
        # One nvcc process per source, all at once.
        with ThreadPoolExecutor(max(len(srcs), 1)) as pool:
            runs = list(pool.map(
                lambda so: subprocess.run(compile_command(nvcc, *so),
                                          capture_output=True, text=True),
                zip(srcs, objects)))
        failed = [f"{src.name} (exit {run.returncode}):\n{run.stdout}{run.stderr}"
                  for src, run in zip(srcs, runs) if run.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        lib = Path(tmp) / out.name
        run = subprocess.run(link_command(nvcc, objects, lib), capture_output=True,
                             text=True)
        if run.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {run.returncode}):\n{run.stderr}")
        os.replace(lib, out)
    return out
