"""Build the package's CUDA sources into one shared library, at first use.

`nvcc` compiles every `csrc/*.cu` for Hopper (`sm_90a`) into a shared
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
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_CUDA_HOME_NVCC = Path("/usr/local/cuda/bin/nvcc")


def sources() -> list[Path]:
    """The CUDA translation units, in a fixed order."""
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc_command(nvcc: str, output: Path) -> list[str]:
    """The nvcc command line that builds the library into `output`."""
    return [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(output),
            *(str(s) for s in sources())]


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
    # Compile to a temporary name and rename, so a concurrent or interrupted
    # build never leaves a half-written library under the final name.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(find_nvcc(), Path(tmp)),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
