"""Package-level properties of the PyTorch port: what it imports, how its
CUDA kernels are built, and how the kernel wrappers choose a path."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import manifold_flow_tpu_torch
from manifold_flow_tpu_torch import kernels
from manifold_flow_tpu_torch.kernels import _lib, build
from manifold_flow_tpu_torch.kernels import fem as kfem

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = Path(manifold_flow_tpu_torch.__file__).resolve().parent


def test_import_pulls_in_no_jax_and_loads_no_kernels():
    modules = sorted(
        ".".join(p.relative_to(PACKAGE.parent).with_suffix("").parts)
        for p in PACKAGE.rglob("*.py") if p.name != "__init__.py")
    assert "manifold_flow_tpu_torch.pipeline.cli" in modules
    assert "manifold_flow_tpu_torch.kernels.analysis" in modules
    assert "manifold_flow_tpu_torch.kernels.coarse" in modules
    assert "manifold_flow_tpu_torch.solve.coarse" in modules
    assert "manifold_flow_tpu_torch.solve.cholesky" in modules
    code = (
        "import importlib, sys\n"
        "import manifold_flow_tpu_torch as m\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'manifold_flow_tpu', 'triton', 'yaml', 'pandas')]\n"
        "assert not bad, bad\n"
        "from manifold_flow_tpu_torch.kernels import _lib\n"
        "assert _lib._LIB is None\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_no_source_file_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|manifold_flow_tpu)\b",
                         re.MULTILINE)
    offenders = [str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert not offenders


def test_nvcc_command_targets_sm90a(tmp_path):
    out = tmp_path / "lib.so"
    cmd = build.nvcc_command("nvcc", out)
    assert cmd[0] == "nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in cmd
    assert "--use_fast_math" not in cmd and "-fmad=false" not in cmd
    assert cmd[cmd.index("-o") + 1] == str(out)
    sources = [Path(a).name for a in cmd if a.endswith(".cu")]
    assert sources == ["analysis_kernels.cu", "coarse_kernels.cu", "fem_kernels.cu",
                       "pcg_kernels.cu"]


def test_library_path_is_keyed_by_sources():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert path == build.library_path()
    assert re.fullmatch(r"libmanifold_flow_kernels_[0-9a-f]{16}\.so", path.name)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "_CUDA_HOME_NVCC", tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_wrappers_check_their_inputs():
    x = torch.zeros((2, 8), dtype=torch.float32)
    with pytest.raises(TypeError, match="float32 or float64"):
        kfem.pcg_dot(x.int(), x.int())
    with pytest.raises(TypeError, match="must be torch.float32"):
        kfem.pcg_dot(x, x.double())
    with pytest.raises(ValueError, match="shape"):
        kfem.pcg_dot(x, x[:, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        kfem.pcg_dot(x, torch.zeros((8, 2)).t())
    with pytest.raises(ValueError, match="unsupported device"):
        kfem.pcg_dot(x.to("meta"), x.to("meta"))
    with pytest.raises(ValueError, match="share one device"):
        kfem.pcg_dot(x, x.to("meta"))


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    gen = torch.Generator().manual_seed(0)
    t, n = 3, 5
    x, r, p, ap = torch.randn((4, t, 2 * n), generator=gen, dtype=torch.float64)
    dinv = torch.randn((t, n, 2, 2), generator=gen, dtype=torch.float64)
    rz = torch.rand(t, generator=gen, dtype=torch.float64)
    pap = torch.tensor([1.0, 0.0, 2.0], dtype=torch.float64)
    before = dict(kernels.LAUNCHES)
    z, rz_new, rr = torch.empty_like(x), torch.empty_like(rz), torch.empty_like(rz)
    x0, r0 = x.clone(), r.clone()
    kfem.pcg_update(x, r, z, p, ap, dinv, rz, pap, rz_new, rr)
    alpha = torch.tensor([rz[0] / 1.0, 0.0, rz[2] / 2.0], dtype=torch.float64)
    torch.testing.assert_close(x, x0 + alpha[:, None] * p)
    torch.testing.assert_close(r, r0 - alpha[:, None] * ap)
    torch.testing.assert_close(z, kfem.apply_block_diag(dinv, r))
    torch.testing.assert_close(rz_new, (r * z).sum(-1))
    torch.testing.assert_close(rr, (r * r).sum(-1))
    q = p.clone()
    kfem.pcg_direction(q, z, rz_new, torch.tensor([2.0, 0.0, 1.0], dtype=torch.float64))
    beta = torch.tensor([rz_new[0] / 2.0, 0.0, rz_new[2]], dtype=torch.float64)
    torch.testing.assert_close(q, z + beta[:, None] * p)
    assert kernels.LAUNCHES == before
    assert _lib._LIB is None


def test_reset_launches_zeroes_every_count():
    kernels.LAUNCHES["pcg_dot<float>"] += 3
    kernels.reset_launches()
    assert set(kernels.LAUNCHES.values()) == {0}
    assert {k.split("<")[0] for k in kernels.LAUNCHES} == {
        "fem_matvec", "jacobi_blocks", "frame_factors_rhs", "pcg_dot",
        "pcg_update", "pcg_direction", "recombine_speed", "detect_singular",
        "compact_detected", "coarse_assemble", "coarse_restrict", "coarse_gemv",
        "coarse_prolong_dot"}
    assert kernels.LAUNCHES is _lib.LAUNCHES
