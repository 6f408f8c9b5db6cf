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
    assert "manifold_flow_tpu_torch.kernels.streams" in modules
    assert "manifold_flow_tpu_torch.kernels.winding" in modules
    assert "manifold_flow_tpu_torch.ops.streamline" in modules
    assert "manifold_flow_tpu_torch.ops.winding" in modules
    assert "manifold_flow_tpu_torch.kernels.fields" in modules
    for name in ("phase", "wavespeed", "interpolate", "svd", "validation"):
        assert f"manifold_flow_tpu_torch.ops.{name}" in modules
    assert "manifold_flow_tpu_torch.viz.fields" in modules
    assert "manifold_flow_tpu_torch.utils.profiling" in modules
    code = (
        "import importlib, sys\n"
        "import manifold_flow_tpu_torch as m\n"
        "import manifold_flow_tpu_torch.viz\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'manifold_flow_tpu', 'triton', 'yaml', 'pandas', "
        "'matplotlib', 'pyvista', 'mne')]\n"
        "assert not bad, bad\n"
        "from manifold_flow_tpu_torch.kernels import _lib\n"
        "assert _lib._LIB is None\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_no_source_file_imports_jax():
    """Neither the package nor chip_smoke.py, which the machine with the card
    runs without JAX, names JAX or the JAX package in an import."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|manifold_flow_tpu)\b",
                         re.MULTILINE)
    files = [*PACKAGE.rglob("*.py"), ROOT / "chip_smoke.py"]
    offenders = [str(p.relative_to(ROOT)) for p in files if pattern.search(p.read_text())]
    assert not offenders


def test_nvcc_command_targets_sm90a(tmp_path):
    """One compile per source (the build runs them in parallel), then one
    link into the shared library."""
    srcs = build.sources()
    assert [s.name for s in srcs] == [
        "analysis_kernels.cu", "coarse_kernels.cu", "fem_kernels.cu",
        "field_kernels.cu", "pcg_kernels.cu", "stream_kernels.cu",
        "svd_kernels.cu", "winding_kernels.cu"]
    objs = [tmp_path / f"{s.stem}.o" for s in srcs]
    out = tmp_path / "lib.so"
    cmds = [build.compile_command("nvcc", s, o) for s, o in zip(srcs, objs)]
    cmds.append(build.link_command("nvcc", objs, out))
    for cmd in cmds:
        assert cmd[0] == "nvcc"
        assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
        for flag in ("-std=c++17", "-O3", "-fPIC"):
            assert flag in cmd
        assert "--use_fast_math" not in cmd and "-fmad=false" not in cmd
    for cmd, src, obj in zip(cmds, srcs, objs):
        assert "-c" in cmd and "-shared" not in cmd
        assert cmd[-1] == str(src) and cmd[cmd.index("-o") + 1] == str(obj)
    link = cmds[-1]
    assert "-shared" in link and "-c" not in link
    assert link[link.index("-o") + 1] == str(out)
    assert [a for a in link if a.endswith(".o")] == [str(o) for o in objs]


FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-c" in args:
    if "bad" in args[-1]:
        print("error: " + args[-1])
        sys.exit(2)
    open(out, "w").write(args[-1])
else:
    open(out, "w").write("+".join(open(a).read() for a in args if a.endswith(".o")))
"""


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("b.cu", "a.cu"):
        (csrc / name).write_text("// " + name)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    lib = build.build()
    assert lib == build.library_path() and lib.parent == tmp_path / "_build"
    assert lib.read_text() == f"{csrc / 'a.cu'}+{csrc / 'b.cu'}"
    assert list((tmp_path / "_build").iterdir()) == [lib]  # objects cleaned up
    assert build.build() == lib
    (csrc / "bad.cu").write_text("// bad")
    with pytest.raises(RuntimeError, match=r"nvcc failed on bad\.cu \(exit 2\)"):
        build.build()
    assert list((tmp_path / "_build").iterdir()) == [lib]


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
    """In a fresh interpreter, so that no kernel library loaded by another
    test of the process (the `cuda` cases on a GPU) is there to find."""
    code = (
        "import torch\n"
        "from manifold_flow_tpu_torch import kernels\n"
        "from manifold_flow_tpu_torch.kernels import _lib\n"
        "from manifold_flow_tpu_torch.kernels import fem as kfem\n"
        "gen = torch.Generator().manual_seed(0)\n"
        "t, n = 3, 5\n"
        "x, r, p, ap = torch.randn((4, t, 2 * n), generator=gen, dtype=torch.float64)\n"
        "dinv = torch.randn((t, n, 2, 2), generator=gen, dtype=torch.float64)\n"
        "rz = torch.rand(t, generator=gen, dtype=torch.float64)\n"
        "pap = torch.tensor([1.0, 0.0, 2.0], dtype=torch.float64)\n"
        "before = dict(kernels.LAUNCHES)\n"
        "z, rz_new, rr = torch.empty_like(x), torch.empty_like(rz), torch.empty_like(rz)\n"
        "x0, r0 = x.clone(), r.clone()\n"
        "kfem.pcg_update(x, r, z, p, ap, dinv, rz, pap, rz_new, rr)\n"
        "alpha = torch.tensor([rz[0] / 1.0, 0.0, rz[2] / 2.0], dtype=torch.float64)\n"
        "torch.testing.assert_close(x, x0 + alpha[:, None] * p)\n"
        "torch.testing.assert_close(r, r0 - alpha[:, None] * ap)\n"
        "torch.testing.assert_close(z, kfem.apply_block_diag(dinv, r))\n"
        "torch.testing.assert_close(rz_new, (r * z).sum(-1))\n"
        "torch.testing.assert_close(rr, (r * r).sum(-1))\n"
        "q = p.clone()\n"
        "kfem.pcg_direction(q, z, rz_new, torch.tensor([2.0, 0.0, 1.0], dtype=torch.float64))\n"
        "beta = torch.tensor([rz_new[0] / 2.0, 0.0, rz_new[2]], dtype=torch.float64)\n"
        "torch.testing.assert_close(q, z + beta[:, None] * p)\n"
        "ctl, gated = torch.tensor([0, 0, 5]), torch.empty_like(rz)\n"
        "kfem.pcg_gate(rr, torch.sqrt(rr) / 2, ctl, rz_new, gated)\n"
        "assert ctl.tolist() == [1, 1, 5] and torch.equal(gated, rz_new)\n"
        "assert kernels.LAUNCHES == before\n"
        "assert _lib._LIB is None\n"
        "print('plain')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "plain"


def test_reset_launches_zeroes_every_count():
    kernels.LAUNCHES["pcg_dot<float>"] += 3
    kernels.reset_launches()
    assert set(kernels.LAUNCHES.values()) == {0}
    assert {k.split("<")[0] for k in kernels.LAUNCHES} == {
        "fem_matvec", "jacobi_blocks", "frame_factors_rhs", "pcg_dot",
        "pcg_update", "pcg_direction", "pcg_gate", "recombine_speed", "detect_singular",
        "compact_detected", "coarse_assemble", "coarse_restrict", "coarse_gemv",
        "coarse_prolong_dot", "classify_candidates", "next_hop", "trace_walks",
        "pack_walks", "winding_profile", "wave_speed", "rbf_fit", "rbf_eval", "jacobi_svd"}
    assert kernels.LAUNCHES is _lib.LAUNCHES


@pytest.mark.parametrize("dtype, n_vert, want", [
    (torch.float32, 0, 1), (torch.float32, 1, 1), (torch.float32, 1024, 1),
    (torch.float32, 1025, 2), (torch.float32, 3136, 4), (torch.float32, 12544, 13),
    (torch.float64, 3136, 7), (torch.float64, 12544, 25),
    (torch.float32, 10 ** 7, _lib.MAX_SLICES)])
def test_frame_slices_give_each_thread_one_vector_group(dtype, n_vert, want):
    """One 16-byte group of vertices (4 in f32, 2 in f64) for each of a
    block's 256 threads, between 1 and MAX_SLICES blocks a frame."""
    assert _lib.frame_slices(n_vert, dtype) == want


def test_slice_workspace_is_kept_per_stream_and_grows():
    """The sliced kernels' partials and tickets: one pair per (device,
    stream), kept while large enough, replaced by a larger one with every
    ticket at 0."""
    dev = torch.device("cpu")
    part, ticket = _lib.slice_workspace(dev, -1, 97, 13)
    assert part.dtype == torch.float64 and part.numel() == 2 * 97 * 13
    assert ticket.dtype == torch.int32 and ticket.numel() == 97
    assert not ticket.any()
    assert all(a is b for a, b in zip(_lib.slice_workspace(dev, -1, 97, 13), (part, ticket)))
    assert all(a is b for a, b in zip(_lib.slice_workspace(dev, -1, 5, 4), (part, ticket)))
    other = _lib.slice_workspace(dev, -2, 5, 4)
    assert other[0] is not part and other[0].numel() == 2 * 5 * 4
    grown = _lib.slice_workspace(dev, -1, 98, 13)
    assert grown[0].numel() == 2 * 98 * 13 and grown[1].numel() == 98
    assert not grown[1].any()
    assert _lib.slice_workspace(dev, -1, 97, 13)[0] is grown[0]
    for key in ((dev, -1), (dev, -2)):
        del _lib._SLICE_WORKSPACE[key]


_C_TYPES = {"int64_t": _lib._I, "double": _lib._D}


def _entry_point_params(name: str) -> list:
    """The ctypes of C entry point mf_<name>_* as csrc/*.cu declares it."""
    decl = re.compile(r'extern "C" int mf_' + name + r'_(?:##SUFFIX|i32)\((.*?)\)\s*\{',
                      re.S)
    found = [m.group(1) for src in build.sources()
             for m in decl.finditer(src.read_text())]
    assert len(found) == 1, f"mf_{name}: {len(found)} declarations"
    params = [p.replace("\\", " ").split() for p in found[0].split(",")]
    return [_lib._P if "*" in "".join(p) else _C_TYPES[p[-2]] for p in params]


@pytest.mark.parametrize("name", sorted({**_lib._ARGTYPES, **_lib._INT_ARGTYPES}))
def test_registered_argtypes_match_the_c_entry_points(name):
    """ctypes passes each argument as its registered type: a pointer or an
    int64 in the wrong place would be cut or misread, so every registered
    entry point's types (the stream last) follow its C declaration."""
    argtypes = {**_lib._ARGTYPES, **_lib._INT_ARGTYPES}[name]
    assert _entry_point_params(name) == argtypes
