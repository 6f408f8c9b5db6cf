"""Nothing the benchmark runs loads JAX or the JAX package: the harness's
check compares top-level module names whole (the port's name begins with
the JAX package's)."""

from __future__ import annotations

import subprocess
import sys

from conftest import REPO

SCRIPT = r"""
import sys, time
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
from conftest import make_root
from pathlib import Path
import tempfile
from flowbench import harness, control
root = make_root(Path(tempfile.mkdtemp(dir={tmp!r})))
for w in ("tiny.trial", "tiny.fields"):
    harness.run(harness.Cell.load(w, root), 7, 0.2, w == "tiny.trial", "cpu", time.perf_counter())
    control.control(harness.Cell.load(w, root), 8)
assert "manifold_flow_tpu_torch" in sys.modules
print("LOADED", harness.forbidden_modules())
"""


def test_a_run_loads_no_jax(tmp_path):
    code = SCRIPT.format(repo=str(REPO), tests=str(REPO / "flowbench" / "tests"),
                         tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


def test_the_check_compares_whole_top_level_names():
    from flowbench import harness

    code = ("import sys, types; sys.path.insert(0, %r); from flowbench import harness; "
            "sys.modules['jax.numpy'] = types.ModuleType('jax.numpy'); "
            "sys.modules['manifold_flow_tpu_torchx'] = types.ModuleType('x'); "
            "print(harness.forbidden_modules())" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "['jax']"
    assert "manifold_flow_tpu" in harness.FORBIDDEN
