"""Fixtures of the benchmark's CPU tests: a checkout-like tree that holds a
test-only configuration (data/tiny.json) under the repository's own traffic
mixes and metric readers, so that the harness runs its whole loop on the CPU
at a tiny size. Tests that need a CUDA card carry the `cuda` marker and
decide in a fixture whether there is one."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
DATA = Path(__file__).resolve().parent / "data"
TRAFFIC = ("trial", "fields")


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
    # One intra-op thread a test process: pytest-xdist runs several.
    import torch

    torch.set_num_threads(1)


def make_root(base: Path, traffic=TRAFFIC) -> Path:
    """A tree with BENCHMARK.json naming cells `tiny.<traffic>`, the tiny
    configuration, the repository's traffic files cut to a pool of 3, its
    metric readers, and the test limits."""
    root = base / "checkout"
    fb = root / "flowbench"
    for sub in ("configs", "traffic", "limits"):
        (fb / sub).mkdir(parents=True)
    shutil.copytree(REPO / "flowbench" / "metrics", fb / "metrics")
    shutil.copy(DATA / "tiny.json", fb / "configs" / "tiny.json")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    traffic_of = {w["name"]: w["traffic"] for w in bench["workloads"]}
    for name in traffic:
        spec = json.loads((REPO / "flowbench" / "traffic" / f"{name}.json").read_text())
        spec.update(pool=3, trace_requests=2)
        spec["warmup"]["max_requests"] = 4
        (fb / "traffic" / f"{name}.json").write_text(json.dumps(spec))
        shutil.copy(DATA / "tiny_limits.json", fb / "limits" / f"tiny.{name}.json")
    bench["configs"] = [{"name": "tiny", "source": "test", "file": "flowbench/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": f"tiny.{t}", "config": "tiny", "traffic": t, "chips": 1,
                           "why": "test"} for t in traffic]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({f"tiny.{traffic_of[w]}" for w in m["workloads"]
                                     if traffic_of[w] in traffic})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("flowbench"))


def run_cell(root: Path, workload: str, seed: int = 2 ** 33 + 5, seconds: float = 0.3,
             trace: bool = False) -> dict:
    from flowbench import harness

    return harness.run(harness.Cell.load(workload, root), seed, seconds, trace, "cpu",
                       time.perf_counter())


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch
