"""On the card: one short run of each cell through the command, as the
driver runs it. Skips without a CUDA card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_on_the_card_is_correct(cuda, workload):
    out = subprocess.run([sys.executable, "flowbench/run.py", "--workload", workload,
                          "--seed", "4000000001", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
