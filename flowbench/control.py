"""The control: the plain reference computed in float32, put in the port's
place, judged by the same comparison as the port's outputs.

    python3 flowbench/control.py --workload <name> --seeds <n> [<n> ...]

The configuration states float64, so the control is the nearest precision
below. For each seed it makes the run's inputs, lets the reference compute
every output the port's stages give in float32 (the whole movie's solve and
its SVD too, as S4 gets it), judges them against the float64 reference on
the frames and requests a run would sample, and prints one JSON line
{"seed", "check": {name: [value, limit]}, "correct"}. Its smallest readings
over the seeds are the upper readings the limits are set below
(PERF.md). The benchmark's own runs do not run it; it needs no card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from flowbench import check, harness, inputs  # noqa: E402


def control(cell: harness.Cell, seed: int) -> dict:
    traffic = cell.traffic
    inp = inputs.Inputs.make(cell.config, traffic, seed)
    stages = traffic["stages"]
    pick = np.random.default_rng([seed, 2])
    items = pick.choice(traffic["pool"], size=traffic["check"]["requests"], replace=False)
    edges = np.linspace(0, len(inp.times) - 1, traffic["check"]["frames"] + 1).astype(int)
    frames = ([int(pick.integers(lo, hi)) for lo, hi in zip(edges[:-1], edges[1:])]
              if "velocity" in stages else [])
    movies = None
    if "decompose" in stages and "velocity" not in stages:
        movies = inp.velocity_movies("cpu", seed, traffic["velocity_noise"]).numpy()
    sampled = []
    for item in items:
        out = check.reference(inp, stages, int(item), frames, np.float32, whole_movie=True,
                              svd_input=None if movies is None else movies[item])
        sampled.append((int(item), out))
    return check.verdict(check.judge(inp, stages, sampled, frames), cell.limits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = harness.Cell.load(args.workload, ROOT)
    for seed in args.seeds:
        v = control(cell, seed)
        print(json.dumps({"workload": args.workload, "seed": seed, "check": v["numbers"],
                          "correct": v["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
