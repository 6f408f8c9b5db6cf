"""Run one cell of the benchmark of manifold_flow_tpu_torch once.

    python3 flowbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, flowbench/ and the
port. It sets up the cell (inputs from the seed, the port's surface and
kernels, warm-up), measures for --seconds, with --trace 1 also traces a few
requests, checks a seeded sample of the window's outputs against the plain
reference, and prints one JSON line last on standard output, the compared
numbers with their limits last on standard error. It needs a CUDA card and
never falls back to the CPU; it exits with another code than 0, printing no
result, where the card is missing, a request breaks the harness, or JAX or
the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# CPU thread pools of this process, fixed before torch and numpy load.
THREADS = 4
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(THREADS)
# Kernel and build caches at fixed places inside the checkout, so that only
# a checkout's first run builds.
_CACHE = ROOT / ".cache" / "flowbench"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(_CACHE / "nv")
sys.path.insert(0, str(ROOT))


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return sys.float_info.max
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from flowbench import harness

    torch.set_num_threads(THREADS)
    cell = harness.Cell.load(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.spec["chips"]:
        print(f"flowbench: {args.workload} needs {cell.spec['chips']} CUDA device(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"flowbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, (value, limit) in result["check"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
