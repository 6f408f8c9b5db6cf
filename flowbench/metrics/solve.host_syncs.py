"""The solve's blocking device-to-host reads a trial: the counts of the
velocity stage's sync.solve.* waits (the PCG loop's convergence reads, the
refinement's outer tests, the preconditioner's zeroed count), from the
stage's span record (timings 'trace'), the mean over the window's trials.
None where the port keeps no such record."""

import numpy as np


def read(run):
    vals = [sum(n for name, n in t["velocity"]["trace"]["counts"].items()
                if name.startswith("sync.solve."))
            for t in run.timings if "trace" in t.get("velocity", {})]
    return float(np.mean(vals)) if vals else None
