"""The solve's inner PCG iterations a trial, summed over its windows,
anchors and outer steps (the velocity stage's span record, count
solve.inner_iters), the mean over the window's trials. None where the port
keeps no such record."""

import numpy as np


def read(run):
    vals = [t["velocity"]["trace"]["counts"]["solve.inner_iters"]
            for t in run.timings if "trace" in t.get("velocity", {})]
    return float(np.mean(vals)) if vals else None
