"""The PCG loop's host time an inner iteration outside its waits (launches,
device guards, Python): the velocity stage's solve.cg span total less its
sync.solve.cg wait total, over the count solve.inner_iters, in us, the mean
over the window's trials. None where the port keeps no such record."""

import numpy as np


def read(run):
    vals = []
    for t in run.timings:
        rec = t.get("velocity", {}).get("trace")
        if rec is None or not rec["counts"].get("solve.inner_iters"):
            continue
        spans = rec["spans"]
        host_s = spans["solve.cg"]["total_s"] - spans["sync.solve.cg"]["total_s"]
        vals.append(1e6 * host_s / rec["counts"]["solve.inner_iters"])
    return float(np.mean(vals)) if vals else None
