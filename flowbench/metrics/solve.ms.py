"""S3's solve on the host's clock: the velocity stage's timings 'dispatch'
(the solve's host loop and K5) + 'solve_wait' (until the converged flags
are on the host), in ms, the mean over the window's trials."""

import numpy as np


def read(run):
    ms = [1e3 * (t["velocity"]["dispatch"] + t["velocity"]["solve_wait"])
          for t in run.timings if "velocity" in t]
    return float(np.mean(ms)) if ms else None
