"""The host's time blocked on the device inside the solve a trial: the
total of the velocity stage's sync.solve.* wait spans, in ms, the mean over
the window's trials. None where the port keeps no such record."""

import numpy as np


def read(run):
    vals = [1e3 * sum(s["total_s"] for name, s in t["velocity"]["trace"]["spans"].items()
                      if name.startswith("sync.solve."))
            for t in run.timings if "trace" in t.get("velocity", {})]
    return float(np.mean(vals)) if vals else None
