"""S3 analysis's time blocked on the device a trial: the total of the
singularity stage's sync.analysis.* wait spans (the candidate counts, the
class codes, the compacted rows), in ms, the mean over the window's trials.
None where the port keeps no such record."""

import numpy as np


def read(run):
    vals = [1e3 * sum(s["total_s"] for name, s in t["singularities"]["trace"]["spans"].items()
                      if name.startswith("sync.analysis."))
            for t in run.timings if "trace" in t.get("singularities", {})]
    return float(np.mean(vals)) if vals else None
