"""S3's detection and classification: the singularity stage's own timings
('detect' + 'classify'), in ms, the mean over the window's trials."""

import numpy as np


def read(run):
    ms = [1e3 * (t["singularities"]["detect"] + t["singularities"]["classify"])
          for t in run.timings if "singularities" in t]
    return float(np.mean(ms)) if ms else None
