"""S4: the decompose stage's own timing ('compute', until the modes are on
the device and synchronised), in ms, the mean over the window's requests."""

import numpy as np


def read(run):
    ms = [1e3 * t["decompose"]["compute"] for t in run.timings if "decompose" in t]
    return float(np.mean(ms)) if ms else None
