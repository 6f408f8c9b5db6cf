"""The solve's inner PCG iterations a trial, as the velocity stage reports
them (VelocityStage.iterations: for a windowed solve, the largest window's
count), the mean over the window's trials."""

import numpy as np


def read(run):
    return float(np.mean(run.iterations)) if run.iterations else None
