"""The 95th percentile of the latency of every trial completed in the traced
run's window, in ms: a trial from its first stage call to its last output,
synchronised. A per-layer reading, because on one shared host its spread
from run to run is too wide for an end-to-end bound (PERF.md)."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies, 95)) * 1e3 if run.latencies else None
