"""S2's share of its roofline, in %: the least time of the traced requests'
S2 work (flowbench.bounds.fields_bound_s of the amplitude and phase
interpolations: the Hilbert transform, each RBF fit and evaluation) over the
device time of every operation launched inside their 'request/s2' ranges."""

from flowbench import bounds


def read(run):
    if run.trace is None or run.trace.n_requests == 0:
        return None
    device_s = run.trace.device_s("request/s2")
    if device_s <= 0:
        return None
    bound = bounds.fields_bound_s(run.shapes, ["interpolate", "interpolate_phases"])
    return 100.0 * run.trace.n_requests * bound / device_s
