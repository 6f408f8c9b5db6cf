"""The field stages' share of their roofline, in %: the least time of the
traced requests' S2, S4 and S5 work (flowbench.bounds.fields_bound_s) over
the device time of every operation launched inside their 'request/s2',
'request/svd' and 'request/s5' ranges."""

from flowbench import bounds


def read(run):
    if run.trace is None or run.trace.n_requests == 0:
        return None
    device_s = sum(run.trace.device_s(r) for r in ("request/s2", "request/svd", "request/s5"))
    if device_s <= 0:
        return None
    stages = run.cell.traffic["stages"]
    return 100.0 * run.trace.n_requests * bounds.fields_bound_s(run.shapes, stages) / device_s
