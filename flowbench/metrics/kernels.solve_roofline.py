"""The solve's share of its roofline, in %: the least time of the traced
trials' solve work (flowbench.bounds.solve_bound_s, from the shapes, the
inner iterations and the outer residual steps the traced trials launched)
over the device time of every operation launched inside their
'request/solve' ranges."""

from flowbench import bounds


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.device_s("request/solve")
    iters = run.launches.get("pcg_direction<float>", 0)
    if device_s <= 0 or iters == 0:
        return None
    bound = bounds.solve_bound_s(run.shapes, iters, run.launches.get("fem_matvec<double>", 0))
    return 100.0 * bound / device_s
