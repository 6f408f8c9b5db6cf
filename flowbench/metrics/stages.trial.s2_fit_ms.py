"""S2's fit on the device: the device time of the operations launched
inside the `s2.fit` spans (K17 `rbf_fit`, the one launch a span holds on the
card, found by its kernel's name in the 'request/s2' ranges; the traced
stretch keeps the request ranges only), in ms a traced trial. None where
the trace holds no such kernel."""


def read(run):
    if run.trace is None or run.trace.n_requests == 0:
        return None
    fit = [o.dur for o in run.trace.ops
           if o.range.startswith("request/s2") and "rbf_fit_kernel" in o.name]
    if not fit:
        return None
    return 1e-3 * sum(fit) / run.trace.n_requests
