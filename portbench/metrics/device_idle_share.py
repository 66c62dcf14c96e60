"""1 - device busy / window, from the profiler's device events over the
traced window."""


def read(r):
    if r.trace is None:
        return None
    return float(1.0 - r.trace["busy_s"] / r.trace["window_s"])
