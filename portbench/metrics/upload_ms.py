"""Host ms in ``convert.batch_from_numpy``, mean per round, in the
traced run, where the host waits for the device's earlier work before
the upload's clock starts (its copies from pageable memory would wait
for it): the copies alone. None in a run without the trace."""


def read(r):
    if r.trace is None:
        return None
    t = r.rounds["td"] - r.rounds["tw"]
    return float(t.mean() * 1e3) if len(t) else None
