"""Host ms of a batch's open: the ``MultiDocSequencer``, its joins and
``make_table``, mean per batch."""


def read(r):
    t = r.opens[:, 1] - r.opens[:, 0]
    return float(t.mean() * 1e3) if len(t) else None
