"""Host ms in ``MultiDocSequencer.ticket_boxcar``, mean per round."""


def read(r):
    t = r.rounds["tb"] - r.rounds["ta"]
    return float(t.mean() * 1e3) if len(t) else None
