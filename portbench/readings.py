"""What the per-metric readers read: one run's window, its trace and
the reference's work counts, as plain arrays.

``rounds`` columns (one row per round of the window): ``rows`` op rows
applied, ``msgs`` messages ticketed, ``refused``; the host clock at the
start of the ticket (``ta``), at the end of the ticket (``tb``) and of
the stamp (``tc``), at the upload's start (``tw``: after the wait for
the device's earlier work in a traced run, ``tc`` otherwise), at its
end (``td``) and at the apply's enqueue (``te``); ``end`` the host clock
at which the device finished the apply; ``least_s`` the apply's least
time by the roofline (NaN without the reference's counts). In a traced
run, ``trace`` holds ``trace.read``'s dict, the B1 kernels' own times
among them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Readings:
    rounds: dict
    opens: np.ndarray        # [batches, 2]: host clock around each open
    window_s: float
    setup_s: float
    trace: dict | None       # trace.read's dict in a traced run


def collect(win, setup_s: float, least=None, trace=None) -> Readings:
    """Readings of ``win`` (``harness.Window``); ``least[r]`` is the
    least time of round ``r`` of a batch."""
    recs = win.rounds
    cols = {k: np.array([r[i] for r in recs], float) for i, k in
            enumerate(("batch", "round", "rows", "msgs", "refused",
                       "ta", "tb", "tc", "tw", "td", "te", "end"))}
    cols["least_s"] = (np.asarray(least)[cols["round"].astype(int)]
                       if least is not None else np.full(len(recs), np.nan))
    return Readings(rounds=cols, opens=np.array(win.opens).reshape(-1, 2),
                    window_s=win.t_end - win.t_start, setup_s=setup_s,
                    trace=trace)
