"""What the per-metric readers read: one run's window, its trace and
the reference's work counts, as plain arrays.

A lane's window gives a ``Window``. Its ``rounds`` columns (one row per
round of the window) that every lane fills: ``rows`` the units of work
applied (op rows in the array lane), ``msgs`` the messages submitted,
the host clock at the round's start (``ta``) and at the enqueue of its
window kernel (``te``), and ``end`` the host clock at which the device
finished the round; a lane's own columns sit beside them (the array
lane's are described in its file). ``collect`` adds ``least_s``, each
round's least time by the roofline (NaN where the lane gives none). In a
traced run, ``trace`` holds ``trace.read``'s dict, the window kernel's
own times among them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Window:
    rounds: dict             # column -> float array, one row per round
    opens: np.ndarray        # [batches, 2]: host clock around each open
    t_start: float
    t_end: float


@dataclass
class Readings:
    rounds: dict
    opens: np.ndarray        # [batches, 2]: host clock around each open
    window_s: float
    setup_s: float
    trace: dict | None       # trace.read's dict in a traced run


def collect(win: Window, setup_s: float, least=None,
            trace=None) -> Readings:
    """Readings of ``win``; ``least[i]`` is the least time of the
    window's round ``i``."""
    cols = dict(win.rounds)
    cols["least_s"] = (np.asarray(least, float) if least is not None
                       else np.full(len(cols["ta"]), np.nan))
    return Readings(rounds=cols, opens=win.opens,
                    window_s=win.t_end - win.t_start, setup_s=setup_s,
                    trace=trace)
