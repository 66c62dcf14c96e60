"""The 95th percentile of every round's time, from the start of its
ticket to the device's end of its apply (a CUDA event, read after the
window), in ms."""
import numpy as np


def read(r):
    t = r.rounds["end"] - r.rounds["ta"]
    return float(np.percentile(t, 95) * 1e3) if len(t) else None
