"""B1's share of its roofline, in %: the launches' least times summed
over the window (``roofline.least_seconds``) over the B1 kernels' own
device times summed, from the traced window (a launch the trace lost
counted at the others' mean)."""
import numpy as np


def read(r):
    least = r.rounds["least_s"]
    if r.trace is None or not len(least) or np.isnan(least).any():
        return None
    took = np.mean(r.trace["b1_kernel_s"]) * len(least)
    return float(100.0 * least.sum() / took)
