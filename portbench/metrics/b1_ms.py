"""Device ms of a B1 launch: the window kernel's own time in the
traced window, all launches' time over their count."""
import numpy as np


def read(r):
    if r.trace is None:
        return None
    return float(np.mean(r.trace["b1_kernel_s"]) * 1e3)
