"""The traced window: ``torch.profiler`` with CUDA activity over the
whole window, read once the window has closed.

Device intervals are every kernel, copy and fill the trace holds. The
trace's clock is tied to the host's by the lane's window kernel (its
``KERNEL``: one launch a round, whose name holds the lane's pattern;
``merge_window``, B1, in the array lane): each round's window kernel
ends on the device where the round's device mark puts it on the host
clock. With as many launches as rounds, the k-th launch is the k-th
round's, and the gap between the two clocks is read round by round (it
drifts, and now and then steps, by tenths of a millisecond over a
window). Where the profiler lost launches from its records, the gap is
read at the window's two ends, from the 20 rounds whose ends agree best
with the first and the last 20 launches', and carried straight between
them. From that:

- ``busy_s``: the union of device intervals inside the window;
- ``<name>_kernel_s``: every window kernel launch's device time in the
  window, and ``<name>_lost`` the launches the trace lost (``b1_...`` in
  the array lane);
- ``<name>_s`` for each of the lane's ``SUMS``: the device time inside
  the window of the operations whose names hold its pattern;
- ``device_ops``: device time by operation name, the ten largest;
- ``idle_gaps``: the device's idle time inside the window by what the
  host was doing then (a phase of a round, a batch's open, or the time
  between a round's last phase and the next round's first), the ten
  largest.

A trace that holds no device event, or no launch of the window kernel,
is an error, and so is one that lost more than ``MAX_LOST`` of the
launches or holds more than the window made.
"""
from __future__ import annotations

import numpy as np
import torch

MAX_LOST = 0.01    # the share of launches the trace may lose


class Trace:
    def __init__(self):
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()

    def device_events(self) -> list:
        """(name, start s, end s) of every device event, trace clock."""
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            start = e.start_ns() / 1e9
            out.append((e.name(), start, start + e.duration_ns() / 1e9))
        return out


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged ``[n, 2]`` intervals, sorted."""
    if not len(intervals):
        return intervals
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [iv[0].tolist()]
    for a, b in iv[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.array(out)


def host_phases(win, phases) -> tuple:
    """Start times (sorted) and labels of what the host did in the
    window (a ``readings.Window``): each batch's open, each round's
    ``phases`` (``(column, label)``, in order), the rest."""
    spans = [(t0, "open") for t0, _ in win.opens]
    spans += [(t1, "between rounds") for _, t1 in win.opens]
    cols = [(win.rounds[c], label) for c, label in phases]
    for i in range(len(win.rounds["end"])):
        spans += [(col[i], label) for col, label in cols]
    spans.sort(key=lambda s: s[0])
    return np.array([s[0] for s in spans]), [s[1] for s in spans]


def _edge_gap(ends: np.ndarray, hosts: list) -> tuple:
    """(host time, gap) of the run of rounds, among ``hosts``, whose
    ends line up with ``ends``: the one whose gaps agree the most."""
    def spread(h):
        g = ends - h
        return float(np.median(np.abs(g - np.median(g))))
    h = min(hosts, key=spread)
    return float(h.mean()), float(np.median(ends - h))


def read(trace: Trace, win, phases, kernel: tuple,
         sums: dict | None = None) -> dict:
    """``busy_s``, ``window_s``, ``device_ops``, ``idle_gaps``, the window
    kernel's times and the summed times of the traced window (a
    ``readings.Window``), for a lane's ``PHASES``, ``KERNEL`` and
    ``SUMS`` (see the module's docstring)."""
    kernel_name, pattern = kernel
    events = trace.device_events()
    launches = sorted((a, b) for n, a, b in events if pattern in n)
    host = np.asarray(win.rounds["end"], float)
    lost = len(host) - len(launches)
    if not events or not launches or lost < 0 or \
            lost > MAX_LOST * len(host):
        raise RuntimeError(f"the device trace holds {len(events)} events "
                           f"and {len(launches)} launches of {pattern!r} "
                           f"while the window made {len(host)}")
    ends = np.array([b for _, b in launches])
    if lost == 0:
        def to_trace(t):
            return np.asarray(t) + np.interp(t, host, ends - host)
    else:
        at, gap = zip(*(_edge_gap(ends[:20], [host[i:i + 20] for i in
                                              range(lost + 1)]),
                        _edge_gap(ends[-20:], [host[len(host) - 20 - i:
                                                    len(host) - i]
                                               for i in range(lost + 1)])))

        def to_trace(t):
            return np.asarray(t) + np.interp(t, at, gap)
    lo, hi = float(to_trace(win.t_start)), float(to_trace(win.t_end))
    iv = np.array([(max(a, lo), min(b, hi)) for _, a, b in events
                   if b > lo and a < hi]).reshape(-1, 2)
    busy = _union(iv)
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0.0
    by_name = {}
    for name, a, b in events:
        if b > lo and a < hi:
            by_name[name] = by_name.get(name, 0.0) + (min(b, hi) - max(a, lo))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # idle time up to t (trace clock), piecewise linear over the idle
    # intervals; each host phase takes the idle time it overlaps
    gaps = np.concatenate([[lo], busy.reshape(-1), [hi]]).reshape(-1, 2)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    xs = gaps.reshape(-1)
    ys = np.concatenate([[0.0], np.cumsum(gaps[:, 1] - gaps[:, 0])])
    ys = np.stack([ys[:-1], ys[1:]], axis=1).reshape(-1)
    starts, labels = host_phases(win, phases)
    bounds = np.clip(to_trace(np.concatenate([[win.t_start], starts,
                                              [win.t_end]])), lo, hi)
    share = np.diff(np.interp(bounds, xs, ys)) if len(xs) else \
        np.zeros(len(bounds) - 1)
    idle = {}
    for label, t in zip(["before the first round"] + labels, share):
        idle[label] = idle.get(label, 0.0) + float(t)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    out = {"busy_s": busy_s, "window_s": win.t_end - win.t_start,
           f"{kernel_name}_kernel_s": [b - a for a, b in launches],
           f"{kernel_name}_lost": lost,
           "device_ops": [[n[:80], s] for n, s in ops],
           "idle_gaps": [[f"host in {n}", s] for n, s in gaps]}
    for key, pat in (sums or {}).items():
        out[f"{key}_s"] = sum(min(b, hi) - max(a, lo) for n, a, b in events
                              if pat in n and b > lo and a < hi)
    return out
