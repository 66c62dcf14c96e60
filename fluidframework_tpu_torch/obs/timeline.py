"""FleetTimeline — the causally-ordered cross-node event log.

A copy of the reference's ``obs/timeline.py``, trimmed to what the port
uses: every node-level lifecycle event is recorded as one
:class:`TimelineEvent` with a monotonically increasing sequence number,
so an incident reads as ONE causally-ordered timeline. In the port the
mesh pool records its live migrations here (``MeshShardedPool(timeline=
...)``); the lease, epoch and failover kinds belong to the replicated
plane, a later layer of the port, and stay in the vocabulary so it is
the reference's.

Determinism contract: the timeline is clock-injectable; under a step
clock a seeded run records a bit-identical event sequence, and
``deterministic_events()`` is that sequence (everything wall-clock or
unhashable excluded by construction). Causal order is the record
order: the ``seq`` assigned at record time — timestamps may tie, seq
never does.

The kind vocabulary is a PURE LITERAL (the CANONICAL_HOPS idiom):
``timeline_events_total{kind}`` stays bounded by code, and an unknown
kind fails loudly at the record site.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from . import metrics as obs_metrics

# kind -> what the event means. A pure literal on purpose (the
# CANONICAL_HOPS contract): the metric label vocabulary is bounded by
# this table, never by data.
TIMELINE_KINDS = {
    "leader_kill": "host loss: the leader process is gone",
    "lease_grant": "a node acquired the leadership lease",
    "lease_renew": "the holder renewed its lease on the heartbeat",
    "lease_expire": "the lease lapsed (faulted, forced, or observed)",
    "epoch_advance": "the epoch fence minted a new leadership term",
    "fenced_write": "a deposed writer was refused by the epoch fence",
    "anti_entropy": "a promotion candidate pulled a missing suffix",
    "promotion": "a follower was promoted into the leader role",
    "migration": "the mesh pool moved a hot document between shards",
    "first_ack": "first client ack through the new leader",
    # partition tolerance (the replicated plane's netsplits)
    "partition": "the network split into reachability islands",
    "heal": "a partition's links came back",
    "degraded_enter": "quorum/lease unprovable: writes refuse with "
                      "retriable unavailable nacks (read-only "
                      "brownout at the committed watermark)",
    "degraded_exit": "quorum/lease provable again: acks resumed",
    "membership": "the quorum membership shrank (grace TTL) or grew "
                  "back (rejoin)",
    "rejoin": "a crashed/wiped follower rejoined via full "
              "anti-entropy resync behind the epoch fence",
    "scrub_repair": "the scrubber read-repaired a bit-rotted record "
                    "from a quorum peer",
}


@dataclass(frozen=True)
class TimelineEvent:
    """One cross-node event. ``seq`` is the causal position (assigned
    at record time, strictly increasing); ``t`` is the injected-clock
    timestamp (ties are legal — seq breaks them)."""

    seq: int
    t: float
    node: str
    kind: str
    fields: dict = field(default_factory=dict)


class FleetTimeline:
    """Bounded, clock-injectable fleet event log.

    ``record()`` validates the kind against :data:`TIMELINE_KINDS`,
    assigns the next causal seq, stamps the injected clock and counts
    ``timeline_events_total{kind}`` on the injected registry (default:
    the process-wide one). ``capacity`` bounds retention the flight-
    recorder way — a timeline left running for days must not grow
    without bound."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 capacity: int = 65536):
        self.clock = clock or time.time
        self.capacity = capacity
        # bounded ring with O(1) eviction (the slo sample-ring idiom)
        self._events: deque[TimelineEvent] = deque(maxlen=capacity)
        self._seq = 0
        self._c_events = (registry or obs_metrics.REGISTRY).counter(
            "timeline_events_total",
            "fleet timeline events recorded, by kind",
            labelnames=("kind",))

    def record(self, kind: str, node: str = "", **fields
               ) -> TimelineEvent:
        if kind not in TIMELINE_KINDS:
            raise ValueError(
                f"unknown timeline event kind {kind!r}; register it "
                "in fluidframework_tpu_torch/obs/timeline.py TIMELINE_KINDS"
            )
        self._seq += 1
        event = TimelineEvent(
            seq=self._seq, t=self.clock(), node=node, kind=kind,
            fields=fields,
        )
        self._events.append(event)  # deque drops the oldest at cap
        self._c_events.labels(kind=kind).inc()
        return event

    # -- reads ----------------------------------------------------------

    def events(self, kind: Optional[str] = None) -> list[TimelineEvent]:
        if kind is None:
            return list(self._events)
        return [e for e in self._events if e.kind == kind]

    def __len__(self) -> int:
        return len(self._events)

    def deterministic_events(self) -> list[tuple]:
        """The event sequence as plain comparable tuples —
        ``(seq, t, node, kind, sorted scalar fields)``. Everything
        here rides the injected clock, so two same-seed runs must
        produce bit-identical lists."""
        out = []
        for e in self._events:
            fields = tuple(sorted(
                (k, v) for k, v in e.fields.items()
                if isinstance(v, (int, float, str, bool))
            ))
            out.append((e.seq, round(e.t, 9), e.node, e.kind, fields))
        return out
