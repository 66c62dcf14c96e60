"""Summarizer subsystem: election, heuristics, ack tracking.

Reference: packages/runtime/container-runtime/src —
- ``OrderedClientElection`` (orderedClientElection.ts:262, collection
  :77) + ``summarizerClientElection.ts:161``: the oldest eligible
  (write-mode) client is the elected summarizer; election advances
  when it leaves.
- ``SummaryManager`` (summaryManager.ts:72): per-client observer that
  runs a summarizer when its own client wins the election. (The
  reference spawns a hidden second container for isolation; in-proc we
  run against the live container — same protocol traffic.)
- ``RunningSummarizer`` (runningSummarizer.ts:53) with heuristics
  (summarizerHeuristics.ts): summarize after N ops or T seconds,
  only when quiescent; retry on nack.
- ``SummaryCollection`` (summaryCollection.ts:206): watches
  summarize/ack/nack traffic for everyone.
"""
from __future__ import annotations

import time
from typing import TYPE_CHECKING, Optional

from ..protocol.messages import MessageType, SequencedMessage
from ..utils.events import EventEmitter

if TYPE_CHECKING:  # pragma: no cover
    from ..loader.container import Container


class OrderedClientElection(EventEmitter):
    """orderedClientElection.ts:262 — eligible clients in join order;
    the head is elected."""

    def __init__(self) -> None:
        super().__init__()
        self._clients: list[str] = []  # eligible, join order

    @property
    def elected(self) -> Optional[str]:
        return self._clients[0] if self._clients else None

    @property
    def eligible(self) -> tuple[str, ...]:
        return tuple(self._clients)

    def add_client(self, client_id: str, eligible: bool = True) -> None:
        if not eligible or client_id in self._clients:
            return
        was = self.elected
        self._clients.append(client_id)
        if self.elected != was:
            self.emit("electedChange", self.elected)

    def remove_client(self, client_id: str) -> None:
        if client_id not in self._clients:
            return
        was = self.elected
        self._clients.remove(client_id)
        if self.elected != was:
            self.emit("electedChange", self.elected)


class SummaryCollection(EventEmitter):
    """summaryCollection.ts:206 — everyone's view of summary traffic."""

    def __init__(self) -> None:
        super().__init__()
        self.last_ack: Optional[dict] = None     # {proposal, handle}
        self.pending_proposals: dict[int, dict] = {}

    @property
    def last_ack_seq(self) -> int:
        return self.last_ack["summaryProposal"] if self.last_ack else 0

    def process(self, msg: SequencedMessage) -> None:
        if msg.type == MessageType.SUMMARIZE:
            self.pending_proposals[msg.sequence_number] = (
                msg.contents or {}
            )
            self.emit("summarize", msg.sequence_number)
        elif msg.type == MessageType.SUMMARY_ACK:
            ack = msg.contents or {}
            self.pending_proposals.pop(ack.get("summaryProposal"), None)
            self.last_ack = ack
            self.emit("summaryAck", ack)
        elif msg.type == MessageType.SUMMARY_NACK:
            nack = msg.contents or {}
            self.pending_proposals.pop(nack.get("summaryProposal"), None)
            self.emit("summaryNack", nack)


class SummarizerHeuristics:
    """summarizerHeuristics.ts — summarize after ``max_ops`` ops or
    ``max_time_s`` seconds since the last acked summary."""

    def __init__(self, max_ops: int = 100,
                 max_time_s: Optional[float] = None,
                 clock=time.monotonic):
        self.max_ops = max_ops
        self.max_time_s = max_time_s
        self._clock = clock
        self.ops_since_summary = 0
        self._last_summary_time = clock()

    def record_op(self) -> None:
        self.ops_since_summary += 1

    def record_summary(self) -> None:
        self.ops_since_summary = 0
        self._last_summary_time = self._clock()

    def should_summarize(self) -> bool:
        if self.ops_since_summary >= self.max_ops:
            return True
        return (
            self.max_time_s is not None
            and self.ops_since_summary > 0
            and self._clock() - self._last_summary_time >= self.max_time_s
        )


class RunningSummarizer(EventEmitter):
    """runningSummarizer.ts:53 — drives summaries on one (elected)
    client: heuristics decide when; a summary is only attempted while
    quiescent (no local pending ops) and while no prior attempt is
    outstanding; nacks retry on the next op."""

    def __init__(self, container: "Container",
                 heuristics: Optional[SummarizerHeuristics] = None):
        super().__init__()
        self.container = container
        self.heuristics = heuristics or SummarizerHeuristics()
        self.attempt_pending = False
        self._attempt_proposal: Optional[int] = None
        self.summaries_produced = 0
        # sticky auth failure: the upload plane rejected our token for
        # write scope — retrying every tick cannot succeed, and
        # re-raising would unwind into the driver's dispatch pump and
        # kill delta processing for every document on the connection
        self.auth_failed = False

    def on_op(self, msg: SequencedMessage) -> None:
        if msg.type == MessageType.SUMMARIZE:
            if (self.attempt_pending and self._attempt_proposal is None
                    and msg.client_id == self.container.client_id):
                # our in-flight attempt got its proposal number
                self._attempt_proposal = msg.sequence_number
            return
        if msg.type == MessageType.SUMMARY_ACK:
            ack = msg.contents or {}
            # ANY acked summary refreshes the document's summary state
            self.heuristics.record_summary()
            if (self._attempt_proposal is not None
                    and ack.get("summaryProposal")
                    == self._attempt_proposal):
                self.attempt_pending = False
                self._attempt_proposal = None
                self.summaries_produced += 1
                self.emit("summarized", ack)
            return
        if msg.type == MessageType.SUMMARY_NACK:
            nack = msg.contents or {}
            if (self._attempt_proposal is not None
                    and nack.get("summaryProposal")
                    == self._attempt_proposal):
                self.attempt_pending = False  # retry on a later tick
                self._attempt_proposal = None
            return
        if msg.type == MessageType.OPERATION:
            self.heuristics.record_op()
        self.maybe_summarize()

    def tick(self) -> None:
        """Re-evaluate outside the op stream: hosts call this
        periodically so the time heuristic (and attempts deferred
        while dirty) fire on quiet documents — the in-proc stand-in
        for the reference's summarizer timers."""
        self.maybe_summarize()

    def maybe_summarize(self) -> None:
        if self.auth_failed or self.attempt_pending \
                or not self.heuristics.should_summarize():
            return
        if self.container.runtime.is_dirty or not self.container.connected:
            return  # wait for quiescence (summarize requires it)
        self.attempt_pending = True
        try:
            self.container.summarize()
        except PermissionError as e:
            # surfaced by Container.summarize (ADVICE r4) — on the
            # AUTO path there is no caller to catch it: record it
            # loudly, stop attempting (sticky until re-election /
            # reconnect builds a new summarizer), keep the pump alive
            self.attempt_pending = False
            self.auth_failed = True
            self.container.mc.logger.send_error_event(
                "summarizeAuthFailed", error=e,
            )
            self.emit("authFailed", e)
        except Exception:
            # no proposal was submitted, so no ack/nack will ever
            # clear the flag — reset it or summaries stop forever
            self.attempt_pending = False
            raise


class SummaryManager(EventEmitter):
    """summaryManager.ts:72 — each client runs one of these; the one
    whose client wins the election drives summaries."""

    def __init__(self, container: "Container",
                 heuristics_factory=SummarizerHeuristics):
        super().__init__()
        self.container = container
        self.election = OrderedClientElection()
        self.collection = SummaryCollection()
        self._heuristics_factory = heuristics_factory
        self.running: Optional[RunningSummarizer] = None
        # seed from the quorum: members who joined before this manager
        # existed (catch-up processed their joins already); dict order
        # is join order
        for cid, detail in container.protocol.quorum.members.items():
            self.election.add_client(cid, eligible=detail.mode == "write")
        self._reconcile_role()
        self._off = container.on("processed", self._on_processed)
        self.disposed = False

    def dispose(self) -> None:
        """Detach from the container (the reference SummaryManager is
        IDisposable); safe to call repeatedly."""
        if not self.disposed:
            self._off()
            self.running = None
            self.disposed = True

    def tick(self) -> None:
        """Periodic re-evaluation for time-based heuristics and
        deferred attempts (see RunningSummarizer.tick)."""
        if self.running is not None:
            self.running.tick()

    @property
    def is_summarizer(self) -> bool:
        return self.running is not None

    def _on_processed(self, msg: SequencedMessage) -> None:
        if msg.type == MessageType.CLIENT_JOIN:
            detail = msg.contents
            self.election.add_client(
                detail.client_id, eligible=detail.mode == "write"
            )
        elif msg.type == MessageType.CLIENT_LEAVE:
            self.election.remove_client(msg.contents)
        self.collection.process(msg)
        self._reconcile_role()
        if self.running is not None:
            self.running.on_op(msg)

    def _reconcile_role(self) -> None:
        elected_us = self.election.elected == self.container.client_id
        if elected_us and self.running is None:
            self.running = RunningSummarizer(
                self.container, self._heuristics_factory()
            )
            self.emit("summarizerStart")
        elif not elected_us and self.running is not None:
            self.running = None
            self.emit("summarizerStop")
