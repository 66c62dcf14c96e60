"""In-memory collaboration session: the mock sequencer harness.

Reference: packages/runtime/test-runtime-utils/src/mocks.ts —
``MockContainerRuntimeFactory`` (:196) is an in-memory deli that stamps
seq/msn and fans sequenced ops out to every registered runtime; the
pattern for every DDS test is: create 2-3 clients, interleave local
ops, ``processAllMessages()``, assert convergence.

Here the *real* ``DocumentSequencer`` plays deli (so msn semantics are
the production ones), and clients are merge-tree clients or any object
with ``apply_msg(SequencedMessage)``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..models.mergetree import MergeTreeClient
from ..protocol.messages import (
    ClientDetail,
    DocumentMessage,
    MessageType,
    SequencedMessage,
)
from ..service.sequencer import DocumentSequencer


@dataclass
class _Endpoint:
    client: MergeTreeClient
    csn: int = 0                 # last client sequence number used
    last_seen_seq: int = 0       # DeltaManager.lastSequenceNumber analogue
    connected: bool = True
    missed: list[SequencedMessage] = field(default_factory=list)


class MockCollabSession:
    """N collaborating merge-tree clients over a real sequencer.

    ``stream_log``, when given, receives every sequenced message
    (including joins) — the recorded total order used for differential
    testing of the batched kernel.
    """

    def __init__(self, client_ids: list[str], document_id: str = "doc",
                 stream_log: list[SequencedMessage] | None = None):
        self.sequencer = DocumentSequencer(document_id)
        self.endpoints: dict[str, _Endpoint] = {}
        self._raw_queue: list[tuple[str, DocumentMessage]] = []
        self.stream_log = stream_log
        for cid in client_ids:
            client = MergeTreeClient(cid)
            client.start_collaboration(cid)
            self.endpoints[cid] = _Endpoint(client=client)
            join = self.sequencer.client_join(ClientDetail(cid))
            self._broadcast(join)

    # ------------------------------------------------------------------

    def client(self, client_id: str) -> MergeTreeClient:
        return self.endpoints[client_id].client

    def submit(self, client_id: str, op) -> None:
        """Queue a local op for sequencing; refSeq is the client's last
        *seen* seq at submit time (deltaManager.ts submit :213)."""
        ep = self.endpoints[client_id]
        if not ep.connected:
            # Offline: the local op stays pending; it will be
            # regenerated and resubmitted on reconnect (§3.5).
            return
        ep.csn += 1
        msg = DocumentMessage(
            client_sequence_number=ep.csn,
            reference_sequence_number=ep.last_seen_seq,
            type=MessageType.OPERATION,
            contents=op,
        )
        self._raw_queue.append((client_id, msg))

    def do(self, client_id: str, method: str, *args, **kwargs):
        """Perform a local DDS op AND queue it: e.g.
        ``session.do('A', 'insert_text_local', 0, 'hi')``."""
        op = getattr(self.client(client_id), method)(*args, **kwargs)
        self.submit(client_id, op)
        return op

    # ------------------------------------------------------------------

    @property
    def pending_count(self) -> int:
        return len(self._raw_queue)

    def process_some(self, count: int) -> int:
        """Sequence + broadcast up to ``count`` queued raw ops."""
        done = 0
        while self._raw_queue and done < count:
            client_id, raw = self._raw_queue.pop(0)
            result = self.sequencer.ticket(client_id, raw)
            if result.nack is not None:
                raise AssertionError(
                    f"unexpected nack for {client_id}: {result.nack.message}"
                )
            if result.message is not None:
                self._broadcast(result.message)
            done += 1
        return done

    def process_all(self) -> int:
        return self.process_some(len(self._raw_queue))

    def _broadcast(self, msg: SequencedMessage) -> None:
        if self.stream_log is not None:
            self.stream_log.append(msg)
        for ep in self.endpoints.values():
            if not ep.connected:
                ep.missed.append(msg)
                continue
            ep.last_seen_seq = msg.sequence_number
            # Full stream, including system messages: apply_msg advances
            # the collab window on non-ops, matching the kernel's
            # min-seq-advancing NOOP encoding (ops/host_bridge.py).
            ep.client.apply_msg(msg)

    # ------------------------------------------------------------------
    # reconnect (mocksForReconnection.ts:19,104 + §3.5)

    def disconnect(self, client_id: str) -> None:
        """Drop the connection: un-ticketed raw ops from this client are
        lost (they stay pending client-side), sequenced traffic is
        buffered for catch-up, and the service sees a leave."""
        ep = self.endpoints[client_id]
        assert ep.connected, "already disconnected"
        ep.connected = False
        self._raw_queue = [
            (cid, raw) for cid, raw in self._raw_queue if cid != client_id
        ]
        leave = self.sequencer.client_leave(client_id)
        if leave is not None:
            self._broadcast(leave)

    def reconnect(self, client_id: str) -> None:
        """Catch up on missed sequenced ops (own ones ack pending
        groups), rejoin, then regenerate + resubmit surviving pending
        ops (replayPendingStates -> reSubmitCore, §3.5).

        Note: unlike the reference we rejoin under the same client id;
        new-id re-attribution of pending segments is future work."""
        ep = self.endpoints[client_id]
        assert not ep.connected, "not disconnected"
        for msg in ep.missed:
            ep.last_seen_seq = msg.sequence_number
            ep.client.apply_msg(msg)
        ep.missed.clear()
        ep.connected = True
        join = self.sequencer.client_join(ClientDetail(client_id))
        self._broadcast(join)
        ep.csn = 0
        for op in ep.client.regenerate_pending_ops():
            self.submit(client_id, op)

    # ------------------------------------------------------------------

    @staticmethod
    def signature(client: MergeTreeClient) -> tuple:
        """Canonical visible-content signature: per-position content
        plus properties plus marker identity — so annotate/marker
        divergence is caught, not just text."""
        out = []
        tree = client.mergetree
        refseq = tree.collab.current_seq
        viewer = tree.collab.client_id
        for seg in tree.segments:
            length = tree._length_at(seg, refseq, viewer)
            if not length:
                continue
            props = tuple(sorted((seg.props or {}).items()))
            if seg.is_marker:
                out.append(("M", seg.marker["refType"], props))
            else:
                out.extend((ch, props) for ch in seg.text)
        return tuple(out)

    def assert_converged(self) -> str:
        """All clients see identical content (text + props + markers);
        returns the text."""
        assert not self._raw_queue, "unprocessed ops remain"
        sigs = {
            cid: self.signature(ep.client)
            for cid, ep in self.endpoints.items()
        }
        values = set(sigs.values())
        assert len(values) == 1, (
            "divergence: "
            + str({c: ep.client.get_text()
                   for c, ep in self.endpoints.items()})
            + f" sigs differ: {sigs}"
        )
        texts = {ep.client.get_text() for ep in self.endpoints.values()}
        assert len(texts) == 1
        return texts.pop()
