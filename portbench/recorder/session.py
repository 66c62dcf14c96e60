"""An in-memory collaboration session over a plain deli: N merge-tree
clients make local edits, a queue holds their raw ops, and ``process``
tickets them in arrival order and delivers every sequenced message to
every client (a frozen copy of ``testing/mocks.py``'s
``MockCollabSession`` and of the deli ``ticket()`` semantics of
``service/sequencer.py``: contiguous client sequence numbers, refSeq
inside the collab window, msn = the least refSeq of the joined clients,
never regressing)."""
from __future__ import annotations

from .mergetree import MergeTreeClient
from .protocol import DocumentMessage, MessageType, SequencedMessage


class Deli:
    """One document's ticket authority. Joins take a seq and start the
    client's refSeq at the seq before the join."""

    def __init__(self):
        self.seq = 0
        self.msn = 0
        self.ref = {}   # client id -> refSeq
        self.csn = {}   # client id -> last client sequence number

    def _msn(self) -> int:
        low = min(self.ref.values()) if self.ref else self.seq
        self.msn = max(self.msn, low)
        return self.msn

    def join(self, client_id: str) -> SequencedMessage:
        self.seq += 1
        if client_id not in self.ref:
            self.ref[client_id] = self.seq - 1
            self.csn[client_id] = 0
        return SequencedMessage(None, self.seq, self._msn(), -1, -1,
                                MessageType.CLIENT_JOIN, client_id)

    def ticket(self, client_id: str, raw: DocumentMessage):
        """The sequenced message, or raises on any refusal (the recorder
        never makes one)."""
        csn, ref = raw.client_sequence_number, raw.reference_sequence_number
        if csn != self.csn[client_id] + 1:
            raise AssertionError(f"{client_id}: csn {csn} out of order")
        if not self.msn <= ref <= self.seq:
            raise AssertionError(f"{client_id}: refSeq {ref} outside "
                                 f"[{self.msn}, {self.seq}]")
        self.csn[client_id] = csn
        self.ref[client_id] = ref
        self.seq += 1
        return SequencedMessage(client_id, self.seq, self._msn(), csn, ref,
                                raw.type, raw.contents)


class Session:
    """``client_ids`` collaborating on one document; ``stream`` receives
    every sequenced message, joins included, in total order."""

    def __init__(self, client_ids: list):
        self.deli = Deli()
        self.clients = {}
        self.csn = {}
        self.last_seen = {}
        self.queue = []
        self.stream = []
        for cid in client_ids:
            client = MergeTreeClient(cid)
            client.start_collaboration(cid)
            self.clients[cid] = client
            self.csn[cid] = 0
            self.last_seen[cid] = 0
            self._broadcast(self.deli.join(cid))

    def do(self, client_id: str, method: str, *args) -> None:
        """A local edit on one client, queued for sequencing with the
        client's last seen seq as its refSeq."""
        op = getattr(self.clients[client_id], method)(*args)
        self.csn[client_id] += 1
        self.queue.append((client_id, DocumentMessage(
            self.csn[client_id], self.last_seen[client_id],
            MessageType.OPERATION, op)))

    def process(self, count: int) -> None:
        for _ in range(min(count, len(self.queue))):
            cid, raw = self.queue.pop(0)
            self._broadcast(self.deli.ticket(cid, raw))

    def _broadcast(self, msg: SequencedMessage) -> None:
        self.stream.append(msg)
        for cid, client in self.clients.items():
            self.last_seen[cid] = msg.sequence_number
            client.apply_msg(msg)

    def text(self) -> str:
        """The converged text; raises if two clients differ."""
        texts = {c.get_text() for c in self.clients.values()}
        if len(texts) != 1:
            raise AssertionError(f"clients diverged: {sorted(texts)}")
        return texts.pop()
