"""Container-level mock session: full runtime stacks over the real
sequencer.

The container analogue of ``MockCollabSession``: each client is a
complete ``ContainerRuntime`` (datastores, channels, outbox, pending
state), mirroring the reference's ``MockContainerRuntime``
(test-runtime-utils/src/mocks.ts:109) + reconnection variant
(mocksForReconnection.ts:19).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..models import default_registry
from ..protocol.messages import (
    ClientDetail,
    DocumentMessage,
    MessageType,
    SequencedMessage,
)
from ..runtime import ChannelRegistry, ContainerRuntime
from ..service.sequencer import DocumentSequencer


@dataclass
class _Endpoint:
    runtime: ContainerRuntime
    csn: int = 0
    last_seen_seq: int = 0
    connected: bool = True
    missed: list[SequencedMessage] = field(default_factory=list)


class ContainerSession:
    def __init__(self, client_ids: list[str],
                 registry: Optional[ChannelRegistry] = None,
                 document_id: str = "doc"):
        self.sequencer = DocumentSequencer(document_id)
        self.endpoints: dict[str, _Endpoint] = {}
        self._raw_queue: list[tuple[str, DocumentMessage]] = []
        for cid in client_ids:
            runtime = ContainerRuntime(registry or default_registry())
            runtime.set_submit_fn(
                lambda contents, metadata, cid=cid:
                self._enqueue(cid, contents, metadata)
            )
            runtime.set_connection_state(True, cid)
            self.endpoints[cid] = _Endpoint(runtime=runtime)
            self._broadcast(self.sequencer.client_join(ClientDetail(cid)))

    # ------------------------------------------------------------------

    def runtime(self, client_id: str) -> ContainerRuntime:
        return self.endpoints[client_id].runtime

    def _enqueue(self, client_id: str, contents: Any,
                 metadata: Any = None) -> None:
        ep = self.endpoints[client_id]
        if not ep.connected:
            return  # offline; pending state replays on reconnect
        ep.csn += 1
        self._raw_queue.append((client_id, DocumentMessage(
            client_sequence_number=ep.csn,
            reference_sequence_number=ep.last_seen_seq,
            type=MessageType.OPERATION,
            contents=contents,
            metadata=metadata,
        )))

    # ------------------------------------------------------------------

    @property
    def pending_count(self) -> int:
        return len(self._raw_queue)

    def flush(self, client_id: Optional[str] = None) -> None:
        """Flush one (or every) runtime's outbox into the raw queue."""
        targets = [client_id] if client_id else list(self.endpoints)
        for cid in targets:
            self.endpoints[cid].runtime.flush()

    def process_some(self, count: int) -> int:
        done = 0
        while self._raw_queue and done < count:
            client_id, raw = self._raw_queue.pop(0)
            result = self.sequencer.ticket(client_id, raw)
            if result.nack is not None:
                raise AssertionError(
                    f"unexpected nack for {client_id}: "
                    f"{result.nack.message}"
                )
            if result.message is not None:
                self._broadcast(result.message)
            done += 1
        return done

    def process_all(self) -> int:
        self.flush()
        total = 0
        while self._raw_queue:
            total += self.process_some(len(self._raw_queue))
            self.flush()
        return total

    def _broadcast(self, msg: SequencedMessage) -> None:
        for ep in self.endpoints.values():
            if not ep.connected:
                ep.missed.append(msg)
                continue
            # An op's refSeq must reflect the view it was created
            # against: flush the outbox before advancing the endpoint's
            # view (the reference gets this from JS turn boundaries —
            # ops flush at turn end, inbound processes in later turns).
            ep.runtime.flush()
            ep.last_seen_seq = msg.sequence_number
            if msg.type == MessageType.OPERATION:
                ep.runtime.process(msg)
            else:
                ep.runtime.observe_system(msg)

    # ------------------------------------------------------------------
    # reconnect

    def disconnect(self, client_id: str) -> None:
        ep = self.endpoints[client_id]
        assert ep.connected
        # Outbox ops enter pending state (they'll be dropped from the
        # raw queue below, and replayed on reconnect).
        ep.runtime.flush()
        ep.connected = False
        ep.runtime.set_connection_state(False)
        self._raw_queue = [
            (cid, raw) for cid, raw in self._raw_queue if cid != client_id
        ]
        leave = self.sequencer.client_leave(client_id)
        if leave is not None:
            self._broadcast(leave)

    def reconnect(self, client_id: str) -> None:
        ep = self.endpoints[client_id]
        assert not ep.connected
        # Offline edits still in the outbox must enter pending state
        # while disconnected (enqueue drops them), so the replay below
        # resubmits everything exactly once.
        ep.runtime.flush()
        # catch-up (own buffered acks process as local)
        for msg in ep.missed:
            ep.last_seen_seq = msg.sequence_number
            if msg.type == MessageType.OPERATION:
                ep.runtime.process(msg)
            else:
                ep.runtime.observe_system(msg)
        ep.missed.clear()
        ep.connected = True
        ep.csn = 0  # the service forgot us on leave; csn restarts at 1
        self._broadcast(self.sequencer.client_join(ClientDetail(client_id)))
        # triggers replayPendingStates -> channel resubmit_core
        ep.runtime.set_connection_state(True, client_id)

    # ------------------------------------------------------------------

    def assert_converged(self) -> None:
        """Every channel's content signature must match across all
        runtimes."""
        self.flush()
        assert not self._raw_queue, "unprocessed ops remain"
        sigs = {}
        for cid, ep in self.endpoints.items():
            assert not ep.runtime.is_dirty, f"{cid} still dirty"
            sigs[cid] = {
                (ds_id, ch_id): ch.signature()
                for ds_id, ds in ep.runtime.datastores.items()
                for ch_id, ch in ds.channels.items()
            }
        baseline_cid = next(iter(sigs))
        baseline = sigs[baseline_cid]
        for cid, sig in sigs.items():
            assert sig == baseline, (
                f"divergence between {baseline_cid} and {cid}:\n"
                f"{baseline}\nvs\n{sig}"
            )
