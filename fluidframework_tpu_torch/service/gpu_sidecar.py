"""GPU merge sidecar: device-resident merge state for the service plane.

The sidecar subscribes to sequenced channel streams, accumulates
per-document windows, applies them to a ``[max_docs, capacity]``
segment table on the GPU in one dispatch per round (the Hopper window
kernel, ``ops/cuda_merge.py``), and serves text and property
signatures.

DISPATCH PIPELINE: ``apply`` packs the queued ops on the host
(noop coalescing, ``pack_rows`` onto a ``BucketLadder`` window rung),
enqueues the window on the CUDA stream and returns; CUDA is
asynchronous, so the host can pack the next round while the device
computes. ``_settle`` is the only host<->device sync: one read of the
in-flight round's ``overflow`` flags, and recovery when one is set.

OVERFLOW RECOVERY: the kernel writes each round into a fresh table, so
the pre-dispatch table stays valid as a snapshot. A document that
outgrows its slab makes the sidecar REGROW (2x): pad the snapshot and
re-apply the same window — O(window). Past ``max_capacity`` the
document is EVICTED to a host-side scalar ``MergeTreeClient`` replica,
seeded by decoding its canonical encoded stream. A document that cannot
be expressed as tensors (a 33rd client, a 5th property key) is evicted
at ingest.

Scope: the scan semantics, the grow ladder and host eviction. The
chunked and egwalker executors and the pool tiers are not ported yet
(ROADMAP A6, A7) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..convert import batch_from_numpy
from ..models.mergetree import MergeTreeClient
from ..ops.bucket_ladder import BucketLadder
from ..ops.host_bridge import (
    DocStream,
    coalesce_noops,
    decode_stream,
    extract_signature,
    extract_text,
    fetch,
    interned_signature,
    pack_rows,
)
from ..ops.merge_kernel import apply_window, compact, pad_capacity
from ..ops.segment_table import KIND_NOOP, SegmentTable, make_table
from ..protocol.messages import MessageType, SequencedMessage


class GpuMergeSidecar:
    """Batched merge state for up to ``max_docs`` sequence channels.

    One tracked channel (doc slot) = one (document, datastore, channel)
    sequence stream. ``ingest`` consumes the document's sequenced
    envelope stream; ``apply`` flushes accumulated windows to the
    device in a single pipelined dispatch.

    ``device`` is ``"cuda"`` unless the caller asks for ``"cpu"`` (the
    tests do); with no GPU the default raises instead of running on the
    CPU.
    """

    def __init__(self, max_docs: int = 1024, capacity: int = 1024,
                 compact_every: int = 8, max_capacity: int = 16384,
                 seq_mesh=None, executor: Optional[str] = None,
                 pipeline: bool = True,
                 ladder: Optional[BucketLadder] = None,
                 device: torch.device | str = "cuda"):
        if executor not in (None, "scan"):
            raise NotImplementedError(
                f"executor={executor!r}: only the scan route is ported "
                "(chunked and egwalker are ROADMAP A6)")
        if seq_mesh is not None:
            raise NotImplementedError(
                "seq_mesh: the pool tiers are not ported (ROADMAP A7)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "GpuMergeSidecar needs a CUDA device; pass device='cpu' "
                "to run the plain version on the CPU")
        self.max_docs = max_docs
        self.capacity = capacity
        self.max_capacity = max_capacity
        self.pipeline = pipeline
        self.ladder = ladder or BucketLadder()
        self._table = make_table(max_docs, capacity, self.device)
        self._slots: dict[tuple[str, str, str], int] = {}
        self._doc_slots: dict[str, list[tuple[int, str, str]]] = {}
        # per-document last ingested seq (the at-least-once dedupe)
        self._last_ingested: dict[str, int] = {}
        # the encoded stream is the single canonical per-doc history:
        # eviction decodes it back into sequenced messages
        self._streams: list[DocStream] = []
        self._queued: list[list[dict]] = []
        # slot -> host oracle replica (evicted documents)
        self._host: dict[int, MergeTreeClient] = {}
        # pipeline state: the pre-dispatch snapshot and the window it
        # predates (regrow re-applies it), and whether the in-flight
        # round's overflow flag has been read yet
        self._prev_table: Optional[SegmentTable] = None
        self._last_arrays: Optional[dict] = None
        self._unsettled = False
        self._applies = 0
        self._compact_every = compact_every
        self.grow_count = 0
        self.evict_count = 0
        # host-pack seconds vs settle (device-wait) seconds per round
        self.stats = {"pack_s": 0.0, "settle_s": 0.0, "rounds": 0}

    # ------------------------------------------------------------------
    # registration + ingest

    def track(self, document_id: str, datastore_id: str,
              channel_id: str) -> int:
        key = (document_id, datastore_id, channel_id)
        if key in self._slots:
            return self._slots[key]
        if len(self._streams) >= self.max_docs:
            raise RuntimeError("sidecar document capacity exhausted")
        slot = len(self._streams)
        self._slots[key] = slot
        self._doc_slots.setdefault(document_id, []).append(
            (slot, datastore_id, channel_id)
        )
        self._streams.append(DocStream())
        self._queued.append([])
        return slot

    def subscribe(self, server, document_id: str, datastore_id: str,
                  channel_id: str) -> None:
        """Attach to a server document's broadcaster (after the
        sequencer, beside the storage writer)."""
        self.track(document_id, datastore_id, channel_id)
        orderer = server.get_orderer(document_id)
        orderer.broadcaster.subscribe(
            f"gpu-sidecar-{id(self)}/{document_id}/{datastore_id}/"
            f"{channel_id}",
            lambda msg: self.ingest(document_id, msg),
        )

    def ingest(self, document_id: str, msg: SequencedMessage) -> None:
        """Consume one sequenced message of a document: channel ops for
        tracked channels encode as kernel ops; everything else becomes
        a NOOP that still advances the collab window.

        A message at/below the document's last ingested sequence number
        is a duplicate delivery and is dropped (at-least-once
        upstream)."""
        last = self._last_ingested.get(document_id, 0)
        if msg.sequence_number <= last:
            return
        self._last_ingested[document_id] = msg.sequence_number
        for slot, ds_id, ch_id in self._doc_slots.get(document_id, ()):
            stream = self._streams[slot]
            envelope = msg.contents if isinstance(msg.contents, dict) else {}
            if (
                msg.type == MessageType.OPERATION
                and envelope.get("kind", "op") == "op"
                and envelope.get("address") == ds_id
                and envelope.get("channel") == ch_id
            ):
                inner = dataclasses.replace(
                    msg, contents=envelope["contents"]
                )
            else:
                inner = dataclasses.replace(
                    msg, type=MessageType.NO_OP, contents=None,
                    client_id=None,
                )
            if slot in self._host:
                self._host[slot].apply_msg(inner)
                continue
            before = len(stream.ops)
            before_payloads = len(stream.payloads)
            try:
                if inner.type == MessageType.OPERATION:
                    stream.add_message(inner)
                else:
                    stream.add_noop(inner.minimum_sequence_number)
            except ValueError:
                # inexpressible in tensor form: roll the partial encode
                # back so the canonical stream stays exact, then the
                # host replica takes over, seeded from the stream, plus
                # the message that failed
                del stream.ops[before:]
                del stream.payloads[before_payloads:]
                self._settle()
                self._evict(slot)
                self._host[slot].apply_msg(inner)
                continue
            self._queued[slot].extend(stream.ops[before:])

    # ------------------------------------------------------------------
    # device application (the dispatch pipeline)

    @property
    def queued_ops(self) -> int:
        return sum(len(q) for q in self._queued)

    def apply(self) -> int:
        """Flush all queued windows in one batched dispatch; returns the
        number of real (non-noop) ops applied. Returns at enqueue: this
        round's overflow flag is read (and recovery run) at the next
        apply or read, inside ``_settle`` — or before returning when
        ``pipeline`` is off."""
        if not self._queued or self.queued_ops == 0:
            return 0
        real = self._dispatch()
        self._applies += 1
        if self._applies % self._compact_every == 0:
            self._table = compact(self._table)
        if not self.pipeline:
            self._settle()
        return real

    def sync(self) -> None:
        """Barrier: settle the in-flight round (overflow recovery)."""
        self._settle()

    def prewarm(self) -> float:
        """Build and load the window kernel (nothing to do on the CPU);
        returns the seconds it took."""
        if self.device.type != "cuda":
            return 0.0
        from ..ops.cuda_merge import prewarm

        return prewarm()

    def _dispatch(self) -> int:
        t0 = time.perf_counter()
        # HOST HALF — runs while the device still computes the previous
        # round: coalesce noop runs (safe: the queue is consumed whole),
        # then pad the window to a ladder rung
        packed = [coalesce_noops(q) for q in self._queued]
        arrays = pack_rows(
            self.max_docs,
            {slot: ops for slot, ops in enumerate(packed) if ops},
            bucket_floor=self.ladder.window_floor,
        )
        real = sum(
            1 for ops in packed for op in ops if op["kind"] != KIND_NOOP
        )
        for queue in self._queued:
            queue.clear()
        self.stats["pack_s"] += time.perf_counter() - t0
        self.stats["rounds"] += 1
        # SYNC BOUNDARY — read the previous round's overflow flag before
        # its snapshot is retired
        self._settle()
        self._prev_table = self._table
        self._last_arrays = arrays
        self._unsettled = True
        self._table = apply_window(
            self._prev_table, batch_from_numpy(arrays, self.device))
        return real

    def _settle(self) -> None:
        """The host<->device sync boundary: read the in-flight round's
        overflow flags and run recovery if one is set. Reads and the
        next dispatch both funnel through here."""
        if not self._unsettled:
            return
        self._unsettled = False
        t0 = time.perf_counter()
        overflowed = bool(self._table.overflow.any())
        self.stats["settle_s"] += time.perf_counter() - t0
        if overflowed:
            self._recover()
        self._prev_table = None
        self._last_arrays = None

    # ------------------------------------------------------------------
    # overflow recovery: grow ladder, then host eviction

    def _recover(self) -> None:
        while True:
            overflowed = torch.nonzero(self._table.overflow).flatten()
            if overflowed.numel() == 0:
                return
            if self.capacity * 2 <= self.max_capacity:
                self._grow(self.capacity * 2)
            else:
                for slot in overflowed.tolist():
                    self._evict(slot)
                return

    def _grow(self, new_capacity: int) -> None:
        """Grow the slab 2x and retry the failed window: pad the
        pre-dispatch snapshot and re-apply the SAME window at the new
        capacity (the failed dispatch wrote a fresh table, so the
        snapshot is intact)."""
        self.grow_count += 1
        self.capacity = new_capacity
        self._prev_table = pad_capacity(self._prev_table, new_capacity)
        self._table = apply_window(
            self._prev_table,
            batch_from_numpy(self._last_arrays, self.device),
        )

    def _retire_rows(self, slots: list) -> None:
        """Zero the table's count/overflow of ``slots``: reads route to
        the host replica, and a stale overflow flag would re-trigger
        recovery."""
        if not slots:
            return
        idx = torch.tensor(slots, dtype=torch.long, device=self.device)
        count = self._table.count.clone()
        overflow = self._table.overflow.clone()
        count[idx] = 0
        overflow[idx] = 0
        self._table = self._table._replace(count=count, overflow=overflow)

    def _evict(self, slot: int) -> None:
        """Move one document to a host-side scalar oracle replica —
        full fidelity (arbitrary props, unbounded length), off the
        device batch path."""
        # retire the device row first, and even for an already-evicted
        # doc: a pipelined round packed before the eviction settled can
        # re-apply ops onto the retired row
        self._retire_rows([slot])
        if slot in self._host:
            return
        self.evict_count += 1
        host = MergeTreeClient(f"sidecar-host-{slot}")
        host.start_collaboration(f"sidecar-host-{slot}")
        self._host[slot] = host
        self._queued[slot].clear()
        for msg in decode_stream(self._streams[slot]):
            host.apply_msg(msg)

    # ------------------------------------------------------------------
    # reads

    def _row(self, slot: int) -> dict:
        """One document's row of the table on the host (as a one-doc
        table: read it at doc 0)."""
        return fetch(SegmentTable(*(t[slot:slot + 1] for t in self._table)))

    def text(self, document_id: str, datastore_id: str,
             channel_id: str) -> str:
        self._settle()
        slot = self._slots[(document_id, datastore_id, channel_id)]
        if slot in self._host:
            return self._host[slot].get_text()
        return extract_text(self._row(slot), self._streams[slot], 0)

    def signature(self, document_id: str, datastore_id: str,
                  channel_id: str) -> tuple:
        self._settle()
        slot = self._slots[(document_id, datastore_id, channel_id)]
        if slot in self._host:
            return interned_signature(self._host[slot], self._streams[slot])
        return extract_signature(self._row(slot), self._streams[slot], 0)

    def host_mode_docs(self) -> int:
        return len(self._host)

    def overflowed(self) -> bool:
        """True only if a document is CURRENTLY wrong (should never
        happen: recovery runs inside the settle boundary)."""
        self._settle()
        return bool(self._table.overflow.any())
