"""Networked ordering broker — the rdkafka tier of the scale-out path.

Reference: server/routerlicious/packages/services-ordering-rdkafka/
src/rdkafkaConsumer.ts:37 / rdkafkaProducer.ts:52 — the reference's
partitions live on a NETWORKED broker so consumer hosts scale out
independently of producers. The in-process ``OrderingQueue`` seam has
in-memory and local-file implementations, so ``--partitions N`` alone
cannot span hosts.

This module closes that: a framed-TCP ``BrokerServer`` owns the
durable partition logs (backed by ``FileOrderingQueue``, so broker
restarts preserve offsets and records), and ``RemoteOrderingQueue``
implements the exact ``OrderingQueue`` interface over the wire —
``Partition``/``CheckpointManager``/``PartitionedServer`` plug in
unchanged. Semantics match the reference's consumer contract:

- ordered, offset-addressed records per partition;
- AT-LEAST-ONCE delivery: consumers re-read from the committed offset
  after a crash (commit is monotonic server-side; deli's
  clientSequenceNumber dedupe drops the replayed duplicates);
- committed offsets are durable on the broker, so a consumer host can
  die and a replacement resumes exactly at the checkpoint.

The wire protocol reuses the ingress framing (4-byte length + JSON).
Request/response only — no server push — so the client is a small
blocking socket with no receive pump. Reads return bounded batches
(the consumer pump polls, like a Kafka poll loop).
"""
from __future__ import annotations

import asyncio
import json
import socket
import threading
from typing import Iterator, Optional

from ..obs import metrics as obs_metrics
from .ingress import pack_frame, read_frame, recv_frame_blocking
from .partitioning import (
    FileOrderingQueue,
    InMemoryOrderingQueue,
    OrderingQueue,
    QueueRecord,
)

_PRODUCED = obs_metrics.REGISTRY.counter(
    "broker_records_produced_total", "records appended to partitions")
_READ = obs_metrics.REGISTRY.counter(
    "broker_records_read_total", "records served to consumers")
_COMMITS = obs_metrics.REGISTRY.counter(
    "broker_commits_total", "consumer offset commits")
_BROKER_ERRORS = obs_metrics.REGISTRY.counter(
    "broker_frame_errors_total", "broker frames that raised")
_BROKER_LAG = obs_metrics.REGISTRY.gauge(
    "broker_fanout_lag",
    "produced-but-uncommitted records across partitions at last "
    "sample (the qos backpressure signal)")


class BrokerServer:
    """Framed-TCP broker owning the partition logs."""

    def __init__(self, n_partitions: int,
                 data_dir: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.queue: OrderingQueue = (
            FileOrderingQueue(data_dir, n_partitions)
            if data_dir is not None
            else InMemoryOrderingQueue(n_partitions)
        )
        self.n_partitions = n_partitions
        self.host = host
        self.port = port
        # _dispatch runs on executor threads — the durable
        # FileOrderingQueue appends/commits are disk writes, which
        # must never run on the event loop (the same
        # async-blocking-call shape concheck pinned in moira; here
        # the I/O hides behind the queue seam, out of static
        # resolution's reach, so this fix is belt-and-suspenders).
        # The lock serializes queue access across connections exactly
        # as the loop used to.
        self._state_lock = threading.Lock()
        self._server: Optional[asyncio.base_events.Server] = None
        # dict-as-ordered-set: connection order is deterministic per
        # run, so shutdown fan-out (and any future broadcast) walks a
        # stable order — a plain set iterates per-process
        # (PYTHONHASHSEED), the detcheck iteration-order-leak hazard
        self._writers: dict[asyncio.StreamWriter, None] = {}

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # abort live client connections or wait_closed() blocks on
            # their handler coroutines (clients poll long-lived)
            for w in list(self._writers):
                try:
                    w.close()
                except Exception:  # pragma: no cover - already gone
                    pass
            await self._server.wait_closed()
            self._server = None

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._writers[writer] = None
        loop = asyncio.get_running_loop()
        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                try:
                    resp = await loop.run_in_executor(
                        None, self._dispatch_locked, frame)
                except Exception as e:  # noqa: BLE001 - report per frame
                    _BROKER_ERRORS.inc()
                    resp = {
                        "type": "error",
                        "message": f"{type(e).__name__}: {e}",
                    }
                resp["rid"] = frame.get("rid")
                writer.write(pack_frame(resp))
                await writer.drain()
        finally:
            self._writers.pop(writer, None)
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError,
                    RuntimeError):
                pass  # loop shutting down mid-close is fine

    def _dispatch_locked(self, frame: dict) -> dict:
        with self._state_lock:
            return self._dispatch(frame)

    def _dispatch(self, frame: dict) -> dict:
        kind = frame.get("type")
        p = int(frame.get("partition", -1))
        if not 0 <= p < self.n_partitions and \
                kind not in ("meta", "lag"):
            raise ValueError(f"partition {p} out of range")
        if kind == "produce":
            offset = self.queue.produce(
                p, frame["document_id"], frame["payload"]
            )
            _PRODUCED.inc()
            return {"type": "produced", "offset": offset}
        if kind == "read":
            limit = int(frame.get("max", 500))
            out = []
            for rec in self.queue.read(p, int(frame["from_offset"])):
                out.append({
                    "offset": rec.offset,
                    "document_id": rec.document_id,
                    "payload": rec.payload,
                })
                if len(out) >= limit:
                    break
            _READ.inc(len(out))
            return {"type": "records", "records": out}
        if kind == "committed":
            return {"type": "committed_offset",
                    "offset": self.queue.committed(p)}
        if kind == "commit":
            self.queue.commit(p, int(frame["offset"]))
            _COMMITS.inc()
            return {"type": "commit_ack"}
        if kind == "meta":
            return {"type": "meta",
                    "n_partitions": self.n_partitions}
        if kind == "lag":
            # consumer-lag probe (the qos 'broker_fanout' pressure
            # source): cheap server-side arithmetic, no log reads
            lag = self.fanout_lag()
            return {"type": "lag", "lag": lag}
        raise ValueError(f"unknown broker frame {kind!r}")

    def fanout_lag(self) -> int:
        """Produced-but-uncommitted records across all partitions."""
        lag = self.queue.fanout_lag()
        _BROKER_LAG.set(lag)
        return lag


class RemoteOrderingQueue(OrderingQueue):
    """OrderingQueue over a BrokerServer connection. Strictly
    request/response, so one blocking socket + a lock suffices; the
    connection re-establishes transparently after a broker restart
    (offsets are durable broker-side)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        meta = self._request({"type": "meta"})
        self.n_partitions = meta["n_partitions"]

    # -- transport -----------------------------------------------------

    def _connect(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout
            )
        return self._sock

    def _request(self, data: dict) -> dict:
        with self._lock:
            for attempt in (0, 1):
                try:
                    sock = self._connect()
                    sock.sendall(pack_frame(data))
                    frame = recv_frame_blocking(sock)
                    break
                except (OSError, ConnectionError):
                    # broker restarted: drop the socket and retry once
                    self._close_sock()
                    if attempt:
                        raise
                except Exception:
                    # protocol fault (oversized/corrupt length prefix
                    # -> ValueError, garbage body -> JSONDecodeError):
                    # the stream position is desynced — the socket
                    # must never be reused, and retrying would parse
                    # mid-frame garbage as a fresh frame
                    self._close_sock()
                    raise
            if frame.get("type") == "error":
                raise RuntimeError(frame.get("message", "broker error"))
            return frame

    def _close_sock(self) -> None:
        # caller holds _lock: _sock is lock-guarded (the retry path
        # in _request swaps it under the same lock)
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        # take the lock: closing concurrently with an in-flight
        # _request must not yank the socket mid-recv (waits for the
        # request to finish instead)
        with self._lock:
            self._close_sock()

    # -- OrderingQueue surface ----------------------------------------

    def produce(self, partition: int, document_id: str,
                payload: dict) -> int:
        return self._request({
            "type": "produce", "partition": partition,
            "document_id": document_id, "payload": payload,
        })["offset"]

    READ_BATCH = 500

    def read(self, partition: int, from_offset: int
             ) -> Iterator[QueueRecord]:
        offset = from_offset
        while True:
            frame = self._request({
                "type": "read", "partition": partition,
                "from_offset": offset, "max": self.READ_BATCH,
            })
            records = frame["records"]
            for r in records:
                yield QueueRecord(
                    r["offset"], r["document_id"], r["payload"]
                )
            if len(records) < self.READ_BATCH:
                # short batch = end of log: no extra empty round trip
                return
            offset = records[-1]["offset"] + 1

    def committed(self, partition: int) -> int:
        return self._request({
            "type": "committed", "partition": partition,
        })["offset"]

    def commit(self, partition: int, offset: int) -> None:
        self._request({
            "type": "commit", "partition": partition,
            "offset": offset,
        })

    # a BLOCKING round trip: tooling/off-loop samplers only — the
    # ingress refuses to wire it as a serving-path pressure source
    # (fanout_lag_is_local stays False; see OrderingQueue)
    def fanout_lag(self) -> int:
        """Broker-side consumer lag (one round trip)."""
        return self._request({"type": "lag"})["lag"]


def run_broker(host: str = "127.0.0.1", port: int = 7081,
               partitions: int = 4,
               data_dir: Optional[str] = None) -> None:
    """Blocking broker entry point (`python -m
    fluidframework_tpu_torch.service.broker`)."""
    broker = BrokerServer(partitions, data_dir, host, port)

    async def main():
        await broker.start()
        print(f"broker listening on {broker.host}:{broker.port} "
              f"({partitions} partitions, "
              f"{'durable' if data_dir else 'in-memory'})",
              flush=True)
        await broker.serve_forever()

    try:
        asyncio.run(main())
    except KeyboardInterrupt:  # pragma: no cover - operator stop
        pass


if __name__ == "__main__":  # pragma: no cover - CLI
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7081)
    ap.add_argument("--partitions", type=int, default=4)
    ap.add_argument("--data-dir", default=None)
    a = ap.parse_args()
    run_broker(a.host, a.port, a.partitions, a.data_dir)
