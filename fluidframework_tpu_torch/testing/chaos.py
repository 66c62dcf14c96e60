"""fluidchaos harness: seeded fault schedules driven end-to-end
through the REAL service stack, with a crash-recovery convergence
differential.

What runs here is not a simulation of the service — it is the real
thing, single-threaded and deterministic:

- real ``AlfredServer._dispatch`` frames (the serve_bench/overload
  idiom: ``_ClientSession(server, None)`` driven synchronously, no
  sockets, no event loop, no timing races);
- real ``Container``s over a frame-level DocumentService adapter
  (:class:`ChaosDocumentService`) whose transport seams consult the
  SAME named injection sites the TCP socket driver registers
  (``socket.frame_in``/``socket.frame_out`` — one schedule drives
  either harness);
- a real ``GpuMergeSidecar`` (tiny ladder, so documents overflow into
  the pool tier mid-run) subscribed to the server-side broadcaster, on
  the harness's ``device`` (``"cuda"`` unless the caller asks for the
  CPU: every entry point takes ``device=``, and without a CUDA device
  the default raises);
- real durable storage (op log + checkpoints), so a CRASH-RESTART
  mid-run rebuilds the whole service from disk: a fresh LocalServer
  fast-forwards each orderer from its last checkpoint + op log, the
  sidecar re-ingests the op log, and every client reconnects and
  resubmits its pending ops.

CRASH-STATE ENUMERATION (PAPERS.md, "All File Systems Are Not Created
Equal"): a crash may additionally leave a TORN durable state — but
only one the storage layer's write barriers actually permit. The
op log fsyncs before the pipeline fans out/acks, so the only
tearable op-log state is a tail op no client ever saw (the harness
asserts this before tearing); the checkpoint's write-temp+fsync+
rename leaves either a torn ``.tmp`` beside an intact checkpoint or
— enumerating the pre-fix reordered-write state read_checkpoint now
degrades on — a garbage final file. All three states must recover.

THE DIFFERENTIAL (tests/test_chaos.py): N seeded schedules each run
the same scripted multi-client workload (three writers sharing a
text+map document, each editing its OWN marker-delimited region +
disjoint map keys; one writer driving a sidecar-tracked document into
the pool tier — conflict-free BY CONSTRUCTION, so the final state is
interleaving-invariant and the fault-free oracle is well defined) and
must end bit-identical to the fault-free run: every replica's text,
signature and map, the late-joining replica loaded fresh from the
service, the sidecar's served text, a rebuilt-from-op-log shadow
sidecar, exactly-once pool watermarks, and every acked edit marker
present exactly once. Any failing seed reproduces from the seed
alone (`run_chaos(seed)`).
"""
from __future__ import annotations

import itertools
import json
import os
import random
import shutil
from dataclasses import dataclass, field
from typing import Optional

from ..loader.container import Container
from ..obs import metrics as obs_metrics
from ..obs.federation import FederatedView
from ..obs.timeline import FleetTimeline
from ..protocol.constants import batch_flag
from ..protocol.messages import (
    ClientDetail,
    DocumentMessage,
    MessageType,
    Nack,
    NackErrorType,
    SequencedMessage,
)
from ..protocol.serialization import decode_contents, message_from_json
from ..qos import CircuitBreaker
from ..qos.faults import (
    KIND_DEFER,
    KIND_DELAY,
    KIND_DISCONNECT,
    KIND_DROP,
    KIND_DUPLICATE,
    KIND_ERROR,
    KIND_NACK,
    KIND_REORDER,
    KIND_TORN_WRITE,
    PLANE,
    FaultSchedule,
    TransientFault,
    standard_rates,
)
from ..service import ingress as ingress_mod
from ..service.ingress import (
    AlfredServer,
    _ClientSession,
    document_message_to_json,
)
from ..service.local_server import LocalServer

# the transport sites (registered by name — the socket driver and
# fault_injection register the same ones)
_SITE_OUT = PLANE.site("socket.frame_out", (KIND_DISCONNECT, KIND_NACK))
_SITE_IN = PLANE.site(
    "socket.frame_in",
    (KIND_DROP, KIND_DUPLICATE, KIND_REORDER, KIND_DELAY))


# ======================================================================
# frame-level client stack over AlfredServer._dispatch


class ChaosTransport:
    """One client's in-proc 'TCP connection': a real ``_ClientSession``
    plus the inbound delivery state (held/delayed frames the reorder
    and delay faults are sitting on). Dies like a socket: marked
    closed, undelivered frames lost."""

    def __init__(self, server: AlfredServer, name: str):
        self.server = server
        self.name = name
        self.session = _ClientSession(server, None)
        server._sessions.add(self.session)
        self.open = True
        self.inbox: list[dict] = []      # drained, awaiting delivery
        self.delayed: list[dict] = []    # chaos-delayed to next pump

    def dispatch(self, frame: dict, nbytes: int = 0) -> None:
        if not self.open:
            raise ConnectionError(f"{self.name}: transport closed")
        try:
            self.server._dispatch(self.session, frame, nbytes)
        except Exception as e:  # noqa: BLE001 - the server-loop catch
            # mirror AlfredServer._handle: a dispatch fault answers
            # with an error frame and the server keeps serving —
            # including the errors-sent accounting, so faults injected
            # under this in-proc transport stay signal-visible
            ingress_mod._ERRORS_OUT.inc()
            self.session.send({
                "type": "error",
                "rid": frame.get("rid"),
                "error_kind": "permission"
                if isinstance(e, PermissionError) else "server",
                "message": f"{type(e).__name__}: {e}",
            })

    def drain(self) -> None:
        """Move queued outbound frames into the inbox (rid replies
        included — request() filters them out before delivery)."""
        q = self.session.outbound
        while not q.empty():
            raw = q.get_nowait()
            if raw is None:
                continue
            self.inbox.append(json.loads(raw[4:]))

    def die(self) -> None:
        """Transport death: both directions stop, undelivered frames
        are lost (the server side notices EOF and closes the session,
        sequencing the client leave — exactly what a dropped TCP
        connection does)."""
        if not self.open:
            return
        self.open = False
        self.inbox = []
        self.delayed = []
        self.session.close()

    def abandon(self) -> None:
        """Crash-side death: the SERVER is gone, so nothing sequences
        a leave — the connection just stops existing."""
        self.open = False
        self.inbox = []
        self.delayed = []


class ChaosDeltaConnection:
    """IDocumentDeltaConnection over chaos frames. Boxcars runtime
    batches into one submitOp frame (the wire-1.2 contract): a fault
    then hits the batch ATOMICALLY — a torn batch on the wire is the
    state the boxcar protocol exists to rule out."""

    def __init__(self, service: "ChaosDocumentService",
                 client_id: str):
        self._service = service
        self.client_id = client_id
        self.open = True
        self._batch: list[dict] = []
        self._batching = False

    def submit(self, op: DocumentMessage) -> None:
        assert self.open, "submit on closed connection"
        wire = document_message_to_json(op)
        flag = batch_flag(op.metadata)
        if self._batching or flag is True:
            self._batch.append(wire)
            self._batching = flag is not False
            if self._batching:
                return
            ops, self._batch = self._batch, []
            self._submit_frame({"ops": ops})
            return
        self._submit_frame({"op": wire})

    def _submit_frame(self, body: dict) -> None:
        fault = _SITE_OUT.fire(client=self.client_id)
        if fault == KIND_NACK:
            # refused as a throttling service would: frame dropped,
            # nack delivered synchronously (the in-proc LocalServer
            # nacks synchronously from submit too)
            self._service._deliver_nack({
                "operation": None, "sequence_number": 0,
                "error_type": int(NackErrorType.THROTTLING),
                "message": "chaos: injected nack",
                "retry_after_seconds": 0.0,
            })
            return
        if fault == KIND_DISCONNECT:
            # transport death mid-submit: this frame (and the rest of
            # the flush) is lost; pending resubmit on reconnect
            self._service._transport_died()
            return
        self._service.transport.dispatch({
            "type": "submitOp",
            "document_id": self._service.document_id, **body,
        })

    def disconnect(self) -> None:
        if not self.open:
            return
        self.open = False
        self._batch = []
        self._batching = False
        transport = self._service.transport
        if transport is not None and transport.open:
            try:
                transport.dispatch({
                    "type": "disconnect_document",
                    "document_id": self._service.document_id,
                })
            except ConnectionError:
                pass


class ChaosDocumentService:
    """IDocumentService over AlfredServer._dispatch frames — the
    socket driver's exact plane vocabulary (connect_document /
    submitOp / read_ops / fetch_summary / upload_summary_chunk),
    synchronous and deterministic. One instance per client per
    document; each connect_to_delta_stream opens a FRESH transport
    (a reconnect is a new TCP connection)."""

    _rids = itertools.count(1)

    def __init__(self, harness: "ChaosHarness", document_id: str,
                 client_name: str):
        self.harness = harness
        self.document_id = document_id
        self.client_name = client_name
        self.transport: Optional[ChaosTransport] = None
        self.connection: Optional[ChaosDeltaConnection] = None
        self._on_message = None
        self._on_nack = None

    # -- transport lifecycle -------------------------------------------

    def _fresh_transport(self) -> ChaosTransport:
        if self.transport is not None:
            self.transport.die()
        self.transport = ChaosTransport(
            self.harness.server, f"{self.client_name}")
        # register at CREATION, not on connect success: a transport
        # opened by a refused join (the degraded window) must still be
        # abandoned by a later leader swap, or a quiesce-time reuse
        # would read from the DEPOSED server through it
        self.harness.register_transport(self)
        return self.transport

    def _transport_died(self) -> None:
        if self.transport is not None:
            self.transport.die()
        if self.connection is not None:
            self.connection.open = False

    # -- request/response ----------------------------------------------

    def _request(self, frame: dict) -> dict:
        """One rid-paired request. Broadcast frames encountered while
        waiting are buffered for the pump — never delivered
        re-entrantly (the gap-refetch path issues requests from
        INSIDE a delivery)."""
        transport = self.transport
        if transport is None or not transport.open:
            # the loader reads snapshot + trailing ops BEFORE joining
            # the delta stream (container.ts load order): storage
            # requests open the transport on demand, exactly like the
            # socket driver's connect-time socket
            transport = self._fresh_transport()
        rid = next(self._rids)
        transport.dispatch(dict(frame, rid=rid))
        transport.drain()
        reply = None
        rest = []
        for f in transport.inbox:
            if f.get("rid") == rid and reply is None:
                reply = f
            else:
                rest.append(f)
        transport.inbox[:] = rest
        if reply is None:
            raise ConnectionError(
                f"{self.client_name}: no reply to {frame['type']}")
        if reply.get("type") == "error":
            msg = reply.get("message", "server error")
            if reply.get("error_kind") == "permission":
                raise PermissionError(msg)
            if reply.get("error_kind") == "throttle":
                from ..drivers.driver_utils import RetriableError

                raise RetriableError(msg, retry_after_seconds=reply.get(
                    "retry_after_seconds"))
            raise RuntimeError(msg)
        return reply

    # -- DocumentService surface ---------------------------------------

    def connect_to_delta_stream(self, client_id, on_message,
                                on_nack=None) -> ChaosDeltaConnection:
        self._on_message = on_message
        self._on_nack = on_nack
        transport = self._fresh_transport()
        transport.dispatch({
            "type": "connect_document",
            "document_id": self.document_id,
            "client_id": client_id,
            "versions": ["1.2", "1.1", "1.0"],
        })
        transport.drain()
        connected = None
        rest = []
        for f in transport.inbox:
            if f.get("type") in ("connected",
                                 "connect_document_error") \
                    and connected is None:
                connected = f
            else:
                rest.append(f)
        transport.inbox[:] = rest
        if connected is None or \
                connected["type"] == "connect_document_error":
            raise PermissionError(
                f"connect_document rejected: "
                f"{(connected or {}).get('message', 'no reply')}")
        self.connection = ChaosDeltaConnection(self, client_id)
        self.harness.register_transport(self)
        return self.connection

    def read_ops(self, from_seq: int,
                 to_seq=None) -> list[SequencedMessage]:
        frame = self._request({
            "type": "read_ops", "document_id": self.document_id,
            "from_seq": from_seq, "to_seq": to_seq,
        })
        return [message_from_json(m) for m in frame["msgs"]]

    def get_latest_summary(self):
        frame = self._request({
            "type": "fetch_summary", "document_id": self.document_id,
        })
        if frame.get("sequence_number") is None:
            return None
        return frame["sequence_number"], decode_contents(
            frame["summary"])

    _UPLOAD_CHUNK = 2048  # small, so uploads really chunk in tests

    def upload_summary(self, summary: dict) -> str:
        from ..protocol.serialization import encode_contents

        payload = json.dumps(encode_contents(summary))
        parts = [payload[i:i + self._UPLOAD_CHUNK]
                 for i in range(0, len(payload), self._UPLOAD_CHUNK)
                 ] or [""]
        upload_id = f"cu{next(self._rids)}"
        for i, part in enumerate(parts):
            data = {
                "type": "upload_summary_chunk",
                "document_id": self.document_id,
                "upload_id": upload_id,
                "chunk": i, "total": len(parts), "data": part,
            }
            if i + 1 < len(parts):
                self.transport.dispatch(data)
            else:
                frame = self._request(data)
        return frame["handle"]

    # -- inbound delivery (driven by the harness pump) ------------------

    def _deliver(self, frame: dict) -> None:
        kind = frame.get("type")
        if kind == "op" and self._on_message is not None:
            self._on_message(message_from_json(frame["msg"]))
        elif kind == "nack":
            self._deliver_nack(frame)
        # "error"/"upload_ack"/stray rid replies: nothing to deliver

    def _deliver_nack(self, frame: dict) -> None:
        if self._on_nack is None:
            return
        from ..service.ingress import document_message_from_json

        op = frame.get("operation")
        self._on_nack(Nack(
            operation=document_message_from_json(op) if op else None,
            sequence_number=frame.get("sequence_number", 0),
            error_type=NackErrorType(frame["error_type"]),
            message=frame.get("message", ""),
            retry_after_seconds=frame.get("retry_after_seconds"),
        ))

    def close(self) -> None:
        if self.transport is not None:
            self.transport.die()


# ======================================================================
# the harness


DOC_ALPHA = "chaos-alpha"
DOC_BETA = "chaos-beta"


class ChaosHarness:
    """Server + sidecar + frame-level clients, rebuildable from disk.

    The sidecar rides the tiny ladder (capacity 16 -> 32, pool 128)
    so the beta document genuinely overflows into the pool tier
    mid-run — chaos then fires through grow/pool-admit/pool-dispatch
    recovery, not just the steady path."""

    SIDECAR_CAPACITY = 16
    SIDECAR_MAX_CAPACITY = 32
    SIDECAR_POOL_CAPACITY = 128

    def __init__(self, durable_dir: str, checkpoint_every: int = 5,
                 replicated: bool = False, n_followers: int = 2,
                 device: str = "cuda"):
        self.durable_dir = durable_dir
        # the merge sidecars' device (the live one and every shadow)
        self.device = device
        self.checkpoint_every = checkpoint_every
        self.replicated = replicated
        self.n_followers = n_followers
        self.clock = ManualClock()
        self.services: dict[str, ChaosDocumentService] = {}
        self._transports: dict[str, ChaosTransport] = {}
        self.server: Optional[AlfredServer] = None
        self.sidecar = None
        self.group = None  # ReplicatedSequencerGroup when replicated
        self.network = None  # NetworkTopology when replicated
        self.crashes = 0
        self.failovers = 0
        # fleet observability (replicated runs): per-NODE registries
        # (the satellite fix — leader and follower series must not
        # double-count into one process registry), federated back
        # into one view, plus the causal failover timeline, all on
        # the step clock so every derived field is seed-deterministic
        self.timeline: Optional[FleetTimeline] = None
        self.fleet: Optional[FederatedView] = None
        self.node_registries: dict[str, obs_metrics.MetricsRegistry] \
            = {}
        if replicated:
            self.node_registries = {
                f"node-{i}": obs_metrics.MetricsRegistry(
                    node=f"node-{i}")
                for i in range(n_followers + 1)
            }
            self.timeline = FleetTimeline(
                clock=self.clock,
                registry=self.node_registries["node-0"])
            self.fleet = FederatedView(clock=self.clock)
            for node, reg in self.node_registries.items():
                self.fleet.add_registry(node, reg)
        self._boot()

    def _boot(self) -> None:
        # the production wiring: checkpoint writes behind a breaker
        # (a failing disk degrades durability, never availability —
        # the op log is the recovery path), on the harness clock so
        # open->half-open->close is step-deterministic
        breaker = CircuitBreaker(
            "chaos-checkpoint", failure_threshold=3,
            reset_timeout_s=0.2, clock=self.clock,
        )
        if self.replicated:
            from ..service.replication import (
                NetworkTopology,
                ReplicatedSequencerGroup,
            )

            if self.group is None:
                self.network = NetworkTopology(timeline=self.timeline)
                self.group = ReplicatedSequencerGroup(
                    self.durable_dir, n_followers=self.n_followers,
                    clock=self.clock, lease_ttl=0.3,
                    registry=self.node_registries["node-0"],
                    follower_registries=[
                        self.node_registries[f"node-{i}"]
                        for i in range(1, self.n_followers + 1)
                    ],
                    timeline=self.timeline,
                    # the netsplit plane: islands the seeded plan
                    # drives, a SHORT quorum deadline (0.2s = 4 retry
                    # ticks on the step clock, so unavailability
                    # discovery costs one submit, not the run), the
                    # grace TTL for membership shrink, and a sleep
                    # that ADVANCES the step clock — the barrier's
                    # deadline wait is deterministic per seed
                    network=self.network,
                    quorum_timeout_s=0.2,
                    retry_interval_s=0.05,
                    membership_grace_s=0.4,
                    sleep=self._advance_clock,
                    server_kwargs=dict(
                        checkpoint_every=self.checkpoint_every,
                        storage_breaker=breaker,
                        # wire timestamps on the step clock: recorded
                        # corpora (op logs, attribution tables) are
                        # byte-stable per seed, not per wall time
                        clock=self.clock,
                    ),
                )
            local = self.group.server
        else:
            local = LocalServer(
                durable_dir=self.durable_dir,
                checkpoint_every=self.checkpoint_every,
                storage_breaker=breaker,
                clock=self.clock,
            )
        self.server = AlfredServer(local)
        self._build_sidecar()

    def _build_sidecar(self) -> None:
        self.sidecar = _merge_sidecar(
            self.device,
            breaker=CircuitBreaker(
                "chaos-sidecar", failure_threshold=3,
                reset_timeout_s=0.2, clock=self.clock,
            ),
        )
        self.sidecar.subscribe(
            self.server.local, DOC_BETA, "app", "text")

    def service_for(self, document_id: str,
                    client_name: str) -> ChaosDocumentService:
        svc = ChaosDocumentService(self, document_id, client_name)
        self.services[client_name] = svc
        return svc

    def register_transport(self, svc: ChaosDocumentService) -> None:
        self._transports[svc.client_name] = svc.transport

    # -- delivery pump --------------------------------------------------

    def pump(self) -> int:
        """Deliver queued fanout frames to every client, firing the
        ``socket.frame_in`` site per 'op' frame. Deterministic order:
        clients in registration order; per client, delayed frames
        from the previous pump first, then fresh drains. Reordered
        frames deliver after the next delivered frame; delayed ones
        at the next pump. Returns frames delivered."""
        delivered = 0
        for name, svc in list(self.services.items()):
            transport = svc.transport
            if transport is None or not transport.open:
                continue
            transport.drain()
            todo = transport.delayed + transport.inbox
            transport.delayed = []
            transport.inbox = []
            held: list[dict] = []
            i = 0
            while i < len(todo) or held:
                if i >= len(todo):
                    # tail: nothing left to reorder past — flush holds
                    frame, held = held[0], held[1:]
                else:
                    frame = todo[i]
                    i += 1
                    if frame.get("type") == "op":
                        fault = _SITE_IN.fire(client=name)
                        if fault == KIND_DROP:
                            continue
                        if fault == KIND_DUPLICATE:
                            todo.insert(i, frame)
                        elif fault == KIND_REORDER:
                            held.append(frame)
                            continue
                        elif fault == KIND_DELAY:
                            transport.delayed.append(frame)
                            continue
                svc._deliver(frame)
                delivered += 1
                if held and frame.get("type") == "op":
                    # a later frame passed the held one: release
                    todo[i:i] = held
                    held = []
                if not transport.open:
                    # a delivery fault tore the transport down
                    break
            # frames drained into inbox by re-entrant requests during
            # delivery are picked up next pump
        return delivered

    # -- crash-restart --------------------------------------------------

    def crash(self, tear: Optional[str] = None,
              containers: Optional[list[Container]] = None) -> bool:
        """Kill the whole service with no goodbyes and rebuild it from
        disk. ``tear`` additionally applies one enumerated torn crash
        state first:

        - ``"checkpoint_tmp"``: crash between the checkpoint's
          temp-write and rename (torn .tmp beside the intact
          checkpoint);
        - ``"checkpoint_final"``: prefix-truncated checkpoint.json —
          the pre-fsync reordered-write state (read_checkpoint must
          degrade to op-log fast-forward);
        - ``"oplog_tail"``: prefix-truncated final op-log line — legal
          ONLY for an op no client processed (the fsync-before-fanout
          barrier); asserted against ``containers``, skipped (and
          recorded) if the barrier would be violated.

        Returns whether the torn state was ACTUALLY applied — callers
        must not report (or count toward coverage) a tear the barrier
        refused.
        """
        self._abandon_all()
        self.server = None
        self.crashes += 1
        applied = False
        if tear:
            applied = self._apply_tear(tear, containers or [])
        self._boot()
        # the sidecar rebuilds from the durable op log — the recovery
        # the differential pins live-state-equal to
        for msg in self.server.local.read_ops(DOC_BETA, 0):
            self.sidecar.ingest(DOC_BETA, msg)
        return applied

    def _abandon_all(self) -> None:
        for transport in self._transports.values():
            transport.abandon()
        for svc in self.services.values():
            if svc.connection is not None:
                svc.connection.open = False

    # -- leader failover (the replicated plane) -------------------------

    def kill_leader(self, mode: str = "clean") -> None:
        """Host loss on the replicated plane: the leader dies with no
        goodbyes (transports abandoned, nothing sequences a leave),
        the lease lapses on its TTL, a follower is promoted at
        exactly the replicated head, and clients ride the
        reconnect/resubmit path onto the new leader — no new client
        machinery, which is the point. ``mode="under_lag"`` promotes
        the LAGGIEST follower (flush + anti-entropy must still land
        it on the exact head)."""
        assert self.group is not None, "kill_leader needs replicated="
        self._abandon_all()
        self.server = None
        # the incident's t0 on the causal timeline (failover_phases
        # measures detection from here)
        self.timeline.record("leader_kill", node=self.group.leader_id,
                             mode=mode)
        self.group.kill_leader()
        # the host is gone; nobody renews: walk the step clock past
        # the TTL — the lease seam is what converts host loss into an
        # election instead of a hung lock
        self.clock.t += self.group.lease.ttl + 0.01
        candidate = (self.group.laggiest_follower()
                     if mode == "under_lag" else None)
        self.group.failover(candidate=candidate)
        self.failovers += 1
        self._swap_to_new_leader()

    def begin_depose(self) -> None:
        """The split-brain candidate: the lease service lapses the
        grant while the leader is ALIVE and serving; a follower is
        promoted. The old leader keeps its transports until
        ``complete_leader_swap`` — every write driven through them in
        between must be refused by the epoch fence."""
        assert self.group is not None
        self.group.lease.force_expire(reason="deposed_race")
        self.group.failover()
        self.failovers += 1

    def complete_leader_swap(self) -> None:
        self._abandon_all()
        self._swap_to_new_leader()

    def _swap_to_new_leader(self) -> None:
        self.server = AlfredServer(self.group.server)
        self._build_sidecar()
        # the sidecar rebuilds from the REPLICATED op log, exactly
        # like the crash path rebuilds from the durable one
        for msg in self.server.local.read_ops(DOC_BETA, 0):
            self.sidecar.ingest(DOC_BETA, msg)

    def _advance_clock(self, dt: float) -> None:
        """The quorum barrier's injectable sleep: waiting out the
        deadline ADVANCES the step clock, so a partition's discovery
        cost is deterministic per seed."""
        self.clock.t += dt

    def load_container(self, document_id: str, client_name: str,
                       client_id: str) -> Container:
        """Container.load with the harness bindings: the throttle-nack
        backoff clock rides the STEP clock (a wall-clock backoff
        would make `flush()`'s reconnect gate depend on how fast the
        test machine runs — the exact nondeterminism the config9
        discipline forbids)."""
        c = Container.load(self.service_for(document_id, client_name),
                           client_id=client_id)
        c._backoff_clock = self.clock
        return c

    # -- netsplits (the partition-tolerance plane) ----------------------

    def apply_netsplit(self, mode: str) -> None:
        """Apply one enumerated split (SPLIT_MODES). Island layouts
        are STATIC node-name lists — a mid-run leadership change does
        not move the islands, exactly like a real partition."""
        assert self.group is not None, "netsplits need replicated="
        if mode in ("symmetric", "flap"):
            self.network.partition(
                [["node-0", "node-1"], ["node-2"]], lease_island=0)
        elif mode == "minority_leader":
            # the leader alone on the minority side; the LEASE
            # SERVICE sits with the majority, so the lease lapses and
            # the majority can elect while the minority leader can
            # only nack (and is fenced after the election)
            self.network.partition(
                [["node-0"], ["node-1", "node-2"]], lease_island=1)
        elif mode == "lease_isolated":
            # everyone replicates fine; NOBODY reaches the lease
            # service — no renewals, no elections: past the TTL the
            # leader cannot prove leadership and steps into the
            # read-only brownout until the heal
            self.network.partition(
                [["node-0", "node-1", "node-2"], []], lease_island=1)
        else:
            raise ValueError(f"unknown netsplit mode {mode!r}")

    def heal_netsplit(self) -> None:
        if self.network is not None:
            self.network.heal()

    def wipe_follower(self, node_id: str) -> None:
        """Crash-and-WIPE a follower: its process dies and its disk is
        gone (the dir is deleted). Detached immediately through the
        group's shared shrink path — the grace TTL covers
        reachability loss; a wipe is observed as a dead host being
        replaced — and re-admitted by ``rejoin_follower`` via full
        anti-entropy from a surviving full-history peer."""
        g = self.group
        f = next(x for x in g.followers if x.node_id == node_id)
        f._heads.clear()
        f._lag.clear()
        root = g.detach(node_id, origin="wipe")
        assert root is not None, f"{node_id} was not detachable"
        shutil.rmtree(root, ignore_errors=True)

    def rejoin_follower(self, node_id: str) -> None:
        self.group.rejoin(
            node_id, registry=self.node_registries.get(node_id))

    def elect_majority(self) -> None:
        """The majority side's election during a minority-leader
        split: the lapsed lease is observed, the best-replicated
        majority follower is promoted (it can reach the lease
        service; the minority leader cannot), and the deposed
        minority leader keeps running — every write still driven
        through it must be refused by the epoch fence until it
        rejoins as a follower after the heal."""
        self.group.failover()
        self.failovers += 1

    def bitrot_and_scrub(self) -> int:
        """Plant one mid-file bit-rot state (a parseable record whose
        crc no longer matches — recorded through the storage.bitrot
        site) in the first follower log with enough records, then run
        the group scrubber: the record must be read-repaired from a
        quorum peer. Returns records repaired."""
        from ..qos.faults import KIND_CORRUPT
        from ..service.storage import _SITE_BITROT

        g = self.group
        for f in g.followers:
            for doc in f.documents():
                path = f._log_path(doc)
                if not os.path.isfile(path):
                    continue
                with open(path) as fh_r:
                    lines = fh_r.readlines()
                if len(lines) < 3:
                    continue
                # corrupt a NEAR-TAIL record (not the tail): the
                # leader's log always still covers it (summary
                # truncation can drop the head), so a quorum copy
                # exists even when this is the only follower
                idx = len(lines) - 2
                row = json.loads(lines[idx])
                row["contents"] = {"bitrot": True}  # stale _crc kept
                lines[idx] = json.dumps(row) + "\n"
                fh = f._fhs.pop(doc, None)
                if fh is not None:
                    fh.close()
                with open(path, "w") as fh_w:
                    fh_w.writelines(lines)
                _SITE_BITROT.force(KIND_CORRUPT, node=f.node_id,
                                   doc=doc, record=idx)
                return g.scrub()
        return 0

    def _apply_tear(self, tear: str,
                    containers: list[Container]) -> bool:
        """Apply one torn crash state; returns whether it actually
        applied (the barrier can refuse — see ``crash``)."""
        doc_dir = os.path.join(self.durable_dir, DOC_ALPHA)
        site = PLANE.site("storage.checkpoint_write")
        if tear == "checkpoint_tmp":
            path = os.path.join(doc_dir, "checkpoint.json")
            data = open(path, "rb").read() if os.path.exists(path) \
                else b'{"torn'
            with open(path + ".tmp", "wb") as f:
                f.write(data[:max(1, len(data) // 2)])
            site.force(KIND_TORN_WRITE, state="checkpoint_tmp")
            return True
        if tear == "checkpoint_final":
            path = os.path.join(doc_dir, "checkpoint.json")
            if not os.path.exists(path):
                return False
            data = open(path, "rb").read()
            with open(path, "wb") as f:
                f.write(data[:max(1, len(data) // 2)])
            site.force(KIND_TORN_WRITE, state="checkpoint_final")
            return True
        if tear == "oplog_tail":
            path = os.path.join(doc_dir, "ops.jsonl")
            if not os.path.exists(path):
                return False
            with open(path, "rb") as f:
                lines = f.readlines()
            if not lines:
                return False
            last_seq = json.loads(lines[-1])["sequenceNumber"]
            seen = max((c.last_processed_seq for c in containers
                        if c.service.document_id == DOC_ALPHA),
                       default=0)
            if last_seq <= seen:
                # the fsync-before-fanout barrier says this op is
                # durable-by-contract (a client processed it): this
                # crash state is UNREACHABLE — record the skip
                PLANE.flight.record("tear-skipped", seq=last_seq,
                                    seen=seen)
                return False
            torn = lines[-1][:max(1, len(lines[-1]) // 2)]
            with open(path, "wb") as f:
                f.writelines(lines[:-1])
                f.write(torn)
            PLANE.site("storage.oplog_append").force(
                KIND_TORN_WRITE, state="oplog_tail", seq=last_seq)
            return True
        raise ValueError(f"unknown tear state {tear!r}")


class ManualClock:
    """The injectable step clock every deterministic harness shares —
    ONE owner (tools/stress and tools/serve_bench import it from
    here; tools may import testing, never the reverse)."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


# ======================================================================
# the scripted workload + convergence report


@dataclass
class ChaosReport:
    seed: int
    faults_armed: bool = True
    converged: bool = False
    failures: list[str] = field(default_factory=list)
    fired: list[tuple] = field(default_factory=list)
    chaos_counts: dict = field(default_factory=dict)
    crashes: int = 0
    tear: Optional[str] = None
    #: the planned tear was ACTUALLY applied (the barrier can refuse
    #: an unreachable state — coverage must not count those)
    tear_applied: bool = False
    reconnects: int = 0
    acked_ops: int = 0
    alpha_text: str = ""
    alpha_kv: str = ""
    beta_text: str = ""
    sidecar_tier: str = ""
    pool_watermarks: dict = field(default_factory=dict)
    # replicated-plane runs (run_chaos_failover)
    failovers: int = 0
    kill_mode: Optional[str] = None
    fenced_writes: int = 0
    repl_lag_max: int = 0
    # netsplit runs (run_chaos_netsplit): the partition-tolerance
    # surface — all step-clock/seed deterministic
    netsplit_mode: Optional[str] = None
    partitions: int = 0
    heals: int = 0
    unavailable_nacks: int = 0
    degraded_s: float = 0.0
    rejoins: int = 0
    scrub_repairs: int = 0
    # fleet observability (replicated runs): the causal timeline's
    # event sequence and the federated per-node counter totals —
    # both step-clock/seed deterministic, both in
    # deterministic_fields so same-seed runs must match bit-for-bit
    timeline_events: list = field(default_factory=list)
    fleet_counters: dict = field(default_factory=dict)
    # the broker coverage leg (exactly-once through the partitioned
    # queue seams, every run)
    broker_ops: int = 0

    def deterministic_fields(self) -> dict:
        """Everything that must be bit-equal for the same seed (the
        config9 discipline: nothing wall-clock rides here)."""
        return {
            "fired": list(self.fired),
            "chaos_counts": dict(self.chaos_counts),
            "crashes": self.crashes,
            "tear": self.tear,
            "tear_applied": self.tear_applied,
            "reconnects": self.reconnects,
            "acked_ops": self.acked_ops,
            "alpha_text": self.alpha_text,
            "alpha_kv": self.alpha_kv,
            "beta_text": self.beta_text,
            "sidecar_tier": self.sidecar_tier,
            "pool_watermarks": dict(self.pool_watermarks),
            "failovers": self.failovers,
            "kill_mode": self.kill_mode,
            "fenced_writes": self.fenced_writes,
            "repl_lag_max": self.repl_lag_max,
            "netsplit_mode": self.netsplit_mode,
            "partitions": self.partitions,
            "heals": self.heals,
            "unavailable_nacks": self.unavailable_nacks,
            "degraded_s": round(self.degraded_s, 6),
            "rejoins": self.rejoins,
            "scrub_repairs": self.scrub_repairs,
            "timeline_events": list(self.timeline_events),
            "fleet_counters": dict(self.fleet_counters),
            "broker_ops": self.broker_ops,
        }


def standard_schedule(seed: int,
                      sites: Optional[list[str]] = None
                      ) -> FaultSchedule:
    return FaultSchedule(seed, rates=standard_rates(sites))


def crash_plan(seed: int, n_steps: int) -> tuple[Optional[int],
                                                 Optional[str]]:
    """(crash step, tear state) as a PURE function of the seed — odd
    seeds crash mid-run, cycling through the enumerated tear states —
    so a failing seed reproduces with no side channel, and any seed
    range [0, 2k) provably covers every crash/tear combination."""
    if seed % 2 == 0:
        return None, None
    tear = [None, "checkpoint_tmp", "checkpoint_final",
            "oplog_tail"][(seed // 2) % 4]
    step = n_steps // 2 + (seed % 5)
    return step, tear


KILL_MODES = ("clean", "mid_batch", "under_lag", "deposed_race")


def failover_plan(seed: int, n_steps: int) -> tuple[Optional[int],
                                                    Optional[str]]:
    """(kill step, kill mode) as a PURE function of the seed for the
    replicated-plane differential: three of every four seeds kill the
    leader (cycling the enumerated modes — clean host loss, kill
    MID-BATCH between one writer's flush and the next, promotion of a
    follower with real replication LAG, and the deposed-leader
    split-brain race), the fourth runs the armed schedule over the
    replicated plane with no kill (replication must also survive
    plain chaos). The mode cycles with (seed%4 + seed//4), so any
    seed range [0, 8k) provably covers every mode plus the no-kill
    case (deposed_race first appears at seed 6 — a 4-seed sweep is
    NOT enough)."""
    if seed % 4 == 3:
        return None, None
    mode = KILL_MODES[(seed % 4 + seed // 4) % 4]
    step = n_steps // 2 + (seed % 5)
    return step, mode


SPLIT_MODES = ("minority_leader", "symmetric", "lease_isolated",
               "flap", "wipe_rejoin")


def netsplit_plan(seed: int, n_steps: int) -> dict:
    """The netsplit differential's schedule as a PURE function of the
    seed (the crash_plan/failover_plan discipline): which of the five
    enumerated split modes applies, when it splits and heals, whether
    the seed additionally crash-restarts the leader (odd seeds —
    placed where each mode makes a takeover legal: mid-split when a
    majority-side election can run, at/after the heal when it cannot),
    and when the bit-rot scrub-repair leg runs (every seed, after the
    heal, so a quorum peer exists). The mode cycles with
    (seed%5 + 2*(seed//5)) — the stride-2 block offset is what makes
    any seed range [0, 20) cover every mode in BOTH parities (a
    stride-1 cycle kept wipe_rejoin on even seeds only, so the
    wipe+crash combination was silently never swept).

    Mode shapes:

    - ``minority_leader`` — the leader alone vs the majority (lease
      with the majority): degraded nacks on the minority side, a
      majority election when the TTL lapses, the deposed leader
      fenced, and a post-heal REJOIN of the old leader as a follower.
    - ``symmetric`` — leader+one follower vs the other: quorum holds,
      the isolated follower detaches on the grace TTL and rejoins at
      the heal.
    - ``lease_isolated`` — the lease service in its own island:
      replication fine, leadership unprovable past the TTL →
      read-only brownout, healed by the first post-heal renewal.
    - ``flap`` — the symmetric split applying/healing every 2 steps.
    - ``wipe_rejoin`` — a follower crashes AND loses its disk;
      rejoin is a full anti-entropy resync from a surviving
      full-history peer behind the epoch fence.
    """
    mode = SPLIT_MODES[(seed % 5 + 2 * (seed // 5)) % 5]
    split = n_steps // 2 - 2 + (seed % 3)
    heal = split + 10
    crash = None
    if seed % 2 == 1:
        if mode in ("symmetric", "flap"):
            crash = split + 3      # mid-split: majority can elect
        elif mode == "lease_isolated":
            crash = heal           # elections impossible mid-split
        elif mode == "wipe_rejoin":
            crash = heal + 1       # after the wiped node resynced
        # minority_leader: the mid-split majority election IS the
        # leadership change this mode exists to prove
    return {"mode": mode, "split": split, "heal": heal,
            "crash": crash, "scrub": heal + 3}


_ALPHA_TAGS = ("A", "B", "C")


def _region_edit(container: Container, tag: str, serial: int,
                 rng: random.Random) -> None:
    """One conflict-free edit inside the client's own marker-delimited
    region: append a UNIQUE marker string at the region's end, or
    remove a couple of the client's own trailing characters. Position
    arithmetic runs against the client's own view; only this client
    writes inside its region, so the region's content is a pure fold
    of its own edit history — interleaving-invariant by construction
    (the docstring up top explains why the differential needs that)."""
    text = container.runtime.get_datastore("app").get_channel("text")
    view = text.get_text()
    start = view.index(f"[{tag}]") + len(tag) + 2
    order = _ALPHA_TAGS + ("Z",)
    ends = [view.index(f"[{t}]") for t in order
            if t != tag and f"[{t}]" in view and
            view.index(f"[{t}]") >= start]
    end = min(ends) if ends else len(view)
    if rng.random() < 0.25 and end - start > 8:
        cut = rng.randrange(2, 4)
        text.remove_text(end - cut, end)
    else:
        text.insert_text(end, f"{tag.lower()}{serial:03d}.")


def run_chaos(seed: int, faults: bool = True,
              n_steps: int = 40, workload_seed: int = 1234,
              durable_dir: Optional[str] = None,
              sites: Optional[list[str]] = None,
              replicated: bool = False,
              netsplit: bool = False,
              device: str = "cuda") -> ChaosReport:
    """One chaos run: scripted workload, seeded schedule, optional
    crash-restart, quiesce, convergence checks. ``faults=False`` is
    the fault-free oracle (same workload, nothing armed, no crash).
    Everything a failure needs rides the returned report. ``device``
    is the merge sidecars' (``"cpu"`` runs their plain version)."""
    report = ChaosReport(seed=seed, faults_armed=faults)
    before = obs_metrics.REGISTRY.flat()
    tmp_owned = durable_dir is None
    if tmp_owned:
        import tempfile

        durable_dir = tempfile.mkdtemp(prefix="fftpu-chaos-")
    try:
        _run_chaos_into(report, seed, faults, n_steps,
                        workload_seed, durable_dir, sites,
                        replicated=replicated, netsplit=netsplit,
                        device=device)
    finally:
        if PLANE.armed:
            PLANE.disarm()
        if tmp_owned:
            shutil.rmtree(durable_dir, ignore_errors=True)
    delta = obs_metrics.REGISTRY.delta(before)
    report.chaos_counts = {
        k: int(v) for k, v in sorted(delta.items())
        if k.startswith("chaos_injected_total")
    }
    # replicated runs already read this from the federated per-node
    # registries inside _run_chaos_into; the process-wide delta is
    # the non-replicated path's (zero) share
    report.fenced_writes += int(delta.get(
        "sequencer_fenced_writes_total", 0))
    report.converged = not report.failures
    return report


def run_chaos_netsplit(seed: int, faults: bool = True,
                       n_steps: int = 40,
                       workload_seed: int = 1234,
                       durable_dir: Optional[str] = None,
                       sites: Optional[list[str]] = None,
                       device: str = "cuda") -> ChaosReport:
    """THE netsplit differential entry point: the same scripted
    workload over the replicated plane, with ``netsplit_plan(seed)``
    splitting the network mid-run (all five enumerated split modes,
    odd seeds additionally crash-restarting the leader) and a bit-rot
    scrub-repair leg after the heal. ``faults=False`` is the
    replicated fault-free oracle — identical to
    ``run_chaos_failover(faults=False)``, so the sweep pins equality
    against the same oracle chain (netsplit ≡ failover oracle ≡
    plain-plane oracle). A failing seed reproduces alone:
    ``run_chaos_netsplit(seed)``."""
    return run_chaos(seed, faults=faults, n_steps=n_steps,
                     workload_seed=workload_seed,
                     durable_dir=durable_dir, sites=sites,
                     replicated=True, netsplit=True, device=device)


def run_chaos_failover(seed: int, faults: bool = True,
                       n_steps: int = 40,
                       workload_seed: int = 1234,
                       durable_dir: Optional[str] = None,
                       sites: Optional[list[str]] = None,
                       device: str = "cuda") -> ChaosReport:
    """THE kill-the-leader differential entry point: the same
    scripted workload over the REPLICATED sequencer plane, with
    ``failover_plan(seed)`` killing the leader mid-run (mid-batch,
    under replication lag, or as a deposed-leader race — see
    KILL_MODES). ``faults=False`` is the replicated fault-free
    oracle; replication is TRANSPARENT, so its converged state must
    also equal the plain-plane oracle's (pinned in test_chaos.py).
    A failing seed reproduces alone: ``run_chaos_failover(seed)``."""
    return run_chaos(seed, faults=faults, n_steps=n_steps,
                     workload_seed=workload_seed,
                     durable_dir=durable_dir, sites=sites,
                     replicated=True, device=device)


def _run_chaos_into(report: ChaosReport, seed: int, faults: bool,
                    n_steps: int, workload_seed: int,
                    durable_dir: str,
                    sites: Optional[list[str]],
                    replicated: bool = False,
                    netsplit: bool = False,
                    device: str = "cuda") -> None:
    harness = ChaosHarness(durable_dir, replicated=replicated,
                           device=device)
    wl = random.Random(workload_seed)  # the SAME script for any seed
    ns: Optional[dict] = None
    if netsplit:
        crash_step, tear = None, None
        kill_step, kill_mode = None, None
        ns = netsplit_plan(seed, n_steps) if faults else None
    elif replicated:
        crash_step, tear = None, None
        kill_step, kill_mode = failover_plan(seed, n_steps) \
            if faults else (None, None)
    else:
        crash_step, tear = crash_plan(seed, n_steps) if faults \
            else (None, None)
        kill_step, kill_mode = None, None
    report.tear = tear if crash_step is not None else None
    report.kill_mode = kill_mode if kill_step is not None else None
    report.netsplit_mode = ns["mode"] if ns else None

    # --- setup (pre-arm): regions + channels, everyone synced --------
    writers: list[Container] = []
    for i, tag in enumerate(_ALPHA_TAGS):
        writers.append(harness.load_container(
            DOC_ALPHA, f"alpha-{tag}", f"client-{tag}"))
    ds = writers[0].runtime.create_datastore("app")
    ds.create_channel("sharedstring", "text")
    ds.create_channel("sharedmap", "kv")
    text0 = writers[0].runtime.get_datastore("app").get_channel("text")
    text0.insert_text(0, "[A][B][C][Z]")
    writers[0].flush()
    harness.pump()
    beta = harness.load_container(DOC_BETA, "beta-W", "client-W")
    bds = beta.runtime.create_datastore("app")
    bds.create_channel("sharedstring", "text")
    beta.flush()
    harness.pump()

    serials = [0, 0, 0]
    beta_serial = 0
    down_until: dict[int, int] = {}
    all_containers = writers + [beta]

    # acked = own OPERATION msgs seen back sequenced, off the
    # 'processed' event (monotone across reconnect epochs)
    acked_box = [0]

    def _count_ack(c: Container):
        from ..protocol.messages import MessageType as _MT

        def on_processed(msg) -> None:
            if msg.type == _MT.OPERATION \
                    and msg.client_id == c.client_id:
                acked_box[0] += 1
        return on_processed

    for c in all_containers:
        c.on("processed", _count_ack(c))

    # broker coverage leg: one op per step through the partitioned
    # queue so the broker seams (queue_append/consume) are covered in
    # the SAME armed sweep the vacuity guard audits — and their
    # absorption (produce retry, csn dedupe) is convergence-checked
    # every run, not just in their unit tests
    from ..service.partitioning import PartitionedOrderingService

    # step clock for wire timestamps, like the main plane: the broker
    # leg's sequenced records are part of the per-seed corpus too
    broker = PartitionedOrderingService(n_partitions=1,
                                        clock=harness.clock)
    broker.produce_join("chaos-broker", ClientDetail("bk"))
    broker_csn = 0

    schedule = standard_schedule(seed, sites)
    reconnect_rng = schedule.rng_for("reconnect")
    if faults:
        PLANE.arm(schedule)

    def beta_edit() -> None:
        nonlocal beta_serial
        btext = beta.runtime.get_datastore("app").get_channel("text")
        length = btext.get_length()
        if wl.random() < 0.2 and length > 12:
            start = wl.randrange(0, length - 3)
            btext.remove_text(start, start + 2)
        else:
            pos = wl.randrange(0, length + 1)
            beta_serial += 1
            btext.insert_text(pos, f"w{beta_serial:03d}.")

    # --- the scripted main loop --------------------------------------
    ns_elected = False
    ns_swap_step: Optional[int] = None
    for step in range(n_steps):
        harness.clock.t += 0.05
        # reconnects due this step (transport deaths + crash)
        for i, when in list(down_until.items()):
            c = all_containers[i]
            if step >= when:
                del down_until[i]
                if not c.connected and not c.closed:
                    if not _connect_maybe(c, report,
                                          guarded=ns is not None):
                        # still inside the degraded window: the join
                        # was refused retriably — stay down, retry on
                        # the jittered schedule
                        down_until[i] = step + 1 + \
                            reconnect_rng.randrange(3)
        # --- netsplit schedule (netsplit_plan: split/heal/crash/scrub)
        if ns is not None:
            if step == ns["split"]:
                if ns["mode"] == "wipe_rejoin":
                    harness.wipe_follower("node-2")
                else:
                    harness.apply_netsplit(ns["mode"])
            if ns["mode"] == "flap" and \
                    ns["split"] < step < ns["heal"] and \
                    (step - ns["split"]) % 2 == 0:
                # flapping: the same split toggling every 2 steps
                if harness.network.split:
                    harness.heal_netsplit()
                else:
                    harness.apply_netsplit("flap")
            if (ns["mode"] == "minority_leader" and not ns_elected
                    and harness.network.split
                    and harness.group.lease.expired()):
                # the MAJORITY side observes the lapse and elects;
                # this step's flushes still drive the deposed
                # minority leader — every one must be fenced
                harness.elect_majority()
                ns_elected = True
                ns_swap_step = step + 1
            if ns_swap_step is not None and step == ns_swap_step:
                ns_swap_step = None
                harness.complete_leader_swap()
                for j in range(len(all_containers)):
                    down_until[j] = step + 1 + \
                        reconnect_rng.randrange(3)
            if step == ns["heal"]:
                harness.heal_netsplit()
                if ns["mode"] == "minority_leader":
                    # the deposed old leader rejoins as a follower
                    harness.rejoin_follower("node-0")
                if ns["mode"] == "wipe_rejoin" or \
                        "node-2" in harness.group.detached:
                    # wiped, or grace-detached during the split
                    harness.rejoin_follower("node-2")
            if ns["crash"] is not None and step == ns["crash"]:
                harness.kill_leader("clean")
                for j in range(len(all_containers)):
                    down_until[j] = step + 1 + \
                        reconnect_rng.randrange(3)
            if step == ns["scrub"]:
                report.scrub_repairs += harness.bitrot_and_scrub()
        kill_now = kill_step is not None and step == kill_step
        if kill_now and kill_mode == "under_lag":
            # make replication lag REAL before the kill: the next
            # offers defer, so the promoted follower carries a
            # buffered (non-durable) tail into the election
            PLANE.site("repl.lag").push(KIND_DEFER, 4)
        if kill_now and kill_mode == "clean":
            # deterministic promote-retry coverage: the election's
            # first attempt fails transiently on every clean-kill
            # seed, not just when the armed schedule happens to draw
            PLANE.site("repl.promote").push(KIND_ERROR, 1)
        if kill_now and kill_mode == "deposed_race":
            # the grant lapses while the leader is ALIVE: this step's
            # flushes below drive writes through the DEPOSED leader
            # and every one must be refused by the epoch fence
            harness.begin_depose()
        # one scripted action per alpha writer; beta edits 2x (it has
        # to outgrow the sidecar ladder into the pool tier). Every
        # client ALWAYS performs its scripted action — offline edits
        # land in pending local state and resubmit on reconnect (the
        # stress idiom) — so the edit script (and the workload rng's
        # consumption) is identical whatever the fault state, which
        # is what makes the fault-free oracle comparable bit-for-bit.
        for i, c in enumerate(writers):
            act = wl.random()
            if act < 0.55:
                serials[i] += 1
                _region_edit(c, _ALPHA_TAGS[i], serials[i], wl)
            elif act < 0.75:
                kv = c.runtime.get_datastore("app").get_channel("kv")
                kv.set(f"{_ALPHA_TAGS[i]}{wl.randrange(8)}",
                       wl.randrange(1000))
            # else: think (flush below still runs)
            _safe_flush(c, all_containers, down_until, i, step,
                        reconnect_rng, guarded=ns is not None)
            if kill_now and kill_mode == "mid_batch" and i == 0:
                # kill MID-BATCH: writer A's flush is sequenced and
                # replicated; B, C and beta flush into a dead plane
                # and their edits ride the pending-resubmit path
                harness.kill_leader("mid_batch")
                for j in range(len(all_containers)):
                    down_until[j] = step + 1 + \
                        reconnect_rng.randrange(3)
        beta_edit()
        beta_edit()
        _safe_flush(beta, all_containers, down_until, 3, step,
                    reconnect_rng, guarded=ns is not None)
        if kill_now and kill_mode in ("clean", "under_lag"):
            # kill AFTER the step's flushes, BEFORE their pump — the
            # crash-plan timing: the just-sequenced fanout frames die
            # with the leader, and the replicated log is the only
            # copy that survives
            harness.kill_leader(kill_mode)
            for j in range(len(all_containers)):
                down_until[j] = step + 1 + reconnect_rng.randrange(3)
        if kill_now and kill_mode == "deposed_race":
            harness.complete_leader_swap()
            for j in range(len(all_containers)):
                down_until[j] = step + 1 + reconnect_rng.randrange(3)
        if step == crash_step:
            # crash AFTER this step's flushes and BEFORE their pump:
            # the just-sequenced ops' fanout frames die undelivered
            # with the server, so no client has processed the log
            # tail — exactly the window where the torn-tail crash
            # state is reachable under the fsync-before-fanout
            # barrier (a crash at the pumped boundary would make
            # every oplog_tail tear a vacuous skip)
            report.tear_applied = harness.crash(
                tear=tear, containers=all_containers)
            for i in range(len(all_containers)):
                down_until[i] = step + 1 + reconnect_rng.randrange(3)
        harness.pump()
        # summarize alpha occasionally (through the chunked upload
        # plane — its chaos site degrades it to the inline path).
        # Gated on EVERY alpha replica being connected and aligned:
        # the summary ack truncates the op log at the proposal's
        # refSeq, and a replica still below that point would be
        # stranded (reconnect cannot catch up from a truncated log —
        # the loud Container.connect error this harness surfaced)
        if step in (n_steps // 3, (2 * n_steps) // 3):
            c = writers[0]
            aligned = (
                all(_alive(w) for w in writers)
                and len({w.last_processed_seq for w in writers}) == 1
                and c.runtime.pending.count == 0
                and not c._sent_times
            )
            if aligned:
                try:
                    c.summarize()
                except (RuntimeError, ConnectionError):
                    pass  # transient: the next summary window retries
                harness.pump()
        # sidecar dispatch round every 3rd step
        if step % 3 == 2:
            try:
                harness.sidecar.apply()
            except TransientFault:
                pass  # queued ops retry at the next round
        # broker coverage leg: a double-fault append retries the SAME
        # csn next step, so the expected sequence stays gapless
        try:
            broker.produce_op("chaos-broker", "bk", DocumentMessage(
                client_sequence_number=broker_csn + 1,
                reference_sequence_number=0,
                type=MessageType.OPERATION,
                contents={"v": broker_csn + 1}))
            broker_csn += 1
        except TransientFault:
            pass
        broker.pump()
    # --- quiesce: disarm, reconnect, drain to a fixed point ----------
    if faults:
        PLANE.disarm()
    def unsettled(c: Container) -> bool:
        # pending local state, in-flight ops, or a replica stale
        # behind the service head (a chaos-dropped fanout frame with
        # no follow-on traffic never redelivers by itself: gap
        # detection needs a NEXT frame to notice)
        head = harness.server.local.get_orderer(
            c.service.document_id).op_log.last_seq
        return bool(c.runtime.pending.count or c._sent_times
                    or c.last_processed_seq < head)

    for _round in range(12):
        harness.clock.t += 0.3  # lets the sidecar breaker half-open
        for c in all_containers:
            if not c.connected and not c.closed:
                c.connect()
                report.reconnects += 1
            c.flush()
        harness.pump()
        harness.sidecar.apply()
        if not any(unsettled(c) for c in all_containers):
            break
        if _round >= 2:
            # still unsettled: heal exactly the way a real client
            # would — drop the connection and reconnect. Catch-up
            # replays everything missed from the op log (dropped
            # acks AND dropped remote fanout) and the pending replay
            # resubmits the rest.
            for c in all_containers:
                if not c.closed and unsettled(c):
                    c.disconnect()
                    c.connect()
                    report.reconnects += 1
                    c.flush()
            harness.pump()
    else:
        stuck = [c.client_id for c in all_containers if unsettled(c)]
        if stuck:
            report.failures.append(
                f"quiesce never drained pending state for {stuck}")
    harness.sidecar.sync()
    _check_convergence(report, harness, writers, beta)
    # broker leg convergence: every successfully produced op sequenced
    # exactly once (redelivery duplicates absorbed by the csn dedupe)
    bops = [m.client_sequence_number
            for m in broker.orderer("chaos-broker").op_log.read(0)
            if m.type == MessageType.OPERATION]
    if bops != list(range(1, broker_csn + 1)):
        report.failures.append(
            f"broker leg diverged: sequenced csns {bops} != "
            f"1..{broker_csn}")
    report.broker_ops = broker_csn
    report.crashes = harness.crashes
    report.failovers = harness.failovers
    if harness.group is not None:
        report.repl_lag_max = harness.group.max_lag_observed
        # the fleet-obs differential surface: timeline sequence +
        # federated counter totals, bit-identical per seed (both
        # ride the step clock and the per-node registries)
        report.timeline_events = \
            harness.timeline.deterministic_events()
        report.fleet_counters = harness.fleet.counter_totals()
        # fence counters live on the per-NODE registries now (the
        # double-count fix), so the report reads them from the
        # federated totals instead of the process-wide delta
        report.fenced_writes = int(report.fleet_counters.get(
            "sequencer_fenced_writes_total", 0))
        # netsplit surface: topology transitions from the replayable
        # PLANE.fired log, unavailability/lifecycle from the
        # federated per-node counters — all step-clock deterministic
        report.partitions = sum(
            1 for site, _, _ in PLANE.fired
            if site == "repl.partition")
        report.heals = sum(
            1 for site, _, _ in PLANE.fired if site == "repl.heal")
        report.unavailable_nacks = int(report.fleet_counters.get(
            "repl_unavailable_nacks_total", 0))
        report.degraded_s = round(float(report.fleet_counters.get(
            "repl_degraded_seconds_total", 0.0)), 6)
        report.rejoins = int(report.fleet_counters.get(
            "repl_rejoin_total", 0))
    report.acked_ops = acked_box[0]
    # PLANE.fired is reset by arm(): an unarmed (oracle) run must
    # report [] — not whatever sequence a PREVIOUS armed run left
    # behind in the process-wide plane
    report.fired = list(PLANE.fired) if faults else []
    for c in all_containers:
        c.close()


def _alive(c: Container) -> bool:
    return c.connected


def _note_down(containers, down_until: dict, i: int, step: int,
               rng: random.Random) -> None:
    """A client whose transport died schedules its reconnect 1-3
    steps out (the jittered-backoff shape, on the step clock)."""
    if i not in down_until and not containers[i].connected:
        down_until[i] = step + 1 + rng.randrange(3)


def _retriable_refusal(e: Exception) -> bool:
    """Is this exception the degraded/deposed plane refusing a
    client, as a real driver would see it? The chaos transport
    reconstructs server-side errors as plain RuntimeError/
    PermissionError from the error frame TEXT, so the typed
    exceptions are not catchable here — match the refusal wording
    instead (narrow on purpose: an unrelated RuntimeError in the
    same code path must stay LOUD, or the differential would absorb
    real bugs as reschedules)."""
    if isinstance(e, ConnectionError):
        return True  # transport died mid-refusal: retriable
    text = str(e)
    return ("quorum unavailable" in text
            or "epoch fence" in text
            or "connect_document rejected" in text)


def _connect_maybe(c: Container, report, guarded: bool = False) -> bool:
    """Reconnect a client; ``guarded`` (netsplit runs) absorbs a
    RETRIABLE refusal — the degraded window refuses the reconnect's
    JOIN with the unavailable error, exactly as a real driver would
    see it, and the harness retries on its jittered schedule. Outside
    a netsplit run a refused connect stays LOUD."""
    try:
        c.connect()
    except (PermissionError, ConnectionError, RuntimeError) as e:
        if not guarded or not _retriable_refusal(e):
            raise
        return False
    if hasattr(report, "reconnects"):  # the storm report has none
        report.reconnects += 1
    return True


def _safe_flush(c: Container, containers, down_until, i, step,
                rng, guarded: bool = False) -> None:
    try:
        c.flush()
    except (PermissionError, ConnectionError, RuntimeError) as e:
        # flush()'s own reconnect-after-nack ran into the degraded
        # window's join refusal: pending edits stay pending, the
        # client stays down and the harness reschedules it
        if not guarded or not _retriable_refusal(e):
            raise
    if not c.connected:
        _note_down(containers, down_until, i, step, rng)


def _check_convergence(report: ChaosReport, harness: ChaosHarness,
                       writers: list[Container],
                       beta: Container) -> None:
    fail = report.failures.append

    def chan(c: Container, name: str):
        return c.runtime.get_datastore("app").get_channel(name)

    # 1. replica agreement on alpha (text, signature, kv)
    texts = [chan(c, "text").get_text() for c in writers]
    sigs = [repr(chan(c, "text").signature()) for c in writers]
    kvs = [repr(sorted(chan(c, "kv").items())) for c in writers]
    if len(set(texts)) != 1 or len(set(sigs)) != 1:
        fail(f"alpha text/signature divergence: {texts} {sigs}")
    if len(set(kvs)) != 1:
        fail(f"alpha kv divergence: {kvs}")
    report.alpha_text = texts[0]
    report.alpha_kv = kvs[0]
    report.beta_text = chan(beta, "text").get_text()

    # 2. late joiner: a FRESH replica loaded from the service (summary
    # + trailing ops) must agree — the full storage-plane round trip
    late = Container.load(
        harness.service_for(DOC_ALPHA, "alpha-late"),
        client_id="client-late")
    if chan(late, "text").get_text() != texts[0]:
        fail("late-joining replica diverged from live replicas")
    if repr(sorted(chan(late, "kv").items())) != kvs[0]:
        fail("late-joining replica kv diverged")
    late.close()

    # 3. exactly-once edits: every serial marker present in the
    # converged text appears exactly once (a double-applied op would
    # repeat one), and the quiesce loop above already drove every
    # submitted marker to acked (nothing pending/in-flight) — so a
    # LOST acked op surfaces as the oracle-equality failure in the
    # test layer, and a duplicated one fails right here
    import re

    for haystack in (texts[0], report.beta_text):
        for marker in re.findall(r"[abcw]\d{3}\.", haystack):
            if haystack.count(marker) != 1:
                fail(f"marker {marker!r} applied "
                     f"{haystack.count(marker)} times")

    # 4. the sidecar's served state: text equals the single-writer
    # replica's, and a SHADOW sidecar rebuilt from the durable op log
    # must serve the identical text+signature (live ≡ rebuilt — the
    # crash-recovery equivalence, checked on every run)
    side_text = harness.sidecar.text(DOC_BETA, "app", "text")
    if side_text != report.beta_text:
        fail(f"sidecar text diverged from the beta replica: "
             f"{side_text!r} != {report.beta_text!r}")
    shadow = _shadow_sidecar(harness)
    shadow_text = shadow.text(DOC_BETA, "app", "text")
    shadow_sig = shadow.signature(DOC_BETA, "app", "text")
    live_sig = harness.sidecar.signature(DOC_BETA, "app", "text")
    if shadow_text != side_text or shadow_sig != live_sig:
        fail("rebuilt-from-op-log sidecar diverged from the live one")

    # 5. exactly-once pool watermarks: every pooled member's watermark
    # sits exactly at its stream head (nothing pending, nothing
    # double-counted)
    sc = harness.sidecar
    report.sidecar_tier = (
        "host" if sc.host_mode_docs() else
        "pool" if sc.pooled_docs() else "primary")
    if sc._pool is not None:
        for slot, upto in sc._pool.applied_upto.items():
            want = len(sc._streams[slot].ops)
            report.pool_watermarks[str(slot)] = upto
            if upto != want:
                fail(f"pool watermark slot {slot}: {upto} != {want}")


def _merge_sidecar(device: str, breaker=None):
    """The harness's merge sidecar on ``device``: the tiny ladder
    (capacity 16 -> 32) over a one-device seq pool of 128 slots."""
    import torch

    from ..parallel import make_seq_mesh
    from ..service.gpu_sidecar import GpuMergeSidecar

    return GpuMergeSidecar(
        max_docs=4,
        capacity=ChaosHarness.SIDECAR_CAPACITY,
        max_capacity=ChaosHarness.SIDECAR_MAX_CAPACITY,
        seq_mesh=make_seq_mesh([torch.device(device)]),
        pool_capacity=ChaosHarness.SIDECAR_POOL_CAPACITY,
        device=device,
        breaker=breaker,
    )


def _shadow_sidecar(harness: ChaosHarness):
    """A fresh sidecar fed the durable op log from scratch — what a
    crash-restart would serve."""
    shadow = _merge_sidecar(harness.device)
    shadow.track(DOC_BETA, "app", "text")
    for msg in harness.server.local.read_ops(DOC_BETA, 0):
        shadow.ingest(DOC_BETA, msg)
    shadow.apply()
    shadow.sync()
    return shadow


# ======================================================================
# chaos storm (tools/stress --chaos, bench config11): goodput dip +
# recovery time on the step clock


@dataclass
class ChaosStormReport:
    seed: int
    steps: int = 0
    storm_steps: tuple = ()
    offered_ops: int = 0
    acked_ops: int = 0
    goodput_steady: float = 1.0
    goodput_dip: float = 1.0        # worst rolling acked/offered
    recovery_steps: Optional[int] = None
    recovery_time_s: Optional[float] = None
    converged: bool = False
    failures: list = field(default_factory=list)
    chaos_counts: dict = field(default_factory=dict)
    fired: int = 0
    metrics_delta: dict = field(default_factory=dict)
    # kill-the-leader leg (replicated plane; --kill-leader / config12)
    kill_leader_step: Optional[int] = None
    failover_time_s: Optional[float] = None
    failovers: int = 0
    repl_lag_max: int = 0
    # the causal decomposition of failover_time_s (detection /
    # anti-entropy / promotion / first-ack — obs/timeline.py) and the
    # federated fleet snapshot: both step-clock deterministic, both
    # asserted bit-equal across config12's x2 storm runs
    failover_phases: Optional[dict] = None
    fleet_metrics: dict = field(default_factory=dict)
    # netsplit leg (--netsplit / config13): the leader loses its
    # quorum mid-storm and must NACK, not hang — unavailability_s is
    # the degraded window (degraded_enter -> degraded_exit on the
    # step clock) and degraded_read_s runs until the first post-heal
    # ack lands (reads were clamped at the stale committed watermark
    # for that whole span)
    netsplit_window: Optional[tuple] = None
    unavailability_s: Optional[float] = None
    degraded_read_s: Optional[float] = None
    unavailable_nacks: int = 0

    def deterministic_fields(self) -> dict:
        return {
            "offered_ops": self.offered_ops,
            "acked_ops": self.acked_ops,
            "goodput_dip": round(self.goodput_dip, 6),
            "recovery_steps": self.recovery_steps,
            "fired": self.fired,
            "converged": self.converged,
            "kill_leader_step": self.kill_leader_step,
            "failover_time_s": self.failover_time_s,
            "failovers": self.failovers,
            "repl_lag_max": self.repl_lag_max,
            "failover_phases": dict(self.failover_phases or {}),
            "fleet_metrics": dict(self.fleet_metrics),
            "netsplit_window": self.netsplit_window,
            "unavailability_s": self.unavailability_s,
            "degraded_read_s": self.degraded_read_s,
            "unavailable_nacks": self.unavailable_nacks,
        }


def run_chaos_storm(seed: int = 0, steps: int = 120,
                    storm: tuple[int, int] = (40, 80),
                    window: int = 8, slo_target: float = 0.95,
                    sites: Optional[list[str]] = None,
                    kill_leader_step: Optional[int] = None,
                    netsplit: Optional[tuple[int, int]] = None,
                    device: str = "cuda") -> ChaosStormReport:
    """Three phases on one step clock: steady (faults off), STORM
    (the standard schedule armed), recovery (faults off again).
    Goodput = rolling acked/offered over ``window`` steps; the dip is
    its minimum from storm start on, and recovery time is how many
    steps past storm end it takes to hold the ``slo_target`` floor
    again for ``window`` consecutive steps. Deterministic per seed on
    the step clock (wall time never enters the numbers).

    ``kill_leader_step`` runs the storm over the REPLICATED plane and
    kills the leader at that step (mid-storm is the interesting
    window): ``failover_time_s`` = step clock from the kill to the
    first post-failover ack, reported next to ``goodput_dip`` —
    bench config12's headline number. It is measured off the fleet
    timeline (leader_kill -> first_ack on the step clock, so the
    lease-TTL detection window is INCLUDED) and decomposed
    into ``failover_phases`` (detection / anti-entropy /
    promotion / first-ack, summing to failover_time_s exactly);
    ``fleet_metrics`` carries the federated per-node snapshot.

    ``netsplit=(lo, hi)`` instead runs the storm over the replicated
    plane and partitions the LEADER away from both followers (lease
    service staying with the leader: no election, pure quorum loss)
    for that step window: writes nack retriable-unavailable for the
    whole split — the plane must brown out, not hang — and the
    report carries ``unavailability_s`` (the degraded window) and
    ``degraded_read_s`` (until the first post-heal ack) next to
    ``goodput_dip``, bench config13's headline numbers."""
    import re
    import tempfile

    if kill_leader_step is not None and not (
            0 <= kill_leader_step < steps):
        # an out-of-range kill step would silently never fire while
        # the measurement guard (step >= kill_leader_step) fabricates
        # a failover_time_s — refuse loudly instead
        raise ValueError(
            f"kill_leader_step {kill_leader_step} outside the run's "
            f"step range [0, {steps})")
    if netsplit is not None:
        if kill_leader_step is not None:
            raise ValueError(
                "--netsplit and --kill-leader are separate storm "
                "modes; run them as separate storms")
        lo_hi_ok = 0 <= netsplit[0] < netsplit[1] < steps
        if not lo_hi_ok:
            raise ValueError(
                f"netsplit window {netsplit} outside the run's step "
                f"range [0, {steps}) or empty")
    report = ChaosStormReport(
        seed=seed, steps=steps, storm_steps=storm,
        kill_leader_step=kill_leader_step,
        netsplit_window=tuple(netsplit) if netsplit else None)
    before = obs_metrics.REGISTRY.flat()
    durable = tempfile.mkdtemp(prefix="fftpu-chaos-storm-")
    harness = ChaosHarness(
        durable,
        replicated=kill_leader_step is not None
        or netsplit is not None, device=device)
    wl = random.Random(4242)
    schedule = standard_schedule(seed, sites)
    reconnect_rng = schedule.rng_for("reconnect")
    try:
        writers: list[Container] = []
        for i, tag in enumerate(_ALPHA_TAGS):
            writers.append(harness.load_container(
                DOC_ALPHA, f"alpha-{tag}", f"client-{tag}"))
        ds = writers[0].runtime.create_datastore("app")
        ds.create_channel("sharedstring", "text")
        ds.create_channel("sharedmap", "kv")
        writers[0].runtime.get_datastore("app").get_channel(
            "text").insert_text(0, "[A][B][C][Z]")
        writers[0].flush()
        harness.pump()

        serials = [0, 0, 0]
        down_until: dict[int, int] = {}
        # acked = own OPERATION msgs seen sequenced, counted off the
        # 'processed' event: monotone across reconnect epochs (csn
        # resets per connection, so csn arithmetic can't be)
        acked_total = [0, 0, 0]
        acked_prev = 0

        def _count_acks(idx: int):
            from ..protocol.messages import MessageType as _MT

            def on_processed(msg) -> None:
                if (msg.type == _MT.OPERATION
                        and msg.client_id == writers[idx].client_id):
                    acked_total[idx] += 1
            return on_processed

        for i in range(len(writers)):
            writers[i].on("processed", _count_acks(i))
        rolling: list[tuple[int, int]] = []
        post_storm_ok = 0
        storm_lo, storm_hi = storm
        first_post_heal_ack_t: Optional[float] = None
        for step in range(steps):
            harness.clock.t += 0.05
            if step == storm_lo:
                PLANE.arm(schedule)
            if step == storm_hi:
                PLANE.disarm()
            if kill_leader_step is not None \
                    and step == kill_leader_step:
                # zero-downtime host loss, measured: the leader dies
                # mid-storm; a follower promotes at the replicated
                # head; writers reconnect and the step clock from
                # kill to first post-failover ack is failover_time_s
                harness.kill_leader("clean")
            if netsplit is not None and step == netsplit[0]:
                # quorum loss, measured: the leader alone (lease on
                # ITS side — no election, pure brownout); every
                # write until the heal must nack, not hang
                harness.network.partition(
                    [["node-0"], ["node-1", "node-2"]],
                    lease_island=0)
            if netsplit is not None and step == netsplit[1]:
                harness.network.heal()
            for i, when in list(down_until.items()):
                if step >= when:
                    del down_until[i]
                    c = writers[i]
                    if not c.connected and not c.closed:
                        if not _connect_maybe(
                                c, report,
                                guarded=netsplit is not None):
                            down_until[i] = step + 1 + \
                                reconnect_rng.randrange(3)
            offered = 0
            acked = 0
            for i, c in enumerate(writers):
                if i in down_until or not c.connected:
                    _note_down(writers, down_until, i, step,
                               reconnect_rng)
                    continue
                serials[i] += 1
                offered += 1
                _region_edit(c, _ALPHA_TAGS[i], serials[i], wl)
                _safe_flush(c, writers, down_until, i, step,
                            reconnect_rng,
                            guarded=netsplit is not None)
            harness.pump()
            acked = sum(acked_total) - acked_prev
            acked_prev = sum(acked_total)
            if (netsplit is not None and step >= netsplit[1]
                    and acked and first_post_heal_ack_t is None):
                first_post_heal_ack_t = harness.clock.t
            if (kill_leader_step is not None
                    and step >= kill_leader_step
                    and report.failover_time_s is None and acked):
                harness.timeline.record(
                    "first_ack", node=harness.group.leader_id,
                    step=step)
                phases = harness.timeline.failover_phases()
                assert phases is not None, (
                    "first ack landed but the timeline has no "
                    "complete kill->promotion chain")
                report.failover_phases = phases
                report.failover_time_s = round(phases["total_s"], 6)
            report.offered_ops += offered
            report.acked_ops += acked
            rolling.append((offered, acked))
            if len(rolling) > window:
                rolling.pop(0)
            off = sum(o for o, _ in rolling)
            ack = sum(a for _, a in rolling)
            ratio = (ack / off) if off else 1.0
            if step < storm_lo:
                report.goodput_steady = min(report.goodput_steady,
                                            ratio)
            else:
                report.goodput_dip = min(report.goodput_dip, ratio)
            if step >= storm_hi and report.recovery_steps is None:
                if ratio >= slo_target:
                    post_storm_ok += 1
                    if post_storm_ok >= window:
                        report.recovery_steps = (
                            step - storm_hi - window + 1)
                        report.recovery_time_s = (
                            report.recovery_steps * 0.05)
                else:
                    post_storm_ok = 0
        # quiesce + convergence (agreement only: the storm harness has
        # no oracle run — the differential in tests/test_chaos.py is
        # where oracle equality lives)
        if PLANE.armed:
            PLANE.disarm()
        for _ in range(10):
            for c in writers:
                if not c.connected and not c.closed:
                    c.connect()
                c.flush()
            harness.pump()
            if all(c.runtime.pending.count == 0 and not c._sent_times
                   for c in writers):
                break
        texts = [c.runtime.get_datastore("app").get_channel(
            "text").get_text() for c in writers]
        if len(set(texts)) != 1:
            report.failures.append(f"storm divergence: {texts}")
        else:
            final = texts[0]
            for marker in re.findall(r"[abc]\d{3}\.", final):
                if final.count(marker) != 1:
                    report.failures.append(
                        f"marker {marker!r} x{final.count(marker)}")
        report.converged = not report.failures
        report.failovers = harness.failovers
        if harness.group is not None:
            report.repl_lag_max = harness.group.max_lag_observed
            report.fleet_metrics = harness.fleet.refresh()
            if kill_leader_step is not None \
                    and report.failover_time_s is None:
                report.failures.append(
                    "no ack ever landed after the leader kill — "
                    "failover never completed")
                report.converged = False
            if netsplit is not None:
                # the netsplit leg's headline numbers, off the fleet
                # timeline (all step-clock): unavailability_s = the
                # degraded window; degraded_read_s = degraded_enter
                # until the first post-heal ack (reads were clamped
                # at the stale committed watermark the whole span)
                enters = [e for e in harness.timeline.events()
                          if e.kind == "degraded_enter"]
                exits = [e for e in harness.timeline.events()
                         if e.kind == "degraded_exit"]
                if not enters or not exits:
                    report.failures.append(
                        "netsplit window never entered/exited "
                        "degraded mode — the split tested nothing")
                    report.converged = False
                else:
                    report.unavailability_s = round(sum(
                        x.t - e.t for e, x in zip(enters, exits)), 6)
                    if first_post_heal_ack_t is None:
                        report.failures.append(
                            "no ack ever landed after the heal")
                        report.converged = False
                    else:
                        report.degraded_read_s = round(
                            first_post_heal_ack_t - enters[0].t, 6)
                totals = harness.fleet.counter_totals()
                report.unavailable_nacks = int(totals.get(
                    "repl_unavailable_nacks_total", 0))
                if report.unavailable_nacks == 0:
                    report.failures.append(
                        "netsplit fired no unavailable nacks")
                    report.converged = False
        # arm() reset PLANE.fired at storm start, so the count is
        # this storm's own; a run whose window never armed reports 0
        report.fired = len(PLANE.fired) if steps > storm_lo else 0
        for c in writers:
            c.close()
    finally:
        if PLANE.armed:
            PLANE.disarm()
        shutil.rmtree(durable, ignore_errors=True)
    delta = obs_metrics.REGISTRY.delta(before)
    report.chaos_counts = {
        k: int(v) for k, v in sorted(delta.items())
        if k.startswith("chaos_injected_total")
    }
    report.metrics_delta = delta
    return report
