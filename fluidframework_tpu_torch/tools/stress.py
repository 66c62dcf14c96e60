"""Stress/load runner with fault injection, plus the OVERLOAD mode.

Reference: packages/test/test-service-load — multi-client load runner
(src/runner.ts, nodeStressTest.ts) with a config (testConfigFile.ts),
randomized op mixes (optionsMatrix.ts) and fault-injection wrappers.

Seeded and deterministic: the same config always produces the same
op/fault schedule, so stress failures reproduce (stochastic-test-utils
discipline, SURVEY §4.2).

``--overload N`` (:func:`run_overload`) is the qos acceptance
harness: it offers N x the configured admission capacity of mixed
writer / slow-reader / summary traffic through the REAL ingress
dispatch path — driven directly and under a MANUAL clock, so the
whole overload scenario is deterministic (no sockets, no event loop,
no timing races) — and reports goodput, shed counts per class, peak
outbound depth and the registry delta. bench.py config8 sweeps it
over offered-load multiples with the throttler on vs off.
"""
from __future__ import annotations

import json as _json
import random
from dataclasses import dataclass, field
from typing import Optional

from ..drivers.local_driver import LocalDocumentServiceFactory
from ..loader.container import Container
from ..obs import metrics as obs_metrics
from ..qos import (
    AdmissionController,
    Budget,
    PressureMonitor,
    RateLimits,
)
from ..service.ingress import AlfredServer, _ClientSession
from ..service.local_server import LocalServer
from ..testing.chaos import ManualClock as _ManualClock
from ..testing.fault_injection import FaultInjectionDocumentService


@dataclass
class StressConfig:
    """testConfigFile.ts shape."""

    n_clients: int = 4
    n_steps: int = 400
    seed: int = 0
    document_id: str = "stress-doc"
    # op mix weights
    w_map_set: int = 4
    w_string_insert: int = 4
    w_string_remove: int = 2
    w_flush: int = 6
    # fault schedule: probability per step of injecting each fault
    p_disconnect: float = 0.01
    p_nack: float = 0.01
    reconnect_after: int = 10  # steps a victim stays down


@dataclass
class StressReport:
    steps: int = 0
    ops_submitted: int = 0
    disconnects_injected: int = 0
    nacks_injected: int = 0
    reconnects: int = 0
    converged: bool = False
    final_text: str = ""
    errors: list[str] = field(default_factory=list)
    # what the run moved in the unified metrics registry (nonzero
    # deltas of the flat view — ops, nacks, roundtrip histograms...)
    metrics_delta: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.converged and not self.errors


def run_stress(config: Optional[StressConfig] = None) -> StressReport:
    cfg = config or StressConfig()
    rng = random.Random(cfg.seed)
    report = StressReport()
    metrics_before = obs_metrics.REGISTRY.flat()

    server = LocalServer()
    factory = LocalDocumentServiceFactory(server)
    services = []
    containers: list[Container] = []
    down_until: dict[int, int] = {}  # client index -> step to reconnect

    for i in range(cfg.n_clients):
        svc = FaultInjectionDocumentService(
            factory.create_document_service(cfg.document_id)
        )
        services.append(svc)
        c = Container.load(svc, client_id=f"client-{i}")
        containers.append(c)
    ds = containers[0].runtime.create_datastore("app")
    ds.create_channel("sharedmap", "kv")
    ds.create_channel("sharedstring", "text")
    containers[0].flush()

    def chan(i: int, name: str):
        return containers[i].runtime.get_datastore("app").get_channel(name)

    actions = (
        ["map_set"] * cfg.w_map_set
        + ["string_insert"] * cfg.w_string_insert
        + ["string_remove"] * cfg.w_string_remove
        + ["flush"] * cfg.w_flush
    )

    for step in range(cfg.n_steps):
        report.steps = step + 1
        # scheduled reconnects
        for i, when in list(down_until.items()):
            if step >= when:
                del down_until[i]
                containers[i].connect()
                report.reconnects += 1
        # faults
        if rng.random() < cfg.p_disconnect:
            victims = [
                i for i in range(cfg.n_clients) if i not in down_until
            ]
            if len(victims) > 1:  # keep at least one client alive
                i = rng.choice(victims)
                containers[i].disconnect()
                down_until[i] = step + cfg.reconnect_after
                report.disconnects_injected += 1
        if rng.random() < cfg.p_nack:
            i = rng.randrange(cfg.n_clients)
            if services[i].live_connections:
                services[i].live_connections[-1].inject_nacks(1)
                report.nacks_injected += 1

        # a random client acts (offline clients edit too: their ops
        # enter pending state and replay on reconnect)
        i = rng.randrange(cfg.n_clients)
        action = rng.choice(actions)
        try:
            if action == "map_set":
                chan(i, "kv").set(
                    f"k{rng.randrange(20)}", rng.randrange(1000)
                )
                report.ops_submitted += 1
            elif action == "string_insert":
                text = chan(i, "text")
                pos = rng.randrange(text.get_length() + 1)
                text.insert_text(pos, rng.choice("abcdefgh") * 2)
                report.ops_submitted += 1
            elif action == "string_remove":
                text = chan(i, "text")
                length = text.get_length()
                if length > 2:
                    start = rng.randrange(length - 1)
                    end = min(length, start + rng.randrange(1, 4))
                    text.remove_text(start, end)
                    report.ops_submitted += 1
            elif action == "flush":
                containers[i].flush()
        except Exception as exc:  # noqa: BLE001 - stress harness boundary
            report.errors.append(f"step {step} {action}: {exc!r}")
            break

    # drain: reconnect everyone, flush everything
    for i in list(down_until):
        containers[i].connect()
        report.reconnects += 1
    for c in containers:
        c.flush()
    for c in containers:
        c.flush()  # second pass: resubmitted pending ops

    texts = {c.client_id: (
        c.runtime.get_datastore("app").get_channel("text").get_text()
    ) for c in containers}
    sigs = {c.client_id: repr(
        c.runtime.get_datastore("app").get_channel("text").signature()
    ) for c in containers}
    kvs = {c.client_id: repr(sorted(
        c.runtime.get_datastore("app").get_channel("kv").items()
    )) for c in containers}
    report.converged = (
        len(set(sigs.values())) == 1 and len(set(kvs.values())) == 1
    )
    if not report.converged:
        report.errors.append(f"divergence: texts={texts}")
    report.final_text = next(iter(texts.values()))
    report.metrics_delta = obs_metrics.REGISTRY.delta(metrics_before)
    return report


# ======================================================================
# overload mode: N x capacity through the admission gate


@dataclass
class OverloadConfig:
    """One deterministic overload scenario. All times are SIMULATED
    seconds on a manual clock."""

    offered_multiple: float = 10.0     # offered / capacity
    capacity_ops_per_s: float = 200.0  # the per-document op budget
    duration_s: float = 4.0
    tick_s: float = 0.05
    n_writers: int = 4
    n_readers: int = 2                 # slow consumers: never drain
    summary_every_s: float = 0.5
    read_ops_every_s: float = 0.2
    throttle: bool = True              # False = unprotected baseline
    outbound_depth: int = 600          # per-session hard limit
    outbound_soft: int = 510           # fanout-drop threshold
    document_id: str = "overload-doc"


@dataclass
class OverloadReport:
    offered_ops: int = 0
    admitted_ops: int = 0       # writer ops the gate let through
    acked_ops: int = 0          # ... seen back sequenced (goodput)
    throttle_nacks: int = 0
    goodput_ops_per_s: float = 0.0
    shed: dict = field(default_factory=dict)  # class -> count
    outbound_dropped: int = 0
    slow_disconnects: int = 0
    peak_outbound_depth: int = 0
    max_pressure_tier: int = 0
    metrics_delta: dict = field(default_factory=dict)

    @property
    def live(self) -> bool:
        """Did the service survive: every offered frame dispatched
        without an unhandled fault, memory bounded."""
        return True  # run_overload raises otherwise


# (the manual clock both overload modes inject lives with the chaos
# harness now — ONE owner; see the import block up top. serve_bench
# keeps importing `_ManualClock` from here.)


class _ScriptedWriter:
    """One write client driven frame-by-frame: submits with correct
    csn bookkeeping (a shed op retries with the SAME csn — the
    sequencer's contiguity check must never see a gap), drains its
    outbound synchronously, and counts acks/nacks."""

    def __init__(self, server: AlfredServer, doc: str, name: str):
        self.server = server
        self.doc = doc
        self.name = name
        self.session = _ClientSession(server, None)
        server._sessions.add(self.session)
        self.csn = 0
        self.acked = 0
        self.nacked = 0
        self.carry = 0.0
        server._dispatch(self.session, {
            "type": "connect_document", "document_id": doc,
            "client_id": name, "versions": ["1.2", "1.1", "1.0"],
        })

    def _drain(self) -> bool:
        """Consume queued outbound frames; True if a throttle nack
        arrived (synchronous with the shed submit)."""
        throttled = False
        q = self.session.outbound
        while not q.empty():
            raw = q.get_nowait()
            if raw is None:
                continue
            frame = _json.loads(raw[4:])
            if frame.get("type") == "op":
                msg = frame.get("msg") or {}
                if msg.get("clientId") == self.name:
                    self.acked += 1
            elif frame.get("type") == "nack":
                self.nacked += 1
                throttled = True
        return throttled

    def offer(self, n_ops: int, nbytes_each: int = 96,
              op_type: int = 2, contents: object = None) -> None:
        for _ in range(n_ops):
            attempt = self.csn + 1
            self.server._dispatch(self.session, {
                "type": "submitOp", "document_id": self.doc,
                "op": {
                    "client_sequence_number": attempt,
                    "reference_sequence_number": 0,
                    "type": op_type,
                    "contents": contents
                    if contents is not None else {"k": "v"},
                    "metadata": None, "traces": [],
                },
            }, nbytes_each)
            if not self._drain():
                self.csn = attempt


def run_overload(config: Optional[OverloadConfig] = None
                 ) -> OverloadReport:
    cfg = config or OverloadConfig()
    report = OverloadReport()
    before = obs_metrics.REGISTRY.flat()
    clock = _ManualClock()

    qos = None
    pressure = None
    if cfg.throttle:
        pressure = PressureMonitor(clock=clock)
        cap = cfg.capacity_ops_per_s
        qos = AdmissionController(
            limits=RateLimits(
                document_ops=Budget(cap),
                tenant_ops=Budget(cap * 4),
                connection_bytes=Budget(cap * 256),
                summary_uploads=Budget(2.0, burst=2.0),
                summary_bytes=Budget(1 << 20),
                catchup_reads=Budget(10.0, burst=10.0),
            ),
            pressure=pressure, clock=clock,
        )
    server = AlfredServer(
        qos=qos,
        max_outbound_depth=cfg.outbound_depth,
        outbound_drop_threshold=cfg.outbound_soft,
    )

    writers = [
        _ScriptedWriter(server, cfg.document_id, f"writer-{i}")
        for i in range(cfg.n_writers)
    ]
    readers = []
    for i in range(cfg.n_readers):
        s = _ClientSession(server, None)
        server._sessions.add(s)
        server._dispatch(s, {
            "type": "connect_document",
            "document_id": cfg.document_id,
            "client_id": f"reader-{i}", "mode": "read",
            "versions": ["1.2", "1.1", "1.0"],
        })
        readers.append(s)
    summarizer = _ScriptedWriter(
        server, cfg.document_id, "summarizer"
    )

    offered_rate = cfg.offered_multiple * cfg.capacity_ops_per_s
    per_writer = offered_rate * cfg.tick_s / cfg.n_writers
    ticks = int(cfg.duration_s / cfg.tick_s)
    rid = 0
    next_summary = 0.0
    next_read = 0.0
    for _tick in range(ticks):
        clock.t += cfg.tick_s
        for w in writers:
            w.carry += per_writer
            n = int(w.carry)
            w.carry -= n
            report.offered_ops += n
            w.offer(n)
        if clock.t >= next_read:
            next_read = clock.t + cfg.read_ops_every_s
            for s in readers:
                rid += 1
                server._dispatch(s, {
                    "type": "read_ops",
                    "document_id": cfg.document_id,
                    "from_seq": 0, "rid": rid,
                })
        if clock.t >= next_summary:
            next_summary = clock.t + cfg.summary_every_s
            # SUMMARIZE proposals classify as summary traffic — the
            # first class the policy sheds under pressure
            summarizer.offer(1, nbytes_each=2048, op_type=7,
                             contents={"summary": {}})
        report.peak_outbound_depth = max(
            report.peak_outbound_depth,
            max(s.outbound.qsize() for s in server._sessions),
        )
        if pressure is not None:
            report.max_pressure_tier = max(
                report.max_pressure_tier, pressure.sample().tier,
            )

    report.acked_ops = sum(w.acked for w in writers)
    report.throttle_nacks = sum(w.nacked for w in writers)
    report.admitted_ops = sum(w.csn for w in writers)
    report.goodput_ops_per_s = report.acked_ops / cfg.duration_s
    delta = obs_metrics.REGISTRY.delta(before)
    report.metrics_delta = delta
    for klass in ("write", "catchup", "summary"):
        report.shed[klass] = sum(
            int(v) for k, v in delta.items()
            if k.startswith("qos_shed_total")
            and f'klass="{klass}"' in k
        )
    report.outbound_dropped = int(delta.get(
        "ingress_outbound_dropped_total", 0))
    report.slow_disconnects = int(delta.get(
        "ingress_slow_consumer_disconnects_total", 0))
    return report


def main(argv: Optional[list[str]] = None) -> int:  # pragma: no cover
    import argparse
    import json

    parser = argparse.ArgumentParser(description="stress runner")
    parser.add_argument("--clients", type=int, default=4)
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--overload", type=float, default=None,
                        metavar="N",
                        help="offer N x the admission capacity of "
                             "mixed writer/reader/summary traffic "
                             "through the qos gate (deterministic; "
                             "reports goodput/shed/metrics_delta)")
    parser.add_argument("--no-throttle", action="store_true",
                        help="with --overload: run the unprotected "
                             "baseline (no admission control)")
    parser.add_argument("--chaos", type=int, default=None,
                        metavar="SEED",
                        help="run the seeded chaos storm "
                             "(testing/chaos.py): steady -> fault "
                             "storm at every registered seam -> "
                             "recovery; reports goodput dip, "
                             "recovery time and chaos_injected "
                             "counts, deterministic per seed")
    parser.add_argument("--sites", default=None,
                        help="with --chaos: comma-separated site "
                             "subset (e.g. socket.frame_in,"
                             "sidecar.dispatch)")
    parser.add_argument("--chaos-steps", type=int, default=120)
    parser.add_argument("--chaos-storm", type=int, nargs=2,
                        default=(40, 80), metavar=("LO", "HI"),
                        help="storm window [LO, HI) in steps")
    parser.add_argument("--sidecar-device", default="cuda",
                        help="the chaos harness's merge sidecar device "
                             "(default cuda; cpu runs the plain "
                             "version)")
    parser.add_argument("--kill-leader", type=int, nargs="?",
                        const=-1, default=None, metavar="STEP",
                        help="with --chaos: run the storm over the "
                             "REPLICATED sequencer plane and kill "
                             "the leader at STEP (default: "
                             "mid-storm); reports failover_time_s "
                             "and repl_lag_max next to goodput_dip "
                             "— a failing failover seed reproduces "
                             "from this CLI alone")
    parser.add_argument("--netsplit", type=int, default=None,
                        metavar="SEED",
                        help="run the seeded storm over the "
                             "REPLICATED plane with the leader "
                             "partitioned away from its quorum for "
                             "the middle half of the storm window: "
                             "writes must nack retriable-"
                             "unavailable, never hang; reports "
                             "unavailability_s and degraded_read_s "
                             "next to goodput_dip and the chaos "
                             "counts — a failing netsplit seed "
                             "reproduces from this CLI alone")
    args = parser.parse_args(argv)
    if args.kill_leader is not None and args.chaos is None:
        parser.error("--kill-leader requires --chaos SEED")
    if args.netsplit is not None and args.kill_leader is not None:
        parser.error("--netsplit and --kill-leader are separate "
                     "storm modes; run them as separate storms")
    if args.netsplit is not None and args.chaos is not None:
        parser.error("--netsplit runs its own seeded storm; drop "
                     "--chaos (the --netsplit value IS the seed)")
    if args.chaos is not None or args.netsplit is not None:
        from ..testing.chaos import run_chaos_storm

        kill_step = args.kill_leader
        if kill_step == -1:
            kill_step = sum(args.chaos_storm) // 2  # mid-storm
        if kill_step is not None and not (
                0 <= kill_step < args.chaos_steps):
            parser.error(
                f"--kill-leader {kill_step} outside the step range "
                f"[0, {args.chaos_steps})")
        netsplit_window = None
        if args.netsplit is not None:
            lo, hi = args.chaos_storm
            quarter = max(1, (hi - lo) // 4)
            netsplit_window = (lo + quarter, hi - quarter)
            if not (0 <= netsplit_window[0] < netsplit_window[1]
                    < args.chaos_steps):
                parser.error(
                    f"netsplit window {netsplit_window} (middle "
                    f"half of the storm {args.chaos_storm}) falls "
                    f"outside the step range [0, {args.chaos_steps})")
        report = run_chaos_storm(
            seed=args.chaos if args.chaos is not None
            else args.netsplit,
            steps=args.chaos_steps,
            storm=tuple(args.chaos_storm),
            sites=args.sites.split(",") if args.sites else None,
            kill_leader_step=kill_step,
            netsplit=netsplit_window,
            device=args.sidecar_device,
        )
        print(json.dumps({
            "seed": report.seed,
            "steps": report.steps,
            "storm_steps": list(report.storm_steps),
            "offered_ops": report.offered_ops,
            "acked_ops": report.acked_ops,
            "goodput_steady": round(report.goodput_steady, 4),
            "goodput_dip": round(report.goodput_dip, 4),
            "recovery_steps": report.recovery_steps,
            "recovery_time_s": report.recovery_time_s,
            "kill_leader_step": report.kill_leader_step,
            "failover_time_s": report.failover_time_s,
            # the causal decomposition + federated fleet snapshot
            # (obs/timeline.py, obs/federation.py): a kill-leader run
            # reports WHERE the failover time went, not one number
            "failover_phases": report.failover_phases,
            "fleet_metrics": report.fleet_metrics,
            "failovers": report.failovers,
            "repl_lag_max": report.repl_lag_max,
            # the netsplit leg (quorum-loss degraded mode): how long
            # the plane browned out, and how long reads stayed
            # clamped at the stale committed watermark
            "netsplit_window": list(report.netsplit_window)
            if report.netsplit_window else None,
            "unavailability_s": report.unavailability_s,
            "degraded_read_s": report.degraded_read_s,
            "unavailable_nacks": report.unavailable_nacks,
            "converged": report.converged,
            "failures": report.failures,
            "fired": report.fired,
            "chaos_counts": report.chaos_counts,
            "metrics_delta": report.metrics_delta,
        }))
        return 0 if report.converged else 1
    if args.overload is not None:
        report = run_overload(OverloadConfig(
            offered_multiple=args.overload,
            throttle=not args.no_throttle,
        ))
        print(json.dumps({
            "offered_ops": report.offered_ops,
            "admitted_ops": report.admitted_ops,
            "acked_ops": report.acked_ops,
            "goodput_ops_per_s": report.goodput_ops_per_s,
            "throttle_nacks": report.throttle_nacks,
            "shed": report.shed,
            "outbound_dropped": report.outbound_dropped,
            "slow_disconnects": report.slow_disconnects,
            "peak_outbound_depth": report.peak_outbound_depth,
            "max_pressure_tier": report.max_pressure_tier,
            "metrics_delta": report.metrics_delta,
        }))
        return 0
    report = run_stress(StressConfig(
        n_clients=args.clients, n_steps=args.steps, seed=args.seed,
    ))
    print(json.dumps({
        "steps": report.steps,
        "ops": report.ops_submitted,
        "disconnects": report.disconnects_injected,
        "nacks": report.nacks_injected,
        "converged": report.converged,
        "errors": report.errors,
        "metrics_delta": report.metrics_delta,
    }))
    return 0 if report.ok else 1


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
