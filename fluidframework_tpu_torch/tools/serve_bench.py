"""Open-loop serving benchmark: Poisson arrivals over the real
ingress dispatch path, graded live by the SLO engine.

Every bench config before this one was CLOSED-loop: the driver waits
for each response before offering the next op, so the offered rate
adapts to the service and latency can never build a queue. Real
traffic doesn't wait: arrivals are an external
process, and when the service falls behind, the backlog — and the
submit→ack latency — grows. This harness is that experiment:

- OPEN-LOOP ARRIVALS: a seeded Poisson process offers ops at a
  configured rate regardless of how the service is doing; arrivals
  queue in a global FIFO backlog and are served through the REAL
  ``AlfredServer._dispatch`` path at the configured service rate.
  Latency = simulated queue wait + the (sub-tick) dispatch, observed
  into ``serve_submit_ack_ms{route="host"}``.
- TENS OF THOUSANDS OF SESSIONS: every document carries one scripted
  writer plus read-mode subscriber sessions (the slow-consumer
  population), all real ``_ClientSession`` objects on the real
  fanout path.
- MIXED ROUTE SPLIT: alongside the host-tier ingress plane, a real
  ``GpuMergeSidecar`` serves a batch-routed document population fed
  corpus op rounds (config7's idiom), on ``sidecar_device`` (``cuda``
  unless the caller names the CPU); its pack/settle cost rides the
  existing ``sidecar_settle_ms`` histogram, which the SLO engine
  grades as its own per-hop budget. Sidecar round timings are WALL
  milliseconds (real device/CPU work); the ingress plane's are
  SIMULATED milliseconds — each objective binds to its own series,
  so the budgets stay meaningful per route.
- QOS ON: the admission controller + pressure monitor run on the
  same manual clock, so sheds/nacks are deterministic and the SLO
  report can cite the pressure tier the breach happened under.
- DETERMINISTIC: everything on the ingress plane is driven by one
  seeded RNG under a manual clock — same config, same counts, same
  verdicts (tests assert run-to-run equality).

The SLO engine ticks every harness tick and is evaluated on a fixed
cadence; its final report (plus how many evaluations breached) is
the record bench config9 carries. The continuous profiler optionally
rides the run (``profile=True``); config9 runs the same config with
it on and off and reports the measured overhead.

A copy of the reference's ``tools/serve_bench.py``. The sidecar is the
port's ``GpuMergeSidecar`` on ``sidecar_device``.
"""
from __future__ import annotations

import json
import math
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from ..obs import metrics as obs_metrics
from ..obs.profiler import ContinuousProfiler
from ..obs.federation import FederatedView
from ..obs.slo import Objective, SloEngine
from ..qos import (
    AdmissionController,
    Budget,
    PressureMonitor,
    RateLimits,
)
from ..service.ingress import AlfredServer, _ClientSession
from .stress import _ManualClock

# simulated-latency buckets: the default ladder starts at 0.1ms, far
# below the tick resolution an open-loop sim can resolve; this one
# spans one-tick waits (tens of ms) to a multi-second collapse
SERVE_LATENCY_BUCKETS_MS = (
    1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
    2500.0, 5000.0,
)

_M_LAT = obs_metrics.REGISTRY.histogram(
    "serve_submit_ack_ms",
    "open-loop submit→ack latency per serving route (host = "
    "simulated ms under the manual clock; sidecar = wall ms of the "
    "real dispatch round)",
    labelnames=("route",), buckets=SERVE_LATENCY_BUCKETS_MS)
_M_OFFERED = obs_metrics.REGISTRY.counter(
    "serve_ops_offered_total",
    "ops the open-loop arrival process offered")
_M_ACKED = obs_metrics.REGISTRY.counter(
    "serve_ops_acked_total",
    "offered ops sequenced and acked back (goodput numerator)")


def poisson(rng: random.Random, lam: float) -> int:
    """Seeded Poisson sample. Knuth's product method underflows past
    lam ~700 (exp(-lam) == 0.0 -> infinite loop), so large rates use
    the normal approximation — fine for arrival counts, where lam is
    already > 30 per tick."""
    if lam <= 0:
        return 0
    if lam > 30.0:
        return max(0, int(round(rng.gauss(lam, math.sqrt(lam)))))
    threshold = math.exp(-lam)
    k, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= threshold:
            return k
        k += 1


@dataclass
class ServeBenchConfig:
    """One deterministic open-loop serving scenario. All times are
    SIMULATED seconds on the manual clock unless stated otherwise."""

    n_docs: int = 64                 # host-tier documents
    readers_per_doc: int = 3         # never-draining subscribers
    duration_s: float = 6.0
    tick_s: float = 0.05
    capacity_ops_per_s: float = 400.0   # service (drain) rate
    offered_multiple: float = 1.0       # arrival rate / capacity
    qos: bool = True
    # seconds-of-capacity of backlog that count as SATURATED for the
    # composite pressure signal: long enough that a sustained
    # overload passes through elevated/severe (shedding bulk classes
    # while writers keep acking — the qos plateau) before critical
    backlog_saturation_s: float = 10.0
    seed: int = 0
    # SLO engine: windows keep production's 1:12 fast:slow ratio on
    # the simulated clock; evaluation cadence in sim seconds
    slo_fast_window_s: float = 1.0
    slo_slow_window_s: float = 12.0
    slo_eval_every_s: float = 0.5
    # must sit ABOVE the one-tick latency floor the discretized
    # open loop imposes (an op arriving mid-tick is served at the
    # next tick boundary): with tick_s=0.05 the healthy p99 is
    # ~1.5 ticks, so the budget is two ticks
    submit_ack_slo_ms: float = 100.0
    goodput_target: float = 0.90
    sidecar_settle_slo_ms: float = 1000.0
    # sidecar route split (0 docs = host-only). Sidecar rounds run
    # real device/CPU dispatches on the wall clock.
    sidecar_docs: int = 0
    sidecar_streams: int = 4
    sidecar_steps: int = 40
    sidecar_capacity: int = 256
    sidecar_round_ops: int = 8
    sidecar_round_every_s: float = 0.5
    # the sidecar's device: the card unless the caller asks for the
    # CPU (no quiet fallback: "cuda" without a card raises)
    sidecar_device: str = "cuda"
    # continuous profiler (wall-clock thread sampler)
    profile: bool = False
    profile_interval_s: float = 0.005
    # cost attribution (obs/heat.py): per-document device-time split
    # across sidecar rounds + per-tenant usage rollup. The attribution
    # clock is a deterministic STEP clock (fixed increment per read),
    # so same-config runs produce bit-identical heat tables and top-k
    # — config16's x2 differential depends on it.
    heat: bool = False
    heat_top_k: int = 8


@dataclass
class ServeBenchReport:
    offered_ops: int = 0
    acked_ops: int = 0
    shed_ops: int = 0
    goodput_ops_per_s: float = 0.0
    latency_p50_ms: Optional[float] = None
    latency_p99_ms: Optional[float] = None
    backlog_peak: int = 0
    backlog_final: int = 0
    max_pressure_tier: int = 0
    sessions: int = 0
    # sidecar plane (wall-clock)
    sidecar_rounds: int = 0
    sidecar_ops: int = 0
    sidecar_round_p50_ms: Optional[float] = None
    sidecar_round_p99_ms: Optional[float] = None
    sidecar_rounds_wall_ms: float = 0.0
    route_split_sidecar: float = 0.0
    # SLO plane
    slo_report: dict = field(default_factory=dict)
    slo_evaluations: int = 0
    slo_breach_evaluations: int = 0
    slo_breached_objectives: list = field(default_factory=list)
    # profiler (None when profile=False)
    profiler: Optional[dict] = None
    # fleet surface: the node ids the ingress's FederatedView merges
    # (one node here; the replicated plane grows the list)
    fleet_nodes: list = field(default_factory=list)
    # cost attribution (heat=True; empty otherwise). Deterministic:
    # the attribution plane runs on the step clock, not wall time.
    heat_top_docs: list = field(default_factory=list)
    heat_top_tenants: list = field(default_factory=list)
    heat_attributed_ms: float = 0.0
    wall_s: float = 0.0
    metrics_delta: dict = field(default_factory=dict)

    def deterministic_fields(self) -> dict:
        """The subset that must be bit-equal run-to-run for the same
        config (everything the manual/step clocks govern; wall-clock
        figures — sidecar round times, profiler, wall_s — excluded)."""
        return {
            "offered_ops": self.offered_ops,
            "acked_ops": self.acked_ops,
            "shed_ops": self.shed_ops,
            "latency_p50_ms": self.latency_p50_ms,
            "latency_p99_ms": self.latency_p99_ms,
            "backlog_peak": self.backlog_peak,
            "max_pressure_tier": self.max_pressure_tier,
            "sidecar_ops": self.sidecar_ops,
            "heat_top_docs": self.heat_top_docs,
            "heat_top_tenants": self.heat_top_tenants,
            "heat_attributed_ms": self.heat_attributed_ms,
        }


class _OpenLoopWriter:
    """One write session driven op-by-op through the real dispatch
    path, with the csn bookkeeping a shed op demands (retrying with
    the SAME csn would be a resubmit; open-loop traffic doesn't
    retry, so a shed op's csn is simply never consumed)."""

    def __init__(self, server: AlfredServer, doc: str, name: str,
                 clock: _ManualClock):
        self.server = server
        self.doc = doc
        self.name = name
        self.clock = clock
        self.session = _ClientSession(server, None)
        server._sessions.add(self.session)
        self.csn = 0
        self.acked = 0
        self.shed = 0
        self.latencies_ms: list = []
        server._dispatch(self.session, {
            "type": "connect_document", "document_id": doc,
            "client_id": name, "versions": ["1.2", "1.1", "1.0"],
        })

    def _drain_own_acks(self) -> int:
        """Consume queued outbound frames; own sequenced-op count."""
        acks = 0
        q = self.session.outbound
        while not q.empty():
            raw = q.get_nowait()
            if raw is None:
                continue
            frame = json.loads(raw[4:])
            if frame.get("type") == "op":
                msg = frame.get("msg") or {}
                if msg.get("clientId") == self.name:
                    acks += 1
        return acks

    def offer_one(self, arrival_t: float, nbytes: int = 96) -> bool:
        """Submit one op that arrived at ``arrival_t``; True = acked
        (latency observed), False = shed by admission."""
        attempt = self.csn + 1
        self.server._dispatch(self.session, {
            "type": "submitOp", "document_id": self.doc,
            "op": {
                "client_sequence_number": attempt,
                "reference_sequence_number": 0,
                "type": 2,  # MessageType.OPERATION
                "contents": {"k": "v"},
                "metadata": None, "traces": [],
            },
        }, nbytes)
        if self._drain_own_acks():
            self.csn = attempt
            self.acked += 1
            lat_ms = max(0.0, (self.clock.t - arrival_t) * 1000.0)
            self.latencies_ms.append(lat_ms)
            _M_LAT.labels(route="host").observe(lat_ms)
            _M_ACKED.inc()
            return True
        self.shed += 1
        return False


def _pct(sorted_arr: list, q: float) -> Optional[float]:
    if not sorted_arr:
        return None
    return sorted_arr[min(len(sorted_arr) - 1,
                          int(len(sorted_arr) * q))]


class _StepClock:
    """Deterministic attribution clock: each read advances a fixed
    step, so a dispatch round's span is (reads between)*step —
    identical every run. Wall time never enters the heat plane."""

    def __init__(self, step_s: float = 0.001):
        self.t = 0.0
        self.step_s = step_s

    def __call__(self) -> float:
        self.t += self.step_s
        return self.t


def _tenant_of_doc(doc: str) -> str:
    """Deterministic doc→tenant assignment for the harness: sdoc-<d>
    bills tenant-<d mod 3> (a skewed-enough split that top-k has an
    ordering to get right)."""
    try:
        d = int(doc.rsplit("-", 1)[1])
    except (IndexError, ValueError):
        return "tenant-0"
    return f"tenant-{d % 3}"


def _build_sidecar(cfg: ServeBenchConfig, heat_ledger=None,
                   usage=None, attr_clock=None):
    """The sidecar-routed document population (config7's feeding
    idiom: canonical encoded streams installed per slot, round
    slices queued directly). Lazy import: a host-only run must not
    pay the torch import."""
    from ..ops.host_bridge import encode_stream
    from ..service.gpu_sidecar import GpuMergeSidecar
    from ..testing import FuzzConfig, record_op_stream

    sidecar = GpuMergeSidecar(
        max_docs=cfg.sidecar_docs, capacity=cfg.sidecar_capacity,
        max_capacity=cfg.sidecar_capacity * 4,
        heat=heat_ledger, usage=usage,
        tenant_of=_tenant_of_doc if usage is not None else None,
        attr_clock=attr_clock,
        device=cfg.sidecar_device,
    )
    encs = []
    for i in range(cfg.sidecar_streams):
        _, stream = record_op_stream(FuzzConfig(
            n_clients=2, n_steps=cfg.sidecar_steps,
            seed=cfg.seed + 1000 + i,
            insert_weight=0.55, remove_weight=0.25,
            annotate_weight=0.05, process_weight=0.15,
        ))
        encs.append(encode_stream(stream))
    for d in range(cfg.sidecar_docs):
        slot = sidecar.track(f"sdoc-{d}", "ds", "ch")
        sidecar._streams[slot] = encs[d % len(encs)]
    return sidecar, encs


def run_serve_bench(config: Optional[ServeBenchConfig] = None
                    ) -> ServeBenchReport:
    cfg = config or ServeBenchConfig()
    report = ServeBenchReport()
    before = obs_metrics.REGISTRY.flat()
    clock = _ManualClock()
    rng = random.Random(cfg.seed)
    wall0 = time.perf_counter()

    qos = None
    pressure = None
    if cfg.qos:
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
    server = AlfredServer(qos=qos)
    # the fleet surface (obs/federation.py): serve_bench is a
    # one-node plane, but the ingress it benchmarks serves the same
    # `fleet-metrics` frame a replicated deployment does — wired
    # here so config9 exercises the federated path, on the manual
    # clock so fleet_snapshot_age_s stays deterministic
    fleet = FederatedView(clock=clock)
    fleet.add_registry(obs_metrics.REGISTRY.node,
                       obs_metrics.REGISTRY)
    server.fleet = fleet

    # --- session population (writers + read-mode subscribers) -------
    writers = [
        _OpenLoopWriter(server, f"doc-{d}", f"writer-{d}", clock)
        for d in range(cfg.n_docs)
    ]
    for d in range(cfg.n_docs):
        for i in range(cfg.readers_per_doc):
            s = _ClientSession(server, None)
            server._sessions.add(s)
            server._dispatch(s, {
                "type": "connect_document",
                "document_id": f"doc-{d}",
                "client_id": f"reader-{d}-{i}", "mode": "read",
                "versions": ["1.2", "1.1", "1.0"],
            })
    report.sessions = len(server._sessions)

    # --- cost attribution (obs/heat.py) ------------------------------
    heat_ledger = None
    usage = None
    if cfg.heat:
        from ..obs.heat import HeatLedger, usage_ledger

        attr_clock = _StepClock()
        heat_ledger = HeatLedger(clock=attr_clock)
        usage = usage_ledger(clock=attr_clock)

    # --- sidecar route split ----------------------------------------
    sidecar = None
    sidecar_round_ms: list = []
    if cfg.sidecar_docs > 0:
        sidecar, sidecar_encs = _build_sidecar(
            cfg, heat_ledger=heat_ledger, usage=usage,
            attr_clock=attr_clock if cfg.heat else None)
        sidecar_rounds_total = int(
            max(len(e.ops) for e in sidecar_encs)
            + cfg.sidecar_round_ops - 1) // cfg.sidecar_round_ops

    # the open-loop backlog: (arrival_t, writer_index) FIFO —
    # declared before the SLO engine so its context lambda closes
    # over a bound name
    pending: deque = deque()
    if pressure is not None:
        # the backlog is this harness's sequencer-inbox analogue;
        # one simulated second of capacity = saturated. This is what
        # makes overload REACH the qos tiers: past it, admission
        # starts shedding by class and the SLO report's pressure
        # context names the tier the breach happened under.
        pressure.add_source(
            "serve_backlog", lambda: len(pending),
            capacity=max(1.0, cfg.capacity_ops_per_s
                         * cfg.backlog_saturation_s),
        )

    # --- SLO engine ---------------------------------------------------
    objectives = [
        Objective("submit-ack-p99", metric="serve_submit_ack_ms",
                  labels={"route": "host"},
                  threshold_ms=cfg.submit_ack_slo_ms, target=0.99),
        Objective("goodput-floor", kind="goodput",
                  good_metric="serve_ops_acked_total",
                  total_metric="serve_ops_offered_total",
                  target=cfg.goodput_target),
    ]
    if sidecar is not None:
        objectives.append(Objective(
            "sidecar-settle-p99", metric="sidecar_settle_ms",
            threshold_ms=cfg.sidecar_settle_slo_ms, target=0.99,
        ))
    engine = SloEngine(
        objectives,
        fast_window_s=cfg.slo_fast_window_s,
        slow_window_s=cfg.slo_slow_window_s,
        clock=clock,
    )
    if pressure is not None:
        engine.add_context("pressure", pressure.context)
    engine.add_context("backlog", lambda: len(pending))
    if usage is not None:
        # breach verdicts arrive with the likely payers attached
        engine.add_context(
            "hot_tenants", lambda: usage.top_k(cfg.heat_top_k))
    if sidecar is not None:
        engine.add_dump_target(sidecar.flight)

    profiler = None
    if cfg.profile:
        profiler = ContinuousProfiler(
            interval_s=cfg.profile_interval_s, name="serve")
        engine.add_dump_target(profiler)
        profiler.start()

    # the profiler attributes samples by thread-name prefix; name the
    # driving thread so "where did serving time go" has a component
    me = threading.current_thread()
    saved_name = me.name
    me.name = f"serve-bench-{saved_name}"

    # --- the open loop ------------------------------------------------
    arrival_rate = cfg.offered_multiple * cfg.capacity_ops_per_s
    budget_per_tick = cfg.capacity_ops_per_s * cfg.tick_s
    ticks = int(cfg.duration_s / cfg.tick_s)
    serve_carry = 0.0
    next_eval = cfg.slo_eval_every_s
    next_sidecar_round = 0.0
    sidecar_round = 0
    breached: set = set()
    try:
        for _tick in range(ticks):
            clock.t += cfg.tick_s
            # arrivals: Poisson count, timestamps spread uniformly
            # inside the tick (sub-tick spread keeps the latency
            # histogram from quantizing to whole-tick multiples)
            n_arrivals = poisson(rng, arrival_rate * cfg.tick_s)
            for _ in range(n_arrivals):
                arrival_t = clock.t - cfg.tick_s * rng.random()
                pending.append((arrival_t,
                                rng.randrange(cfg.n_docs)))
            report.offered_ops += n_arrivals
            _M_OFFERED.inc(n_arrivals)
            report.backlog_peak = max(report.backlog_peak,
                                      len(pending))
            # service: drain the FIFO at the configured rate through
            # the real dispatch path (fractional budgets carry over)
            serve_carry += budget_per_tick
            n_serve = min(int(serve_carry), len(pending))
            serve_carry -= int(serve_carry)
            for _ in range(n_serve):
                arrival_t, w = pending.popleft()
                if not writers[w].offer_one(arrival_t):
                    report.shed_ops += 1
            # sidecar plane: real dispatch rounds on the wall clock
            if sidecar is not None and clock.t >= next_sidecar_round:
                next_sidecar_round = (
                    clock.t + cfg.sidecar_round_every_s)
                if sidecar_round < sidecar_rounds_total:
                    lo = sidecar_round * cfg.sidecar_round_ops
                    hi = lo + cfg.sidecar_round_ops
                    for d in range(cfg.sidecar_docs):
                        enc = sidecar._streams[d]
                        sl = enc.ops[lo:hi]
                        if sl:
                            sidecar._queued[d].extend(sl)
                    t0 = time.perf_counter()
                    report.sidecar_ops += sidecar.apply()
                    sidecar.sync()
                    ms = (time.perf_counter() - t0) * 1000.0
                    sidecar_round_ms.append(ms)
                    _M_LAT.labels(route="sidecar").observe(ms)
                    sidecar_round += 1
                    report.sidecar_rounds += 1
            if pressure is not None:
                report.max_pressure_tier = max(
                    report.max_pressure_tier,
                    pressure.sample().tier)
            engine.tick()
            if clock.t >= next_eval:
                next_eval = clock.t + cfg.slo_eval_every_s
                evaluation = engine.evaluate()
                report.slo_evaluations += 1
                bad = [o["name"] for o in evaluation["objectives"]
                       if o["verdict"] == "breach"]
                if bad:
                    report.slo_breach_evaluations += 1
                    breached.update(bad)
    finally:
        me.name = saved_name
        if profiler is not None:
            profiler.stop()

    report.acked_ops = sum(w.acked for w in writers)
    report.goodput_ops_per_s = report.acked_ops / cfg.duration_s
    report.backlog_final = len(pending)
    lats = sorted(x for w in writers for x in w.latencies_ms)
    report.latency_p50_ms = _pct(lats, 0.5)
    report.latency_p99_ms = _pct(lats, 0.99)
    rounds = sorted(sidecar_round_ms)
    report.sidecar_round_p50_ms = _pct(rounds, 0.5)
    report.sidecar_round_p99_ms = _pct(rounds, 0.99)
    report.sidecar_rounds_wall_ms = float(sum(sidecar_round_ms))
    total_served = report.acked_ops + report.sidecar_ops
    report.route_split_sidecar = (
        report.sidecar_ops / total_served if total_served else 0.0)
    report.slo_report = engine.evaluate()
    report.slo_breached_objectives = sorted(breached)
    if profiler is not None:
        report.profiler = profiler.summary()
    report.fleet_nodes = fleet.nodes()
    if heat_ledger is not None:
        report.heat_top_docs = [
            [k, v] for k, v in heat_ledger.top_k(cfg.heat_top_k)]
        report.heat_top_tenants = [
            [k, v] for k, v in usage.top_k(cfg.heat_top_k)]
        report.heat_attributed_ms = float(sum(
            heat_ledger.get(k) for k in heat_ledger.keys()))
    report.wall_s = time.perf_counter() - wall0
    report.metrics_delta = obs_metrics.REGISTRY.delta(before)
    return report


def main(argv: Optional[list] = None) -> int:  # pragma: no cover
    import argparse
    import dataclasses

    parser = argparse.ArgumentParser(
        description="open-loop serving benchmark (SLO-graded)")
    parser.add_argument("--docs", type=int, default=64)
    parser.add_argument("--duration", type=float, default=6.0)
    parser.add_argument("--offered-multiple", type=float, default=1.0)
    parser.add_argument("--capacity", type=float, default=400.0)
    parser.add_argument("--sidecar-docs", type=int, default=0)
    parser.add_argument("--sidecar-device", default="cuda",
                        help="the sidecar's torch device (default "
                             "cuda; cpu runs the plain version)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--no-qos", action="store_true")
    parser.add_argument("--heat", action="store_true")
    args = parser.parse_args(argv)
    report = run_serve_bench(ServeBenchConfig(
        n_docs=args.docs, duration_s=args.duration,
        offered_multiple=args.offered_multiple,
        capacity_ops_per_s=args.capacity,
        sidecar_docs=args.sidecar_docs, seed=args.seed,
        sidecar_device=args.sidecar_device,
        profile=args.profile, qos=not args.no_qos,
        heat=args.heat,
    ))
    out = dataclasses.asdict(report)
    out.pop("metrics_delta")  # bulky; the bench record carries it
    print(json.dumps(out, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
