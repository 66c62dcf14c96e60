"""Fleet observability walkthrough: kill a replicated sequencer's
leader under the step clock and read the incident back three ways.

1. THE TIMELINE: every cross-node lifecycle event (lease grants and
   renewals, the lapse, anti-entropy pulls, the epoch fence advance,
   the promotion, the first post-failover ack) lands on ONE causally
   ordered FleetTimeline (obs/timeline.py), and `failover_phases()`
   decomposes the opaque failover number into detection /
   anti-entropy / promotion / first-ack — summing to the total
   exactly.
2. THE FEDERATED SNAPSHOT: leader and followers each keep their OWN
   metrics registry (no double-counting into one process aggregate);
   obs.federation.FederatedView merges them back — counters sum,
   gauges keep per-node identity under a `node` label.
3. THE SPAN TREE: the whole incident exported as an OTLP-JSON trace
   (obs/spans.py timeline_to_otlp) next to the per-op spans, and one
   replicated op's own breakdown showing the quorum barrier as its
   repl:forward -> repl:quorum_ack hops.

Everything rides an injected step clock, so the printed numbers are
bit-identical on every run.

Run: python -m fluidframework_tpu_torch.examples.fleet_timeline
"""
import tempfile

from fluidframework_tpu_torch.drivers import (
    LocalDocumentServiceFactory,
)
from fluidframework_tpu_torch.loader import Container
from fluidframework_tpu_torch.obs.federation import FederatedView
from fluidframework_tpu_torch.obs.metrics import MetricsRegistry
from fluidframework_tpu_torch.obs.spans import timeline_to_otlp
from fluidframework_tpu_torch.obs.timeline import FleetTimeline
from fluidframework_tpu_torch.service.replication import (
    ReplicatedSequencerGroup,
)


class StepClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def drive(container, n, tag):
    ds = container.runtime.datastores.get("app") or \
        container.runtime.create_datastore("app")
    if "text" not in ds.channels:
        ds.create_channel("sharedstring", "text")
    text = ds.get_channel("text")
    for i in range(n):
        text.insert_text(0, f"{tag}{i}.")
        container.flush()
    return text.get_text()


def main():
    clock = StepClock()
    registries = {f"node-{i}": MetricsRegistry(node=f"node-{i}")
                  for i in range(3)}
    timeline = FleetTimeline(clock=clock,
                             registry=registries["node-0"])
    fleet = FederatedView(clock=clock)
    for node, reg in registries.items():
        fleet.add_registry(node, reg)

    root = tempfile.mkdtemp(prefix="fleet-timeline-")
    group = ReplicatedSequencerGroup(
        root, n_followers=2, clock=clock, lease_ttl=0.3,
        registry=registries["node-0"],
        follower_registries=[registries["node-1"],
                             registries["node-2"]],
        timeline=timeline,
        server_kwargs=dict(clock=clock),
    )

    print("== act 1: steady serving on the replicated plane ==")
    writer = Container.load(
        LocalDocumentServiceFactory(group.server)
        .create_document_service("doc"),
        client_id="writer")
    for _ in range(5):
        clock.t += 0.05
        drive(writer, 1, "w")
    print(f"  5 ops quorum-acked; committed head ="
          f" {group.committed('doc')}")
    print("  one op's breakdown (the quorum barrier is its own hop):")
    hops = [h["hop"] for h in writer.op_trace()["hops"]]
    print("   ", " -> ".join(h for h in hops if h.startswith("repl")))

    print("\n== act 2: host loss, lease lapse, promotion ==")
    timeline.record("leader_kill", node=group.leader_id,
                    mode="example")
    group.kill_leader()
    clock.t += group.lease.ttl + 0.01  # nobody renews; TTL lapses
    group.failover()
    print(f"  promoted {group.leader_id} at epoch {group.epoch}")
    reader = Container.load(
        LocalDocumentServiceFactory(group.server)
        .create_document_service("doc"),
        client_id="reader")
    clock.t += 0.05
    drive(reader, 1, "post")
    timeline.record("first_ack", node=group.leader_id)

    print("\n== act 3: the causal timeline, decomposed ==")
    print(timeline.format())
    phases = timeline.failover_phases()
    print("  failover phases (sum == total, within one step):")
    for key in ("detection_s", "anti_entropy_s", "promotion_s",
                "first_ack_s", "total_s"):
        print(f"    {key:<15} {phases[key]:.3f}s")
    total = sum(phases[k] for k in ("detection_s", "anti_entropy_s",
                                    "promotion_s", "first_ack_s"))
    assert abs(total - phases["total_s"]) < 1e-9

    print("\n== act 4: the federated fleet snapshot ==")
    merged = fleet.refresh()
    for name in ("sequencer_failovers_total",
                 "sequencer_fenced_writes_total",
                 "timeline_events_total", "repl_epoch",
                 "fleet_nodes"):
        fam = merged.get(name)
        if fam is None:
            continue
        for labels, value in sorted(fam["values"].items()):
            if isinstance(value, dict):
                value = value["count"]
            print(f"  {name}{labels} = {value}")

    doc = timeline_to_otlp(timeline.events())
    spans = doc["resourceSpans"][0]["scopeSpans"][0]["spans"]
    print(f"\n  incident exported as {len(spans)} OTLP spans "
          f"(root + one per event)")
    assert doc == timeline_to_otlp(timeline.events())

    writer.close()
    reader.close()
    print("\nOK")


if __name__ == "__main__":
    main()
