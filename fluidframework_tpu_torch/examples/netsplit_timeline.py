"""Partition-tolerance walkthrough: split a replicated sequencer's
network on the step clock and read the incident's phase decomposition
off the fleet timeline.

1. THE SPLIT: the leader lands alone in a minority island (the lease
   service with the majority). Its quorum barrier discovers the loss
   by DEADLINE — one submit pays the wait, every later one fast-nacks
   with the retriable "unavailable" refusal (shed_class rides the
   nack's optional wire fields) while reads stay served, clamped at
   the committed watermark: the read-only brownout.
2. THE ELECTION: the lease lapses (renewals are lost across the
   split); the majority elects a follower; the deposed minority
   leader is refused by the epoch fence on its next write.
3. THE HEAL + REJOIN: the old leader rejoins as a follower via full
   anti-entropy behind the fence; membership grows back.
4. THE SCRUB: a planted mid-file bit-flip (parseable record, wrong
   crc) is read-repaired from a quorum peer, loudly counted.

Every phase lands on ONE causally ordered FleetTimeline
(partition / degraded_enter / lease_expire / promotion /
fenced_write / heal / rejoin / scrub_repair), and the printed
decomposition is bit-identical on every run — everything rides the
injected step clock.

Run: python -m fluidframework_tpu_torch.examples.netsplit_timeline
"""
import json
import tempfile

from fluidframework_tpu_torch.drivers import (
    LocalDocumentServiceFactory,
)
from fluidframework_tpu_torch.loader import Container
from fluidframework_tpu_torch.obs.metrics import MetricsRegistry
from fluidframework_tpu_torch.obs.timeline import FleetTimeline
from fluidframework_tpu_torch.service.replication import (
    NetworkTopology,
    QuorumUnavailableError,
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
    registry = MetricsRegistry(node="node-0")
    timeline = FleetTimeline(clock=clock, registry=registry)
    network = NetworkTopology(timeline=timeline)
    root = tempfile.mkdtemp(prefix="netsplit-timeline-")
    group = ReplicatedSequencerGroup(
        root, n_followers=2, clock=clock, lease_ttl=0.3,
        registry=registry, timeline=timeline, network=network,
        quorum_timeout_s=0.2, retry_interval_s=0.05,
        sleep=lambda dt: setattr(clock, "t", clock.t + dt),
        server_kwargs=dict(clock=clock),
    )

    print("== act 1: steady serving, then the split ==")
    writer = Container.load(
        LocalDocumentServiceFactory(group.server)
        .create_document_service("doc"),
        client_id="writer")
    writer._backoff_clock = clock
    for _ in range(4):
        clock.t += 0.05
        drive(writer, 1, "w")
    print(f"  4 ops quorum-acked; committed = {group.committed('doc')}")
    network.partition([["node-0"], ["node-1", "node-2"]],
                      lease_island=1)
    nacks = []
    writer.on("nack", nacks.append)
    clock.t += 0.05
    drive(writer, 1, "lost")  # pays the deadline, comes back nacked
    print(f"  minority-side write refused: {len(nacks)} retriable "
          f"nack(s), shed_class={nacks[0].shed_class!r}")
    reads = group.server.read_ops("doc", 0)
    print(f"  reads still served, clamped at committed "
          f"({reads[-1].sequence_number} == {group.committed('doc')})")

    print("\n== act 2: the majority elects; the minority is fenced ==")
    while not group.lease.expired():
        clock.t += 0.05
    old_server = group.server
    group.failover()  # the majority side observes the lapse
    print(f"  promoted {group.leader_id} at epoch {group.epoch}")
    try:
        old_server.read_ops("doc", 0)
    except Exception as e:
        print(f"  deposed minority leader refused: "
              f"{type(e).__name__}")

    print("\n== act 3: heal, rejoin, scrub ==")
    network.heal()
    rejoined = group.rejoin("node-0")
    print(f"  node-0 rejoined as a follower at head "
          f"{rejoined.head('doc')}; quorum back to {group.quorum}")
    # plant one mid-file bit-rot state on a follower and repair it
    target = group.followers[0]
    path = target._log_path("doc")
    lines = open(path).readlines()
    row = json.loads(lines[1])
    row["contents"] = {"bitrot": True}  # stale _crc: mismatch
    lines[1] = json.dumps(row) + "\n"
    fh = target._fhs.pop("doc", None)
    if fh is not None:
        fh.close()
    open(path, "w").writelines(lines)
    repaired = group.scrub()
    print(f"  scrubber read-repaired {repaired} bit-rotted record(s) "
          "from a quorum peer")

    print("\n== act 4: the causal timeline ==")
    print(timeline.format())
    kinds = [e.kind for e in timeline.events()]
    for expected in ("partition", "degraded_enter", "lease_expire",
                     "promotion", "heal", "rejoin", "scrub_repair"):
        assert expected in kinds, (expected, kinds)
    order = [kinds.index(k) for k in ("partition", "degraded_enter",
                                      "promotion", "heal", "rejoin")]
    assert order == sorted(order), kinds
    assert repaired == 1
    writer.close()
    print("\nOK")


if __name__ == "__main__":
    main()
