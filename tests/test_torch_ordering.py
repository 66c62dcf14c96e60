"""The port's partitioned ordering service and replicated sequencer
against the JAX package's, on the CPU, each package feeding its own
merge sidecar (``TpuMergeSidecar`` on the reference's,
``GpuMergeSidecar(device="cpu")`` on the port's).

The sessions are ``chip_smoke``'s own legs (``partitioned_leg``,
``replicated_leg``: two writers per document, the service cell's edits,
an injected step clock) at a small size: 16 documents, 2 rounds,
capacity 128. Each runs once per package and the runs are equal,
exactly:

- the in-memory queue: every sequenced message (``message_to_json``,
  less what reads the wall clock: the client's and the driver's hops
  and a join's client-detail time), every queue record and committed
  offset, the sidecar's text and signature per document;
- the durable queue with partitions 0 and 1 paused and resumed from
  their committed offsets mid-round: the same, plus the records
  the new consumers read and the duplicates the re-attached sidecar
  dropped;
- the networked broker (``BrokerServer`` + ``RemoteOrderingQueue`` over
  TCP): the same streams as the in-memory queue's, in both packages;
- the replicated group across one leader kill and failover mid-round:
  every sequenced message, every node's op log on disk, the epochs,
  the committed watermarks, the fleet timeline's events and
  ``failover_phases``, and the live sidecar, which equals a shadow
  sidecar fed the new leader's durable log from seq 0.
"""
import importlib
import json
import os
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

REF, PORT = "fluidframework_tpu", "fluidframework_tpu_torch"
DOCS = [f"doc-{d}" for d in range(16)]
ROUNDS, SEED, PARTITIONS = 2, 3, 4
# the resume and the failover: before document 8 of round 2 edits, so
# every document has edits on both sides of it or of the round boundary
MIDPOINT = (2, 8)


def _sidecar(package: str):
    kw = dict(max_docs=len(DOCS), capacity=128, max_capacity=1024)
    if package == REF:
        from fluidframework_tpu.service import TpuMergeSidecar

        return TpuMergeSidecar(executor="scan", **kw)
    from fluidframework_tpu_torch.service import GpuMergeSidecar

    return GpuMergeSidecar(device="cpu", **kw)


def _api(package: str):
    return chip_smoke.ordering_api(importlib.import_module(package))


def _payload(payload: dict) -> dict:
    """A queue record's payload less what reads the wall clock."""
    payload = dict(payload)
    if "op" in payload:
        op = dict(payload["op"])
        op["traces"] = [t for t in op.get("traces") or []
                        if t["service"] not in ("client", "driver")]
        payload["op"] = op
    if "detail" in payload:
        payload["detail"] = {k: v for k, v in payload["detail"].items()
                             if k != "timestamp"}
    return payload


def _served(sidecar, writers) -> dict:
    out = {}
    for doc, pair in writers.items():
        strings = [c.runtime.get_datastore("d").get_channel("s")
                   for c in pair]
        out[doc] = {
            "sidecar": (sidecar.text(doc, "d", "s"),
                        sidecar.signature(doc, "d", "s")),
            "writers": [(s.get_text(), s.signature()) for s in strings],
        }
    return out


def _streams(api, server) -> dict:
    return {d: [chip_smoke._canon_json(api.message_to_json(m))
                for m in server.read_ops(d, 0)] for d in DOCS}


def _partitioned(package: str, kind: str, root) -> dict:
    api = _api(package)
    clock = chip_smoke.StepClock()
    durable_dir, resume = None, ()
    if kind == "durable":
        durable_dir, resume = str(root), (0, 1)
        queue = api.FileOrderingQueue(os.path.join(root, "queue"),
                                      PARTITIONS, fsync=True)
    else:
        queue = api.InMemoryOrderingQueue(PARTITIONS)
    server = api.PartitionedServer(n_partitions=PARTITIONS,
                                   durable_dir=durable_dir, queue=queue,
                                   clock=clock)
    sidecar = _sidecar(package)
    rec = chip_smoke.partitioned_leg(
        api, server, DOCS, ROUNDS, SEED, chip_smoke._SelfTimes(), sidecar,
        clock, resume_at=MIDPOINT, resume=resume)
    return {
        "streams": _streams(api, server),
        "queue": [[(r.offset, r.document_id, _payload(r.payload))
                   for r in queue.read(p, 0)] for p in range(PARTITIONS)],
        "committed": [queue.committed(p) for p in range(PARTITIONS)],
        "served": _served(sidecar, rec["writers"]),
        "resume": {k: rec[k] for k in ("moved", "redelivered", "dropped")},
        "nacks": len(server.svc.nacks),
    }


def _broker(package: str) -> dict:
    api = _api(package)
    loop = chip_smoke._Loop()
    broker = api.BrokerServer(PARTITIONS)
    loop.run(broker.start(), 30)
    queue = api.RemoteOrderingQueue("127.0.0.1", broker.port)
    try:
        clock = chip_smoke.StepClock()
        server = api.PartitionedServer(n_partitions=PARTITIONS,
                                       queue=queue, clock=clock)
        sidecar = _sidecar(package)
        rec = chip_smoke.partitioned_leg(
            api, server, DOCS, ROUNDS, SEED, chip_smoke._SelfTimes(),
            sidecar, clock)
        return {"streams": _streams(api, server),
                "committed": [queue.committed(p)
                              for p in range(PARTITIONS)],
                "lag": queue.fanout_lag(),
                "served": _served(sidecar, rec["writers"]),
                "nacks": len(server.svc.nacks)}
    finally:
        queue.close()
        loop.run(broker.stop(), 30)
        loop.close()


def _node_logs(root) -> dict:
    """Every node's op log on disk, by path under the group's root."""
    out = {}
    for path in sorted(Path(root).rglob("ops.jsonl")):
        with open(path) as f:
            out[str(path.relative_to(root))] = [
                chip_smoke._canon_json(json.loads(line)) for line in f]
    return out


def _replicated(package: str, root) -> dict:
    api = _api(package)
    clock = chip_smoke.StepClock()
    timeline = api.FleetTimeline(clock=clock)
    group = api.ReplicatedSequencerGroup(
        str(root), n_followers=2, clock=clock, timeline=timeline,
        server_kwargs={"clock": clock})
    sidecar = _sidecar(package)
    rec = chip_smoke.replicated_leg(
        api, group, DOCS, ROUNDS, SEED, chip_smoke._SelfTimes(), sidecar,
        clock, timeline, MIDPOINT)
    shadow = _sidecar(package)
    for doc in DOCS:
        shadow.track(doc, "d", "s")
        for msg in group.server.read_ops(doc, 0):
            shadow.ingest(doc, msg)
    shadow.apply()
    return {
        "streams": _streams(api, group.server),
        "nodes": _node_logs(root),
        "group": {"epoch": group.epoch, "fence": group.fence.epoch,
                  "leader": group.leader_id, "quorum": group.quorum,
                  "committed": dict(group._committed),
                  "heads": [(f.node_id, f.total_head())
                            for f in group.followers]},
        "resumed": rec["resumed"],
        "phases": rec["phases"],
        "timeline": timeline.deterministic_events(),
        "served": _served(sidecar, rec["writers"]),
        "shadow": {d: (shadow.text(d, "d", "s"), shadow.signature(d, "d", "s"))
                   for d in DOCS},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    out = {}
    for package in (REF, PORT):
        root = tmp_path_factory.mktemp(package)
        out[package] = {
            "memory": _partitioned(package, "memory", root / "memory"),
            "durable": _partitioned(package, "durable", root / "durable"),
            "broker": _broker(package),
            "replicated": _replicated(package, root / "replicated"),
        }
    return out


LEGS = ("memory", "durable", "broker", "replicated")


@pytest.mark.parametrize("leg", LEGS)
def test_sequenced_streams_equal(runs, leg):
    ref, port = runs[REF][leg]["streams"], runs[PORT][leg]["streams"]
    assert ref == port
    for doc in DOCS:
        seqs = [m["sequenceNumber"] for m in port[doc]]
        assert seqs == list(range(1, len(seqs) + 1)), doc


@pytest.mark.parametrize("leg", LEGS)
def test_sidecars_equal_and_serve_the_writers(runs, leg):
    ref, port = runs[REF][leg]["served"], runs[PORT][leg]["served"]
    assert ref == port
    for doc, served in port.items():
        assert len(set(served["writers"])) == 1, doc
        assert served["writers"][0][0] == served["sidecar"][0], doc


@pytest.mark.parametrize("leg", ("memory", "durable"))
def test_queue_records_and_offsets_equal(runs, leg):
    ref, port = runs[REF][leg], runs[PORT][leg]
    assert ref["queue"] == port["queue"]
    assert ref["committed"] == port["committed"]
    assert port["committed"] == [len(r) - 1 for r in port["queue"]]
    assert ref["nacks"] == port["nacks"] == 0


def test_partition_resume_drops_duplicates(runs):
    ref, port = runs[REF]["durable"], runs[PORT]["durable"]
    assert ref["resume"] == port["resume"]
    assert port["resume"]["moved"] and port["resume"]["redelivered"] > 0
    assert port["resume"]["dropped"] > 0


def test_broker_queue_matches_in_memory(runs):
    for package in (REF, PORT):
        brk, mem = runs[package]["broker"], runs[package]["memory"]
        assert brk["streams"] == mem["streams"], package
        assert brk["committed"] == mem["committed"], package
        assert brk["lag"] == 0 and brk["nacks"] == 0, package


def test_replicated_nodes_epochs_and_timeline_equal(runs):
    ref, port = runs[REF]["replicated"], runs[PORT]["replicated"]
    assert ref["nodes"] == port["nodes"]
    assert set(port["nodes"]) >= {f"node-{i}/{d}/ops.jsonl"
                                  for i in range(3) for d in DOCS}
    assert ref["group"] == port["group"]
    assert port["group"]["epoch"] == 2 and port["group"]["leader"] != "node-0"
    assert ref["timeline"] == port["timeline"]
    assert ref["resumed"] == port["resumed"]
    assert all(seq == head for seq, head in port["resumed"].values())


def test_failover_phases_equal_and_sum(runs):
    ref, port = runs[REF]["replicated"], runs[PORT]["replicated"]
    assert ref["phases"] == port["phases"]
    phases = port["phases"]
    assert round(sum(v for k, v in phases.items() if k != "total_s"),
                 9) == phases["total_s"] > 0


def test_shadow_sidecar_equals_live_after_failover(runs):
    for package in (REF, PORT):
        rep = runs[package]["replicated"]
        assert rep["shadow"] == {d: s["sidecar"]
                                 for d, s in rep["served"].items()}, package
