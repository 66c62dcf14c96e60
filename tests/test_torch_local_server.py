"""The port's in-process Fluid service and client stack against the JAX
package's, on the CPU.

- One seeded session runs through each package's own ``LocalServer``,
  local driver and ``Container``s on the same manual clock: three
  documents with two or three writers each doing inserts, markers,
  removes and annotates, a summarize and its ack, a late join from the
  summary, a stale client's nack, a reconnect with offline edits and a
  gap refetch. The op logs (as ``message_to_json`` records modulo the
  client and driver hop stamps, which read the wall clock), the quorum
  snapshots, the scribe's latest summary trees, every nack, and every
  client's text and signature are equal. The session makes no interval
  and no chunked op, so no ``uuid``-minted field reaches the wire.
- Each package's merge sidecar subscribes to its own package's server
  (``TpuMergeSidecar`` on the reference's, ``GpuMergeSidecar(device=
  "cpu")`` on the port's), and over the same session both serve the
  same text and signature, through a grow and a host eviction.
- A ``durable_dir`` and a summary written by one package load in the
  other, both ways.
"""
import importlib
import json
import random
import types

import pytest

REF, PORT = "fluidframework_tpu", "fluidframework_tpu_torch"
DIRECTIONS = [(REF, PORT), (PORT, REF)]


def _api(package: str) -> types.SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{package}.{name}")

    return types.SimpleNamespace(
        LocalServer=m("service.local_server").LocalServer,
        Factory=m("drivers").LocalDocumentServiceFactory,
        Container=m("loader").Container,
        DocumentMessage=m("protocol.messages").DocumentMessage,
        MessageType=m("protocol.messages").MessageType,
        ReferenceType=m("models.mergetree.ops").ReferenceType,
        message_to_json=m("protocol.serialization").message_to_json,
        save_document=m("drivers").save_document,
        load_document=m("drivers").load_document,
    )


def _clock():
    t = {"v": 1000.0}

    def clock():
        t["v"] += 0.25
        return t["v"]

    return clock


def _canon(rec: dict) -> dict:
    rec = dict(rec)
    rec["traces"] = [t for t in rec.get("traces") or []
                     if t["service"] not in ("client", "driver")]
    return rec


def _string(container):
    return container.runtime.get_datastore("d").get_channel("s")


def _edit(rng, s, marker_type) -> None:
    """One random edit of a SharedString."""
    n = s.get_length()
    r = rng.random()
    if n > 2 and r < 0.3:
        start = rng.randrange(n - 1)
        s.remove_text(start, min(n, start + rng.randint(1, 6)))
    elif n > 2 and r < 0.45:
        start = rng.randrange(n - 1)
        s.annotate_range(start, min(n, start + rng.randint(1, 5)),
                         {"bold": rng.randint(0, 3)})
    elif r < 0.55:
        s.insert_marker(rng.randint(0, n), marker_type,
                        {"tag": rng.randint(0, 9)})
    else:
        s.insert_text(rng.randint(0, n),
                      "".join(rng.choice("abcxyz") for _ in
                              range(rng.randint(1, 6))))


def _round(rng, writers, marker_type, offline=()) -> None:
    """Every writer edits (local, concurrent), then every one flushes."""
    for c in writers:
        for _ in range(rng.randint(1, 3)):
            _edit(rng, _string(c), marker_type)
    for c in writers:
        if c not in offline:
            c.flush()


def _session(package: str, seed: int = 11) -> dict:
    api = _api(package)
    rng = random.Random(seed)
    server = api.LocalServer(clock=_clock())
    factory = api.Factory(server)
    marker = api.ReferenceType.TILE
    docs = {}
    for d, n_writers in (("doc-0", 2), ("doc-1", 3), ("doc-2", 2)):
        writers = [api.Container.load(factory.create_document_service(d),
                                      client_id=f"{d}-w{i}")
                   for i in range(n_writers)]
        writers[0].runtime.create_datastore("d").create_channel(
            "sharedstring", "s")
        writers[0].flush()
        docs[d] = writers
    for _ in range(3):
        for writers in docs.values():
            _round(rng, writers, marker)

    # a summarize and its ack, then a late join from summary + tail
    acks = []
    docs["doc-0"][0].on("summaryAck", acks.append)
    docs["doc-0"][0].summarize()
    _round(rng, docs["doc-0"], marker)
    late = api.Container.load(factory.create_document_service("doc-0"),
                              client_id="doc-0-late")
    assert _string(late).get_text() == _string(docs["doc-0"][0]).get_text()
    docs["doc-0"].append(late)

    # a stale client: a csn gap is nacked by the service
    nack = server.get_orderer("doc-1").submit(
        "doc-1-w2", api.DocumentMessage(
            client_sequence_number=99, reference_sequence_number=0,
            type=api.MessageType.OPERATION, contents=None))

    # a reconnect with offline edits
    away = docs["doc-1"][1]
    away.disconnect()
    _round(rng, docs["doc-1"], marker, offline=(away,))
    _round(rng, docs["doc-1"], marker, offline=(away,))
    away.connect()
    away.flush()

    # a gap refetch: one broadcast to a writer is lost on the way
    lossy_writer = docs["doc-2"][1]
    deliver, lost = lossy_writer._connection._inner.on_message, []

    def lossy(msg):
        if not lost:
            lost.append(msg.sequence_number)
            return
        deliver(msg)

    lossy_writer._connection._inner.on_message = lossy
    for _ in range(2):
        for writers in docs.values():
            _round(rng, writers, marker)

    out = {"acks": len(acks), "nack": (nack.message, int(nack.error_type)),
           "lost": lost, "docs": {}}
    for d, writers in docs.items():
        orderer = server.get_orderer(d)
        latest = server.latest_summary(d)
        out["docs"][d] = {
            "log": [json.dumps(_canon(api.message_to_json(m)),
                               sort_keys=True)
                    for m in orderer.op_log.read(0)],
            "quorum": [json.dumps(c.protocol.snapshot(), sort_keys=True)
                       for c in writers],
            "scribe": json.dumps(orderer.scribe.protocol.snapshot(),
                                 sort_keys=True),
            "summary": None if latest is None else (
                latest.sequence_number,
                json.dumps(latest.summary, sort_keys=True, default=repr)),
            "texts": [_string(c).get_text() for c in writers],
            "signatures": [_string(c).signature() for c in writers],
        }
    return out


def test_session_equal_through_both_stacks():
    ref, port = _session(REF), _session(PORT)
    assert ref["acks"] == 1 and ref["lost"] and "gap" in ref["nack"][0]
    assert port["acks"] == ref["acks"] and port["nack"] == ref["nack"]
    assert port["lost"] == ref["lost"]
    assert port["docs"].keys() == ref["docs"].keys()
    for d, want in ref["docs"].items():
        got = port["docs"][d]
        assert len(set(want["texts"])) == 1, d  # the writers converged
        assert got["log"] == want["log"], d
        for key in ("quorum", "scribe", "summary", "texts", "signatures"):
            assert got[key] == want[key], (d, key)
    assert ref["docs"]["doc-0"]["summary"] is not None


def test_session_is_byte_stable_on_the_manual_clock():
    """The port's server routes every wire timestamp and service hop
    stamp through the injected clock: two runs record the same logs."""
    a, b = _session(PORT), _session(PORT)
    assert a == b
    for rec in a["docs"]["doc-1"]["log"]:
        rec = json.loads(rec)
        assert 1000.0 < rec["timestamp"] < 2000.0
        assert all(1000.0 < t["timestamp"] < 2000.0 for t in rec["traces"])


# ----------------------------------------------------------------------
# each package's sidecar on its own package's server

SIDECAR_CASES = {
    # name: (sidecar arguments, documents, edit steps)
    "multidoc": (dict(max_docs=8, capacity=256), 5, 80),
    "grow": (dict(max_docs=2, capacity=16, max_capacity=512), 1, 60),
    "evict": (dict(max_docs=2, capacity=16, max_capacity=16), 2, 60),
}


def _sidecar(package: str, **kw):
    if package == REF:
        from fluidframework_tpu.service import TpuMergeSidecar

        return TpuMergeSidecar(executor="scan", **kw)
    from fluidframework_tpu_torch.service import GpuMergeSidecar

    return GpuMergeSidecar(device="cpu", **kw)


def _served_session(package: str, case: str, seed: int = 5) -> dict:
    kw, n_docs, steps = SIDECAR_CASES[case]
    api = _api(package)
    rng = random.Random(seed)
    server = api.LocalServer(clock=_clock())
    factory = api.Factory(server)
    sidecar = _sidecar(package, **kw)
    docs = [f"doc-{i}" for i in range(n_docs)]
    writers = {}
    for d in docs:
        sidecar.subscribe(server, d, "d", "s")
        pair = [api.Container.load(factory.create_document_service(d),
                                   client_id=f"{d}-{who}")
                for who in "ab"]
        pair[0].runtime.create_datastore("d").create_channel(
            "sharedstring", "s")
        pair[0].flush()
        writers[d] = pair
    for step in range(steps):
        d = docs[0] if case != "multidoc" else rng.choice(docs)
        c = rng.choice(writers[d])
        s = _string(c)
        n = s.get_length()
        if n > 6 and rng.random() < 0.3:
            start = rng.randrange(n - 3)
            s.remove_text(start, start + rng.randint(1, 3))
        elif n > 4 and rng.random() < 0.15:
            s.annotate_range(0, 3, {"color": rng.choice(["r", "g", None])})
        else:
            s.insert_text(rng.randint(0, n), "abcdefgh"[:rng.randint(2, 8)])
        c.flush()
        if step % 7 == 6:
            sidecar.apply()
    if case == "evict":  # a healthy neighbour of the evicted document
        s = _string(writers[docs[1]][0])
        s.insert_text(0, "tiny")
        writers[docs[1]][0].flush()
    sidecar.apply()
    sidecar.sync()
    return {
        "served": [(sidecar.text(d, "d", "s"), sidecar.signature(d, "d", "s"))
                   for d in docs],
        "writers": [[_string(c).get_text() for c in writers[d]]
                    for d in docs],
        "grows": sidecar.grow_count,
        "host_docs": sidecar.host_mode_docs(),
        "capacity": sidecar.capacity,
    }


@pytest.mark.parametrize("case", list(SIDECAR_CASES))
def test_sidecars_on_their_own_servers(case):
    ref, port = _served_session(REF, case), _served_session(PORT, case)
    assert port == ref
    for (text, _), texts in zip(port["served"], port["writers"]):
        assert texts == [text, text]
    if case == "grow":
        assert port["grows"] >= 1 and port["host_docs"] == 0
    if case == "evict":
        assert port["host_docs"] == 1


# ----------------------------------------------------------------------
# state carried across packages: the durable store and summaries

def _writers(api, server, doc="doc"):
    factory = api.Factory(server)
    a, b = (api.Container.load(factory.create_document_service(doc),
                               client_id=f"{doc}-{who}")
            for who in "ab")
    a.runtime.create_datastore("d").create_channel("sharedstring", "s")
    a.flush()
    return a, b


def _some_edits(api, a, b, rng, rounds=4):
    for _ in range(rounds):
        _round(rng, [a, b], api.ReferenceType.TILE)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_durable_dir_reopens_across_packages(tmp_path, writer, reader):
    w, r = _api(writer), _api(reader)
    rng = random.Random(3)
    a, b = _writers(w, w.LocalServer(durable_dir=str(tmp_path)))
    _some_edits(w, a, b, rng)
    a.summarize()
    _some_edits(w, a, b, rng)  # a tail past the summary
    want = (_string(a).get_text(), _string(a).signature())

    server = r.LocalServer(durable_dir=str(tmp_path))
    assert server.latest_summary("doc") is not None
    c = r.Container.load(r.Factory(server).create_document_service("doc"),
                         client_id="doc-reader")
    assert (_string(c).get_text(), _string(c).signature()) == want
    _string(c).insert_text(0, "reader:")
    c.flush()
    want = (_string(c).get_text(), _string(c).signature())

    again = w.LocalServer(durable_dir=str(tmp_path))
    d = w.Container.load(w.Factory(again).create_document_service("doc"),
                         client_id="doc-back")
    assert (_string(d).get_text(), _string(d).signature()) == want


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_summary_loads_across_packages(tmp_path, writer, reader):
    """A summary and the tail after it, written by one package's file
    driver, load in the other package's ``Container`` (through its
    ``ContainerRuntime.load``): the summary alone gives the text at the
    summary, the summary and the tail the writers' text."""
    w, r = _api(writer), _api(reader)
    rng = random.Random(4)
    server = w.LocalServer(clock=_clock())
    a, b = _writers(w, server)
    _some_edits(w, a, b, rng)
    a.summarize()
    at_summary = (_string(a).get_text(), _string(a).signature())
    latest = server.latest_summary("doc")
    assert latest is not None
    _some_edits(w, a, b, rng)
    path = tmp_path / "doc.json"
    w.save_document(path, "doc", server.read_ops("doc", 0),
                    (latest.sequence_number, latest.summary))
    c = r.Container.load(r.load_document(path), client_id="reader",
                         connect=False, replay_trailing=False)
    assert (_string(c).get_text(), _string(c).signature()) == at_summary
    c = r.Container.load(r.load_document(path), client_id="reader",
                         connect=False)
    assert _string(c).get_text() == _string(a).get_text() \
        == _string(b).get_text()
    assert _string(c).signature() == _string(a).signature()
