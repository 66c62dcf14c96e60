"""The port's networked front door against the JAX package's, on the CPU.

- One seeded TCP session: three documents, two writer ``Container``s
  each (one document on the single-socket driver, two on two
  ``MultiplexedSocketClient``s, one per writer group), rounds of
  concurrent edits, a summarize through the chunked upload plane and a
  late joiner through ``CachingMultiplexFactory``. It runs with the
  server and the clients taken from either package in all four
  pairings; every pairing gives the same op logs (``message_to_json``
  records modulo the client, driver and ingress hops, which read the
  wall clock), texts and signatures as the reference's own. The
  server's stamps ride ``LocalServer(clock=)``, a manual clock. The
  writers take turns under the drivers' locks so that the sequence
  order and every reference sequence number are the same in each run,
  while writer B's edits of a round stay concurrent with writer A's.
- ``encode_columns`` gives byte-equal ``submitOp`` frames in both
  packages.
- ``run_serve_bench`` at a small size (the sidecar on the CPU) gives
  equal ``deterministic_fields()`` and equal verdicts of the
  manual-clock objectives in both packages; the sidecar's settle
  objective grades wall milliseconds and is left out.

Tolerance: exact for every compared field.
"""
import asyncio
import contextlib
import functools
import importlib
import random
import threading
import time
import types

import pytest

REF, PORT = "fluidframework_tpu", "fluidframework_tpu_torch"
PAIRINGS = [(PORT, PORT), (REF, PORT), (PORT, REF)]  # (server, client)
DOCS = ("tcp-0", "tcp-1", "tcp-2")
ROUNDS, SUMMARY_ROUND = 4, 1
WALL_HOPS = ("client", "driver", "ingress")


def _api(package: str) -> types.SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{package}.{name}")

    return types.SimpleNamespace(
        AlfredServer=m("service.ingress").AlfredServer,
        pack_frame=m("service.ingress").pack_frame,
        LocalServer=m("service.local_server").LocalServer,
        SocketDocumentService=m("drivers.socket_driver")
        .SocketDocumentService,
        MultiplexedSocketClient=m("drivers.caching_driver")
        .MultiplexedSocketClient,
        CachingMultiplexFactory=m("drivers.caching_driver")
        .CachingMultiplexFactory,
        Container=m("loader").Container,
        message_to_json=m("protocol.serialization").message_to_json,
        encode_columns=m("protocol.columnar").encode_columns,
        mark_batch=m("protocol.constants").mark_batch,
        DocumentMessage=m("protocol.messages").DocumentMessage,
        MessageType=m("protocol.messages").MessageType,
        InsertOp=m("models.mergetree.ops").InsertOp,
        RemoveOp=m("models.mergetree.ops").RemoveOp,
        ReferenceType=m("models.mergetree.ops").ReferenceType,
    )


def _clock():
    t = {"v": 5000.0}

    def clock():
        t["v"] += 0.125
        return t["v"]

    return clock


@contextlib.contextmanager
def _serving(api):
    """``AlfredServer(LocalServer(clock=<manual>))`` on a background
    event loop at ``127.0.0.1:0``."""
    alfred = api.AlfredServer(api.LocalServer(clock=_clock()))
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(alfred.start())
        started.set()
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert started.wait(10)
    try:
        yield alfred
    finally:
        asyncio.run_coroutine_threadsafe(alfred.stop(), loop).result(10)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)


def _until(pred, what: str, timeout: float = 20.0) -> None:
    deadline = time.time() + timeout
    while not pred():
        if time.time() > deadline:
            raise TimeoutError(what)
        time.sleep(0.005)


def _string(container):
    return container.runtime.get_datastore("d").get_channel("s")


def _edit(rng, s, marker) -> None:
    n = s.get_length()
    r = rng.random()
    if n > 2 and r < 0.3:
        start = rng.randrange(n - 1)
        s.remove_text(start, min(n, start + rng.randint(1, 6)))
    elif n > 2 and r < 0.45:
        start = rng.randrange(n - 1)
        s.annotate_range(start, min(n, start + rng.randint(1, 5)),
                         {"bold": rng.randint(0, 3)})
    elif r < 0.5:
        s.insert_marker(rng.randint(0, n), marker, {"tag": rng.randint(0, 9)})
    else:
        s.insert_text(rng.randint(0, n), "".join(
            rng.choice("abcxyz") for _ in range(rng.randint(1, 6))))


def _quiet(local, doc, pair) -> bool:
    """Every writer has processed the whole log and has no op in
    flight."""
    last = local.get_orderer(doc).sequencer.sequence_number
    for svc, c in pair:
        with svc.lock:
            if c.last_processed_seq != last or c.runtime.pending.count:
                return False
    return True


def _acked(svc, c) -> bool:
    with svc.lock:
        return c.runtime.pending.count == 0


@functools.lru_cache(maxsize=None)
def _session(server_pkg: str, client_pkg: str, seed: int = 5) -> dict:
    s, c = _api(server_pkg), _api(client_pkg)
    rng = random.Random(seed)
    marker = c.ReferenceType.TILE
    with _serving(s) as alfred:
        local, port = alfred.local, alfred.port
        mux = [c.MultiplexedSocketClient("127.0.0.1", port)
               for _ in range(2)]
        services, writers = [], {}
        try:
            for doc in DOCS:
                pair = []
                for g, who in enumerate("ab"):
                    if doc == DOCS[0]:
                        svc = c.SocketDocumentService("127.0.0.1", port,
                                                      doc)
                        services.append(svc)
                    else:
                        svc = mux[g].document_service(doc)
                    with svc.lock:
                        pair.append((svc, c.Container.load(
                            svc, client_id=f"{doc}-{who}")))
                _until(lambda: _quiet(local, doc, pair), f"{doc} joins")
                (sa, ca), _ = pair
                with sa.lock:
                    ca.runtime.create_datastore("d").create_channel(
                        "sharedstring", "s")
                    ca.flush()
                _until(lambda: _quiet(local, doc, pair), f"{doc} attach")
                writers[doc] = pair
            acks = []
            for rnd in range(ROUNDS):
                for doc, pair in writers.items():
                    (sa, ca), (sb, cb) = pair
                    # B's dispatch waits on its lock, so B edits on the
                    # view before A's ops: concurrent, in a fixed order
                    with sb.lock:
                        with sa.lock:
                            for _ in range(rng.randint(1, 4)):
                                _edit(rng, _string(ca), marker)
                            ca.flush()
                        _until(lambda: _acked(sa, ca), f"{doc} A acked")
                        for _ in range(rng.randint(1, 4)):
                            _edit(rng, _string(cb), marker)
                        cb.flush()
                    _until(lambda: _quiet(local, doc, pair),
                           f"{doc} round {rnd}")
                if rnd == SUMMARY_ROUND:
                    sa, ca = writers[DOCS[1]][0]
                    with sa.lock:
                        ca.on("summaryAck", acks.append)
                        ca.summarize()
                    _until(lambda: acks and _quiet(
                        local, DOCS[1], writers[DOCS[1]]), "summary ack")
            factory = c.CachingMultiplexFactory("127.0.0.1", port)
            late_svc = factory.create_document_service(DOCS[1])
            with late_svc.lock:
                late = c.Container.load(late_svc, client_id="late")
            _until(lambda: _quiet(local, DOCS[1], [(late_svc, late)]),
                   "late joiner")
            out = {"late": _string(late).get_text(), "docs": {}}
            for doc, pair in writers.items():
                views = []
                for svc, w in pair:
                    with svc.lock:
                        views.append((_string(w).get_text(),
                                      _string(w).signature()))
                log = []
                for m in local.read_ops(doc, 0):
                    rec = s.message_to_json(m)
                    rec["traces"] = [t for t in rec.get("traces") or []
                                     if t["service"] not in WALL_HOPS]
                    log.append(rec)
                out["docs"][doc] = {"views": views, "log": log}
            for svc, w in (p for pair in writers.values() for p in pair):
                with svc.lock:
                    w.close()
            factory.close()
            return out
        finally:
            for svc in services + mux:
                svc.close()


@pytest.mark.parametrize("server_pkg,client_pkg", PAIRINGS,
                         ids=lambda p: p.rsplit("_", 1)[-1])
def test_tcp_session_matches_reference(server_pkg, client_pkg):
    want = _session(REF, REF)
    got = _session(server_pkg, client_pkg)
    for doc in DOCS:
        views = got["docs"][doc]["views"]
        assert views[0] == views[1], doc
        assert views == want["docs"][doc]["views"], doc
        assert got["docs"][doc]["log"] == want["docs"][doc]["log"], doc
    assert got["late"] == want["late"] == \
        got["docs"][DOCS[1]]["views"][0][0]
    # the summary ack truncated the summarized document's log
    assert got["docs"][DOCS[1]]["log"][0]["sequenceNumber"] > 1


def test_columnar_frames_are_byte_equal():
    frames = []
    for package in (REF, PORT):
        api = _api(package)
        ops = [api.InsertOp(pos1=3, text="col"),
               api.RemoveOp(pos1=1, pos2=4),
               api.InsertOp(pos1=0, text="umnar")]
        batch = [api.DocumentMessage(
            client_sequence_number=i + 1, reference_sequence_number=7,
            type=api.MessageType.OPERATION, contents=op,
            metadata=(api.mark_batch(None, i == 0) if i in (0, 2)
                      else None))
            for i, op in enumerate(ops)]
        cols = api.encode_columns(batch)
        assert cols is not None and cols["n"] == 3
        frames.append(api.pack_frame({"type": "submitOp",
                                      "document_id": "d", "cols": cols}))
    assert frames[0] == frames[1]


@pytest.mark.parametrize("offered", [0.8, 3.0])
def test_serve_bench_matches_reference(offered):
    reports = []
    for package in (REF, PORT):
        sb = importlib.import_module(f"{package}.tools.serve_bench")
        kw = dict(n_docs=8, readers_per_doc=2, duration_s=1.5,
                  tick_s=0.05, capacity_ops_per_s=100.0,
                  offered_multiple=offered, seed=11, sidecar_docs=2,
                  sidecar_steps=10)
        if package == PORT:
            kw["sidecar_device"] = "cpu"
        reports.append(sb.run_serve_bench(sb.ServeBenchConfig(**kw)))
    ref, port = reports
    assert port.deterministic_fields() == ref.deterministic_fields()
    assert port.sidecar_rounds == ref.sidecar_rounds > 0
    verdicts = [{o["name"]: o["verdict"]
                 for o in r.slo_report["objectives"]
                 if o["name"] != "sidecar-settle-p99"} for r in reports]
    assert verdicts[0] == verdicts[1]
    assert len(verdicts[0]) == 2
    if offered > 1.0:
        assert set(verdicts[0].values()) == {"breach"}
