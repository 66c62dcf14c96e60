"""Secure multi-tenant deployment: token-gated ingress over the
PARTITIONED ordering pipeline, write + read-only clients.

Shows the service-plane features end to end: riddler-style tenancy
(signed claims tokens, scopes), the kafka-shaped partitioned pipeline
behind the front door, and a doc:read connection that observes without
joining the quorum.

Run: python -m fluidframework_tpu_torch.examples.secure_multitenant
"""
import asyncio
import sys
import threading

from fluidframework_tpu_torch.drivers.socket_driver import (
    SocketDocumentService,
)
from fluidframework_tpu_torch.loader import Container
from fluidframework_tpu_torch.service import TenantManager, sign_token
from fluidframework_tpu_torch.service.ingress import AlfredServer
from fluidframework_tpu_torch.service.partitioning import PartitionedServer
from fluidframework_tpu_torch.service.tenancy import SCOPE_READ


def main() -> int:
    # --- operator side: tenants + the partitioned service -------------
    tenants = TenantManager()
    acme = tenants.create_tenant("acme", "Acme Inc")
    server = AlfredServer(
        PartitionedServer(n_partitions=3), tenants=tenants)
    loop = asyncio.new_event_loop()
    started = threading.Event()

    async def run():
        await server.start()
        started.set()
        await server.serve_forever()

    threading.Thread(
        target=lambda: loop.run_until_complete(run()), daemon=True
    ).start()
    assert started.wait(10)
    print(f"secure service on 127.0.0.1:{server.port} "
          "(3 queue partitions, token-gated)")

    doc = "quarterly-report"

    # --- no token: rejected -------------------------------------------
    intruder = SocketDocumentService(
        "127.0.0.1", server.port, doc, timeout=5)
    try:
        intruder.connect_to_delta_stream("eve", lambda m: None)
        raise AssertionError("unauthenticated connect must fail")
    except PermissionError as e:
        print(f"unauthenticated connect rejected: {e}")
    intruder.close()

    # --- writer with a doc:write token --------------------------------
    writer_token = sign_token(acme.key, "acme", doc, "alice")
    svc_w = SocketDocumentService(
        "127.0.0.1", server.port, doc,
        tenant_id="acme", token=writer_token)
    with svc_w.lock:
        alice = Container.load(svc_w, client_id="alice")
        text = (alice.runtime.create_datastore("d")
                .create_channel("sharedstring", "body"))
        alice.flush()
        text.insert_text(0, "Q3 numbers are up.")
        alice.flush()

    # --- read-only observer (doc:read scope, never joins quorum) ------
    ro_token = sign_token(acme.key, "acme", doc, "auditor",
                          scopes=[SCOPE_READ])
    svc_r = SocketDocumentService(
        "127.0.0.1", server.port, doc,
        tenant_id="acme", token=ro_token, mode="read")
    seen = []
    svc_r.connect_to_delta_stream("auditor", seen.append)
    ops = svc_r.read_ops(0)
    print(f"auditor read {len(ops)} sequenced ops with a read token")
    assert any("Q3" in str(getattr(m, "contents", "")) for m in ops)

    # the read connection cannot pin the msn or write
    inner = server.local.svc
    assert "auditor" not in inner.orderer(doc).sequencer.clients

    # --- the queue really sequenced it --------------------------------
    part = inner.partition_of(doc)
    print(f"doc routed to partition {part}, committed offset "
          f"{inner.queue.committed(part)}")
    assert inner.queue.committed(part) >= 1

    with svc_w.lock:
        final = text.get_text()
    print(f"document body: {final!r}")
    svc_w.close()
    svc_r.close()
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
