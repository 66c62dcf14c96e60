"""Per-op trace demo: pick any op and print its ordered submit→ack
hop list with per-hop latencies — the "where is op X right now"
answer an ack stall investigation lacked.

One process, three planes:

- a real TCP ingress (AlfredServer) on a background thread,
- a GPU merge sidecar (``GpuMergeSidecar``, trace_ops on, on
  ``--device``: the card unless the CPU is asked for) subscribed
  server-side to the document's broadcaster,
- two socket clients editing concurrently.

For a chosen op the CLIENT sees its wire-path hops (submit,
driver-send, ingress, sequenced, fanout, deliver, ack) from its own
deserialized copy; the SIDECAR's copy carries the dispatch hops
(pack, settle). The script merges both by sequence number and prints
the combined breakdown, then the metrics-registry exposition and the
sidecar's flight-recorder tail.

Run: python -m fluidframework_tpu_torch.examples.op_trace [seq] [--device cpu]
"""
import argparse
import asyncio
import threading
import time

from fluidframework_tpu_torch.drivers.socket_driver import (
    SocketDocumentService,
)
from fluidframework_tpu_torch.loader import Container
from fluidframework_tpu_torch.obs import (
    REGISTRY,
    breakdown,
    format_breakdown,
    total_ms,
)
from fluidframework_tpu_torch.service.ingress import AlfredServer
from fluidframework_tpu_torch.service.gpu_sidecar import (
    GpuMergeSidecar,
)

DOC = "traced"


def start_server():
    server = AlfredServer()
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(server.start())
        started.set()
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert started.wait(10)
    return server, loop


def pump(svc, container, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        with svc.lock:
            if container.runtime.pending.count == 0:
                return
        time.sleep(0.02)
    raise TimeoutError("ops never acked")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("seq", nargs="?", type=int, default=None,
                        help="the sequence number of the op to trace "
                             "(default: ana's newest acked op)")
    parser.add_argument("--device", default="cuda",
                        help="the merge sidecar's torch device (default "
                             "cuda; cpu runs the plain version)")
    args = parser.parse_args(argv)
    server, loop = start_server()
    sidecar = GpuMergeSidecar(max_docs=8, capacity=256,
                              trace_ops=True, device=args.device)
    sidecar.subscribe(server.local, DOC, "app", "s")

    svc_a = SocketDocumentService("127.0.0.1", server.port, DOC)
    with svc_a.lock:
        ca = Container.load(svc_a, client_id="ana")
        sa = ca.runtime.create_datastore("app").create_channel(
            "sharedstring", "s")
        ca.flush()
    pump(svc_a, ca)

    svc_b = SocketDocumentService("127.0.0.1", server.port, DOC)
    with svc_b.lock:
        cb = Container.load(svc_b, client_id="ben")
        sb = cb.runtime.get_datastore("app").get_channel("s")

    # concurrent edits so the trace crosses real interleaving
    with svc_a.lock:
        for i in range(4):
            sa.insert_text(0, f"a{i} ")
        ca.flush()
    with svc_b.lock:
        sb.insert_text(0, "ben-was-here ")
        cb.flush()
    pump(svc_a, ca)
    pump(svc_b, cb)

    # flush the sidecar's accumulated window; sync() settles it so
    # the pack/settle hops are stamped
    sidecar.apply()
    sidecar.sync()

    # choose an op: newest of ana's acked ops, or by sequence number
    # from argv
    entry = ca.op_trace()
    if args.seq is not None:
        want = args.seq
        entry = next(
            (ca.op_trace(csn) for csn in range(1, ca._csn + 1)
             if (ca.op_trace(csn) or {}).get("sequenceNumber") == want),
            None,
        )
        if entry is None:
            print(f"no acked op with seq {want}")
            return 1

    seq = entry["sequenceNumber"]
    print(f"=== client-side trace of op seq={seq} "
          f"(csn={entry['clientSequenceNumber']}) ===")
    print(ca.op_breakdown(entry["clientSequenceNumber"]))

    # merge in the sidecar's dispatch hops for the same op
    sidecar_msg = next(
        (m for m in sidecar.last_settled_msgs
         if m.sequence_number == seq), None,
    )
    if sidecar_msg is not None:
        merged = list(entry["traces"])
        have = {(t.service, t.action, t.timestamp) for t in merged}
        merged += [
            t for t in sidecar_msg.traces
            if (t.service, t.action, t.timestamp) not in have
        ]
        print(f"\n=== merged with sidecar dispatch hops "
              f"({total_ms(merged):.3f} ms first→last) ===")
        print(format_breakdown(merged))
        hops = [h["hop"] for h in breakdown(merged)]
        assert "sidecar:pack" in hops and "sidecar:settle" in hops, (
            "sidecar hops missing from the merged trace"
        )

    print("\n=== per-hop summary over the ledgered ops ===")
    for hop, agg in sorted(ca.op_ledger.summary().items()):
        print(f"  {hop:<22} n={agg['count']:<4} "
              f"mean={agg['mean_ms']:8.3f}ms "
              f"max={agg['max_ms']:8.3f}ms")

    print("\n=== metrics registry (excerpt) ===")
    for line in REGISTRY.render_prometheus().splitlines():
        if line.startswith(("container_", "sidecar_", "sequencer_",
                            "ingress_")) and not line.endswith(" 0.0"):
            print(" ", line)

    print("\n=== sidecar flight recorder ===")
    print(sidecar.flight.dump(reason="example", last=8))

    with svc_a.lock:
        ca.close()
    with svc_b.lock:
        cb.close()
    svc_a.close()
    svc_b.close()
    loop.call_soon_threadsafe(loop.stop)
    print("\nOK: full submit→ack hop attribution for a live op over "
          "the TCP service, including sidecar dispatch hops.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
