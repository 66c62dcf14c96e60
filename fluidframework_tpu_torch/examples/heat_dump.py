"""Cost attribution walkthrough: where did the device time go, and
who is spending it?

1. THE LEDGER: a deterministic HeatLedger (obs/heat.py) charged by
   the sidecar attribution plane — each dispatch round's wall-ms is
   split across the documents in the round proportional to the ops
   each contributed, at the settle boundary (counts come off the
   pack metadata; no mid-loop device sync). The sum of per-doc
   charges equals the round total: device time is conserved.
2. THE TENANT ROLLUP: every doc charge also rolls up to the doc's
   tenant on a usage ledger, so "hot tenants" rank by the same
   device-ms unit as "hot documents" — next to the ingress counters
   (ops offered/ticketed, bytes, sheds) that explain the bill.
3. THE FLEET VIEW: two nodes each serve their own top-k heat cut
   (the wire-1.4 ``heat`` frame; ``--dump-heat HOST:PORT`` on the
   CLI); obs.federation merges the cuts — per-key sums, re-ranked
   by the deterministic heat ordering.

Run: python -m fluidframework_tpu_torch.examples.heat_dump [--device cpu]
(the serve_bench slice's merge sidecar runs on ``--device``: the card
unless the CPU is asked for)
"""
import argparse

from fluidframework_tpu_torch.obs.federation import FederatedView
from fluidframework_tpu_torch.obs.heat import (
    HeatLedger,
    attribute_round,
    usage_ledger,
)
from fluidframework_tpu_torch.tools.serve_bench import (
    ServeBenchConfig,
    run_serve_bench,
)


def tenant_of(doc: str) -> str:
    return "tenant-%s" % (int(doc.rsplit("-", 1)[1]) % 3)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="the serve_bench sidecar's torch device "
                             "(default cuda; cpu runs the plain version)")
    args = parser.parse_args(argv)
    # -- 1. the ledger, charged by hand to show the mechanics --------
    heat = HeatLedger(clock=iter(range(1, 10**6)).__next__)
    usage = usage_ledger(clock=iter(range(1, 10**6)).__next__)
    rounds = [
        ({"doc-0": 6, "doc-1": 2, "doc-2": 2}, 5.0),
        ({"doc-0": 1, "doc-3": 3}, 2.0),
        ({"doc-1": 4, "doc-2": 4}, 4.0),
    ]
    charged = 0.0
    for counts, round_ms in rounds:
        charged += attribute_round(heat, counts, round_ms,
                                   usage=usage, tenant_of=tenant_of)
    total_ms = sum(ms for _, ms in rounds)
    print(f"attributed {charged:g}ms of {total_ms:g}ms "
          f"across {len(heat)} documents (conserved: "
          f"{abs(charged - total_ms) < 1e-9})")
    print("hot documents (accumulated device-ms):")
    for doc, ms in heat.top_k(4):
        print(f"  {doc:<8} {ms:7.3f}ms  tenant={tenant_of(doc)}")
    print("hot tenants:")
    for tenant, ms in usage.top_k(3, by="device_ms"):
        print(f"  {tenant:<10} {ms:7.3f}ms")

    # -- 2. the real plumbing: the serve_bench sidecar slice with the
    #       attribution plane on (the config16 shape) ----------------
    report = run_serve_bench(ServeBenchConfig(
        n_docs=16, readers_per_doc=2, duration_s=1.5,
        capacity_ops_per_s=200.0, seed=7,
        sidecar_docs=4, sidecar_steps=30, heat=True,
        sidecar_device=args.device))
    print(f"\nserve_bench sidecar: {report.sidecar_rounds} rounds, "
          f"{report.heat_attributed_ms:g}ms attributed")
    print(f"  top docs:    {report.heat_top_docs[:3]}")
    print(f"  top tenants: {report.heat_top_tenants[:3]}")
    assert report.heat_top_docs, "attribution plane produced no heat"

    # -- 3. federate two nodes' served cuts --------------------------
    fleet = FederatedView()
    fleet.add_heat("node-a",
                   docs=[["doc-0", 4.0], ["doc-1", 3.0]],
                   tenants=[["tenant-0", 4.0], ["tenant-1", 3.0]])
    fleet.add_heat("node-b",
                   docs=[["doc-1", 3.5], ["doc-9", 1.0]],
                   tenants=[["tenant-1", 3.5], ["tenant-0", 1.0]])
    merged = fleet.heat_top_k(k=3)
    print("\nfleet heat (two nodes merged):")
    print(f"  docs:    {merged['docs']}")
    print(f"  tenants: {merged['tenants']}")
    assert merged["docs"][0] == ["doc-1", 6.5], merged["docs"]

    print("\nOK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
