"""SLO report walkthrough: declare objectives, serve open-loop
traffic, read the burn-rate verdicts — then watch the same
objectives breach under overload, with the profiler and span export
riding along.

Three acts, all deterministic (manual clock, seeded Poisson):

1. STEADY: the open-loop serving harness (tools/serve_bench.py)
   offers 0.8x capacity through the real ingress dispatch path; the
   SLO engine grades a submit→ack p99 budget and a goodput floor
   with multi-window burn rates — both hold.
2. OVERLOAD: the same config at 3x capacity. The backlog grows
   without bound, p99 collapses, both objectives burn through their
   budgets in BOTH windows -> breach, and the report cites the qos
   pressure context the breach happened under.
3. TOOLING: the continuous profiler's per-component attribution for
   the steady run, and one op's hop table exported as an OTLP-JSON
   span tree (obs/spans.py) and read back bit-exact.

Run: python -m fluidframework_tpu_torch.examples.slo_report
"""
import json
import os
import tempfile

from fluidframework_tpu_torch.obs.spans import (
    FileSpanExporter,
    otlp_to_hops,
)
from fluidframework_tpu_torch.obs.trace import stamp
from fluidframework_tpu_torch.tools.serve_bench import (
    ServeBenchConfig,
    run_serve_bench,
)


def show_report(title, report):
    print(f"\n=== {title} ===")
    for o in report.slo_report["objectives"]:
        bound = (f" (p99 budget {o['effective_threshold_ms']}ms)"
                 if o["kind"] == "latency"
                 else f" (floor {o['target']:.0%})")
        print(f"  {o['name']:<16} {o['verdict']:>6}  "
              f"burn fast={o['fast']['burn']:<7} "
              f"slow={o['slow']['burn']:<7}{bound}")
    ctx = report.slo_report["context"]["pressure"]
    print(f"  offered={report.offered_ops} acked={report.acked_ops} "
          f"p99={report.latency_p99_ms:.1f}ms "
          f"backlog_peak={report.backlog_peak} "
          f"pressure={ctx['tier_name']}")


def main():
    cfg = dict(n_docs=32, readers_per_doc=2, duration_s=4.0,
               capacity_ops_per_s=300.0, seed=11)

    # Act 1 — steady state, profiler riding along
    steady = run_serve_bench(ServeBenchConfig(
        offered_multiple=0.8, profile=True, **cfg))
    show_report("steady (0.8x capacity)", steady)
    verdicts = {o["name"]: o["verdict"]
                for o in steady.slo_report["objectives"]}
    assert set(verdicts.values()) == {"ok"}, verdicts

    print("\n  profiler attribution (thread-name -> component):")
    for comp, n in steady.profiler["by_component"].items():
        print(f"    {comp:<10} {n} samples")
    print(f"    sampler own cost: "
          f"{steady.profiler['overhead_pct']:.2f}%")

    # Act 2 — overload: the objectives must SEE it
    overload = run_serve_bench(ServeBenchConfig(
        offered_multiple=3.0, **cfg))
    show_report("overload (3x capacity)", overload)
    assert "submit-ack-p99" in overload.slo_breached_objectives
    assert "goodput-floor" in overload.slo_breached_objectives

    # Act 3 — span export: one op's path as an OTLP trace document
    t0 = 1722700000.125
    traces = stamp([], "client", "submit", timestamp=t0)
    stamp(traces, "ingress", "receive", timestamp=t0 + 0.0021)
    stamp(traces, "sequencer", "ticket", timestamp=t0 + 0.0038)
    stamp(traces, "broadcaster", "fanout", timestamp=t0 + 0.0049)
    stamp(traces, "client", "ack", timestamp=t0 + 0.0112)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spans.jsonl")
        doc = FileSpanExporter(path).export(
            traces, document_id="doc", client_id="alice", csn=1)
        with open(path, encoding="utf-8") as f:
            reread = json.loads(f.readline())
    spans = doc["resourceSpans"][0]["scopeSpans"][0]["spans"]
    print(f"\n=== span export ({len(spans)} spans, "
          f"trace {spans[0]['traceId'][:12]}…) ===")
    for s in spans[1:]:
        ms = (int(s["endTimeUnixNano"])
              - int(s["startTimeUnixNano"])) / 1e6
        print(f"  {s['name']:<20} +{ms:.3f} ms")
    back = otlp_to_hops(reread)
    assert [(t.service, t.action, t.timestamp) for t in back] == \
        [(t.service, t.action, t.timestamp) for t in traces]
    print("  round-trip through disk: bit-exact")

    print("\nOK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
