"""End-to-end op tracing: the canonical hop vocabulary + stamping.

A copy of the reference's ``obs/trace.py``. Fluid's protocol carries
``traces`` on every sequenced message (protocol.ts ITrace) so "where is
op X right now?" has an answer. This module is the ONE place the hop
vocabulary lives: every layer stamps through :func:`stamp`, which
validates the (service, action) pair against :data:`CANONICAL_HOPS` —
an unknown hop fails loudly at the call site. The table is the
reference's, letter for letter, so tooling groups and joins hops of
both packages alike.

A single op's submit→ack path, in canonical order:

    client:submit        the runtime op leaves the outbox (Container)
    driver:send          the driver puts it on the wire / in-proc bus
    ingress:receive      the service front door decodes the frame
    sequencer:ticket     deli assigns seq + msn
    sidecar:pack         the sidecar packed it into a round
    sidecar:settle       that round's settle boundary completed
    broadcaster:fanout   the service fanned the sequenced op out
    driver:deliver       the driver handed it to the container
    client:ack           the submitting container matched its csn

In the port only the sidecar hops are stamped (``GpuMergeSidecar`` with
``trace_ops`` on), and ``pool:migrate`` marks a mesh-pool migration on
the pool's own ``migration_traces`` list; the other hops belong to
layers the port has not copied yet, and stay in the table so it is the
reference's.
"""
from __future__ import annotations

import time
from typing import Optional

from ..protocol.messages import Trace

# (service, action) -> what the stamp means. A PURE LITERAL on purpose:
# a static reader can take it with ast.literal_eval, importing nothing.
CANONICAL_HOPS = {
    ("client", "submit"): "runtime op left the container outbox",
    ("driver", "send"): "driver put the op on the wire",
    ("ingress", "receive"): "service front door decoded the frame",
    ("sequencer", "ticket"): "deli assigned sequence number + msn",
    ("scriptorium", "write"): "op log persisted the sequenced op",
    ("scribe", "process"): "scribe's protocol replica processed it",
    ("sidecar", "pack"): "TPU sidecar packed the op into a round",
    ("sidecar", "settle"): "sidecar round settled (device done)",
    ("broadcaster", "fanout"): "service fanned the sequenced op out",
    ("driver", "deliver"): "driver delivered the broadcast",
    ("client", "ack"): "submitting container matched its csn",
    # fleet hops: the replicated / partitioned plane
    ("partition", "route"): "raw op routed to its queue partition",
    ("repl", "fence_check"): "epoch fence admitted the write",
    ("repl", "forward"): "leader offered the op to its followers",
    ("repl", "follower_append"): "a follower made the op durable",
    ("repl", "quorum_ack"): "quorum ack barrier satisfied",
    ("pool", "migrate"): "mesh pool migrated a hot document at settle",
}


def stamp(traces: list, service: str, action: str,
          timestamp: Optional[float] = None) -> list:
    """Append one canonical hop to ``traces`` and return the list.

    Raises ``ValueError`` for a (service, action) pair missing from
    :data:`CANONICAL_HOPS`: an unregistered hop name would fragment
    the vocabulary tooling groups/joins on."""
    if (service, action) not in CANONICAL_HOPS:
        raise ValueError(
            f"unknown trace hop {service}:{action}; register it in "
            "fluidframework_tpu_torch/obs/trace.py CANONICAL_HOPS"
        )
    traces.append(Trace(
        service=service, action=action,
        timestamp=time.time() if timestamp is None else timestamp,
    ))
    return traces


def hop_name(trace: Trace) -> str:
    return f"{trace.service}:{trace.action}"
