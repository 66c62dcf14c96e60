"""fluidlint for the port — machine-enforced invariants over
``fluidframework_tpu_torch``, its tests and ``chip_smoke.py``.

The reference's pass families that do not reason about ``jax.jit``,
copied and pointed at the port, plus the port's own ``synccheck``; one
CLI (``python -m fluidframework_tpu_torch.analysis``):

- **layercheck** — the declared subpackage layering (analysis/
  layercheck.py holds the map; the port adds ``convert``).
- **synccheck** — device->host syncs inside the sidecars' dispatch
  loops outside their sync boundary (the reference's jaxhazards rule
  ``dispatch-loop-sync``; analysis/synccheck.py keeps its own API,
  ``check_package`` / ``check_source``).
- **lockcheck** — writes to lock-guarded attributes that bypass the
  lock.
- **obscheck** / **qoscheck** — observability-contract and
  overload-safety rules.
- **concheck** — lock-order cycles, blocking calls reachable from
  event-loop coroutines, awaits holding threading locks (runtime half:
  testing/sanitizer.py).
- **detcheck** — un-routed wall-clock reads and unseeded RNG on the
  deterministic planes (runtime half: testing/detsan.py).
- **wirecheck** — frame encoder/decoder drift against ``WIRE_SCHEMA``
  (runtime half: testing/wiresan.py).
- **shapecheck** — donated-table reuse, launch shapes that do not come
  from the bucket ladder, 64-bit widens in device-reachable code, literal
  shape mismatches, and device roots the dispatch loops reach that no
  prewarm walks (runtime half: testing/jitsan.py).
- **failcheck** — silent exception handlers on the serving planes
  (runtime half: testing/failsan.py).

The reference's jaxhazards has no copy: its dispatch-loop rule is
synccheck, and its ``jit-*`` rules guard a traced program the port does
not have. Findings are ``path:line rule-id message``,
suppressible per line with ``# fluidlint: disable=<rule-id>`` and
grandfathered through ``analysis/allowlist.txt`` (empty; capped at 10).
"""
from .core import DEFAULT_ROOTS, Finding, load_allowlist, run_analysis
from .synccheck import DISPATCH_LOOPS, RULES, check_package, check_source

__all__ = ["DEFAULT_ROOTS", "DISPATCH_LOOPS", "Finding", "RULES",
           "check_package", "check_source", "load_allowlist",
           "run_analysis"]
