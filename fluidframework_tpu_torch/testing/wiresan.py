"""wiresan — a runtime wire-schema sanitizer for the frame protocol.

The dynamic half of the wirecheck static pass
(analysis/wirecheck.py), completing the family-pair pattern
(concheck<->fluidsan, detcheck<->detsan, failcheck<->failsan): the
static analyzer extracts, from the encoder/decoder ASTs, the
per-frame-type field schema the code CAN put on the wire and checks
it against the reviewed ``WIRE_SCHEMA`` registry
(protocol/constants.py); wiresan observes the frames that ACTUALLY
cross the serialize/dispatch seams and trips LOUDLY when a
registered frame type carries a field the registry does not know.
The differential test (tests/test_wiresan.py) drives the real chaos
sweep, a serve_bench slice and a live TCP session and asserts every
runtime-observed (frame type, field) is in the static schema — a gap
fails BY NAME as an analyzer-resolution or registry gap, never
silently — with two-way non-vacuity (every registry frame type
observed; at least one optional-presence field observed both present
and omitted, proving the emit guards actually guard).

What gets patched (``install()``):

- ``service.ingress.pack_frame`` — every server->client frame
  (including the in-proc chaos/serve_bench stacks, whose real
  ``_ClientSession.send`` packs through this module global).
- ``drivers.socket_driver.pack_frame`` — every client->server frame
  (the driver imported the function BY VALUE, so the module
  attribute is patched separately).
- ``AlfredServer._dispatch`` — every frame the server dispatches,
  which covers transports that never pack (chaos's ChaosTransport
  and serve_bench hand dicts straight to ``_dispatch``).

Recording is structural only (field names, presence, emptiness —
never values): each top-level key of a frame is recorded under the
frame's ``"type"``, and op payloads riding ``"msg"``/``"msgs"``
(sequenced messages) and ``"op"``/``"ops"``/``"operation"``
(document messages) are recorded under the registry's ``msg:*``
pseudo-types. Frames whose type is NOT in the registry are recorded
in ``unknown_types()`` but do NOT trip: the sanitize lane runs the
whole suite, and tests deliberately throw malformed frames at the
server — the contract wiresan enforces is that KNOWN frames never
grow unregistered fields at runtime.

Trips count in ``wiresan_trips_total`` and fail the test that
caused them under the pytest plugin ``testing/sanitize_plugin.py``,
same as the other sanitizers.
"""
from __future__ import annotations

import dataclasses
import _thread
from typing import Optional

from ..obs import metrics as obs_metrics

_TRIPS_TOTAL = obs_metrics.REGISTRY.counter(
    "wiresan_trips_total",
    "wiresan runtime frames carrying a wire field absent from the "
    "reviewed WIRE_SCHEMA registry")

# frame keys whose values are op payloads: key -> (pseudo-type,
# is-list). A non-dict payload (None nack operation, an already
# opaque blob) is counted for the FRAME field but not descended into.
# "cols" is the wire-1.3 columnar submitOp payload: the dict IS the
# column layout (protocol/columnar.py), so the descent records its
# column names against the cols:columnar pseudo-type exactly like
# the row payloads record against msg:*.
_PAYLOAD_KEYS = {
    "msg": ("msg:sequenced", False),
    "msgs": ("msg:sequenced", True),
    "op": ("msg:document", False),
    "ops": ("msg:document", True),
    "operation": ("msg:document", False),
    "cols": ("cols:columnar", False),
}


@dataclasses.dataclass
class Trip:
    """One runtime frame carrying an unregistered wire field."""

    frame_type: str
    field: str
    seam: str               # "pack:ingress" | "pack:driver" | "dispatch"

    def describe(self) -> str:
        return (
            f"wiresan: runtime frame type {self.frame_type!r} "
            f"(seam {self.seam}) carries wire field {self.field!r} "
            "that is absent from the WIRE_SCHEMA registry "
            "(protocol/constants.py) — either the registry is "
            "missing a reviewed entry or an encoder grew a field "
            "the static wirecheck pass cannot see; add the entry "
            "(with its since-version) or fix the emit, and "
            "regenerate protocol/WIRE_SCHEMA.json"
        )


class _State:
    def __init__(self) -> None:
        self.installs = 0
        self.originals: dict = {}
        self.trips: list[Trip] = []
        self.tripped_keys: set = set()
        # frame type -> observed frame count
        self.frames: dict[str, int] = {}
        # (frame type, field) -> [present count, empty count]
        self.fields: dict[tuple, list] = {}
        # (frame type, field) -> {seams it crossed}
        self.field_seams: dict[tuple, set] = {}
        self.unknown: dict[str, int] = {}
        self.schema: dict[str, dict] = {}


_STATE = _State()
_LOCK = _thread.allocate_lock()


def _load_schema() -> dict:
    """frame type -> {field: (since, optional, tolerated)} from the
    live registry (runtime import is fine here: testing/ lints
    nothing — the imports-nothing discipline binds the PASS)."""
    from ..protocol.constants import WIRE_SCHEMA, wire_schema_fields

    return {t: wire_schema_fields(t) for t in WIRE_SCHEMA}


def _record_payload(value, ptype: str, seam: str) -> None:
    if not isinstance(value, dict):
        return
    _record_fields(ptype, value, seam, discriminator=False)
    # tree channel-op descent (wire 1.5): the sharedtree payload
    # rides the runtime envelope two levels down — msg contents hold
    # {"kind": "op", ..., "contents": {"type": "tree", ...}}.
    # Keyed strictly on the "tree" discriminator: tree-schema ops and
    # foreign channels share the envelope but not the msg:tree schema
    envelope = value.get("contents")
    if isinstance(envelope, dict) and \
            envelope.get("kind", "op") == "op":
        leaf = envelope.get("contents")
        if isinstance(leaf, dict) and leaf.get("type") == "tree":
            _record_fields("msg:tree", leaf, seam,
                           discriminator=False)


def _record_fields(ftype: str, frame: dict, seam: str,
                   discriminator: bool = True) -> None:
    spec = _STATE.schema.get(ftype)
    _STATE.frames[ftype] = _STATE.frames.get(ftype, 0) + 1
    for field, value in frame.items():
        if discriminator and field == "type":
            continue
        slot = _STATE.fields.setdefault((ftype, field), [0, 0])
        slot[0] += 1
        _STATE.field_seams.setdefault((ftype, field), set()).add(seam)
        if value is None or value == [] or value == {} or value == "":
            slot[1] += 1
        if spec is not None and field not in spec:
            key = (ftype, field)
            if key not in _STATE.tripped_keys:
                _STATE.tripped_keys.add(key)
                _STATE.trips.append(Trip(ftype, field, seam))
                _TRIPS_TOTAL.inc()
        if discriminator and field in _PAYLOAD_KEYS:
            ptype, is_list = _PAYLOAD_KEYS[field]
            if is_list and isinstance(value, (list, tuple)):
                for item in value:
                    _record_payload(item, ptype, seam)
            elif not is_list:
                _record_payload(value, ptype, seam)


def _record_frame(frame, seam: str) -> None:
    if not isinstance(frame, dict):
        return
    ftype = frame.get("type")
    if not isinstance(ftype, str):
        return
    with _LOCK:
        if ftype not in _STATE.schema:
            _STATE.unknown[ftype] = _STATE.unknown.get(ftype, 0) + 1
            return
        _record_fields(ftype, frame, seam)


# ---------------------------------------------------------------------------
# install / uninstall


def install() -> None:
    """Patch the pack/dispatch seams (refcounted, idempotent per
    balance with :func:`uninstall`)."""
    from ..drivers import socket_driver as drv_mod
    from ..service import ingress as ingress_mod

    with _LOCK:
        _STATE.installs += 1
        if _STATE.installs > 1:
            return
        _STATE.schema = _load_schema()

        orig_pack = ingress_mod.pack_frame
        orig_drv_pack = drv_mod.pack_frame
        orig_dispatch = ingress_mod.AlfredServer._dispatch

        def pack_ingress(data: dict) -> bytes:
            _record_frame(data, "pack:ingress")
            return orig_pack(data)

        def pack_driver(data: dict) -> bytes:
            _record_frame(data, "pack:driver")
            return orig_drv_pack(data)

        def dispatch(self, session, frame, nbytes: int = 0):
            _record_frame(frame, "dispatch")
            return orig_dispatch(self, session, frame, nbytes)

        for fn in (pack_ingress, pack_driver, dispatch):
            fn.__wiresan_wrapped__ = True  # type: ignore[attr-defined]
        _STATE.originals = {
            "pack_ingress": orig_pack,
            "pack_driver": orig_drv_pack,
            "dispatch": orig_dispatch,
        }
        ingress_mod.pack_frame = pack_ingress
        drv_mod.pack_frame = pack_driver
        ingress_mod.AlfredServer._dispatch = dispatch


def uninstall() -> None:
    from ..drivers import socket_driver as drv_mod
    from ..service import ingress as ingress_mod

    with _LOCK:
        if _STATE.installs == 0:
            return
        _STATE.installs -= 1
        if _STATE.installs:
            return
        ingress_mod.pack_frame = _STATE.originals["pack_ingress"]
        drv_mod.pack_frame = _STATE.originals["pack_driver"]
        ingress_mod.AlfredServer._dispatch = \
            _STATE.originals["dispatch"]
        _STATE.originals = {}


def installed() -> bool:
    return _STATE.installs > 0


# ---------------------------------------------------------------------------
# introspection (the differential's API)


def trips() -> list[Trip]:
    with _LOCK:
        return list(_STATE.trips)


def observed() -> dict:
    """(frame type, field) -> {"present": n, "empty": n} for every
    field observed on the wire since the last reset."""
    with _LOCK:
        return {
            key: {"present": present, "empty": empty}
            for key, (present, empty) in _STATE.fields.items()
        }


def observed_frames() -> dict:
    """frame type -> frames observed (registered types only)."""
    with _LOCK:
        return dict(_STATE.frames)


def observed_seams() -> dict:
    """(frame type, field) -> {seams} — which patched seams each
    field crossed. The differential uses this to hold the pack seams
    (frames built by IN-SCOPE encoders) to the static emit schema
    while leaving dispatch-seam traffic (frames handcrafted by test
    transports) to the registry check alone."""
    with _LOCK:
        return {key: set(seams)
                for key, seams in _STATE.field_seams.items()}


def unknown_types() -> dict:
    """frame type -> count for observed frames whose type is not in
    the registry (recorded, never tripped — see module docstring)."""
    with _LOCK:
        return dict(_STATE.unknown)


def optional_presence() -> dict:
    """(frame type, field) -> (times present, times omitted) for
    every optional-presence ('?') registry field of an observed
    frame type — the two-way non-vacuity evidence."""
    with _LOCK:
        out = {}
        for ftype, spec in _STATE.schema.items():
            total = _STATE.frames.get(ftype, 0)
            if not total or spec is None:
                continue
            for field, (_since, optional, _tol) in spec.items():
                if not optional:
                    continue
                present = _STATE.fields.get((ftype, field), [0, 0])[0]
                out[(ftype, field)] = (present, total - present)
        return out


def reset() -> None:
    with _LOCK:
        _STATE.trips = []
        _STATE.tripped_keys = set()
        _STATE.frames = {}
        _STATE.fields = {}
        _STATE.field_seams = {}
        _STATE.unknown = {}
