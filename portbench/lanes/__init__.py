"""The benchmark's lanes: the part of a run that drives one plane of the
program. A configuration names its lane with its ``"lane"`` key
(``DEFAULT`` where it has none); ``cell.load_lane`` loads
``lanes/<lane>.py`` by its path, so a lane is added as one new file and
nothing else is edited.

A lane's file gives:

- ``CONFIG_KEYS`` and ``TRAFFIC_KEYS``: the keys it reads from the
  configuration's and the traffic mix's files, which the spec test checks
  in every file under this lane (beside the keys every configuration
  holds: ``name``, ``source``, ``deployment``, ``reduced``, ``assumed``,
  ``guarantees``);
- ``Recording(config, seed, workers)``: the cell's traffic being made
  from the seed, started before torch loads (with more than one worker
  in spawned processes, which can take only work importable by module
  path: not a function of the lane's own file). Called, it waits for the
  traffic and returns it; ``stop()`` ends its processes;
- ``Run(cell, seed, device, trace, recording, log, **parts)``: the lane's
  set-up, which opens the program, waits for the traffic and warms every
  shape the window uses; ``parts`` stand in for the lane's own pieces (a
  test's broken path, a control). Then ``window(seconds)`` runs the
  timed window and returns a ``readings.Window`` once the device is done,
  and ``check()`` drops what of the program the check does not need,
  runs the plain reference and returns ``(checks, failed, least_s)``:
  every compared number with its limit (``{name: {"value", "limit"}}``),
  the messages or operations that failed, and each round's least time by
  the roofline (None where the lane has none);
- ``PHASES``: ``(column, label)`` of the host's phases in a round, in
  order, for ``idle_gaps``; ``slices(readings)``, a line of how the
  window drifts, for the log; ``extras(readings)``, the lane's own keys
  of the result line;
- ``KERNEL``: ``(name, pattern)`` of the window kernel, the device
  operation that ends each round: one launch a round whose name holds
  ``pattern``; the trace is tied to the host's clock by them, and
  ``trace.read`` returns their times as ``<name>_kernel_s`` and the
  launches it lost as ``<name>_lost``. ``SUMS``: ``{name: pattern}`` of
  further device operations whose time in the window is summed, as
  ``<name>_s``.

The frame around a lane (``cell.run``, ``run.py``) loads the cell, times
``setup_s``, starts and stops the trace, reads ``memory_peak_bytes``,
calls the metric readers, shapes the result line and checks what was
imported.
"""

DEFAULT = "array"
