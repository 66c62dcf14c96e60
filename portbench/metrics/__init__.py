"""One reader per metric, ``metrics/<name>.py``, found by the metric's
name in ``BENCHMARK.json``: ``read(readings) -> float | None``. A reader
that finds nothing to read returns None, and the metric is left out of
the result line."""
