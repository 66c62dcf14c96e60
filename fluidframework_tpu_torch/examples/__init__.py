"""Runnable demonstrations of the port's framework API: headless
console apps, each run as ``python -m
fluidframework_tpu_torch.examples.<name>``, each printing ``OK`` and
exiting 0 (``README.md`` lists them). Copies of the reference's
``examples/`` scripts; importing a script runs nothing."""
