"""Frozen traffic generator: seeded concurrent SharedString sessions
recorded through scalar merge-tree clients over a plain deli."""
