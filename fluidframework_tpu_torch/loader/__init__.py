"""Loader layer: Container + delta management over drivers.

Reference analogue: packages/loader/container-loader.
"""
from .container import Container

__all__ = ["Container"]
