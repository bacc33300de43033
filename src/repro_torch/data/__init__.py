"""Deterministic synthetic token batches (a copy of the reference's NumPy
generator, byte-identical tokens)."""

from .pipeline import SyntheticStream, make_batch

__all__ = ["SyntheticStream", "make_batch"]
