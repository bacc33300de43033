"""Deterministic synthetic token batches (a copy of the reference's NumPy
generator, byte-identical tokens) and their DLT load descriptors."""

from .pipeline import SyntheticStream, batch_load_spec, make_batch

__all__ = ["SyntheticStream", "make_batch", "batch_load_spec"]
