"""Deterministic synthetic data pipeline.

A copy of the reference's ``data/pipeline.py`` (NumPy only; the port imports
nothing of the reference).  Batches are pure functions of (step, arch,
shape): stateless and restart-safe, and byte-identical to the reference's
for the same arguments.

Each batch also carries its DLT *load descriptor* (bytes, flops) for the
planner (:func:`batch_load_spec`) — the bridge between the data pipeline and
the paper's scheduler.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.config import ArchConfig
from repro_torch.core.planner import BatchSpec
from repro_torch.models.flops import train_flops_per_token

__all__ = ["SyntheticStream", "make_batch", "batch_load_spec"]


def _tokens(step: int, seed: int, shape, vocab: int) -> np.ndarray:
    """Counter-based deterministic token block (stateless, like a PRNG skip)."""
    rng = np.random.Generator(np.random.Philox(key=seed, counter=step))
    return rng.integers(0, vocab, size=shape, dtype=np.int32)


def make_batch(cfg: ArchConfig, batch_size: int, seq_len: int, step: int, seed: int = 0):
    """Build one training batch (tokens, labels shifted, masks/patches)."""
    if cfg.family == "audio":
        toks = _tokens(step, seed, (batch_size, seq_len + 1, cfg.num_codebooks), cfg.vocab_size)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    elif cfg.family == "vlm":
        text_len = seq_len - cfg.num_patches
        toks = _tokens(step, seed, (batch_size, text_len + 1), cfg.vocab_size)
        rngp = np.random.Generator(np.random.Philox(key=seed + 1, counter=step))
        patches = rngp.normal(size=(batch_size, cfg.num_patches, cfg.patch_dim)).astype(np.float32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "patches": patches}
    else:
        toks = _tokens(step, seed, (batch_size, seq_len + 1), cfg.vocab_size)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return batch


def batch_load_spec(cfg: ArchConfig, batch_size: int, seq_len: int) -> BatchSpec:
    """The DLT load descriptor of one global batch (planner input)."""
    if cfg.family == "vlm":
        bytes_per_sample = (
            (seq_len - cfg.num_patches) * 4 + cfg.num_patches * cfg.patch_dim * 4
        )
    elif cfg.family == "audio":
        bytes_per_sample = seq_len * cfg.num_codebooks * 4
    else:
        bytes_per_sample = seq_len * 4
    flops_per_sample = train_flops_per_token(cfg, seq_len) * seq_len
    return BatchSpec(
        num_samples=batch_size,
        bytes_per_sample=float(bytes_per_sample),
        flops_per_sample=float(flops_per_sample),
    )


@dataclasses.dataclass
class SyntheticStream:
    """Iterator facade with prefetch-like lookahead (CPU: eager numpy)."""

    cfg: ArchConfig
    batch_size: int
    seq_len: int
    seed: int = 0
    step: int = 0

    def __iter__(self):
        return self

    def __next__(self):
        b = make_batch(self.cfg, self.batch_size, self.seq_len, self.step, self.seed)
        self.step += 1
        return b

    def peek_load_spec(self) -> BatchSpec:
        return batch_load_spec(self.cfg, self.batch_size, self.seq_len)

    def at_step(self, step: int) -> "SyntheticStream":
        return dataclasses.replace(self, step=step)
