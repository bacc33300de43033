"""Step builders.  The port of the reference's ``runtime/train.py``, so far
only its serve step; the train step and its state come with the training
slice of the port."""

from __future__ import annotations

from repro_torch.config import ArchConfig, ShardingPolicy
from repro_torch.models import decode_step

__all__ = ["make_serve_step"]


def make_serve_step(cfg: ArchConfig, policy: ShardingPolicy):
    """Returns serve_step(model, cache, tokens, cache_len) -> (logits, cache);
    the cache is updated in place (see :func:`repro_torch.models.decode_step`)."""

    def serve_step(model, cache, tokens, cache_len):
        return decode_step(model, cfg, policy, cache, tokens, cache_len)

    return serve_step
