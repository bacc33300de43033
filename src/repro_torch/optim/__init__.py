"""Optimizer substrate of the port: AdamW, schedules, clipping, gradient
compression (the reference's ``optim`` package)."""

from .adamw import AdamWState, adamw_init, adamw_update, cosine_lr, global_norm
from .compress import (
    CompressorState,
    int8_compress,
    int8_decompress,
    topk_compress_init,
    topk_compress_update,
)

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_lr",
    "global_norm",
    "CompressorState",
    "int8_compress",
    "int8_decompress",
    "topk_compress_init",
    "topk_compress_update",
]
