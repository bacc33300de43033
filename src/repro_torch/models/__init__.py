"""The port's model path: the dense decoder's layers, attention and serving
functions (prefill + decode)."""

from .transformer import (
    Transformer,
    decode_step,
    dequantize_kv,
    forward,
    init_cache,
    init_params,
    prefill,
    quantize_kv,
)

__all__ = [
    "Transformer",
    "init_params",
    "forward",
    "init_cache",
    "prefill",
    "decode_step",
    "quantize_kv",
    "dequantize_kv",
]
