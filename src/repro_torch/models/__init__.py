"""The port's model path: the layers, attention, the Mamba-2 mixer and the
serving functions (prefill + decode) of the dense, ssm and hybrid decoders."""

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
from .flops import decode_flops_per_token, param_counts, train_flops_per_token
from .ssm import mamba_decode_step, mamba_mixer

__all__ = [
    "Transformer",
    "init_params",
    "forward",
    "init_cache",
    "prefill",
    "decode_step",
    "quantize_kv",
    "dequantize_kv",
    "mamba_mixer",
    "mamba_decode_step",
    "param_counts",
    "train_flops_per_token",
    "decode_flops_per_token",
]
