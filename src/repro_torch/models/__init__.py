"""The port's model path: the layers, attention, MLA, the experts, the
Mamba-2 mixer, the serving functions (prefill + decode) and the training
loss of the decoders of every family (dense, moe, ssm, hybrid, vlm,
audio)."""

from .transformer import (
    Transformer,
    decode_step,
    dequantize_kv,
    forward,
    init_cache,
    init_params,
    loss_fn,
    prefill,
    quantize_kv,
)
from .flops import decode_flops_per_token, param_counts, train_flops_per_token
from .mla import init_mla_cache, mla_attention, mla_decode_step
from .moe import moe_ffn
from .ssm import mamba_decode_step, mamba_mixer

__all__ = [
    "Transformer",
    "init_params",
    "forward",
    "loss_fn",
    "init_cache",
    "prefill",
    "decode_step",
    "quantize_kv",
    "dequantize_kv",
    "mla_attention",
    "mla_decode_step",
    "init_mla_cache",
    "moe_ffn",
    "mamba_mixer",
    "mamba_decode_step",
    "param_counts",
    "train_flops_per_token",
    "decode_flops_per_token",
]
