"""The port's model path: the layers, attention, MLA, the experts, the
Mamba-2 mixer, the serving functions (prefill + decode), the training
loss of the decoders of every family (dense, moe, ssm, hybrid, vlm,
audio), their shapes on the meta device and the sharding helpers."""

from .flops import decode_flops_per_token, param_counts, train_flops_per_token
from .layers import activate_mesh, constrain, cross_entropy, current_mesh, fix_spec
from .mla import init_mla_cache, mla_attention, mla_decode_step
from .moe import moe_ffn
from .ssm import mamba_decode_step, mamba_mixer
from .transformer import (
    Transformer,
    cache_shapes,
    decode_step,
    dequantize_kv,
    forward,
    init_cache,
    init_params,
    loss_fn,
    param_shapes,
    prefill,
    quantize_kv,
)

__all__ = [
    "activate_mesh",
    "constrain",
    "current_mesh",
    "cross_entropy",
    "fix_spec",
    "Transformer",
    "init_params",
    "param_shapes",
    "forward",
    "loss_fn",
    "init_cache",
    "cache_shapes",
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
