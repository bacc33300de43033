"""Analytic parameter/FLOPs models per architecture.

Used by (a) the DLT planner (V_comp per batch), (b) the roofline report
(MODEL_FLOPS = 6*N*D dense / 6*N_active*D MoE), (c) memory budgeting notes.

A copy of the reference's ``models/flops.py`` (plain Python; the port
imports nothing of the reference), giving the same counts for the same
configuration.
"""

from __future__ import annotations

import dataclasses

from repro_torch.config import ArchConfig

__all__ = ["ParamCounts", "param_counts", "train_flops_per_token", "decode_flops_per_token"]


@dataclasses.dataclass(frozen=True)
class ParamCounts:
    total: int
    active: int  # per-token activated (MoE: shared + top_k experts)
    embed: int


def _attn_params(cfg: ArchConfig) -> int:
    if cfg.mla is not None:
        m = cfg.mla
        dq = m.qk_nope_head_dim + m.qk_rope_head_dim
        return (
            cfg.d_model * cfg.num_heads * dq
            + cfg.d_model * m.kv_lora_rank
            + cfg.d_model * m.qk_rope_head_dim
            + m.kv_lora_rank * cfg.num_heads * m.qk_nope_head_dim
            + m.kv_lora_rank * cfg.num_heads * m.v_head_dim
            + cfg.num_heads * m.v_head_dim * cfg.d_model
        )
    hd = cfg.head_dim
    return cfg.d_model * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)


def _mlp_params(cfg: ArchConfig) -> int:
    return 3 * cfg.d_model * cfg.d_ff


def _moe_params(cfg: ArchConfig):
    mo = cfg.moe
    per_expert = 3 * cfg.d_model * mo.d_ff_expert
    total = mo.num_experts * per_expert + cfg.d_model * mo.num_experts
    total += mo.num_shared * per_expert
    active = (mo.top_k + mo.num_shared) * per_expert + cfg.d_model * mo.num_experts
    return total, active


def _ssm_params(cfg: ArchConfig) -> int:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.d_inner(d)
    h = s.n_heads(d)
    g = 1
    conv_dim = d_in + 2 * g * s.d_state
    return (
        d * (2 * d_in + 2 * g * s.d_state + h)
        + s.d_conv * conv_dim
        + 3 * h
        + d_in
        + d_in * d
    )


def param_counts(cfg: ArchConfig) -> ParamCounts:
    embed = cfg.vocab_size * cfg.d_model * (cfg.num_codebooks if cfg.family == "audio" else 1)
    head = 0 if cfg.tie_embeddings else cfg.d_model * cfg.vocab_size * (
        cfg.num_codebooks if cfg.family == "audio" else 1
    )
    per_layer_total = 0
    per_layer_active = 0
    if cfg.has_attention:
        a = _attn_params(cfg)
        per_layer_total += a
        per_layer_active += a
    if cfg.has_ssm:
        s = _ssm_params(cfg)
        per_layer_total += s
        per_layer_active += s
    if cfg.family == "moe":
        t, a = _moe_params(cfg)
        per_layer_total += t
        per_layer_active += a
    elif cfg.d_ff:
        m = _mlp_params(cfg)
        per_layer_total += m
        per_layer_active += m
    if cfg.family == "vlm":
        per = cfg.patch_dim * cfg.d_model
        embed += per
    total = embed + head + cfg.num_layers * per_layer_total
    active = embed + head + cfg.num_layers * per_layer_active
    return ParamCounts(total=total, active=active, embed=embed)


def train_flops_per_token(cfg: ArchConfig, seq_len: int | None = None) -> float:
    """6 * N_active (+ attention quadratic term when seq_len given)."""
    pc = param_counts(cfg)
    base = 6.0 * (pc.active - pc.embed)  # embeddings are gathers, not matmuls
    if seq_len and cfg.has_attention:
        w = cfg.window if cfg.attn_type == "swa" else 0
        ctx = min(seq_len, w) if w else seq_len
        # fwd+bwd attention score/value matmuls per layer:
        # 2 matmuls * 2 FLOP/MAC * 3x (fwd + 2x bwd), causal halves ctx
        base += 12.0 * cfg.num_layers * cfg.num_heads * cfg.head_dim * (ctx / 2.0)
    return base


def decode_flops_per_token(cfg: ArchConfig, context: int) -> float:
    pc = param_counts(cfg)
    base = 2.0 * (pc.active - pc.embed)
    if cfg.has_attention:
        w = cfg.window if cfg.attn_type == "swa" else 0
        ctx = min(context, w) if w else context
        base += 4.0 * cfg.num_layers * cfg.num_heads * cfg.head_dim * ctx
    return base
