"""Per-architecture smoke tests of the port, mirroring the reference's
``tests/test_arch_smoke.py``: every registered architecture's reduced
variant (same family) through one forward and a few decode steps on the
CPU, shapes and finiteness checked; two train steps on one batch lower
the loss; prefill then decode against the full forward; the SSM families'
recurrence against their chunked forward; the int8 KV cache against the
float one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.config import ShardingPolicy, TrainConfig, get_arch, list_archs, smoke_variant
from repro_torch.data import make_batch
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
from repro_torch.runtime import make_train_state, make_train_step

ARCHS = [
    "phi4-mini-3.8b",
    "llama3.2-3b",
    "mistral-large-123b",
    "minitron-8b",
    "paligemma-3b",
    "mamba2-2.7b",
    "deepseek-v2-lite-16b",
    "kimi-k2-1t-a32b",
    "hymba-1.5b",
    "musicgen-medium",
]

POLICY = ShardingPolicy(attention_impl="chunked", attn_chunk=16)
B, S = 2, 32


def test_all_assigned_archs_registered():
    assert set(ARCHS) <= set(list_archs())


def _batch(cfg):
    return {k: torch.from_numpy(v) for k, v in make_batch(cfg, B, S, step=0).items()}


def _model(cfg):
    return init_params(cfg, seed=0, dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_and_finite(arch):
    cfg = smoke_variant(get_arch(arch))
    batch = _batch(cfg)
    logits, aux, _ = forward(_model(cfg), cfg, POLICY, batch["tokens"], batch.get("patches"))
    if cfg.family == "audio":
        assert logits.shape == (B, S, cfg.num_codebooks, cfg.vocab_size)
    else:  # vlm: the patch prefix and the text tail, S positions in all
        assert logits.shape == (B, S, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert torch.isfinite(aux) and (aux > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_reduces_loss(arch):
    cfg = smoke_variant(get_arch(arch))
    tcfg = TrainConfig(lr=1e-2, warmup_steps=0, total_steps=50, microbatches=1)
    state = make_train_state(_model(cfg), tcfg)
    step = make_train_step(cfg, POLICY, tcfg)
    batch = _batch(cfg)  # same batch twice: loss must drop
    state, m0 = step(state, batch)
    state, m1 = step(state, batch)
    l0, l1 = float(m0["loss"]), float(m1["loss"])
    assert np.isfinite(l0) and np.isfinite(l1)
    assert l1 < l0, (arch, l0, l1)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_runs(arch):
    cfg = smoke_variant(get_arch(arch))
    model = _model(cfg)
    cache = init_cache(cfg, B, max_len=S, dtype=torch.float32, device="cpu")
    shape = (B, 1, cfg.num_codebooks) if cfg.family == "audio" else (B, 1)
    tok = torch.zeros(shape, dtype=torch.int32)
    for n in range(3):
        logits, cache = decode_step(model, cfg, POLICY, cache, tok, n)
    if cfg.family == "audio":
        assert logits.shape == (B, 1, cfg.num_codebooks, cfg.vocab_size)
    else:
        assert logits.shape == (B, 1, cfg.vocab_size)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ["llama3.2-3b", "phi4-mini-3.8b", "deepseek-v2-lite-16b"])
def test_prefill_then_decode_matches_forward(arch):
    """Autoregressive consistency: the prefill cache + the decode of token t
    equal the full forward's logits at position t (the reference's 2e-4)."""
    cfg = smoke_variant(get_arch(arch))
    # dense MoE dispatch: capacity dropping is a gshard artifact orthogonal
    # to the cache machinery under test (gshard == dense: test_torch_moe.py)
    policy = POLICY if cfg.moe is None else ShardingPolicy(
        attention_impl="chunked", attn_chunk=16, moe_impl="dense")
    model = _model(cfg)
    toks = _batch(cfg)["tokens"]
    full_logits, _, _ = forward(model, cfg, policy, toks)
    n = S // 2
    logits_p, cache, clen = prefill(model, cfg, policy, toks[:, :n], max_len=S)
    assert clen == n
    torch.testing.assert_close(logits_p[:, -1], full_logits[:, n - 1], rtol=2e-4, atol=2e-4)
    logits_d, cache = decode_step(model, cfg, policy, cache, toks[:, n:n + 1], n)
    torch.testing.assert_close(logits_d[:, 0], full_logits[:, n], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
def test_ssm_decode_matches_forward(arch):
    """SSM/hybrid: token-by-token decode from scratch equals the parallel
    (chunked) forward: the recurrence and its dual agree."""
    cfg = smoke_variant(get_arch(arch))
    model = _model(cfg)
    toks = _batch(cfg)["tokens"][:, :8]
    full_logits, _, _ = forward(model, cfg, POLICY, toks)
    cache = init_cache(cfg, B, max_len=toks.shape[1], dtype=torch.float32, device="cpu")
    outs = []
    for t in range(toks.shape[1]):
        logits, cache = decode_step(model, cfg, POLICY, cache, toks[:, t:t + 1], t)
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), full_logits, rtol=5e-4, atol=5e-4)


def test_smoke_variant_preserves_family_features():
    for arch in ARCHS:
        full, sm = get_arch(arch), smoke_variant(get_arch(arch))
        assert sm.family == full.family
        assert (sm.moe is None) == (full.moe is None)
        assert (sm.mla is None) == (full.mla is None)
        assert (sm.ssm is None) == (full.ssm is None)
        assert sm.attn_type == full.attn_type
        assert (sm.num_patches > 0) == (full.num_patches > 0)
        assert sm.num_codebooks == full.num_codebooks


@pytest.mark.parametrize("arch", ["llama3.2-3b", "hymba-1.5b"])
def test_int8_kv_cache_decode_close_to_bf16(arch):
    """int8 KV cache: prefill + decode logits stay close to the float cache
    path (absmax/127 per (token, head))."""
    cfg = smoke_variant(get_arch(arch))
    pol8 = ShardingPolicy(attention_impl="chunked", attn_chunk=16, kv_cache_dtype="int8")
    model = _model(cfg)
    toks = _batch(cfg)["tokens"]
    n = S // 2
    lg_f, cache_f, _ = prefill(model, cfg, POLICY, toks[:, :n], max_len=S)
    lg_q, cache_q, _ = prefill(model, cfg, pol8, toks[:, :n], max_len=S)
    assert cache_q["k"].dtype == torch.int8
    torch.testing.assert_close(lg_q, lg_f, rtol=0.1, atol=0.1)
    d_f, _ = decode_step(model, cfg, POLICY, cache_f, toks[:, n:n + 1], n)
    d_q, _ = decode_step(model, cfg, pol8, cache_q, toks[:, n:n + 1], n)
    assert torch.equal(d_f[:, 0].argmax(-1), d_q[:, 0].argmax(-1))  # top-1 agreement
    assert (d_q - d_f).abs().max() < 0.2
