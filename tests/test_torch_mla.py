"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against the JAX package's (``repro.models.mla``) on the same weights and
inputs, and the port's deepseek-v2-lite-16b smoke variant decoding
autoregressively from its latent cache.

The reference's seeded float32 weights and inputs go through both packages
as NumPy.  Bars: the expanded prefill form, the absorbed decode form and
the latent cache to 1e-5 (float32, sums in another order); prefill then
decode against the full forward to the reference's own 2e-4
(``tests/test_arch_smoke.py``: the decode step's absorbed products take
another order than the expanded ones).
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as ref_get_arch
from repro.config import smoke_variant as ref_smoke_variant
from repro.models.layers import Initializer as RefInitializer
from repro.models.mla import init_mla as ref_init_mla
from repro.models.mla import init_mla_cache as ref_init_mla_cache
from repro.models.mla import mla_attention as ref_mla_attention
from repro.models.mla import mla_decode_step as ref_mla_decode_step
from repro_torch.config import ShardingPolicy, get_arch, smoke_variant
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
from repro_torch.models.mla import init_mla_cache, mla_attention, mla_decode_step

ARCH = "deepseek-v2-lite-16b"
B, S, SMAX = 2, 12, 16


def _setup(seed=0):
    ref_cfg = ref_smoke_variant(ref_get_arch(ARCH))
    cfg = smoke_variant(get_arch(ARCH))
    p = ref_init_mla(RefInitializer(seed, dtype=jnp.float32), ref_cfg)
    tp = SimpleNamespace(**{k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    x = np.random.default_rng(seed + 1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, p, tp, x


def _positions(n):
    return np.broadcast_to(np.arange(n)[None], (B, n))


def test_mla_attention_matches_reference():
    ref_cfg, cfg, p, tp, x = _setup()
    out_r, cache_r = ref_mla_attention(p, jnp.asarray(x), ref_cfg, jnp.asarray(_positions(S)))
    out, cache = mla_attention(tp, torch.from_numpy(x), cfg,
                               torch.from_numpy(_positions(S).copy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r), rtol=1e-5, atol=1e-5)
    assert set(cache) == set(cache_r) == {"c_kv", "k_pe"}
    for name in cache_r:
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(cache_r[name]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_init_mla_cache_matches_reference_shapes():
    ref_cfg, cfg, *_ = _setup()
    ref = ref_init_mla_cache(ref_cfg, B, SMAX, dtype=jnp.float32)
    port = init_mla_cache(cfg, 3, B, SMAX, torch.float32, "cpu")
    for name in ("c_kv", "k_pe"):
        assert tuple(port[name].shape) == (3, *ref[name].shape)
        assert port[name].dtype == torch.float32 and not port[name].any()


@pytest.mark.parametrize("cache_len", [0, 5, S, SMAX - 1])
def test_mla_decode_step_matches_reference(cache_len):
    """The absorbed form against a cache holding ``cache_len`` tokens (the
    rest of the cache random, so a wrong mask shows): its output, and the
    new token's latents written at slot ``cache_len``."""
    ref_cfg, cfg, p, tp, x = _setup()
    rng = np.random.default_rng(cache_len)
    m = cfg.mla
    cache_np = {"c_kv": rng.standard_normal((B, SMAX, m.kv_lora_rank)).astype(np.float32),
                "k_pe": rng.standard_normal((B, SMAX, m.qk_rope_head_dim)).astype(np.float32)}
    x1 = x[:, :1]
    out_r, cache_r = ref_mla_decode_step(p, jnp.asarray(x1), jax.tree.map(jnp.asarray, cache_np),
                                         jnp.int32(cache_len), ref_cfg)
    cache = {k: torch.from_numpy(v.copy()) for k, v in cache_np.items()}
    out = mla_decode_step(tp, torch.from_numpy(x1), cache,
                          torch.tensor([cache_len], dtype=torch.int32), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r), rtol=1e-5, atol=1e-5)
    for name in cache_np:
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(cache_r[name]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_smoke_prefill_then_decode_steps_match_forward():
    """deepseek-v2-lite-16b's smoke variant (dense experts: capacity dropping
    is orthogonal to the cache): prefill 8 tokens, decode the next 4 one at
    a time from the latent cache; each step's logits equal the full
    forward's at that position within the reference's 2e-4."""
    cfg = smoke_variant(get_arch(ARCH))
    policy = ShardingPolicy(attention_impl="chunked", attn_chunk=16, moe_impl="dense")
    model = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S),
                                                              dtype=np.int32))
    full, _, _ = forward(model, cfg, policy, toks)
    n = 8
    logits, cache, pos = prefill(model, cfg, policy, toks[:, :n], max_len=SMAX)
    assert pos == n and set(cache) == {"mla"}
    torch.testing.assert_close(logits[:, -1], full[:, n - 1], rtol=2e-4, atol=2e-4)
    for t in range(n, S):
        lg, cache = decode_step(model, cfg, policy, cache, toks[:, t:t + 1], t)
        torch.testing.assert_close(lg[:, 0], full[:, t], rtol=2e-4, atol=2e-4)
    empty = init_cache(cfg, B, SMAX, dtype=torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in empty["mla"].items()} == {
        k: tuple(v.shape) for k, v in cache["mla"].items()}
    assert not cache["mla"]["c_kv"][:, :, S:].any()  # nothing past the last token
