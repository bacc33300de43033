"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
(``repro.models.moe``) on the same weights and inputs, and the four
properties of ``tests/test_moe.py`` held by the port.

The reference's seeded float32 weights and input (deepseek-v2-lite-16b's
smoke variant: 4 experts, top-2, one shared expert) go through both
packages as NumPy.  Bars: outputs to 2e-5 and the aux loss to 1e-6
(float32, the same products with sums in another order); the routed
experts identical and the normalised gates to 1e-6.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as ref_get_arch
from repro.config import smoke_variant as ref_smoke_variant
from repro.models.layers import Initializer as RefInitializer
from repro.models.moe import _router as ref_router
from repro.models.moe import init_moe as ref_init_moe
from repro.models.moe import moe_ffn as ref_moe_ffn
from repro_torch.config import get_arch, smoke_variant
from repro_torch.models.moe import _router, capacity, moe_ffn

ARCH = "deepseek-v2-lite-16b"


def _namespace(tree):
    """A parameter dict as the attribute tree the port's functions read."""
    return SimpleNamespace(**{k: _namespace(v) if isinstance(v, dict) else
                              torch.from_numpy(np.array(v)) for k, v in tree.items()})


def _setup(cf=8.0, seed=0, shape=(2, 16)):
    """(reference cfg, port cfg, reference params, port params, x as jnp and torch)."""
    ref_cfg = ref_smoke_variant(ref_get_arch(ARCH))
    ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(ref_cfg.moe,
                                                                   capacity_factor=cf))
    cfg = smoke_variant(get_arch(ARCH))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    p = ref_init_moe(RefInitializer(seed, dtype=jnp.float32), ref_cfg)
    x = jax.random.normal(jax.random.PRNGKey(seed + 1), (*shape, cfg.d_model), jnp.float32)
    return ref_cfg, cfg, p, _namespace(jax.tree.map(np.asarray, p)), x, torch.from_numpy(
        np.array(x))


@pytest.mark.parametrize("cf", [8.0, 0.01])
@pytest.mark.parametrize("impl", ["gshard", "dense"])
def test_moe_ffn_matches_reference(impl, cf):
    ref_cfg, cfg, p, tp, x, tx = _setup(cf=cf)
    y_ref, aux_ref = ref_moe_ffn(p, x, ref_cfg, impl=impl)
    y, aux = moe_ffn(tp, tx, cfg, impl=impl)
    assert y.dtype == torch.float32 and tuple(y.shape) == tuple(x.shape)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-6)


@pytest.mark.parametrize("shape", [(2, 16), (4, 1)])
def test_router_picks_the_reference_experts(shape):
    """The same top-k experts and normalised gates at a prefill and at a
    decode step's four tokens."""
    ref_cfg, cfg, p, tp, x, tx = _setup(shape=shape)
    x2d = x.reshape(-1, cfg.d_model)
    gates_r, experts_r, aux_r = ref_router(p, x2d, ref_cfg.moe)
    gates, experts, aux = _router(tp, tx.reshape(-1, cfg.d_model), cfg.moe)
    np.testing.assert_array_equal(experts.numpy(), np.asarray(experts_r))
    np.testing.assert_allclose(gates.numpy(), np.asarray(gates_r), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=1e-6)


@pytest.mark.parametrize("n,cf,want", [(32, 1.25, 20), (2, 1.25, 1), (4, 1.25, 2),
                                       (12, 1.25, 8), (4, 0.01, 1), (32, 8.0, 128)])
def test_capacity_is_the_references(n, cf, want):
    """C = max(1, round(cf N k / E)) with Python's round (halves to even:
    2.5 -> 2, 7.5 -> 8), at 4 experts top-2."""
    cfg = smoke_variant(get_arch(ARCH))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    assert capacity(cfg, n) == want == max(1, int(round(cf * n * 2 / 4)))


def test_gshard_equals_dense_with_ample_capacity():
    _, cfg, _, tp, _, tx = _setup(cf=8.0)
    y_g, aux_g = moe_ffn(tp, tx, cfg, impl="gshard")
    y_d, aux_d = moe_ffn(tp, tx, cfg, impl="dense")
    np.testing.assert_allclose(y_g.numpy(), y_d.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(aux_g), float(aux_d), rtol=1e-6)


def test_gshard_tight_capacity_bounded_deviation():
    """With C = 1 the dropped slots lose their routed contribution but keep
    the shared-expert term: outputs stay finite and within the dense envelope."""
    _, cfg, _, tp, _, tx = _setup(cf=0.01)
    y_g, _ = moe_ffn(tp, tx, cfg, impl="gshard")
    assert torch.isfinite(y_g).all()
    y_d, _ = moe_ffn(tp, tx, cfg, impl="dense")
    assert y_g.abs().max() <= y_d.abs().max() * 3 + 1.0


def test_router_normalizes_topk_gates():
    _, cfg, _, tp, _, tx = _setup()
    gates, experts, aux = _router(tp, tx.reshape(-1, cfg.d_model), cfg.moe)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert int(experts.max()) < cfg.moe.num_experts
    assert float(aux) > 0.0


def test_aux_loss_uniform_routing_lower_than_collapsed():
    """The load-balance loss penalises collapsed routing."""
    _, cfg, _, tp, _, tx = _setup()
    collapsed = SimpleNamespace(**vars(tp))
    collapsed.router = torch.zeros_like(tp.router)
    collapsed.router[:, 0] = 10.0
    x2d = tx.reshape(-1, cfg.d_model)
    assert float(_router(collapsed, x2d, cfg.moe)[2]) > float(_router(tp, x2d, cfg.moe)[2])


def test_decode_step_drops_colliding_tokens_as_the_reference():
    """A decode step of 2 tokens at cf 1.25 gives C = 1 here (4 tokens do
    at deepseek-v2-lite-16b's 64 experts, top-6): a second slot routed to
    an expert already holding a token is dropped, in both packages alike
    (ROADMAP C)."""
    ref_cfg, cfg, p, tp, x, tx = _setup(cf=1.25, shape=(2, 1))
    assert capacity(cfg, 2) == 1
    _, experts, _ = _router(tp, tx.reshape(-1, cfg.d_model), cfg.moe)
    assert len(set(experts.reshape(-1).tolist())) < experts.numel()  # some slot is dropped
    y_ref, _ = ref_moe_ffn(p, x, ref_cfg, impl="gshard")
    y, _ = moe_ffn(tp, tx, cfg, impl="gshard")
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=2e-5, atol=2e-5)
    y_dense, _ = moe_ffn(tp, tx, cfg, impl="dense")
    assert (y - y_dense).abs().max() > 1e-3
