"""The port's optimizer substrate (``repro_torch.optim``) against the
reference's ``repro.optim``: the six cases of ``tests/test_optim.py`` and the
int8 round trip of ``tests/test_optim_properties.py`` on the port, then
``adamw_update``, ``cosine_lr``, ``global_norm``, the int8 codec and top-k
compression on the same NumPy inputs through both packages.

Tolerances: both packages compute in float32 with the same arithmetic in
the same order, so AdamW over three steps agrees to 1e-6 relative (XLA and
PyTorch may round ``beta ** t`` and ``cos`` an ulp apart); the codec and the
top-k selection are exact (ties included).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import cosine_lr as ref_cosine_lr
from repro.optim import global_norm as ref_global_norm
from repro.optim.compress import int8_compress as ref_int8_compress
from repro.optim.compress import int8_decompress as ref_int8_decompress
from repro.optim.compress import topk_compress_init as ref_topk_init
from repro.optim.compress import topk_compress_update as ref_topk_update
from repro_torch.optim import (adamw_init, adamw_update, cosine_lr, global_norm, int8_compress,
                               int8_decompress, topk_compress_init, topk_compress_update)

RTOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


# ---------------------------------------------------------------- tests/test_optim.py


def test_adamw_matches_reference_impl():
    """One AdamW step vs a hand-rolled numpy reference."""
    rng = np.random.default_rng(0)
    p = {"w": _t(rng.normal(size=(4, 3)))}
    g = {"w": _t(rng.normal(size=(4, 3)))}
    p0 = p["w"].clone().numpy()
    st_ = adamw_init(p)
    lr, b1, b2, eps, wd = 1e-2, 0.9, 0.95, 1e-8, 0.1
    adamw_update(g, st_, p, lr=lr, beta1=b1, beta2=b2, eps=eps, weight_decay=wd, grad_clip=0.0)
    m = (1 - b1) * g["w"].numpy()
    v = (1 - b2) * g["w"].numpy() ** 2
    mh = m / (1 - b1)
    vh = v / (1 - b2)
    want = p0 - lr * (mh / (np.sqrt(vh) + eps) + wd * p0)
    np.testing.assert_allclose(p["w"].numpy(), want, rtol=1e-5, atol=1e-6)
    assert int(st_.step) == 1


def test_grad_clip_bounds_global_norm():
    g = {"a": torch.full((10,), 100.0), "b": torch.full((5,), -100.0)}
    p = {k: torch.zeros_like(v) for k, v in g.items()}
    st_ = adamw_init(p)
    _, _, metrics = adamw_update(g, st_, p, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                                 weight_decay=0.0, grad_clip=1.0)
    assert float(metrics["grad_norm"]) > 1.0  # pre-clip norm reported


def test_cosine_lr_profile():
    step = lambda s: torch.tensor(s, dtype=torch.int32)
    assert float(cosine_lr(step(0), 1.0, warmup=10, total=100)) == 0.0
    assert abs(float(cosine_lr(step(10), 1.0, warmup=10, total=100)) - 1.0) < 1e-6
    end = float(cosine_lr(step(100), 1.0, warmup=10, total=100))
    assert end <= 0.11  # decays to min_frac
    mid = float(cosine_lr(step(55), 1.0, warmup=10, total=100))
    assert end < mid < 1.0


def test_topk_error_feedback_conserves_mass():
    """sent_t + residual_t == residual_{t-1} + grad_t (nothing lost)."""
    rng = np.random.default_rng(1)
    g = {"w": _t(rng.normal(size=(64,)))}
    state = topk_compress_init(g)
    total_sent = np.zeros(64, np.float32)
    total_grad = np.zeros(64, np.float32)
    for _ in range(5):
        g = {"w": _t(rng.normal(size=(64,)))}
        sent, state = topk_compress_update(g, state, k_frac=0.1)
        total_sent += sent["w"].numpy()
        total_grad += g["w"].numpy()
        np.testing.assert_allclose(total_sent + state.residual["w"].numpy(), total_grad,
                                   rtol=1e-5, atol=1e-5)


def test_topk_sparsity():
    g = {"w": _t(np.random.default_rng(2).normal(size=(100,)))}
    sent, _ = topk_compress_update(g, topk_compress_init(g), k_frac=0.05)
    assert int((sent["w"] != 0).sum()) <= 7  # ~5 of 100 (ties can add a few)


def test_global_norm():
    t = {"a": torch.ones(3), "b": torch.full((4,), 2.0)}
    np.testing.assert_allclose(float(global_norm(t)), np.sqrt(3 + 16), rtol=1e-6)


# ---------------------------------------------------------------- tests/test_optim_properties.py


def _int8_roundtrip_error_bound(xs):
    x = torch.from_numpy(np.array(xs, np.float32))
    q, scale = int8_compress(x)
    back = int8_decompress(q, scale)
    # linear quantization error <= scale/2 per element
    assert float((back - x).abs().max()) <= float(scale) / 2 + 1e-6
    assert q.dtype == torch.int8


def test_int8_roundtrip_error_bound_hypothesis():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=25, deadline=None)
    @hypothesis.given(st.lists(st.floats(-1e4, 1e4, allow_nan=False), min_size=1, max_size=64))
    def prop(xs):
        _int8_roundtrip_error_bound(xs)

    prop()


@pytest.mark.parametrize("seed", range(4))
def test_int8_roundtrip_error_bound_seeded(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 65))
    _int8_roundtrip_error_bound(rng.uniform(-1e4, 1e4, size=n) * rng.choice([1e-4, 1, 1], n))


# ---------------------------------------------------------------- against the reference


def _tree(seed, shapes=(("a", (5, 7)), ("b", (16,)), ("c", (3, 4, 2)))):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes}


@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference_over_three_steps(state_dtype, clip):
    """Parameters, both moments and the step after three updates on a seeded
    tree (gradients of norm ~7, so clip 1.0 rescales), lr from the schedule
    as the train step reads it."""
    p_np = _tree(0)
    ref_p = {k: jnp.asarray(v) for k, v in p_np.items()}
    ref_st = ref_adamw_init(ref_p, state_dtype=jnp.dtype(state_dtype))
    p = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    st = adamw_init(p, state_dtype=getattr(torch, state_dtype))
    kw = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=clip)
    for s in range(3):
        g_np = _tree(10 + s)
        ref_lr = ref_cosine_lr(ref_st.step, 1e-2, 1, 10)
        lr = cosine_lr(st.step, 1e-2, 1, 10)
        np.testing.assert_allclose(float(lr), float(ref_lr), rtol=RTOL)
        ref_p, ref_st, ref_m = ref_adamw_update({k: jnp.asarray(v) for k, v in g_np.items()},
                                                ref_st, ref_p, lr=ref_lr, **kw)
        _, _, m = adamw_update({k: torch.from_numpy(v) for k, v in g_np.items()}, st, p, lr=lr,
                               **kw)
        np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]), rtol=RTOL)
    assert int(st.step) == int(ref_st.step) == 3
    for k in p_np:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(ref_p[k]), rtol=RTOL, atol=1e-7)
        for got, want in ((st.m[k], ref_st.m[k]), (st.v[k], ref_st.v[k])):
            assert got.dtype == getattr(torch, state_dtype)
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want.astype(jnp.float32)),
                                       rtol=RTOL if state_dtype == "float32" else 1e-2,
                                       atol=1e-9)


@pytest.mark.parametrize("total", [50, 100])
@pytest.mark.parametrize("warmup", [0, 1, 10])
def test_cosine_lr_matches_the_reference(warmup, total):
    for s in (0, 1, 5, 9, 10, 11, 37, 55, 99, 100, 150):
        want = float(ref_cosine_lr(jnp.int32(s), 3e-4, warmup, total))
        got = float(cosine_lr(torch.tensor(s, dtype=torch.int32), 3e-4, warmup, total))
        np.testing.assert_allclose(got, want, rtol=RTOL)


def test_global_norm_matches_the_reference():
    t = _tree(3)
    want = float(ref_global_norm({k: jnp.asarray(v) for k, v in t.items()}))
    got = float(global_norm({k: torch.from_numpy(v) for k, v in t.items()}))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("seed", range(3))
def test_int8_codec_matches_the_reference(seed):
    x = np.random.default_rng(seed).normal(size=(33, 7)).astype(np.float32) * 10 ** seed
    x[0, :3] = [0.0, -x.max(), x.max()]
    ref_q, ref_scale = ref_int8_compress(jnp.asarray(x))
    q, scale = int8_compress(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    assert float(scale) == float(ref_scale)
    np.testing.assert_array_equal(int8_decompress(q, scale).numpy(),
                                  np.asarray(ref_int8_decompress(ref_q, ref_scale)))


@pytest.mark.parametrize("k_frac", [0.05, 0.1, 0.5])
def test_topk_compress_matches_the_reference_ties_included(k_frac):
    """Five rounds of error feedback; the gradients are rounded to a coarse
    grid so that many |acc| entries tie at the threshold, all of which are
    sent in both packages."""
    rng = np.random.default_rng(5)
    shapes = (("w", (10, 10)), ("b", (37,)))
    g0 = {k: np.round(rng.normal(size=s) * 2).astype(np.float32) / 2 for k, s in shapes}
    ref_st = ref_topk_init({k: jnp.asarray(v) for k, v in g0.items()})
    st = topk_compress_init({k: torch.from_numpy(v) for k, v in g0.items()})
    ties = 0
    for _ in range(5):
        g = {k: np.round(rng.normal(size=s) * 2).astype(np.float32) / 2 for k, s in shapes}
        ref_sent, ref_st = ref_topk_update({k: jnp.asarray(v) for k, v in g.items()}, ref_st,
                                           k_frac=k_frac)
        sent, st = topk_compress_update({k: torch.from_numpy(v) for k, v in g.items()}, st,
                                        k_frac=k_frac)
        for k, v in g.items():
            np.testing.assert_array_equal(sent[k].numpy(), np.asarray(ref_sent[k]))
            np.testing.assert_array_equal(st.residual[k].numpy(), np.asarray(ref_st.residual[k]))
            ties += int((sent[k] != 0).sum()) - max(1, int(v.size * k_frac))
    assert ties > 0  # the grid made ties at the threshold, and both kept them
