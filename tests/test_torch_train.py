"""The port's training loss and its gradients against the reference's, for
one smoke architecture of each family, and the training path's refusal of
the CUDA kernels.

Each case draws the reference's parameters (``repro.models.init_params``,
seed 0, float32), carries them across with ``params_from_reference``, and
takes ``loss_fn`` of the same ``make_batch`` through both packages:
``jax.value_and_grad`` of the reference's against the port's autograd.
Tolerances: the total loss and the aux loss within 1e-5 relative; every
gradient leaf within 1e-4 of its own max |g| (measured worst on the CPU:
5.4e-6, hymba; the two differ only in float32 summation order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ShardingPolicy as RefPolicy
from repro.config import get_arch as ref_get_arch
from repro.config import smoke_variant as ref_smoke_variant
from repro.data import make_batch
from repro.models import init_params as ref_init_params
from repro.models import loss_fn as ref_loss_fn
from repro_torch.config import ShardingPolicy, TrainConfig, get_arch, smoke_variant
from repro_torch.convert import leaves_to_reference, params_from_reference, policy_from_reference
from repro_torch.models import loss_fn
from repro_torch.runtime import make_train_step

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of the leaf's max |g|
FAMILIES = {"dense": "llama3.2-3b", "moe": "deepseek-v2-lite-16b", "ssm": "mamba2-2.7b",
            "hybrid": "hymba-1.5b", "vlm": "paligemma-3b", "audio": "musicgen-medium"}
REF_POLICY = RefPolicy(attention_impl="chunked", attn_chunk=16)


def _ref_leaves(tree) -> dict:
    """A reference tree's leaves as NumPy by '/'-joined path."""
    def name(k):
        return str(getattr(k, "key", getattr(k, "name", k)))

    return {"/".join(name(k) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_every_gradient_leaf_match_the_reference(family):
    arch = FAMILIES[family]
    ref_cfg, cfg = ref_smoke_variant(ref_get_arch(arch)), smoke_variant(get_arch(arch))
    policy = policy_from_reference(REF_POLICY)
    assert policy.remat == "block" and policy.attention_impl == "chunked"
    params = ref_init_params(ref_cfg, REF_POLICY, seed=0, dtype=jnp.float32)
    batch = make_batch(ref_cfg, 2, 32, step=0)
    (ref_total, ref_parts), ref_grads = jax.value_and_grad(
        lambda p: ref_loss_fn(p, ref_cfg, REF_POLICY,
                              {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(params)

    model = params_from_reference(jax.tree.map(np.asarray, params), cfg, "cpu")
    model.requires_grad_(True)
    total, parts = loss_fn(model, cfg, policy, {k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()

    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=LOSS_RTOL)
    for k in ("loss", "aux"):
        np.testing.assert_allclose(float(parts[k].detach()), float(ref_parts[k]), rtol=LOSS_RTOL,
                                   atol=1e-7)
    assert (float(parts["aux"]) > 0) == (cfg.moe is not None)
    got = leaves_to_reference({n: p.grad for n, p in model.named_parameters()})
    want = _ref_leaves(ref_grads)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k] - w).max())
        assert err <= GRAD_TOL * scale, (family, k, err, scale)


def test_vlm_loss_needs_patches():
    cfg = smoke_variant(get_arch("paligemma-3b"))
    from repro_torch.models import init_params

    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, 2, 16, step=0).items()
             if k != "patches"}
    with pytest.raises(ValueError, match="patch"):
        loss_fn(init_params(cfg, seed=0, dtype=torch.float32, device="cpu"), cfg,
                ShardingPolicy(attn_chunk=8), batch)


def test_train_step_refuses_the_cuda_kernels():
    """No fall back to the plain path: building the step raises, naming the
    missing backward kernels and the reference's own limit."""
    cfg = smoke_variant(get_arch("llama3.2-3b"))
    with pytest.raises(ValueError, match="backward kernels.*reference cannot differentiate"):
        make_train_step(cfg, ShardingPolicy(attention_impl="cuda"), TrainConfig())
    make_train_step(cfg, ShardingPolicy(attention_impl="chunked"), TrainConfig())
    make_train_step(cfg, ShardingPolicy(attention_impl="naive"), TrainConfig())


def test_reference_cannot_differentiate_its_pallas_attention():
    """The fact behind that refusal: the reference's Pallas flash attention
    runs forward (interpret mode on the CPU), but ``jax.grad`` through it
    fails in the ``pallas_call`` JVP rule, so the reference trains through
    plain JAX (its driver fixes ``attention_impl="chunked"``)."""
    from repro.kernels import ops

    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.normal(size=(1, 16, 2, 16)), jnp.float32)
    k = jnp.asarray(rng.normal(size=(1, 16, 1, 16)), jnp.float32)
    out = ops.flash_attention(q, k, k)
    assert out.shape == q.shape and np.isfinite(np.asarray(out)).all()
    with pytest.raises(AssertionError):
        jax.grad(lambda q: ops.flash_attention(q, k, k).sum())(q)
