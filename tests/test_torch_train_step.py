"""The port's train step (``repro_torch.runtime.make_train_step``) against
the reference's jitted one, and the reference's trainer invariants
(``tests/test_train_step.py``) on the port: microbatch accumulation equals
the full batch, masked tokens do not contribute, training is
deterministic, and block rematerialization changes no value.

Tolerances.  Against the reference (llama3.2-3b smoke, batch 8 x 32, lr
1e-2, three steps, the reference's parameters carried across): the loss,
lr and grad norm of every step within 1e-5 relative; the parameters within
the reference's own bar for microbatching (rtol 2e-3, atol 2e-4) except at
most one element in 10^4, and every element within 2 lr.  An element
whose gradient sits below float32 rounding gets Adam's normalised step in
whichever direction its rounding points, so the two packages may move it
apart by up to 2 lr a step; on the CPU one element of 120,000 (in
``w_o``) does, by 6.6e-4.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ShardingPolicy as RefPolicy
from repro.config import TrainConfig as RefTrainConfig
from repro.config import get_arch as ref_get_arch
from repro.config import smoke_variant as ref_smoke_variant
from repro.data import make_batch
from repro.models import init_params as ref_init_params
from repro.runtime import make_train_state as ref_make_train_state
from repro.runtime import make_train_step as ref_make_train_step
from repro_torch.config import ShardingPolicy, TrainConfig, get_arch, smoke_variant
from repro_torch.convert import leaves_to_reference, params_from_reference, policy_from_reference
from repro_torch.models import init_params, loss_fn
from repro_torch.runtime import make_train_state, make_train_step

CFG = smoke_variant(get_arch("llama3.2-3b"))
POLICY = ShardingPolicy(attn_chunk=16)
LR = 1e-2


def _batch(step: int, b: int = 8, s: int = 32) -> dict:
    return {k: torch.from_numpy(v) for k, v in make_batch(CFG, b, s, step=step).items()}


def _run(microbatches: int, steps: int = 2, policy=POLICY):
    tcfg = TrainConfig(lr=LR, warmup_steps=0, total_steps=10, microbatches=microbatches)
    state = make_train_state(init_params(CFG, seed=0, dtype=torch.float32, device="cpu"), tcfg)
    step = make_train_step(CFG, policy, tcfg)
    for s in range(steps):
        state, m = step(state, _batch(s))
    return state, float(m["loss"])


def _params(state) -> dict:
    return {n: p.detach() for n, p in state.params.named_parameters()}


@pytest.mark.parametrize("microbatches", [1, 4])
def test_three_steps_match_the_reference_train_step(microbatches):
    ref_cfg = ref_smoke_variant(ref_get_arch("llama3.2-3b"))
    ref_policy = RefPolicy(attn_chunk=16)
    ref_tcfg = RefTrainConfig(lr=LR, warmup_steps=0, total_steps=10, microbatches=microbatches)
    tcfg = TrainConfig(lr=LR, warmup_steps=0, total_steps=10, microbatches=microbatches)
    params = ref_init_params(ref_cfg, ref_policy, seed=0, dtype=jnp.float32)
    model = params_from_reference(jax.tree.map(np.asarray, params), CFG, "cpu")
    ref_state = ref_make_train_state(params, ref_tcfg)
    ref_step = jax.jit(ref_make_train_step(ref_cfg, ref_policy, ref_tcfg))
    state = make_train_state(model, tcfg)
    step = make_train_step(CFG, policy_from_reference(ref_policy), tcfg)
    for s in range(3):
        batch = make_batch(ref_cfg, 8, 32, step=s)
        ref_state, ref_m = ref_step(ref_state, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]), rtol=1e-5, err_msg=k)
    assert int(state.opt.step) == int(ref_state.opt.step) == 3
    got = leaves_to_reference(_params(state))
    want = jax.tree_util.tree_flatten_with_path(ref_state.params)[0]
    want = {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): np.asarray(v)
            for path, v in want}
    assert set(got) == set(want)
    outside = total = 0
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        assert diff.max() <= 2 * LR, (k, diff.max())
        outside += int((diff > 2e-4 + 2e-3 * np.abs(w)).sum())
        total += w.size
    assert outside <= total // 10_000, (outside, total)


def test_microbatch_accumulation_matches_full_batch():
    s1, l1 = _run(1)
    s4, l4 = _run(4)
    assert abs(l1 - l4) < 5e-4, (l1, l4)
    p1, p4 = _params(s1), _params(s4)
    for n in p1:
        np.testing.assert_allclose(p1[n].numpy(), p4[n].numpy(), rtol=2e-3, atol=2e-4,
                                   err_msg=n)


def test_microbatches_must_divide_the_batch():
    tcfg = TrainConfig(microbatches=3)
    state = make_train_state(init_params(CFG, seed=0, dtype=torch.float32, device="cpu"), tcfg)
    with pytest.raises(ValueError, match="not divisible by microbatches 3"):
        make_train_step(CFG, POLICY, tcfg)(state, _batch(0))


def test_mask_zeroes_do_not_contribute():
    model = init_params(CFG, seed=0, dtype=torch.float32, device="cpu")
    batch = _batch(0, 4, 16)
    policy = ShardingPolicy(attn_chunk=16)
    full, _ = loss_fn(model, CFG, policy, batch)
    # mask out half the batch; loss must equal the loss on that half alone
    mask = torch.ones(4, 16)
    mask[2:] = 0.0
    masked, _ = loss_fn(model, CFG, policy, {**batch, "mask": mask})
    half_loss, _ = loss_fn(model, CFG, policy, {k: v[:2] for k, v in batch.items()})
    np.testing.assert_allclose(float(masked), float(half_loss), rtol=1e-5)
    assert float(full) != float(masked)


def test_training_is_deterministic():
    _, a = _run(1, steps=3)
    _, b = _run(1, steps=3)
    assert a == b


def test_remat_block_and_none_give_identical_steps():
    """Recomputing each block in the backward pass changes memory, not a
    value: two steps with ``remat="block"`` and ``"none"`` are bitwise
    equal (loss and every parameter)."""
    sb, lb = _run(1, policy=POLICY)
    sn, ln = _run(1, policy=dataclasses.replace(POLICY, remat="none"))
    assert lb == ln
    pb, pn = _params(sb), _params(sn)
    assert all(torch.equal(pb[n], pn[n]) for n in pb)


def test_state_dtype_bfloat16_trains():
    """``optimizer_state_dtype="bfloat16"`` keeps both moments in bfloat16,
    as the reference allows, and the loss still falls on a repeated batch."""
    tcfg = TrainConfig(lr=LR, warmup_steps=0, total_steps=10, optimizer_state_dtype="bfloat16")
    state = make_train_state(init_params(CFG, seed=0, dtype=torch.float32, device="cpu"), tcfg)
    step = make_train_step(CFG, POLICY, tcfg)
    state, m0 = step(state, _batch(0))
    state, m1 = step(state, _batch(0))
    assert all(t.dtype == torch.bfloat16 for t in [*state.opt.m.values(), *state.opt.v.values()])
    assert float(m1["loss"]) < float(m0["loss"])


def test_serving_models_keep_their_parameters_frozen():
    """Only make_train_state switches a model's parameters to requires_grad;
    a model as drawn (the serving path's) builds no graph in forward."""
    from repro_torch.models import forward

    model = init_params(CFG, seed=0, dtype=torch.float32, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    logits, _, _ = forward(model, CFG, POLICY, _batch(0, 2, 16)["tokens"])
    assert logits.grad_fn is None
    make_train_state(model, TrainConfig())
    assert all(p.requires_grad for p in model.parameters())


def test_bfloat16_parameters_accumulate_in_float32_as_the_reference():
    """bfloat16 parameters: each microbatch's gradient is summed in float32
    (outside ``.grad``, which is bfloat16), as the reference's float32
    accumulator sums it.  Two steps with 2 microbatches against the
    reference's jitted step: the loss within 2e-3 and the grad norm within
    2e-2 relative (bfloat16 products, rounded in other orders)."""
    ref_cfg = ref_smoke_variant(ref_get_arch("llama3.2-3b"))
    ref_policy = RefPolicy(attn_chunk=16)
    ref_tcfg = RefTrainConfig(lr=LR, warmup_steps=0, total_steps=10, microbatches=2)
    tcfg = TrainConfig(lr=LR, warmup_steps=0, total_steps=10, microbatches=2)
    params = ref_init_params(ref_cfg, ref_policy, seed=0, dtype=jnp.bfloat16)
    ref_state = ref_make_train_state(params, ref_tcfg)
    ref_step = jax.jit(ref_make_train_step(ref_cfg, ref_policy, ref_tcfg))
    state = make_train_state(params_from_reference(jax.tree.map(np.asarray, params), CFG, "cpu"),
                             tcfg)
    step = make_train_step(CFG, policy_from_reference(ref_policy), tcfg)
    for s in range(2):
        batch = make_batch(ref_cfg, 8, 32, step=s)
        ref_state, ref_m = ref_step(ref_state, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), rtol=2e-3)
        np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]), rtol=2e-2)
    assert all(p.dtype == torch.bfloat16 and p.grad is None
               for p in state.params.parameters() if p.dtype != torch.float32)
