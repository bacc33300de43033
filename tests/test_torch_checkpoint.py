"""The port's checkpoint store (``repro_torch.checkpoint``): the five cases
of ``tests/test_checkpoint.py`` on the port, and checkpoints crossing
between the two packages both ways (the same on-disk format: keys and
shapes of the reference's flatten of its ``TrainState``).

Tolerances: a round trip is exact; a step resumed from a crossed
checkpoint matches the other package's own resumed step within 1e-5
relative (loss, lr, grad norm) and its parameters within 1e-5 + 1e-5 |p|
(one step at lr 1e-3; the packages differ in float32 summation order only).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as ref_restore_checkpoint
from repro.checkpoint import save_checkpoint as ref_save_checkpoint
from repro.config import ShardingPolicy as RefPolicy
from repro.config import TrainConfig as RefTrainConfig
from repro.config import get_arch as ref_get_arch
from repro.config import smoke_variant as ref_smoke_variant
from repro.data import make_batch
from repro.models import init_params as ref_init_params
from repro.runtime import make_train_state as ref_make_train_state
from repro.runtime import make_train_step as ref_make_train_step
from repro_torch.checkpoint import (CheckpointManager, latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.config import ShardingPolicy, TrainConfig, get_arch, smoke_variant
from repro_torch.convert import (flatten_tree, leaves_to_reference, train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.models import init_params
from repro_torch.runtime import make_train_state, make_train_step

CFG = smoke_variant(get_arch("llama3.2-3b"))


@pytest.fixture
def tmpdir_(tmp_path):
    return str(tmp_path / "ckpt")


def _state(seed=0, cfg=CFG, dtype=torch.float32, tcfg=TrainConfig()):
    return make_train_state(init_params(cfg, seed=seed, dtype=dtype, device="cpu"), tcfg)


def _leaves(state) -> dict:
    return flatten_tree(train_state_to_reference(state))


def test_round_trip(tmpdir_):
    state = _state()
    state.opt.step += 3
    state.opt.m = {n: torch.randn_like(t) for n, t in state.opt.m.items()}
    save_checkpoint(tmpdir_, 7, state, metadata={"note": "x"})
    assert latest_step(tmpdir_) == 7
    target = _state(seed=1)
    restored, meta = restore_checkpoint(tmpdir_, 7, target, device="cpu")
    assert meta == {"note": "x"}
    assert restored is target
    want, got = _leaves(state), _leaves(restored)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_no_torn_checkpoint_on_partial_write(tmpdir_):
    state = _state()
    save_checkpoint(tmpdir_, 1, state)
    # a crashed writer: a stale .tmp dir must be invisible to latest_step
    os.makedirs(os.path.join(tmpdir_, "step_00000002.tmp"))
    assert latest_step(tmpdir_) == 1


def test_manager_async_and_gc(tmpdir_):
    state = _state()
    mgr = CheckpointManager(tmpdir_, keep=2)
    for s in range(5):
        mgr.save_async(s, state)
        mgr.wait()
    assert sorted(os.listdir(tmpdir_)) == ["step_00000003", "step_00000004"]


def test_manager_snapshots_before_the_next_step(tmpdir_):
    """save_async copies the state to the host before it returns: an update
    in place right after does not reach the checkpoint."""
    state = _state()
    mgr = CheckpointManager(tmpdir_)
    before = state.params.embed.detach().clone()
    mgr.save_async(0, state)
    with torch.no_grad():
        state.params.embed.add_(1.0)
    mgr.wait()
    restored, _ = restore_checkpoint(tmpdir_, 0, _state(seed=1), device="cpu")
    assert torch.equal(restored.params.embed, before)


def test_shape_mismatch_raises(tmpdir_):
    save_checkpoint(tmpdir_, 0, _state())
    import dataclasses

    bad = _state(cfg=dataclasses.replace(CFG, d_ff=CFG.d_ff + 1))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(tmpdir_, 0, bad, device="cpu")


def test_restore_is_dtype_preserving(tmpdir_):
    save_checkpoint(tmpdir_, 0, _state())
    target = _state(dtype=torch.bfloat16, tcfg=TrainConfig(optimizer_state_dtype="bfloat16"))
    dtypes = {n: p.dtype for n, p in target.params.named_parameters()}
    restored, _ = restore_checkpoint(tmpdir_, 0, target, device="cpu")
    assert {n: p.dtype for n, p in restored.params.named_parameters()} == dtypes
    assert all(t.dtype == torch.bfloat16 for t in restored.opt.m.values())
    assert restored.opt.step.dtype == torch.int32


def test_bfloat16_state_round_trips_in_the_reference_bytes(tmpdir_):
    """A bfloat16 moment is written as the reference writes one (its 16-bit
    patterns, ``|V2`` in the npz, ``"bfloat16"`` in the manifest) and
    restores exactly in the port (the reference's own restore cannot cast
    ``|V2`` back: ROADMAP C.17)."""
    import json

    state = _state(tcfg=TrainConfig(optimizer_state_dtype="bfloat16"))
    state.opt.v = {n: torch.randn_like(t) for n, t in state.opt.v.items()}
    save_checkpoint(tmpdir_, 0, state)
    path = os.path.join(tmpdir_, "step_00000000")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        assert data["opt/v/embed"].dtype == np.dtype("V2")
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["dtypes"]["opt/v/embed"] == "bfloat16"
    restored, _ = restore_checkpoint(tmpdir_, 0, _state(seed=1, tcfg=TrainConfig(
        optimizer_state_dtype="bfloat16")), device="cpu")
    assert all(torch.equal(restored.opt.v[n], state.opt.v[n]) for n in state.opt.v)


# ---------------------------------------------------------------- across the packages

REF_CFG = ref_smoke_variant(ref_get_arch("llama3.2-3b"))
REF_POLICY = RefPolicy(attn_chunk=16)
LR = 1e-3


def _ref_tcfg():
    return RefTrainConfig(lr=LR, warmup_steps=0, total_steps=10)


def _tcfg():
    return TrainConfig(lr=LR, warmup_steps=0, total_steps=10)


def _ref_batch(step):
    return {k: jnp.asarray(v) for k, v in make_batch(REF_CFG, 4, 32, step=step).items()}


def _batch(step):
    return {k: torch.from_numpy(v) for k, v in make_batch(CFG, 4, 32, step=step).items()}


def _ref_trained(steps):
    state = ref_make_train_state(ref_init_params(REF_CFG, REF_POLICY, seed=0, dtype=jnp.float32),
                                 _ref_tcfg())
    step = jax.jit(ref_make_train_step(REF_CFG, REF_POLICY, _ref_tcfg()))
    for s in range(steps):
        state, _ = step(state, _ref_batch(s))
    return state, step


def _ref_flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_metrics(m, ref_m):
    for k in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(ref_m[k]), rtol=1e-5, err_msg=k)


def test_reference_checkpoint_resumes_in_the_port(tmpdir_):
    """The reference trains 2 steps and saves; the port restores that
    checkpoint into a state of other weights and takes step 2 as the
    reference does from the same checkpoint."""
    ref_state, ref_step = _ref_trained(2)
    ref_save_checkpoint(tmpdir_, 1, ref_state)
    state, _ = restore_checkpoint(tmpdir_, 1, _state(seed=5, tcfg=_tcfg()), device="cpu")
    assert int(state.opt.step) == 2
    ref_back, _ = ref_restore_checkpoint(tmpdir_, 1, ref_state)
    ref_back, ref_m = ref_step(ref_back, _ref_batch(2))
    state, m = make_train_step(CFG, ShardingPolicy(attn_chunk=16), _tcfg())(state, _batch(2))
    _close_metrics(m, ref_m)
    got = leaves_to_reference({n: p.detach() for n, p in state.params.named_parameters()})
    for k, w in _ref_flat(ref_back.params).items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5, err_msg=k)


def test_port_checkpoint_restores_in_the_reference(tmpdir_):
    """The port's state (the reference's weights carried across, 2 steps
    trained in the port) saved by the port restores through the
    reference's ``restore_checkpoint`` leaf for leaf, and the reference's
    next step from it matches the port's."""
    ref_state, ref_step = _ref_trained(0)
    state = train_state_from_reference(jax.tree.map(np.asarray, ref_state), CFG, device="cpu")
    step = make_train_step(CFG, ShardingPolicy(attn_chunk=16), _tcfg())
    for s in range(2):
        state, _ = step(state, _batch(s))
    save_checkpoint(tmpdir_, 1, state)
    ref_back, _ = ref_restore_checkpoint(tmpdir_, 1, ref_state)
    assert int(ref_back.opt.step) == 2
    saved = _leaves(state)
    restored = _ref_flat(ref_back)
    assert set(restored) == set(saved)
    for k, w in saved.items():
        np.testing.assert_array_equal(restored[k], w, err_msg=k)
    ref_back, ref_m = ref_step(ref_back, _ref_batch(2))
    state, m = step(state, _batch(2))
    _close_metrics(m, ref_m)


def test_train_state_crosses_both_ways_exactly():
    """train_state_from_reference and its inverse are exact inverses on the
    reference's TrainState (parameters, both moments, the step)."""
    ref_state, _ = _ref_trained(1)
    ref_np = jax.tree.map(np.asarray, ref_state)
    back = flatten_tree(train_state_to_reference(train_state_from_reference(ref_np, CFG, "cpu")))
    want = _ref_flat(ref_np)
    assert set(back) == set(want)
    for k, w in want.items():
        assert back[k].dtype == w.dtype and back[k].shape == w.shape, k
        np.testing.assert_array_equal(back[k], w, err_msg=k)
