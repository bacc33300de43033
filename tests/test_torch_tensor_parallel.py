"""Tensor parallelism in the port (a model axis wider than 1: the dense
family's weights as DTensors on the model submesh, the reference's
``constrain`` layouts) on the CPU: gloo worlds of 2 and 4 processes
against one process and against the reference.

The reference's steps (in this process, jitted) are the oracle: three
train steps of llama3.2-3b's smoke variant (4 heads, 2 KV, d_ff 128, vocab
256) from its own initial parameters, and its prefill of a 4 x 32 prompt
then four greedy serve steps.  The parameters are carried into the port
(``params_from_reference``); the same batches then go through the port's
cells (``launch/specs.build_cell``) in separate interpreters joined through
a ``file://`` rendezvous under ``tmp_path``:

- the train cell on (data 1, model 2) and on (data 2, model 2) (model axis
  and FSDP together): losses and grad norms within 1e-6 relative of one
  process's unsharded step, parameters within C.18's bar of the
  reference's;
- the prefill and decode cells on (1, 2): logits and caches within 1e-5 of
  the reference's, the greedy tokens equal;
- a model drawn sharded (``init_sharded``) equal to the one drawn whole, and
  the vocabulary-sharded argmax equal to ``argmax``.

In this process, over a fake process group: ``constrain``'s placements on a
model axis of 2, the identity on a model axis of 1, ``check_model_axis``
accepting the ssm, hybrid, audio and vlm families' configurations at widths
2, 4 and 16 (their cells run in ``test_torch_tensor_parallel_ssm.py`` and
``test_torch_tensor_parallel_families.py``) and refusing a width a sharded
dim does not divide, and the refusal of the one policy value whose layout
the port keeps refusing, a model axis not named 'model' (ROADMAP A.18).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.config import ShardingPolicy as RefPolicy
from repro.config import TrainConfig as RefTrainConfig
from repro.config import get_arch as ref_get_arch
from repro.config import smoke_variant as ref_smoke_variant
from repro.data import make_batch as ref_make_batch
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.runtime import make_serve_step as ref_make_serve_step
from repro.runtime import make_train_state as ref_make_train_state
from repro.runtime import make_train_step as ref_make_train_step
from repro_torch.config import ShardingPolicy, TrainConfig, get_arch, smoke_variant
from repro_torch.convert import leaves_to_reference, train_state_from_reference
from repro_torch.data import make_batch
from repro_torch.launch.dryrun import fake_world
from repro_torch.models.layers import activate_mesh, constrain
from repro_torch.runtime import make_train_step
from repro_torch.runtime import sharding

REPO = Path(__file__).resolve().parents[1]
ARCH = "llama3.2-3b"
B, S, STEPS, LR, DECODE = 4, 32, 3, 1e-3, 4
CFG = smoke_variant(get_arch(ARCH))
POLICY = ShardingPolicy(attn_chunk=16)
RTOL = 1e-6
SERVE_TOL = 1e-5


def _tcfg() -> TrainConfig:
    return TrainConfig(lr=LR, warmup_steps=0, total_steps=10)


@pytest.fixture(scope="module")
def reference():
    """The reference's initial state, its three train steps, and its
    prefill + greedy serve steps."""
    cfg = ref_smoke_variant(ref_get_arch(ARCH))
    tcfg = RefTrainConfig(lr=LR, warmup_steps=0, total_steps=10)
    ref_policy = RefPolicy(attn_chunk=16)
    params = ref_init_params(cfg, RefPolicy(), 0, jnp.float32)
    state = ref_make_train_state(params, tcfg)
    init = jax.tree.map(np.asarray, state)
    step = jax.jit(ref_make_train_step(cfg, ref_policy, tcfg))
    metrics = []
    for i in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in ref_make_batch(cfg, B, S, step=i).items()}
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    flat = jax.tree_util.tree_flatten_with_path(state.params)[0]
    after = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in flat}

    toks = ref_make_batch(cfg, B, S, step=7)["tokens"]
    lg, cache, pos = ref_prefill(params, cfg, ref_policy, jnp.asarray(toks), max_len=S + DECODE)
    serve = {"prefill_logits": np.asarray(lg), "prefill_k": np.asarray(cache["k"])[:, :, :S],
             "prefill_v": np.asarray(cache["v"])[:, :, :S], "logits": [], "tokens": []}
    serve_step = jax.jit(ref_make_serve_step(cfg, ref_policy))
    nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
    serve["tokens"].append(np.asarray(nxt))
    for i in range(DECODE):
        lg, cache = serve_step(params, cache, nxt, jnp.int32(pos + i))
        nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        serve["logits"].append(np.asarray(lg))
        serve["tokens"].append(np.asarray(nxt))
    serve["k"], serve["v"] = np.asarray(cache["k"]), np.asarray(cache["v"])
    return {"init": init, "metrics": metrics, "after": after, "serve": serve, "prompt": toks}


WORKER = r"""
import pickle, sys
import numpy as np
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch.config import ShapeConfig, ShardingPolicy, TrainConfig, get_arch, smoke_variant
from repro_torch.convert import train_state_from_reference
from repro_torch.data import make_batch
from repro_torch.launch.specs import build_cell
from repro_torch.models import extend_cache, greedy_tokens, init_params
from repro_torch.runtime import make_train_state
from repro_torch.runtime.sharding import init_sharded, shard_model, tp_distribute

rank, world, data, tmp = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
cfg = smoke_variant(get_arch("llama3.2-3b"))
policy = ShardingPolicy(attn_chunk=16)
B, S, STEPS, LR, DECODE = 4, 32, 3, 1e-3, 4
tcfg = TrainConfig(lr=LR, warmup_steps=0, total_steps=10)
dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                        world_size=world)
mesh = init_device_mesh("cpu", (data, world // data), mesh_dim_names=("data", "model"))
with open(f"{tmp}/init.pkl", "rb") as f:
    init = pickle.load(f)

def whole(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()

out = {}
# the train cell: each data rank its rows of every global batch
state = train_state_from_reference(init, cfg, "cpu")
shard_model(state.params, mesh, policy)
state = make_train_state(state.params, tcfg)
cell = build_cell(mesh, cfg, ShapeConfig("t", S, B, "train"), policy, tcfg, torch.float32)
d = mesh.get_local_rank("data")
rows = slice(d * B // data, (d + 1) * B // data)
metrics = []
for i in range(STEPS):
    batch = {k: torch.from_numpy(v[rows]) for k, v in make_batch(cfg, B, S, step=i).items()}
    state, m = cell.fn(state, batch)
    metrics.append((float(m["loss"]), float(m["grad_norm"])))
out["metrics"] = metrics
out["after"] = {n: whole(p) for n, p in state.params.named_parameters()}
out["placements"] = {n: [repr(x) for x in p.placements] for n, p in state.params.named_parameters()}
del state

if data == 1:  # the serving cells on (1, model)
    model = tp_distribute(train_state_from_reference(init, cfg, "cpu").params, mesh, policy)
    model.requires_grad_(False)
    prefill = build_cell(mesh, cfg, ShapeConfig("p", S, B, "prefill"), policy, tcfg,
                         torch.float32)
    decode = build_cell(mesh, cfg, ShapeConfig("d", S + DECODE, B, "decode"), policy, tcfg,
                        torch.float32)
    toks = torch.from_numpy(make_batch(cfg, B, S, step=7)["tokens"])
    lg, cache = prefill.fn(model, {"tokens": toks})
    out["prefill_logits"] = whole(lg)
    out["prefill_k"], out["prefill_v"] = whole(cache["k"]), whole(cache["v"])
    out["cache_placements"] = [repr(x) for x in cache["k"].placements]
    cache = extend_cache(cfg, cache, S + DECODE)
    nxt = greedy_tokens(lg[:, -1:])
    out["tokens"], out["logits"] = [nxt.clone()], []
    for i in range(DECODE):
        lg, cache = decode.fn(model, cache, {"tokens": nxt}, torch.tensor([S + i], dtype=torch.int32))
        nxt = greedy_tokens(lg[:, -1:])
        out["logits"].append(whole(lg))
        out["tokens"].append(nxt.clone())
    out["k"], out["v"] = whole(cache["k"]), whole(cache["v"])
    # a checkpointed block recomputed where no mesh is active (autograd runs
    # the backward pass on a thread of its own for a card) gives the grads
    # of the backward under the mesh
    from repro_torch.models import activate_mesh, loss_fn
    batch0 = {k: torch.from_numpy(v) for k, v in make_batch(cfg, B, S, step=0).items()}
    def grads(inside):
        mdl = tp_distribute(train_state_from_reference(init, cfg, "cpu").params, mesh, policy)
        with activate_mesh(mesh):
            total, _ = loss_fn(mdl, cfg, policy, batch0)
            if inside:
                total.backward()
        if not inside:
            total.backward()
        return {n: whole(p.grad) for n, p in mdl.named_parameters()}
    inside, outside = grads(True), grads(False)
    out["recompute_outside_mesh_equal"] = all(torch.equal(inside[n], outside[n]) for n in inside)
    # greedy over vocabulary shards, ties included, against argmax
    g = torch.Generator().manual_seed(3)
    logits = torch.randint(0, 5, (6, 1, cfg.vocab_size), generator=g).float()
    shards = DTensor.from_local(logits.chunk(world // data, -1)[mesh.get_local_rank("model")],
                                mesh["model"], [torch.distributed.tensor.Shard(2)],
                                run_check=False)
    out["greedy_equal"] = bool(torch.equal(greedy_tokens(shards), greedy_tokens(logits)))
    # a model drawn sharded equals the one drawn whole
    drawn = init_sharded(cfg, mesh, seed=4, dtype=torch.float32, device="cpu", policy=policy)
    ref = init_params(cfg, seed=4, dtype=torch.float32, device="cpu")
    out["init_sharded_equal"] = all(
        torch.equal(whole(p), q) for (_, p), (_, q) in zip(drawn.named_parameters(),
                                                             ref.named_parameters()))
if rank == 0:
    torch.save(out, f"{tmp}/out.pt")
dist.destroy_process_group()
"""


def _run_world(tmp: Path, world: int, data: int) -> dict:
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(data),
                               str(tmp)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, err[-3000:])
    return torch.load(tmp / "out.pt", weights_only=True)


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    """One process's unsharded steps, then the (1, 2) and (2, 2) worlds."""
    one_state = train_state_from_reference(reference["init"], CFG, "cpu")
    step = make_train_step(CFG, POLICY, _tcfg())
    one = []
    for i in range(STEPS):
        batch = {k: torch.from_numpy(v) for k, v in make_batch(CFG, B, S, step=i).items()}
        one_state, m = step(one_state, batch)
        one.append((float(m["loss"]), float(m["grad_norm"])))
    out = {"one": one,
           "one_after": {n: p.detach() for n, p in one_state.params.named_parameters()}}
    for name, world, data in (("1x2", 2, 1), ("2x2", 4, 2)):
        tmp = tmp_path_factory.mktemp(f"tp{name}")
        with open(tmp / "init.pkl", "wb") as f:
            pickle.dump(reference["init"], f)
        out[name] = _run_world(tmp, world, data)
    return out


def _within_c18(got: dict, want: dict) -> None:
    """C.18's allowance: all within 2 lr, at most 1 element in 10^4 outside
    the reference's microbatch bar (rtol 2e-3, atol 2e-4)."""
    assert set(got) == set(want)
    outside = total = 0
    for k, w in want.items():
        diff = np.abs(np.asarray(got[k], np.float64) - w)
        assert diff.max() <= 2 * LR, (k, diff.max())
        outside += int((diff > 2e-4 + 2e-3 * np.abs(w)).sum())
        total += w.size
    assert outside <= total // 10_000, (outside, total)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_train_cell_equals_one_process_and_the_reference(reference, runs, mesh):
    got = runs[mesh]["metrics"]
    for (l2, g2), (l1, g1), (lr, gr) in zip(got, runs["one"], reference["metrics"]):
        assert abs(l2 - l1) <= RTOL * abs(l1) and abs(g2 - g1) <= RTOL * abs(g1)
        assert abs(l2 - lr) < 2e-4 and abs(g2 - gr) <= 1e-4 * gr


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_train_cell_parameters_within_the_reference_bar(reference, runs, mesh):
    _within_c18(leaves_to_reference(runs[mesh]["after"]), reference["after"])
    _within_c18(leaves_to_reference(runs[mesh]["after"]),  # and one process's (C.18 again)
                leaves_to_reference(runs["one_after"]))


def test_train_cell_weights_are_split_over_both_axes(runs):
    """(2, 2): the projections over 'model' on d_out (w_q) or d_in (w_o),
    over 'data' on the other dim; the norms whole on the data ranks and
    replicated over 'model'."""
    pl = runs["2x2"]["placements"]
    assert pl["blocks.0.attn.w_q"] == ["Shard(dim=0)", "Shard(dim=1)"]
    assert pl["blocks.0.attn.w_o"] == ["Shard(dim=1)", "Shard(dim=0)"]
    assert pl["embed"] == ["Shard(dim=1)", "Shard(dim=0)"]
    assert pl["blocks.0.ln1"] == ["Replicate()"]
    assert runs["1x2"]["placements"]["blocks.0.mlp.w_down"] == ["Shard(dim=1)", "Shard(dim=0)"]


def test_prefill_cell_equals_the_reference(reference, runs):
    ref, got = reference["serve"], runs["1x2"]
    np.testing.assert_allclose(got["prefill_logits"].numpy(), ref["prefill_logits"],
                               atol=SERVE_TOL, rtol=0)
    for name in ("prefill_k", "prefill_v"):
        np.testing.assert_allclose(got[name].numpy(), ref[name], atol=SERVE_TOL, rtol=0)
    assert got["cache_placements"] == ["Shard(dim=2)"]  # the sequence over 'model'


def test_decode_cell_equals_the_reference(reference, runs):
    ref, got = reference["serve"], runs["1x2"]
    for a, b in zip(got["tokens"], ref["tokens"]):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(got["logits"], ref["logits"]):
        np.testing.assert_allclose(a.numpy(), b, atol=SERVE_TOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(got[name].numpy(), ref[name], atol=SERVE_TOL, rtol=0)


def test_remat_recomputes_under_the_mesh_of_the_forward(runs):
    """The backward pass outside ``activate_mesh`` (where autograd runs it on
    a card) recomputes each block in the forward's layouts."""
    assert runs["1x2"]["recompute_outside_mesh_equal"]


def test_greedy_tokens_over_vocabulary_shards_equal_argmax(runs):
    assert runs["1x2"]["greedy_equal"]


def test_init_sharded_draws_the_weights_init_params_draws(runs):
    assert runs["1x2"]["init_sharded_equal"]


@pytest.mark.parametrize("spec,want", [
    ((("pod", "data"), None, None), (Replicate(),)),
    ((("pod", "data"), None, "model"), (Shard(2),)),
    ((("pod", "data"), "model", None, None), (Shard(1),)),
])
def test_constrain_gives_the_placements_its_spec_names(spec, want):
    shape = (2, 4, 6, 8)[:len(spec)]
    start = [Shard(2)] if want == (Replicate(),) else [Replicate()]
    local = torch.ones(shape[:2] + (3,) + shape[3:]) if start == [Shard(2)] else torch.ones(shape)
    with fake_world(2):
        mesh = DeviceMesh("cpu", torch.arange(2).reshape(1, 2), mesh_dim_names=("data", "model"))
        x = DTensor.from_local(local, mesh["model"], start, run_check=False)
        with activate_mesh(mesh):
            y = constrain(x, *spec)
        assert tuple(y.placements) == want
        assert y.shape == x.shape == shape


def test_constrain_is_the_identity_on_a_model_axis_of_one():
    x = torch.ones(2, 3)
    with fake_world(2):
        mesh = DeviceMesh("cpu", torch.arange(2).reshape(2, 1), mesh_dim_names=("data", "model"))
        with activate_mesh(mesh):
            assert constrain(x, ("pod", "data"), None, "model") is x
        data = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("data",))
        with activate_mesh(data):
            assert constrain(x, ("pod", "data"), "model") is x


def test_constrain_refuses_a_plain_tensor_on_a_model_axis():
    with fake_world(2):
        mesh = DeviceMesh("cpu", torch.arange(2).reshape(1, 2), mesh_dim_names=("data", "model"))
        with activate_mesh(mesh), pytest.raises(ValueError, match="DTensors"):
            constrain(torch.ones(2, 3), ("pod", "data"), None)


@pytest.mark.parametrize("width", [2, 4, 16])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b", "musicgen-medium", "paligemma-3b"])
def test_families_run_on_a_model_axis(arch, width):
    """hymba-1.5b's 50 SSM heads divide neither 4 nor 16: its head dim (64)
    goes over 'model' instead."""
    sharding.check_model_axis(get_arch(arch), ShardingPolicy(), width)


def test_a_mamba_width_that_does_not_divide_is_refused():
    cfg = smoke_variant(get_arch("mamba2-2.7b"))  # d_inner 128, conv channels 160
    with pytest.raises(ValueError, match=r"d_inner.*do not divide over a model axis of 3"):
        sharding.check_model_axis(cfg, ShardingPolicy(), 3)


@pytest.mark.parametrize("field,value,beside", [
    ("kv_cache_dtype", "int8", {"sp_activations": True}),
    ("attention_impl", "cuda", {"shard_seq_attn": False, "qkv_feature_shard": False}),
    ("kv_cache_dtype", "int8", {}), ("attention_impl", "cuda", {}), ("model_axis", "tp", {})])
def test_unported_policy_values_refuse_naming_their_roadmap_item(field, value, beside):
    """Beside the activation layouts that are ported (``beside``: they run):
    the int8 cache and the kernels run now (A.18 items 5-6); a model axis
    named other than 'model' is still refused, by name, beside them too."""
    policy = ShardingPolicy(**beside, **{field: value})
    if field == "model_axis":
        with pytest.raises(ValueError, match=rf"{field}.*ROADMAP A\.18"):
            sharding.check_model_axis(CFG, policy, 2)
    else:
        sharding.check_model_axis(CFG, policy, 2)  # runs now
        with pytest.raises(ValueError, match=r"\{'model_axis': 'tp'\}.*ROADMAP A\.18"):
            sharding.check_model_axis(CFG, ShardingPolicy(**beside, **{field: value},
                                                          model_axis="tp"), 2)
    sharding.check_model_axis(CFG, ShardingPolicy(**beside), 2)  # the ported layout runs
    sharding.check_model_axis(CFG, ShardingPolicy(), 2)  # the default runs
    with pytest.raises(ValueError, match="do not divide"):
        sharding.check_model_axis(CFG, ShardingPolicy(), 3)  # d_ff 128 over 3
