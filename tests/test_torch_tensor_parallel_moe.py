"""The model axis for the moe family in the port (the experts' d_ff and
MLA's heads over 'model', gshard routed over the global batch) on the CPU:
gloo worlds of 2 and 4 processes against one process and against the
reference.

The reference's steps (in this process, jitted) are the oracle, for the
smoke variants of deepseek-v2-lite-16b (MLA, 4 experts top-2 plus a shared
one) and kimi-k2-1t-a32b (GQA, the same experts): three train steps from
its own initial parameters (the aux loss read at each step's parameters),
and its prefill of a 4 x 32 prompt then four greedy serve steps.  The
parameters are carried into the port (``params_from_reference``); the same
batches go through the port's cells (``launch/specs.build_cell``) in
separate interpreters joined through a ``file://`` rendezvous under
``tmp_path``:

- the train cell on (data 1, model 2) and on (2, 2), and deepseek's on (2,
  1) (FSDP alone): losses, aux losses and grad norms within 1e-6 relative
  of one process's unsharded step at every step, and of the reference's at
  the first (after it Adam turns rounding into lr-sized moves, C.18: the
  grad norms are held to 1e-4 there, as the dense family's), parameters
  within C.18's bar;
- at a capacity that drops slots (cf 0.5), the (2, 2) train step equals the
  reference's, and an MoE layer on each data rank's rows gives the
  reference's output on the whole batch, which routing each rank's rows
  alone does not (ROADMAP C.19);
- the prefill and decode cells on (1, 2): logits and caches (MLA's latents,
  kimi's KV) within 1e-5 of the reference's, the greedy tokens equal;
- a model drawn sharded (``init_sharded``) equal to the one drawn whole.

On (2, 1) and (2, 2) the experts are split over the data ranks (expert
parallelism, the default policy's layout; its own checks are in
``tests/test_torch_expert_parallel.py``).

In this process: ``check_model_axis`` accepts both configurations at
widths 2, 4 and 16 and refuses an expert d_ff that does not divide and the
experts and their d_ff over one axis (C.20); the experts over 'model' run
(``tests/test_torch_expert_model.py``).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ShardingPolicy as RefPolicy
from repro.config import TrainConfig as RefTrainConfig
from repro.config import get_arch as ref_get_arch
from repro.config import smoke_variant as ref_smoke_variant
from repro.data import make_batch as ref_make_batch
from repro.models import init_params as ref_init_params
from repro.models import loss_fn as ref_loss_fn
from repro.models import prefill as ref_prefill
from repro.models.moe import _router as ref_router
from repro.models.moe import moe_ffn as ref_moe_ffn
from repro.runtime import make_serve_step as ref_make_serve_step
from repro.runtime import make_train_state as ref_make_train_state
from repro.runtime import make_train_step as ref_make_train_step
from repro_torch.config import ShardingPolicy, TrainConfig, get_arch, smoke_variant
from repro_torch.convert import leaves_to_reference, train_state_from_reference
from repro_torch.data import make_batch
from repro_torch.models.moe import moe_ffn
from repro_torch.runtime import make_train_step
from repro_torch.runtime import sharding

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("deepseek-v2-lite-16b", "kimi-k2-1t-a32b")
B, S, STEPS, LR, DECODE = 4, 32, 3, 1e-3, 4
SMALL_CF = 0.5  # drops slots at B x S = 128 tokens, 4 experts, top-2
RTOL = 1e-6
SERVE_TOL = 1e-5
WORLDS = {"1x2": (2, 1), "2x2": (4, 2), "2x1": (2, 2)}  # name: (world, data ranks)


def _tcfg(cls=TrainConfig):
    return cls(lr=LR, warmup_steps=0, total_steps=10)


def _with_cf(cfg, cf):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _ref_train(cfg, state, steps):
    """The reference's ``steps`` train steps from ``state``: (loss, aux at
    the step's parameters, grad norm) a step, and the final parameters."""
    policy = RefPolicy(attn_chunk=16)
    step = jax.jit(ref_make_train_step(cfg, policy, _tcfg(RefTrainConfig)))
    aux_of = jax.jit(lambda p, b: ref_loss_fn(p, cfg, policy, b)[1]["aux"])
    metrics = []
    for i in range(steps):
        batch = {k: jnp.asarray(v) for k, v in ref_make_batch(cfg, B, S, step=i).items()}
        aux = float(aux_of(state.params, batch))
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), aux, float(m["grad_norm"])))
    flat = jax.tree_util.tree_flatten_with_path(state.params)[0]
    after = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in flat}
    return metrics, after


def _moe_input(cfg):
    return np.random.default_rng(5).standard_normal((B, S, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def reference():
    """By arch: the reference's initial state, its train steps, its step
    at the small capacity, one MoE layer on the whole batch at it, and its
    prefill + greedy serve steps."""
    out = {}
    for arch in ARCHS:
        cfg = ref_smoke_variant(ref_get_arch(arch))
        policy = RefPolicy(attn_chunk=16)
        params = ref_init_params(cfg, RefPolicy(), 0, jnp.float32)
        state = ref_make_train_state(params, _tcfg(RefTrainConfig))
        init = jax.tree.map(np.asarray, state)
        metrics, after = _ref_train(cfg, state, STEPS)
        small = _with_cf(cfg, SMALL_CF)
        small_metrics, _ = _ref_train(small, ref_make_train_state(params, _tcfg(RefTrainConfig)),
                                      1)
        moe0 = jax.tree.map(lambda t: t[0], params["blocks"]["moe"])
        x = jnp.asarray(_moe_input(cfg))
        moe_y = np.asarray(ref_moe_ffn(moe0, x, small)[0])
        # the slots the reference drops at the small capacity (its cumsum)
        experts = np.asarray(ref_router(moe0, x.reshape(-1, cfg.d_model), small.moe)[1])
        flat = experts.reshape(-1)
        pos = (np.cumsum(np.eye(cfg.moe.num_experts, dtype=int)[flat], axis=0) - 1)[
            np.arange(flat.size), flat]
        cap = max(1, int(round(SMALL_CF * B * S * cfg.moe.top_k / cfg.moe.num_experts)))

        toks = ref_make_batch(cfg, B, S, step=7)["tokens"]
        lg, cache, pos0 = ref_prefill(params, cfg, policy, jnp.asarray(toks), max_len=S + DECODE)
        names = ("c_kv", "k_pe") if cfg.mla is not None else ("k", "v")
        tree = (lambda c: c["mla"]) if cfg.mla is not None else (lambda c: c)
        serve = {"prefill_logits": np.asarray(lg), "logits": [], "tokens": [],
                 **{f"prefill_{n}": np.asarray(tree(cache)[n])[:, :, :S] for n in names}}
        serve_step = jax.jit(ref_make_serve_step(cfg, policy))
        nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        serve["tokens"].append(np.asarray(nxt))
        for i in range(DECODE):
            lg, cache = serve_step(params, cache, nxt, jnp.int32(pos0 + i))
            nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
            serve["logits"].append(np.asarray(lg))
            serve["tokens"].append(np.asarray(nxt))
        serve.update({n: np.asarray(tree(cache)[n]) for n in names})
        out[arch] = {"init": init, "metrics": metrics, "after": after, "serve": serve,
                     "small_metrics": small_metrics, "moe_y": moe_y, "moe0": moe0,
                     "dropped": int((pos >= cap).sum()), "names": names}
    return out


WORKER = r"""
import dataclasses, pickle, sys
import numpy as np
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.config import ShapeConfig, ShardingPolicy, TrainConfig, get_arch, smoke_variant
from repro_torch.convert import train_state_from_reference
from repro_torch.data import make_batch
from repro_torch.launch.specs import build_cell
from repro_torch.models import activate_mesh, extend_cache, greedy_tokens, init_params
from repro_torch.models.moe import moe_ffn
from repro_torch.runtime import make_train_state
from repro_torch.runtime.sharding import init_sharded, shard_model, tp_distribute

rank, world, data, tmp, arch = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                sys.argv[4], sys.argv[5])
cfg = smoke_variant(get_arch(arch))
policy = ShardingPolicy(attn_chunk=16)
B, S, STEPS, LR, DECODE, SMALL_CF = 4, 32, 3, 1e-3, 4, 0.5
tcfg = TrainConfig(lr=LR, warmup_steps=0, total_steps=10)
dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                        world_size=world)
mesh = init_device_mesh("cpu", (data, world // data), mesh_dim_names=("data", "model"))
with open(f"{tmp}/init.pkl", "rb") as f:
    init = pickle.load(f)

def whole(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()

d = mesh.get_local_rank("data")
rows = slice(d * B // data, (d + 1) * B // data)

def train(c, steps):
    state = train_state_from_reference(init, c, "cpu")
    shard_model(state.params, mesh, policy)
    state = make_train_state(state.params, tcfg)
    cell = build_cell(mesh, c, ShapeConfig("t", S, B, "train"), policy, tcfg, torch.float32)
    metrics = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v[rows]) for k, v in make_batch(c, B, S, step=i).items()}
        state, m = cell.fn(state, batch)
        metrics.append((float(m["loss"]), float(m["aux"]), float(m["grad_norm"])))
    return state, metrics

out = {}
state, out["metrics"] = train(cfg, STEPS)
out["after"] = {n: whole(p) for n, p in state.params.named_parameters()}
del state
small = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=SMALL_CF))
if data > 1 and world > data:  # (2, 2): a step and one MoE layer at a capacity that drops
    out["small_metrics"] = train(small, 1)[1]
    model = tp_distribute(train_state_from_reference(init, cfg, "cpu").params, mesh,
                          policy).requires_grad_(False)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((B, S, cfg.d_model))
                         .astype(np.float32))[rows]
    with activate_mesh(mesh), torch.no_grad():
        y, _ = moe_ffn(model.blocks[0].moe, DTensor.from_local(x, mesh["model"], [Replicate()]),
                       small)
    parts = [None] * world
    dist.all_gather_object(parts, (d, mesh.get_local_rank("model"), y.full_tensor()))
    out["moe_y"] = torch.cat([t for _, m, t in sorted(parts, key=lambda p: p[:2]) if m == 0])

if data == 1:  # the serving cells on (1, model)
    model = tp_distribute(train_state_from_reference(init, cfg, "cpu").params, mesh,
                          policy).requires_grad_(False)
    prefill = build_cell(mesh, cfg, ShapeConfig("p", S, B, "prefill"), policy, tcfg,
                         torch.float32)
    decode = build_cell(mesh, cfg, ShapeConfig("d", S + DECODE, B, "decode"), policy, tcfg,
                        torch.float32)
    toks = torch.from_numpy(make_batch(cfg, B, S, step=7)["tokens"])
    lg, cache = prefill.fn(model, {"tokens": toks})
    tree = (lambda c: c["mla"]) if cfg.mla is not None else (lambda c: c)
    out["prefill_logits"] = whole(lg)
    out.update({f"prefill_{n}": whole(t) for n, t in tree(cache).items()})
    out["cache_placements"] = {n: [repr(x) for x in t.placements] for n, t in tree(cache).items()}
    cache = extend_cache(cfg, cache, S + DECODE)
    nxt = greedy_tokens(lg[:, -1:])
    out["tokens"], out["logits"] = [nxt.clone()], []
    for i in range(DECODE):
        lg, cache = decode.fn(model, cache, {"tokens": nxt},
                              torch.tensor([S + i], dtype=torch.int32))
        nxt = greedy_tokens(lg[:, -1:])
        out["logits"].append(whole(lg))
        out["tokens"].append(nxt.clone())
    out.update({n: whole(t) for n, t in tree(cache).items()})
    out["placements"] = {n: [repr(x) for x in p.placements] for n, p in model.named_parameters()}
    drawn = init_sharded(cfg, mesh, seed=4, dtype=torch.float32, device="cpu", policy=policy)
    ref = init_params(cfg, seed=4, dtype=torch.float32, device="cpu")
    out["init_sharded_equal"] = all(
        torch.equal(whole(p), q) for (_, p), (_, q) in zip(drawn.named_parameters(),
                                                             ref.named_parameters()))
if rank == 0:
    torch.save(out, f"{tmp}/out.pt")
dist.destroy_process_group()
"""


def _run_world(tmp: Path, arch: str, world: int, data: int) -> dict:
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(data),
                               str(tmp), arch], env=env, stdout=subprocess.PIPE,
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
    """By arch: one process's unsharded steps, then the worlds (deepseek's
    FSDP-only world too)."""
    out = {}
    for arch in ARCHS:
        cfg = smoke_variant(get_arch(arch))
        state = train_state_from_reference(reference[arch]["init"], cfg, "cpu")
        step = make_train_step(cfg, ShardingPolicy(attn_chunk=16), _tcfg())
        one = []
        for i in range(STEPS):
            batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, B, S, step=i).items()}
            state, m = step(state, batch)
            one.append((float(m["loss"]), float(m["aux"]), float(m["grad_norm"])))
        out[arch] = {"one": one,
                     "one_after": {n: p.detach() for n, p in state.params.named_parameters()}}
        for name, (world, data) in WORLDS.items():
            if name == "2x1" and arch != ARCHS[0]:
                continue
            tmp = tmp_path_factory.mktemp(f"tp_{arch}_{name}")
            with open(tmp / "init.pkl", "wb") as f:
                pickle.dump(reference[arch]["init"], f)
            out[arch][name] = _run_world(tmp, arch, world, data)
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


def _rel(a, b):
    return abs(a - b) / abs(b)


CASES = [(a, m) for a in ARCHS for m in ("1x2", "2x2")] + [(ARCHS[0], "2x1")]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_train_cell_equals_one_process_and_the_reference(reference, runs, arch, mesh):
    got, one, ref = runs[arch][mesh]["metrics"], runs[arch]["one"], reference[arch]["metrics"]
    for i, (g, o, r) in enumerate(zip(got, one, ref)):
        assert all(_rel(a, b) <= RTOL for a, b in zip(g, o)), (i, g, o)  # loss, aux, norm
        assert _rel(g[0], r[0]) <= RTOL and _rel(g[1], r[1]) <= RTOL, (i, g, r)
        assert _rel(g[2], r[2]) <= (RTOL if i == 0 else 1e-4), (i, g, r)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_train_cell_parameters_within_the_reference_bar(reference, runs, arch, mesh):
    got = leaves_to_reference(runs[arch][mesh]["after"])
    _within_c18(got, reference[arch]["after"])
    _within_c18(got, leaves_to_reference(runs[arch]["one_after"]))  # and one process's


@pytest.mark.parametrize("arch", ARCHS)
def test_dropped_slots_are_the_references_over_the_global_batch(reference, runs, arch):
    """C.19: at cf 0.5 the reference drops slots of the 128-token batch; the
    (2, 2) world's step and its MoE layer on each data rank's rows give the
    reference's, where routing each rank's 64 tokens alone does not."""
    ref, got = reference[arch], runs[arch]["2x2"]
    assert ref["dropped"] > 0
    (g,), (r,) = got["small_metrics"], ref["small_metrics"]
    assert all(_rel(a, b) <= RTOL for a, b in zip(g, r)), (g, r)
    np.testing.assert_allclose(got["moe_y"].numpy(), ref["moe_y"], atol=1e-5, rtol=0)
    cfg = _with_cf(smoke_variant(get_arch(arch)), SMALL_CF)
    p, x = _namespace(ref["moe0"]), torch.from_numpy(_moe_input(cfg))
    alone = torch.cat([moe_ffn(p, x[:B // 2], cfg)[0], moe_ffn(p, x[B // 2:], cfg)[0]])
    assert np.abs(alone.numpy() - ref["moe_y"]).max() > 1e-2


def _namespace(tree):
    """A parameter dict as the attribute tree the port's functions read."""
    return SimpleNamespace(**{k: _namespace(v) if isinstance(v, dict) else
                              torch.from_numpy(np.array(v)) for k, v in tree.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cell_equals_the_reference(reference, runs, arch):
    ref, got = reference[arch]["serve"], runs[arch]["1x2"]
    np.testing.assert_allclose(got["prefill_logits"].numpy(), ref["prefill_logits"],
                               atol=SERVE_TOL, rtol=0)
    for n in reference[arch]["names"]:
        np.testing.assert_allclose(got[f"prefill_{n}"][:, :, :S].numpy(), ref[f"prefill_{n}"],
                                   atol=SERVE_TOL, rtol=0)
        assert got["cache_placements"][n] == ["Shard(dim=2)"]  # the sequence over 'model'


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cell_equals_the_reference(reference, runs, arch):
    ref, got = reference[arch]["serve"], runs[arch]["1x2"]
    for a, b in zip(got["tokens"], ref["tokens"]):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(got["logits"], ref["logits"]):
        np.testing.assert_allclose(a.numpy(), b, atol=SERVE_TOL, rtol=0)
    for n in reference[arch]["names"]:
        np.testing.assert_allclose(got[n].numpy(), ref[n], atol=SERVE_TOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_experts_and_mla_heads_are_split_over_the_model_axis(runs, arch):
    """Each expert's d_ff over 'model' (w_gate/w_up on F, w_down on its
    input F), the router replicated; MLA's w_uk/w_uv on their heads, the
    latent projections replicated."""
    pl = runs[arch]["1x2"]["placements"]
    assert pl["blocks.0.moe.w_gate"] == pl["blocks.0.moe.w_up"] == ["Shard(dim=2)"]
    assert pl["blocks.0.moe.w_down"] == ["Shard(dim=1)"]
    assert pl["blocks.0.moe.router"] == ["Replicate()"]
    assert pl["blocks.0.moe.shared.w_down"] == ["Shard(dim=0)"]
    if arch == "deepseek-v2-lite-16b":
        assert pl["blocks.0.attn.w_uk"] == pl["blocks.0.attn.w_uv"] == ["Shard(dim=1)"]
        assert pl["blocks.0.attn.w_dkv"] == pl["blocks.0.attn.w_kr"] == ["Replicate()"]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_sharded_draws_the_weights_init_params_draws(runs, arch):
    assert runs[arch]["1x2"]["init_sharded_equal"]


@pytest.mark.parametrize("width", [2, 4, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_configs_run_on_a_model_axis(arch, width):
    sharding.check_model_axis(get_arch(arch), ShardingPolicy(), width)


def test_an_expert_d_ff_that_does_not_divide_is_refused():
    cfg = get_arch("deepseek-v2-lite-16b")
    odd = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, d_ff_expert=1400))
    with pytest.raises(ValueError, match=r"d_ff_expert.*do not divide"):
        sharding.check_model_axis(odd, ShardingPolicy(), 16)  # 1400 / 16 = 87.5
    sharding.check_model_axis(odd, ShardingPolicy(), 8)


@pytest.mark.parametrize("field,value", [("kv_cache_dtype", "int8"), ("expert_ff_axis", "data"),
                                         ("expert_axis", "model"),
                                         ("expert_axis+expert_ff_axis", "model+data")])
def test_unported_moe_policy_values_refuse_naming_their_roadmap_item(field, value):
    """The experts over 'model' with their d_ff over 'data' (A.18 item 7)
    run on a model axis now, beside the int8 cache (item 5) too; the
    experts and their d_ff over one axis ('data' twice, or 'model' twice)
    are refused naming C.20."""
    cfg = smoke_variant(get_arch("deepseek-v2-lite-16b"))
    over = dict(zip(field.split("+"), value.split("+")))
    if field == "kv_cache_dtype":
        sharding.check_model_axis(cfg, ShardingPolicy(**over), 2)  # runs now
        sharding.check_model_axis(cfg, ShardingPolicy(**over, expert_axis="model",
                                                      expert_ff_axis="data"), 2)
        return
    if len(over) == 2:
        sharding.check_model_axis(cfg, ShardingPolicy(**over), 2)  # item 7 runs now
        return
    axis = "data" if field == "expert_ff_axis" else "model"
    with pytest.raises(ValueError, match=rf"{field}.*'{axis}' twice.*ROADMAP C\.20"):
        sharding.check_model_axis(cfg, ShardingPolicy(**over), 2)


def test_a_leaf_past_whole_is_drawn_in_slabs_deferred_or_not(monkeypatch):
    """A leaf of more than ``WHOLE`` elements (kimi-k2-1t-a32b's experts) is
    drawn a slab of about ``PIECE`` elements along dim 0 at a time, when its
    deferred draw is called, from the seed at the fan-in scale: on the CPU
    generator the same numbers as the leaf drawn whole."""
    from repro_torch.models import layers

    def draw(whole, piece):
        monkeypatch.setattr(layers, "WHOLE", whole)
        monkeypatch.setattr(layers, "PIECE", piece)
        t = layers.Initializer(0, dtype=torch.float32, device="cpu").normal((16, 8, 20))
        assert callable(t)
        return t()

    slabs = draw(1_000, 300)  # 16 slabs of [1, 8, 20]
    assert torch.equal(slabs, draw(1_000, 300)) and slabs.shape == (16, 8, 20)
    assert torch.equal(slabs, draw(1 << 30, 1 << 28))
    assert not torch.equal(slabs[0], slabs[1])  # the generator runs on across slabs
    assert abs(float(slabs.std()) - 8 ** -0.5) < 0.02
