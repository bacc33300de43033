"""Expert parallelism in the port (an MoE model's routed experts split on E
over the batch axes, the gshard slots sent to them by all-to-all) on the
CPU: gloo worlds of 2 and 4 processes against one process and against the
reference.

The reference's steps (in this process, jitted) are the oracle, for the
smoke variants of deepseek-v2-lite-16b (MLA, 4 experts top-2 plus a shared
one) and kimi-k2-1t-a32b (GQA, the same experts): three train steps from
its own initial parameters (the aux loss read at each step's parameters),
one step at a capacity that drops slots (cf 0.5), and its prefill of a 4 x
32 prompt then four greedy serve steps.  The parameters are carried into
the port (``params_from_reference``); the same batches go through the
port's cells (``launch/specs.build_cell``) in one gloo world a mesh, (data
2, model 1), (2, 2) and (4, 1), each running both models, in separate
interpreters joined through a ``file://`` rendezvous under ``tmp_path``:

- the train cell on each mesh: losses, aux losses and grad norms within
  1e-6 relative of one process's unsharded step at every step, and of the
  reference's at the first (after it Adam turns rounding into lr-sized
  moves, C.18: the grad norms are held to 1e-4 there); parameters within
  C.18's bar;
- at cf 0.5 the (2, 2) and (4, 1) steps equal the reference's;
- the prefill and decode cells on (2, 1) and (2, 2), each data rank its
  rows: logits and caches within 1e-5 of the reference's, greedy tokens
  equal;
- each rank holds only its E / ranks experts' slabs (d_ff over 'model'),
  FSDP manages no expert leaf, and in a step under ``CommDebugMode`` every
  all-gather is one of FSDP's units without the experts, while the
  all-to-alls carry the slots;
- a (2, 2) checkpoint restores on (4, 1) and in one process, leaf for
  leaf; a model drawn sharded on (2, 2) equals the one drawn whole;
- on (2, 1) the dense oracle over the experts' ranks equals the
  reference's dense step, and the experts over 'model' (each expert's d_ff
  over 'data', outside FSDP: ``tests/test_torch_expert_model.py``) one
  process's.

In this process: an expert count the batch ranks do not divide, and the
experts and their d_ff over one axis (each expert's d_ff over 'data'
beside the experts over 'data', or both over 'model'), are refused, and
the experts over 'model' with their d_ff over 'data' run on a model axis;
a deferred leaf's rows are the whole leaf's.
"""

from __future__ import annotations

import dataclasses
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

from repro.config import ShardingPolicy as RefPolicy
from repro.config import TrainConfig as RefTrainConfig
from repro.config import get_arch as ref_get_arch
from repro.config import smoke_variant as ref_smoke_variant
from repro.data import make_batch as ref_make_batch
from repro.models import init_params as ref_init_params
from repro.models import loss_fn as ref_loss_fn
from repro.models import prefill as ref_prefill
from repro.runtime import make_serve_step as ref_make_serve_step
from repro.runtime import make_train_state as ref_make_train_state
from repro.runtime import make_train_step as ref_make_train_step
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.config import ShardingPolicy, TrainConfig, get_arch, smoke_variant
from repro_torch.convert import leaves_to_reference, train_state_from_reference
from repro_torch.data import make_batch
from repro_torch.runtime import make_train_step
from repro_torch.runtime import sharding

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("deepseek-v2-lite-16b", "kimi-k2-1t-a32b")
B, S, STEPS, LR, DECODE = 4, 32, 3, 1e-3, 4
SMALL_CF = 0.5  # drops slots at B x S = 128 tokens, 4 experts, top-2
RTOL = 1e-6
SERVE_TOL = 1e-5
WORLDS = {"2x1": (2, 2), "2x2": (4, 2), "4x1": (4, 4)}  # name: (world, data ranks), in order
SERVED = ("2x1", "2x2")


def _tcfg(cls=TrainConfig):
    return cls(lr=LR, warmup_steps=0, total_steps=10)


def _with_cf(cfg, cf):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _ref_train(cfg, state, steps, policy=None):
    """The reference's ``steps`` train steps from ``state``: (loss, aux at
    the step's parameters, grad norm) a step, and the final parameters."""
    policy = policy or RefPolicy(attn_chunk=16)
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


@pytest.fixture(scope="module")
def reference():
    """By arch: the reference's initial state, its train steps, its step at
    the small capacity, and its prefill + greedy serve steps."""
    out = {}
    for arch in ARCHS:
        cfg = ref_smoke_variant(ref_get_arch(arch))
        policy = RefPolicy(attn_chunk=16)
        params = ref_init_params(cfg, RefPolicy(), 0, jnp.float32)
        state = ref_make_train_state(params, _tcfg(RefTrainConfig))
        init = jax.tree.map(np.asarray, state)
        metrics, after = _ref_train(cfg, state, STEPS)
        small_metrics, _ = _ref_train(_with_cf(cfg, SMALL_CF),
                                      ref_make_train_state(params, _tcfg(RefTrainConfig)), 1)
        dense_metrics, _ = _ref_train(cfg, ref_make_train_state(params, _tcfg(RefTrainConfig)), 1,
                                      RefPolicy(attn_chunk=16, moe_impl="dense"))
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
                     "small_metrics": small_metrics, "dense_metrics": dense_metrics,
                     "names": names}
    return out


WORKER = r"""
import dataclasses, pickle, sys
import numpy as np
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.config import ShapeConfig, ShardingPolicy, TrainConfig, get_arch, smoke_variant
from repro_torch.convert import train_state_from_reference
from repro_torch.data import make_batch
from repro_torch.launch.specs import build_cell
from repro_torch.models import extend_cache, greedy_tokens, init_params
from repro_torch.runtime import make_train_state
from repro_torch.runtime.profile import CommBytes
from repro_torch.runtime.sharding import init_sharded, is_expert_leaf, shard_model, tp_distribute

rank, world, data, tmp, name = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                                sys.argv[5])
policy = ShardingPolicy(attn_chunk=16)
B, S, STEPS, LR, DECODE, SMALL_CF = 4, 32, 3, 1e-3, 4, 0.5
tcfg = TrainConfig(lr=LR, warmup_steps=0, total_steps=10)
dist.init_process_group("gloo", init_method=f"file://{tmp}/{name}/rendezvous", rank=rank,
                        world_size=world)
mesh = init_device_mesh("cpu", (data, world // data), mesh_dim_names=("data", "model"))
d = mesh.get_local_rank("data")
rows = slice(d * B // data, (d + 1) * B // data)


def whole(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()


class Gathers(CommBytes):
    # each all-gather's (op, bytes), in order: FSDP's (c10d) and DTensor's
    def __init__(self):
        super().__init__()
        self.each = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = dict(self.bytes)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        self.each += [(k, v - before.get(k, 0)) for k, v in self.bytes.items()
                      if "gather" in k and v > before.get(k, 0)]
        return out


def fsdp_units(model):
    # FSDP's units (each block, the root): the names of the leaves each
    # manages and the bytes of its all-gather's output
    named = {id(p): n for n, p in model.named_parameters()}
    out = []
    for unit in [*model.blocks, model]:
        params = unit._get_fsdp_state()._fsdp_param_group.fsdp_params
        out.append(([named[id(fp.sharded_param)] for fp in params],
                    data * sum(fp.padded_sharded_param_size.numel() * fp.param_dtype.itemsize
                               if fp.param_dtype is not None else
                               fp.padded_sharded_param_size.numel()
                               * fp.sharded_param.element_size() for fp in params)))
    return out


def train(cfg, init, steps, policy=policy):
    state = train_state_from_reference(init, cfg, "cpu")
    shard_model(state.params, mesh, policy)
    state = make_train_state(state.params, tcfg)
    cell = build_cell(mesh, cfg, ShapeConfig("t", S, B, "train"), policy, tcfg, torch.float32)
    metrics = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v[rows]) for k, v in make_batch(cfg, B, S, step=i).items()}
        state, m = cell.fn(state, batch)
        metrics.append((float(m["loss"]), float(m["aux"]), float(m["grad_norm"])))
    return state, cell, metrics


out = {}
for arch in ("deepseek-v2-lite-16b", "kimi-k2-1t-a32b"):
    cfg = smoke_variant(get_arch(arch))
    with open(f"{tmp}/init_{arch}.pkl", "rb") as f:
        init = pickle.load(f)
    got = out[arch] = {}
    state, cell, got["metrics"] = train(cfg, init, STEPS)
    got["after"] = {n: whole(p) for n, p in state.params.named_parameters()}
    got["expert_local"] = {n: (tuple(p.to_local().shape), [repr(x) for x in p.placements])
                           for n, p in state.params.named_parameters() if is_expert_leaf(n)}
    units = fsdp_units(state.params)
    got["fsdp_leaves"] = [n for names, _ in units for n in names]
    got["fsdp_unit_bytes"] = [b for _, b in units]
    ckpt = f"{tmp}/ckpt_{arch}"
    if name == "2x2":  # the checkpoint the (4, 1) world and one process restore
        save_checkpoint(ckpt, STEPS, state)
        got["moments"] = {n: (whole(state.opt.m[n]), whole(state.opt.v[n]))
                          for n in state.opt.m}
    if name == "4x1":
        fresh = train_state_from_reference(init, cfg, "cpu")
        shard_model(fresh.params, mesh, policy)
        fresh = make_train_state(fresh.params, tcfg)
        restore_checkpoint(ckpt, STEPS, fresh, device="cpu")
        got["restored"] = {n: whole(p) for n, p in fresh.params.named_parameters()}
        got["restored_moments"] = {n: (whole(fresh.opt.m[n]), whole(fresh.opt.v[n]))
                                   for n in fresh.opt.m}
        got["restored_step"] = int(fresh.opt.step)
        del fresh
    batch = {k: torch.from_numpy(v[rows]) for k, v in make_batch(cfg, B, S, step=STEPS).items()}
    comm = Gathers()
    with comm:
        cell.fn(state, batch)
    got["gathers"], got["collectives"] = comm.each, comm.counts()
    del state, cell
    if name != "2x1":  # a step at a capacity that drops slots
        small = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                 capacity_factor=SMALL_CF))
        got["small_metrics"] = train(small, init, 1)[2]
    if name == "2x1":  # the dense oracle over the experts' ranks; the experts over 'model'
        got["dense_metrics"] = train(cfg, init, 1, dataclasses.replace(policy,
                                                                      moe_impl="dense"))[2]
        state, _, got["model_axis_metrics"] = train(cfg, init, 1, dataclasses.replace(
            policy, expert_axis="model", expert_ff_axis="data"))
        got["model_axis_experts"] = {n: tuple(p.to_local().shape)
                                     for n, p in state.params.named_parameters()
                                     if is_expert_leaf(n)}
        got["model_axis_fsdp"] = [n for names, _ in fsdp_units(state.params) for n in names]
        del state
    if name in ("2x1", "2x2"):  # the serving cells, each data rank its rows
        model = tp_distribute(train_state_from_reference(init, cfg, "cpu").params, mesh,
                              policy).requires_grad_(False)
        prefill = build_cell(mesh, cfg, ShapeConfig("p", S, B, "prefill"), policy, tcfg,
                             torch.float32)
        decode = build_cell(mesh, cfg, ShapeConfig("d", S + DECODE, B, "decode"), policy, tcfg,
                            torch.float32)
        toks = torch.from_numpy(make_batch(cfg, B, S, step=7)["tokens"])[rows]
        lg, cache = prefill.fn(model, {"tokens": toks})
        tree = (lambda c: c["mla"]) if cfg.mla is not None else (lambda c: c)
        got["prefill_logits"] = whole(lg)
        got.update({f"prefill_{n}": whole(t) for n, t in tree(cache).items()})
        cache = extend_cache(cfg, cache, S + DECODE)
        nxt = greedy_tokens(lg[:, -1:])
        got["tokens"], got["logits"] = [nxt.clone()], []
        for i in range(DECODE):
            lg, cache = decode.fn(model, cache, {"tokens": nxt},
                                  torch.tensor([S + i], dtype=torch.int32))
            nxt = greedy_tokens(lg[:, -1:])
            got["logits"].append(whole(lg))
            got["tokens"].append(nxt.clone())
        got.update({n: whole(t) for n, t in tree(cache).items()})
    if name == "2x2":
        drawn = init_sharded(cfg, mesh, seed=4, dtype=torch.float32, device="cpu", policy=policy)
        ref = init_params(cfg, seed=4, dtype=torch.float32, device="cpu")
        got["init_sharded_equal"] = all(
            torch.equal(whole(p), q) for (_, p), (_, q) in zip(drawn.named_parameters(),
                                                                 ref.named_parameters()))
out["data_rank"], out["model_rank"] = d, mesh.get_local_rank("model")
torch.save(out, f"{tmp}/{name}/out_{rank}.pt")
dist.destroy_process_group()
"""


def _run_world(tmp: Path, name: str, world: int, data: int) -> list:
    """The world's ranks' outputs, each data rank's once (model rank 0), in
    the data ranks' order."""
    (tmp / name).mkdir()
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(data),
                               str(tmp), name], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (name, r, err[-3000:])
    ranks = [torch.load(tmp / name / f"out_{r}.pt", weights_only=True) for r in range(world)]
    return sorted((o for o in ranks if o["model_rank"] == 0), key=lambda o: o["data_rank"])


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    """One process's unsharded steps by arch, then each world's data ranks'
    outputs by mesh name (the (2, 2) world before the (4, 1) one, which
    restores its checkpoint)."""
    tmp = tmp_path_factory.mktemp("expert_parallel")
    out = {"one": {}}
    for arch in ARCHS:
        cfg = smoke_variant(get_arch(arch))
        with open(tmp / f"init_{arch}.pkl", "wb") as f:
            pickle.dump(reference[arch]["init"], f)
        state = train_state_from_reference(reference[arch]["init"], cfg, "cpu")
        step = make_train_step(cfg, ShardingPolicy(attn_chunk=16), _tcfg())
        one = []
        for i in range(STEPS):
            batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, B, S, step=i).items()}
            state, m = step(state, batch)
            one.append((float(m["loss"]), float(m["aux"]), float(m["grad_norm"])))
        out["one"][arch] = {"metrics": one, "after": {n: p.detach() for n, p in
                                                       state.params.named_parameters()}}
    for name, (world, data) in WORLDS.items():
        out[name] = _run_world(tmp, name, world, data)
    out["tmp"] = tmp
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


CASES = [(a, m) for a in ARCHS for m in WORLDS]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_train_cell_equals_one_process_and_the_reference(reference, runs, arch, mesh):
    ref, one = reference[arch]["metrics"], runs["one"][arch]["metrics"]
    for got in (r[arch]["metrics"] for r in runs[mesh]):  # every data rank logs the same
        for i, (g, o, r) in enumerate(zip(got, one, ref)):
            assert all(_rel(a, b) <= RTOL for a, b in zip(g, o)), (i, g, o)  # loss, aux, norm
            assert _rel(g[0], r[0]) <= RTOL and _rel(g[1], r[1]) <= RTOL, (i, g, r)
            assert _rel(g[2], r[2]) <= (RTOL if i == 0 else 1e-4), (i, g, r)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_train_cell_parameters_within_the_reference_bar(reference, runs, arch, mesh):
    got = leaves_to_reference(runs[mesh][0][arch]["after"])
    _within_c18(got, reference[arch]["after"])
    _within_c18(got, leaves_to_reference(runs["one"][arch]["after"]))  # and one process's


@pytest.mark.parametrize("arch,mesh", [(a, m) for a in ARCHS for m in ("2x2", "4x1")])
def test_a_step_that_drops_slots_equals_the_references(reference, runs, arch, mesh):
    (r,) = reference[arch]["small_metrics"]
    (g,) = runs[mesh][0][arch]["small_metrics"]
    assert all(_rel(a, b) <= RTOL for a, b in zip(g, r)), (g, r)


def _rows(runs, mesh, arch, key, dim=0):
    """A tensor of every data rank's rows, joined in order."""
    return torch.cat([r[arch][key] for r in runs[mesh]], dim=dim).numpy()


@pytest.mark.parametrize("arch,mesh", [(a, m) for a in ARCHS for m in SERVED])
def test_prefill_cell_equals_the_reference(reference, runs, arch, mesh):
    ref = reference[arch]["serve"]
    np.testing.assert_allclose(_rows(runs, mesh, arch, "prefill_logits"), ref["prefill_logits"],
                               atol=SERVE_TOL, rtol=0)
    for n in reference[arch]["names"]:  # caches [L, B, ...]
        got = _rows(runs, mesh, arch, f"prefill_{n}", dim=1)
        np.testing.assert_allclose(got[:, :, :S], ref[f"prefill_{n}"], atol=SERVE_TOL, rtol=0)


@pytest.mark.parametrize("arch,mesh", [(a, m) for a in ARCHS for m in SERVED])
def test_decode_cell_equals_the_reference(reference, runs, arch, mesh):
    ref = reference[arch]["serve"]
    for i, want in enumerate(ref["tokens"]):
        got = torch.cat([r[arch]["tokens"][i] for r in runs[mesh]]).numpy()
        np.testing.assert_array_equal(got, want)
    for i, want in enumerate(ref["logits"]):
        got = torch.cat([r[arch]["logits"][i] for r in runs[mesh]]).numpy()
        np.testing.assert_allclose(got, want, atol=SERVE_TOL, rtol=0)
    for n in reference[arch]["names"]:
        np.testing.assert_allclose(_rows(runs, mesh, arch, n, dim=1), ref[n], atol=SERVE_TOL,
                                   rtol=0)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_each_rank_holds_its_experts_and_fsdp_gathers_none(runs, arch, mesh):
    """An expert leaf [E, D, F] / [E, F, D] is split on E over the data
    ranks and on F over 'model' (4 experts: 2 a rank on (2, x), 1 on (4,
    1)); FSDP's units hold no expert leaf, every all-gather of a step is
    one of theirs (each block's, forward and backward, the root's once),
    the model axis's gathers of activations are each smaller than an expert
    leaf, and the slots go out and back by all-to-all (2 a layer, forward,
    and again in the backward and the recomputed forward)."""
    cfg = smoke_variant(get_arch(arch))
    world, data = WORLDS[mesh]
    E, D, F = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    got = runs[mesh][0][arch]
    for name, (shape, placements) in got["expert_local"].items():
        want = (E // data, D, F // (world // data))
        assert shape == (want if name.endswith(("w_gate", "w_up")) else
                         (want[0], want[2], want[1])), (name, shape)
        assert placements == ["Shard(dim=0)", f"Shard(dim={2 if shape[1] == D else 1})"]
    assert len(got["expert_local"]) == 3 * cfg.num_layers
    assert not [n for n in got["fsdp_leaves"] if sharding.is_expert_leaf(n)]
    fsdp = [b for op, b in got["gathers"] if op.startswith("c10d.")]
    assert len(fsdp) == 2 * cfg.num_layers + 1 and set(fsdp) <= set(got["fsdp_unit_bytes"])
    leaf = E * D * F * 4  # an expert leaf whole, float32
    assert all(b < leaf for op, b in got["gathers"] if not op.startswith("c10d."))  # 'model'
    assert got["collectives"]["c10d_functional.all_to_all_single"]["count"] == \
        2 * 3 * cfg.num_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_a_2x2_checkpoint_restores_on_4x1_and_in_one_process(reference, runs, arch):
    saved = runs["2x2"][0][arch]
    restored = runs["4x1"][0][arch]
    assert restored["restored_step"] == STEPS
    for n, t in saved["after"].items():
        assert torch.equal(restored["restored"][n], t), n
        for a, b in zip(restored["restored_moments"][n], saved["moments"][n]):
            assert torch.equal(a, b), n
    cfg = smoke_variant(get_arch(arch))
    state = train_state_from_reference(reference[arch]["init"], cfg, "cpu")
    restore_checkpoint(str(runs["tmp"] / f"ckpt_{arch}"), STEPS, state, device="cpu")
    assert int(state.opt.step) == STEPS
    for n, p in state.params.named_parameters():
        assert torch.equal(p.detach(), saved["after"][n]), n
    for n, (m, v) in saved["moments"].items():
        assert torch.equal(state.opt.m[n], m) and torch.equal(state.opt.v[n], v), n


@pytest.mark.parametrize("arch", ARCHS)
def test_init_sharded_draws_the_weights_init_params_draws(runs, arch):
    assert runs["2x2"][0][arch]["init_sharded_equal"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("batch", [4, 16])
def test_an_expert_count_the_batch_ranks_do_not_divide_is_refused(arch, batch):
    cfg = smoke_variant(get_arch(arch))
    odd = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=6))
    with pytest.raises(ValueError, match=rf"num_experts.*6.*do not divide.*{batch} ranks"):
        sharding.check_model_axis(odd, ShardingPolicy(), 1, batch)
    sharding.check_model_axis(odd, ShardingPolicy(), 1, 2)  # 3 experts a rank
    sharding.check_model_axis(cfg, ShardingPolicy(), 1, 4)


def test_tp_distribute_refuses_experts_the_data_ranks_do_not_divide():
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.models import param_shapes

    cfg = smoke_variant(get_arch("deepseek-v2-lite-16b"))
    odd = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=6))
    with fake_world(4):
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(4, 1), mesh_dim_names=("data", "model"))
        with pytest.raises(ValueError, match=r"num_experts.*do not divide over batch axes of 4"):
            sharding.tp_distribute(param_shapes(odd), mesh)
        model = sharding.tp_distribute(param_shapes(cfg), mesh)  # 1 expert a rank
        assert model.blocks[0].moe.w_up.to_local().shape == (1, 64, 32)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_dense_oracle_runs_over_the_experts_ranks(reference, runs, arch):
    """moe_impl 'dense' on (2, 1): the experts split as under gshard, every
    rank's tokens through every rank's experts; its step is the
    reference's dense step."""
    (r,) = reference[arch]["dense_metrics"]
    (g,) = runs["2x1"][0][arch]["dense_metrics"]
    assert all(_rel(a, b) <= RTOL for a, b in zip(g, r)), (g, r)


@pytest.mark.parametrize("arch", ARCHS)
def test_experts_over_the_model_axis_stay_on_every_batch_rank(runs, arch):
    """expert_axis 'model' (each expert's d_ff over 'data') on (2, 1): no
    expert parallelism, every expert on every batch rank (a model axis of
    1), each expert's d_ff split over 'data' and never gathered (FSDP
    manages no expert leaf: every data rank's slots go to every rank's d_ff
    slab); the step is one process's."""
    cfg = smoke_variant(get_arch(arch))
    E, D, F = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    got = runs["2x1"][0][arch]
    (g,), o = got["model_axis_metrics"], runs["one"][arch]["metrics"][0]
    assert all(_rel(a, b) <= RTOL for a, b in zip(g, o)), (g, o)
    assert not [n for n in got["model_axis_fsdp"] if sharding.is_expert_leaf(n)]
    assert len(got["model_axis_experts"]) == 3 * cfg.num_layers
    for name, shape in got["model_axis_experts"].items():
        assert shape == ((E, D, F // 2) if name.endswith(("w_gate", "w_up")) else (E, F // 2, D))


@pytest.mark.parametrize("field,value", [("attention_impl", "cuda"), ("expert_ff_axis", "data"),
                                         ("expert_axis", "model"),
                                         ("expert_axis+expert_ff_axis", "model+data")])
def test_unported_moe_policy_values_on_a_model_axis_refuse_naming_their_roadmap_item(field,
                                                                                    value):
    """On a (2, 2) mesh: the experts over 'model' with their d_ff over
    'data' (A.18 item 7) run now, and so do the kernels (item 6) beside
    either expert layout; the experts and their d_ff over one axis ('data'
    twice, or 'model' twice) are refused naming C.20."""
    cfg = smoke_variant(get_arch("kimi-k2-1t-a32b"))
    over = dict(zip(field.split("+"), value.split("+")))
    if field == "attention_impl":
        sharding.check_model_axis(cfg, ShardingPolicy(**over), 2, 2)  # runs now
        sharding.check_model_axis(cfg, ShardingPolicy(**over, expert_axis="model",
                                                      expert_ff_axis="data"), 2, 2)
    elif len(over) == 2:
        sharding.check_model_axis(cfg, ShardingPolicy(**over), 2, 2)  # item 7 runs now
    else:
        axis = "data" if field == "expert_ff_axis" else "model"
        with pytest.raises(ValueError,
                           match=rf"{field}.*'{axis}' twice.*ROADMAP C\.20"):
            sharding.check_model_axis(cfg, ShardingPolicy(**over), 2, 2)
    sharding.check_model_axis(cfg, ShardingPolicy(**over), 1, 1)  # one card: any


def test_expert_parallelism_refuses_each_experts_d_ff_over_data_too():
    """Beside ``expert_axis="data"`` the reference's spec would name 'data'
    twice; on batch axes of 1, or with the experts over 'model', it runs."""
    cfg = smoke_variant(get_arch("deepseek-v2-lite-16b"))
    policy = ShardingPolicy(expert_ff_axis="data")
    with pytest.raises(ValueError, match=r"expert_ff_axis 'data' beside expert_axis 'data'"):
        sharding.check_model_axis(cfg, policy, 1, 2)
    sharding.check_model_axis(cfg, policy, 1, 1)
    sharding.check_model_axis(cfg, dataclasses.replace(policy, expert_axis="model"), 1, 2)
    sharding.check_model_axis(cfg, ShardingPolicy(moe_impl="dense"), 1, 2)


@pytest.mark.parametrize("whole,piece", [(1 << 30, 1 << 28), (1_000, 300)])
def test_a_deferred_leafs_rows_are_the_whole_leafs(monkeypatch, whole, piece):
    """Rows of dim 0 made alone (a rank's experts) hold the whole leaf's
    numbers, drawn whole and cut or (past ``WHOLE``) from every slab in
    turn; the generator ends where the whole draw leaves it."""
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "WHOLE", whole)
    monkeypatch.setattr(layers, "PIECE", piece)
    full = layers.Initializer(0, dtype=torch.float32, device="cpu")
    part = layers.Initializer(0, dtype=torch.float32, device="cpu")
    want, leaf = full.normal((16, 8, 20))(), part.normal((16, 8, 20))
    assert leaf.shape == (16, 8, 20)
    got = leaf(slice(5, 11))
    assert torch.equal(got, want[5:11])
    assert torch.equal(part.normal((3, 4))(), full.normal((3, 4))())
    assert part.ones((6, 2))(slice(1, 3)).shape == (2, 2)
