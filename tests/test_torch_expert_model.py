"""The experts over the model axis in the port (the reference's
``expert_model``: ``expert_axis="model"``, ``expert_ff_axis="data"``; E
over 'model', each expert's d_ff over 'data') on the CPU: gloo worlds of 2
and 4 processes against one process and against the reference.

The reference's steps (in this process, jitted, unsharded) are the oracle,
for the smoke variants of deepseek-v2-lite-16b (MLA, 4 experts top-2 plus a
shared one) and kimi-k2-1t-a32b (GQA, the same experts): three train steps
from its own initial parameters (the aux loss read at each step's
parameters), a step at a capacity that drops slots (cf 0.5) and one MoE
layer there on a whole batch, a step of the dense oracle, and its prefill
of a 4 x 32 prompt then four greedy serve steps.  The parameters are
carried into the port (``params_from_reference``); the same batches go
through the port's cells (``launch/specs.build_cell``) under the policy in
one gloo world a mesh, (data 1, model 2), (1, 4), (2, 2) and (2, 1), each
running both models, in separate interpreters joined through a ``file://``
rendezvous under ``tmp_path``, each data rank its rows:

- the train cell: losses and aux losses within 1e-6 relative of one
  process's unsharded step and of the reference's at every step, grad
  norms at the first (after it Adam turns rounding into lr-sized moves,
  C.18: the grad norms are held to 1e-4 there; on (1, 4) kimi's second
  grad norm is 1.008e-6 from one process's under the default layout too,
  two elements having moved by such steps); parameters within C.18's bar;
- at cf 0.5 the step equals the reference's, and the MoE layer on each data
  rank's rows gives the reference's output on the whole batch (the same
  slots dropped); the dense oracle's step equals the reference's;
- the prefill and decode cells: logits and caches within 1e-5 of the
  reference's, greedy tokens equal;
- each rank holds exactly its [E / M, D, F / D_data] slabs, FSDP manages no
  expert leaf, and in a step under ``CommDebugMode`` every all-gather is
  one of FSDP's units without them or an activation's smaller than an
  expert leaf; the slots are gathered and returned once a layer each way
  on a data axis wider than 1, never on one of 1;
- a model drawn sharded equals the one drawn whole;
- a (2, 2) checkpoint restores leaf for leaf in one process and under the
  default layout on (2, 2).

In this process: ``check_model_axis`` accepts the pair for both
configurations on model axes of 2, 4 and 16 and refuses by name a model
axis not named 'model' (A.18), the experts and their d_ff over one axis
(C.20) and widths that do not divide; the dry run records a decode cell's
collectives with the gathers and returns apart; and, in a child process
with four fake XLA devices, the reference's own ``moe_ffn`` under the pair
refuses its shared experts' spec and lowers without them (C.21).
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
from repro.models.moe import _router as ref_router
from repro.models.moe import moe_ffn as ref_moe_ffn
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
PAIR = {"expert_axis": "model", "expert_ff_axis": "data"}
WORLDS = {"1x2": (2, 1), "1x4": (4, 1), "2x2": (4, 2), "2x1": (2, 2)}  # (world, data ranks)
CASES = [(a, m) for a in ARCHS for m in WORLDS]


def _tcfg(cls=TrainConfig):
    return cls(lr=LR, warmup_steps=0, total_steps=10)


def _with_cf(cfg, cf):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _moe_input(cfg):
    return np.random.default_rng(5).standard_normal((B, S, cfg.d_model)).astype(np.float32)


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
    the small capacity and its first MoE layer there on a whole batch (with
    the slots it drops), its dense step, and its prefill + greedy serve
    steps; all unsharded."""
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
        dense_metrics, _ = _ref_train(cfg, ref_make_train_state(params, _tcfg(RefTrainConfig)), 1,
                                      RefPolicy(attn_chunk=16, moe_impl="dense"))
        moe0 = jax.tree.map(lambda t: t[0], params["blocks"]["moe"])
        x = jnp.asarray(_moe_input(cfg))
        moe_y = np.asarray(ref_moe_ffn(moe0, x, small)[0])
        flat = np.asarray(ref_router(moe0, x.reshape(-1, cfg.d_model), small.moe)[1]).reshape(-1)
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
                     "small_metrics": small_metrics, "dense_metrics": dense_metrics,
                     "moe_y": moe_y, "dropped": int((pos >= cap).sum()), "names": names}
    return out


WORKER = r"""
import dataclasses, pickle, sys
import numpy as np
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.config import ShapeConfig, ShardingPolicy, TrainConfig, get_arch, smoke_variant
from repro_torch.convert import train_state_from_reference
from repro_torch.data import make_batch
from repro_torch.launch.specs import build_cell
from repro_torch.models import activate_mesh, extend_cache, greedy_tokens, init_params
from repro_torch.models.moe import exchange_tally, moe_ffn
from repro_torch.runtime import make_train_state
from repro_torch.runtime.profile import CommBytes
from repro_torch.runtime.sharding import init_sharded, is_expert_leaf, shard_model, tp_distribute

rank, world, data, tmp, name = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                                sys.argv[5])
policy = ShardingPolicy(attn_chunk=16, expert_axis="model", expert_ff_axis="data")
B, S, STEPS, LR, DECODE, SMALL_CF = 4, 32, 3, 1e-3, 4, 0.5
tcfg = TrainConfig(lr=LR, warmup_steps=0, total_steps=10)
dist.init_process_group("gloo", init_method=f"file://{tmp}/{name}/rendezvous", rank=rank,
                        world_size=world)
mesh = init_device_mesh("cpu", (data, world // data), mesh_dim_names=("data", "model"))
d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
rows = slice(d * B // data, (d + 1) * B // data)


def whole(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()


class Gathers(CommBytes):
    # each all-gather's (op, bytes), in order: FSDP's (c10d) and DTensor's; and
    # the all-gathers whose input is one of the watched tensors' storage
    def __init__(self, watched):
        super().__init__()
        self.each, self.watched, self.of_watched = [], watched, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = dict(self.bytes)
        first = args[0] if args else None
        if "gather" in str(func) and isinstance(first, torch.Tensor):
            self.of_watched += first.untyped_storage().data_ptr() in self.watched
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
                    data * sum(fp.padded_sharded_param_size.numel()
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
        state, mt = cell.fn(state, batch)
        metrics.append((float(mt["loss"]), float(mt["aux"]), float(mt["grad_norm"])))
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
    batch = {k: torch.from_numpy(v[rows]) for k, v in make_batch(cfg, B, S, step=STEPS).items()}
    comm = Gathers({p.to_local().untyped_storage().data_ptr()
                    for n, p in state.params.named_parameters() if is_expert_leaf(n)})
    with comm, exchange_tally() as tally:
        cell.fn(state, batch)
    got["gathers"], got["collectives"], got["exchanges"] = comm.each, comm.counts(), tally
    got["expert_leaf_gathers"] = comm.of_watched
    if name == "2x2":  # restored in one process and under the default layout here
        ckpt = f"{tmp}/ckpt_{arch}"
        save_checkpoint(ckpt, STEPS + 1, state)
        got["saved"] = {n: whole(p) for n, p in state.params.named_parameters()}
        got["moments"] = {n: (whole(state.opt.m[n]), whole(state.opt.v[n])) for n in state.opt.m}
        fresh = train_state_from_reference(init, cfg, "cpu")
        shard_model(fresh.params, mesh, ShardingPolicy(attn_chunk=16))
        fresh = make_train_state(fresh.params, tcfg)
        restore_checkpoint(ckpt, STEPS + 1, fresh, device="cpu")
        got["default_experts"] = [tuple(p.to_local().shape) for n, p in
                                  fresh.params.named_parameters() if is_expert_leaf(n)]
        got["restored"] = {n: whole(p) for n, p in fresh.params.named_parameters()}
        got["restored_moments"] = {n: (whole(fresh.opt.m[n]), whole(fresh.opt.v[n]))
                                   for n in fresh.opt.m}
        got["restored_step"] = int(fresh.opt.step)
        del fresh
    del state, cell
    small = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=SMALL_CF))
    got["small_metrics"] = train(small, init, 1)[2]
    got["dense_metrics"] = train(cfg, init, 1, dataclasses.replace(policy, moe_impl="dense"))[2]
    model = tp_distribute(train_state_from_reference(init, cfg, "cpu").params, mesh,
                          policy).requires_grad_(False)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((B, S, cfg.d_model))
                         .astype(np.float32))[rows]
    if world // data > 1:
        x = DTensor.from_local(x, mesh["model"], [Replicate()])
    with activate_mesh(mesh), torch.no_grad():
        y, _ = moe_ffn(model.blocks[0].moe, x, small, expert_axis="model", ff_axis="data")
    got["moe_y"] = whole(y)
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
    del model
    drawn = init_sharded(cfg, mesh, seed=4, dtype=torch.float32, device="cpu", policy=policy)
    ref = init_params(cfg, seed=4, dtype=torch.float32, device="cpu")
    got["init_sharded_equal"] = all(
        torch.equal(whole(p), q) for (_, p), (_, q) in zip(drawn.named_parameters(),
                                                             ref.named_parameters()))
out["data_rank"], out["model_rank"] = d, m
torch.save(out, f"{tmp}/{name}/out_{rank}.pt")
dist.destroy_process_group()
"""


def _start_world(tmp: Path, name: str, world: int, data: int) -> list:
    """The world's ranks, started."""
    (tmp / name).mkdir()
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(data),
                              str(tmp), name], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True) for r in range(world)]


def _end_world(tmp: Path, name: str, procs: list) -> list:
    """The world's ranks' outputs, in the order of the ranks (data major)."""
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (name, r, err[-3000:])
    return [torch.load(tmp / name / f"out_{r}.pt", weights_only=True) for r in range(len(procs))]


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    """One process's unsharded steps by arch, then every rank's outputs of
    each world by mesh name."""
    tmp = tmp_path_factory.mktemp("expert_model")
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
    names = list(WORLDS)
    for pair in (names[:2], names[2:]):  # two worlds at a time, six ranks
        procs = {name: _start_world(tmp, name, *WORLDS[name]) for name in pair}
        out.update({name: _end_world(tmp, name, p) for name, p in procs.items()})
    out["tmp"] = tmp
    return out


def _data_ranks(runs, mesh) -> list:
    """Each data rank's output once (its model rank 0's), in order."""
    return [r for r in runs[mesh] if r["model_rank"] == 0]


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


def _rows(runs, mesh, arch, key, dim=0):
    """A tensor of every data rank's rows, joined in order."""
    return torch.cat([r[arch][key] for r in _data_ranks(runs, mesh)], dim=dim).numpy()


@pytest.mark.parametrize("arch,mesh", CASES)
def test_train_cell_equals_one_process_and_the_reference(reference, runs, arch, mesh):
    ref, one = reference[arch]["metrics"], runs["one"][arch]["metrics"]
    for got in (r[arch]["metrics"] for r in runs[mesh]):  # every rank logs the same
        for i, (g, o, r) in enumerate(zip(got, one, ref)):
            for want in (o, r):  # loss, aux, grad norm
                assert _rel(g[0], want[0]) <= RTOL and _rel(g[1], want[1]) <= RTOL, (i, g, want)
                assert _rel(g[2], want[2]) <= (RTOL if i == 0 else 1e-4), (i, g, want)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_train_cell_parameters_within_the_reference_bar(reference, runs, arch, mesh):
    got = leaves_to_reference(runs[mesh][0][arch]["after"])
    _within_c18(got, reference[arch]["after"])
    _within_c18(got, leaves_to_reference(runs["one"][arch]["after"]))  # and one process's


@pytest.mark.parametrize("arch,mesh", CASES)
def test_the_slots_dropped_and_the_step_at_a_small_capacity_are_the_references(reference, runs,
                                                                               arch, mesh):
    """At cf 0.5 the reference drops slots of the 128-token batch; the MoE
    layer on each data rank's rows gives its output on the whole batch (the
    same slots dropped over the global batch), and the step equals its."""
    ref = reference[arch]
    assert ref["dropped"] > 0
    np.testing.assert_allclose(_rows(runs, mesh, arch, "moe_y"), ref["moe_y"], atol=1e-5, rtol=0)
    (g,), (r,) = runs[mesh][0][arch]["small_metrics"], ref["small_metrics"]
    assert all(_rel(a, b) <= RTOL for a, b in zip(g, r)), (g, r)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_the_dense_oracle_equals_the_references_dense_step(reference, runs, arch, mesh):
    (r,) = reference[arch]["dense_metrics"]
    (g,) = runs[mesh][0][arch]["dense_metrics"]
    assert all(_rel(a, b) <= RTOL for a, b in zip(g, r)), (g, r)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_prefill_cell_equals_the_reference(reference, runs, arch, mesh):
    ref = reference[arch]["serve"]
    np.testing.assert_allclose(_rows(runs, mesh, arch, "prefill_logits"), ref["prefill_logits"],
                               atol=SERVE_TOL, rtol=0)
    for n in reference[arch]["names"]:  # caches [L, B, ...]
        got = _rows(runs, mesh, arch, f"prefill_{n}", dim=1)
        np.testing.assert_allclose(got[:, :, :S], ref[f"prefill_{n}"], atol=SERVE_TOL, rtol=0)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_decode_cell_equals_the_reference(reference, runs, arch, mesh):
    ref = reference[arch]["serve"]
    for i, want in enumerate(ref["tokens"]):
        got = torch.cat([r[arch]["tokens"][i] for r in _data_ranks(runs, mesh)]).numpy()
        np.testing.assert_array_equal(got, want)
    for i, want in enumerate(ref["logits"]):
        got = torch.cat([r[arch]["logits"][i] for r in _data_ranks(runs, mesh)]).numpy()
        np.testing.assert_allclose(got, want, atol=SERVE_TOL, rtol=0)
    for n in reference[arch]["names"]:
        np.testing.assert_allclose(_rows(runs, mesh, arch, n, dim=1), ref[n], atol=SERVE_TOL,
                                   rtol=0)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_each_rank_holds_its_slabs_and_fsdp_gathers_none(runs, arch, mesh):
    """An expert leaf [E, D, F] / [E, F, D] lies on E over 'model' and on F
    over 'data' (4 experts of d_ff 32: [4 / M, 64, 32 / D_data] a rank);
    FSDP's units hold no expert leaf, no all-gather of a step reads an
    expert leaf's storage, and with 2 or more data ranks (FSDP's gathers
    then run) every all-gather is one of FSDP's units' or an activation's
    smaller than an expert leaf; the slots go out and back once a layer
    each way, in the forward and again in the recomputed forward, with one
    reverse exchange of each in the backward, where the data axis is wider
    than 1 (none where it is 1)."""
    cfg = smoke_variant(get_arch(arch))
    world, data = WORLDS[mesh]
    E, D, F, L = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert, cfg.num_layers
    want = (E // (world // data), D, F // data)
    for rank in runs[mesh]:
        got = rank[arch]
        assert len(got["expert_local"]) == 3 * L
        for name, (shape, placements) in got["expert_local"].items():
            up = name.endswith(("w_gate", "w_up"))
            assert shape == (want if up else (want[0], want[2], want[1])), (name, shape)
            assert placements == [f"Shard(dim={2 if up else 1})", "Shard(dim=0)"], placements
        assert not [n for n in got["fsdp_leaves"] if sharding.is_expert_leaf(n)]
        fsdp = [b for op, b in got["gathers"] if op.startswith("c10d.")]  # none on 1 data rank
        assert len(fsdp) == (2 * L + 1 if data > 1 else 0)
        assert set(fsdp) <= set(got["fsdp_unit_bytes"])
        assert got["expert_leaf_gathers"] == 0
        leaf = E * D * F * 4  # an expert leaf whole, float32
        assert data == 1 or all(b < leaf for op, b in got["gathers"]
                                if not op.startswith("c10d."))
        exchanges = {k: v["count"] for k, v in got["exchanges"].items()}
        assert exchanges == ({"gather": 2 * L, "return": 2 * L, "gather backward": L,
                              "return backward": L} if data > 1 else {}), exchanges
        a2a = got["collectives"].get("c10d_functional.all_to_all_single", {"count": 0})
        assert a2a["count"] == sum(exchanges.values())


@pytest.mark.parametrize("arch,mesh", CASES)
def test_init_sharded_draws_the_weights_init_params_draws(runs, arch, mesh):
    assert all(r[arch]["init_sharded_equal"] for r in runs[mesh])


@pytest.mark.parametrize("arch", ARCHS)
def test_a_2x2_checkpoint_restores_in_one_process_and_under_the_default_layout(reference, runs,
                                                                             arch):
    saved = runs["2x2"][0][arch]
    cfg = smoke_variant(get_arch(arch))
    E, F = cfg.moe.num_experts, cfg.moe.d_ff_expert
    assert saved["restored_step"] == STEPS + 1
    assert saved["default_experts"][0] == (E // 2, cfg.d_model, F // 2)  # the other layout
    for n, t in saved["saved"].items():
        assert torch.equal(saved["restored"][n], t), n
        for a, b in zip(saved["restored_moments"][n], saved["moments"][n]):
            assert torch.equal(a, b), n
    state = train_state_from_reference(reference[arch]["init"], cfg, "cpu")
    restore_checkpoint(str(runs["tmp"] / f"ckpt_{arch}"), STEPS + 1, state, device="cpu")
    assert int(state.opt.step) == STEPS + 1
    for n, p in state.params.named_parameters():
        assert torch.equal(p.detach(), saved["saved"][n]), n
    for n, (m, v) in saved["moments"].items():
        assert torch.equal(state.opt.m[n], m) and torch.equal(state.opt.v[n], v), n


@pytest.mark.parametrize("width", [2, 4, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_check_model_axis_accepts_the_pair_at_full_width(arch, width):
    cfg = get_arch(arch)
    for batch in (1, 2, 16):
        sharding.check_model_axis(cfg, ShardingPolicy(**PAIR), width, batch)


@pytest.mark.parametrize("over,match", [
    ({"model_axis": "tp"}, r"\{'model_axis': 'tp'\}.*ROADMAP A\.18"),
    ({"expert_axis": "data", "expert_ff_axis": "data"},
     r"expert_ff_axis 'data' beside expert_axis 'data'.*ROADMAP C\.20"),
    ({"expert_axis": "model", "expert_ff_axis": "model"},
     r"expert_ff_axis 'model' beside expert_axis 'model'.*ROADMAP C\.20"),
])
@pytest.mark.parametrize("width,batch", [(2, 1), (1, 2), (2, 2)])
def test_check_model_axis_refuses_by_name(over, match, width, batch):
    cfg = get_arch("kimi-k2-1t-a32b")
    if "model_axis" in over and width == 1:
        sharding.check_model_axis(cfg, ShardingPolicy(**PAIR, **over), width, batch)  # no axis
        return
    with pytest.raises(ValueError, match=match):
        sharding.check_model_axis(cfg, ShardingPolicy(**{**PAIR, **over}), width, batch)
    sharding.check_model_axis(cfg, ShardingPolicy(**{**PAIR, **over}), 1, 1)  # one card: any


@pytest.mark.parametrize("over,width,data,match", [
    ({"num_experts": 6}, 4, 1, r"\{'num_experts': 6\} do not divide over the experts' model axis "
                               r"of 4"),
    ({"d_ff_expert": 1400}, 2, 16, r"\{'d_ff_expert': 1400\} do not divide.*data axis of 16"),
    ({"d_ff_expert": 1400, "num_shared": 1}, 16, 8,
     r"\{'d_ff_shared': 1400\} do not divide over a model axis of 16"),
])
def test_widths_the_pair_does_not_divide_are_refused(over, width, data, match):
    """The experts over the model axis, each expert's d_ff over the data
    axis (not the pods), and the shared experts' d_ff over the model axis;
    an expert d_ff the model axis does not divide runs (it is not split
    there)."""
    cfg = get_arch("deepseek-v2-lite-16b")
    odd = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **over))
    with pytest.raises(ValueError, match=match):
        sharding.check_model_axis(odd, ShardingPolicy(**PAIR), width, data)
    if over == {"d_ff_expert": 1400}:  # over 8 data ranks (two pods of them: 16), not 16
        sharding.check_model_axis(odd, ShardingPolicy(**PAIR), 16, 16, data=8)
        with pytest.raises(ValueError, match=r"d_ff_expert.*do not divide over a model axis"):
            sharding.check_model_axis(odd, ShardingPolicy(), 16, 1)  # the default splits it


def test_the_dry_run_records_the_gathers_and_returns_apart():
    """deepseek-v2-lite-16b's decode cell on the single-pod production mesh
    (16 x 16, a fake world) under the pair: its step runs on the meta
    device, and its collectives count a gather and a return a MoE layer
    (balanced routing's sizes) among the all-to-alls."""
    from repro_torch.launch.dryrun import fake_world, run_cell

    with fake_world(256):
        rec = run_cell("deepseek-v2-lite-16b", "decode_32k", False, ShardingPolicy(**PAIR),
                       verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    moe_layers = get_arch("deepseek-v2-lite-16b").num_layers  # every block has experts
    ex = rec["expert_exchanges"]
    assert set(ex) == {"gather", "return"}
    assert ex["gather"]["count"] == ex["return"]["count"] == moe_layers
    assert rec["collectives"]["c10d_functional.all_to_all_single"]["count"] == 2 * moe_layers
    assert ex["gather"]["bytes"] > 0 and ex["return"]["bytes"] > 0


C21 = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.config import get_arch, smoke_variant
from repro.models import init_params
from repro.models.layers import activate_mesh
from repro.models.moe import moe_ffn
from repro.config import ShardingPolicy
import dataclasses

cfg = smoke_variant(get_arch("deepseek-v2-lite-16b"))
params = init_params(cfg, ShardingPolicy(), 0, jnp.float32)
moe0 = jax.tree.map(lambda t: t[0], params["blocks"]["moe"])
x = jnp.asarray(np.random.default_rng(5).standard_normal((4, 32, cfg.d_model)), jnp.float32)
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
run = jax.jit(lambda p, x, c: moe_ffn(p, x, c, expert_axis="model", ff_axis="data")[0],
              static_argnums=2)
try:
    with activate_mesh(mesh):
        run(moe0, x, cfg)
    print("SHARED lowered")
except Exception as e:
    print("SHARED", type(e).__name__)
routed = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_shared=0))
p0 = {k: v for k, v in moe0.items() if k != "shared"}
with activate_mesh(mesh):
    got = np.asarray(run(p0, x, routed))
want = np.asarray(moe_ffn(p0, x, routed)[0])
print("ROUTED", float(np.abs(got - want).max()))
"""


def test_the_references_expert_model_refuses_its_shared_experts_spec():
    """ROADMAP C.21: on a 2 x 2 mesh of fake CPU devices (a child process:
    the device count is fixed at JAX's start) the reference's ``moe_ffn``
    under ``expert_axis="model"``, ``ff_axis="data"`` raises JAX's
    ``DuplicateSpecError`` at its shared experts' constraint (('pod',
    'data') beside ``ff_axis``), and without shared experts lowers and
    equals the unsharded call within 1e-6."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", C21], env=env, capture_output=True, text=True,
                         timeout=60)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in res.stdout.split("\n") if line)
    assert lines["SHARED"] == "DuplicateSpecError", lines
    assert float(lines["ROUTED"]) <= 1e-6, lines
