"""The reference's activation-layout policy values on a model axis in the
port (ROADMAP A.18, items 1-4), dense family: gloo worlds of 2 and 4
processes against one process and against the reference.

The values, as the reference's ``benchmarks/hillclimb.py`` names its
variants (:data:`VARIANTS`): ``prefill_last_logit_only`` (the prefill's
last position's logits alone, the head never making the others),
``qkv_feature_shard=False``, ``sp_activations`` (Megatron sequence
parallelism: the residual stream sequence-sharded, the sub-layers'
partial sums reduce-scattered onto it), ``shard_seq_attn=False`` (prefill
attention on each rank's heads), ``moe_impl="dense"`` (the moe family,
``test_torch_layouts_moe.py``) and ``logits_fp32=False``.  None changes a
value but the last position's cut, so every variant is held to the same
bars as the default layout.

The reference's steps (in this process, jitted, each variant under its
own policy) are the oracle: three train steps from its own initial
parameters, and its prefill (under ``prefill_last_logit_only`` its
logits' ``[:, -1:]``, as its serving cell cuts them) then three greedy
serve steps.  In separate interpreters, one world a mesh for every case
and variant (:func:`all_runs`):

- the train cell on (data 1, model 2) and on (2, 2) under each training
  variant: losses and grad norms within 1e-5 relative of one process's
  unsharded step under the same policy, and of the reference's as the
  default layout's tests hold them; parameters within C.18's bar of the
  reference's;
- the prefill and decode cells on (1, 2) (the moe family also on (2, 2))
  under each serving variant: logits and caches within 1e-5 of the
  reference's and of one process's, the greedy tokens equal.

The dense cases: llama3.2-3b's smoke variant (4 heads, 2 KV: both split
over 'model'), one with 6 heads over 3 KV heads (the q heads split, the KV
heads replicated, a rank's q heads reaching into two GQA groups) and one
with 3 heads over 1 (replicated heads, as llama3.2-3b's 24 over 16 in the
dry run).  In this process: the values still refused on a model axis
name ROADMAP A.18, ``policy_from_reference`` carries every field the port
reads, the head's input under ``prefill_last_logit_only`` is [B, 1, D],
and ``logits_fp32=False`` is held to the reference.
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
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.runtime import make_serve_step as ref_make_serve_step
from repro.runtime import make_train_state as ref_make_train_state
from repro.runtime import make_train_step as ref_make_train_step
from repro_torch.config import ShardingPolicy, TrainConfig, get_arch, smoke_variant
from repro_torch.convert import (leaves_to_reference, params_from_reference, policy_from_reference,
                                 train_state_from_reference)
from repro_torch.data import make_batch
from repro_torch.models import decode_step, forward, greedy_tokens, prefill, transformer
from repro_torch.runtime import make_train_step
from repro_torch.runtime import sharding

REPO = Path(__file__).resolve().parents[1]
B, STEPS, LR, DECODE, CHUNK = 4, 3, 1e-3, 3, 16
RTOL = 1e-5
SERVE_TOL = 1e-5
WORLDS = {"1x2": (2, 1), "2x2": (4, 2)}  # name: (world, data ranks)
# the reference's hillclimb variants of these values (benchmarks/hillclimb.py)
VARIANTS = {
    "default": {},
    "last_logit": {"prefill_last_logit_only": True},
    "noseqshard": {"shard_seq_attn": False, "qkv_feature_shard": False},
    "sp": {"sp_activations": True},
    "sp+last": {"sp_activations": True, "prefill_last_logit_only": True},
    "sp_noq": {"sp_activations": True, "qkv_feature_shard": False},
    "sp+last+bf16": {"sp_activations": True, "prefill_last_logit_only": True,
                     "logits_fp32": False},
    "noremat+sp": {"remat": "none", "sp_activations": True, "qkv_feature_shard": False},
    "dense": {"moe_impl": "dense"},
    "sp+dense": {"sp_activations": True, "moe_impl": "dense"},
}
TRAIN = ("sp", "noremat+sp", "noseqshard")
SERVE = ("last_logit", "noseqshard", "sp", "sp+last", "sp_noq", "sp+last+bf16")


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str
    fields: tuple  # (name, value) pairs replaced in its smoke variant
    seq: int
    train: tuple = TRAIN
    serve: tuple = SERVE
    serve_meshes: tuple = ("1x2",)
    dtype: str = "float32"  # the served weights'


CASES = {
    "llama3.2-3b": Case("llama3.2-3b", (), 32),
    # 6 q heads in 3 GQA groups over 2 ranks: a rank's 3 q heads reach two groups
    "llama-split-groups": Case("llama3.2-3b", (("num_heads", 6), ("num_kv_heads", 3)), 32,
                               train=("noseqshard",), serve=("noseqshard", "sp")),
    # 3 heads over 2 ranks: replicated heads
    "llama-replicated-heads": Case("llama3.2-3b", (("num_heads", 3), ("num_kv_heads", 1)), 32,
                                   train=("noseqshard",), serve=("noseqshard", "sp_noq")),
    # logits_fp32=False where it matters: bfloat16 weights, the logits left in bfloat16
    "llama-bf16": Case("llama3.2-3b", (), 32, train=(), serve=("sp+last+bf16",),
                       dtype="bfloat16"),
}


def configs(case: Case) -> tuple:
    """The reference's and the port's configuration of a case."""
    fields = dict(case.fields)
    return (dataclasses.replace(ref_smoke_variant(ref_get_arch(case.arch)), **fields),
            dataclasses.replace(smoke_variant(get_arch(case.arch)), **fields))


def policy(variant: str) -> ShardingPolicy:
    return ShardingPolicy(attn_chunk=CHUNK, **VARIANTS[variant])


def ref_policy(variant: str) -> RefPolicy:
    return RefPolicy(attn_chunk=CHUNK, **VARIANTS[variant])


def _tcfg(cls=TrainConfig):
    return cls(lr=LR, warmup_steps=0, total_steps=10)


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else
                   {prefix + k: np.asarray(v)})
    return out


def _ref_serve(params, cfg, case: Case, variant: str) -> dict:
    """The reference's prefill (its serving cell's cut under
    ``prefill_last_logit_only``) and greedy serve steps under ``variant``."""
    pol = ref_policy(variant)
    S = case.seq
    prompt = ref_make_batch(cfg, B, S, step=7)
    lg, cache, pos = ref_prefill(params, cfg, pol, jnp.asarray(prompt["tokens"]),
                                 jnp.asarray(prompt["patches"]) if "patches" in prompt else None,
                                 max_len=S + DECODE)
    if pol.prefill_last_logit_only:
        lg = lg[:, -1:]
    out = {"prefill_logits": np.asarray(lg), "prefill_cache": _flat(cache), "logits": [],
           "tokens": []}
    serve_step = jax.jit(ref_make_serve_step(cfg, pol))
    nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
    out["tokens"].append(np.asarray(nxt))
    for i in range(DECODE):
        lg, cache = serve_step(params, cache, nxt, jnp.int32(pos + i))
        nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        out["logits"].append(np.asarray(lg))
        out["tokens"].append(np.asarray(nxt))
    out["cache"] = _flat(cache)
    return out


def reference_runs(cases: dict) -> dict:
    """By case: the initial state, and by variant the reference's train
    steps (metrics, final parameters) and serving."""
    out = {}
    for name, case in cases.items():
        cfg, _ = configs(case)
        params = ref_init_params(cfg, RefPolicy(), 0, jnp.float32)
        init = jax.tree.map(np.asarray, ref_make_train_state(params, _tcfg(RefTrainConfig)))
        run = out[name] = {"init": init, "train": {}, "serve": {}}
        for v in case.train:
            state = ref_make_train_state(params, _tcfg(RefTrainConfig))
            step = jax.jit(ref_make_train_step(cfg, ref_policy(v), _tcfg(RefTrainConfig)))
            metrics = []
            for i in range(STEPS):
                batch = {k: jnp.asarray(x) for k, x in
                         ref_make_batch(cfg, B, case.seq, step=i).items()}
                state, m = step(state, batch)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            flat = jax.tree_util.tree_flatten_with_path(state.params)[0]
            run["train"][v] = {"metrics": metrics, "after": {
                "/".join(str(k.key) for k in path): np.asarray(x) for path, x in flat}}
        served = jax.tree.map(lambda x: x.astype(getattr(jnp, case.dtype)), params)
        for v in case.serve:
            run["serve"][v] = _ref_serve(served, cfg, case, v)
    return out


WORKER = r"""
import dataclasses, pickle, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch.config import ShapeConfig, ShardingPolicy, TrainConfig, get_arch, smoke_variant
from repro_torch.convert import train_state_from_reference
from repro_torch.data import make_batch
from repro_torch.launch.specs import build_cell
from repro_torch.models import extend_cache, greedy_tokens, transformer
from repro_torch.runtime import make_train_state
from repro_torch.runtime.profile import CommBytes
from repro_torch.runtime.sharding import shard_model, tp_distribute

rank, world, data, tmp = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
B, STEPS, LR, DECODE, CHUNK = 4, 3, 1e-3, 3, 16
tcfg = TrainConfig(lr=LR, warmup_steps=0, total_steps=10)
dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                        world_size=world)
mesh = init_device_mesh("cpu", (data, world // data), mesh_dim_names=("data", "model"))
mesh_name = f"{data}x{world // data}"
with open(f"{tmp}/cases.pkl", "rb") as f:
    cases, variants = pickle.load(f)

def whole(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()

def rows_all(t):
    # every data rank's rows of a whole tensor, joined in their order
    if data == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(data)]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group("data"))
    return torch.cat(parts)

def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out

heads = []
head = transformer._head
def watched(model, cfg, policy, x, fp32=True):
    heads.append(tuple(x.shape))
    return head(model, cfg, policy, x, fp32)
transformer._head = watched

d = mesh.get_local_rank("data")
rows = slice(d * B // data, (d + 1) * B // data)
outs = {}
for name, ((arch, fields, S, train, serve, serve_meshes, dtype), init) in cases.items():
    cfg = dataclasses.replace(smoke_variant(get_arch(arch)), **dict(fields))
    out = outs[name] = {"train": {}, "serve": {}}
    for v in train:  # the train cell: each data rank its rows of every global batch
        policy = ShardingPolicy(attn_chunk=CHUNK, **variants[v])
        state = train_state_from_reference(init, cfg, "cpu")
        shard_model(state.params, mesh, policy)
        state = make_train_state(state.params, tcfg)
        cell = build_cell(mesh, cfg, ShapeConfig("t", S, B, "train"), policy, tcfg,
                          torch.float32)
        metrics = []
        for i in range(STEPS):
            batch = {k: torch.from_numpy(x[rows]) for k, x in make_batch(cfg, B, S, step=i).items()}
            state, m = cell.fn(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out["train"][v] = {"metrics": metrics,
                           "after": {n: whole(p) for n, p in state.params.named_parameters()}}
        del state
    if mesh_name not in serve_meshes:
        continue
    for v in serve:  # the serving cells, each data rank its rows
        policy = ShardingPolicy(attn_chunk=CHUNK, **variants[v])
        model = train_state_from_reference(init, cfg, "cpu").params.to(getattr(torch, dtype))
        model = tp_distribute(model, mesh, policy)
        model.requires_grad_(False)
        prefill = build_cell(mesh, cfg, ShapeConfig("p", S, B, "prefill"), policy, tcfg,
                             torch.float32)
        decode = build_cell(mesh, cfg, ShapeConfig("d", S + DECODE, B, "decode"), policy, tcfg,
                            torch.float32)
        prompt = {k: torch.from_numpy(x[rows]) for k, x in make_batch(cfg, B, S, step=7).items()
                  if k != "labels"}
        heads.clear()
        comm = CommBytes()
        with comm:
            lg, cache = prefill.fn(model, prompt)
        got = {"prefill_logits": rows_all(whole(lg)), "head_inputs": list(heads),
               "prefill_collectives": {k: c["count"] for k, c in comm.counts().items()},
               "prefill_cache": {n: rows_all(whole(t).transpose(0, 1)).transpose(0, 1)
                                 for n, t in flat(cache).items()}}
        cache = extend_cache(cfg, cache, S + DECODE)
        nxt = greedy_tokens(lg[:, -1:])
        got["tokens"], got["logits"] = [rows_all(nxt)], []
        for i in range(DECODE):
            lg, cache = decode.fn(model, cache, {"tokens": nxt},
                                  torch.tensor([S + i], dtype=torch.int32))
            nxt = greedy_tokens(lg[:, -1:])
            got["logits"].append(rows_all(whole(lg)))
            got["tokens"].append(rows_all(nxt))
        got["cache"] = {n: rows_all(whole(t).transpose(0, 1)).transpose(0, 1)
                        for n, t in flat(cache).items()}
        out["serve"][v] = got
if rank == 0:
    torch.save(outs, f"{tmp}/out.pt")
dist.destroy_process_group()
"""


def run_world(tmp: Path, cases: dict, reference: dict, world: int, data: int) -> dict:
    """The worker over ``world`` processes on a (data, world / data) mesh,
    every case and variant in turn; rank 0's outputs by case."""
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(({n: (dataclasses.astuple(c), reference[n]["init"]) for n, c in cases.items()},
                     VARIANTS), f)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(data),
                               str(tmp)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, err[-3000:])
    return torch.load(tmp / "out.pt", weights_only=True)


def one_process_runs(cases: dict, reference: dict) -> dict:
    """By case and variant: one process's unsharded train steps and
    serving under the variant's policy, from the reference's initial
    state."""
    out = {}
    for name, case in cases.items():
        _, cfg = configs(case)
        init = reference[name]["init"]
        run = out[name] = {"train": {}, "serve": {}}
        for v in case.train:
            state = train_state_from_reference(init, cfg, "cpu")
            step = make_train_step(cfg, policy(v), _tcfg())
            metrics = []
            for i in range(STEPS):
                batch = {k: torch.from_numpy(x) for k, x in
                         make_batch(cfg, B, case.seq, step=i).items()}
                state, m = step(state, batch)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            run["train"][v] = metrics
        for v in case.serve:
            model = train_state_from_reference(init, cfg, "cpu").params.to(
                getattr(torch, case.dtype)).requires_grad_(False)
            prompt = make_batch(cfg, B, case.seq, step=7)
            lg, cache, pos = prefill(model, cfg, policy(v), torch.from_numpy(prompt["tokens"]),
                                     torch.from_numpy(prompt["patches"]) if "patches" in prompt
                                     else None, max_len=case.seq + DECODE)
            got = {"prefill_logits": lg, "logits": []}
            nxt = greedy_tokens(lg[:, -1:])
            for i in range(DECODE):
                lg, cache = decode_step(model, cfg, policy(v), cache, nxt, pos + i)
                nxt = greedy_tokens(lg[:, -1:])
                got["logits"].append(lg)
            run["serve"][v] = got
    return out


def all_runs(cases: dict, reference: dict, tmp_path_factory) -> dict:
    """One process's runs, then one world a mesh: by case, then ``"one"``
    or the mesh's name."""
    one = one_process_runs(cases, reference)
    out = {name: {"one": one[name]} for name in cases}
    for mesh, (world, data) in WORLDS.items():
        got = run_world(tmp_path_factory.mktemp(f"layouts{mesh}"), cases, reference, world, data)
        for name in cases:
            out[name][mesh] = got[name]
    return out


def within_c18(got: dict, want: dict) -> None:
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


def train_params(cases: dict) -> list:
    return [(c, v, m) for c, case in cases.items() for v in case.train for m in WORLDS]


def serve_params(cases: dict) -> list:
    """The float32 cases' serving (the bfloat16 one has its own test)."""
    return [(c, v, m) for c, case in cases.items() if case.dtype == "float32"
            for v in case.serve for m in case.serve_meshes]


def check_train(ref: dict, run: dict, variant: str, mesh: str) -> None:
    """Losses and grad norms within 1e-5 relative of one process's under
    the same policy, and of the reference's as the default layout's tests
    hold them; the parameters within C.18's bar of the reference's."""
    got, one, want = (run[mesh]["train"][variant]["metrics"], run["one"]["train"][variant],
                      ref["train"][variant]["metrics"])
    for (l2, g2), (l1, g1), (lr, gr) in zip(got, one, want):
        assert abs(l2 - l1) <= RTOL * abs(l1) and abs(g2 - g1) <= RTOL * abs(g1)
        assert abs(l2 - lr) < 2e-4 and abs(g2 - gr) <= 1e-4 * gr
    within_c18(leaves_to_reference(run[mesh]["train"][variant]["after"]),
               ref["train"][variant]["after"])


def _cache_leaf(ref: np.ndarray, got: torch.Tensor) -> np.ndarray:
    """The reference's cache leaf cut to the port's entries (a prefill cell
    holds the prompt's; the reference's holds room for the decode steps)."""
    return ref[tuple(slice(0, n) for n in got.shape)]


def check_serve(ref: dict, run: dict, variant: str, mesh: str) -> None:
    """The prefill's logits and cache, each decode step's logits and the
    final cache within 1e-5 of the reference's and the logits of one
    process's; the greedy tokens equal."""
    ref, got, one = ref["serve"][variant], run[mesh]["serve"][variant], run["one"]["serve"][variant]
    for a, b in zip([got["prefill_logits"], *got["logits"]],
                    [ref["prefill_logits"], *ref["logits"]]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.float().numpy(), b.astype(np.float32), atol=SERVE_TOL,
                                   rtol=0)
    for a, b in zip([got["prefill_logits"], *got["logits"]],
                    [one["prefill_logits"], *one["logits"]]):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=SERVE_TOL, rtol=0)
    for a, b in zip(got["tokens"], ref["tokens"]):
        np.testing.assert_array_equal(a.numpy(), b)
    assert set(got["prefill_cache"]) == set(ref["prefill_cache"]) == set(got["cache"])
    for n, t in got["prefill_cache"].items():
        np.testing.assert_allclose(t.numpy(), _cache_leaf(ref["prefill_cache"][n], t),
                                   atol=SERVE_TOL, rtol=0, err_msg=n)
    for n, t in got["cache"].items():
        np.testing.assert_allclose(t.numpy(), ref["cache"][n], atol=SERVE_TOL, rtol=0, err_msg=n)


@pytest.fixture(scope="module")
def reference():
    return reference_runs(CASES)


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    return all_runs(CASES, reference, tmp_path_factory)


@pytest.mark.parametrize("case,variant,mesh", train_params(CASES))
def test_train_cell_under_the_layout_equals_one_process_and_the_reference(reference, runs, case,
                                                                          variant, mesh):
    check_train(reference[case], runs[case], variant, mesh)


@pytest.mark.parametrize("case,variant,mesh", serve_params(CASES))
def test_serving_cells_under_the_layout_equal_one_process_and_the_reference(reference, runs,
                                                                            case, variant, mesh):
    check_serve(reference[case], runs[case], variant, mesh)


def test_sequence_parallelism_reduce_scatters_the_sub_layers_outputs(runs):
    """A prefill on (1, 2): by default the embedding's and each block's two
    partial sums are all-reduced onto the replicated stream; under
    ``sp_activations`` each is reduce-scattered onto the sequence-sharded
    stream and nothing is all-reduced."""
    _, cfg = configs(CASES["llama3.2-3b"])
    sums = 1 + 2 * cfg.num_layers
    sp = runs["llama3.2-3b"]["1x2"]["serve"]["sp"]["prefill_collectives"]
    assert sp.get("c10d_functional.reduce_scatter_tensor") == sums
    assert "c10d_functional.all_reduce" not in sp
    assert runs["llama3.2-3b"]["1x2"]["serve"]["noseqshard"]["prefill_collectives"][
        "c10d_functional.all_reduce"] == sums


@pytest.mark.parametrize("variant", ["last_logit", "sp+last", "sp+last+bf16"])
def test_the_head_reads_the_last_position_alone_on_the_mesh(runs, variant):
    """Under ``prefill_last_logit_only`` the head's input is [B, 1, D] on a
    model axis too (a sequence-sharded stream's last row from its rank), so
    the [B, S, V] logits are never made."""
    _, cfg = configs(CASES["llama3.2-3b"])
    got = runs["llama3.2-3b"]["1x2"]["serve"][variant]
    assert got["head_inputs"] == [(B, 1, cfg.d_model)]
    assert tuple(got["prefill_logits"].shape) == (B, 1, cfg.vocab_size)


def test_the_head_reads_the_last_position_alone_on_one_process(monkeypatch):
    """One process: the head's input [B, 1, D], the logits the whole
    prefill's last row."""
    cfg = smoke_variant(get_arch("llama3.2-3b"))
    model = transformer.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    tokens = torch.from_numpy(make_batch(cfg, B, 32, step=7)["tokens"])
    seen = []
    head = transformer._head

    def watched(model, cfg, policy, x, fp32=True):
        seen.append(tuple(x.shape))
        return head(model, cfg, policy, x, fp32)

    monkeypatch.setattr(transformer, "_head", watched)
    last, _, _ = prefill(model, cfg, policy("last_logit"), tokens)
    full, _, _ = prefill(model, cfg, policy("default"), tokens)
    assert seen == [(B, 1, cfg.d_model), (B, 32, cfg.d_model)]
    torch.testing.assert_close(last, full[:, -1:], rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "musicgen-medium"])
def test_logits_fp32_false_equals_the_reference_on_one_process(arch):
    """``logits_fp32=False`` in bfloat16: the head's logits stay in the
    weights' dtype (audio's a codebook each), as the reference's."""
    cfg, port_cfg = (ref_smoke_variant(ref_get_arch(arch)), smoke_variant(get_arch(arch)))
    params = ref_init_params(cfg, RefPolicy(), 0, jnp.bfloat16)
    batch = ref_make_batch(cfg, B, 32, step=2)
    want, _, _ = ref_forward(params, cfg, RefPolicy(logits_fp32=False),
                             jnp.asarray(batch["tokens"]))
    model = params_from_reference(params, port_cfg, "cpu")
    got, _, _ = forward(model, port_cfg, ShardingPolicy(logits_fp32=False),
                        torch.from_numpy(batch["tokens"]))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_logits_fp32_false_on_the_model_axis_equals_the_reference(reference, runs):
    """``sp+last+bf16`` on (1, 2) with bfloat16 weights: the last
    position's logits stay bfloat16 (vocabulary-sharded, then gathered)
    and equal the reference's under the same policy, and one process's,
    within bfloat16's rounding through two layers (4e-2 of max |value| of
    the reference's, 2e-2 of one process's)."""
    got = runs["llama-bf16"]["1x2"]["serve"]["sp+last+bf16"]["prefill_logits"]
    one = runs["llama-bf16"]["one"]["serve"]["sp+last+bf16"]["prefill_logits"]
    want = reference["llama-bf16"]["serve"]["sp+last+bf16"]["prefill_logits"]
    assert got.dtype == one.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert tuple(got.shape) == want.shape == (B, 1, configs(CASES["llama-bf16"])[1].vocab_size)
    want = want.astype(np.float32)
    tol = 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 * tol)
    np.testing.assert_allclose(got.float().numpy(), one.float().numpy(), rtol=0, atol=tol)


def test_policy_from_reference_carries_every_field_the_port_reads():
    """Each field the two policies share, the new ones included, set away
    from its default on the reference's side, arrives on the port's."""
    changed = dict(remat="none", attention_impl="naive", attn_chunk=64, attn_block_skip=True,
                   logits_fp32=False, kv_cache_dtype="int8", moe_impl="dense", model_axis="tp",
                   fsdp_params=False, expert_axis="model", expert_ff_axis="data",
                   shard_seq_attn=False, qkv_feature_shard=False, prefill_last_logit_only=True,
                   sp_activations=True)
    shared = {f.name for f in dataclasses.fields(ShardingPolicy)} & {
        f.name for f in dataclasses.fields(RefPolicy)}
    assert shared == set(changed)
    got = policy_from_reference(RefPolicy(**changed))
    assert {k: getattr(got, k) for k in changed} == changed
    assert {"qkv_feature_shard", "prefill_last_logit_only"} <= shared


@pytest.mark.parametrize("over,field", [
    ({"sp_activations": True, "kv_cache_dtype": "int8"}, "kv_cache_dtype"),
    ({"shard_seq_attn": False, "attention_impl": "cuda"}, "attention_impl"),
    ({"prefill_last_logit_only": True, "qkv_feature_shard": False, "kv_cache_dtype": "int8"},
     "kv_cache_dtype"),
    ({"sp_activations": True, "expert_axis": "model", "expert_ff_axis": "data"}, "expert_axis"),
])
def test_a_ported_layout_beside_a_value_still_refused_names_the_refused_one(over, field):
    """The ported layouts run on a model axis, and beside them the int8
    cache, the kernels and the experts over 'model' (``field``: A.18's
    items 5-7; a dense model has no experts to place) now too; beside them
    all the one value still refused (a model axis not named 'model') is
    refused by name alone."""
    _, cfg = configs(CASES["llama3.2-3b"])
    sharding.check_model_axis(cfg, ShardingPolicy(**over), 2)  # runs now
    with pytest.raises(ValueError, match=r"\{'model_axis'.*ROADMAP A\.18") as err:
        sharding.check_model_axis(cfg, ShardingPolicy(**over, model_axis="tp"), 2)
    assert not set(over) & set(str(err.value).split("'"))
    sharding.check_model_axis(cfg, ShardingPolicy(**{k: v for k, v in over.items()
                                                     if k != field}), 2)
