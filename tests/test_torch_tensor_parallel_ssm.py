"""The model axis for the ssm and hybrid families in the port (the Mamba
mixer's d_inner, conv channels and heads over 'model'; hymba's sliding
window on the sequence-sharded rows and ring cache) on the CPU: gloo
worlds of 2 and 4 processes against one process and against the
reference.

The reference's steps (in this process, jitted) are the oracle, for the
smoke variants of mamba2-2.7b (8 SSM heads), hymba-1.5b (8 SSM heads
beside 4 attention heads, a window of 32) and a hymba-shaped variant built
the same way for both packages whose 5 SSM heads do not divide the model
axis and whose vocabulary (250) has pad rows: three train steps from its
own initial parameters, and its prefill then four greedy serve steps
(hymba's prompt of 64 is longer than its window, so the ring cache wraps
in the prefill and again while decoding).  The parameters are carried into
the port (``params_from_reference``); the same batches go through the
port's cells (``launch/specs.build_cell``) in separate interpreters, one
world a mesh for every configuration, joined through a ``file://``
rendezvous under ``tmp_path``:

- the train cell on (data 1, model 2) and on (2, 2): losses and grad norms
  within 1e-6 relative of one process's unsharded step, parameters within
  C.18's bar of the reference's and of one process's;
- the prefill and decode cells on (1, 2): logits and every cache leaf (the
  KV ring, the Mamba conv window and state) within 1e-5 of the
  reference's, the greedy tokens equal;
- the weights and caches on the placements the reference's specs give
  (the state on its heads, or on its head dim where the heads do not
  divide), and a model drawn sharded (``init_sharded``) equal to the one
  drawn whole.

The audio and vlm families run the same machinery
(``test_torch_tensor_parallel_families.py`` imports it).
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
from repro.models import prefill as ref_prefill
from repro.runtime import make_serve_step as ref_make_serve_step
from repro.runtime import make_train_state as ref_make_train_state
from repro.runtime import make_train_step as ref_make_train_step
from repro_torch.config import ShardingPolicy, TrainConfig, get_arch, smoke_variant
from repro_torch.convert import leaves_to_reference, train_state_from_reference
from repro_torch.data import make_batch
from repro_torch.runtime import make_train_step

REPO = Path(__file__).resolve().parents[1]
B, STEPS, LR, DECODE, CHUNK = 4, 3, 1e-3, 4, 16
RTOL = 1e-6
SERVE_TOL = 1e-5
WORLDS = {"1x2": (2, 1), "2x2": (4, 2)}  # name: (world, data ranks)
# name: (arch, fields replaced in its smoke variant, sequence length)
CASES = {
    "mamba2-2.7b": ("mamba2-2.7b", {}, 32),
    "hymba-1.5b": ("hymba-1.5b", {}, 64),
    # d_inner 80: 5 SSM heads over 2 ranks, so the head dim is sharded instead
    "hymba-odd": ("hymba-1.5b", {"d_model": 40, "vocab_size": 250}, 64),
}


def configs(case: tuple) -> tuple:
    """The reference's and the port's configuration of a case."""
    arch, fields, _ = case
    return (dataclasses.replace(ref_smoke_variant(ref_get_arch(arch)), **fields),
            dataclasses.replace(smoke_variant(get_arch(arch)), **fields))


def _tcfg(cls=TrainConfig):
    return cls(lr=LR, warmup_steps=0, total_steps=10)


def _flat(tree, prefix="") -> dict:
    """A (nested) cache's leaves as NumPy by dotted name."""
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else
                   {prefix + k: np.asarray(v)})
    return out


def reference_runs(cases: dict) -> dict:
    """By case: the reference's initial state, its train steps' metrics and
    final parameters, and its prefill + greedy serve steps (logits, tokens,
    the caches after the prefill and after the last step)."""
    out = {}
    for name, case in cases.items():
        cfg, _ = configs(case)
        S = case[2]
        policy = RefPolicy(attn_chunk=CHUNK)
        params = ref_init_params(cfg, RefPolicy(), 0, jnp.float32)
        state = ref_make_train_state(params, _tcfg(RefTrainConfig))
        init = jax.tree.map(np.asarray, state)
        step = jax.jit(ref_make_train_step(cfg, policy, _tcfg(RefTrainConfig)))
        metrics = []
        for i in range(STEPS):
            batch = {k: jnp.asarray(v) for k, v in ref_make_batch(cfg, B, S, step=i).items()}
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        flat = jax.tree_util.tree_flatten_with_path(state.params)[0]
        after = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in flat}

        prompt = ref_make_batch(cfg, B, S, step=7)
        lg, cache, pos = ref_prefill(params, cfg, policy, jnp.asarray(prompt["tokens"]),
                                     jnp.asarray(prompt["patches"]) if "patches" in prompt
                                     else None, max_len=S + DECODE)
        assert pos == S
        serve = {"prefill_logits": np.asarray(lg), "prefill_cache": _flat(cache),
                 "logits": [], "tokens": []}
        serve_step = jax.jit(ref_make_serve_step(cfg, policy))
        nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        serve["tokens"].append(np.asarray(nxt))
        for i in range(DECODE):
            lg, cache = serve_step(params, cache, nxt, jnp.int32(pos + i))
            nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
            serve["logits"].append(np.asarray(lg))
            serve["tokens"].append(np.asarray(nxt))
        serve["cache"] = _flat(cache)
        out[name] = {"init": init, "metrics": metrics, "after": after, "serve": serve}
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
from repro_torch.models import extend_cache, greedy_tokens, init_params
from repro_torch.runtime import make_train_state
from repro_torch.runtime.sharding import init_sharded, shard_model, tp_distribute

rank, world, data, tmp = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
B, STEPS, LR, DECODE, CHUNK = 4, 3, 1e-3, 4, 16
policy = ShardingPolicy(attn_chunk=CHUNK)
tcfg = TrainConfig(lr=LR, warmup_steps=0, total_steps=10)
dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                        world_size=world)
mesh = init_device_mesh("cpu", (data, world // data), mesh_dim_names=("data", "model"))
with open(f"{tmp}/cases.pkl", "rb") as f:
    cases = pickle.load(f)

def whole(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()

def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out

d = mesh.get_local_rank("data")
rows = slice(d * B // data, (d + 1) * B // data)
outs = {}
for name, ((arch, fields, S), init) in cases.items():
    cfg = dataclasses.replace(smoke_variant(get_arch(arch)), **fields)
    out = outs[name] = {}
    # the train cell: each data rank its rows of every global batch
    state = train_state_from_reference(init, cfg, "cpu")
    shard_model(state.params, mesh, policy)
    state = make_train_state(state.params, tcfg)
    cell = build_cell(mesh, cfg, ShapeConfig("t", S, B, "train"), policy, tcfg, torch.float32)
    metrics = []
    for i in range(STEPS):
        batch = {k: torch.from_numpy(v[rows]) for k, v in make_batch(cfg, B, S, step=i).items()}
        state, m = cell.fn(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    out["metrics"] = metrics
    out["after"] = {n: whole(p) for n, p in state.params.named_parameters()}
    del state
    if data > 1:
        continue
    # the serving cells on (1, model)
    model = tp_distribute(train_state_from_reference(init, cfg, "cpu").params, mesh, policy)
    model.requires_grad_(False)
    out["placements"] = {n: [repr(x) for x in p.placements] for n, p in model.named_parameters()}
    prefill = build_cell(mesh, cfg, ShapeConfig("p", S, B, "prefill"), policy, tcfg,
                         torch.float32)
    decode = build_cell(mesh, cfg, ShapeConfig("d", S + DECODE, B, "decode"), policy, tcfg,
                        torch.float32)
    prompt = {k: torch.from_numpy(v) for k, v in make_batch(cfg, B, S, step=7).items()
              if k != "labels"}
    lg, cache = prefill.fn(model, prompt)
    out["prefill_logits"] = whole(lg)
    out["prefill_cache"] = {n: whole(t) for n, t in flat(cache).items()}
    out["cache_placements"] = {n: [repr(x) for x in t.placements] for n, t in flat(cache).items()}
    cache = extend_cache(cfg, cache, S + DECODE)
    nxt = greedy_tokens(lg[:, -1:])
    out["tokens"], out["logits"] = [nxt.clone()], []
    for i in range(DECODE):
        lg, cache = decode.fn(model, cache, {"tokens": nxt},
                              torch.tensor([S + i], dtype=torch.int32))
        nxt = greedy_tokens(lg[:, -1:])
        out["logits"].append(whole(lg))
        out["tokens"].append(nxt.clone())
    out["cache"] = {n: whole(t) for n, t in flat(cache).items()}
    # a model drawn sharded equals the one drawn whole
    drawn = init_sharded(cfg, mesh, seed=4, dtype=torch.float32, device="cpu", policy=policy)
    ref = init_params(cfg, seed=4, dtype=torch.float32, device="cpu")
    out["init_sharded_equal"] = all(
        torch.equal(whole(p), q) for (_, p), (_, q) in zip(drawn.named_parameters(),
                                                             ref.named_parameters()))
if rank == 0:
    torch.save(outs, f"{tmp}/out.pt")
dist.destroy_process_group()
"""


def run_world(tmp: Path, cases: dict, reference: dict, world: int, data: int) -> dict:
    """The worker over ``world`` processes on a (data, world / data) mesh,
    every case in turn; rank 0's outputs by case."""
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump({n: (c, reference[n]["init"]) for n, c in cases.items()}, f)
    # one thread a rank: the ranks share the cores, and these shapes gain nothing from more
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
    """By case: one process's unsharded train steps from the reference's
    initial state (metrics, final parameters)."""
    out = {}
    for name, case in cases.items():
        _, cfg = configs(case)
        state = train_state_from_reference(reference[name]["init"], cfg, "cpu")
        step = make_train_step(cfg, ShardingPolicy(attn_chunk=CHUNK), _tcfg())
        one = []
        for i in range(STEPS):
            batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, B, case[2], step=i).items()}
            state, m = step(state, batch)
            one.append((float(m["loss"]), float(m["grad_norm"])))
        out[name] = {"one": one,
                     "one_after": {n: p.detach() for n, p in state.params.named_parameters()}}
    return out


def all_runs(cases: dict, reference: dict, tmp_path_factory) -> dict:
    """One process's steps, then one world a mesh: by case, by mesh."""
    out = one_process_runs(cases, reference)
    for mesh, (world, data) in WORLDS.items():
        got = run_world(tmp_path_factory.mktemp(f"tp{mesh}"), cases, reference, world, data)
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


def check_train_metrics(ref: dict, run: dict, mesh: str) -> None:
    for (l2, g2), (l1, g1), (lr, gr) in zip(run[mesh]["metrics"], run["one"], ref["metrics"]):
        assert abs(l2 - l1) <= RTOL * abs(l1) and abs(g2 - g1) <= RTOL * abs(g1)
        assert abs(l2 - lr) < 2e-4 and abs(g2 - gr) <= 1e-4 * gr


def check_train_params(ref: dict, run: dict, mesh: str) -> None:
    got = leaves_to_reference(run[mesh]["after"])
    within_c18(got, ref["after"])
    within_c18(got, leaves_to_reference(run["one_after"]))  # and one process's


def _cache_leaf(ref: np.ndarray, got: torch.Tensor) -> np.ndarray:
    """The reference's cache leaf cut to the port's entries (a prefill cell
    holds the prompt's; the reference's holds room for the decode steps)."""
    return ref[tuple(slice(0, n) for n in got.shape)]


def check_prefill(ref: dict, got: dict) -> None:
    ref = ref["serve"]
    np.testing.assert_allclose(got["prefill_logits"].numpy(), ref["prefill_logits"],
                               atol=SERVE_TOL, rtol=0)
    assert set(got["prefill_cache"]) == set(ref["prefill_cache"])
    for n, t in got["prefill_cache"].items():
        np.testing.assert_allclose(t.numpy(), _cache_leaf(ref["prefill_cache"][n], t),
                                   atol=SERVE_TOL, rtol=0, err_msg=n)


def check_decode(ref: dict, got: dict) -> None:
    ref = ref["serve"]
    for a, b in zip(got["tokens"], ref["tokens"]):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(got["logits"], ref["logits"]):
        np.testing.assert_allclose(a.numpy(), b, atol=SERVE_TOL, rtol=0)
    assert set(got["cache"]) == set(ref["cache"])
    for n, t in got["cache"].items():
        np.testing.assert_allclose(t.numpy(), ref["cache"][n], atol=SERVE_TOL, rtol=0,
                                   err_msg=n)


@pytest.fixture(scope="module")
def reference():
    return reference_runs(CASES)


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    return all_runs(CASES, reference, tmp_path_factory)


TRAIN = [(c, m) for c in CASES for m in WORLDS]


@pytest.mark.parametrize("case,mesh", TRAIN)
def test_train_cell_equals_one_process_and_the_reference(reference, runs, case, mesh):
    check_train_metrics(reference[case], runs[case], mesh)


@pytest.mark.parametrize("case,mesh", TRAIN)
def test_train_cell_parameters_within_the_reference_bar(reference, runs, case, mesh):
    check_train_params(reference[case], runs[case], mesh)


@pytest.mark.parametrize("case", CASES)
def test_prefill_cell_equals_the_reference(reference, runs, case):
    check_prefill(reference[case], runs[case]["1x2"])


@pytest.mark.parametrize("case", CASES)
def test_decode_cell_equals_the_reference(reference, runs, case):
    check_decode(reference[case], runs[case]["1x2"])


def test_the_hymba_ring_wraps_in_the_prefill_and_the_decode_steps(runs):
    """The prompt is longer than the window: the prefill leaves the ring
    of the last window's entries (rolled to their slots), and the decode
    steps overwrite its oldest ones; the cache never grows past it."""
    _, cfg = configs(CASES["hymba-1.5b"])
    got = runs["hymba-1.5b"]["1x2"]
    assert CASES["hymba-1.5b"][2] > cfg.window
    assert got["prefill_cache"]["k"].shape[2] == got["cache"]["k"].shape[2] == cfg.window


@pytest.mark.parametrize("case", CASES)
def test_the_mixer_and_its_cache_are_split_over_the_model_axis(runs, case):
    """``w_z``/``w_xbc`` on their outputs (d_inner, the conv channels),
    ``conv_w`` on its channels, ``norm_w`` and ``w_out`` on d_inner, ``w_dt``,
    ``A_log``, ``D`` and ``dt_bias`` replicated; the conv window on its
    channels, the state on its heads or, where the 2 ranks do not divide
    them (5 heads), on its head dim; the KV ring on its sequence."""
    got = runs[case]["1x2"]
    pl, cpl = got["placements"], got["cache_placements"]
    assert pl["blocks.0.mamba.w_z"] == pl["blocks.0.mamba.w_xbc"] == ["Shard(dim=1)"]
    assert pl["blocks.0.mamba.conv_w"] == ["Shard(dim=1)"]
    assert pl["blocks.0.mamba.norm_w"] == ["Shard(dim=0)"]
    assert pl["blocks.0.mamba.w_out"] == ["Shard(dim=0)"]
    for leaf in ("w_dt", "A_log", "D", "dt_bias"):
        assert pl[f"blocks.0.mamba.{leaf}"] == ["Replicate()"]
    assert cpl["ssm.conv"] == ["Shard(dim=3)"]
    assert cpl["ssm.state"] == ["Shard(dim=3)" if case == "hymba-odd" else "Shard(dim=2)"]
    if case != "mamba2-2.7b":
        assert cpl["k"] == cpl["v"] == ["Shard(dim=2)"]


@pytest.mark.parametrize("case", CASES)
def test_init_sharded_draws_the_weights_init_params_draws(runs, case):
    assert runs[case]["1x2"]["init_sharded_equal"]
