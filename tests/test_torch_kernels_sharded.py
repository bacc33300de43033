"""The hand-written kernels and the int8 KV cache on a model axis (ROADMAP
A.18 items 5-6) on the CPU: every family's smoke model served on (data 1,
model 2), and llama3.2-3b's also on (2, 2), under ``attention_impl="cuda"``
(the kernels' plain versions on the CPU: each rank's call is the one the
card runs), ``kv_cache_dtype="int8"`` and both, against one process and
against the reference, whose ``"pallas"`` runs in interpret mode.

The cases: llama3.2-3b's smoke variant (4 heads over 2 KV heads, the
prefill's q rows sequence-sharded: the flash kernel at each rank's
``q_offset``); one with 6 heads over 3 KV heads under
``shard_seq_attn=False`` (attention on each rank's heads, a rank's q heads
reaching into two GQA groups); mamba2-2.7b (the SSD kernel on each rank's
heads); a hymba-1.5b variant with 5 SSM heads (the scan on each rank's
head-dim columns) and a prompt of twice its window (the ring wraps in the
prefill and while decoding; a rank's rows attend from their offset through
the window); paligemma-3b with a padded vocabulary (head dim 16 here, 256 on
the cards); musicgen-medium; and deepseek-v2-lite-16b, whose MLA has no
kernel and whose latent cache the reference never quantizes.

Bars: the cuda path's logits and caches within 1e-5 of one process's and
1e-4 of the reference's, greedy tokens equal.  The int8 cache as ROADMAP
C.5 holds it: each decode step starts from the reference's cache (carried
across and placed on the mesh), a value one quantization step apart is a
flip, a batch row without one is held to 1e-4 (1e-5 against one process)
and the row that flips in that very step to 1e-3.  The reference's own
tokens are fed to both sides.

On each rank the kernels' wrappers are counted (on the card each call is a
launch): one flash call a layer with attention and one SSD call a Mamba
layer in a prefill, one decode call a layer with attention and step; none
for deepseek.  ``write_slot`` is watched: under int8 it gets int8 values and
float32 scales only, never floats for an int8 cache (and a float raises).
The plain versions' new arguments are held to the reference's
``kernels/ref.py`` on the whole problem: ``flash_attention_plain`` with
``q_offset`` on row blocks, ``decode_attention_plain`` with ``kv_start``
and ``lse`` on cache shards merged as the model merges the ranks', empty
shards included.
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
from repro.config import get_arch as ref_get_arch
from repro.config import smoke_variant as ref_smoke_variant
from repro.data import make_batch as ref_make_batch
from repro.kernels.ref import decode_attention_ref, flash_attention_ref
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.runtime import make_serve_step as ref_make_serve_step
from repro_torch.config import ShardingPolicy, get_arch, smoke_variant
from repro_torch.convert import cache_from_reference, params_from_reference
from repro_torch.kernels import decode_attention_plain, flash_attention_plain
from repro_torch.launch.dryrun import fake_world
from repro_torch.models import decode_step, greedy_tokens, prefill
from repro_torch.models.attention import merge_splits
from repro_torch.models.layers import write_slot

REPO = Path(__file__).resolve().parents[1]
B, DECODE, CHUNK = 4, 3, 16
TOL, ONE_TOL, FLIP_TOL = 1e-4, 1e-5, 1e-3
WORLDS = {"1x2": (2, 1), "2x2": (4, 2)}  # name: (world, data ranks)
VARIANTS = {
    "cuda": {"attention_impl": "cuda"},
    "int8": {"kv_cache_dtype": "int8"},
    "cuda+int8": {"attention_impl": "cuda", "kv_cache_dtype": "int8"},
    "cuda+noseqshard": {"attention_impl": "cuda", "shard_seq_attn": False,
                        "qkv_feature_shard": False},
}


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str
    fields: tuple  # (name, value) pairs replaced in its smoke variant
    seq: int
    variants: tuple
    meshes: tuple = ("1x2",)


CASES = {
    "llama3.2-3b": Case("llama3.2-3b", (), 32, ("cuda", "int8", "cuda+int8"),
                        ("1x2", "2x2")),
    "llama-split-groups": Case("llama3.2-3b", (("num_heads", 6), ("num_kv_heads", 3)), 32,
                               ("cuda+noseqshard",)),
    "mamba2-2.7b": Case("mamba2-2.7b", (), 32, ("cuda",)),
    "hymba-odd": Case("hymba-1.5b", (("d_model", 40), ("vocab_size", 250)), 64,
                      ("cuda", "cuda+int8")),
    "paligemma-3b": Case("paligemma-3b", (("vocab_size", 250),), 32, ("cuda", "cuda+int8")),
    "musicgen-medium": Case("musicgen-medium", (), 32, ("cuda", "cuda+int8")),
    "deepseek-v2-lite-16b": Case("deepseek-v2-lite-16b", (), 32, ("cuda+int8",)),
    # kimi-k2-1t-a32b's head dim, 112: the kernels at the next instantiated width
    "kimi-d112": Case("kimi-k2-1t-a32b", (("head_dim", 112),), 32, ("cuda",)),
    # hymba-1.5b's family at d_model 72: 3 SSD heads of 48 (which 2 ranks do
    # not divide: each rank scans its 24 strided head-dim columns), state
    # size 80, 4 attention heads on 2 KV heads of 72
    "hymba-d72": Case("hymba-1.5b", (("d_model", 72), ("num_heads", 4), ("num_kv_heads", 2),
                                     ("head_dim", 72),
                                     ("ssm", (("d_state", 80), ("head_dim", 48)))),
                      32, ("cuda",)),
}
PARAMS = [(c, v, m) for c, case in CASES.items() for v in case.variants for m in case.meshes
          if m == "1x2" or v != "int8"]


def _smoke(cfg, fields: tuple):
    """``cfg`` with ``fields`` replaced ("ssm": pairs of its SSM config's)."""
    fields = dict(fields)
    if "ssm" in fields:
        fields["ssm"] = dataclasses.replace(cfg.ssm, **dict(fields["ssm"]))
    return dataclasses.replace(cfg, **fields)


def configs(case: Case) -> tuple:
    """The reference's and the port's configuration of a case."""
    return (_smoke(ref_smoke_variant(ref_get_arch(case.arch)), case.fields),
            _smoke(smoke_variant(get_arch(case.arch)), case.fields))


def policy(variant: str) -> ShardingPolicy:
    return ShardingPolicy(attn_chunk=CHUNK, **VARIANTS[variant])


def ref_policy(variant: str) -> RefPolicy:
    fields = dict(VARIANTS[variant])
    if fields.get("attention_impl") == "cuda":
        fields["attention_impl"] = "pallas"  # interpret mode on the CPU
    return RefPolicy(attn_chunk=CHUNK, **fields)


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else
                   {prefix + k: np.array(v)})
    return out


def kernel_calls(cfg, variant: str) -> dict:
    """The wrapper calls a rank makes under ``variant`` (none but under
    ``"cuda"``): (prefill, the decode steps)."""
    on = policy(variant).attention_impl == "cuda"
    attn = cfg.num_layers if on and cfg.has_attention and cfg.mla is None else 0
    ssm = cfg.num_layers if on and cfg.has_ssm else 0
    return {"prefill": {"flash_attention": attn, "decode_attention": 0, "ssd_scan": ssm},
            "decode": {"flash_attention": 0, "decode_attention": attn * DECODE, "ssd_scan": 0}}


def reference_runs() -> dict:
    """By case: the reference's parameters, its prompt, and by variant its
    prefill (logits, cache) and greedy serve steps (logits, tokens, the
    cache before each step and after the last)."""
    out = {}
    for name, case in CASES.items():
        cfg, _ = configs(case)
        params = ref_init_params(cfg, RefPolicy(), 0, jnp.float32)
        prompt = ref_make_batch(cfg, B, case.seq, step=7)
        prompt = {k: prompt[k] for k in ("tokens", "patches") if k in prompt}
        run = out[name] = {"params": jax.tree.map(np.array, params), "prompt": prompt,
                           "serve": {}}
        for v in case.variants:
            pol = ref_policy(v)
            lg, cache, pos = ref_prefill(params, cfg, pol, jnp.asarray(prompt["tokens"]),
                                         jnp.asarray(prompt["patches"]) if "patches" in prompt
                                         else None, max_len=case.seq + DECODE)
            got = {"prefill_logits": np.array(lg), "prefill_cache": _flat(cache),
                   "logits": [], "tokens": [], "caches": [jax.tree.map(np.array, cache)]}
            step = jax.jit(ref_make_serve_step(cfg, pol))
            nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
            got["tokens"].append(np.array(nxt))
            for i in range(DECODE):
                lg, cache = step(params, cache, nxt, jnp.int32(pos + i))
                nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
                got["logits"].append(np.array(lg))
                got["tokens"].append(np.array(nxt))
                got["caches"].append(jax.tree.map(np.array, cache))
            got["cache"] = _flat(cache)
            run["serve"][v] = got
    return out


WORKER = r"""
import dataclasses, pickle, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from repro_torch import kernels
from repro_torch.config import ShardingPolicy, get_arch, smoke_variant
from repro_torch.convert import cache_from_reference, params_from_reference
from repro_torch.models import activate_mesh, decode_step, greedy_tokens, prefill, transformer
from repro_torch.runtime.sharding import check_model_axis, tp_distribute

rank, world, data, tmp = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                        world_size=world)
mesh = init_device_mesh("cpu", (data, world // data), mesh_dim_names=("data", "model"))
mesh_name = f"{data}x{world // data}"
with open(f"{tmp}/cases.pkl", "rb") as f:
    cases, variants, (B, DECODE, CHUNK) = pickle.load(f)

calls = {}
def counted(name):
    fn = getattr(kernels, name)
    def call(*args, **kw):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kw)
    return call
for name in ("flash_attention", "decode_attention", "ssd_scan"):
    setattr(kernels, name, counted(name))
slots = set()
write_slot = transformer.write_slot
def watched(cache, slot, new):
    slots.add((str(cache.to_local().dtype), str(new.dtype)))
    return write_slot(cache, slot, new)
transformer.write_slot = watched

def whole(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()

def rows_all(t, dim=0):
    # every data rank's rows of a whole tensor, joined in their order
    if data == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(data)]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group("data"))
    return torch.cat(parts, dim=dim)

def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out

def place(cache, ref, rows):
    # the reference's whole cache, this data rank's rows, into the mesh's cache
    for name, leaf in flat(cache).items():
        src = flat(ref)[name][:, rows]
        shape, off = compute_local_shape_and_global_offset(leaf.shape, leaf.device_mesh,
                                                           leaf.placements)
        leaf.to_local().copy_(src[tuple(slice(o, o + n) for o, n in zip(off, shape))])

d = mesh.get_local_rank("data")
rows = slice(d * B // data, (d + 1) * B // data)
outs = {}
for name, ((arch, fields, S, vs, meshes), params, prompt, steps) in cases.items():
    if mesh_name not in meshes:
        continue
    fields = dict(fields)
    if "ssm" in fields:
        fields["ssm"] = dataclasses.replace(smoke_variant(get_arch(arch)).ssm,
                                            **dict(fields["ssm"]))
    cfg = dataclasses.replace(smoke_variant(get_arch(arch)), **fields)
    out = outs[name] = {}
    for v in vs:
        if v == "int8" and mesh_name != "1x2":
            continue
        policy = ShardingPolicy(attn_chunk=CHUNK, **variants[v])
        model = tp_distribute(params_from_reference(params, cfg, "cpu"), mesh, policy)
        model.requires_grad_(False)
        check_model_axis(cfg, policy, world // data, data)
        toks = torch.from_numpy(prompt["tokens"][rows])
        patches = torch.from_numpy(prompt["patches"][rows]) if "patches" in prompt else None
        calls.clear(); slots.clear()
        with activate_mesh(mesh):
            lg, cache, pos = prefill(model, cfg, policy, toks, patches, max_len=S + DECODE)
        got = {"calls": {"prefill": dict(calls)}, "prefill_logits": rows_all(whole(lg)),
               "prefill_cache": {n: rows_all(whole(t), 1) for n, t in flat(cache).items()},
               "logits": [], "tokens": [], "caches": []}
        calls.clear()
        ref_caches, feed = steps[v]
        for i in range(DECODE):
            if policy.kv_cache_dtype == "int8":  # each step from the reference's cache
                place(cache, cache_from_reference(ref_caches[i], cfg, "cpu"), rows)
            with activate_mesh(mesh):
                lg, cache = decode_step(model, cfg, policy, cache,
                                        torch.from_numpy(feed[i][rows].copy()),
                                        torch.tensor([pos + i], dtype=torch.int32))
            got["logits"].append(rows_all(whole(lg)))
            got["tokens"].append(rows_all(greedy_tokens(lg[:, -1:])))
            got["caches"].append({n: rows_all(whole(t), 1) for n, t in flat(cache).items()})
        got["calls"]["decode"] = dict(calls)
        got["slots"] = sorted(slots)
        out[v] = got
if rank == 0:
    torch.save(outs, f"{tmp}/out.pt")
dist.destroy_process_group()
"""


def run_world(tmp: Path, reference: dict, world: int, data: int) -> dict:
    """The worker over ``world`` processes on a (data, world / data) mesh,
    every case and variant in turn; rank 0's outputs by case and variant."""
    cases = {}
    for name, case in CASES.items():
        ref = reference[name]
        # per variant: the reference's caches before each step, and its tokens fed
        steps = {v: (ref["serve"][v]["caches"], ref["serve"][v]["tokens"])
                 for v in case.variants}
        cases[name] = ((case.arch, case.fields, case.seq, case.variants, case.meshes),
                       ref["params"], ref["prompt"], steps)
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump((cases, VARIANTS, (B, DECODE, CHUNK)), f)
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


def one_process_runs(reference: dict) -> dict:
    """By case and variant: one process's prefill and decode steps under
    the variant's policy, fed as the worker is."""
    out = {}
    for name, case in CASES.items():
        _, cfg = configs(case)
        ref = reference[name]
        out[name] = {}
        for v in case.variants:
            model = params_from_reference(ref["params"], cfg, "cpu").requires_grad_(False)
            prompt = {k: torch.from_numpy(x) for k, x in ref["prompt"].items()}
            lg, cache, pos = prefill(model, cfg, policy(v), prompt["tokens"],
                                     prompt.get("patches"), max_len=case.seq + DECODE)
            got = {"prefill_logits": lg, "prefill_cache": _flat(cache), "logits": [],
                   "caches": []}
            serve = ref["serve"][v]
            for i in range(DECODE):
                if policy(v).kv_cache_dtype == "int8":
                    cache = cache_from_reference(jax.tree.map(np.copy, serve["caches"][i]), cfg,
                                                 "cpu")
                lg, cache = decode_step(model, cfg, policy(v), cache,
                                        torch.from_numpy(serve["tokens"][i].copy()), pos + i)
                got["logits"].append(lg)
                got["caches"].append(_flat(cache))
            out[name][v] = got
    return out


@pytest.fixture(scope="module")
def reference():
    return reference_runs()


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    """By case: ``"one"`` (one process) and each mesh's name, then by
    variant."""
    one = one_process_runs(reference)
    out = {name: {"one": one[name]} for name in CASES}
    for mesh, (world, data) in WORLDS.items():
        got = run_world(tmp_path_factory.mktemp(f"kernels{mesh}"), reference, world, data)
        for name in got:
            out[name][mesh] = got[name]
    return out


def _int8_leaves(cache: dict) -> list:
    return [n for n, t in cache.items() if np.asarray(t).dtype == np.int8]


def _flips(got: dict, want: dict) -> np.ndarray:
    """Per batch row: the int8 cache entries quantized one step apart."""
    rows = 0
    for n in _int8_leaves(want):
        gap = np.abs(np.asarray(got[n]).astype(np.int32) - np.asarray(want[n]).astype(np.int32))
        assert gap.max() <= 1, (n, gap.max())
        rows = rows + (gap != 0).sum(axis=(0, *range(2, gap.ndim)))
    return np.asarray(rows) if np.ndim(rows) else np.zeros(B, int)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=0, err_msg=what)


def _cache_leaf(ref: np.ndarray, got) -> np.ndarray:
    """The reference's leaf cut to the port's entries."""
    return ref[tuple(slice(0, n) for n in np.shape(got))]


@pytest.mark.parametrize("case,variant,mesh", PARAMS)
def test_serving_equals_one_process_and_the_reference(reference, runs, case, variant, mesh):
    ref, got, one = (reference[case]["serve"][variant], runs[case][mesh][variant],
                     runs[case]["one"][variant])
    int8 = policy(variant).kv_cache_dtype == "int8"
    _close(got["prefill_logits"], ref["prefill_logits"], TOL, "prefill logits")
    _close(got["prefill_logits"], one["prefill_logits"], ONE_TOL, "prefill logits (one)")
    assert set(got["prefill_cache"]) == set(ref["prefill_cache"])
    for n, t in got["prefill_cache"].items():
        want, mine = _cache_leaf(ref["prefill_cache"][n], t), _cache_leaf(one["prefill_cache"][n],
                                                                           t)
        if t.dtype == torch.int8:  # a prefill entry quantized one step apart (C.5)
            assert np.abs(t.numpy().astype(int) - want.astype(int)).max() <= 1, n
            assert np.abs(t.numpy().astype(int) - mine.astype(int)).max() <= 1, n
            continue
        _close(t, want, TOL, n)
        _close(t, mine, ONE_TOL, n)
    for i in range(DECODE):
        lg = got["logits"][i].float().numpy()
        if int8:  # each step from the reference's cache: this step's flips alone
            to_ref = _flips(got["caches"][i], _flat(ref["caches"][i + 1]))
            to_one = _flips(got["caches"][i], one["caches"][i])
            for b in range(B):
                _close(lg[b], ref["logits"][i][b], FLIP_TOL if to_ref[b] else TOL,
                       f"step {i} row {b}")
                _close(lg[b], one["logits"][i][b].float(), FLIP_TOL if to_one[b] else ONE_TOL,
                       f"step {i} row {b} (one)")
        else:
            _close(lg, ref["logits"][i], TOL, f"step {i}")
            _close(lg, one["logits"][i].float(), ONE_TOL, f"step {i} (one)")
        np.testing.assert_array_equal(got["tokens"][i].numpy(), ref["tokens"][i + 1])
    if not int8:
        for n, t in got["caches"][-1].items():
            _close(t, ref["cache"][n], TOL, n)
            _close(t, one["caches"][-1][n], ONE_TOL, n)


@pytest.mark.parametrize("case,variant,mesh", PARAMS)
def test_each_rank_calls_each_kernel_once_a_layer(runs, case, variant, mesh):
    """On the card each call is one launch: a flash and an SSD launch a
    layer in a prefill, a decode launch a layer and step; MLA none; the
    plain paths none."""
    _, cfg = configs(CASES[case])
    want = kernel_calls(cfg, variant)
    got = runs[case][mesh][variant]["calls"]
    for stage in ("prefill", "decode"):
        assert {k: got[stage].get(k, 0) for k in want[stage]} == want[stage], stage


@pytest.mark.parametrize("case,variant", [(c, v) for c, v, m in PARAMS
                                          if m == "1x2" and "int8" in v])
def test_int8_cache_takes_quantized_values_and_scales_only(runs, case, variant):
    """``write_slot`` on the mesh gets int8 values for the int8 leaves and
    float32 scales for theirs; deepseek's latent cache stays float32 (the
    reference's has no int8 form) and nothing goes through write_slot."""
    got = runs[case]["1x2"][variant]
    leaves = got["prefill_cache"]
    if case == "deepseek-v2-lite-16b":
        assert {str(t.dtype) for t in leaves.values()} == {"torch.float32"}
        assert not [n for n in leaves if "scale" in n] and got["slots"] == []
        return
    assert got["slots"] == [("torch.float32", "torch.float32"), ("torch.int8", "torch.int8")]
    assert {n: str(t.dtype) for n, t in leaves.items() if n in ("k", "v", "k_scale", "v_scale")} \
        == {"k": "torch.int8", "v": "torch.int8", "k_scale": "torch.float32",
            "v_scale": "torch.float32"}


def test_write_slot_refuses_floats_for_an_int8_cache():
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard

    with fake_world(2):
        mesh = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("model",))
        cache = DTensor.from_local(torch.zeros(2, 3, 2, 4, dtype=torch.int8), mesh, [Shard(1)],
                                   run_check=False)
        slot = torch.tensor([1])
        with pytest.raises(TypeError, match="int8"):
            write_slot(cache, slot, torch.ones(2, 1, 2, 4))
        write_slot(cache, slot, torch.full((2, 1, 2, 4), 7, dtype=torch.int8))
        assert int(cache.to_local()[:, 1].min()) == 7 and int(cache.to_local().sum()) == 7 * 16


# the plain versions' new arguments against the reference's oracles

FLASH = [((24, 8, 16), 64, 0, (0, 16, 32, 48)), ((8, 1, 32), 64, 12, (0, 5, 40)),
         ((25, 5, 16), 96, 32, (0, 24, 48, 72)), ((4, 2, 16), 40, 0, (0, 13, 27)),
         ((8, 1, 112), 64, 0, (0, 16, 32, 48)), ((16, 16, 72), 64, 0, (0, 16, 32, 48)),
         ((8, 1, 192), 64, 12, (0, 5, 40))]


@pytest.mark.parametrize("heads,S,window,cuts", FLASH)
def test_flash_attention_plain_rows_at_their_offset_equal_the_reference(heads, S, window, cuts):
    H, KVH, D = heads
    rng = np.random.default_rng(S + window)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, S, H, D), (2, S, KVH, D), (2, S, KVH, D)))
    want = np.asarray(flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=True, window=window))
    for a, b in zip(cuts, (*cuts[1:], S)):
        got = flash_attention_plain(torch.from_numpy(q[:, a:b]), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=True, window=window, q_offset=a)
        _close(got, want[:, a:b], 1e-5, f"rows {a}:{b}")


DECODE_CASES = [((24, 8, 16), 40, 4, 0), ((8, 1, 32), 36, 3, 8), ((25, 5, 16), 30, 5, 0),
                ((8, 1, 112), 40, 4, 0), ((16, 16, 72), 40, 4, 0), ((8, 1, 192), 36, 3, 8)]


@pytest.mark.parametrize("heads,smax,shards,window", DECODE_CASES)
@pytest.mark.parametrize("length", [1, 7, "all"])
def test_decode_attention_plain_shards_merged_equal_the_reference(heads, smax, shards, window,
                                                                   length):
    """Each shard's output and log-sum-exp from its ``kv_start``, merged as
    the model merges the ranks'; a shard with no valid entry gives 0 and
    NEG_INF."""
    H, KVH, D = heads
    n = smax if length == "all" else length
    rng = np.random.default_rng(smax + n)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 1, H, D), (3, smax, KVH, D), (3, smax, KVH, D)))
    want = np.asarray(decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.int32(n), window=window))
    size = -(-smax // shards)
    outs, lses = [], []
    for start in range(0, smax, size):
        part = slice(start, start + size)
        o, lse = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k[:, part]),
                                        torch.from_numpy(v[:, part]),
                                        torch.tensor([n], dtype=torch.int32), window=window,
                                        kv_start=start, with_lse=True)
        lo = max(0, n - window) if window else 0
        if start >= n or start + size <= lo:  # no valid entry
            assert not o.any() and bool((lse == -1e30).all())
        assert torch.isfinite(lse).all()
        outs.append(o[:, 0])
        lses.append(lse)
    lse = torch.stack(lses)
    got = merge_splits(lse, torch.ones_like(lse), torch.stack(outs))
    _close(got[:, None], want, 1e-5, "merged")


@pytest.mark.parametrize("arch", ["llama3.2-3b", "hymba-1.5b"])
def test_dry_run_serves_the_int8_cache_on_the_production_mesh(arch):
    """The smoke variant's decode cell on the production mesh (16 model
    ranks) with the int8 cache runs (no refusal) with the default's
    collectives: each rank quantizes and dequantizes its own entries; a
    rank's cache bytes are the int8 values and float32 scales of its
    shard."""
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_production_mesh

    cfg = smoke_variant(get_arch(arch))
    shape = ShapeConfig("decode", 256, 32, "decode")
    got = {}
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        for kv in ("bf16", "int8"):
            pol = ShardingPolicy(kv_cache_dtype=kv)
            assert dryrun._refusal(cfg, pol, mesh) is None
            got[kv] = (dryrun.step_collectives(mesh, cfg, shape, pol),
                       dryrun.argument_bytes(specs.build_cell(mesh, cfg, shape, pol), 1))
    assert got["int8"][0] == got["bf16"][0]
    L, KVH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    entries = 2 * (min(256, cfg.window) if cfg.window else 256) // 16  # rows a rank x its entries
    attn = L * entries * KVH * 2  # k and v
    assert got["bf16"][1] - got["int8"][1] == attn * hd * 2 - attn * (hd + 4)
