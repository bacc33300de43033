"""The port's serving path (prefill + decode of the llama3.2-3b smoke
variant, and of the deepseek-v2-lite-16b (moe, MLA), paligemma-3b (vlm)
and musicgen-medium (audio) smoke variants) against the JAX package's, its
token generator, its conversion of the reference's parameters and caches,
and its CLI.

The reference's parameters (``init_params``, float32) are carried across
with ``params_from_reference``, and both packages serve the same prompt:
JAX ``prefill`` + ``make_serve_step`` with ``attention_impl="pallas"``
(interpret mode) or ``"chunked"``, the port with ``"cuda"`` (the kernels'
plain versions on the CPU) or ``"chunked"``; deepseek's experts dispatch
by gshard at the reference's capacity factor (1.25) in both, paligemma's
prompt is 8 patch embeddings and 8 text tokens, musicgen's 4 codebooks.
Each step is fed the reference's greedy token (one a codebook for audio).  Tolerances (float32): prefill logits and KV
cache to 1e-5, each step's logits to 1e-4 (the sums run in another order
and decode steps build on the prefill's cache); greedy tokens identical.

With the int8 cache a new K/V value that lies within an ulp of a rounding
boundary can quantize one step apart in the two packages (a difference of
1e-7 in float32 becomes one step of absmax/127).  So in the int8 case the
port starts each step from the reference's cache, carried across with
``cache_from_reference``: a flip cannot carry into later steps.  Flips are
counted per step and batch row (at most 4 entries, one step each); a row
without one is held to 1e-4, and only the row that flips in that very step
to 1e-3, the size one quantization step of one cached value moves its
logits at this width (2.4e-4 at this seed).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import re
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
from repro.data import SyntheticStream as RefStream
from repro.data import batch_load_spec as ref_batch_load_spec
from repro.data import make_batch as ref_make_batch
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.runtime import make_serve_step as ref_make_serve_step
from repro_torch.config import get_arch, smoke_variant
from repro_torch.convert import cache_from_reference, params_from_reference, policy_from_reference
from repro_torch.data import SyntheticStream, batch_load_spec, make_batch
from repro_torch.models import prefill
from repro_torch.runtime import make_serve_step

REPO = Path(__file__).resolve().parents[1]
ARCH = "llama3.2-3b"
B, PROMPT, STEPS, MAX_LEN = 2, 16, 6, 24

# (reference attention_impl, kv_cache_dtype, attention type[, arch: llama3.2-3b])
CASES = [("pallas", "bf16", "full"), ("chunked", "bf16", "full"), ("pallas", "int8", "full"),
         ("chunked", "bf16", "swa"), ("chunked", "bf16", "full", "deepseek-v2-lite-16b"),
         ("pallas", "bf16", "full", "paligemma-3b"), ("pallas", "bf16", "full", "musicgen-medium"),
         ("pallas", "bf16", "full", "kimi-k2-1t-a32b"),
         ("pallas", "bf16", "full", "hymba-1.5b-d72"),
         ("pallas", "bf16", "full", "llama3.2-3b-d192")]
# fields replaced in an arch's smoke variant in both packages ("ssm": fields of
# its SSM config), by case name, with the registered arch it starts from:
# kimi-k2-1t-a32b keeps its head dim, 112, which the kernels run at the next
# instantiated width; shapes no registered config has: hymba-1.5b's family at
# d_model 72 (d_inner 144: 3 SSD heads of 48, state size 80; 4 attention heads
# on 2 KV heads of 72), llama3.2-3b's at head dim 192 (the head-dim-256 kernels)
SMOKE_FIELDS = {
    "kimi-k2-1t-a32b": ("kimi-k2-1t-a32b", {"head_dim": 112}),
    "hymba-1.5b-d72": ("hymba-1.5b", {"d_model": 72, "num_heads": 4, "num_kv_heads": 2,
                                      "head_dim": 72, "ssm": {"d_state": 80, "head_dim": 48}}),
    "llama3.2-3b-d192": ("llama3.2-3b", {"head_dim": 192}),
}


def _smoke(cfg, fields):
    fields = dict(fields)
    if "ssm" in fields:
        fields["ssm"] = dataclasses.replace(cfg.ssm, **fields["ssm"])
    return dataclasses.replace(cfg, **fields)


def _cfgs(attn_type, arch=ARCH):
    arch, fields = SMOKE_FIELDS.get(arch, (arch, {}))
    ref_cfg = _smoke(ref_smoke_variant(ref_get_arch(arch)), fields)
    cfg = _smoke(smoke_variant(get_arch(arch)), fields)
    if attn_type == "swa":  # the ring-buffer branches: window 8 < prompt 16
        ref_cfg = dataclasses.replace(ref_cfg, attn_type="swa", window=8)
        cfg = dataclasses.replace(cfg, attn_type="swa", window=8)
    return ref_cfg, cfg


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x)


def _flat(tree, prefix=""):
    """A (nested) cache's leaves as NumPy by dotted name."""
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else
                   {prefix + k: _np(v.clone() if isinstance(v, torch.Tensor) else v)})
    return out


@functools.lru_cache(maxsize=None)
def _runs(case):
    """Both packages through prefill + STEPS decode steps on the same
    parameters and prompt; the port is fed the reference's tokens."""
    impl, kv_dtype, attn_type, *arch = case
    ref_cfg, cfg = _cfgs(attn_type, *arch)
    ref_policy = RefPolicy(attention_impl=impl, attn_chunk=PROMPT, kv_cache_dtype=kv_dtype)
    policy = policy_from_reference(ref_policy)
    params = ref_init_params(ref_cfg, ref_policy, seed=5, dtype=jnp.float32)
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg, "cpu")
    rng = np.random.default_rng(11)
    n_text = PROMPT - (cfg.num_patches if cfg.family == "vlm" else 0)
    codebooks = (cfg.num_codebooks,) if cfg.family == "audio" else ()
    toks = rng.integers(0, cfg.vocab_size, size=(B, n_text, *codebooks), dtype=np.int32)
    patches = (rng.standard_normal((B, cfg.num_patches, cfg.patch_dim)).astype(np.float32)
               if cfg.family == "vlm" else None)

    ref = {"logits": [], "tokens": []}
    lg, cache, pos = ref_prefill(params, ref_cfg, ref_policy, jnp.asarray(toks),
                                 None if patches is None else jnp.asarray(patches),
                                 max_len=MAX_LEN)
    assert pos == PROMPT
    ref["prefill_logits"], ref["prefill_cache"] = np.asarray(lg), _flat(cache)
    step = jax.jit(ref_make_serve_step(ref_cfg, ref_policy))
    nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
    feed = [np.asarray(nxt)]
    ref_caches = [jax.tree.map(np.asarray, cache)]  # before step 0, after each step
    for i in range(STEPS):
        lg, cache = step(params, cache, nxt, jnp.int32(pos + i))
        nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        ref["logits"].append(np.asarray(lg))
        ref["tokens"].append(np.asarray(nxt))
        ref_caches.append(jax.tree.map(np.asarray, cache))
        feed.append(np.asarray(nxt))
    ref["cache"] = _flat(cache)

    port = {"logits": [], "tokens": []}
    lg, cache, pos = prefill(model, cfg, policy, torch.from_numpy(toks),
                             None if patches is None else torch.from_numpy(patches),
                             max_len=MAX_LEN)
    assert pos == PROMPT
    port["prefill_logits"] = _np(lg)
    port["prefill_cache"] = _flat(cache)
    port["first_token"] = lg[:, -1:].argmax(dim=-1).to(torch.int32).numpy()
    step = make_serve_step(cfg, policy)
    port["flips"] = []  # per step: int8 entries quantized apart, per batch row; largest gap
    for i in range(STEPS):
        if kv_dtype == "int8":  # each step from the reference's cache: no flip carries on
            cache = cache_from_reference(ref_caches[i], cfg, "cpu")
        lg, cache = step(model, cache, torch.from_numpy(feed[i].copy()), pos + i)
        port["logits"].append(_np(lg))
        port["tokens"].append(lg[:, -1:].argmax(dim=-1).to(torch.int32).numpy())
        gaps = [np.abs(cache[k].numpy().astype(np.int32) - ref_caches[i + 1][k])
                for k in ("k", "v")] if kv_dtype == "int8" else [np.zeros((1, B, 1))]
        port["flips"].append((sum((g != 0).sum(axis=(0, *range(2, g.ndim))) for g in gaps),
                              max(int(g.max()) for g in gaps)))
    port["cache"] = _flat(cache)
    port["feed0"] = feed[0]
    return ref, port


CASE_IDS = ["-".join(c) for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_prefill_logits_and_cache_match_reference(case):
    ref, port = _runs(case)
    np.testing.assert_allclose(port["prefill_logits"], ref["prefill_logits"], rtol=1e-5,
                               atol=1e-5)
    assert set(port["prefill_cache"]) == set(ref["prefill_cache"])
    for name, want in ref["prefill_cache"].items():
        np.testing.assert_allclose(port["prefill_cache"][name], want.astype(np.float32),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_decode_steps_match_reference(case):
    ref, port = _runs(case)
    for i, (got, want) in enumerate(zip(port["logits"], ref["logits"])):
        row_flips, step_size = port["flips"][i]
        assert step_size <= 1 and row_flips.sum() <= 4, (i, row_flips, step_size)
        for b in range(B):
            tol = 1e-3 if row_flips[b] else 1e-4  # a flip in this very step moves this row
            np.testing.assert_allclose(got[b], want[b], rtol=tol, atol=tol,
                                       err_msg=f"step {i}, row {b}")
    for name, want in ref["cache"].items():
        if want.dtype == np.int8:
            assert np.abs(port["cache"][name] - want).max() <= 1, name
            continue
        np.testing.assert_allclose(port["cache"][name], want.astype(np.float32), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_greedy_tokens_match_reference(case):
    ref, port = _runs(case)
    np.testing.assert_array_equal(port["first_token"], port["feed0"])
    np.testing.assert_array_equal(np.concatenate(port["tokens"], 1),
                                  np.concatenate(ref["tokens"], 1))


def test_cache_from_reference_round_trips_the_reference_cache():
    ref, _ = _runs(CASES[2])  # int8
    _, cfg = _cfgs("full")
    cache = cache_from_reference(ref["prefill_cache"], cfg, "cpu")
    assert cache["k"].dtype == torch.int8 and cache["k_scale"].dtype == torch.float32
    for name, want in ref["prefill_cache"].items():
        np.testing.assert_array_equal(cache[name].numpy(), want)


def test_params_from_reference_carries_bfloat16_bit_for_bit():
    ref_cfg, cfg = _cfgs("full")
    params = jax.tree.map(np.asarray, ref_init_params(ref_cfg, seed=1))  # bfloat16
    model = params_from_reference(params, cfg, "cpu")
    assert model.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(model.embed.view(torch.int16).numpy(),
                                  params["embed"].view(np.int16))
    np.testing.assert_array_equal(model.blocks[1].mlp.w_down.view(torch.int16).numpy(),
                                  params["blocks"]["mlp"]["w_down"][1].view(np.int16))


def _broken(params, what):
    p = jax.tree.map(lambda a: a, params)
    if what == "shape":
        p["blocks"]["attn"]["w_q"] = p["blocks"]["attn"]["w_q"][:, :, :-1]
    elif what == "dtype":
        p["blocks"]["ln1"] = p["blocks"]["ln1"].astype(np.float64)
    elif what == "missing":
        del p["blocks"]["mlp"]["w_up"]
    elif what == "extra":
        p["head"] = p["embed"].T
    return p


@pytest.mark.parametrize("what,exc", [("shape", ValueError), ("dtype", TypeError),
                                      ("missing", ValueError), ("extra", ValueError)])
def test_params_from_reference_checks_the_tree(what, exc):
    ref_cfg, cfg = _cfgs("full")
    params = jax.tree.map(np.asarray, ref_init_params(ref_cfg, seed=1, dtype=jnp.float32))
    with pytest.raises(exc):
        params_from_reference(_broken(params, what), cfg, "cpu")


NEW_FAMILIES = ["deepseek-v2-lite-16b", "paligemma-3b", "musicgen-medium"]


def _ref_leaf(params, name):
    """The reference leaf behind the port's parameter ``name``
    (``blocks.<l>.`` indexes the stacked layer axis)."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return functools.reduce(lambda t, k: t[k], parts, params)
    return functools.reduce(lambda t, k: t[k], parts[2:], params["blocks"])[int(parts[1])]


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_params_from_reference_carries_the_new_families_bit_for_bit(arch):
    """Every leaf of the moe/MLA, vlm and audio trees (the experts and the
    shared expert, the latent projections, ``patch_proj``, the codebook
    ``embed`` and ``heads``) crosses bfloat16 bit for bit."""
    ref_cfg, cfg = _cfgs("full", arch)
    params = jax.tree.map(np.asarray, ref_init_params(ref_cfg, seed=1))  # bfloat16
    model = params_from_reference(params, cfg, "cpu")
    names = dict(model.named_parameters())
    assert len(names) == len(jax.tree.leaves(params["blocks"])) * cfg.num_layers + len(
        [k for k in params if k != "blocks"])
    for name, t in names.items():
        want = _ref_leaf(params, name)
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == want.shape, name
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), want.view(np.int16),
                                      err_msg=name)


def _broken_leaf(params, path, what):
    p = jax.tree.map(lambda a: a, params)
    *parents, leaf = path.split(".")
    node = functools.reduce(lambda t, k: t[k], parents, p)
    if what == "shape":
        node[leaf] = node[leaf][..., :-1]
    elif what == "dtype":
        node[leaf] = node[leaf].astype(np.float64)
    elif what == "missing":
        del node[leaf]
    return p


@pytest.mark.parametrize("arch,path,what,exc", [
    ("deepseek-v2-lite-16b", "blocks.moe.w_gate", "shape", ValueError),
    ("deepseek-v2-lite-16b", "blocks.moe.shared.w_down", "dtype", TypeError),
    ("deepseek-v2-lite-16b", "blocks.attn.w_dkv", "missing", ValueError),
    ("deepseek-v2-lite-16b", "blocks.moe.router", "shape", ValueError),
    ("paligemma-3b", "patch_proj", "shape", ValueError),
    ("paligemma-3b", "patch_proj", "missing", ValueError),
    ("musicgen-medium", "heads", "shape", ValueError),
    ("musicgen-medium", "embed", "dtype", TypeError),
])
def test_params_from_reference_checks_the_new_families_trees(arch, path, what, exc):
    ref_cfg, cfg = _cfgs("full", arch)
    params = jax.tree.map(np.asarray, ref_init_params(ref_cfg, seed=1, dtype=jnp.float32))
    params_from_reference(params, cfg, "cpu")  # the unbroken tree crosses
    with pytest.raises(exc):
        params_from_reference(_broken_leaf(params, path, what), cfg, "cpu")


@functools.lru_cache(maxsize=None)
def _mla_cache_bf16():
    """deepseek's smoke variant prefilled by the reference in bfloat16: its
    latent cache as NumPy."""
    ref_cfg, _ = _cfgs("full", "deepseek-v2-lite-16b")
    ref_policy = RefPolicy(attention_impl="chunked", attn_chunk=PROMPT)
    params = ref_init_params(ref_cfg, ref_policy, seed=2)  # bfloat16
    toks = np.random.default_rng(4).integers(0, ref_cfg.vocab_size, size=(B, PROMPT),
                                             dtype=np.int32)
    _, cache, _ = ref_prefill(params, ref_cfg, ref_policy, jnp.asarray(toks), max_len=MAX_LEN)
    return jax.tree.map(np.asarray, cache)


def test_cache_from_reference_carries_the_mla_cache_bit_for_bit():
    _, cfg = _cfgs("full", "deepseek-v2-lite-16b")
    ref = _mla_cache_bf16()
    cache = cache_from_reference(ref, cfg, "cpu")
    assert set(cache) == {"mla"} and set(cache["mla"]) == {"c_kv", "k_pe"}
    for name, want in ref["mla"].items():
        got = cache["mla"][name]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        assert got[:, :, :PROMPT].any()
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


@pytest.mark.parametrize("what", ["shape", "dtype", "kv_names"])
def test_cache_from_reference_checks_the_mla_cache(what):
    _, cfg = _cfgs("full", "deepseek-v2-lite-16b")
    ref = jax.tree.map(lambda a: a, _mla_cache_bf16())
    if what == "shape":
        ref["mla"]["k_pe"] = ref["mla"]["k_pe"][..., :-1]
    elif what == "dtype":
        ref["mla"]["c_kv"] = ref["mla"]["c_kv"].astype(np.float64)
    else:
        ref = {"k": ref["mla"]["c_kv"], "v": ref["mla"]["c_kv"]}
    with pytest.raises(TypeError if what == "dtype" else ValueError):
        cache_from_reference(ref, cfg, "cpu")


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_policy_from_reference_maps_pallas_to_cuda(impl):
    pol = policy_from_reference(RefPolicy(attention_impl=impl, attn_chunk=32,
                                          kv_cache_dtype="int8"))
    assert pol.attention_impl == {"pallas": "cuda"}.get(impl, impl)
    assert (pol.attn_chunk, pol.kv_cache_dtype) == (32, "int8")


@pytest.mark.parametrize("arch", ["llama3.2-3b", "paligemma-3b", "musicgen-medium"])
@pytest.mark.parametrize("step", [0, 3])
def test_make_batch_is_byte_identical_to_reference(arch, step):
    want = ref_make_batch(ref_smoke_variant(ref_get_arch(arch)), 3, 40, step, seed=7)
    got = make_batch(smoke_variant(get_arch(arch)), 3, 40, step, seed=7)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k


def test_synthetic_stream_matches_reference():
    ref = RefStream(ref_smoke_variant(ref_get_arch(ARCH)), 2, 8, seed=3).at_step(4)
    port = SyntheticStream(smoke_variant(get_arch(ARCH)), 2, 8, seed=3).at_step(4)
    for _ in range(3):
        a, b = next(ref), next(port)
        assert a["tokens"].tobytes() == b["tokens"].tobytes()
    assert port.step == ref.step == 7


def _serve_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args], env=env,
                          capture_output=True, text=True, timeout=300)


def test_serve_cli_on_the_cpu_prints_its_two_lines():
    out = _serve_cli("--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                     "--prompt-len", "16", "--gen-len", "4")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert re.fullmatch(r"arch=llama3\.2-3b-smoke prefill 2x16 in [\d.]+s; decoded 8 tokens "
                        r"in [\d.]+s \([\d.]+ tok/s on cpu\)", lines[-2]), lines
    tokens = re.fullmatch(r"sample tokens: \[([\d, ]+)\]", lines[-1])
    assert tokens and len(tokens.group(1).split(",")) == 4


# the moe (MLA), vlm and audio families: a prompt of 16 positions (paligemma:
# 8 patch embeddings + 8 text tokens) and 4 greedy steps; musicgen prints
# the first 8 of its 4 x 4 codebook tokens
@pytest.mark.parametrize("arch,n_sample", [("deepseek-v2-lite-16b", 4), ("paligemma-3b", 4),
                                           ("musicgen-medium", 8)])
def test_serve_cli_serves_the_moe_vlm_and_audio_families_on_the_cpu(arch, n_sample):
    out = _serve_cli("--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                     "--prompt-len", "16", "--gen-len", "4")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert re.fullmatch(rf"arch={re.escape(arch)}-smoke prefill 2x16 in [\d.]+s; decoded 8 "
                        r"tokens in [\d.]+s \([\d.]+ tok/s on cpu\)", lines[-2]), lines
    tokens = re.fullmatch(r"sample tokens: \[([\d, ]+)\]", lines[-1])
    assert tokens and len(tokens.group(1).split(",")) == n_sample


def test_serve_cli_refuses_a_vlm_prompt_no_longer_than_its_patches():
    """paligemma's prompt is its patch embeddings, then text: a prompt
    length that leaves no text is refused before anything is built."""
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit, match="--prompt-len must exceed 8"):
        main(["--arch", "paligemma-3b", "--smoke", "--device", "cpu", "--prompt-len", "8"])


def test_serve_generate_matches_a_manual_loop_and_samples_reproducibly():
    from repro_torch.launch.serve import generate, load_model, prompt_tokens, serve_policy

    cfg = smoke_variant(get_arch(ARCH))
    model = load_model(cfg, seed=0, device="cpu")
    prompt = prompt_tokens(cfg, 2, 16, seed=0, device="cpu")
    policy = serve_policy(16)
    res = generate(model, cfg, policy, prompt, 4, keep_logits=True)
    assert tuple(res.tokens.shape) == (2, 4) and len(res.step_logits) == 4
    assert tuple(res.prefill_logits.shape) == (2, 16, cfg.vocab_size)
    nxt = res.prefill_logits[:, -1:].argmax(-1).to(torch.int32)
    logits, cache, pos = prefill(model, cfg, policy, prompt, max_len=20)
    step = make_serve_step(cfg, policy)
    for i in range(4):
        lg, cache = step(model, cache, nxt, pos + i)
        torch.testing.assert_close(lg, res.step_logits[i], rtol=0, atol=0)
        nxt = lg[:, -1:].argmax(-1).to(torch.int32)
        assert torch.equal(nxt[:, 0], res.tokens[:, i])
    a = generate(model, cfg, policy, prompt, 3, greedy=False, temperature=0.7, seed=4)
    b = generate(model, cfg, policy, prompt, 3, greedy=False, temperature=0.7, seed=4)
    assert torch.equal(a.tokens, b.tokens)


# name and ids kept from when the planner flags (A.6) and --serve (A.9)
# were refused here; both are ported now, so each flag runs the plan server
# on the CPU, drains it and refuses nothing
@pytest.mark.parametrize("flag,item", [
    pytest.param(["--serve"], "A.9", id="flag2-A.9"),
    pytest.param(["--serve", "--serve-port", "0"], "A.9", id="flag3-A.9")])
def test_serve_cli_refuses_what_the_port_lacks(flag, item, capsys):
    from repro_torch.launch.serve import main

    main(["--arch", ARCH, "--smoke", "--device", "cpu", "--plan-backend", "torch",
          "--serve-duration", "0.2", *flag])
    out = capsys.readouterr()
    assert f"ROADMAP {item}" not in out.err
    assert "plan server: http://localhost:" in out.out
    assert "backend=torch on cpu" in out.out
    assert "drained. cache: 0 hit / 0 miss" in out.out


def test_serve_cli_trace_out_records_the_prefill_and_decode_spans(tmp_path, capsys):
    import json

    from repro_torch.launch.serve import main

    out = tmp_path / "trace.json"
    main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "1", "--prompt-len", "8",
          "--gen-len", "2", "--trace-out", str(out)])
    events = json.loads(out.read_text())["traceEvents"]
    assert [e["name"] for e in events if e.get("ph") == "X"] == ["serve.prefill", "serve.decode"]
    assert "(2 spans)" in capsys.readouterr().out


# ---------------------------------------------------------------- the planner flags

# one architecture of each family the port serves
FAMILY_ARCHS = ["llama3.2-3b", "mamba2-2.7b", "hymba-1.5b", "deepseek-v2-lite-16b",
                "paligemma-3b", "musicgen-medium"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_flops_counts_match_reference(arch):
    from repro.models import flops as ref_flops
    from repro_torch.models import flops

    for ref_cfg, cfg in ((ref_get_arch(arch), get_arch(arch)),
                         (ref_smoke_variant(ref_get_arch(arch)), smoke_variant(get_arch(arch)))):
        assert dataclasses.asdict(flops.param_counts(cfg)) == dataclasses.asdict(
            ref_flops.param_counts(ref_cfg))
        for seq in (None, 16, 512, 4096):
            assert flops.train_flops_per_token(cfg, seq) == ref_flops.train_flops_per_token(
                ref_cfg, seq)
        for ctx in (1, 544, 4096):
            assert flops.decode_flops_per_token(cfg, ctx) == ref_flops.decode_flops_per_token(
                ref_cfg, ctx)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_batch_load_spec_matches_reference(arch):
    for batch, seq in ((4, 512), (2, 16)):
        want = dataclasses.asdict(ref_batch_load_spec(ref_get_arch(arch), batch, seq))
        assert dataclasses.asdict(batch_load_spec(get_arch(arch), batch, seq)) == want
        stream = SyntheticStream(get_arch(arch), batch, seq, seed=3)
        ref_stream = RefStream(ref_get_arch(arch), batch, seq, seed=3)
        assert dataclasses.asdict(stream.peek_load_spec()) == dataclasses.asdict(
            ref_stream.peek_load_spec())


PLAN_ARGS = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "8", "--gen-len", "2"]
_MS = r"([0-9.eE+-]+)ms"
# the reference CLI's runs: (--plan-backend, --topology, --return-ratio);
# the first also sweeps --auto-t 3
REF_PLANS = [("batched", "chain", 0.0), ("auto", "star", 0.5), ("batched", "chain", 0.25)]

# A child process runs the reference's serving CLI: its engine needs the
# jax.experimental.enable_x64 alias under the installed JAX, which is never
# set in the pytest process.  Its Planner is wrapped to record what the
# CLI's own code hands it (platform, loads) and what it returns, at full
# precision (the CLI prints makespans to 3 decimals).
REF_CLI_CHILD = r"""
import contextlib, dataclasses, io, json, sys
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
import repro.launch.serve as serve

runs = []
class Recording(serve.Planner):
    def __init__(self, stages, links, **kw):
        super().__init__(stages, links, **kw)
        self.rec = dict(stages=[dataclasses.asdict(x) for x in stages],
                        links=[dataclasses.asdict(x) for x in links], plans=[])
        runs.append(self.rec)
    def plan(self, loads, **kw):
        p = super().plan(loads, **kw)
        self.rec["loads"] = [dataclasses.asdict(x) for x in loads]
        self.rec["plans"].append(p.makespan)
        return p
    def plan_auto_T(self, loads, **kw):
        r = super().plan_auto_T(loads, **kw)
        self.rec["auto_t"] = dict(t_star=r.t_star,
                                  makespans={str(q): v for q, v in r.makespans.items()},
                                  costs={str(q): v for q, v in r.costs.items()})
        return r
serve.Planner = Recording
for argv in json.loads(sys.argv[1]):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(argv)
    runs[-1]["stdout"] = out.getvalue()
print(json.dumps(runs))
"""


@pytest.fixture(scope="module")
def ref_cli():
    """The reference CLI's ``--plan 2`` runs of ``REF_PLANS``, recorded in a
    child process: {(backend, topology, return_ratio): record}."""
    import json

    argvs = [PLAN_ARGS + ["--plan", "2", "--plan-backend", b, "--topology", t,
                          "--return-ratio", str(r)] + (["--auto-t", "3"] if i == 0 else [])
             for i, (b, t, r) in enumerate(REF_PLANS)]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", REF_CLI_CHILD, json.dumps(argvs)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    runs = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(runs) == len(REF_PLANS)
    return dict(zip(REF_PLANS, runs))


def _schedule(out):
    return re.findall(r"  load \d installment \d: requests/stage=\[.*\]", out)


def _run_cli(args, capsys):
    from repro_torch.launch.serve import main

    main(args)
    return capsys.readouterr().out


@pytest.mark.parametrize("backend,ref_backend,topology,return_ratio", [
    ("torch", "batched", "chain", 0.0), ("auto", "auto", "star", 0.5),
    ("batched", "batched", "chain", 0.25)])
def test_serve_cli_plan_matches_reference(backend, ref_backend, topology, return_ratio, capsys,
                                          ref_cli):
    """``--plan 2``: the port's platform and loads are those the reference
    CLI builds, its printed schedule is the reference's, and its makespan
    (and the replanning tick's) the reference CLI's within 1e-9.  The
    port's ``torch`` (and the alias ``batched``) against the reference's
    engine backend ``batched``, ``auto`` against ``auto``."""
    from repro_torch.launch.serve import PLAN_BACKENDS, plan_inputs

    ref = ref_cli[(ref_backend, topology, return_ratio)]
    mine = plan_inputs(smoke_variant(get_arch(ARCH)), 2, 8, 2, 2, return_ratio)
    for got, key in zip(mine, ("stages", "links", "loads")):
        assert [dataclasses.asdict(x) for x in got] == ref[key]
    want = ref["plans"][0] * 1e3
    assert ref["plans"][1] == ref["plans"][0]

    out = _run_cli(PLAN_ARGS + ["--device", "cpu", "--plan", "2", "--plan-backend", backend,
                                "--topology", topology, "--return-ratio", str(return_ratio)],
                   capsys)
    head_re = (rf"DLT plan for 2 request batches over 4 {topology} stages: makespan="
               rf"{_MS} \(backend=([\w+]+),")
    head, ref_head = re.search(head_re, out), re.search(head_re, ref["stdout"])
    assert head and ref_head, out
    assert abs(float(head.group(1)) - want) <= 1e-9 * want
    assert head.group(2) == PLAN_BACKENDS.get(ref_head.group(2), ref_head.group(2))
    assert len(_schedule(out)) == 4 and _schedule(out) == _schedule(ref["stdout"])
    tick_re = rf"replan tick: makespan={_MS} cache_hit=(True|False)"
    tick, ref_tick = re.search(tick_re, out), re.search(tick_re, ref["stdout"])
    assert tick and ref_tick and abs(float(tick.group(1)) - want) <= 1e-9 * want
    assert tick.group(2) == ref_tick.group(2)  # engine backends hit the cache


def test_serve_cli_auto_t_matches_reference(capsys, ref_cli):
    """``--plan 2 --auto-t 3``: every rung's makespan and the cost-aware T*
    as the reference CLI's engine sweep (``plan_auto_T``, backend
    "batched")."""
    ref = ref_cli[REF_PLANS[0]]["auto_t"]
    out = _run_cli(PLAN_ARGS + ["--device", "cpu", "--plan", "2", "--auto-t", "3"], capsys)
    sweep = {int(q): (float(mk), float(extra))
             for q, mk, extra in re.findall(rf"q=(\d+): {_MS}\+{_MS}", out)}
    assert sorted(sweep) == [1, 2, 3]
    for q, (mk, extra) in sweep.items():
        want_mk = ref["makespans"][str(q)] * 1e3
        assert abs(mk - want_mk) <= 1e-9 * want_mk
        assert abs(mk + extra - ref["costs"][str(q)] * 1e3) <= 1e-9 * want_mk
    star = re.search(rf"-> T\* = (\d+) installments/load, cost-aware makespan {_MS}", out)
    assert star and int(star.group(1)) == ref["t_star"]
    want_cost = ref["costs"][str(ref["t_star"])] * 1e3
    assert abs(float(star.group(2)) - want_cost) <= 1e-9 * want_cost
