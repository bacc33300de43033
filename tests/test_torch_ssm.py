"""The port's Mamba-2 path against the JAX package's: the SSD scan (the
kernel's plain version and its wrapper on the CPU), the mixer and its decode
step, and the mamba2-2.7b and hymba-1.5b smoke variants served end to end.

Inputs are made with NumPy from a seed and handed to both packages; the
reference's parameters (``init_params``, float32) are carried across with
``params_from_reference``.  The reference's Pallas kernel runs in interpret
mode, as its own tests run it.

Tolerances, each with its reason:

* SSD scan against the reference's Pallas kernel and ``ref.ssd_scan_ref``:
  the reference's own bars for its kernel (``tests/test_kernels.py``):
  float32 3e-4, bfloat16 5e-2.  The port sums the log-decay in float64, the
  reference in float32 (up to ~1e-5 relative in exp at these lengths), and
  the reference oracle is the sequential recurrence.
* SSD scan against the model's chunked form (both packages): the reference's
  bar for that comparison, 2e-4.
* SSD scan at a chunk of 4,096: the oracle's float32 bar, 3e-4; against the
  reference's kernel 1e-3 of max |y|, since that kernel sums the log-decay
  of a chunk in float32 (|cum| reaches ~3,000 here, ulp 2.4e-4, so its
  decay factors are off by ~1e-4 relative; 7.7e-3 of 104 measured against
  its own oracle).
* The mixer and its decode step, float32: the same function with sums in
  another order, 1e-5; the kernel pairs (the reference's Pallas kernel and
  the port's ``"cuda"`` impl, whose plain version runs here) 1e-4, for the
  float32 cumsum of the reference's kernel (|cum| up to ~90 here, ulp 8e-6).
* Serving, float32: prefill logits and caches 1e-4, each step's logits 1e-4
  (decode steps build on the prefill's cache); greedy tokens identical.
"""

from __future__ import annotations

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
from repro.kernels import ops, ref
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models import ssm as ref_ssm
from repro.runtime import make_serve_step as ref_make_serve_step
from repro_torch.config import get_arch, smoke_variant
from repro_torch.convert import cache_from_reference, params_from_reference, policy_from_reference
from repro_torch.kernels import (launch_counts, reset_launch_counts, ssd_scan, ssd_scan_plain,
                                 ssd_scan_tolerance)
from repro_torch.kernels.ssd_scan import kernel_size, pick_chunk
from repro_torch.models import init_cache, init_params, prefill, ssm
from repro_torch.runtime import make_serve_step

REPO = Path(__file__).resolve().parents[1]

# the reference's SSD_CASES (tests/test_kernels.py)
SSD_CASES = [
    # (b, s, h, p, g, n, chunk)
    (1, 64, 2, 16, 1, 16, 16),
    (2, 128, 4, 32, 1, 32, 32),
    (1, 128, 4, 16, 2, 16, 64),   # multi-group
    (1, 96, 2, 16, 1, 16, 32),    # s % chunk == 0 but != power of two
]
DTYPES = {"float32": (jnp.float32, torch.float32, 3e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _np32(x):
    if isinstance(x, torch.Tensor):  # a copy: the port's decode step writes its cache in place
        return x.float().numpy().copy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ssd_arrays(case, seed=4):
    b, s, h, p, g, n, _ = case
    rng = np.random.default_rng(seed + sum(case))
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)  # softplus
    A = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    D = np.linspace(0.5, 1.5, h).astype(np.float32)
    return x, dt, A, B, C, D


@functools.lru_cache(maxsize=None)
def _ssd_case(case, dtype):
    """The port's inputs, and the reference kernel's and oracle's outputs."""
    jdt, tdt, _ = DTYPES[dtype]
    x, dt, A, B, C, D = _ssd_arrays(case)
    jin = [jnp.asarray(x).astype(jdt), jnp.asarray(dt), jnp.asarray(A),
           jnp.asarray(B).astype(jdt), jnp.asarray(C).astype(jdt), jnp.asarray(D)]
    tin = [torch.from_numpy(x).to(tdt), torch.from_numpy(dt), torch.from_numpy(A),
           torch.from_numpy(B).to(tdt), torch.from_numpy(C).to(tdt), torch.from_numpy(D)]
    kern = ops.ssd_scan(*jin, chunk=case[6], interpret=True)
    oracle = ref.ssd_scan_ref(*jin)
    return tin, _np32(kern), _np32(oracle)


# head dims and state sizes the kernels run at the next instantiated size
# (16 ... 256): (48, 80), (24, 48) with two groups, (64, 256)
SSD_SIZE_CASES = [
    (1, 64, 2, 48, 1, 80, 32),
    (1, 64, 2, 24, 2, 48, 16),
    (1, 32, 2, 64, 1, 256, 16),
]


SSD_IMPLS = {
    "plain": lambda args, chunk: ssd_scan_plain(*args, chunk=pick_chunk(args[0].shape[1], chunk)),
    "wrapper": lambda args, chunk: ssd_scan(*args, chunk=chunk),
}


@pytest.mark.parametrize("impl", sorted(SSD_IMPLS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", SSD_CASES + SSD_SIZE_CASES, ids=lambda c: "x".join(map(str, c)))
def test_ssd_scan_matches_pallas_and_oracle(case, dtype, impl):
    args, kern, oracle = _ssd_case(case, dtype)
    out = SSD_IMPLS[impl](args, case[6])
    assert out.dtype == args[0].dtype and tuple(out.shape) == tuple(args[0].shape)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np32(out), kern, rtol=tol, atol=tol)
    np.testing.assert_allclose(_np32(out), oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_ssd_scan_plain_matches_both_chunked_forms(case):
    """The plain version against the model's chunked form, the reference's
    and the port's (which repeat B/C over heads; the plain version does
    not), at the same chunk."""
    x, dt, A, B, C, D = _ssd_arrays(case)
    chunk = case[6]
    want = np.asarray(ref_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C, D)), chunk=chunk))
    tin = [torch.from_numpy(a) for a in (x, dt, A, B, C, D)]
    np.testing.assert_allclose(ssd_scan_plain(*tin, chunk=chunk).numpy(), want, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(ssm.ssd_chunked(*tin, chunk=chunk).numpy(), want, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("case", SSD_CASES[:2], ids=lambda c: "x".join(map(str, c)))
def test_ssd_reference_and_decode_step_match_the_reference(case):
    x, dt, A, B, C, D = _ssd_arrays(case)
    want = np.asarray(ref_ssm.ssd_reference(*map(jnp.asarray, (x, dt, A, B, C, D))))
    tin = [torch.from_numpy(a) for a in (x, dt, A, B, C, D)]
    np.testing.assert_allclose(ssm.ssd_reference(*tin).numpy(), want, rtol=1e-5, atol=1e-5)
    b, _, h, p, g, n, _ = case
    state = np.random.default_rng(1).standard_normal((b, h, p, n)).astype(np.float32)
    step = [a[:, 3] for a in (x, dt, B, C)]
    ws, wy = ref_ssm.ssd_decode_step(jnp.asarray(state), *map(jnp.asarray, step[:2]),
                                     jnp.asarray(A), *map(jnp.asarray, step[2:]), jnp.asarray(D))
    gs, gy = ssm.ssd_decode_step(torch.from_numpy(state), *map(torch.from_numpy, step[:2]),
                                 tin[2], *map(torch.from_numpy, step[2:]), tin[5])
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=1e-5, atol=1e-5)


def test_ssd_scan_reads_strided_slices_like_copies():
    """x, B and C as slices of one [b, s, conv_dim] tensor (as the mixer
    hands them over) give what contiguous copies give."""
    b, s, h, p, g, n = 2, 64, 4, 16, 1, 32
    rng = np.random.default_rng(9)
    xbc = torch.from_numpy(rng.standard_normal((b, s, h * p + 2 * g * n)).astype(np.float32))
    x = xbc[..., :h * p].reshape(b, s, h, p)
    B = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
    C = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    assert not x.is_contiguous() and not B.is_contiguous()
    dt = torch.nn.functional.softplus(torch.from_numpy(rng.standard_normal((b, s, h))
                                                       .astype(np.float32)))
    A, D = -torch.linspace(1.0, 16.0, h), torch.ones(h)
    got = ssd_scan(x, dt, A, B, C, D, chunk=16)
    want = ssd_scan(x.contiguous(), dt, A, B.contiguous(), C.contiguous(), D, chunk=16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_scan_at_a_chunk_of_4096_matches_pallas_and_oracle(dtype):
    """A chunk past the kernels' shared memory (its cumsum in the
    workspace on the card): 2 chunks of 4,096 at 2 heads."""
    case = (1, 8192, 2, 16, 1, 16, 4096)
    args, kern, oracle = _ssd_case(case, dtype)
    out = _np32(ssd_scan(*args, chunk=4096))
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(out, oracle, rtol=tol, atol=tol)
    bar = max(tol, 1e-3 * np.abs(kern).max()) if dtype == "float32" else tol
    np.testing.assert_allclose(out, kern, rtol=tol, atol=bar)


def test_ssd_scan_at_a_prime_length_matches_the_oracle():
    """S = 4,099, a prime: the reference's chunk picker gives chunks of 1,
    4,099 of them (the kernel's grid loops past 65,535 of them at batch 16
    on the card).  Against ``ref.ssd_scan_ref``: interpret mode would run
    4,099 grid steps."""
    case = (2, 4099, 2, 16, 1, 16, 256)
    assert pick_chunk(4099, 256) == 1
    x, dt, A, B, C, D = _ssd_arrays(case)
    want = np.asarray(ref.ssd_scan_ref(*map(jnp.asarray, (x, dt, A, B, C, D))))
    got = ssd_scan(*map(torch.from_numpy, (x, dt, A, B, C, D)), chunk=256).numpy()
    np.testing.assert_allclose(got, want, rtol=DTYPES["float32"][2], atol=DTYPES["float32"][2])


@pytest.mark.parametrize("n,size", [(1, 16), (16, 16), (24, 32), (48, 64), (80, 128),
                                    (128, 128), (129, 256), (200, 256), (256, 256), (257, None),
                                    (0, None)])
def test_ssd_kernel_size_takes_every_size_to_256(n, size):
    if size is None:
        with pytest.raises(ValueError, match="from 1 to 256"):
            kernel_size(n)
    else:
        assert kernel_size(n) == size


@pytest.mark.parametrize("n,target", [(512, 256), (96, 64), (480, 256), (7, 4), (8, 64)])
def test_pick_chunk_is_the_references_pick_block(n, target):
    assert pick_chunk(n, target) == ops._pick_block(n, target)


def _bad_ssd():
    x, dt = torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 4)
    A, D, B = torch.zeros(4), torch.zeros(4), torch.zeros(1, 8, 2, 16)
    return {
        "rank": ((x[0], dt, A, B, B, D), ValueError),
        "bc_shape": ((x, dt, A, B, B[:, :4], D), ValueError),
        "groups": ((x, dt, A, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16), D),
                   ValueError),
        "dt_shape": ((x, dt[:, :4], A, B, B, D), ValueError),
        "dtype": ((x.double(), dt, A, B.double(), B.double(), D), TypeError),
        "mixed_dtype": ((x, dt, A, B.bfloat16(), B, D), TypeError),
    }


@pytest.mark.parametrize("what", sorted(_bad_ssd()))
def test_ssd_scan_wrapper_rejects(what):
    args, exc = _bad_ssd()[what]
    with pytest.raises(exc):
        ssd_scan(*args)


def test_ssd_scan_counts_no_launch_on_the_cpu():
    reset_launch_counts()
    args, _, _ = _ssd_case(SSD_CASES[0], "float32")
    ssd_scan(*args, chunk=16)
    assert launch_counts()["ssd_scan"] == 0


# ---------------------------------------------------------------- the mixer

ARCHS = ["mamba2-2.7b", "hymba-1.5b"]
# (reference impl, port impl)
MIXER_IMPLS = [("reference", "reference"), ("chunked", "chunked"), ("pallas", "cuda")]
B_, PROMPT, STEPS, MAX_LEN = 2, 16, 6, 24


@functools.lru_cache(maxsize=None)
def _model(arch):
    ref_cfg = ref_smoke_variant(ref_get_arch(arch))
    cfg = smoke_variant(get_arch(arch))
    params = ref_init_params(ref_cfg, RefPolicy(), seed=5, dtype=jnp.float32)
    params_np = jax.tree.map(np.asarray, params)
    return ref_cfg, cfg, params, params_np, params_from_reference(params_np, cfg, "cpu")


@pytest.mark.parametrize("impls", MIXER_IMPLS, ids=lambda p: p[1])
@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_mixer_matches_reference(arch, impls):
    ref_cfg, cfg, params, _, model = _model(arch)
    layer = 1
    p_ref = jax.tree.map(lambda a: a[layer], params["blocks"]["mamba"])
    x = np.random.default_rng(3).standard_normal((B_, PROMPT, cfg.d_model)).astype(np.float32)
    want = np.asarray(ref_ssm.mamba_mixer(p_ref, jnp.asarray(x), ref_cfg, impl=impls[0]))
    got = ssm.mamba_mixer(model.blocks[layer].mamba, torch.from_numpy(x), cfg, impl=impls[1])
    tol = 1e-4 if impls[1] == "cuda" else 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_decode_step_matches_reference_and_writes_the_cache(arch):
    ref_cfg, cfg, params, _, model = _model(arch)
    p_ref = jax.tree.map(lambda a: a[0], params["blocks"]["mamba"])
    rng = np.random.default_rng(4)
    cache_ref = ref_ssm.init_mamba_cache(ref_cfg, B_, dtype=jnp.float32)
    cache_np = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in cache_ref.items()}
    x = rng.standard_normal((B_, 1, cfg.d_model)).astype(np.float32)
    want, new = ref_ssm.mamba_decode_step(p_ref, jnp.asarray(x),
                                          jax.tree.map(jnp.asarray, cache_np), ref_cfg)
    cache = {k: torch.from_numpy(v.copy()) for k, v in cache_np.items()}
    got = ssm.mamba_decode_step(model.blocks[0].mamba, torch.from_numpy(x), cache, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for k in ("conv", "state"):  # written in place
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(new[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------- serving

SERVE_CASES = [(arch, impl) for arch in ARCHS for impl in ("pallas", "chunked", "naive")]
SERVE_IDS = ["-".join(c) for c in SERVE_CASES]


def _flat(cache: dict, prefix="") -> dict:
    """Leaves of a (nested) cache by dotted name, as float32 NumPy."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = _np32(v)
    return out


@functools.lru_cache(maxsize=None)
def _serve(case):
    """Both packages through prefill + STEPS decode steps on the same
    parameters and prompt; the port is fed the reference's tokens."""
    arch, impl = case
    ref_cfg, cfg, params, _, model = _model(arch)
    ref_policy = RefPolicy(attention_impl=impl, attn_chunk=PROMPT)
    policy = policy_from_reference(ref_policy)
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, size=(B_, PROMPT),
                                              dtype=np.int32)
    ref_out = {"logits": [], "tokens": []}
    lg, cache, pos = ref_prefill(params, ref_cfg, ref_policy, jnp.asarray(toks), max_len=MAX_LEN)
    ref_out["prefill_logits"] = np.asarray(lg)
    ref_out["prefill_cache"] = _flat(jax.tree.map(np.asarray, cache))
    step = jax.jit(ref_make_serve_step(ref_cfg, ref_policy))
    nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
    feed = [np.asarray(nxt)]
    for i in range(STEPS):
        lg, cache = step(params, cache, nxt, jnp.int32(pos + i))
        nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        ref_out["logits"].append(np.asarray(lg))
        ref_out["tokens"].append(np.asarray(nxt))
        feed.append(np.asarray(nxt))
    ref_out["cache"] = _flat(jax.tree.map(np.asarray, cache))

    port = {"logits": [], "tokens": []}
    reset_launch_counts()
    lg, cache, pos = prefill(model, cfg, policy, torch.from_numpy(toks), max_len=MAX_LEN)
    port["prefill_logits"] = _np32(lg)
    port["prefill_cache"] = _flat(cache)
    port["first_token"] = lg[:, -1:].argmax(dim=-1).to(torch.int32).numpy()
    step = make_serve_step(cfg, policy)
    for i in range(STEPS):
        lg, cache = step(model, cache, torch.from_numpy(feed[i].copy()), pos + i)
        port["logits"].append(_np32(lg))
        port["tokens"].append(lg[:, -1:].argmax(dim=-1).to(torch.int32).numpy())
    port["cache"] = _flat(cache)
    port["feed0"] = feed[0]
    port["launches"] = launch_counts()
    return ref_out, port


@pytest.mark.parametrize("case", SERVE_CASES, ids=SERVE_IDS)
def test_ssm_prefill_logits_and_cache_match_reference(case):
    ref_out, port = _serve(case)
    np.testing.assert_allclose(port["prefill_logits"], ref_out["prefill_logits"], rtol=1e-4,
                               atol=1e-4)
    assert set(port["prefill_cache"]) == set(ref_out["prefill_cache"])
    for name, want in ref_out["prefill_cache"].items():
        np.testing.assert_allclose(port["prefill_cache"][name], want.astype(np.float32),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    # ROADMAP C.4: neither package builds the SSM state in its prefill
    assert not port["prefill_cache"]["ssm.state"].any()
    assert not port["prefill_cache"]["ssm.conv"].any()
    assert sum(port["launches"].values()) == 0  # the CPU runs the plain versions


@pytest.mark.parametrize("case", SERVE_CASES, ids=SERVE_IDS)
def test_ssm_decode_steps_and_cache_match_reference(case):
    ref_out, port = _serve(case)
    for i, (got, want) in enumerate(zip(port["logits"], ref_out["logits"])):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
    assert set(port["cache"]) == set(ref_out["cache"])
    for name, want in ref_out["cache"].items():
        np.testing.assert_allclose(port["cache"][name], want.astype(np.float32), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    assert port["cache"]["ssm.state"].any()  # the decode steps did write the state


@pytest.mark.parametrize("case", SERVE_CASES, ids=SERVE_IDS)
def test_ssm_greedy_tokens_match_reference(case):
    ref_out, port = _serve(case)
    np.testing.assert_array_equal(port["first_token"], port["feed0"])
    np.testing.assert_array_equal(np.concatenate(port["tokens"], 1),
                                  np.concatenate(ref_out["tokens"], 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_from_reference_carries_the_ssm_cache(arch):
    ref_cfg, cfg, _, _, _ = _model(arch)
    from repro.models import init_cache as ref_init_cache

    rng = np.random.default_rng(2)
    cache_np = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                            jax.tree.map(np.asarray, ref_init_cache(ref_cfg, B_, MAX_LEN,
                                                                    dtype=jnp.float32)))
    cache = cache_from_reference(cache_np, cfg, "cpu")
    want = init_cache(cfg, B_, MAX_LEN, dtype=torch.float32, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), cache) == \
        jax.tree.map(lambda a: tuple(a.shape), want)
    for name, leaf in _flat(cache_np).items():
        np.testing.assert_array_equal(_flat(cache)[name], leaf)
    del cache_np["ssm"]["state"]
    with pytest.raises(ValueError):
        cache_from_reference(cache_np, cfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_references_tree(arch):
    ref_cfg, cfg, _, params_np, _ = _model(arch)
    model = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    for l, blk in enumerate(model.blocks):
        for name, want in params_np["blocks"]["mamba"].items():
            got = getattr(blk.mamba, name)
            assert tuple(got.shape) == want.shape[1:], name
    assert model.blocks[0].mamba.A_log.dtype == torch.float32
    np.testing.assert_allclose(model.blocks[0].mamba.A_log.numpy(),
                               params_np["blocks"]["mamba"]["A_log"][0], rtol=1e-6)
    bf16 = init_params(cfg, seed=0, device="cpu")  # bfloat16 weights, float32 A_log/D/dt_bias
    assert bf16.blocks[0].mamba.w_xbc.dtype == torch.bfloat16
    assert bf16.blocks[0].mamba.dt_bias.dtype == torch.float32


@pytest.mark.parametrize("what,exc", [("shape", ValueError), ("a_log_bf16", TypeError),
                                      ("missing", ValueError)])
def test_params_from_reference_checks_the_mamba_tree(what, exc):
    _, cfg, _, params_np, _ = _model("mamba2-2.7b")
    p = jax.tree.map(lambda a: a, params_np)
    mamba = p["blocks"]["mamba"]
    if what == "shape":
        mamba["w_xbc"] = mamba["w_xbc"][..., :-1]
    elif what == "a_log_bf16":
        mamba["A_log"] = mamba["A_log"].astype(jnp.bfloat16)
    else:
        del mamba["dt_bias"]
    with pytest.raises(exc):
        params_from_reference(p, cfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_serves_the_family_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
                          "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "16",
                          "--gen-len", "4"], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert re.fullmatch(rf"arch={re.escape(arch)}-smoke prefill 2x16 in [\d.]+s; decoded 8 "
                        r"tokens in [\d.]+s \([\d.]+ tok/s on cpu\)", lines[-2]), lines
    tokens = re.fullmatch(r"sample tokens: \[([\d, ]+)\]", lines[-1])
    assert tokens and len(tokens.group(1).split(",")) == 4


def _ssd_exact(x, dt, A, B, C, D):
    """The recurrence step by step in float64 (NumPy)."""
    b, s, h, p = x.shape
    rep = h // B.shape[2]
    Bh, Ch = np.repeat(B, rep, axis=2), np.repeat(C, rep, axis=2)
    state = np.zeros((b, h, p, B.shape[-1]))
    y = np.empty((b, s, h, p))
    for t in range(s):
        a = np.exp(dt[:, t].astype(np.float64) * A)
        state = state * a[..., None, None] + (x[:, t] * dt[:, t, :, None])[..., None] \
            * Bh[:, t, :, None, :]
        y[:, t] = np.einsum("bhpn,bhn->bhp", state, Ch[:, t]) + x[:, t] * D[:, None]
    return y


@pytest.mark.parametrize("decay", ["model", "weak"])
@pytest.mark.parametrize("case", [(1, 128, 4, 16, 1, 32, 64), (2, 96, 4, 32, 2, 16, 32)],
                         ids=lambda c: "x".join(map(str, c)))
def test_ssd_scan_tolerance_covers_the_plain_versions_rounding(case, decay):
    """Each float32 evaluation lies within half of ssd_scan_tolerance of the
    exact value (the recurrence in float64), at the model's decays
    (A = -1 .. -16) and at weak ones (|dt A| ~ 1e-3, where the carried state
    matters)."""
    b, s, h, p, g, n, chunk = case
    rng = np.random.default_rng(sum(case))
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, h).astype(np.float32) * (1e-3 if decay == "weak" else 1.0)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    D = np.linspace(0.5, 1.5, h).astype(np.float32)
    tin = [torch.from_numpy(a) for a in (x, dt, A, B, C, D)]
    tol = ssd_scan_tolerance(*tin, chunk=chunk).numpy()
    exact = _ssd_exact(x, dt, A.astype(np.float64), B, C, D)
    got = ssd_scan(*tin, chunk=chunk).numpy()
    assert (np.abs(got - exact) <= tol / 2).all(), np.max(np.abs(got - exact) / tol)
    # an O(1) fault (a lost carried state, a wrong decay) is far outside it
    assert (tol < 1e-3 * np.abs(exact).max()).all()


def _tf32(t):
    """float32 rounded to TF32 (10 mantissa bits): to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32_einsum(einsum):
    """A product as the kernel takes it on the tensor cores: each operand
    split as hi = tf32(a), lo = tf32(a - hi), and lo hi + hi lo + hi hi."""
    def product(eq, a, b):
        ah, bh = _tf32(a), _tf32(b)
        al, bl = _tf32(a - ah), _tf32(b - bh)
        return einsum(eq, al, bh) + einsum(eq, ah, bl) + einsum(eq, ah, bh)
    return product


# mamba2-2.7b's and hymba-1.5b's SSD heads (P 64, G 1; N 128 and 16) over a
# 512-token prompt at the models' chunk of 256, narrowed to 4 heads
SPLIT_CASES = {"mamba2": (1, 512, 4, 64, 1, 128, 256), "hymba": (1, 512, 4, 64, 1, 16, 256)}


@pytest.mark.parametrize("decay", ["model", "weak"])
@pytest.mark.parametrize("heads", sorted(SPLIT_CASES))
def test_ssd_scan_tolerance_covers_split_tf32_products(heads, decay, monkeypatch):
    """The chunked form with every product taken as split TF32 (emulated:
    the plain version's four einsums, C Bᵀ, the decayed scores times xbar,
    C s and xbar Bᵀ, each on split operands) lies within ssd_scan_tolerance
    of the float32 plain version, at the model's decays and at weak ones."""
    b, s, h, p, g, n, chunk = SPLIT_CASES[heads]
    rng = np.random.default_rng(s + n + (decay == "weak"))
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, h).astype(np.float32) * (1e-3 if decay == "weak" else 1.0)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    D = np.linspace(0.5, 1.5, h).astype(np.float32)
    tin = [torch.from_numpy(a) for a in (x, dt, A, B, C, D)]
    want = ssd_scan_plain(*tin, chunk=chunk)
    tol = ssd_scan_tolerance(*tin, chunk=chunk)
    monkeypatch.setattr(torch, "einsum", _split_tf32_einsum(torch.einsum))
    got = ssd_scan_plain(*tin, chunk=chunk)
    monkeypatch.undo()
    assert (got != want).any()  # the split ran: its roundings differ from float32's
    diff = (got - want).abs()
    assert (diff <= tol).all(), (diff / tol).max().item()
