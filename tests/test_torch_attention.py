"""The port's attention (the kernels' plain versions and the model's three
implementations) against the JAX package's Pallas kernels in interpret mode
and its ``ref.py`` oracles, on the same inputs made with NumPy from a seed.

Tolerances: float32 to 1e-5 (the same function, sums taken in another
order); bfloat16 to 2e-2 (inputs and outputs rounded to bfloat16, and the
chunked implementation rounds its probabilities to the value dtype before
the second product, as the reference's does).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import (decode_attention, decode_attention_plain, flash_attention,
                                 flash_attention_plain)
from repro_torch.models.attention import attention
from repro_torch.models.attention import decode_attention as model_decode_attention

# the four FLASH_CASES of tests/test_kernels.py, plus a length no tile divides
FLASH_CASES = [
    # (B, Sq, Sk, H, KVH, D, causal, window)
    (1, 128, 128, 4, 2, 32, True, 0),
    (2, 256, 256, 4, 1, 64, True, 0),
    (1, 256, 256, 8, 8, 16, False, 0),
    (1, 256, 256, 4, 2, 32, True, 96),
    (1, 100, 100, 4, 2, 32, True, 0),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _flash_case(case, dtype):
    B, Sq, Sk, H, KVH, D, causal, window = case
    arrays = _arrays(sum(case[:6]), (B, Sq, H, D), (B, Sk, KVH, D), (B, Sk, KVH, D))
    (jq, jk, jv), torch_in = _both(arrays, dtype)
    kern = ops.flash_attention(jq, jk, jv, causal=causal, window=window, interpret=True)
    oracle = ref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    return torch_in, _np32(kern), _np32(oracle)


FLASH_IMPLS = {
    "plain": lambda q, k, v, c, w: flash_attention_plain(q, k, v, causal=c, window=w),
    "wrapper": lambda q, k, v, c, w: flash_attention(q, k, v, causal=c, window=w),
    "naive": lambda q, k, v, c, w: attention(q, k, v, impl="naive", causal=c, window=w),
    "chunked": lambda q, k, v, c, w: attention(q, k, v, impl="chunked", causal=c, window=w,
                                               q_chunk=64 if q.shape[1] % 64 == 0 else 1024,
                                               kv_chunk=64 if q.shape[1] % 64 == 0 else 1024),
    "chunked_noskip": lambda q, k, v, c, w: attention(q, k, v, impl="chunked", causal=c,
                                                      window=w, block_skip=False),
    "cuda": lambda q, k, v, c, w: attention(q, k, v, impl="cuda", causal=c, window=w),
}


@pytest.mark.parametrize("impl", sorted(FLASH_IMPLS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "x".join(map(str, c)))
def test_prefill_attention_matches_pallas_and_oracle(case, dtype, impl):
    (q, k, v), kern, oracle = _flash_case(case, dtype)
    out = FLASH_IMPLS[impl](q, k, v, case[6], case[7])
    assert out.dtype == q.dtype and tuple(out.shape) == tuple(q.shape)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np32(out), kern, rtol=tol, atol=tol)
    np.testing.assert_allclose(_np32(out), oracle, rtol=tol, atol=tol)


DECODE_SHAPE = (2, 4, 2, 32, 256)  # B, H, KVH, D, Smax (as tests/test_kernels.py)


@functools.lru_cache(maxsize=None)
def _decode_case(cache_len, window, dtype):
    B, H, KVH, D, Smax = DECODE_SHAPE
    arrays = _arrays(cache_len + window, (B, 1, H, D), (B, Smax, KVH, D), (B, Smax, KVH, D))
    (jq, jk, jv), torch_in = _both(arrays, dtype)
    kern = ops.decode_attention(jq, jk, jv, cache_len, window=window, block_k=64,
                                interpret=True)
    oracle = ref.decode_attention_ref(jq, jk, jv, cache_len, window=window)
    return torch_in, _np32(kern), _np32(oracle)


def _len32(n):
    return torch.tensor([n], dtype=torch.int32)


DECODE_IMPLS = {
    "plain": lambda q, k, v, n, w: decode_attention_plain(q, k, v, n, window=w),
    "wrapper": lambda q, k, v, n, w: decode_attention(q, k, v, n, window=w),
    "wrapper_len_tensor": lambda q, k, v, n, w: decode_attention(q, k, v, _len32(n), window=w),
    "naive": lambda q, k, v, n, w: model_decode_attention(q, k, v, n, window=w, impl="naive"),
    "chunked": lambda q, k, v, n, w: model_decode_attention(q, k, v, _len32(n), window=w,
                                                            impl="chunked"),
    "cuda": lambda q, k, v, n, w: model_decode_attention(q, k, v, _len32(n), window=w,
                                                         impl="cuda"),
}


@pytest.mark.parametrize("impl", sorted(DECODE_IMPLS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("cache_len", [1, 100, 256])
def test_decode_attention_matches_pallas_and_oracle(cache_len, window, dtype, impl):
    (q, k, v), kern, oracle = _decode_case(cache_len, window, dtype)
    out = DECODE_IMPLS[impl](q, k, v, cache_len, window)
    assert out.dtype == q.dtype and tuple(out.shape) == tuple(q.shape)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np32(out), kern, rtol=tol, atol=tol)
    np.testing.assert_allclose(_np32(out), oracle, rtol=tol, atol=tol)


def _bad_flash():
    q, k, v = (torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16))
    return {
        "rank": ((q[0], k, v), ValueError),
        "kv_shape": ((q, k, v[:, :4]), ValueError),
        "groups": ((torch.zeros(1, 8, 3, 16), k, v), ValueError),
        "dtype": ((q.double(), k.double(), v.double()), TypeError),
        "mixed_dtype": ((q, k.bfloat16(), v), TypeError),
    }


@pytest.mark.parametrize("what", sorted(_bad_flash()))
def test_flash_attention_wrapper_rejects(what):
    args, exc = _bad_flash()[what]
    with pytest.raises(exc):
        flash_attention(*args)


def _bad_decode():
    q, kc = torch.zeros(1, 1, 4, 16), torch.zeros(1, 8, 2, 16)
    return {
        "two_queries": ((torch.zeros(1, 2, 4, 16), kc, kc, 3), ValueError),
        "cache_shape": ((q, kc, kc[:, :4], 3), ValueError),
        "dtype": ((q.bfloat16(), kc, kc, 3), TypeError),
        "len_dtype": ((q, kc, kc, torch.tensor([3])), TypeError),
        "len_float": ((q, kc, kc, 3.0), TypeError),
        "len_numel": ((q, kc, kc, torch.tensor([3, 4], dtype=torch.int32)), TypeError),
    }


@pytest.mark.parametrize("what", sorted(_bad_decode()))
def test_decode_attention_wrapper_rejects(what):
    args, exc = _bad_decode()[what]
    with pytest.raises(exc):
        decode_attention(*args)


def test_wrappers_count_no_launch_on_the_cpu():
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    (q, k, v), _, _ = _flash_case(FLASH_CASES[0], "float32")
    flash_attention(q, k, v)
    decode_attention(q[:, :1], k, v, 5)
    counts = launch_counts()
    assert counts["flash_attention"] == 0 and counts["decode_attention"] == 0
    assert set(counts) == {"simplex_pivot", "asap_replay", "flash_attention", "decode_attention",
                           "ssd_scan", "rms_norm"}
