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
from repro_torch.kernels.decode_attention import (check_decode_layout, decode_cluster,
                                                  decode_shares, decode_split, decode_valid)
from repro_torch.kernels.flash_attention import (check_kernel_layout, kernel_operands,
                                                 kernel_width, workspace_bytes)
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
    (1, 128, 128, 8, 1, 256, True, 0),  # head dim 256, 8 query heads a kv head (paligemma-3b)
    # head dim 256 with 8 query heads a kv head and a window, and Sq != Sk
    # without a mask: the oracle of the card's head-dim-256 kernels
    (1, 256, 256, 8, 1, 256, True, 96),
    (1, 128, 256, 4, 2, 256, False, 0),
    # head dims the kernels run at the next instantiated width: kimi-k2-1t-a32b's
    # 112 at its 8 query heads a kv head, causal and with a window over a
    # length no tile divides; 80
    (1, 256, 256, 8, 1, 112, True, 0),
    (1, 100, 100, 8, 1, 112, True, 96),
    (1, 128, 128, 4, 2, 80, True, 0),
    # any head dim up to 256: 8 (width 16), SigLIP-so400m's 72 and 100
    # (width 128; bfloat16 rows of 200 bytes, which the wrapper copies into
    # padded rows on the card), 192 on the head-dim-256 kernels; GQA, a
    # window, a length no tile divides, unmasked Sq != Sk
    (1, 128, 128, 4, 2, 8, True, 0),
    (1, 128, 128, 8, 2, 72, True, 32),
    (1, 100, 100, 4, 2, 100, True, 0),
    (1, 128, 192, 8, 1, 192, False, 0),
    (1, 128, 128, 8, 1, 192, True, 64),
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


# paligemma-3b's decode heads: head dim 256, 8 query heads on one kv head
DECODE_SHAPE_256 = (2, 8, 1, 256, 192)
# kimi-k2-1t-a32b's grouping, 8 query heads a kv head, at its head dim 112
DECODE_SHAPE_112 = (2, 8, 1, 112, 192)
# any head dim up to 256: 8, SigLIP-so400m's 72, 100, 192 (the head-dim-256
# kernel's); GQA
DECODE_SHAPES_ANY = [(2, 4, 2, 8, 192), (2, 4, 2, 72, 192), (2, 8, 1, 100, 192),
                     (2, 8, 1, 192, 192)]


@functools.lru_cache(maxsize=None)
def _decode_case(cache_len, window, dtype, shape=DECODE_SHAPE):
    B, H, KVH, D, Smax = shape
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


@pytest.mark.parametrize("impl", sorted(DECODE_IMPLS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("cache_len", [1, 150])
def test_decode_attention_head_dim_256_matches_pallas_and_oracle(cache_len, window, dtype, impl):
    (q, k, v), kern, oracle = _decode_case(cache_len, window, dtype, DECODE_SHAPE_256)
    out = DECODE_IMPLS[impl](q, k, v, cache_len, window)
    assert out.dtype == q.dtype and tuple(out.shape) == tuple(q.shape)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np32(out), kern, rtol=tol, atol=tol)
    np.testing.assert_allclose(_np32(out), oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("impl", sorted(DECODE_IMPLS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("cache_len", [1, 150])
def test_decode_attention_head_dim_112_matches_pallas_and_oracle(cache_len, window, dtype, impl):
    (q, k, v), kern, oracle = _decode_case(cache_len, window, dtype, DECODE_SHAPE_112)
    out = DECODE_IMPLS[impl](q, k, v, cache_len, window)
    assert out.dtype == q.dtype and tuple(out.shape) == tuple(q.shape)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np32(out), kern, rtol=tol, atol=tol)
    np.testing.assert_allclose(_np32(out), oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("impl", sorted(DECODE_IMPLS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("cache_len", [1, 150])
@pytest.mark.parametrize("shape", DECODE_SHAPES_ANY, ids=lambda s: f"D{s[3]}")
def test_decode_attention_any_head_dim_matches_pallas_and_oracle(shape, cache_len, window,
                                                                 dtype, impl):
    (q, k, v), kern, oracle = _decode_case(cache_len, window, dtype, shape)
    out = DECODE_IMPLS[impl](q, k, v, cache_len, window)
    assert out.dtype == q.dtype and tuple(out.shape) == tuple(q.shape)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np32(out), kern, rtol=tol, atol=tol)
    np.testing.assert_allclose(_np32(out), oracle, rtol=tol, atol=tol)


# every head dim from 1 to 256 runs at the next instantiated width; others refused
@pytest.mark.parametrize("D,width", [(16, 16), (32, 32), (48, 64), (64, 64), (80, 128),
                                     (96, 128), (112, 128), (128, 128), (256, 256),
                                     (8, 16), (24, 32), (120, 128), (144, 256),
                                     (192, 256), (512, None), (0, None)])
def test_kernel_width_takes_every_head_dim_up_to_256(D, width):
    if width is None:
        with pytest.raises(ValueError, match="head dims"):
            kernel_width(D)
    else:
        assert kernel_width(D) == width


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


def _fused(B, S, H, KVH, D, dtype=torch.float32):
    """q, k and v as views of one fused projection [B, S, (H + 2 KVH) D]."""
    qkv = torch.zeros(B, S, (H + 2 * KVH) * D, dtype=dtype)
    return (qkv[..., :H * D].view(B, S, H, D), qkv[..., H * D:(H + KVH) * D].view(B, S, KVH, D),
            qkv[..., (H + KVH) * D:].view(B, S, KVH, D))


def _layouts():
    """(q, k, v) laid out as the kernel takes them (``None``), or not (the
    words its refusal must contain)."""
    B, S, H, KVH, D = 2, 8, 4, 2, 16
    fused = _fused(B, S, H, KVH, D)
    k, v = torch.zeros(B, S, KVH, D), torch.zeros(B, S, KVH, D)
    q = torch.zeros(B, S, H, D)
    flat = torch.zeros(B * S * H * D + 1)
    return {
        "contiguous": ((q, k, v), None),
        "fused_view": (fused, None),
        "bf16_d16": ((q.bfloat16(), k.bfloat16(), v.bfloat16()), None),
        "size1_odd_stride": ((torch.zeros(H * D).as_strided((1, 1, H, D), (3, 5, D, 1)),
                              k[:1, :1], v[:1, :1]), None),
        "row_stride_12_bytes": ((torch.zeros(B, S, H, D + 3)[..., :D], k, v),
                                "multiples of 16 bytes"),
        "bf16_head_stride": ((torch.zeros(B, S, H, D + 4).bfloat16()[..., :D], k.bfloat16(),
                              v.bfloat16()), "multiples of 16 bytes"),
        "misaligned_base": ((flat[1:].view(B, S, H, D), k, v), "16-byte-aligned"),
        "head_dim_112": ((torch.zeros(B, S, H, 112), torch.zeros(B, S, KVH, 112),
                          torch.zeros(B, S, KVH, 112)), None),
        "head_dim_80_bf16": ((torch.zeros(B, S, H, 80).bfloat16(),
                              torch.zeros(B, S, KVH, 80).bfloat16(),
                              torch.zeros(B, S, KVH, 80).bfloat16()), None),
        "head_dim_48": ((torch.zeros(B, S, H, 48), torch.zeros(B, S, KVH, 48),
                         torch.zeros(B, S, KVH, 48)), None),
        "head_dim": ((torch.zeros(B, S, H, 320), torch.zeros(B, S, KVH, 320),
                      torch.zeros(B, S, KVH, 320)), "head dims"),
        "head_dim_72": ((torch.zeros(B, S, H, 72), torch.zeros(B, S, KVH, 72),
                         torch.zeros(B, S, KVH, 72)), None),
        "head_dim_192_bf16": ((torch.zeros(B, S, H, 192).bfloat16(),
                               torch.zeros(B, S, KVH, 192).bfloat16(),
                               torch.zeros(B, S, KVH, 192).bfloat16()), None),
        # rows of 200 / 28 bytes: copied into padded rows, whatever the strides
        "head_dim_100_bf16": ((torch.zeros(B, S, H, 100).bfloat16(),
                               torch.zeros(B, S, KVH, 100).bfloat16(),
                               torch.zeros(B, S, KVH, 100).bfloat16()), None),
        "head_dim_100_bf16_fused": (_fused(B, S, H, KVH, 100, torch.bfloat16), None),
        "head_dim_7": ((torch.zeros(B, S, H, 7), torch.zeros(B, S, KVH, 7),
                        torch.zeros(B, S, KVH, 7)), None),
        "last_dim_stride": ((q.transpose(2, 3).contiguous().transpose(2, 3), k, v),
                            "contiguous last dimension"),
        "kv_strides_differ": ((q, k, torch.zeros(B, KVH, S, D).transpose(1, 2)),
                              "equal strides"),
    }


@pytest.mark.parametrize("what", sorted(_layouts()))
def test_flash_kernel_layout_check(what):
    """What the kernel's TMA copies take in place, checked on CPU tensors:
    the check the wrapper runs before every launch on the card, reading the
    tensors that pass in place and copying the rest (but a head dim above
    256, which it refuses)."""
    args, words = _layouts()[what]
    if words is None:
        check_kernel_layout(*args)
    else:
        with pytest.raises(ValueError, match=words):
            check_kernel_layout(*args)


@pytest.mark.parametrize("what", sorted(w for w, (_, words) in _layouts().items()
                                         if words is None))
def test_flash_kernel_operands_are_what_tma_reads(what):
    """Every layout the kernel takes: the tensors themselves, which TMA
    reads in place, or, where a row of the head dim is no whole number of
    16-byte units (bfloat16 at 100, float32 at 7), copies equal to them
    whose rows are padded to 16 bytes, 16-byte aligned."""
    args, _ = _layouts()[what]
    ops = kernel_operands(*args)
    padded = (args[0].shape[-1] * args[0].element_size()) % 16 != 0
    for t, o in zip(args, ops):
        assert o.shape == t.shape and torch.equal(o, t)
        assert (o.data_ptr() != t.data_ptr()) == padded
        if padded:
            assert o.stride(-1) == 1 and o.data_ptr() % 16 == 0
            assert all(st > 0 and (st * o.element_size()) % 16 == 0 for st in o.stride()[:3])


@pytest.mark.parametrize("what", sorted(w for w, (_, words) in _layouts().items()
                                         if words is not None))
def test_flash_kernel_operands_copy_no_refused_layout(what):
    """A layout the kernel refuses at a head dim whose rows are whole
    16-byte units (a misaligned view, odd strides, k and v apart) is handed
    back as it is, not copied, so the wrapper's check raises on it before a
    launch: a layout regression in the model shows as an error, not as
    copies in every prefill."""
    args, words = _layouts()[what]
    ops = kernel_operands(*args)
    assert all(o is t for t, o in zip(args, ops))
    with pytest.raises(ValueError, match=words):
        check_kernel_layout(*ops)


@pytest.mark.parametrize("shape,want", [
    # (B, KVH, Sk, D, dtype, tile): float32 at head dim 256 splits every key
    # of every kv head into 4 x 256 float32, padded to whole tiles
    ((4, 1, 512, 256, torch.float32, 16), 4 * 512 * 4096),
    ((2, 2, 130, 256, torch.float32, 16), 2 * 2 * 144 * 4096),
    ((1, 1, 1, 256, torch.float32, 32), 32 * 4096),
    ((1, 1, 500, 256, torch.float32, 32), 512 * 4096),
    # head dims from 129 to 255 on the same images, zeros past D
    ((4, 1, 512, 192, torch.float32, 32), 4 * 512 * 4096),
    # nothing for bfloat16 (read as stored) or a smaller head dim
    ((4, 1, 512, 256, torch.bfloat16, 16), 0),
    ((4, 8, 512, 128, torch.float32, 16), 0),
], ids=["paligemma", "ragged", "one_key", "tile32", "d192", "bf16", "d128"])
def test_flash_workspace_bytes(shape, want):
    assert workspace_bytes(*shape) == want


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


def _decode_layouts():
    """(k_cache, v_cache) laid out as the kernels read them in place
    (``None``: in 16-byte pieces or narrower ones), or not (the words its
    refusal must contain)."""
    B, S, KVH, D = 2, 8, 2, 16
    k = torch.zeros(B, S, KVH, D)
    kv = torch.zeros(B, S, 2 * KVH * D)  # a fused KV projection, viewed per part
    odd = torch.zeros(B, S, KVH, D + 3)[..., :D]
    flat = torch.zeros(B * S * KVH * D + 1)[1:].view(B, S, KVH, D)
    size1 = torch.zeros(KVH * D).as_strided((1, 1, KVH, D), (3, 5, D, 1))
    return {
        "contiguous": ((k, torch.zeros_like(k)), None),
        "fused_view": ((kv[..., :KVH * D].view(B, S, KVH, D),
                        kv[..., KVH * D:].view(B, S, KVH, D)), None),
        "bf16_d16": ((k.bfloat16(), k.bfloat16()), None),
        "size1_odd_stride": ((size1, size1), None),
        "row_stride_12_bytes": ((odd, odd), None),
        "misaligned_base": ((flat, flat), None),
        "bf16_head_dim_100": ((torch.zeros(B, S, KVH, 100).bfloat16(),) * 2, None),
        "zero_stride": ((torch.zeros(B, 1, KVH, D).expand(B, S, KVH, D),) * 2, "positive strides"),
        "last_dim_stride": ((k.transpose(2, 3).contiguous().transpose(2, 3),) * 2,
                            "contiguous last dimension"),
        "kv_strides_differ": ((k, torch.zeros(B, KVH, S, D).transpose(1, 2)), "equal strides"),
    }


@pytest.mark.parametrize("what", sorted(_decode_layouts()))
def test_decode_kernel_layout_check(what):
    """What the decode kernels read in place, checked on CPU tensors: the
    check the wrapper runs before every launch on the card."""
    args, words = _decode_layouts()[what]
    if words is None:
        check_decode_layout(*args)
    else:
        with pytest.raises(ValueError, match=words):
            check_decode_layout(*args)


# (B, KVH, G, Smax) -> entries a block on a card of 132 SMs: llama3.2-3b's
# and hymba-1.5b's decode shapes, a tiny cache, a long one, and G = 12 (two
# blocks a split, 8 + 4 query heads)
@pytest.mark.parametrize("shape,split", [((4, 8, 3, 544), 48), ((4, 5, 5, 544), 32),
                                         ((1, 1, 1, 16), 16), ((4, 8, 3, 32768), 64),
                                         ((2, 8, 12, 544), 48)])
def test_decode_split_keeps_at_most_four_blocks_an_sm(shape, split):
    B, KVH, G, Smax = shape
    got = decode_split(B, KVH, G, Smax, 132)
    assert got == split and got % 16 == 0
    blocks = B * KVH * -(-G // 8)
    assert blocks * -(-Smax // got) <= 4 * 132 or got == 64
    assert got == 16 or blocks * -(-Smax // (got - 16)) > 4 * 132


def _q_layouts():
    """q laid out as the head-dim-256 kernel reads it (``None``: by bulk
    copies, or narrower pieces where those cannot take it), or not (the
    words its refusal must contain), beside contiguous caches."""
    B, H, KVH, D = 2, 8, 1, 256
    qkv = torch.zeros(B, 1, (H + 2 * KVH) * D)  # a fused projection, q viewed out of it
    flat = torch.zeros(B * H * D + 1)[1:].view(B, 1, H, D)
    return {
        "contiguous": (torch.zeros(B, 1, H, D), None),
        "fused_view": (qkv[..., :H * D].view(B, 1, H, D), None),
        "bf16": (torch.zeros(B, 1, H, D, dtype=torch.bfloat16), None),
        "one_row": (torch.zeros(1, 1, 1, D + 2)[..., :D], None),
        "head_stride_12_bytes": (torch.zeros(B, 1, H, D + 3)[..., :D], None),
        "misaligned_base": (flat, None),
        "last_dim_stride": (torch.zeros(B, 1, D, H).transpose(2, 3), "contiguous last dimension"),
    }


@pytest.mark.parametrize("what", sorted(_q_layouts()))
def test_decode_q_layout_check(what):
    """What the head-dim-256 kernel's copy of q takes, checked on CPU
    tensors beside contiguous caches: the check the wrapper runs before
    every launch on the card."""
    q, words = _q_layouts()[what]
    k = torch.zeros(q.shape[0], 16, 1, q.shape[-1], dtype=q.dtype)
    if words is None:
        check_decode_layout(k, k, q)
    else:
        with pytest.raises(ValueError, match=words):
            check_decode_layout(k, k, q)


# (B, KVH, G, Smax) -> blocks a cluster of the head-dim-256 kernel (8 query
# heads a cluster, at most 16 blocks, as the kernel's geometry) on a card of
# 132 SMs: paligemma-3b's decode shape, two kv heads, G = 12 (two head
# groups), llama-like G = 3, batches of 64 and 256, a tiny cache, a short
# one and a long one
@pytest.mark.parametrize("shape,cluster", [
    ((4, 1, 8, 544), 16), ((4, 2, 8, 550), 16), ((4, 2, 12, 550), 8), ((4, 8, 3, 544), 4),
    ((64, 1, 8, 544), 2), ((256, 1, 8, 544), 1), ((1, 1, 1, 16), 1), ((1, 1, 8, 100), 4),
    ((4, 1, 8, 32768), 16)])
def test_decode_cluster_fills_the_card_with_one_cluster_a_head_group(shape, cluster):
    B, KVH, G, Smax = shape
    got = decode_cluster(B, KVH, G, Smax, 132, heads=8, max_cluster=16)
    assert got == cluster and got & (got - 1) == 0 and 1 <= got <= 16
    pairs = B * KVH * -(-G // 8)
    assert got == 1 or (pairs * got <= 132 and got * 16 <= Smax)
    assert got == 16 or pairs * 2 * got > 132 or 2 * got * 16 > Smax


# (cache_len, Smax, window, cluster): empty, fewer valid entries than blocks,
# a share on either side of 1 and of a 32-entry stage, paligemma's lengths
# with and without a window, cache_len above Smax (with a window that still
# reaches into the cache, and one that does not), a long cache, one block
@pytest.mark.parametrize("case", [
    (0, 544, 0, 16), (1, 544, 0, 16), (15, 544, 0, 16), (16, 544, 0, 16), (17, 544, 0, 16),
    (511, 544, 0, 16), (513, 544, 0, 16), (300, 544, 0, 16), (544, 544, 0, 16),
    (300, 544, 64, 16), (544, 544, 64, 16), (1, 544, 64, 16), (600, 544, 0, 16),
    (600, 544, 64, 16), (650, 544, 64, 16), (32768, 32768, 0, 16), (544, 544, 0, 1),
    (100, 550, 0, 8)])
def test_decode_shares_split_the_valid_entries_evenly(case):
    cache_len, smax, window, cluster = case
    shares = decode_shares(cache_len, smax, window, cluster)
    valid = decode_valid(smax, cache_len, window, "cpu").nonzero().flatten().tolist()
    assert len(shares) == cluster
    assert [e for a, b in shares for e in range(a, b)] == valid  # in order, each once
    sizes = [b - a for a, b in shares]
    assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1


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
