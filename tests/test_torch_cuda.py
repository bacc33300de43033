"""The port's CUDA kernels on the card, held against their plain versions
on the same card, and the engine and the serving paths on the card against
the same on the CPU.

These need an NVIDIA card and ``nvcc``; elsewhere they skip (the fixture
decides at run time, so every xdist worker collects the same tests).  On the
card: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from repro_torch.core.instance import random_instance
from repro_torch.kernels import (asap_replay, asap_replay_plain, decode_attention,
                                 decode_attention_plain, flash_attention, flash_attention_plain,
                                 launch_counts, reset_launch_counts, rms_norm, rms_norm_plain,
                                 simplex_pivot, simplex_pivot_plain, ssd_scan, ssd_scan_plain,
                                 ssd_scan_tolerance)
from repro_torch.kernels.ssd_scan import pick_chunk

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available() or shutil.which("nvcc") is None:
        pytest.skip("needs an NVIDIA card and nvcc (the CUDA kernels are built from source)")
    return torch.device("cuda")


def _stack(rng, B, R, C):
    T = rng.uniform(0.1, 1.0, size=(B, R, C))
    T[:, -1, :] = rng.uniform(-1.0, 0.5, size=(B, C))
    T[:, :, -1] = rng.uniform(0.5, 1.5, size=(B, R))
    basis = np.stack([rng.permutation(C - 1)[: R - 1] for _ in range(B)]).astype(np.int32)
    it = np.zeros(B, np.int32)
    status = np.full(B, -1, np.int32)
    status[1] = 0
    it[2] = 5
    return [torch.from_numpy(a) for a in (T, basis, it, status)]


@pytest.mark.parametrize("k_pivots", [1, 4])
@pytest.mark.parametrize("shape", [(4, 7, 13), (3, 300, 700)])
def test_simplex_pivot_kernel_matches_plain_on_card(card, shape, k_pivots):
    base = _stack(np.random.default_rng(sum(shape)), *shape)
    kw = dict(ncols_price=shape[2] - 1, bland_after=3, max_iter=50, k_pivots=k_pivots)
    plain = simplex_pivot_plain(*[x.to(card) for x in base], **kw)
    reset_launch_counts()
    kern = simplex_pivot(*[x.to(card) for x in base], **kw)
    torch.cuda.synchronize()
    assert launch_counts()["simplex_pivot"] == 1
    for a, b in zip(kern[1:], plain[1:]):
        assert torch.equal(a, b)
    assert (kern[0] - plain[0]).abs().max().item() <= 1e-12 * base[0].abs().max().item()


@pytest.mark.parametrize("with_ret", [False, True])
@pytest.mark.parametrize("topology", ["chain", "star"])
@pytest.mark.parametrize("m", [1, 4])
def test_asap_replay_kernel_matches_plain_on_card(card, topology, with_ret, m):
    if with_ret and m == 1:
        pytest.skip("the return phase needs a link")
    rng = np.random.default_rng(m)
    B, T = 64, 6
    valid = np.ones(T)
    valid[-1] = 0.0
    args = [rng.uniform(0.1, 1.0, size=(B, m, T)), rng.uniform(0.1, 1.0, size=(B, m - 1)),
            rng.uniform(0.0, 0.1, size=(B, m - 1)), rng.uniform(0.0, 1.0, size=(B, m)),
            rng.uniform(1.0, 2.0, size=(B, T)), rng.uniform(1.0, 2.0, size=(B, T)),
            rng.uniform(0.0, 1.0, size=(B, T)), valid, rng.uniform(0.0, 1.0, size=(B, m, T))]
    ret = torch.from_numpy(rng.uniform(0, 1, size=(B, T))).to(card) if with_ret else None
    targs = [torch.from_numpy(a).to(card) for a in args]
    want = asap_replay_plain(*targs, ret, topology=topology)
    got = asap_replay(*targs, ret, topology=topology)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if w is not None:
            torch.testing.assert_close(g, w, rtol=1e-12, atol=0)


def test_solve_bulk_on_card_matches_cpu(card):
    from repro_torch.engine import solve_bulk

    rng = np.random.default_rng(3)
    insts = [random_instance(rng, m=4, n_loads=2, q=2, topology=t, return_ratio=r,
                             with_latency=True)
             for t in ("chain", "star") for r in (0.0, 0.5) for _ in range(3)]
    reset_launch_counts()
    gpu = solve_bulk(insts)
    counts = launch_counts()
    cpu = solve_bulk(insts, device="cpu")
    assert counts["simplex_pivot"] > 0 and counts["asap_replay"] > 0
    for g, c in zip(gpu, cpu):
        assert g.ok and g.backend == "cuda"
        assert abs(g.makespan - c.makespan) <= 1e-9 * c.makespan


# float32: the same function with sums in another order; bfloat16: inputs and
# outputs rounded to bfloat16 (the kernel and the plain version both compute
# in float32 in between)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (B, Sq, Sk, H, KVH, D, causal, window)
    (2, 512, 512, 24, 8, 128, True, 0),
    (4, 512, 512, 25, 5, 64, True, 1024),  # hymba-1.5b's heads and window
    (1, 500, 500, 4, 2, 64, True, 0),
    (1, 256, 256, 4, 2, 32, True, 96),
    (1, 130, 200, 8, 8, 16, False, 0),
    # the edges of the TMA-fed tiles: one row or key, one past a 64-row tile
    # (rows and keys zero-filled past the end), a window of 1, Sq != Sk at
    # the smallest head dim
    (1, 1, 1, 4, 2, 64, True, 0),
    (1, 65, 65, 4, 2, 128, True, 0),
    (1, 65, 1, 4, 2, 64, False, 0),
    (1, 1, 65, 4, 2, 64, False, 0),
    (2, 100, 100, 4, 4, 64, True, 1),
    (1, 70, 150, 4, 2, 16, True, 0),
])
def test_flash_attention_kernel_matches_plain_on_card(card, case, dtype):
    B, Sq, Sk, H, KVH, D, causal, window = case
    g = torch.Generator(device=card).manual_seed(sum(case[:6]))
    q, k, v = (torch.randn(s, generator=g, device=card).to(dtype)
               for s in ((B, Sq, H, D), (B, Sk, KVH, D), (B, Sk, KVH, D)))
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1 and got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_reads_a_fused_projection_on_card(card, dtype):
    """q, k and v as strided views into one [B, S, (H + 2 KVH) D] projection,
    as a model with a fused QKV weight hands them over: the tensor maps
    read them in place."""
    B, S, H, KVH, D = 2, 200, 8, 2, 128
    g = torch.Generator(device=card).manual_seed(7)
    qkv = torch.randn(B, S, (H + 2 * KVH) * D, generator=g, device=card).to(dtype)
    q = qkv[..., :H * D].view(B, S, H, D)
    k = qkv[..., H * D:(H + KVH) * D].view(B, S, KVH, D)
    v = qkv[..., (H + KVH) * D:].view(B, S, KVH, D)
    got = flash_attention(q, k, v)
    want = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("cache_len", [1, 63, 64, 300, 544])
@pytest.mark.parametrize("heads", [(24, 8, 128), (25, 5, 64)])  # llama3.2-3b's, hymba-1.5b's
def test_decode_attention_kernel_matches_plain_on_card(card, heads, cache_len, window, dtype):
    B, Smax = 4, 544
    H, KVH, D = heads
    g = torch.Generator(device=card).manual_seed(cache_len + window)
    q, kc, vc = (torch.randn(s, generator=g, device=card).to(dtype)
                 for s in ((B, 1, H, D), (B, Smax, KVH, D), (B, Smax, KVH, D)))
    n = torch.tensor([cache_len], dtype=torch.int32, device=card)
    reset_launch_counts()
    got = decode_attention(q, kc, vc, n, window=window)
    want = decode_attention_plain(q, kc, vc, n, window=window)
    torch.cuda.synchronize()
    assert launch_counts()["decode_attention"] == 1 and got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (B, S, H, P, G, N, chunk, decay): mamba2-2.7b's and hymba-1.5b's heads,
    # a ragged chunk (480 -> 240), multi-group, P = 128, and weak decay
    (2, 512, 8, 64, 1, 128, 256, 1.0),
    (2, 512, 8, 64, 1, 16, 256, 1.0),
    (1, 480, 4, 64, 1, 128, 256, 1e-3),
    (1, 128, 4, 16, 2, 32, 64, 1.0),
    (1, 96, 2, 128, 1, 64, 32, 1e-3),
])
def test_ssd_scan_kernel_matches_plain_on_card(card, case, dtype):
    B, S, H, P, G, N, chunk, decay = case
    g = torch.Generator(device=card).manual_seed(S + H + N)
    xbc = torch.randn(B, S, H * P + 2 * G * N, generator=g, device=card).to(dtype)
    x = xbc[..., :H * P].reshape(B, S, H, P)  # strided, as the mixer passes them
    Bm = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N)
    Cm = xbc[..., H * P + G * N:].reshape(B, S, G, N)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g, device=card))
    A = -torch.linspace(1.0, 16.0, H, device=card) * decay
    D = torch.linspace(0.5, 1.5, H, device=card)
    reset_launch_counts()
    got = ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk)
    want = ssd_scan_plain(x, dt, A, Bm, Cm, D, chunk=pick_chunk(S, chunk))
    torch.cuda.synchronize()
    assert launch_counts()["ssd_scan"] == 1 and got.dtype == dtype
    tol = ssd_scan_tolerance(x, dt, A, Bm, Cm, D, chunk=chunk)
    assert ((got.float() - want.float()).abs() <= tol).all()


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-2.7b", "hymba-1.5b"])
def test_smoke_serving_on_card_matches_cpu(card, arch):
    from repro_torch.config import get_arch, smoke_variant
    from repro_torch.launch.serve import generate, load_model, prompt_tokens, serve_policy

    cfg = smoke_variant(get_arch(arch))
    model = load_model(cfg, seed=0, device="cpu")
    prompt = prompt_tokens(cfg, 2, 16, seed=0, device="cpu")
    cpu = generate(model, cfg, serve_policy(16), prompt, 4)
    reset_launch_counts()
    gpu = generate(model.to(card), cfg, serve_policy(16), prompt.to(card), 4)
    counts = launch_counts()
    attn = cfg.num_layers if cfg.has_attention else 0
    assert counts["flash_attention"] == attn
    assert counts["decode_attention"] == 4 * attn
    assert counts["ssd_scan"] == (cfg.num_layers if cfg.has_ssm else 0)
    torch.testing.assert_close(gpu.prefill_logits.cpu(), cpu.prefill_logits, rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(gpu.tokens.cpu(), cpu.tokens)


# the served models' norm shapes (llama3.2-3b prefill and decode, mamba2-2.7b's
# gated norm over d_inner, hymba-1.5b), bfloat16, a ragged row count, and two
# the vectorised path does not take (an odd D, rows read through a stride)
RMS_CASES = [((2048, 3072), torch.float32), ((4, 3072), torch.float32),
             ((2048, 5120), torch.float32), ((2048, 1600), torch.float32),
             ((2048, 3072), torch.bfloat16), ((2047, 3072), torch.float32),
             ((33, 97), torch.float32), ((33, 97), torch.bfloat16),
             # one row; many rows (each resident block walks over several)
             ((1, 3072), torch.float32), ((1, 3072), torch.bfloat16),
             ((4096, 3072), torch.float32), ((4096, 5120), torch.bfloat16),
             # the register path at widths of 1, 2, 4 and 8 warps a row and at
             # its widest (16384 float32, 24576 bfloat16); one vector past it
             # (the generic kernel, row in shared memory); past 32768 (the
             # generic kernel reading the row twice), aligned and not
             ((64, 2048), torch.float32), ((64, 2048), torch.bfloat16),
             ((64, 128), torch.float32), ((64, 4096), torch.float32),
             ((64, 8192), torch.float32), ((64, 16384), torch.float32),
             ((64, 24576), torch.bfloat16), ((64, 16388), torch.float32),
             ((8, 40000), torch.float32), ((8, 40001), torch.bfloat16)]


def rms_norm_within_tolerance(got, x, w):
    """The kernel against the plain version's float32 value on the same
    inputs: 1e-5 of max(1, max |out|) for the float32 sum of squares taken
    in another order, plus, for bfloat16 output, its one rounding (2^-8
    relative)."""
    want = rms_norm_plain(x.float(), w)
    tol = 1e-5 * max(1.0, want.abs().max().item())
    if x.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * want.abs()
    return bool(((got.float() - want).abs() <= tol).all())


@pytest.mark.parametrize("shape,dtype", RMS_CASES)
def test_rms_norm_kernel_matches_plain_on_card(card, shape, dtype):
    g = torch.Generator(device=card).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=card).to(dtype)
    w = 1.0 + 0.1 * torch.randn(shape[-1], generator=g, device=card)
    reset_launch_counts()
    got = rms_norm(x, w)
    torch.cuda.synchronize()
    assert launch_counts()["rms_norm"] == 1 and got.dtype == dtype and got.shape == x.shape
    assert rms_norm_within_tolerance(got, x, w)
    wide = torch.randn(shape[0], shape[-1] + 8, generator=g, device=card).to(dtype)
    strided = wide[:, 3:3 + shape[-1]]  # rows through a stride, unaligned
    assert rms_norm_within_tolerance(rms_norm(strided, w), strided, w)


def test_session_on_card_matches_the_serial_session(card):
    """The port's front door on the card ("cuda" and "torch" on the card)
    against its serial "auto" session, and evaluate_gammas through the
    replay kernel against the serial simulator."""
    from repro_torch.api import Policy, Session
    from repro_torch.core.simulator import simulate

    rng = np.random.default_rng(11)
    insts = [random_instance(rng, m=m, n_loads=2, q=q, topology=t, return_ratio=r,
                             with_latency=True)
             for t in ("chain", "star") for r in (0.0, 0.5) for m, q in ((3, 1), (4, 2))]
    serial = Session(policy=Policy(backend="auto")).solve_bulk(insts)
    for backend in ("cuda", "torch"):
        reset_launch_counts()
        arts = Session(policy=Policy(backend=backend)).solve_bulk(insts)
        counts = launch_counts()
        assert counts["simplex_pivot"] > 0 and counts["asap_replay"] > 0
        for a, s in zip(arts, serial):
            assert a.status == s.status == "optimal"
            assert a.backend == "cuda" or a.events[0]["kind"] == "serial-rescue"
            if a.backend == "cuda":
                assert a.events == ()
            for k in ("makespan", "lp_makespan", "objective_value"):
                assert abs(getattr(a, k) - getattr(s, k)) <= 1e-9 * max(1.0, abs(getattr(s, k)))
    sess = Session()
    reset_launch_counts()
    got = sess.evaluate_gammas(insts, [a.gamma for a in serial])
    assert launch_counts()["asap_replay"] > 0
    want = np.array([simulate(i, a.gamma).makespan for i, a in zip(insts, serial)])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
