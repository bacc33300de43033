"""The port's DLT chain runner (``repro_torch.runtime.dlt_runner``) and the
chain groups of ``repro_torch.launch.mesh`` on the CPU.

* ``stage_batches`` gives the reference's arrays bit for bit over several
  plans (both packages plan through their serial solvers).
* One chain step against the reference's ``make_dlt_train_step``, run in a
  child process with 4 forced host devices as ``tests/test_dlt_runner.py``
  runs it, from the same weights (``convert.params_from_reference``): the
  loss within the reference's own 2e-4, the parameters under C.18's
  allowance (at most 1 element in 10^4 outside the reference's
  microbatch bar, rtol 2e-3 / atol 2e-4, and all within 2 lr).  The same
  step's loss within 2e-4 of a single pass over the same samples and its
  gradients within 1e-5 of each leaf's max |g| of ``make_train_step``'s
  over the samples concatenated.
* ``LocalChain`` against ``DistChain`` on 4 gloo processes (each its own
  interpreter, a ``file://`` rendezvous under ``tmp_path``): one step's loss
  within 1e-6 relative, the replicas bitwise equal across the ranks; and a
  run through ``launch.train.run_dlt_chain`` whose stage 1 fails, so the
  chain shrinks 4 -> 3, the last process leaves, and the three left restore
  the checkpoint and go on with replicas bitwise equal, each super-step's
  loss within 1e-5 relative of the ``LocalChain`` run's.
* ``HW`` holds the H100 constants ``chip_smoke.py`` bounds its kernels by.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.config import get_arch as ref_get_arch
from repro.config import smoke_variant as ref_smoke_variant
from repro.core.planner import BatchSpec as RefBatchSpec
from repro.core.planner import LinkSpec as RefLinkSpec
from repro.core.planner import Planner as RefPlanner
from repro.core.planner import StageSpec as RefStageSpec
from repro.data import make_batch
from repro.runtime.dlt_runner import stage_batches as ref_stage_batches
from repro_torch.config import ShardingPolicy, TrainConfig, get_arch, smoke_variant
from repro_torch.convert import leaves_to_reference, params_from_reference
from repro_torch.core.planner import BatchSpec, LinkSpec, Planner, StageSpec
from repro_torch.launch import train
from repro_torch.launch.mesh import HW, make_chain_mesh
from repro_torch.models import init_params, loss_fn
from repro_torch.runtime import make_train_state, make_train_step
from repro_torch.runtime.dlt_runner import (DistChain, LocalChain, make_dlt_train_step,
                                            stage_batches)

REPO = Path(__file__).resolve().parents[1]
CFG = smoke_variant(get_arch("llama3.2-3b"))
LR = 1e-3


def _plans(m, q, B, n_loads, skew):
    """The same chain planned by both packages (serial solvers)."""
    out = []
    for pkg in ((RefStageSpec, RefLinkSpec, RefBatchSpec, RefPlanner),
                (StageSpec, LinkSpec, BatchSpec, Planner)):
        S, L, Bs, P = pkg
        stages = [S(f"s{i}", 1e9 / (1 + skew * i)) for i in range(m)]
        links = [L(1e8, 1e-4)] * (m - 1)
        out.append(P(stages, links).plan([Bs(B, 256.0, 2e7) for _ in range(n_loads)], q=q))
    return out


@pytest.mark.parametrize("m,q,B,n_loads,skew", [(3, 2, 8, 2, 0.0), (4, 2, 8, 2, 0.25),
                                                (4, 3, 12, 3, 0.5), (2, 1, 5, 1, 0.1),
                                                (5, 4, 16, 2, 0.3)])
def test_stage_batches_equal_the_references(m, q, B, n_loads, skew):
    ref_plan, plan = _plans(m, q, B, n_loads, skew)
    assert [list(s) for s in plan.samples] == [list(s) for s in ref_plan.samples]
    batches = [make_batch(ref_smoke_variant(ref_get_arch("llama3.2-3b")), B, 16, step=i)
               for i in range(n_loads)]
    got = stage_batches(plan, batches, m)
    want = ref_stage_batches(ref_plan, batches, m)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
    assert got[2].sum() == n_loads * B


# ---------------------------------------------------------------- against the reference

REF_CHILD = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.config import ShardingPolicy, TrainConfig, get_arch, smoke_variant
from repro.core.planner import LinkSpec, Planner, StageSpec
from repro.data import batch_load_spec, make_batch
from repro.models import init_params
from repro.runtime import make_train_state
from repro.runtime.dlt_runner import make_dlt_train_step, stage_batches
from repro.launch.mesh import make_chain_mesh

cfg = smoke_variant(get_arch("llama3.2-3b"))
policy = ShardingPolicy(attn_chunk=16)
tcfg = TrainConfig(lr=1e-3, warmup_steps=0, total_steps=10)
B, S, m = 8, 32, 4
load = batch_load_spec(cfg, B, S)
speed = load.flops_per_sample * B / 0.05
stages = [StageSpec(f"s{i}", speed / (1 + 0.25 * i)) for i in range(m)]
links = [LinkSpec(load.bytes_per_sample * B / 0.01, 1e-4)] * (m - 1)
plan = Planner(stages, links).plan([load, load], q=2)
batches = [make_batch(cfg, B, S, step=i) for i in range(2)]
toks, labs, counts = stage_batches(plan, batches, m)
params = init_params(cfg, policy, seed=0, dtype=jnp.float32)
init = jax.tree.map(np.asarray, params)
state = make_train_state(params, tcfg)
step = make_dlt_train_step(cfg, policy, tcfg, make_chain_mesh(m), n_cells=len(plan.cells))
state2, metrics = step(state, jnp.asarray(toks), jnp.asarray(labs), jnp.asarray(counts))
flat = jax.tree_util.tree_flatten_with_path(state2.params)[0]
after = {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): np.asarray(v)
         for path, v in flat}
pickle.dump(dict(init=init, after=after, loss=float(metrics["loss"]),
                 grad_norm=float(metrics["grad_norm"]), toks=toks, labs=labs, counts=counts,
                 batches=batches), open(sys.argv[1], "wb"))
"""


@pytest.fixture(scope="module")
def reference_step(tmp_path_factory):
    """The reference's chain step (4 forced host devices), in a child."""
    out = tmp_path_factory.mktemp("dlt_ref") / "out.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", REF_CHILD, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    import pickle

    with open(out, "rb") as f:
        return pickle.load(f)  # written by the child above


def _within_c18(got: dict, want: dict, lr: float) -> None:
    """C.18's allowance: all within 2 lr, at most 1 element in 10^4 outside
    the reference's microbatch bar (rtol 2e-3, atol 2e-4)."""
    assert set(got) == set(want)
    outside = total = 0
    for k, w in want.items():
        diff = np.abs(np.asarray(got[k], np.float64) - w)
        assert diff.max() <= 2 * lr, (k, diff.max())
        outside += int((diff > 2e-4 + 2e-3 * np.abs(w)).sum())
        total += w.size
    assert outside <= total // 10_000, (outside, total)


def _port_chain_step(ref):
    model = params_from_reference(ref["init"], CFG, "cpu")
    tcfg = TrainConfig(lr=LR, warmup_steps=0, total_steps=10)
    state = make_train_state(model, tcfg)
    n_cells = ref["counts"].shape[0]
    step = make_dlt_train_step(CFG, ShardingPolicy(attn_chunk=16), tcfg, LocalChain(4, "cpu"),
                               n_cells)
    return step(state, ref["toks"], ref["labs"], ref["counts"])


def test_chain_step_matches_the_references(reference_step):
    ref = reference_step
    state, m = _port_chain_step(ref)
    assert abs(float(m["loss"]) - ref["loss"]) < 2e-4, (float(m["loss"]), ref["loss"])
    np.testing.assert_allclose(float(m["grad_norm"]), ref["grad_norm"], rtol=1e-4)
    got = leaves_to_reference({n: p.detach() for n, p in state.params.named_parameters()})
    _within_c18(got, ref["after"], LR)
    assert int(state.opt.step) == 1


def test_chain_step_equals_a_single_pass_over_the_same_samples(reference_step):
    ref = reference_step
    policy = ShardingPolicy(attn_chunk=16)
    batch = {k: torch.from_numpy(np.concatenate([b[k] for b in ref["batches"]]))
             for k in ("tokens", "labels")}
    with torch.no_grad():
        single, _ = loss_fn(params_from_reference(ref["init"], CFG, "cpu"), CFG, policy, batch)
    chain, m = _port_chain_step(ref)
    assert abs(float(m["loss"]) - float(single)) < 2e-4
    tcfg = TrainConfig(lr=LR, warmup_steps=0, total_steps=10)
    plain = make_train_state(params_from_reference(ref["init"], CFG, "cpu"), tcfg)
    plain, pm = make_train_step(CFG, policy, tcfg)(plain, batch)
    np.testing.assert_allclose(float(m["loss"]), float(pm["loss"]), rtol=1e-5)
    want = {n: p.grad for n, p in plain.params.named_parameters()}
    for n, p in chain.params.named_parameters():
        scale = float(want[n].abs().max())
        assert float((p.grad - want[n]).abs().max()) <= 1e-5 * scale, n


def test_chain_step_refuses_the_kernel_attention_and_bad_counts():
    tcfg = TrainConfig()
    with pytest.raises(ValueError, match="backward"):
        make_dlt_train_step(CFG, ShardingPolicy(attention_impl="cuda"), tcfg,
                            LocalChain(2, "cpu"), 2)
    state = make_train_state(init_params(CFG, seed=0, device="cpu"), tcfg)
    step = make_dlt_train_step(CFG, ShardingPolicy(attn_chunk=16), tcfg, LocalChain(2, "cpu"), 2)
    toks = np.zeros((2, 3, 8), np.int32)
    with pytest.raises(ValueError, match="cells, stages"):
        step(state, toks, toks, np.ones((2, 3), np.int32))


# ---------------------------------------------------------------- DistChain on gloo

WORKER = r"""
import json, sys
import torch, torch.distributed as dist
from repro_torch.launch import train
rank, world, init, out, argv = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
                                json.loads(sys.argv[5]))
dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
args = train.parse_args(argv)
cfg, policy, tcfg = train.build_cfg(args)
log, state = train.run_dlt_chain(args, cfg, policy, tcfg)
torch.save({"log": log, "params": {n: p.detach() for n, p in state.params.named_parameters()},
            "opt_step": int(state.opt.step)}, f"{out}/rank{rank}.pt")
dist.destroy_process_group()
"""

CHAIN_ARGS = ["--arch", "llama3.2-3b", "--smoke", "--device", "cpu", "--batch", "8",
              "--seq", "32", "--dlt-chain", "4", "--dlt-q", "2", "--lr", "1e-3"]


def _run_dist(tmp_path: Path, argv: list, world: int = 4) -> list:
    """``run_dlt_chain`` in ``world`` processes joined over gloo; returns
    what each rank saved."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    init = tmp_path / "rendezvous"
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(init),
                               str(tmp_path), json.dumps(argv)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, err[-3000:])
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=True) for r in range(world)]


def _local(argv: list) -> tuple:
    args = train.parse_args(argv)
    return train.run_dlt_chain(args, *train.build_cfg(args))


def _bitwise_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[n], b[n]) for n in a)


def test_dist_chain_step_matches_the_local_chain_with_equal_replicas(tmp_path):
    argv = [*CHAIN_ARGS, "--steps", "1"]
    ranks = _run_dist(tmp_path, argv)
    log, state = _local(argv)
    for r in ranks[1:]:
        assert _bitwise_equal(r["params"], ranks[0]["params"])
        assert r["log"][0]["loss"] == ranks[0]["log"][0]["loss"]
    assert ranks[0]["log"][0]["loss"] == pytest.approx(log[0]["loss"], rel=1e-6)
    assert ranks[0]["log"][0]["samples"] == log[0]["samples"]
    local = {n: p.detach().numpy() for n, p in state.params.named_parameters()}
    _within_c18({n: t.numpy() for n, t in ranks[0]["params"].items()}, local, 1e-3)


def test_dist_chain_shrinks_on_a_failure_and_restores(tmp_path):
    ckpt_local, ckpt_dist = tmp_path / "ck_local", tmp_path / "ck_dist"
    ev = ["--steps", "3", "--save-every", "1", "--fail", "1@step2", "--straggle", "3@step1x2.0"]
    ranks = _run_dist(tmp_path, [*CHAIN_ARGS, *ev, "--ckpt-dir", str(ckpt_dist)])
    log, state = _local([*CHAIN_ARGS, *ev, "--ckpt-dir", str(ckpt_local)])
    assert [m["stages"] for m in log] == [4, 4, 3]
    # the last process leaves the chain at the failure; the three left go on
    assert len(ranks[3]["log"]) == 2 and all(len(r["log"]) == 3 for r in ranks[:3])
    for r in ranks[1:3]:
        assert _bitwise_equal(r["params"], ranks[0]["params"])
    assert ranks[0]["opt_step"] == state.opt.step == 3  # restored step 1 (2 updates), then 1
    assert sorted(os.listdir(ckpt_dist)) == sorted(os.listdir(ckpt_local))
    for got, want in zip(ranks[0]["log"], log):
        assert got["samples"] == want["samples"] and got["stages"] == want["stages"]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)


def test_dist_chain_sums_in_flat_buckets(tmp_path, monkeypatch):
    """``sum_`` packs leaves of one dtype into buckets of at most
    ``SUM_BUCKET_BYTES`` and writes each sum back into its leaf (a world of
    one: the sum is the leaf itself)."""
    import torch.distributed as dist

    from repro_torch.runtime import dlt_runner

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1)
    try:
        calls = []
        real = dist.all_reduce
        monkeypatch.setattr(dist, "all_reduce", lambda t, **kw: (calls.append(t.numel()),
                                                                  real(t, **kw))[1])
        monkeypatch.setattr(dlt_runner, "SUM_BUCKET_BYTES", 32)
        chain = make_chain_mesh(1, "cpu")
        assert isinstance(chain, DistChain) and chain.backend == "gloo" and not chain.staged
        xs = [torch.arange(4.0), torch.arange(6.0), torch.ones(2, dtype=torch.float64),
              torch.ones(3)]
        want = [x.clone() for x in xs]
        chain.sum_(xs)
        assert calls == [4, 6, 2, 3]  # 4 + 6 floats pass 32 bytes; a dtype change splits
        assert all(torch.equal(x, w) for x, w in zip(xs, want))
        with pytest.raises(RuntimeError, match="world of 2"):
            make_chain_mesh(2, "cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- mesh


def test_local_chain_hands_rows_down_the_chain():
    chain = make_chain_mesh(3, "cpu")
    assert isinstance(chain, LocalChain) and (chain.rank, chain.size) == (0, 3)
    packed = torch.arange(2 * 4 * 2).reshape(2, 4, 2)
    counts = np.array([[2, 1, 1], [1, 0, 1]])
    chain.begin(packed, counts)
    seen = {}
    for t in range(2):
        for s in chain.stages:
            rows = chain.arrive(t, s)
            n = int(counts[t, s])
            chain.hop(t, s, n)
            seen[(t, s)] = rows[:n]
    chain.end()
    assert torch.equal(seen[(0, 0)], packed[0, :2]) and torch.equal(seen[(0, 2)], packed[0, 3:4])
    assert seen[(1, 1)].shape[0] == 0 and torch.equal(seen[(1, 2)], packed[1, 1:2])
    assert chain.shrink(2).size == 2
    with pytest.raises(ValueError):
        LocalChain(0, "cpu")


def test_hw_holds_the_h100_constants_chip_smoke_bounds_by():
    # the values chip_smoke.py bounded every kernel by before it read them
    # from HW (PERF.md's bounds rest on them), under the reference's names
    assert (HW.PEAK_FLOPS_BF16, HW.HBM_BW, HW.HBM_BYTES) == (989e12, 3.35e12, 80e9)
    assert (HW.PEAK_FLOPS_TF32, HW.PEAK_FLOPS_FP32, HW.PEAK_FLOPS_FP64) == (495e12, 67e12, 34e12)
    assert HW.L2_BYTES == 50 << 20 and HW.NVLINK_BW == 900e9
    src = (REPO / "chip_smoke.py").read_text()
    for name in ("HW.HBM_BW", "HW.PEAK_FLOPS_FP64", "HW.PEAK_FLOPS_FP32", "HW.PEAK_FLOPS_BF16",
                 "HW.PEAK_FLOPS_TF32", "HW.L2_BYTES"):
        assert name in src, name
