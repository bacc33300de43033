"""Standing guards of the port: it imports neither JAX nor the JAX package,
it runs on the card unless told otherwise, and its serial NumPy copies agree
with the reference's serial oracle."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.simulator import simulate as ref_simulate
from repro.core.solver import solve as ref_solve
from repro_torch.convert import instance_from_reference
from repro_torch.core.instance import random_instance

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
RTOL = 1e-9


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_import_neither_jax_nor_the_reference():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    bad = [(f.relative_to(REPO).as_posix(), mod) for f in files for mod in _imported_modules(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_port_examples_import_neither_jax_nor_the_reference():
    files = sorted((REPO / "examples").glob("torch_*.py"))
    assert files
    bad = [(f.name, mod) for f in files for mod in _imported_modules(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    mods = list(_imported_modules(REPO / "chip_smoke.py"))
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]


@pytest.mark.parametrize("script", ["fsdp_dist.py", "chain_dist.py", "tp_dist.py", "flash_variants.py",
                                    "decode_variants.py", "decode_cache_states.py",
                                    "pivot_stages.py", "pivot_variants.py", "replay_stages.py",
                                    "replay_variants.py", "ssd_stages.py", "port_serve_steps.py"])
def test_card_scripts_import_neither_jax_nor_the_reference(script):
    mods = list(_imported_modules(REPO / "scripts" / script))
    assert mods and not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]


CHILD = r"""
import sys
import numpy as np
import repro_torch.engine as engine
from repro_torch.core.instance import random_instance
rng = np.random.default_rng(0)
insts = [random_instance(rng, m=3, n_loads=2, q=2, topology=t) for t in ("chain", "star")]
res = engine.solve_bulk(insts, device="cpu")
assert all(r.ok for r in res)
from repro_torch.api import Policy, Session
from repro_torch.core.heuristics import ALL_HEURISTICS, run_strategy
import repro_torch.eval
arts = Session(policy=Policy(backend="torch"), device="cpu").solve_bulk(insts)
assert all(a.ok for a in arts)
assert [run_strategy(n, f, insts[0]).name for n, f in ALL_HEURISTICS.items()]
from repro_torch.launch import serve, train
serve.main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--gen-len", "2"])
train.main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "8", "--steps", "1"])
train.main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "8", "--steps", "1", "--dlt-chain", "2"])
import repro_torch.checkpoint, repro_torch.optim
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")))
"""


def test_import_and_cpu_solve_leave_jax_unimported():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", CHILD], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_default_device_is_the_card_and_raises_without_one():
    import torch

    from repro_torch.core.backends import get_backend
    from repro_torch.engine import solve_bulk

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs there")
    inst = random_instance(np.random.default_rng(1), m=3, n_loads=1, q=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_bulk([inst])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_backend("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_bulk([inst], n_shards=2)  # logical shards are streams of the card
    (single,) = solve_bulk([inst], device="cpu")
    (sharded,) = solve_bulk([inst], device="cpu", n_shards=2)
    assert sharded.ok and sharded.makespan == single.makespan


def test_serve_without_device_runs_on_the_card_and_raises_without_one():
    import torch

    from repro_torch.launch import serve

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the serve demo runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3.2-3b", "--smoke", "--batch", "1", "--prompt-len", "4",
                    "--gen-len", "1"])


@pytest.mark.parametrize("entry", ["init_params", "init_cache", "init_mamba_cache", "Initializer",
                                   "prompt_tokens", "Session_torch", "Session_cuda",
                                   "evaluate_gammas", "run_campaign", "train_main",
                                   "train_init_state", "restore_checkpoint",
                                   "train_state_from_reference", "train_dlt_chain",
                                   "make_chain_mesh", "ChainReplanner", "make_data_mesh",
                                   "make_production_mesh", "torch_quickstart",
                                   "torch_serve_multiload", "torch_elastic_restart"])
def test_model_entry_points_default_to_the_card_and_raise_without_one(entry, tmp_path):
    import torch

    from repro_torch.api import Policy, Session
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.config import TrainConfig, get_arch, smoke_variant
    from repro_torch.convert import train_state_from_reference, train_state_to_reference
    from repro_torch.eval import run_campaign
    from repro_torch.core.planner import LinkSpec, Planner, StageSpec
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_chain_mesh, make_data_mesh, make_production_mesh
    from repro_torch.launch.serve import prompt_tokens
    from repro_torch.runtime.dlt_runner import ChainReplanner
    from repro_torch.runtime import make_train_state
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.layers import Initializer
    from repro_torch.models.ssm import init_mamba_cache

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs there")
    from test_torch_campaign import micro_spec

    cfg = smoke_variant(get_arch("llama3.2-3b"))
    ssm_cfg = smoke_variant(get_arch("mamba2-2.7b"))
    inst = random_instance(np.random.default_rng(1), m=3, n_loads=1, q=1)
    calls = {"init_params": lambda: init_params(cfg, seed=0),
             "init_cache": lambda: init_cache(cfg, 1, 8),
             "init_mamba_cache": lambda: init_mamba_cache(ssm_cfg, 1, 1),
             "Initializer": lambda: Initializer(0),
             "prompt_tokens": lambda: prompt_tokens(cfg, 1, 4, 0, None),
             "Session_torch": lambda: Session(policy=Policy(backend="torch")).solve(inst),
             "Session_cuda": lambda: Session(policy=Policy(backend="cuda")).solve(inst),
             "evaluate_gammas": lambda: Session().evaluate_gammas([inst], [np.ones((3, 1)) / 3]),
             "run_campaign": lambda: run_campaign(micro_spec(backend="cuda")),
             "train_main": lambda: train.main(["--arch", "llama3.2-3b", "--smoke", "--steps",
                                               "1"]),
             "train_init_state": lambda: train.init_state(
                 train.parse_args(["--arch", "llama3.2-3b", "--smoke"]), cfg, TrainConfig()),
             "restore_checkpoint": lambda: restore_checkpoint(str(tmp_path), 0, cpu_state()),
             "train_state_from_reference": lambda: train_state_from_reference(
                 train_state_to_reference(cpu_state()), cfg),
             "train_dlt_chain": lambda: train.main(["--arch", "llama3.2-3b", "--smoke",
                                                    "--steps", "1", "--dlt-chain", "2"]),
             "make_chain_mesh": lambda: make_chain_mesh(2),
             "make_data_mesh": lambda: make_data_mesh(),
             "make_production_mesh": lambda: make_production_mesh(),
             "torch_quickstart": lambda: _example_main("torch_quickstart"),
             "torch_serve_multiload": lambda: _example_main("torch_serve_multiload"),
             "torch_elastic_restart": lambda: _example_main("torch_elastic_restart"),
             "ChainReplanner": lambda: ChainReplanner(Planner(
                 [StageSpec("a", 1e9), StageSpec("b", 1e9)], [LinkSpec(1e8)]))}

    def cpu_state():
        return make_train_state(init_params(cfg, seed=0, device="cpu"), TrainConfig())

    if entry == "restore_checkpoint":
        save_checkpoint(str(tmp_path), 0, cpu_state())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def _example_main(name: str):
    """An example's ``main`` with its default device (the card)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main([])


def test_torch_backend_on_the_cpu_through_the_registry():
    from repro_torch.core.backends import SolveRequest, get_backend
    from repro_torch.engine import TorchBackend

    rng = np.random.default_rng(2)
    insts = [random_instance(rng, m=3, n_loads=2, q=2, topology="star") for _ in range(2)]
    backend = get_backend(TorchBackend(device="cpu"))
    reps = backend.solve_many([SolveRequest(instance=i) for i in insts]
                              + [SolveRequest(instance=insts[0], cross_check=True)])
    assert [r.backend for r in reps[:2]] == ["torch", "torch"]
    assert reps[2].backend in ("simplex", "scipy")  # cross_check is a serial contract
    assert abs(reps[2].makespan - reps[0].makespan) <= RTOL * reps[0].makespan


@pytest.mark.parametrize("topology", ["chain", "star"])
@pytest.mark.parametrize("returns", [0.0, 0.5])
def test_port_solve_bulk_matches_reference_serial_solve(topology, returns):
    """Serial oracle: the reference's JAX-free NumPy solver."""
    from repro.core.instance import random_instance as ref_random_instance

    from repro_torch.engine import solve_bulk

    rng = np.random.default_rng(7)
    ref_insts = [ref_random_instance(rng, m=4, n_loads=2, q=2, topology=topology,
                                     return_ratio=returns, with_latency=True)
                 for _ in range(3)]
    res = solve_bulk([instance_from_reference(i) for i in ref_insts], device="cpu")
    for r, inst in zip(res, ref_insts):
        want = ref_solve(inst)
        assert r.ok and want.ok
        assert abs(r.makespan - want.makespan) <= RTOL * want.makespan
        # the port's replay of its own gamma vs the reference's serial replay
        sched = ref_simulate(inst, r.schedule.gamma)
        assert abs(r.makespan - sched.makespan) <= RTOL * sched.makespan
        np.testing.assert_allclose(r.schedule.comp_end, sched.comp_end, rtol=RTOL)
        np.testing.assert_allclose(r.schedule.comm_end, sched.comm_end, rtol=RTOL)
        if r.schedule.ret_end is not None:
            np.testing.assert_allclose(r.schedule.ret_end, sched.ret_end, rtol=RTOL)


@pytest.mark.parametrize("topology", ["chain", "star"])
def test_port_replay_matches_reference_simulator_on_padded_buckets(topology):
    """Several shapes replayed together: padded cells and processors."""
    from repro_torch.engine import simulate_many

    rng = np.random.default_rng(8)
    insts = [random_instance(rng, m=m, n_loads=n, q=q, topology=topology,
                             return_ratio=r, with_latency=True)
             for m, n, q, r in ((2, 1, 1, 0.0), (3, 2, 2, 0.0), (4, 2, 1, 0.0), (5, 1, 2, 0.0),
                                (3, 2, 1, 0.4), (4, 1, 2, 0.4))]
    gammas = [rng.uniform(0, 1, size=(i.m, i.total_installments)) for i in insts]
    gammas = [g / g.sum(axis=0, keepdims=True) for g in gammas]
    got = simulate_many(insts, gammas, pad_shapes=True, device="cpu")
    for inst, g, s in zip(insts, gammas, got):
        from repro.core.instance import Chain, Instance, Loads, Star

        p, ld = inst.platform, inst.loads
        ref_inst = Instance((Star if topology == "star" else Chain)(
            w=p.w, z=p.z, tau=p.tau, latency=p.latency),
            Loads(v_comm=ld.v_comm, v_comp=ld.v_comp, release=ld.release,
                  return_ratio=ld.return_ratio), q=inst.q)
        want = ref_simulate(ref_inst, g)
        assert abs(s.makespan - want.makespan) <= RTOL * want.makespan
        for a, b in ((s.comm_start, want.comm_start), (s.comp_start, want.comp_start),
                     (s.comp_end, want.comp_end)):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-12)


def test_rms_norm_never_falls_back_to_the_plain_version():
    """Off the CPU the wrapper launches its kernel or raises: a tensor on
    another device never reaches the plain version."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts, rms_norm

    reset_launch_counts()
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rms_norm(x, torch.empty(8, device="meta"))
    assert launch_counts()["rms_norm"] == 0
