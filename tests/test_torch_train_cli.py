"""The port's training CLI (``python -m repro_torch.launch.train``) on the
CPU: it prints the reference driver's lines, checkpoints, resumes where an
uninterrupted run would be, and runs the ``--dlt-chain`` mode (a failure
shrinks the chain and restores the checkpoint, a straggler replans) with
the reference's lines; a torch.distributed world that is not the chain is
refused; the standard mode trains data parallel under ``torchrun`` (two
gloo ranks print one rank's losses) and steps under its data mesh.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import train
from repro_torch.runtime import make_train_step

REPO = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "llama3.2-3b", "--smoke", "--device", "cpu", "--batch", "4", "--seq", "32"]


def _template(line: str) -> str:
    """A printed line with its numbers replaced (the format, not the values)."""
    return re.sub(r"-?\d+(\.\d+)?(e[-+]\d+)?", "#", line.strip())


def _steps(out: str) -> dict:
    return {int(m.group(1)): (m.group(2), m.group(3))
            for m in re.finditer(r"^step +(\d+) loss (\S+) lr (\S+) \d+ms$", out, re.M)}


def test_cli_prints_the_reference_lines_checkpoints_and_resumes(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    first = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS, "--steps", "3",
         "--ckpt-dir", str(ckpt), "--save-every", "1"],
        env=env, capture_output=True, text=True, timeout=300)
    assert first.returncode == 0, first.stderr[-3000:]
    assert sorted(os.listdir(ckpt)) == ["step_00000000", "step_00000001", "step_00000002"]
    straight = first.stdout
    # a run cut after step 1's checkpoint resumes there and retakes step 2
    shutil.rmtree(ckpt / "step_00000002")
    train.main([*ARGS, "--steps", "3", "--ckpt-dir", str(ckpt), "--resume",
                "--metrics-out", str(tmp_path / "m.json")])
    resumed = capsys.readouterr().out
    assert "resumed from step 1" in resumed
    assert list(_steps(resumed)) == [2]
    assert [m["step"] for m in json.loads((tmp_path / "m.json").read_text())] == [2]
    assert _steps(resumed)[2] == _steps(straight)[2]  # loss and lr, printed to 4 digits

    # the reference's driver prints the same lines (its own weights, so
    # other values): arch/params/devices, one line a step, the summary
    from repro.launch import train as ref_train

    ref_train.main(["--arch", "llama3.2-3b", "--smoke", "--batch", "4", "--seq", "32",
                    "--steps", "3"])
    ref_out = capsys.readouterr().out
    assert straight.splitlines()[0] == ref_out.splitlines()[0]  # arch=... params=... devices=1
    assert [_template(x) for x in straight.splitlines()] == \
        [_template(x) for x in ref_out.splitlines()]


CHAIN = [*ARGS[:-4], "--batch", "4", "--seq", "16", "--dlt-chain", "4", "--dlt-q", "2",
         "--dlt-loads", "1", "--steps", "4", "--fail", "1@step3", "--straggle", "3@step1x2.0",
         "--save-every", "2"]


def test_cli_runs_the_dlt_chain_with_a_failure_and_a_straggler(tmp_path, capsys):
    train.main([*CHAIN, "--ckpt-dir", str(tmp_path / "ck"),
                "--metrics-out", str(tmp_path / "m.json")])
    out = capsys.readouterr().out
    assert "  FAILURE stage 1 at step 3: replanning" in out
    assert "  restored checkpoint step 1; new chain=['pod0', 'pod2', 'pod3']" in out
    assert "straggler replan (stage 3)" in out and out.splitlines()[-1].startswith("done: ")
    log = json.loads((tmp_path / "m.json").read_text())
    assert [m["stages"] for m in log] == [4, 4, 4, 3]
    assert all(sum(map(sum, m["samples"])) == 4 for m in log)  # one load of 4 a super-step
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000001", "step_00000003"]


def test_cli_dlt_chain_prints_the_reference_lines(tmp_path):
    """The same flags through both CLIs (the reference's with 4 forced
    host devices, in a child): the same lines, numbers aside."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.run(
        [sys.executable, "-m", "repro.launch.train",
         *[a for a in CHAIN if a not in ("--device", "cpu")],
         "--ckpt-dir", str(tmp_path / "ref")],
        env=env, capture_output=True, text=True, timeout=600)
    assert ref.returncode == 0, ref.stderr[-3000:]
    env.pop("XLA_FLAGS")
    port = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *CHAIN,
         "--ckpt-dir", str(tmp_path / "port")],
        env=env, capture_output=True, text=True, timeout=300)
    assert port.returncode == 0, port.stderr[-3000:]
    got, want = port.stdout.splitlines(), ref.stdout.splitlines()
    assert len(got) == len(want) == 12
    assert [_template(x) for x in got] == [_template(x) for x in want]
    # the plans are the serial planner's on both sides: those lines are equal
    plans = [k for k, x in enumerate(want) if "samples=" in x or "new chain=" in x]
    assert len(plans) == 5 and all(got[k] == want[k] for k in plans)


def test_cli_refuses_a_world_that_is_not_the_chain(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="chain of 2 needs a torch.distributed world "
                                               "of 2 processes, found 1"):
            train.main([*ARGS, "--steps", "1", "--dlt-chain", "2"])
        # the standard mode trains over the group: a (1, 1) data mesh
        train.main([*ARGS, "--steps", "1", "--metrics-out", str(tmp_path / "m.json")])
        (m,) = json.loads((tmp_path / "m.json").read_text())
        assert m["step"] == 0 and m["loss"] > 0
    finally:
        dist.destroy_process_group()


def test_standard_mode_steps_under_its_data_mesh(tmp_path, monkeypatch):
    import torch.distributed as dist

    from repro_torch.models import current_mesh

    seen = []

    def recording(*a, **kw):
        step = make_train_step(*a, **kw)

        def run(state, batch):
            seen.append(current_mesh())
            return step(state, batch)
        return run

    monkeypatch.setattr(train, "make_train_step", recording)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1)
    try:
        args = train.parse_args([*ARGS, "--steps", "2"])
        train.run_standard(args, *train.build_cfg(args))
    finally:
        dist.destroy_process_group()
    assert len(seen) == 2 and seen[0] is seen[1]
    assert seen[0].mesh_dim_names == ("data", "model") and tuple(seen[0].shape) == (1, 1)
    assert current_mesh() is None


def test_standard_mode_trains_under_torchrun_on_two_gloo_ranks(tmp_path):
    """``torchrun --nproc-per-node 2``: the state sharded over two ranks,
    each on half of every batch; the printed losses are one process's."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), GLOO_SOCKET_IFNAME="lo")
    argv = [*ARGS, "--steps", "3", "--ckpt-dir", str(tmp_path / "ck"), "--save-every", "3"]
    two = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.train", *argv], env=env, capture_output=True, text=True,
        timeout=300)
    assert two.returncode == 0, two.stderr[-3000:]
    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *argv[:-4]],
                         env=env, capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    lines = two.stdout.splitlines()
    assert lines[0].endswith("devices=2 backend=gloo")
    assert len(_steps(two.stdout)) == 3 and _steps(two.stdout) == _steps(one.stdout)
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000002"]  # rank 0 wrote it


def test_standard_mode_refuses_a_batch_the_ranks_cannot_split():
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_data_mesh

    args = train.parse_args([*ARGS[:-4], "--batch", "3", "--seq", "32", "--steps", "1"])
    with fake_world(2):  # rank 0 of two: the check comes before any collective
        with pytest.raises(ValueError, match="--batch 3 does not split over 2 data ranks"):
            train.run_standard(args, *train.build_cfg(args), mesh=make_data_mesh("cpu"))
