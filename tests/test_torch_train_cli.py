"""The port's training CLI (``python -m repro_torch.launch.train``) on the
CPU: it prints the reference driver's lines, checkpoints, resumes where an
uninterrupted run would be, and runs the ``--dlt-chain`` mode (a failure
shrinks the chain and restores the checkpoint, a straggler replans) with
the reference's lines; a torch.distributed world that is not the chain is
refused.
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
        with pytest.raises(SystemExit, match="A.17"):
            train.main([*ARGS, "--steps", "1"])
    finally:
        dist.destroy_process_group()
