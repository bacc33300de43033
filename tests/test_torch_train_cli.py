"""The port's training CLI (``python -m repro_torch.launch.train``) on the
CPU: it prints the reference driver's lines, checkpoints, resumes where an
uninterrupted run would be, and refuses ``--dlt-chain`` (ROADMAP A.15).
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


def test_cli_refuses_the_dlt_chain_mode():
    with pytest.raises(SystemExit, match="ROADMAP A.15"):
        train.main([*ARGS, "--steps", "1", "--dlt-chain", "2"])


def test_cli_help_says_one_card():
    assert "A.15" in train.__doc__ and "one card" in train.__doc__
