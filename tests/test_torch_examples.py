"""The port's examples (``examples/torch_*.py``) run on the CPU."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_torch_train_dlt_chain_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, str(REPO / "examples" / "torch_train_dlt_chain.py"),
                          "--steps", "6", "--device", "cpu"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("arch=llama3.2-3b-smoke") and "devices=1" in lines[0]
    assert "  FAILURE stage 1 at step 6: replanning" in lines
    assert any(x.startswith("  restored checkpoint step 4; new chain=") for x in lines)
    assert lines[-2].startswith("done: first loss") and "torch_train_dlt_chain OK" in lines[-1]
    (run,) = [p for p in tmp_path.iterdir() if p.name.startswith("repro_torch_dlt_chain_")]
    assert (run / "metrics.json").is_file() and (run / "ckpt" / "step_00000004").is_dir()
