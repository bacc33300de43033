"""The port's examples (``examples/torch_*.py``) run on the CPU; the
quickstart, multi-load serving and elastic restart examples print and
return the reference examples' deterministic numbers (makespans, plans)
within 1e-9."""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-9


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


# ------------------------------------------ the three examples against the reference's

REF_CHILD = r"""
import contextlib, io, pickle, runpy, sys
import numpy as np
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
examples, ckpt, dst = sys.argv[1], sys.argv[2], sys.argv[3]
out = {}

def heuristics(g, inst):
    return {name: fn(inst).makespan for name, fn in
            (("SIMPLE", g["simple"]), ("SINGLEINST", g["single_inst"]),
             ("MULTIINST", lambda i: g["multi_inst"](i, cap=g["_cap"])))}

g = runpy.run_path(f"{examples}/quickstart.py", run_name="__main__")
g["_cap"] = 300
out["quickstart"] = dict(
    paper=g["art"].makespan, paper_gamma=np.asarray(g["art"].gamma),
    heuristics=heuristics(g, g["example_instance"](0.75)), star=g["star_art"].makespan,
    star_closed_form=float(g["cf"]), ret=g["ret_art"].makespan,
    ret_end=float(g["ret_art"].schedule().ret_end.max()), submits=list(g["makespans"]),
    last_replan=g["update"].makespan, served=g["served"].makespan,
    restarted=g["warm"].makespan, auto=dict(g["auto"].makespans), t_star=g["auto"].t_star,
    plan=g["plan"].makespan, samples=np.asarray(g["plan"].samples).tolist())
g = runpy.run_path(f"{examples}/serve_multiload.py", run_name="__main__")
g["_cap"] = 100
out["serve_multiload"] = dict(
    plan=g["plan"].makespan, samples=np.asarray(g["plan"].samples).tolist(),
    cells=[list(c) for c in g["plan"].cells],
    heuristics=heuristics(g, g["planner"].to_instance(g["loads"], q=1)))
src = open(f"{examples}/elastic_restart.py").read().replace("/tmp/repro_elastic_ckpt", ckpt)
g = {"__name__": "__main__"}
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    exec(compile(src, f"{examples}/elastic_restart.py", "exec"), g)
chain = g["chain"]
out["elastic_restart"] = dict(
    lines=buf.getvalue().splitlines(), final=(chain.plan.makespan,
                                              [list(map(int, s)) for s in chain.plan.samples]),
    log=list(chain.log), replans=chain.replans)
with open(dst, "wb") as f:
    pickle.dump(out, f)
"""


class _Reference:
    """The reference's three examples, run once in a child process (with
    the ``jax.experimental.enable_x64`` alias, ROADMAP C.1) while the port's
    examples run here; ``result()`` waits for it."""

    def __init__(self, tmp: Path):
        self.dst = tmp / "ref.pkl"
        env = dict(os.environ, JAX_PLATFORMS="cpu", TMPDIR=str(tmp),
                   PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                               os.environ.get("PYTHONPATH", "")]))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", REF_CHILD, str(REPO / "examples"), str(tmp / "ckpt"),
             str(self.dst)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.out = None

    def result(self) -> dict:
        if self.out is None:
            _, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, err[-3000:]
            import pickle

            with open(self.dst, "rb") as f:
                self.out = pickle.load(f)
        return self.out


@pytest.fixture(scope="module")
def reference_examples(tmp_path_factory):
    ref = _Reference(tmp_path_factory.mktemp("ref_examples"))
    yield ref
    ref.proc.kill()


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(a, b) -> bool:
    return abs(a - b) <= RTOL * abs(b)


def test_torch_quickstart_matches_the_reference_example(reference_examples, capsys, tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    got = _example("torch_quickstart").main(["--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-1] == "torch_quickstart OK"
    want = reference_examples.result()["quickstart"]
    for key in ("paper", "star", "star_closed_form", "ret", "ret_end", "served", "restarted",
                "plan"):
        assert _close(got[key], want[key]), key
    assert _close(got["paper_simplex"], want["paper"]) and _close(got["paper_engine"],
                                                                   want["paper"])
    np.testing.assert_allclose(got["paper_gamma"], want["paper_gamma"], rtol=0, atol=1e-9)
    for name, v in want["heuristics"].items():
        assert _close(got[f"heuristic_{name}"], v), name
    assert len(got["submits"]) == 20 and all(map(_close, got["submits"], want["submits"]))
    assert _close(got["replans"][-1], want["last_replan"])
    assert got["auto"].keys() == want["auto"].keys() and got["t_star"] == want["t_star"]
    assert all(_close(got["auto"][q], want["auto"][q]) for q in want["auto"])
    assert got["samples"] == want["samples"]
    assert all(np.isfinite(got["losses"]))
    assert not [p for p in os.listdir(tmp_path) if p.startswith("torch_quickstart_")]  # store


def test_torch_serve_multiload_matches_the_reference_example(reference_examples, capsys):
    got = _example("torch_serve_multiload").main(["--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-1] == "torch_serve_multiload OK"
    want = reference_examples.result()["serve_multiload"]
    assert _close(got["plan"], want["plan"])
    assert got["samples"] == want["samples"] and got["cells"] == want["cells"]
    for name, v in want["heuristics"].items():
        assert _close(got[f"heuristic_{name}"], v), name
    assert got["tokens"] == 3 * 6 * 8 and len(got["heads"]) == 3


def test_torch_elastic_restart_matches_the_reference_example(reference_examples, capsys,
                                                             tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    got = _example("torch_elastic_restart").main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("torch_elastic_restart OK")
    want = reference_examples.result()["elastic_restart"]

    def plan_lines(ls):
        return [x for x in ls if x.startswith(("phase 1:", "  surviving chain:", "  chain:",
                                              "  restored checkpoint"))]

    assert plan_lines(lines) == plan_lines(want["lines"])  # the three plans, as printed
    makespan, samples = got["plans"][-1]
    assert _close(makespan, want["final"][0]) and samples == want["final"][1]
    assert got["replans"] == want["replans"] == 2
    assert [e[:2] for e in got["log"]] == [e[:2] for e in want["log"]]
    assert all(_close(a[2], b[2]) for a, b in zip(got["log"], want["log"]))
    assert got["restored_step"] == 3 and got["ckpt"].startswith(str(tmp_path))
    assert not os.path.exists(got["ckpt"])  # the checkpoints are removed
