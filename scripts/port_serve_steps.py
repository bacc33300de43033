"""Time the port's serving loop on the card: prefill + greedy decode steps of
one served model (``--arch``: one of ``chip_smoke.SERVE_ARCHS``; paligemma-3b
with its seeded patch embeddings) at full size, at ``chip_smoke.py``'s serve
phase's batch, prompt length, step count and seed, three runs after a
warm-up, in a fresh process.

    python scripts/port_serve_steps.py --src src --label change
    python scripts/port_serve_steps.py --src old/src --label parent   # another tree
    python scripts/port_serve_steps.py --arch hymba-1.5b

``--src`` is the ``src`` directory of the tree to time, so two versions of the
port (say a parent commit unpacked with ``git archive``) can be timed in turns
in one call on one card (parent, change, change, parent).  Prints one JSON
line: the card, the prefill seconds and the decode step milliseconds of each
run (host wall time ending in a synchronised card), and for each run the
main thread's CPU seconds and the process's involuntary context switches
(a step that waits for a CPU shows in its wall time but not in its CPU time).
"""

from __future__ import annotations

import argparse
import json
import resource
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUNS = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--arch", default="llama3.2-3b")
    args = ap.parse_args(argv)
    # the tree under test first: chip_smoke puts this tree's src on the path
    # when imported, and a package once imported is the one every later
    # import of it finds
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import repro_torch

    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"imported {repro_torch.__file__}, not from {src}")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import SEED, SERVE_ARCHS, SERVE_B, SERVE_PROMPT, SERVE_STEPS

    if args.arch not in SERVE_ARCHS:
        ap.error(f"--arch must be one of {', '.join(SERVE_ARCHS)}")

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this timing needs the card", file=sys.stderr)
        return 2
    from repro_torch.config import get_arch
    from repro_torch.launch.serve import (generate, load_model, prompt_patches, prompt_tokens,
                                          serve_policy)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(args.arch)
    dev = torch.device("cuda")
    model = load_model(cfg, SEED, dev)
    prompt = prompt_tokens(cfg, SERVE_B, SERVE_PROMPT, SEED, dev)
    patches = prompt_patches(cfg, SERVE_B, SERVE_PROMPT, SEED, dev)  # None but for vlm
    policy = serve_policy(SERVE_PROMPT)
    generate(model, cfg, policy, prompt, 2, patches=patches)  # first-call costs
    prefill_s, step_ms, cpu_s, preempted = [], [], [], []
    for _ in range(RUNS):
        cpu0, nivcsw0 = time.thread_time(), resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw
        res = generate(model, cfg, policy, prompt, SERVE_STEPS, patches=patches)
        cpu_s.append(time.thread_time() - cpu0)
        preempted.append(resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw - nivcsw0)
        prefill_s.append(res.prefill_s)
        step_ms.append(1e3 * res.decode_s / SERVE_STEPS)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "arch": cfg.name, "card": card, "prefill_s": prefill_s,
                      "decode_step_ms": step_ms, "cpu_s": cpu_s,
                      "involuntary_switches": preempted}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
