"""End-to-end run of the port: train a model with the DLT chain runner,
the paper's installment schedule executed over a 4-stage chain, with a
mid-run stage failure, checkpoint restore, LP replanning, and a straggler
slow-down.

A thin wrapper over ``repro_torch.launch.train`` with the flags of
``examples/train_dlt_chain.py``: the smoke config, 4 stages in one process
(a ``LocalChain``) on the card, or on the CPU with ``--device cpu``.  The
checkpoints and the metrics go to a fresh temporary directory.  Under
``torchrun --nproc-per-node 4`` each process is one stage.

Run:  PYTHONPATH=src python examples/torch_train_dlt_chain.py [--steps 200] [--device cpu]
"""

import argparse
import os
import tempfile

from repro_torch.launch import train

N_STAGES = 4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    out = tempfile.mkdtemp(prefix="repro_torch_dlt_chain_")
    metrics = os.path.join(out, "metrics.json")
    train.main([
        "--arch", "llama3.2-3b", "--smoke",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "32",
        "--dlt-chain", str(N_STAGES), "--dlt-q", "2", "--dlt-loads", "2",
        "--ckpt-dir", os.path.join(out, "ckpt"), "--save-every", "5",
        "--fail", f"1@step{max(6, args.steps // 3)}",
        "--straggle", "3@step3x2.0",
        "--metrics-out", metrics,
        *(["--device", args.device] if args.device else []),
    ])
    print(f"torch_train_dlt_chain OK (see {metrics})")


if __name__ == "__main__":
    main()
