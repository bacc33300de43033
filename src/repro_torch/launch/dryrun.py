"""Production-mesh dry run: build every (architecture x input shape) cell
on the reference's production meshes without a card, and record what a
run without XLA can say about it.  The port of the reference's
``launch/dryrun.py``, with its flags.

  python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both      # 80 records under build/dryrun

Per cell this builds the mesh (``make_production_mesh``: 256 or 512 ranks
over a fake process group in this one process), the cell
(``launch/specs.build_cell``: the step function, its inputs on the meta
device, their placements), and from DTensor's own split of each input
leaf over the mesh the bytes of arguments one device holds.  The record
keeps the reference's keys where they can be filled: ``status`` /
``skip_reason``, ``devices``, ``params_total`` / ``params_active``,
``model_flops``, ``memory.argument_size_in_bytes`` (per device, the
largest shard of each leaf), ``fits`` against the card's memory
(``HW.HBM_BYTES``) and a roofline from ``HW``'s H100 constants (the model's
FLOPs over the bfloat16 peak against the arguments read once over HBM).
The keys only XLA's compiler gives (``temp_size_in_bytes``,
``bytes_accessed_per_device``, ``collectives``, ``hlo_bytes``,
``compile_s``, ``flops_per_device``) are ``null``, each with its reason
under ``not_applicable``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback


from repro_torch.config import SHAPES, ShardingPolicy, TrainConfig, get_arch
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.launch.specs import build_cell, cell_skip_reason
from repro_torch.models import Transformer
from repro_torch.models.flops import decode_flops_per_token, param_counts, train_flops_per_token
from repro_torch.optim import AdamWState
from repro_torch.runtime import TrainState

__all__ = ["ARCH_ORDER", "SHAPE_ORDER", "model_flops", "fake_world", "argument_bytes",
           "run_cell", "main"]

ARCH_ORDER = [
    "phi4-mini-3.8b", "llama3.2-3b", "mistral-large-123b", "minitron-8b",
    "paligemma-3b", "mamba2-2.7b", "deepseek-v2-lite-16b", "kimi-k2-1t-a32b",
    "hymba-1.5b", "musicgen-medium",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
WORLD = 512  # the multi-pod mesh's ranks; the single-pod mesh takes the first 256

_XLA_ONLY = ("XLA's compiled program gives it (memory_analysis / cost_analysis / HLO); "
             "PyTorch has none")
NOT_APPLICABLE = {
    "temp_size_in_bytes": _XLA_ONLY,
    "bytes_accessed_per_device": _XLA_ONLY,
    "collectives": "the reference parses XLA's post-SPMD HLO (launch/hlo.py); PyTorch emits none, "
                   "and the port's collectives run only on real ranks (CommDebugMode in "
                   "scripts/fsdp_dist.py)",
    "hlo_bytes": "no HLO: PyTorch does not lower to XLA",
    "compile_s": "nothing is compiled: the port's step runs eagerly",
    "flops_per_device": "the reference counts the dot FLOPs of XLA's HLO; model_flops / devices "
                        "stands in for the roofline's compute term",
}


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS for the roofline: 6·N·D train (N_active for MoE),
    2·N_active per decoded token + attention reads."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return train_flops_per_token(cfg, S) * B * S
    if shape.kind == "prefill":
        return train_flops_per_token(cfg, S) / 3.0 * B * S  # fwd only
    return decode_flops_per_token(cfg, S) * B  # one token per stream


@contextlib.contextmanager
def fake_world(size: int = WORLD):
    """A fake ``torch.distributed`` world of ``size`` ranks in this process
    (this process is rank 0; no collective moves data), torn down after."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process without a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _pairs(arg, sharding):
    """(tensor, NamedSharding) for every leaf of an input and its placements."""
    if isinstance(arg, TrainState):
        yield from _pairs(arg.params, sharding.params)
        yield from _pairs(arg.opt, sharding.opt)
    elif isinstance(arg, AdamWState):
        for f in ("step", "m", "v"):
            yield from _pairs(getattr(arg, f), getattr(sharding, f))
    elif isinstance(arg, Transformer):
        yield from _pairs(dict(arg.named_parameters()), sharding)
    elif isinstance(arg, dict):
        if set(arg) != set(sharding):
            raise ValueError(f"inputs {sorted(arg)} against placements {sorted(sharding)}")
        for k in arg:
            yield from _pairs(arg[k], sharding[k])
    else:
        yield arg, sharding


def argument_bytes(cell) -> int:
    """Bytes of the cell's inputs one device holds: each leaf's shard on
    this rank (rank 0 takes the largest piece of an uneven split)."""
    return sum(math.prod(sh.shard_shape(t.shape)) * t.element_size()
               for arg, shs in zip(cell.args, cell.in_shardings) for t, sh in _pairs(arg, shs))


def run_cell(arch: str, shape_name: str, multi_pod: bool, policy=None, tcfg=None,
             verbose=True) -> dict:
    """One record; needs a (fake) world of at least the mesh's ranks."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    policy = policy or ShardingPolicy()
    tcfg = tcfg or TrainConfig()
    mesh_name = "multi" if multi_pod else "single"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "ok",
           "kind": shape.kind,
           "policy": {f.name: str(getattr(policy, f.name)) for f in dataclasses.fields(policy)}}
    reason = cell_skip_reason(cfg, shape)
    if reason:
        rec.update(status="skip", skip_reason=reason)
        return rec
    try:
        t0 = time.time()
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        n_dev = mesh.size()
        cell = build_cell(mesh, cfg, shape, policy, tcfg)
        arg_bytes = argument_bytes(cell)
        pc = param_counts(cfg)
        mf = model_flops(cfg, shape)
        t_compute = mf / n_dev / HW.PEAK_FLOPS_BF16
        t_memory = arg_bytes / HW.HBM_BW
        rec.update(
            devices=n_dev,
            build_s=round(time.time() - t0, 3),
            params_total=int(pc.total),
            params_active=int(pc.active),
            model_flops=float(mf),
            model_flops_per_device=float(mf / n_dev),
            memory={"argument_size_in_bytes": int(arg_bytes), "temp_size_in_bytes": None},
            fits=bool(arg_bytes <= HW.HBM_BYTES),
            hbm_bytes=HW.HBM_BYTES,
            roofline={
                "compute_s": t_compute,
                "memory_s": t_memory,
                "collective_s": None,
                "bottleneck": "compute" if t_compute >= t_memory else "memory",
                "constants": "H100 SXM data sheet: bfloat16 dense peak, HBM3 rate",
            },
            **{k: None for k in NOT_APPLICABLE if k != "temp_size_in_bytes"},
            not_applicable=dict(NOT_APPLICABLE),
        )
        if verbose:
            print(f"[{arch} × {shape_name} × {mesh_name}] devices={n_dev} "
                  f"args/dev={arg_bytes:.3e}B fits={rec['fits']} "
                  f"compute={t_compute:.3e}s memory={t_memory:.3e}s "
                  f"bottleneck={rec['roofline']['bottleneck']}")
    except Exception as e:  # a failure here is a framework bug — record it
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[{arch} × {shape_name} × {mesh_name}] FAILED: {rec['error']}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="run every (arch × shape)")
    ap.add_argument("--out-dir", default=os.path.join("build", "dryrun"))
    ap.add_argument("--policy-json", default=None,
                    help="ShardingPolicy field overrides as JSON")
    ap.add_argument("--tag", default="", help="suffix for output files")
    args = ap.parse_args(argv)

    policy = None
    if args.policy_json:
        policy = dataclasses.replace(ShardingPolicy(), **json.loads(args.policy_json))
    if os.path.normpath(args.out_dir).split(os.sep)[0] == "bench_out":
        raise SystemExit("bench_out/ holds the reference's committed records; write the "
                         "port's under build/")
    os.makedirs(args.out_dir, exist_ok=True)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(a, s) for a in ARCH_ORDER for s in SHAPE_ORDER]
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    n_err = 0
    with fake_world(WORLD):
        for arch, shape in cells:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, policy=policy)
                n_err += rec["status"] == "error"
                tag = ("_" + args.tag) if args.tag else ""
                fn = f"{args.out_dir}/{arch}_{shape}_{'multi' if mp else 'single'}{tag}.json"
                with open(fn, "w") as f:
                    json.dump(rec, f, indent=1)
    print(f"done; {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
