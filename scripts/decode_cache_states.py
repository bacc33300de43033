"""decode_attention at llama3.2-3b's decode step (B 4, H 24 / KVH 8, D 128,
a 544-entry cache, 1 or 544 entries valid) under three states of the L2
cache: flushed by writing 100 MB (``chip_smoke.py``'s method, which leaves
dirty lines to write back), flushed by reading 100 MB (clean lines), and
warm; the kernel and PyTorch's SDPA with the same mask, device ms by CUDA
events (``chip_smoke.device_ms``), and the same method's floor, a one-element
add.

    python scripts/decode_cache_states.py          # from the repo root, one card

Prints the card's name and power limit, then one JSON line per (dtype,
cache length).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import decode_attention  # noqa: E402


def main() -> int:
    print(cs.smi(), flush=True)
    dev = torch.device("cuda")
    B, Smax, H, KVH, D = 4, 544, cs.LLAMA["H"], cs.LLAMA["KVH"], cs.LLAMA["D"]
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    flush = torch.empty(2 * cs.L2_BYTES // 4, device=dev)
    one = torch.zeros(1, device=dev)
    print(json.dumps(dict(floor_add_ms=cs.device_ms(lambda t: t.add_(1.0), lambda: (one,),
                                                    reps=50))), flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        q, kc, vc = (torch.randn(s, generator=gen, device=dev).to(dtype)
                     for s in ((B, 1, H, D), (B, Smax, KVH, D), (B, Smax, KVH, D)))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kc, vc))
        for n in (1, Smax):
            n_t = torch.tensor([n], dtype=torch.int32, device=dev)
            valid = (torch.arange(Smax, device=dev) < n)[None, :]
            row = {}
            for how in ("write", "read", "warm"):
                def prep(*a, how=how):
                    if how == "write":
                        flush.zero_()
                    elif how == "read":
                        flush.sum()
                    return a

                row[how] = cs.device_ms(lambda *a: decode_attention(*a),
                                        lambda: prep(q, kc, vc, n_t), reps=50)
                row["sdpa_" + how] = cs.device_ms(
                    lambda *a: F.scaled_dot_product_attention(*a, attn_mask=valid,
                                                              enable_gqa=True),
                    lambda: prep(qt, kt, vt), reps=50)
            print(json.dumps(dict(dtype=str(dtype), cache_len=n, **row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
