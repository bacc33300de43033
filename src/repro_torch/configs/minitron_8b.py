"""minitron-8b [dense] — pruned nemotron, arXiv:2407.14679; hf.

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""

from repro_torch.config import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="minitron-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=16_384,
        vocab_size=256_000,
        head_dim=128,
        attn_type="full",
        act="swiglu",
        source="arXiv:2407.14679; hf",
    )
)
