"""phi4-mini-3.8b [dense] — arXiv:2412.08905; hf.

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064 — RoPE SwiGLU GQA.
"""

from repro_torch.config import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="phi4-mini-3.8b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=200_064,
        head_dim=128,
        attn_type="full",
        act="swiglu",
        tie_embeddings=True,
        source="arXiv:2412.08905; hf",
    )
)
