"""llama3.2-3b [dense] — hf:meta-llama (unverified).

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256 — small llama3.
"""

from repro_torch.config import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="llama3.2-3b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=128_256,
        head_dim=128,
        attn_type="full",
        act="swiglu",
        rope_theta=500_000.0,
        tie_embeddings=True,
        source="hf:meta-llama/Llama-3.2-1B; unverified",
    )
)
