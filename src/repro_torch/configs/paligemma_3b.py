"""paligemma-3b [vlm] — SigLIP + gemma, arXiv:2407.07726; hf.

18L d_model=2048 8H (GQA kv=1, i.e. MQA) d_ff=16384 vocab=257216.
Backbone only per the assignment: the SigLIP frontend is a STUB —
``input_specs()`` provides precomputed patch embeddings
[B, num_patches=256, patch_dim=1152] which a linear projector maps to d_model.
"""

from repro_torch.config import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="paligemma-3b",
        family="vlm",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        d_ff=16_384,
        vocab_size=257_216,
        head_dim=256,
        attn_type="full",
        act="geglu",
        tie_embeddings=True,
        frontend="siglip_stub",
        num_patches=256,
        patch_dim=1152,
        source="arXiv:2407.07726; hf",
    )
)
