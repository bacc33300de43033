"""musicgen-medium [audio] — decoder-only over EnCodec tokens, arXiv:2306.05284; hf.

48L d_model=1536 24H (GQA kv=24, i.e. MHA) d_ff=6144 vocab=2048.
The EnCodec codec is a STUB per the assignment: inputs are 4 parallel
codebook token streams (summed embeddings in, 4 prediction heads out; the
release's codebook delay pattern is a data-layout concern handled by the
pipeline, not the backbone).
"""

from repro_torch.config import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        head_dim=64,
        attn_type="full",
        act="geglu",
        frontend="encodec_stub",
        num_codebooks=4,
        source="arXiv:2306.05284; hf",
    )
)
