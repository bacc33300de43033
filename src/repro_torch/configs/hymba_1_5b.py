"""hymba-1.5b [hybrid] — parallel attn+mamba heads, arXiv:2411.13676; hf.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
head_dim = 1600/25 = 64.  Sliding-window attention (window 1024) in every
layer (the released model's few global layers + meta tokens are simplified
away — DESIGN.md §Known config notes); the SSM branch runs in parallel with
the attention branch inside each block.
"""

from repro_torch.config import ArchConfig, SSMConfig, register

CONFIG = register(
    ArchConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        d_ff=5504,
        vocab_size=32_001,
        head_dim=64,
        attn_type="swa",
        window=1024,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=64, d_conv=4, chunk=256),
        source="arXiv:2411.13676; hf",
    )
)
