"""mamba2-2.7b [ssm] — SSD (state-space duality), arXiv:2405.21060 (unverified).

64L d_model=2560 (attn-free) d_ff=0 vocab=50280, ssm_state=128.
d_inner = 2*d_model = 5120, head_dim 64 -> 80 SSD heads.
"""

from repro_torch.config import ArchConfig, SSMConfig, register

CONFIG = register(
    ArchConfig(
        name="mamba2-2.7b",
        family="ssm",
        num_layers=64,
        d_model=2560,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50_280,
        head_dim=64,
        attn_type="none",
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, d_conv=4, chunk=256),
        source="arXiv:2405.21060; unverified",
    )
)
