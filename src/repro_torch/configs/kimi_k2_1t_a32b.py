"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table), arXiv:2501.kimi2
(unverified).

61L d_model=7168 64H (GQA kv=8) d_ff(expert)=2048 vocab=163840,
MoE 384 routed top-8.  head_dim = 7168/64 = 112.
The assignment table says GQA kv=8 (the released K2 uses MLA) — we follow the
assignment table.
"""

from repro_torch.config import ArchConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        d_ff=2048,
        vocab_size=163_840,
        head_dim=112,
        attn_type="full",
        moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048, num_shared=1),
        source="arXiv:2501.kimi2; unverified",
    )
)
