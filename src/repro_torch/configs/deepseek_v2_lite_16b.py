"""deepseek-v2-lite-16b [moe] — MLA + DeepSeekMoE, arXiv:2405.04434; hf.

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400, MoE 64 routed top-6 +
2 shared, MLA kv_lora=512.

NOTE (DESIGN.md §Known config notes): the assignment header says "64e top-6"
while its detail note says "160 routed"; the HF config of V2-Lite is 64 routed
+ 2 shared, top-6 — we implement the header (= HF).  The real model's dense
first layer is homogenized to MoE in all layers (scan-over-layers).
"""

from repro_torch.config import ArchConfig, MLAConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,
        vocab_size=102_400,
        head_dim=128,
        attn_type="full",
        moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2),
        mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
        source="arXiv:2405.04434; hf",
    )
)
