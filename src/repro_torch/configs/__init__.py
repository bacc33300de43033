"""Assigned architecture configs (public-literature).  Importing this package
registers all architectures with repro_torch.config."""

from . import (  # noqa: F401
    deepseek_v2_lite_16b,
    hymba_1_5b,
    kimi_k2_1t_a32b,
    llama3_2_3b,
    mamba2_2_7b,
    minitron_8b,
    mistral_large_123b,
    musicgen_medium,
    paligemma_3b,
    phi4_mini_3_8b,
)

ARCH_IDS = [
    "phi4-mini-3.8b",
    "llama3.2-3b",
    "mistral-large-123b",
    "minitron-8b",
    "paligemma-3b",
    "mamba2-2.7b",
    "deepseek-v2-lite-16b",
    "kimi-k2-1t-a32b",
    "hymba-1.5b",
    "musicgen-medium",
]
