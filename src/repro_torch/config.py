"""Architecture + run configuration system.

A copy of the reference's ``config.py`` (the port imports nothing of it).
Every assigned architecture lives in ``repro_torch/configs/<id>.py`` as an
:class:`ArchConfig`; shapes are :class:`ShapeConfig`; the serving path's
knobs are :class:`ShardingPolicy`.  Reduced "smoke" variants for CPU tests
come from :func:`smoke_variant`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = [
    "MoEConfig",
    "MLAConfig",
    "SSMConfig",
    "ArchConfig",
    "ShapeConfig",
    "ShardingPolicy",
    "TrainConfig",
    "SHAPES",
    "smoke_variant",
    "get_arch",
    "list_archs",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int  # routed experts
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    d_conv: int = 4
    chunk: int = 64  # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_type: str = "full"  # full | swa | none
    window: int = 0  # sliding-window size when attn_type == "swa"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    act: str = "swiglu"  # swiglu | geglu
    tie_embeddings: bool = False
    # modality frontends (stubs per the assignment)
    frontend: Optional[str] = None  # siglip_stub | encodec_stub
    num_patches: int = 0  # vlm: prefix length of patch embeddings
    patch_dim: int = 0  # vlm: precomputed patch-embedding dim
    num_codebooks: int = 1  # audio: EnCodec codebooks
    source: str = ""  # provenance note

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows padded to 256 (MaxText-style) so the vocab
        axis divides every mesh axis; logits are sliced back before the
        softmax, token ids never reach the pad rows."""
        return -(-self.vocab_size // 256) * 256

    @property
    def has_attention(self) -> bool:
        return self.attn_type != "none"

    @property
    def has_ssm(self) -> bool:
        return self.ssm is not None

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: bounded decode state (SSM and/or SWA-only)."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid" and self.attn_type == "swa":
            return True
        return False


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


#: the assigned input-shape set (same for every LM arch in the pool)
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """The knobs of the reference's policy that the port's serving,
    training and sharding paths read.

    ``model_axis``, ``fsdp_params``, ``expert_axis`` and ``expert_ff_axis``
    steer the sharding rules of :mod:`repro_torch.runtime.sharding` as they
    steer the reference's: ``fsdp_params`` shards each weight's ``d_in``
    over the data axes (FSDP / ZeRO-3), ``expert_axis`` the experts' dimension
    and ``expert_ff_axis`` each expert's ``d_ff``.

    ``remat``: ``"block"`` recomputes each decoder block's activations in
    the backward pass (the reference's ``jax.checkpoint`` per block) and
    ``"none"`` keeps them; it changes memory, never a value.

    ``attention_impl``: ``"naive"`` (materialized scores), ``"chunked"``
    (online softmax over q/kv chunks) or ``"cuda"`` (the hand-written
    kernels in :mod:`repro_torch.kernels`; the reference calls its Pallas
    kernels ``"pallas"``).  ``moe_impl``: the experts' dispatch,
    ``"gshard"`` (capacity buckets) or ``"dense"`` (every token through
    every expert, the oracle).

    ``shard_seq_attn``, ``qkv_feature_shard`` and ``sp_activations`` are
    the reference's activation layouts on a model axis wider than 1
    (prefill attention sequence-sharded, else on each rank's heads; q
    projected feature-sharded; the residual stream sequence-sharded:
    Megatron sequence parallelism); they change no value.
    ``prefill_last_logit_only``: a prefill returns the last position's
    logits alone ([B, 1, V]), the only ones sampling reads, and the head
    never makes the others.  On a model axis the int8 cache, the kernels
    (they serve only: they have no backward) and both expert layouts run;
    the port refuses a model axis not named 'model' (ROADMAP A.18) and the
    experts and their d_ff over one axis (C.20).
    """

    remat: str = "block"  # none | block (recompute each block in the backward)
    attention_impl: str = "chunked"  # naive | chunked | cuda
    attn_chunk: int = 1024  # q-chunk for the online-softmax attention
    attn_block_skip: bool = False  # skip fully masked kv blocks (chunked)
    logits_fp32: bool = True
    kv_cache_dtype: str = "bf16"  # "int8": per-(token, kv-head) scaled cache
    moe_impl: str = "gshard"  # gshard (capacity dispatch) | dense (the oracle)
    model_axis: str = "model"
    fsdp_params: bool = True  # shard dim0 of weights over 'data' (ZeRO-3 style)
    expert_axis: str = "data"  # axis sharding the expert dimension
    expert_ff_axis: str = "model"  # axis sharding each expert's d_ff
    shard_seq_attn: bool = True  # sequence-sharded attention (vs each rank's heads)
    qkv_feature_shard: bool = True  # project q feature-sharded (then a2a to seq-sharded)
    prefill_last_logit_only: bool = False  # serving: emit only logits[:, -1:]
    sp_activations: bool = False  # sequence parallelism: residual stream seq-sharded


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    microbatches: int = 1  # gradient-accumulation installments
    optimizer_state_dtype: str = "float32"
    param_dtype: str = "bfloat16"
    seed: int = 0


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Reduced config of the same family for CPU smoke tests."""
    kw: dict = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, d_ff_expert=32, num_shared=min(cfg.moe.num_shared, 1)
        )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=8)
    if cfg.window:
        kw["window"] = 32
    if cfg.family == "vlm":
        kw["num_patches"] = 8
        kw["patch_dim"] = 32
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)


_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_archs() -> list:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    # importing repro_torch.configs populates the registry
    import repro_torch.configs  # noqa: F401
