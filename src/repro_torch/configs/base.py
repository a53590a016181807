"""Config dataclasses: architectures, input shapes, parallelism, training.

The port's own copy of ``repro.configs.base`` (values identical, ``source``
strings included). Every architecture gets one ``ArchConfig`` in its own
module under ``repro_torch.configs``; the registry in
``repro_torch.configs.__init__`` resolves ``--arch <id>``. CPU tests run
``smoke_config(cfg)`` reductions; ``launch.serve --no-smoke`` builds the
full config on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int            # routed experts
    top_k: int
    expert_d_ff: int            # hidden width per routed expert
    num_shared: int = 0         # always-on shared experts
    shared_d_ff: int = 0        # hidden width of the shared expert block
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense|moe|ssm|hybrid|encdec_audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int             # == n_heads for MHA; 0 for attention-free layers
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    mlp: str = "swiglu"         # swiglu|geglu|relu2
    norm: str = "rmsnorm"
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    max_seq_len: int = 131072
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    n_dense_head: int = 0       # leading dense layers before MoE (DeepSeek: 1)
    # layer-type cycle, e.g. ("rglru","rglru","local_attn") for recurrentgemma
    block_pattern: Tuple[str, ...] = ("attn",)
    window: int = 2048          # local_attn window
    rnn_width: Optional[int] = None   # RG-LRU lru width (defaults d_model)
    rnn_heads: int = 1          # RG-LRU block-diagonal heads / RWKV heads
    conv_width: int = 4         # temporal conv in recurrent block
    encoder_layers: int = 0     # enc-dec: encoder depth (decoder = n_layers)
    prefix_len: int = 256       # vlm/audio stub: prefix embedding positions
    frontend: str = "none"      # none|audio|vision (stubbed: precomputed embeds)
    source: str = ""            # provenance note [paper/hf; tier]
    sub_quadratic: bool = False # supports long_500k decode

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so embedding/logits shard over model=16
        (standard vocab padding; pad ids are never emitted as labels)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def pattern_for_layer(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    def layer_types(self) -> Tuple[str, ...]:
        return tuple(self.pattern_for_layer(i) for i in range(self.n_layers))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train|prefill|decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Is this (arch, shape) cell runnable? Returns (ok, reason-if-not)."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "skipped (full attention; no sub-quadratic path)"
    return True, ""


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How a step is laid out on the mesh (see launch.shardings)."""
    data_axes: Tuple[str, ...] = ("pod", "data")   # batch sharding axes present in mesh
    model_axis: str = "model"
    zero1: bool = True           # shard optimizer state over data axes
    sequence_parallel: bool = False
    remat: str = "block"         # none|block — activation checkpoint per layer
    pipeline_stages: int = 1     # >1: GPipe over the leading data axis
    grad_compression: str = "none"  # none|int8_ef


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    param_dtype: str = "float32"     # master/runtime params
    compute_dtype: str = "bfloat16"
    label_smoothing: float = 0.0


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Family-preserving reduction for CPU smoke tests.

    Keeps: block pattern cycle length, GQA ratio, MoE routing shape (fewer
    experts, same top_k semantics), enc-dec split, frontend kind.
    Shrinks: layers -> one pattern cycle (>=2), widths, vocab, experts.
    """
    n_layers = max(len(cfg.block_pattern), 2)
    if cfg.is_encdec:
        n_layers = 2
    n_heads = max(4, min(cfg.n_heads, 4))
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1)) if cfg.n_kv_heads else 0
    n_kv = max(1, n_heads // ratio) if cfg.n_kv_heads else 0
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            expert_d_ff=64,
            shared_d_ff=64 if cfg.moe.shared_d_ff else 0)
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=128,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_ff=256,
        vocab=512,
        head_dim=32,
        max_seq_len=512,
        rnn_width=128 if cfg.rnn_width else None,
        rnn_heads=min(cfg.rnn_heads, 4) if cfg.rnn_heads > 1 else cfg.rnn_heads,
        window=64,
        encoder_layers=2 if cfg.encoder_layers else 0,
        prefix_len=16 if cfg.frontend != "none" else 0,
        moe=moe,
    )
