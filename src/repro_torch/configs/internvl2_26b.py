"""InternVL2-26B — VLM: InternViT-6B (stub) + InternLM2-20B language backbone.

[arXiv:2404.16821; hf-verified]
The vision tower is a STUB per the assignment: input_specs() provides 256
precomputed patch embeddings (post pixel-shuffle, post MLP-projector) at
d_model. The 48-layer InternLM2 backbone is fully implemented; vocab is the
92553-entry VLM-extended table.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    max_seq_len=32768,
    tie_embeddings=False,
    frontend="vision",
    prefix_len=256,
    source="arXiv:2404.16821; hf",
)
