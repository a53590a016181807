"""Qwen2-72B — dense GQA decoder with QKV bias; the largest assigned arch.

[arXiv:2407.10671; hf-verified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    max_seq_len=32768,
    tie_embeddings=False,
    source="arXiv:2407.10671; hf",
)
