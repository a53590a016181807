"""Nemotron-4-15B — dense GQA decoder with squared-ReLU MLP.

[arXiv:2402.16819; unverified]
Squared-ReLU (relu2) MLP and LayerNorm per the Nemotron-4 report.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    head_dim=128,
    mlp="relu2",
    norm="layernorm",
    rope_theta=10_000.0,
    max_seq_len=4096,
    tie_embeddings=False,
    source="arXiv:2402.16819; unverified",
)
