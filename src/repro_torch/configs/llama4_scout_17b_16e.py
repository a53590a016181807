"""Llama-4-Scout-17B-16E — MoE decoder: 16 routed experts top-1 + shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
Every layer carries a MoE FFN (top-1 of 16 routed + 1 always-on shared
expert, both width 8192). Early-fusion multimodality is out of scope for the
text backbone cells (noted in DESIGN.md).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=500_000.0,
    max_seq_len=131072,
    tie_embeddings=False,
    moe=MoEConfig(num_experts=16, top_k=1, expert_d_ff=8192,
                  num_shared=1, shared_d_ff=8192),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
