"""DeepSeekMoE-16B — fine-grained MoE: 2 shared + 64 routed top-6.

[arXiv:2401.06066; hf-verified]
Layer 0 is a dense FFN (width 10944) per the DeepSeekMoE config
(n_dense_head=1); layers 1..27 use 64 fine-grained routed experts (width
1408, top-6) plus 2 shared experts (width 1408 each, fused to 2816).
MHA (kv=16).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,               # dense head layer width (assignment lists the
                              # expert width 1408 — see moe.expert_d_ff)
    vocab=102400,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    max_seq_len=16384,
    tie_embeddings=False,
    n_dense_head=1,
    moe=MoEConfig(num_experts=64, top_k=6, expert_d_ff=1408,
                  num_shared=2, shared_d_ff=1408),
    source="arXiv:2401.06066; hf",
)
