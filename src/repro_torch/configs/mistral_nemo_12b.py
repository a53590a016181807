"""Mistral-Nemo-Base-2407 (12B) — dense GQA decoder, 128k context.

[hf:mistralai/Mistral-Nemo-Base-2407; hf-verified]
Note head_dim=128 with 32 heads (q proj 4096 < d_model 5120) per HF config.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    max_seq_len=131072,
    tie_embeddings=False,
    source="hf:mistralai/Mistral-Nemo-Base-2407; hf",
)
