"""RecurrentGemma-2B (Griffin) — hybrid RG-LRU + local attention, 1:2 ratio.

[arXiv:2402.19427; hf-verified]
Pattern: (recurrent, recurrent, local_attn) cycled over 26 layers (the final
partial cycle — 2 recurrent layers — is handled as unrolled tail layers).
MQA (kv=1) on the attention layers, window 2048, lru_width = d_model = 2560.
Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    mlp="geglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    max_seq_len=1_048_576,
    tie_embeddings=True,
    block_pattern=("rglru", "rglru", "local_attn"),
    window=2048,
    rnn_width=2560,
    conv_width=4,
    sub_quadratic=True,
    source="arXiv:2402.19427; hf",
)
