"""RWKV-6 (Finch) 3B — attention-free, data-dependent decay.

[arXiv:2404.05892; hf-verified]
32 layers of time-mix (matrix-valued state per 64-dim head, decay
w_t = exp(-exp(w0 + lora(x_t)))) + channel-mix (squared-ReLU, width 8960).
Constant-size state -> runs the long_500k cell.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,               # bookkeeping: rnn heads of size 64
    n_kv_heads=0,             # attention-free
    d_ff=8960,
    vocab=65536,
    head_dim=64,
    mlp="relu2",
    norm="layernorm",
    max_seq_len=1_048_576,
    tie_embeddings=False,
    block_pattern=("rwkv",),
    rnn_heads=40,
    sub_quadratic=True,
    source="arXiv:2404.05892; hf",
)
