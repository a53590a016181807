"""SeamlessM4T-medium backbone — encoder-decoder, multimodal (audio stub).

[arXiv:2308.11596; hf-verified]
The speech frontend (w2v-BERT conformer feature extractor) is a STUB per the
assignment: input_specs() provides precomputed frame embeddings at d_model.
The transformer backbone (12L bidirectional encoder + 12L causal decoder with
cross-attention, MHA kv=16) is fully implemented.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec_audio",
    n_layers=12,              # decoder depth
    encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    head_dim=64,
    mlp="gelu",
    norm="layernorm",
    rope_theta=10_000.0,
    max_seq_len=4096,
    tie_embeddings=False,
    frontend="audio",
    source="arXiv:2308.11596; hf",
)
