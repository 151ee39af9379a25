"""musicgen-large — decoder-only over EnCodec audio tokens. [arXiv:2306.05284]

The EnCodec/conditioning frontend is a STUB per the brief: input_specs()
supplies precomputed conditioning frame embeddings (batch, prefix_len, d_model)
that the decoder consumes via prefix fusion; the token stream is the EnCodec
codebook stream (vocab 2048).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    prefix_frontend=True,
    prefix_len=64,
    source="arXiv:2306.05284",
)
