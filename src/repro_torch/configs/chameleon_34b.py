"""chameleon-34b — early-fusion VLM over VQ image tokens. [arXiv:2405.09818]

The VQ-VAE image tokenizer / patch encoder is a STUB per the brief:
input_specs() supplies precomputed patch embeddings (batch, prefix_len,
d_model); text+image VQ tokens share the 65536 vocab. qk-norm per the paper.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    prefix_frontend=True,
    prefix_len=256,
    source="arXiv:2405.09818",
)
