"""rwkv6-3b (Finch) — attention-free, data-dependent decay. [arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,                 # d_model / head_dim time-mix heads
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    # chunk=16: fp32 stability domain of the chunked factored WKV6 form
    ssm=SSMConfig(kind="rwkv6", state_dim=64, head_dim=64, chunk=16),
    source="arXiv:2404.05892",
)
