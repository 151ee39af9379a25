"""zamba2-1.2b — Mamba2 backbone + periodically applied weight-shared
attention block. [arXiv:2411.15242]

38 Mamba2 blocks; after every 6th block the single shared attention+MLP block
(one parameter set, reused) is applied — 6 shared applications total, trailing
2 Mamba2 blocks. ssm_state=64.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,                      # shared block MLP width
    vocab_size=32000,
    ssm=SSMConfig(kind="mamba2", state_dim=64, head_dim=64, expand=2, conv_dim=4, chunk=128),
    hybrid_period=6,
    source="arXiv:2411.15242",
)
