"""Architecture registry: ``--arch <id>`` resolution.

The port's own copy of ``repro.configs``: ARCHS maps the public arch id to
its ModelConfig; REDUCED maps to a smoke-test variant of the same family
(<=2 layers, d_model<=512, <=4 experts) runnable on the CPU. The registry
equals the reference's field for field (tests/test_torch_lm.py).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (
    INPUT_SHAPES,
    FederatedConfig,
    InputShape,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    TrainConfig,
)

from repro_torch.configs import (  # noqa: E402
    chameleon_34b,
    deepseek_v3_671b,
    gemma2_2b,
    glm4_9b,
    granite_moe_1b,
    llama3_2_1b,
    musicgen_large,
    rwkv6_3b,
    starcoder2_15b,
    zamba2_1_2b,
)

ARCHS = {
    "llama3.2-1b": llama3_2_1b.CONFIG,
    "gemma2-2b": gemma2_2b.CONFIG,
    "starcoder2-15b": starcoder2_15b.CONFIG,
    "rwkv6-3b": rwkv6_3b.CONFIG,
    "granite-moe-1b-a400m": granite_moe_1b.CONFIG,
    "musicgen-large": musicgen_large.CONFIG,
    "deepseek-v3-671b": deepseek_v3_671b.CONFIG,
    "glm4-9b": glm4_9b.CONFIG,
    "zamba2-1.2b": zamba2_1_2b.CONFIG,
    "chameleon-34b": chameleon_34b.CONFIG,
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant of the same family: 2 layers, d_model<=512,
    <=4 experts, tiny vocab — runs a real forward on the CPU."""
    kw: dict = dict(
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        prefix_len=8 if cfg.prefix_frontend else 0,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=4,
            top_k=2,
            d_ff_expert=128,
            d_ff_shared=128 if cfg.moe.num_shared_experts else 0,
            impl="dense",
        )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(
            q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
            qk_rope_head_dim=16, v_head_dim=32,
        )
        kw["head_dim"] = 32
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=32, chunk=16)
        kw["num_heads"] = 8 if cfg.ssm.kind == "rwkv6" else kw["num_heads"]
        kw["num_kv_heads"] = kw["num_heads"]
    if cfg.hybrid_period:
        kw["num_layers"] = 3          # 2 mamba + shared-attn cadence of 2
        kw["hybrid_period"] = 2
    if cfg.first_k_dense:
        kw["first_k_dense"] = 1
        kw["num_layers"] = 2          # 1 dense + 1 moe
    return cfg.with_overrides(name=cfg.name + "-smoke", **kw)


REDUCED = {name: reduced(cfg) for name, cfg in ARCHS.items()}

__all__ = [
    "ARCHS", "REDUCED", "INPUT_SHAPES", "get_arch", "reduced",
    "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig",
    "InputShape", "FederatedConfig", "TrainConfig",
]
