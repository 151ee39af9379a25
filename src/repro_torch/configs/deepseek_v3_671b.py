"""deepseek-v3-671b — MLA + 1 shared / 256 routed top-8 MoE + MTP. [arXiv:2412.19437]"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,               # MLA: latent-shared KV; head count for q
    head_dim=128,                   # v head dim
    d_ff=18432,                     # dense FFN width for the first_k_dense layers
    vocab_size=129280,
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_ff_expert=2048,
        num_shared_experts=1,
        d_ff_shared=2048,
        router="sigmoid",
        routed_scaling=2.5,
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    first_k_dense=3,
    mtp_depth=1,
    source="arXiv:2412.19437",
)
