"""gemma2-2b — local/global alternating attention + logit softcaps. [arXiv:2408.00118]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    attn_variant="alternating",       # even layers local (sliding), odd global
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_block_norm=True,
    tie_embeddings=True,
    scale_embeddings=True,
    source="arXiv:2408.00118",
)
