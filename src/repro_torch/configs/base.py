"""Config dataclasses for architectures and input shapes.

The port's own copy of ``repro.configs.base``, field for field. Every
assigned architecture (see configs/<arch>.py) instantiates ModelConfig;
TrainConfig and FederatedConfig describe a training run. Configs are plain
frozen dataclasses so they hash and compare; no torch imports here, and
dtype fields stay strings, as in the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block config (Switch/DeepSeek style)."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    router: str = "softmax"           # softmax | sigmoid (deepseek-v3)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01     # load-balance loss coefficient
    routed_scaling: float = 1.0       # deepseek-v3 routed expert scaling
    # Expert-parallel implementation in the reference: "dense", "gspmd" or
    # "ep" (kept so the registry equals the reference's)
    impl: str = "gspmd"


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / RWKV6 recurrent block config."""

    kind: str                 # "mamba2" | "rwkv6"
    state_dim: int = 64       # N (mamba2 state size) — per-head value dim for rwkv6
    head_dim: int = 64
    expand: int = 2           # mamba2 inner expansion
    conv_dim: int = 4         # mamba2 depthwise conv width
    dt_rank: int = 0          # unused by mamba2 (uses per-head dt)
    chunk: int = 128          # chunked-scan block length
    # recurrent-chunk sharding over the reference's model axis ("k" | "seq")
    shard: str = "k"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    source: str = ""          # citation for the config

    # --- attention options -------------------------------------------------
    attn_variant: str = "full"        # full | sliding | alternating
    sliding_window: int = 4096
    attn_logit_softcap: float = 0.0   # gemma2: 50.0 (0 disables)
    final_logit_softcap: float = 0.0  # gemma2: 30.0
    qk_norm: bool = False             # chameleon-style query/key RMSNorm
    rope_theta: float = 10000.0
    post_block_norm: bool = False     # gemma2 post-norms
    # the reference's decode sharding variants; on one card both compute
    # the same function as the default decode branch, which the port takes
    decode_expand_kv: bool = False
    decode_cache_seq: bool = False

    # --- per-family sub-configs --------------------------------------------
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # hybrid (zamba2): rounds of `hybrid_period` ssm blocks followed by one
    # weight-shared attention block.
    hybrid_period: int = 0

    # deepseek: number of leading dense (non-MoE) layers
    first_k_dense: int = 0
    # deepseek multi-token prediction depth (0 disables)
    mtp_depth: int = 0

    # modality frontend stub: inputs carry `prefix_embeds` of shape
    # (batch, prefix_len, d_model) produced by a frozen external encoder.
    prefix_frontend: bool = False
    prefix_len: int = 0

    tie_embeddings: bool = False
    scale_embeddings: bool = False    # gemma: embed * sqrt(d_model)
    norm_eps: float = 1e-5

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- derived -----------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def param_count(self) -> int:
        """Parameter count of the port's own init, counted on the `meta`
        device (no memory)."""
        from repro_torch.models.backbone import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        """Parameters a token reaches: a moe model's E - k unchosen
        experts a layer left out."""
        from repro_torch.models.backbone import count_params_analytic

        return count_params_analytic(self, active_only=True)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


@dataclass(frozen=True)
class FederatedConfig:
    """The paper's technique as a first-class training feature.

    num_silos `d` intra-group DC servers run `local_steps` optimizer steps
    with zero cross-silo communication, then average parameters across the
    silo mesh axis (the central-FL-server all-reduce). local_steps=1 with
    num_silos=1 degenerates to standard data-parallel training.
    """

    num_silos: int = 1
    local_steps: int = 4              # H — paper: epochs-per-round
    # fedavg | fedprox | fedsgd, or a robust boundary (DESIGN.md §8):
    # median | trimmed_mean | krum
    aggregator: str = "fedavg"
    fedprox_mu: float = 0.0
    trim_frac: float = 0.2            # trimmed_mean: trim fraction per tail
    krum_f: int = 1                   # krum: tolerated Byzantine silos
    # silo mesh axis is resolved at launch: "pod" (multi-pod) or "data".
    silo_axis: str = "auto"


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    shape: InputShape
    federated: FederatedConfig = field(default_factory=FederatedConfig)
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"
    opt_state_dtype: str = "float32"  # bf16 for very large models
    remat: bool = True
    seed: int = 0
    fsdp: bool = True                 # shard params over the data axis too


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": InputShape("prefill_32k", seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": InputShape("decode_32k", seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": InputShape("long_500k", seq_len=524288, global_batch=1, kind="decode"),
}
