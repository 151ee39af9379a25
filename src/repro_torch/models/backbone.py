"""Backbone LM (counterpart of ``repro.models.backbone``), every family:

  dense / audio / vlm : a uniform [attn + SwiGLU] stack (GQA, sliding
          window, softcap, qk-norm per config), with forward, loss,
          prefill and cached single-token decode; audio (musicgen) and
          vlm (chameleon) take a modality prefix, below;
  moe   : [attn + MoE] layers, after `first_k_dense` leading dense layers
          (their own stack, ``dense_layers``, and their own cache,
          ``dense_cache``), with the MoE load-balance loss in ``loss_fn``
          and, where ``mtp_depth`` asks, deepseek's multi-token-prediction
          head; the same forward, loss, prefill and decode as dense. With
          ``mla`` (deepseek) every attention block, the MTP head's
          included, is multi-head latent attention: the expanded form in
          forward and prefill, whose caches hold the latent ``ckv`` and
          the rope key ``krope`` a position, and the absorbed-weight
          decode against them;
  ssm   : rwkv6's [time-mix + channel-mix] stack, with forward, loss,
          prefill (which also returns the recurrent state) and
          single-token decode from that state;
  hybrid: zamba2's rounds of `hybrid_period` Mamba2 blocks, each round
          followed by ONE weight-shared attention + SwiGLU block
          (``shared_block``, unstacked), then the trailing Mamba2 blocks
          (``tail_layers``); prefill fills each round's Mamba2 states
          (``mamba``: conv window and SSM state), one KV-cache layer per
          shared application (``shared_cache``) and the trailing blocks'
          states (``mamba_tail``), from which decode continues.

Parameters are stacked on a leading layer axis L, as in the reference, so
its weights carry over as they are (``repro_torch.weights``); layers run in
a Python loop, so gemma2's alternating local/global flag is a concrete bool
per layer. With ``remat`` each layer runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the scan
body): its activations are recomputed in the backward pass, a MoE layer's
routing included (the same deterministic top-k and stable sort); a
hybrid model checkpoints one round at a time (its Mamba2 blocks and the
shared block, the blocks inside not checkpointed again) and each trailing
block alone, as the reference does.

A modality prefix (``prefix_frontend``: precomputed embeddings (B, P, d)
from a frozen encoder, ``models.modality`` draws stand-ins) is RMS-normed
by ``ln_prefix`` in the embedding's dtype and put in front of the token
embeddings: positions run 0..P+S-1, the loss masks the prefix out, and
prefill caches its entries (next position P + S).

``use_kernels`` (the reference's ``use_pallas``) sends the attention of
forward and prefill through the flash-attention kernel (MLA's expanded
form takes ``sdpa`` whatever it says, as the reference's does), and rwkv6's
recurrence in forward and loss through the WKV6 kernel; False runs the
plain paths (``sdpa``, ``wkv6_chunked``). rwkv6's prefill needs the final
recurrent state, which the WKV6 kernel does not return (ROADMAP.md, Queue 2
item 2): it takes the chunked plain form whatever ``use_kernels`` says, as
the reference's prefill does. Mamba2 has no kernel in the reference: its
SSD scan is torch ops on either path. Decode runs no kernel, as in the
reference. Decode writes its state in place (the KV caches; rwkv6's
``wkv``, ``x_prev_att`` and ``x_prev_ffn``; Mamba2's ``conv`` and
``ssm``), so a caller's view of one batch row, as ``BatchedServer`` keeps
per slot, sees every update.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]


# ===========================================================================
# init
# ===========================================================================

def _init_dense_block(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                      lead=(), *, moe_layer: bool = False) -> Params:
    init_attn = L.init_attention if cfg.mla is None else L.init_mla
    p: Params = {"ln_attn": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
                 "ln_mlp": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
                 "attn": init_attn(gen, cfg, dtype, device, lead)}
    if moe_layer:
        p["moe"] = L.init_moe(gen, cfg, dtype, device, lead)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device, lead)
    if cfg.post_block_norm:
        p["ln_post_attn"] = L.init_rmsnorm(cfg.d_model, dtype, device, lead)
        p["ln_post_mlp"] = L.init_rmsnorm(cfg.d_model, dtype, device, lead)
    return p


def _init_rwkv_block(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                     lead=()) -> Params:
    return {"ln_att": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
            "ln_ffn": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
            "tm": L.init_rwkv6(gen, cfg, dtype, device, lead),
            "cm": L.init_rwkv6_channelmix(gen, cfg, dtype, device, lead)}


def _init_mamba_block(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                      lead=()) -> Params:
    return {"ln": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
            "mamba": L.init_mamba2(gen, cfg, dtype, device, lead)}


def _hybrid_split(cfg: ModelConfig):
    """(rounds of `hybrid_period` Mamba2 blocks, trailing blocks)."""
    rounds = cfg.num_layers // cfg.hybrid_period
    return rounds, cfg.num_layers - rounds * cfg.hybrid_period


def _hybrid_rounds(cfg: ModelConfig):
    """(round r, the slice of ``layers`` holding its Mamba2 blocks, the
    shared block's local flag) for every round."""
    rounds, _ = _hybrid_split(cfg)
    per = cfg.hybrid_period
    return [(r, slice(r * per, (r + 1) * per), flag)
            for r, flag in enumerate(_local_flags(cfg, rounds))]


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                param_dtype=torch.float32, *,
                device: DeviceLike = None) -> Params:
    """Random weights in the reference's tree, drawn on `device` from
    `generator` (a generator of that device; None on the `meta` device,
    which only shapes). Torch cannot reproduce ``jax.random``: parity runs
    load the reference's weights (``weights.lm_params_from_numpy``)."""
    return _init_tree(cfg, generator, param_dtype, resolve_device(device))


def _init_tree(cfg: ModelConfig, generator: Optional[torch.Generator],
               param_dtype, dev: torch.device) -> Params:
    params: Params = {"embed": torch.empty((cfg.vocab_size, cfg.d_model),
                                           dtype=torch.float32, device=dev)}
    if dev.type != "meta":
        params["embed"].normal_(0.0, 0.02, generator=generator)
    params["embed"] = params["embed"].to(param_dtype)
    params["ln_final"] = L.init_rmsnorm(cfg.d_model, param_dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = L._dense_init(generator,
                                          (cfg.d_model, cfg.vocab_size),
                                          cfg.d_model, param_dtype, dev)
    if cfg.prefix_frontend:
        params["ln_prefix"] = L.init_rmsnorm(cfg.d_model, param_dtype, dev)
    if cfg.family == "ssm":
        params["layers"] = _init_rwkv_block(generator, cfg, param_dtype, dev,
                                            lead=(cfg.num_layers,))
        return params
    if cfg.family == "hybrid":
        rounds, trailing = _hybrid_split(cfg)
        params["layers"] = _init_mamba_block(
            generator, cfg, param_dtype, dev,
            lead=(rounds * cfg.hybrid_period,))
        if trailing:
            params["tail_layers"] = _init_mamba_block(
                generator, cfg, param_dtype, dev, lead=(trailing,))
        params["shared_block"] = _init_dense_block(generator, cfg,
                                                   param_dtype, dev)
        return params
    if cfg.family != "moe":
        params["layers"] = _init_dense_block(generator, cfg, param_dtype, dev,
                                             lead=(cfg.num_layers,))
        return params
    if cfg.first_k_dense:
        params["dense_layers"] = _init_dense_block(
            generator, cfg, param_dtype, dev, lead=(cfg.first_k_dense,))
    params["layers"] = _init_dense_block(
        generator, cfg, param_dtype, dev,
        lead=(cfg.num_layers - cfg.first_k_dense,), moe_layer=True)
    if cfg.mtp_depth:
        d = cfg.d_model
        params["mtp"] = {
            "proj": L._dense_init(generator, (2 * d, d), 2 * d, param_dtype,
                                  dev),
            "ln_h": L.init_rmsnorm(d, param_dtype, dev),
            "ln_e": L.init_rmsnorm(d, param_dtype, dev),
            "block": _init_dense_block(generator, cfg, param_dtype, dev)}
    return params


def _layers(stacked: Params) -> List[Params]:
    """Every layer's params, views made by one ``unbind`` per tensor: its
    backward stacks the L layer gradients once, where L separate ``a[i]``
    would each add a zero-padded full-size gradient."""
    unbound = [a.unbind(0) for a in tree_leaves(stacked)]

    def layer(i):
        it = iter(u[i] for u in unbound)
        return tree_map(lambda _: next(it), stacked)

    return [layer(i) for i in range(len(unbound[0]))]


# ===========================================================================
# forward
# ===========================================================================

def _local_flags(cfg: ModelConfig, n: int) -> List[bool]:
    if cfg.attn_variant == "sliding":
        return [True] * n
    if cfg.attn_variant == "alternating":
        return [i % 2 == 0 for i in range(n)]
    return [False] * n


def embed_inputs(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
                 prefix_embeds: Optional[torch.Tensor] = None):
    """-> (x (B, P+S, d), positions (B, P+S), loss_mask (B, P+S)), P = 0
    without a prefix front end (`prefix_embeds` is then ignored, as in the
    reference); with one, `prefix_embeds` (B, P, d) is required."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    if cfg.scale_embeddings:
        x = x * math.sqrt(cfg.d_model)
    loss_mask = torch.ones((B, S), dtype=torch.bool, device=x.device)
    if cfg.prefix_frontend:
        if prefix_embeds is None:
            raise ValueError(f"{cfg.name} requires prefix_embeds")
        pe = L.apply_rmsnorm(params["ln_prefix"],
                             prefix_embeds.to(device=x.device,
                                              dtype=x.dtype), cfg.norm_eps)
        x = torch.cat([pe, x], dim=1)
        loss_mask = torch.cat([torch.zeros((B, pe.shape[1]), dtype=torch.bool,
                                           device=x.device), loss_mask], dim=1)
    T = x.shape[1]
    positions = torch.arange(T, dtype=torch.int32,
                             device=x.device).expand(B, T)
    return x, positions, loss_mask


def _dense_block_apply(lp: Params, x: torch.Tensor, cfg: ModelConfig, *,
                       positions, is_local: bool, use_kernels: bool,
                       moe_layer: bool = False, return_kv: bool = False):
    """-> (x, aux) or, with return_kv, (x, aux, the cache entries: (k, v),
    or MLA's (ckv, krope)): aux is the MoE layer's load-balance loss, None
    for a dense layer."""
    h = L.apply_rmsnorm(lp["ln_attn"], x, cfg.norm_eps)
    if cfg.mla is not None:
        attn, kv = L.mla_attention(lp["attn"], h, cfg, positions=positions,
                                   is_local=is_local, return_kv=True)
    else:
        attn, kv = L.multi_head_attention(
            lp["attn"], h, cfg, positions=positions, is_local=is_local,
            use_kernels=use_kernels, return_kv=True)
    if cfg.post_block_norm:
        attn = L.apply_rmsnorm(lp["ln_post_attn"], attn, cfg.norm_eps)
    x = x + attn
    h = L.apply_rmsnorm(lp["ln_mlp"], x, cfg.norm_eps)
    out, aux = _ffn(lp, h, cfg, moe_layer)
    if cfg.post_block_norm:
        out = L.apply_rmsnorm(lp["ln_post_mlp"], out, cfg.norm_eps)
    if return_kv:
        return x + out, aux, kv
    return x + out, aux


def _ffn(lp: Params, h: torch.Tensor, cfg: ModelConfig, moe_layer: bool):
    """The block's feed-forward half: (out, the MoE aux loss or None)."""
    if moe_layer:
        return L.apply_moe(lp["moe"], h, cfg)
    return L.apply_mlp(lp["mlp"], h), None


def _rwkv_block_apply(lp: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      use_kernels: bool):
    h = L.apply_rmsnorm(lp["ln_att"], x, cfg.norm_eps)
    x = x + L.rwkv6_timemix(lp["tm"], h, cfg, use_kernels=use_kernels)
    h = L.apply_rmsnorm(lp["ln_ffn"], x, cfg.norm_eps)
    h_prev = F.pad(h, (0, 0, 1, 0))[:, :-1]
    return x + L.rwkv6_channelmix(lp["cm"], h, h_prev), None


def _mamba_block_apply(lp: Params, x: torch.Tensor, cfg: ModelConfig):
    h = L.apply_rmsnorm(lp["ln"], x, cfg.norm_eps)
    return x + L.mamba2_forward(lp["mamba"], h, cfg)


def _run_stack(body, x: torch.Tensor, stacked: Params, flags: List[bool],
               remat: bool):
    """`body(x, layer_params, flag) -> (x, aux or None)` over the stacked
    layers, each under ``checkpoint`` with `remat` -> (x, the sum of the
    layers' aux losses, fp32, 0 where none has one)."""
    auxs = []
    for lp, flag in zip(_layers(stacked), flags):
        if remat:
            x, aux = checkpoint(body, x, lp, flag, use_reentrant=False)
        else:
            x, aux = body(x, lp, flag)
        if aux is not None:
            auxs.append(aux)
    if not auxs:
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    return x, torch.sum(torch.stack(auxs))


def _n_stacked(stacked: Params) -> int:
    return tree_leaves(stacked)[0].shape[0]


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            prefix_embeds: Optional[torch.Tensor] = None,
            use_kernels: bool = True, remat: bool = True,
            compute_dtype=torch.bfloat16, return_logits: bool = True):
    """-> (logits (B, T, V) fp32 | None, hidden (B, T, d),
    {"moe_aux": the moe layers' summed aux loss (0 for the other
    families), "loss_mask": (B, T)}); T = P + S with a prefix."""
    x, positions, loss_mask = embed_inputs(params, tokens, cfg,
                                           prefix_embeds=prefix_embeds)
    x = x.to(compute_dtype)
    remat = remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        x, aux = _run_stack(
            lambda h, lp, flag: _rwkv_block_apply(lp, h, cfg,
                                                  use_kernels=use_kernels),
            x, params["layers"], [False] * cfg.num_layers, remat)
    elif cfg.family == "hybrid":
        x = _hybrid_forward(params, x, cfg, positions=positions,
                            use_kernels=use_kernels, remat=remat)
    else:
        def body(moe_layer):
            return lambda h, lp, flag: _dense_block_apply(
                lp, h, cfg, positions=positions, is_local=flag,
                use_kernels=use_kernels, moe_layer=moe_layer)

        if cfg.family == "moe" and cfg.first_k_dense:
            # the leading dense layers' aux is nothing, as the reference's
            x, _ = _run_stack(body(False), x, params["dense_layers"],
                              _local_flags(cfg, cfg.first_k_dense), remat)
        n = _n_stacked(params["layers"])
        x, aux = _run_stack(body(cfg.family == "moe"), x, params["layers"],
                            _local_flags(cfg, n), remat)
    hidden = L.apply_rmsnorm(params["ln_final"], x, cfg.norm_eps)
    logits = _lm_logits(params, hidden, cfg) if return_logits else None
    return logits, hidden, {"moe_aux": aux, "loss_mask": loss_mask}


def _hybrid_forward(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions, use_kernels: bool, remat: bool):
    """The hybrid stack: each round's Mamba2 blocks, then the shared block
    (one ``checkpoint`` a round under `remat`), then the trailing blocks
    (one each)."""
    blocks = _layers(params["layers"])

    def round_body(h, round_blocks, flag):
        for lp in round_blocks:
            h = _mamba_block_apply(lp, h, cfg)
        h, _ = _dense_block_apply(params["shared_block"], h, cfg,
                                  positions=positions, is_local=flag,
                                  use_kernels=use_kernels)
        return h

    for _, sl, flag in _hybrid_rounds(cfg):
        if remat:
            x = checkpoint(round_body, x, blocks[sl], flag,
                           use_reentrant=False)
        else:
            x = round_body(x, blocks[sl], flag)
    if "tail_layers" in params:
        x, _ = _run_stack(
            lambda h, lp, flag: (_mamba_block_apply(lp, h, cfg), None),
            x, params["tail_layers"], [False] * _n_stacked(
                params["tail_layers"]), remat)
    return x


def _lm_logits(params: Params, hidden: torch.Tensor, cfg: ModelConfig):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (hidden @ head.to(hidden.dtype)).float()
    if cfg.final_logit_softcap:
        logits = (torch.tanh(logits / cfg.final_logit_softcap)
                  * cfg.final_logit_softcap)
    return logits


# ===========================================================================
# loss
# ===========================================================================

def _xent_sums(logits: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor):
    """(sum of masked next-token NLL, sum of the mask). logits fp32."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over masked positions. logits fp32."""
    tot, cnt = _xent_sums(logits, labels, mask)
    # mask is a {0,1} token count: the 1.0 clamp only turns an all-masked
    # batch into 0/1 = 0 instead of 0/0
    return tot / torch.clamp(cnt, min=1.0)


XENT_CHUNK = 512            # sequence-block size for the chunked CE head


def chunked_xent(params: Params, hidden: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor, cfg: ModelConfig,
                 chunk: int = XENT_CHUNK) -> torch.Tensor:
    """CE over the vocab head computed in sequence blocks when S is a
    multiple of `chunk` above it, as the reference does: each block's
    (B, chunk, V) logits are made, reduced and (under autograd) kept for
    the backward pass one block at a time."""
    S = hidden.shape[1]
    if S % chunk or S <= chunk:
        return softmax_xent(_lm_logits(params, hidden, cfg), labels, mask)
    tot = cnt = 0.0
    for i in range(0, S, chunk):
        t, c = _xent_sums(_lm_logits(params, hidden[:, i:i + chunk], cfg),
                          labels[:, i:i + chunk], mask[:, i:i + chunk])
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            *, use_kernels: bool = True, remat: bool = True,
            compute_dtype=torch.bfloat16, mtp_coef: float = 0.3,
            aux_coef: float = 0.01):
    """batch: tokens (B,S), labels (B,S) (next token, -1 = ignore), and
    prefix_embeds (B,P,d) for a prefix family (its positions carry no
    label) -> (loss, metrics): "ce" and "loss", and for the moe family
    "moe_aux" (added as ``aux_coef`` x it, the reference's keyword default:
    ``MoEConfig.router_aux_coef`` is read nowhere, as in the reference)
    and, with an MTP head, "mtp" (added as ``mtp_coef`` x it)."""
    tokens, labels = batch["tokens"], batch["labels"]
    _, hidden, aux = forward(params, tokens, cfg,
                             prefix_embeds=batch.get("prefix_embeds"),
                             use_kernels=use_kernels, remat=remat,
                             compute_dtype=compute_dtype,
                             return_logits=False)
    P = hidden.shape[1] - tokens.shape[1]
    hidden = hidden[:, P:]
    mask = (labels >= 0) & aux["loss_mask"][:, P:]
    loss = chunked_xent(params, hidden, torch.clamp(labels, min=0),
                        mask.float(), cfg)
    metrics = {"ce": loss}
    if cfg.moe is not None:
        loss = loss + aux_coef * aux["moe_aux"]
        metrics["moe_aux"] = aux["moe_aux"]
    if cfg.mtp_depth and "mtp" in params:
        mtp = _mtp_loss(params, hidden, tokens, labels, cfg)
        loss = loss + mtp_coef * mtp
        metrics["mtp"] = mtp
    metrics["loss"] = loss
    return loss, metrics


def _mtp_loss(params: Params, hidden: torch.Tensor, tokens: torch.Tensor,
              labels: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """DeepSeek-V3's multi-token prediction (depth 1): at position t, the
    main hidden state with the embedding of token t+1 predicts token t+2,
    through one dense block on plain attention."""
    mp = params["mtp"]
    B, S, d = hidden.shape
    h = L.apply_rmsnorm(mp["ln_h"], hidden[:, :-1], cfg.norm_eps)
    e = params["embed"][tokens[:, 1:].long()].to(h.dtype)
    e = L.apply_rmsnorm(mp["ln_e"], e, cfg.norm_eps)
    x = torch.cat([h, e], dim=-1) @ mp["proj"].to(h.dtype)
    positions = torch.arange(S - 1, dtype=torch.int32,
                             device=x.device).expand(B, S - 1)
    x, _ = _dense_block_apply(mp["block"], x, cfg, positions=positions,
                              is_local=False, use_kernels=False)
    x = L.apply_rmsnorm(params["ln_final"], x, cfg.norm_eps)
    mtp_labels = labels[:, 1:]          # the labels of t+2; the last is out
    mask = (mtp_labels >= 0).float()
    # trim to a chunk multiple so the CE head stays chunked at scale
    Sm = x.shape[1]
    keep = (Sm // XENT_CHUNK) * XENT_CHUNK if Sm > XENT_CHUNK else Sm
    return chunked_xent(params, x[:, :keep],
                        torch.clamp(mtp_labels[:, :keep], min=0),
                        mask[:, :keep], cfg)


# ===========================================================================
# prefill: full-sequence forward that also fills the decode cache
# ===========================================================================

def _entry_names(cache: Params):
    """The per-position leaves of a ring cache: (k, v), or MLA's latent
    (ckv, krope)."""
    return ("ckv", "krope") if "ckv" in cache else ("k", "v")


def _fill_cache(cache: Params, layer: int, entries, positions: torch.Tensor
                ) -> None:
    """Write one layer's per-position entries ((k, v) (B, S, KV, hd), or
    MLA's (ckv (B, S, r_kv), krope (B, S, rope))) into the ring cache,
    keeping the last min(S, cache_len) positions at slots pos % cache_len.
    The reference stacks every layer's entries and fills once; here each
    layer fills as it goes, so the stack never exists."""
    C = cache["pos"].shape[2]
    S = positions.shape[0]
    W = min(S, C)
    slots = (positions[S - W:] % C).long()
    for name, ent in zip(_entry_names(cache), entries):
        cache[name][layer][:, slots] = ent[:, S - W:].to(cache[name].dtype)


def _entries_to_cache(cache: Params, positions: torch.Tensor) -> None:
    """The positions of the kept entries, in every layer's pos array."""
    C = cache["pos"].shape[2]
    S = positions.shape[0]
    W = min(S, C)
    pos = positions[S - W:]
    cache["pos"][:, :, (pos % C).long()] = pos.to(cache["pos"].dtype)


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            cache_len: int, prefix_embeds: Optional[torch.Tensor] = None,
            use_kernels: bool = True, compute_dtype=torch.bfloat16,
            cache_dtype=torch.bfloat16):
    """Process a full prompt, returning (last-position logits (B, 1, V),
    decode state matching init_decode_state, next position (B,)).

    With a prefix front end, `prefix_embeds` (B, P, d) goes in front of the
    S tokens: the caches hold the prefix's entries too and the next
    position is P + S, so size `cache_len` for P + S + the decode steps
    (a ring sized for S alone wraps over the prefix)."""
    x, positions, _ = embed_inputs(params, tokens, cfg,
                                   prefix_embeds=prefix_embeds)
    x = x.to(compute_dtype)
    B, T = positions.shape
    kw = dict(positions=positions, use_kernels=use_kernels,
              cache_len=cache_len, cache_dtype=cache_dtype)
    state: Params = {}
    if cfg.family == "ssm":
        x, state = _prefill_rwkv(params["layers"], x, cfg)
    elif cfg.family == "hybrid":
        x, state = _prefill_hybrid(params, x, cfg, **kw)
    else:
        if cfg.first_k_dense:
            x, state["dense_cache"] = _prefill_attn_stack(
                params["dense_layers"], x, cfg, moe_layer=False, **kw)
        x, state["cache"] = _prefill_attn_stack(
            params["layers"], x, cfg, moe_layer=cfg.family == "moe", **kw)
    next_pos = torch.full((B,), T, dtype=torch.int32, device=x.device)
    return _last_logits(params, x, cfg), state, next_pos


def _prefill_attn_stack(stacked: Params, x: torch.Tensor, cfg: ModelConfig,
                        *, positions, moe_layer: bool, use_kernels: bool,
                        cache_len: int, cache_dtype):
    """The attention layers of one stack over the prompt, each filling its
    layer of a new ring cache (KV, or MLA's latent) as it goes ->
    (x, cache)."""
    n = _n_stacked(stacked)
    pos1d = positions[0]
    cache = _init_attn_cache(cfg, x.shape[0], cache_len, n, cache_dtype,
                             x.device)
    _entries_to_cache(cache, pos1d)
    for i, (lp, flag) in enumerate(zip(_layers(stacked),
                                       _local_flags(cfg, n))):
        x, _, kv = _dense_block_apply(
            lp, x, cfg, positions=positions, is_local=flag,
            use_kernels=use_kernels, moe_layer=moe_layer, return_kv=True)
        _fill_cache(cache, i, kv, pos1d)
    return x, cache


def _last_logits(params: Params, x: torch.Tensor, cfg: ModelConfig):
    hidden = L.apply_rmsnorm(params["ln_final"], x[:, -1:], cfg.norm_eps)
    return _lm_logits(params, hidden, cfg)


def _prefill_rwkv(stacked: Params, x: torch.Tensor, cfg: ModelConfig):
    """rwkv6's layers over the prompt, each also returning its final wkv
    state (the chunked plain form) and its last normalized inputs, fp32:
    the decode state of init_decode_state."""
    wkv, xpa, xpf = [], [], []
    for lp in _layers(stacked):
        hn = L.apply_rmsnorm(lp["ln_att"], x, cfg.norm_eps)
        att, s = L.rwkv6_timemix(lp["tm"], hn, cfg, return_state=True)
        x = x + att
        hf = L.apply_rmsnorm(lp["ln_ffn"], x, cfg.norm_eps)
        hf_prev = F.pad(hf, (0, 0, 1, 0))[:, :-1]
        x = x + L.rwkv6_channelmix(lp["cm"], hf, hf_prev)
        wkv.append(s)
        xpa.append(hn[:, -1].float())
        xpf.append(hf[:, -1].float())
    return x, {"wkv": torch.stack(wkv), "x_prev_att": torch.stack(xpa),
               "x_prev_ffn": torch.stack(xpf)}


def _prefill_mamba(stacked: Params, x: torch.Tensor, cfg: ModelConfig):
    """Mamba2 blocks over the prompt -> (x, their decode state: the conv
    windows and SSM states, stacked)."""
    conv, ssm = [], []
    for lp in _layers(stacked):
        hn = L.apply_rmsnorm(lp["ln"], x, cfg.norm_eps)
        out, (cw, st) = L.mamba2_forward(lp["mamba"], hn, cfg,
                                         return_state=True)
        x = x + out
        conv.append(cw)
        ssm.append(st)
    return x, {"conv": torch.stack(conv), "ssm": torch.stack(ssm)}


def _prefill_hybrid(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions, use_kernels: bool, cache_len: int,
                    cache_dtype):
    """The hybrid stack over the prompt. Each round's Mamba2 states go to
    ``mamba``; each shared application fills its own layer of
    ``shared_cache`` as it goes (the weights are shared, the keys are not);
    the trailing blocks' states go to ``mamba_tail``."""
    rounds = _hybrid_rounds(cfg)
    pos1d = positions[0]
    cache = L.init_kv_cache(cfg, x.shape[0], cache_len, len(rounds),
                            cache_dtype, x.device)
    _entries_to_cache(cache, pos1d)
    rstates = []
    for r, sl, flag in rounds:
        x, st = _prefill_mamba(tree_map(lambda a: a[sl], params["layers"]),
                               x, cfg)
        rstates.append(st)
        x, _, kv = _dense_block_apply(
            params["shared_block"], x, cfg, positions=positions,
            is_local=flag, use_kernels=use_kernels, return_kv=True)
        _fill_cache(cache, r, kv, pos1d)
    state = {"mamba": tree_map(lambda *a: torch.cat(a), *rstates),
             "shared_cache": cache}
    if "tail_layers" in params:
        x, state["mamba_tail"] = _prefill_mamba(params["tail_layers"], x, cfg)
    return x, state


# ===========================================================================
# decode (single token, cached)
# ===========================================================================

def _init_attn_cache(cfg: ModelConfig, batch: int, cache_len: int, n: int,
                     dtype, device) -> Params:
    """An attention stack's ring cache: MLA's latent one, or KV."""
    init = L.init_kv_cache if cfg.mla is None else L.init_mla_cache
    return init(cfg, batch, cache_len, n, dtype, device)


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype=torch.bfloat16, *,
                      device: DeviceLike = None) -> Params:
    """State tree for serve_step: the KV cache (dense, audio, vlm and moe,
    which also has a ``dense_cache`` for its `first_k_dense` leading
    layers; with MLA both are latent caches, ``ckv`` / ``krope`` / ``pos``;
    cache_len should be min(seq_len, window) for pure sliding-window
    configs), rwkv6's fp32 recurrent state and token-shift states (ssm;
    no cache_len or dtype), or the hybrid's fp32 Mamba2 states (``mamba``,
    ``mamba_tail`` where there are trailing blocks) and the shared block's
    KV cache, one layer per shared application (``shared_cache``)."""
    dev = resolve_device(device)
    if cfg.family == "hybrid":
        rounds, trailing = _hybrid_split(cfg)
        state = {"mamba": L.init_mamba2_cache(
            cfg, batch, rounds * cfg.hybrid_period, dev)}
        if trailing:
            state["mamba_tail"] = L.init_mamba2_cache(cfg, batch, trailing,
                                                      dev)
        state["shared_cache"] = L.init_kv_cache(cfg, batch, cache_len, rounds,
                                                dtype, dev)
        return state
    if cfg.family == "ssm":
        zeros = lambda *shape: torch.zeros((cfg.num_layers, batch) + shape,
                                           dtype=torch.float32, device=dev)
        hd = cfg.ssm.head_dim
        return {"wkv": zeros(cfg.num_heads, hd, hd),
                "x_prev_att": zeros(cfg.d_model),
                "x_prev_ffn": zeros(cfg.d_model)}
    state: Params = {}
    if cfg.first_k_dense:
        state["dense_cache"] = _init_attn_cache(cfg, batch, cache_len,
                                                cfg.first_k_dense, dtype, dev)
    state["cache"] = _init_attn_cache(cfg, batch, cache_len,
                                      cfg.num_layers - cfg.first_k_dense,
                                      dtype, dev)
    return state


def decode_step(params: Params, state: Params, tokens: torch.Tensor,
                cur_pos: torch.Tensor, cfg: ModelConfig, *,
                compute_dtype=torch.bfloat16):
    """One decode step. tokens: (B, 1) int; cur_pos: (B,) absolute position.
    Returns (logits (B, 1, V) fp32, state). The state is updated in place,
    so the returned state is `state` itself (the reference returns an
    updated copy)."""
    x = params["embed"][tokens[:, 0].long()][:, None]
    if cfg.scale_embeddings:
        x = x * math.sqrt(cfg.d_model)
    x = x.to(compute_dtype)
    if cfg.family == "ssm":
        x = _decode_rwkv_stack(params["layers"], state, x, cfg)
    elif cfg.family == "hybrid":
        x = _decode_hybrid(params, state, x, cur_pos, cfg)
    else:
        if cfg.first_k_dense:
            x = _decode_attn_stack(params["dense_layers"],
                                   state["dense_cache"], x, cur_pos, cfg,
                                   moe_layer=False)
        x = _decode_attn_stack(params["layers"], state["cache"], x, cur_pos,
                               cfg, moe_layer=cfg.family == "moe")
    hidden = L.apply_rmsnorm(params["ln_final"], x, cfg.norm_eps)
    return _lm_logits(params, hidden, cfg), state


def _decode_attn_stack(stacked: Params, cache: Params, x: torch.Tensor,
                       cur_pos: torch.Tensor, cfg: ModelConfig, *,
                       moe_layer: bool):
    """Run a stack's layers on one token, writing each layer's cache in
    place. A MoE layer routes the step's B tokens together: its capacity
    comes from B, as the reference's does."""
    n = _n_stacked(stacked)
    for i, (lp, flag) in enumerate(zip(_layers(stacked),
                                       _local_flags(cfg, n))):
        x = _decode_attn_block(lp, cache, i, x, cur_pos, cfg, is_local=flag,
                               moe_layer=moe_layer)
    return x


def _decode_attn_block(lp: Params, cache: Params, i: int, x: torch.Tensor,
                       cur_pos: torch.Tensor, cfg: ModelConfig, *,
                       is_local: bool, moe_layer: bool = False):
    """One attention block on one token, against layer `i` of `cache`,
    which it writes in place (MLA: the absorbed decode on the latent
    cache)."""
    hn = L.apply_rmsnorm(lp["ln_attn"], x, cfg.norm_eps)
    if cfg.mla is not None:
        attn = L.mla_decode(
            lp["attn"], hn, cfg, cache_ckv=cache["ckv"][i],
            cache_krope=cache["krope"][i], cache_pos=cache["pos"][i],
            cur_pos=cur_pos, is_local=is_local)
    else:
        attn = L.decode_attention(
            lp["attn"], hn, cfg, cache_k=cache["k"][i],
            cache_v=cache["v"][i], cache_pos=cache["pos"][i],
            cur_pos=cur_pos, is_local=is_local)
    if cfg.post_block_norm:
        attn = L.apply_rmsnorm(lp["ln_post_attn"], attn, cfg.norm_eps)
    x = x + attn
    hn = L.apply_rmsnorm(lp["ln_mlp"], x, cfg.norm_eps)
    out, _ = _ffn(lp, hn, cfg, moe_layer)
    if cfg.post_block_norm:
        out = L.apply_rmsnorm(lp["ln_post_mlp"], out, cfg.norm_eps)
    return x + out


def _decode_mamba_stack(stacked: Params, mstate: Params, x: torch.Tensor,
                        cfg: ModelConfig):
    """Mamba2 blocks on one token, writing each block's conv window and
    SSM state (layer i of `mstate`) in place."""
    for i, lp in enumerate(_layers(stacked)):
        hn = L.apply_rmsnorm(lp["ln"], x, cfg.norm_eps)
        out, conv, ssm = L.mamba2_decode_step(
            lp["mamba"], hn, cfg, conv_state=mstate["conv"][i],
            ssm_state=mstate["ssm"][i])
        mstate["conv"][i].copy_(conv)
        mstate["ssm"][i].copy_(ssm)
        x = x + out
    return x


def _decode_hybrid(params: Params, state: Params, x: torch.Tensor,
                   cur_pos: torch.Tensor, cfg: ModelConfig):
    """The hybrid stack on one token: each round's Mamba2 blocks, then the
    shared block against its application's layer of ``shared_cache``, then
    the trailing blocks; every state written in place."""
    for r, sl, flag in _hybrid_rounds(cfg):
        x = _decode_mamba_stack(
            tree_map(lambda a: a[sl], params["layers"]),
            tree_map(lambda a: a[sl], state["mamba"]), x, cfg)
        x = _decode_attn_block(params["shared_block"], state["shared_cache"],
                               r, x, cur_pos, cfg, is_local=flag)
    if "tail_layers" in params:
        x = _decode_mamba_stack(params["tail_layers"], state["mamba_tail"],
                                x, cfg)
    return x


def _decode_rwkv_stack(stacked: Params, state: Params, x: torch.Tensor,
                       cfg: ModelConfig):
    """rwkv6's layers on one token, writing each layer's state in place."""
    for i, lp in enumerate(_layers(stacked)):
        x, wkv, xpa, xpf = L.rwkv6_decode_step(
            lp["tm"], lp["cm"], x, cfg, state=state["wkv"][i],
            x_prev_att=state["x_prev_att"][i],
            x_prev_ffn=state["x_prev_ffn"][i], norm_att=lp["ln_att"],
            norm_ffn=lp["ln_ffn"])
        state["wkv"][i].copy_(wkv)
        state["x_prev_att"][i].copy_(xpa)
        state["x_prev_ffn"][i].copy_(xpf)
    return x


# ===========================================================================
# parameter counts (exact — from the port's init on the meta device)
# ===========================================================================

def count_params_analytic(cfg: ModelConfig, active_only: bool = False,
                          include_embed: bool = True) -> int:
    """Parameters of the init's tree, shaped on the `meta` device (no
    memory, no draws). With `include_embed` False the embedding (and an
    untied head) is left out; with `active_only` the experts a token does
    not reach (E - k of them in every moe layer) are, as the reference
    counts them."""
    shapes = _init_tree(cfg, None, torch.float32, torch.device("meta"))
    total = sum(t.numel() for t in tree_leaves(shapes))
    if not include_embed:
        total -= cfg.vocab_size * cfg.d_model
        if not cfg.tie_embeddings:
            total -= cfg.vocab_size * cfg.d_model
    if active_only and cfg.moe is not None:
        mo = cfg.moe
        n_moe = cfg.num_layers - cfg.first_k_dense
        total -= (n_moe * 3 * cfg.d_model * mo.d_ff_expert
                  * (mo.num_experts - mo.top_k))
    return total
