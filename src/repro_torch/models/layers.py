"""Layer library: RMSNorm, RoPE, attention (GQA / sliding window / softcap
/ qk-norm) for prefill and for cached decode, DeepSeek's multi-head latent
attention (the expanded form for prefill, the absorbed-weight decode
against the latent cache), the SwiGLU MLP, the mixture of experts (both
routers, shared experts, the dense and the capacity-based gspmd dispatch,
the load-balance loss), RWKV6's time mix and channel mix (full-sequence
and single-token decode), the chunk-level linear recurrence they and
Mamba2 need, and Mamba2 (the causal conv, the chunked SSD scan,
full-sequence and single-token decode) (counterpart of
``repro.models.layers``).

Functional style, as the reference: ``init_*`` builds a dict of tensors,
``apply_*`` consumes it, in the reference's layouts (``wq`` (d, H, hd),
``wo`` (H, hd, d), ...), so weights carry over without transposes. An
``init_*`` takes ``lead``, the shape of leading stack axes (the backbone
stacks layers on axis 0). The reference's sharding hints (``constrain``)
have no counterpart on one card, and its scan/unroll helpers none in eager
torch: layers loop in Python, so each layer's local/global flag is a
concrete bool.

Dtype convention: params live in ``param_dtype``; activations are computed
in ``compute_dtype`` with fp32 where it matters (softmax, norms, RoPE).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from repro_torch.kernels.rwkv6 import ref as rwkv_ref

Params = Dict[str, Any]
Shape = Tuple[int, ...]
NEG_INF = -1e30


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

def _dense_init(gen: torch.Generator, shape: Shape, in_axis_size: int, dtype,
                device) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1/fan_in) cut at ±3 std. Drawn in
    fp32 on `device` from `gen` (a generator of that device); a `meta`
    tensor is only shaped."""
    std = 1.0 / math.sqrt(max(in_axis_size, 1))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        torch.nn.init.trunc_normal_(t, 0.0, std, -3.0 * std, 3.0 * std,
                                    generator=gen)
    return t.to(dtype)


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device, lead: Shape = ()) -> Params:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def apply_rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5
                  ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * p["scale"].float()).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> sin/cos of shape (..., head_dim//2), fp32."""
    half = head_dim // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device)
                      * (math.log(theta) / half))
    ang = positions.float()[..., None] * freqs               # (..., half)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., head_dim); sin/cos broadcastable to (..., head_dim//2).

    Rotates pairs (x[..., :half], x[..., half:]) — "half" layout.
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _bcast_rope(sin: torch.Tensor, cos: torch.Tensor):
    """(B, S, half) -> (B, S, 1, half) to broadcast over heads."""
    return sin[..., None, :], cos[..., None, :]


# --------------------------------------------------------------------------
# Attention (GQA, sliding window, softcap, qk-norm) — forward/prefill path
# --------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                   lead: Shape = ()) -> Params:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": _dense_init(gen, lead + (d, H, hd), d, dtype, device),
        "wk": _dense_init(gen, lead + (d, KV, hd), d, dtype, device),
        "wv": _dense_init(gen, lead + (d, KV, hd), d, dtype, device),
        "wo": _dense_init(gen, lead + (H, hd, d), H * hd, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dtype, device, lead)
        p["k_norm"] = init_rmsnorm(hd, dtype, device, lead)
    return p


def _heads_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, nh, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, nh * hd)).unflatten(-1, (nh, hd))


def _heads_out(ctx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product."""
    nh, hd, d = w.shape
    return ctx.flatten(-2) @ w.to(ctx.dtype).reshape(nh * hd, d)


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return torch.tanh(logits / cap) * cap
    return logits


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                   is_local: bool, window: int) -> torch.Tensor:
    """Boolean (broadcast) mask: True = attend. q_pos (..., Sq), k_pos
    (..., Sk)."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    causal = k <= q
    if is_local:
        return causal & (k > q - window)
    return causal


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig, positions):
    hd = cfg.head_dim
    q = _heads_in(x, p["wq"])
    k = _heads_in(x, p["wk"])
    v = _heads_in(x, p["wv"])
    if cfg.qk_norm:
        q = apply_rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = apply_rmsnorm(p["k_norm"], k, cfg.norm_eps)
    sin, cos = rope_angles(positions, hd, cfg.rope_theta)
    sin_b, cos_b = _bcast_rope(sin, cos)
    return apply_rope(q, sin_b, cos_b), apply_rope(k, sin_b, cos_b), v


def multi_head_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                         positions: torch.Tensor, is_local: bool = False,
                         use_kernels: bool = True, return_kv: bool = False):
    """Full-sequence attention. x: (B, S, d); positions: (B, S), the
    sequence's own positions 0..S-1. With return_kv, also returns the
    rope'd (k, v) for the prefill cache fill.

    use_kernels=True sends attention through ``flash_attention`` (the CUDA
    kernel on a card, its plain version on the CPU); False through ``sdpa``,
    the plain path the reference runs without Pallas."""
    q, k, v = _qkv(p, x, cfg, positions)
    if use_kernels:
        ctx = fa_ops.flash_attention(
            q, k, v, causal=True,
            window=cfg.sliding_window if is_local else 0,
            softcap=cfg.attn_logit_softcap)
    else:
        ctx = sdpa(q, k, v, q_pos=positions, k_pos=positions,
                   is_local=is_local, window=cfg.sliding_window,
                   softcap=cfg.attn_logit_softcap)
    out = _heads_out(ctx, p["wo"])
    if return_kv:
        return out, (k, v)
    return out


QCHUNK_THRESHOLD = 4096     # q-chunk full-sequence attention above this Sq
QCHUNK = 1024               # query-block size for the chunked plain path


def sdpa_qchunked(q, k, v, *, q_pos, k_pos, is_local, window, softcap,
                  chunk: int = QCHUNK) -> torch.Tensor:
    """Query-block-chunked attention: never materializes the full Sq×Sk
    logit matrix (peak temp O(chunk·Sk) per head)."""
    Sq = q.shape[1]
    if Sq % chunk:
        return sdpa_reference(q, k, v, q_pos=q_pos, k_pos=k_pos,
                              is_local=is_local, window=window,
                              softcap=softcap)
    outs = [sdpa_reference(q[:, i:i + chunk], k, v,
                           q_pos=q_pos[:, i:i + chunk], k_pos=k_pos,
                           is_local=is_local, window=window, softcap=softcap)
            for i in range(0, Sq, chunk)]
    return torch.cat(outs, dim=1)


def sdpa(q, k, v, *, q_pos, k_pos, is_local, window, softcap) -> torch.Tensor:
    if q.shape[1] > QCHUNK_THRESHOLD:
        return sdpa_qchunked(q, k, v, q_pos=q_pos, k_pos=k_pos,
                             is_local=is_local, window=window, softcap=softcap)
    return sdpa_reference(q, k, v, q_pos=q_pos, k_pos=k_pos,
                          is_local=is_local, window=window, softcap=softcap)


def sdpa_reference(q, k, v, *, q_pos, k_pos, is_local, window,
                   softcap) -> torch.Tensor:
    """Masked GQA attention, fp32 softmax. q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd).
    KV heads are expanded to the full H (head h reads kv head h // G)."""
    hd = q.shape[-1]
    G = q.shape[2] // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    logits = torch.einsum("bqhk,bshk->bhqs", q, k).float()
    logits = logits / math.sqrt(hd)
    logits = _softcap(logits, softcap)
    mask = attention_mask(q_pos, k_pos, is_local=is_local, window=window)
    logits = torch.where(mask[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshk->bqhk", probs, v)


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype, device,
             lead: Shape = ()) -> Params:
    """DeepSeek's multi-head latent attention params, in the reference's
    tree: the query's down / up projections ``w_dq`` (d, r_q), ``w_uq``
    (r_q, H, nope + rope); the joint latent and shared rope key ``w_dkv``
    (d, r_kv + rope); the latent's up projections ``w_uk`` (r_kv, H,
    nope), ``w_uv`` (r_kv, H, v); ``wo`` (H, v, d)."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    r_q, r_kv = m.q_lora_rank, m.kv_lora_rank
    return {
        "w_dq": _dense_init(gen, lead + (d, r_q), d, dtype, device),
        "q_norm": init_rmsnorm(r_q, dtype, device, lead),
        "w_uq": _dense_init(gen, lead + (r_q, H, qk), r_q, dtype, device),
        "w_dkv": _dense_init(gen, lead + (d, r_kv + m.qk_rope_head_dim), d,
                             dtype, device),
        "kv_norm": init_rmsnorm(r_kv, dtype, device, lead),
        "w_uk": _dense_init(gen, lead + (r_kv, H, m.qk_nope_head_dim), r_kv,
                            dtype, device),
        "w_uv": _dense_init(gen, lead + (r_kv, H, m.v_head_dim), r_kv, dtype,
                            device),
        "wo": _dense_init(gen, lead + (H, m.v_head_dim, d), H * m.v_head_dim,
                          dtype, device),
    }


def _mla_query(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) -> (q_nope (B, S, H, nope), q_rope (B, S, H, rope)),
    before RoPE."""
    m = cfg.mla
    cq = apply_rmsnorm(p["q_norm"], x @ p["w_dq"].to(x.dtype), cfg.norm_eps)
    q = _heads_in(cq, p["w_uq"])
    return q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]


def _mla_latent(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) -> (the normed latent ckv (B, S, r_kv), the shared
    rope key (B, S, rope), before RoPE)."""
    r = cfg.mla.kv_lora_rank
    full = x @ p["w_dkv"].to(x.dtype)
    return (apply_rmsnorm(p["kv_norm"], full[..., :r], cfg.norm_eps),
            full[..., r:])


def mla_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  positions: torch.Tensor, is_local: bool = False,
                  return_kv: bool = False):
    """Forward / prefill MLA in the expanded form, as the reference
    computes it. x: (B, S, d); positions: (B, S). Every head's key is its
    nope part (from the latent) with the one rope key broadcast across
    heads and concatenated, so ``sdpa`` scales by 1/sqrt(nope + rope).
    With return_kv, also returns the latent cache entries (ckv, k_rope),
    k_rope rope'd."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope = _mla_query(p, x, cfg)
    ckv, k_rope = _mla_latent(p, x, cfg)
    k_nope = _heads_in(ckv, p["w_uk"])
    v = _heads_in(ckv, p["w_uv"])
    sin, cos = rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    sin_b, cos_b = _bcast_rope(sin, cos)
    q_rope = apply_rope(q_rope, sin_b, cos_b)
    k_rope = apply_rope(k_rope[:, :, None, :], sin_b, cos_b)  # (B,S,1,rope)
    q_eff = torch.cat([q_nope, q_rope], dim=-1)
    k_eff = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_head_dim)],
                      dim=-1)
    ctx = sdpa(q_eff, k_eff, v, q_pos=positions, k_pos=positions,
               is_local=is_local, window=cfg.sliding_window, softcap=0.0)
    out = _heads_out(ctx, p["wo"])
    if return_kv:
        return out, (ckv, k_rope[:, :, 0, :])
    return out


# --------------------------------------------------------------------------
# Attention — single-token decode against a ring-buffer KV cache
# --------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int,
                  num_layers: int, dtype, device) -> Params:
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    shape = (num_layers, batch, cache_len, KV, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        # absolute position stored per slot; -1 = empty
        "pos": torch.full((num_layers, batch, cache_len), -1,
                          dtype=torch.int32, device=device),
    }


def decode_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     cache_pos: torch.Tensor, cur_pos: torch.Tensor,
                     is_local: bool = False):
    """One-token decode. x: (B, 1, d); cache_k/v: (B, C, KV, hd);
    cache_pos: (B, C) absolute positions; cur_pos: (B,) int.

    Returns out (B,1,d). Ring-buffer write at cur_pos % C, so a
    sliding-window cache uses C = window. The write is IN PLACE into the
    given caches (the reference returns updated copies). The reference's
    ``decode_expand_kv`` / ``decode_cache_seq`` variants compute the same
    function as this default GQA-grouped branch and take it.
    """
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    C = cache_k.shape[1]
    q, k, v = _qkv(p, x, cfg, cur_pos[:, None])

    slot = (cur_pos % C).long()                                 # (B,)
    bidx = torch.arange(B, device=x.device)
    cache_k[bidx, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, slot] = v[:, 0].to(cache_v.dtype)
    cache_pos[bidx, slot] = cur_pos.to(cache_pos.dtype)

    G = H // KV
    valid = (cache_pos >= 0) & (cache_pos <= cur_pos[:, None])    # (B, C)
    if is_local:
        valid = valid & (cache_pos > cur_pos[:, None] - cfg.sliding_window)
    qg = q.reshape(B, KV, G, hd)                                  # Sq==1
    kc = cache_k.to(q.dtype).permute(0, 2, 3, 1)                  # (B,KV,hd,C)
    logits = torch.matmul(qg, kc).float()                         # (B,KV,G,C)
    logits = _softcap(logits / math.sqrt(hd), cfg.attn_logit_softcap)
    logits = torch.where(valid[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    vc = cache_v.to(q.dtype).permute(0, 2, 1, 3)                  # (B,KV,C,hd)
    ctx = torch.matmul(probs, vc).reshape(B, 1, H, hd)
    return _heads_out(ctx, p["wo"])


def init_mla_cache(cfg: ModelConfig, batch: int, cache_len: int,
                   num_layers: int, dtype, device) -> Params:
    """MLA's latent ring cache: per position the normed latent ``ckv``
    (r_kv) and the rope'd shared key ``krope`` (rope), not H keys and
    values."""
    m = cfg.mla
    lead = (num_layers, batch, cache_len)
    return {
        "ckv": torch.zeros(lead + (m.kv_lora_rank,), dtype=dtype,
                           device=device),
        "krope": torch.zeros(lead + (m.qk_rope_head_dim,), dtype=dtype,
                             device=device),
        "pos": torch.full(lead, -1, dtype=torch.int32, device=device),
    }


def mla_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
               cache_ckv: torch.Tensor, cache_krope: torch.Tensor,
               cache_pos: torch.Tensor, cur_pos: torch.Tensor,
               is_local: bool = False) -> torch.Tensor:
    """One-token MLA decode with the absorbed weights: the query's nope
    part is taken through ``w_uk`` into the latent space and scored against
    the latent cache directly, and the context is taken out of it through
    ``w_uv``. x: (B, 1, d); cache_ckv (B, C, r_kv), cache_krope (B, C,
    rope), cache_pos (B, C); cur_pos (B,). The ring write at cur_pos % C
    is IN PLACE (the reference returns updated copies). Returns out
    (B, 1, d)."""
    m = cfg.mla
    B = x.shape[0]
    C = cache_ckv.shape[1]
    q_nope, q_rope = (t[:, 0] for t in _mla_query(p, x, cfg))   # (B,H,.)
    ckv, k_rope = (t[:, 0] for t in _mla_latent(p, x, cfg))     # (B,.)
    sin, cos = rope_angles(cur_pos[:, None], m.qk_rope_head_dim,
                           cfg.rope_theta)                      # (B,1,half)
    q_rope = apply_rope(q_rope, sin, cos)
    k_rope = apply_rope(k_rope[:, None, :], sin, cos)[:, 0]

    slot = (cur_pos % C).long()
    bidx = torch.arange(B, device=x.device)
    cache_ckv[bidx, slot] = ckv.to(cache_ckv.dtype)
    cache_krope[bidx, slot] = k_rope.to(cache_krope.dtype)
    cache_pos[bidx, slot] = cur_pos.to(cache_pos.dtype)

    # absorb: q_eff[b,h,r] = sum_k q_nope[b,h,k] * w_uk[r,h,k]
    q_eff = torch.einsum("bhk,rhk->bhr", q_nope, p["w_uk"].to(x.dtype))
    lat = cache_ckv.to(x.dtype)                                  # (B,C,r)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    logits = (torch.matmul(q_eff, lat.transpose(1, 2))
              + torch.matmul(q_rope, cache_krope.to(x.dtype).transpose(1, 2))
              ).float() * scale                                  # (B,H,C)
    valid = (cache_pos >= 0) & (cache_pos <= cur_pos[:, None])
    if is_local:
        valid = valid & (cache_pos > cur_pos[:, None] - cfg.sliding_window)
    logits = torch.where(valid[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx = torch.matmul(probs, lat)                               # (B,H,r)
    out_h = torch.einsum("bhr,rhk->bhk", ctx, p["w_uv"].to(x.dtype))
    return _heads_out(out_h[:, None], p["wo"])


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, d_ff: int, dtype, device,
             lead: Shape = ()) -> Params:
    return {
        "w_gate": _dense_init(gen, lead + (d, d_ff), d, dtype, device),
        "w_up": _dense_init(gen, lead + (d, d_ff), d, dtype, device),
        "w_down": _dense_init(gen, lead + (d_ff, d), d_ff, dtype, device),
    }


def apply_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    return (F.silu(g) * u) @ p["w_down"].to(x.dtype)


# --------------------------------------------------------------------------
# Mixture of Experts
# --------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, device,
             lead: Shape = ()) -> Params:
    mo = cfg.moe
    d, E, f = cfg.d_model, mo.num_experts, mo.d_ff_expert
    p = {
        # the router stays fp32 whatever the param dtype
        "router": _dense_init(gen, lead + (d, E), d, torch.float32, device),
        "w_gate": _dense_init(gen, lead + (E, d, f), d, dtype, device),
        "w_up": _dense_init(gen, lead + (E, d, f), d, dtype, device),
        "w_down": _dense_init(gen, lead + (E, f, d), f, dtype, device),
    }
    if mo.router == "sigmoid":          # deepseek-v3's aux-free bias
        p["router_bias"] = torch.zeros(lead + (E,), dtype=torch.float32,
                                       device=device)
    if mo.num_shared_experts:
        p["shared"] = init_mlp(gen, d, mo.d_ff_shared * mo.num_shared_experts,
                               dtype, device, lead)
    return p


def _router_probs(p: Params, x2d: torch.Tensor, mo):
    """x2d: (T, d) -> (gates (T, k), idx (T, k), probs (T, E) fp32). Both
    routers: softmax -> top-k -> renormalised gates; sigmoid -> top-k of
    the bias-shifted scores (the bias moves the selection only) -> the
    chosen probabilities renormalised, times ``routed_scaling``."""
    logits = x2d.float() @ p["router"].float()
    if mo.router == "sigmoid":
        probs = torch.sigmoid(logits)
        sel = probs + p["router_bias"].float()[None, :]
        idx = torch.topk(sel, mo.top_k, dim=-1).indices
        gates = torch.gather(probs, -1, idx)
        gates = gates / (torch.sum(gates, dim=-1, keepdim=True) + 1e-9)
        gates = gates * mo.routed_scaling
    else:
        probs = torch.softmax(logits, dim=-1)
        gates, idx = torch.topk(probs, mo.top_k, dim=-1)
        gates = gates / (torch.sum(gates, dim=-1, keepdim=True) + 1e-9)
    return gates, idx, probs


def moe_aux_loss(probs: torch.Tensor, idx: torch.Tensor, mo) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * P_e. The counts are
    a scatter-add (no host sync, so a captured step can run it)."""
    E = mo.num_experts
    T = probs.shape[0]
    counts = torch.zeros((E,), dtype=torch.float32, device=probs.device)
    counts = counts.index_add(0, idx.reshape(-1),
                              torch.ones(idx.numel(), dtype=torch.float32,
                                         device=probs.device))
    f = counts / (T * mo.top_k)
    P = probs.mean(dim=0)
    return E * torch.sum(f * P)


def apply_moe_dense(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Every token through every expert, weighted by its (top-k masked)
    gate: the reference's path for tiny configs. O(T·E·d·f) work."""
    mo = cfg.moe
    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    gates, idx, probs = _router_probs(p, x2d, mo)
    dense_gates = torch.zeros((x2d.shape[0], mo.num_experts),
                              dtype=torch.float32, device=x.device)
    dense_gates = dense_gates.scatter_add(1, idx, gates)
    g = torch.einsum("td,edf->tef", x2d, p["w_gate"].to(x.dtype))
    u = torch.einsum("td,edf->tef", x2d, p["w_up"].to(x.dtype))
    y = torch.einsum("tef,efd->ted", F.silu(g) * u, p["w_down"].to(x.dtype))
    out = torch.einsum("ted,te->td", y.float(), dense_gates).to(x.dtype)
    if mo.num_shared_experts:
        out = out + apply_mlp(p["shared"], x2d)
    return out.reshape(B, S, d), moe_aux_loss(probs, idx, mo)


def moe_dispatch(idx: torch.Tensor, cap: int, E: int):
    """The gspmd path's queue positions. idx (T, k) -> (flat_e (T·k,),
    slot (T·k,), keep (T·k,) bool): each (token, slot) pair's place in its
    expert's queue, by a stable sort on the expert id, so earlier tokens
    (and, within a token, earlier slots) come first; a place at or past
    `cap` is dropped and points at the overflow slot `cap`. No host sync:
    sort, searchsorted and scatter run on the device."""
    flat_e = idx.reshape(-1)
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(E, dtype=sorted_e.dtype, device=idx.device))
    pos_sorted = torch.arange(n, device=idx.device) - starts[sorted_e]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < cap
    slot = torch.where(keep, pos, cap)
    return flat_e, slot, keep


def apply_moe_gspmd(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Capacity-based dispatch by scatter and gather, the reference's
    Switch semantics: capacity cap = max(int(capacity_factor·T·k/E), 1)
    from this call's own T tokens (so a decode step's output depends on
    its batch-mates), tokens over capacity dropped. Each (token, slot)
    row is written to (expert, place) of an (E, cap + 1, d) buffer; the
    dropped rows all land in the overflow slot `cap`, which is cut off
    before any use, as the reference's ``buf[:, :cap]`` is (which of them
    lands there does not matter). The expert products are batched
    matmuls over E."""
    mo = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = mo.num_experts, mo.top_k
    x2d = x.reshape(T, d)
    gates, idx, probs = _router_probs(p, x2d, mo)
    cap = max(int(mo.capacity_factor * T * k / E), 1)
    flat_e, slot, keep = moe_dispatch(idx, cap, E)

    src = x2d[:, None, :].expand(T, k, d).reshape(T * k, d)   # t-major
    buf = x.new_zeros((E, cap + 1, d)).index_put_((flat_e, slot), src)
    ebuf = buf[:, :cap]
    g = torch.bmm(ebuf, p["w_gate"].to(x.dtype))
    u = torch.bmm(ebuf, p["w_up"].to(x.dtype))
    y = torch.bmm(F.silu(g) * u, p["w_down"].to(x.dtype))

    # back to the (token, slot) rows: a dropped row reads the zero pad. A
    # row gather of the flattened buffer, whose gradient is an index_add
    # into distinct rows (the pad's, discarded, aside)
    y_pad = torch.cat([y, y.new_zeros((E, 1, d))], dim=1)
    back = y_pad.reshape(E * (cap + 1), d).index_select(
        0, flat_e * (cap + 1) + slot)                          # (T·k, d)
    w = (gates.reshape(-1) * keep.float()).to(x.dtype)
    out = torch.sum((back * w[:, None]).reshape(T, k, d), dim=1)
    if mo.num_shared_experts:
        out = out + apply_mlp(p["shared"], x2d)
    return out.reshape(B, S, d), moe_aux_loss(probs, idx, mo)


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """-> (out (B, S, d), aux loss). impl "dense", "gspmd" or "ep" (the
    expert-parallel path, ``moe_ep``, which on one card is gspmd's)."""
    impl = cfg.moe.impl
    if impl == "dense":
        return apply_moe_dense(p, x, cfg)
    if impl == "ep":
        from repro_torch.models.moe_ep import apply_moe_ep
        return apply_moe_ep(p, x, cfg)
    return apply_moe_gspmd(p, x, cfg)


# --------------------------------------------------------------------------
# RWKV6 (Finch): time-mix with data-dependent decay + channel mix
# --------------------------------------------------------------------------

def _draw(shape: Shape, device, fill) -> torch.Tensor:
    """An fp32 tensor filled in place by `fill` (a draw from a generator);
    a `meta` tensor is only shaped."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        fill(t)
    return t


def init_rwkv6(gen: torch.Generator, cfg: ModelConfig, dtype, device,
               lead: Shape = ()) -> Params:
    d = cfg.d_model
    H, hd = cfg.num_heads, cfg.ssm.head_dim
    inner = H * hd
    lora = max(32, d // 16)
    uniform = lambda t: t.uniform_(0.0, 1.0, generator=gen)
    normal = lambda t: t.normal_(0.0, 1.0, generator=gen)
    return {
        # data-dependent token-shift lerp (5 targets: r,k,v,w,g)
        "mix_base": (_draw(lead + (5, d), device, uniform) * 0.5).to(dtype),
        "mix_lora_a": _dense_init(gen, lead + (d, 5, lora // 2), d, dtype,
                                  device),
        "mix_lora_b": _dense_init(gen, lead + (5, lora // 2, d), lora, dtype,
                                  device),
        "w_r": _dense_init(gen, lead + (d, H, hd), d, dtype, device),
        "w_k": _dense_init(gen, lead + (d, H, hd), d, dtype, device),
        "w_v": _dense_init(gen, lead + (d, H, hd), d, dtype, device),
        "w_g": _dense_init(gen, lead + (d, inner), d, dtype, device),
        "w_o": _dense_init(gen, lead + (H, hd, d), inner, dtype, device),
        # decay: w_t = exp(-exp(decay_base + lora(x))); fp32 whatever dtype
        "decay_base": _draw(lead + (H, hd), device, normal) * 0.3 - 1.0,
        "decay_lora_a": _dense_init(gen, lead + (d, lora), d, dtype, device),
        "decay_lora_b": _dense_init(gen, lead + (lora, H, hd), lora, dtype,
                                    device),
        "bonus": _draw(lead + (H, hd), device, normal) * 0.3,
        "ln_out": init_rmsnorm(inner, dtype, device, lead),
    }


def _rwkv6_rkvwg(p: Params, x: torch.Tensor, x_prev: torch.Tensor,
                 cfg: ModelConfig):
    """Token-shift data-dependent mixing -> (r, k, v, log_w (fp32), g).

    Decode's token-shift state `x_prev` is fp32: there the mixes, and the
    products after them, run in fp32 on the weights cast to the compute
    dtype, as the reference's mixed-dtype einsums promote."""
    dt = x.dtype
    # ddlerp: mix_i = x + (shifted - x) * (base_i + lora_i(x))
    lora_in = torch.einsum("...d,dml->...ml", x, p["mix_lora_a"].to(dt))
    lora = torch.einsum("...ml,mld->...md", torch.tanh(lora_in),
                        p["mix_lora_b"].to(dt))
    mixes = x[..., None, :] + (x_prev - x)[..., None, :] * (
        p["mix_base"].to(dt) + lora)                             # (..., 5, d)
    w = lambda name: p[name].to(dt).to(mixes.dtype)
    xr, xk, xv, xw, xg = mixes.unbind(-2)
    r = _heads_in(xr, w("w_r"))
    k = _heads_in(xk, w("w_k"))
    v = _heads_in(xv, w("w_v"))
    dl = xw @ w("decay_lora_a")
    dw = torch.einsum("...l,lhk->...hk", torch.tanh(dl), w("decay_lora_b"))
    # Clip so per-step log-decay >= -e^1.6 ~= -4.95: keeps the chunked
    # factored form (k * exp(-cumdecay)) inside fp32 range for chunk<=16
    # (see kernels/rwkv6/ref.py stability note).
    log_w = -torch.exp(torch.clamp(p["decay_base"] + dw.float(), -8.0, 1.6))
    g = F.silu(xg @ w("w_g"))
    return r, k, v, log_w, g


def rwkv6_timemix(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  use_kernels: bool = True, return_state: bool = False):
    """Full-sequence RWKV6 time mix. x: (B, S, d). With return_state, also
    returns the final recurrent wkv state (B, H, K, V) for prefill.

    use_kernels=True runs the recurrence through ``rwkv_ops.wkv6`` (the CUDA
    kernel on a card, the chunked plain form on the CPU), as the reference's
    ``use_pallas`` does; asking for the state takes the chunked plain form,
    as in the reference (the kernel returns no state)."""
    B, S, d = x.shape
    H, hd = cfg.num_heads, cfg.ssm.head_dim
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, log_w, g = _rwkv6_rkvwg(p, x, x_prev, cfg)
    if use_kernels and not return_state:
        o = rwkv_ops.wkv6(r, k, v, log_w, p["bonus"], chunk=cfg.ssm.chunk)
        state = None
    else:
        res = rwkv_ref.wkv6_chunked(r, k, v, log_w, p["bonus"],
                                    chunk=cfg.ssm.chunk,
                                    return_state=return_state,
                                    shard=cfg.ssm.shard)
        o, state = res if return_state else (res, None)
    o = o.reshape(B, S, H * hd).to(x.dtype)
    o = apply_rmsnorm(p["ln_out"], o, cfg.norm_eps) * g
    out = _heads_out(o.reshape(B, S, H, hd), p["w_o"])
    if return_state:
        return out, state
    return out


def init_rwkv6_channelmix(gen: torch.Generator, cfg: ModelConfig, dtype,
                          device, lead: Shape = ()) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mix_k": (_draw(lead + (d,), device,
                        lambda t: t.uniform_(0.0, 1.0, generator=gen))
                  * 0.5).to(dtype),
        "w_k": _dense_init(gen, lead + (d, f), d, dtype, device),
        "w_v": _dense_init(gen, lead + (f, d), f, dtype, device),
        "w_r": _dense_init(gen, lead + (d, d), d, dtype, device),
    }


def rwkv6_channelmix(p: Params, x: torch.Tensor, x_prev: torch.Tensor
                     ) -> torch.Tensor:
    dt = x.dtype
    xk = x + (x_prev - x) * p["mix_k"].to(dt)
    k = torch.square(F.relu(xk @ p["w_k"].to(dt)))
    kv = k @ p["w_v"].to(dt)
    r = torch.sigmoid(xk @ p["w_r"].to(dt))
    return r * kv


def rwkv6_decode_step(p_tm: Params, p_cm: Params, x: torch.Tensor,
                      cfg: ModelConfig, *, state: torch.Tensor,
                      x_prev_att: torch.Tensor, x_prev_ffn: torch.Tensor,
                      norm_att: Params, norm_ffn: Params):
    """Single-token RWKV6 block step. x: (B, 1, d) in the compute dtype;
    state: (B, H, hd, hd) fp32; x_prev_att / x_prev_ffn: (B, d) fp32.
    Returns (out (B, 1, d) in x's dtype, new state, new x_prev_att, new
    x_prev_ffn), the last three fp32. Nothing is written in place."""
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.ssm.head_dim
    xa = apply_rmsnorm(norm_att, x, cfg.norm_eps)[:, 0]          # (B, d)
    r, k, v, log_w, g = _rwkv6_rkvwg(p_tm, xa, x_prev_att, cfg)
    rf, kf, vf = r.float(), k.float(), v.float()
    u = p_tm["bonus"].float()
    # o = r · (S + u ⊙ k vᵀ); S' = diag(w) S + k vᵀ
    kv = kf[..., :, None] * vf[..., None, :]                     # (B,H,K,V)
    o = torch.einsum("bhk,bhkv->bhv", rf, state + u[None, :, :, None] * kv)
    new_state = torch.exp(log_w)[..., None] * state + kv
    o = o.reshape(B, H * hd).to(x.dtype)
    o = apply_rmsnorm(p_tm["ln_out"], o, cfg.norm_eps) * g
    att_out = _heads_out(o.reshape(B, H, hd), p_tm["w_o"].to(x.dtype))
    h = x[:, 0] + att_out
    xf = apply_rmsnorm(norm_ffn, h[:, None], cfg.norm_eps)[:, 0]
    ffn_out = rwkv6_channelmix(p_cm, xf, x_prev_ffn)
    # the fp32 token-shift states promote the residual: cast it back so the
    # next layer takes the compute dtype
    out = (h + ffn_out).to(x.dtype)[:, None]
    return out, new_state, xa.float(), xf.float()


# --------------------------------------------------------------------------
# the chunk-level linear recurrence s_i = a_i ⊙ s_{i-1} + b_i
# --------------------------------------------------------------------------

PSCAN_MIN_BLOCK = 16     # fewest steps a block of the closed form takes
# log a where a = 0: far under any fp32 or fp64 exponent, so exp of a sum
# that crosses it is 0, yet finite, so two such sums still subtract
LOG_ZERO = -1e4


def linear_recurrence_pscan(a: torch.Tensor, b: torch.Tensor,
                            extra_dims: int = 1) -> torch.Tensor:
    """Inclusive prefix states of s_i = a_i ⊙ s_{i-1} + b_i along axis 1.

    a: (G, n, K) in [0, 1]; b: (G, n, K, *extra). Returns inclusive states
    like b. The reference runs a log-depth associative scan, which torch
    lacks; this is a blocked closed form. Within blocks of L steps,
    s_i = Σ_{j<=i} exp(C_i - C_j) b_j with C = cumsum(log a) from the
    block's start, one batched product; across blocks a loop carries the
    block-end state, s = exp(C) ⊙ s_prev + local. Every exponent is <= 0,
    so no term overflows; C is summed in float64, so the differences keep
    fp32 precision however strong the decay. An a that is exactly 0 (a
    decay that underflowed, as Mamba2's chunk decays do at full width)
    takes log a = LOG_ZERO: every weight across it is exp(<= -1e4) = 0,
    so the state restarts from b there, as the loop's does, and sums of
    ~1e4 keep ~1e-12 of absolute precision in float64; its gradient
    reaches a = 0 as 0, never as 0/0. L = clamp(X, 16, n) for X the
    product of the extra dims: the (G, n, L, K) weights hold no more
    elements than the (G, n, K, X) states returned (for X >= 16), so memory
    is linear in n, as the reference's scan is.
    """
    G, n, K = a.shape
    bf = b.reshape(G, n, K, -1)
    X = bf.shape[-1]
    L = max(1, min(n, max(X, PSCAN_MIN_BLOCK)))
    nb = -(-n // L)
    pad = nb * L - n
    if pad:             # a = 1, b = 0 past n: the states just carry on
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        bf = F.pad(bf, (0, 0, 0, 0, 0, pad))
    live = a > 0
    log_a = torch.where(live, torch.log(torch.where(live, a, 1.0)).double(),
                        LOG_ZERO)
    C = torch.cumsum(log_a.reshape(G, nb, L, K), dim=2)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=a.device))[None, None, :, :, None]
    weight = torch.exp(torch.where(
        causal, (C[:, :, :, None] - C[:, :, None]).to(a.dtype), -torch.inf))
    local = torch.einsum("gbijk,gbjkx->gbikx", weight,
                         bf.reshape(G, nb, L, K, X))
    del weight
    # the state entering each block: a loop over nb = n / L block ends
    decay = torch.exp(C).to(a.dtype)                       # (G, nb, L, K)
    carry = [torch.zeros_like(local[:, 0, 0])]
    for blk in range(nb - 1):
        carry.append(decay[:, blk, -1, :, None] * carry[-1]
                     + local[:, blk, -1])
    incl = local + decay[..., None] * torch.stack(carry, 1)[:, :, None]
    return incl.reshape(G, nb * L, *b.shape[2:])[:, :n]


def _prev_states(a: torch.Tensor, b: torch.Tensor, extra_dims: int = 1):
    """(exclusive-prefix states, final state) for the recurrence above."""
    incl = linear_recurrence_pscan(a, b, extra_dims)
    prev = torch.cat([torch.zeros_like(incl[:, :1]), incl[:, :-1]], dim=1)
    return prev, incl[:, -1]


# --------------------------------------------------------------------------
# Mamba2 (SSD)
# --------------------------------------------------------------------------

def _mamba2_dims(cfg: ModelConfig):
    """(inner width, SSD heads H, state N, head width P, conv channels)."""
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    return (inner, inner // s.head_dim, s.state_dim, s.head_dim,
            inner + 2 * s.state_dim)


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                lead: Shape = ()) -> Params:
    d = cfg.d_model
    inner, H, N, _, conv_ch = _mamba2_dims(cfg)
    fp32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, **fp32))
    return {
        "w_in": _dense_init(gen, lead + (d, 2 * inner + 2 * N + H), d, dtype,
                            device),
        "conv_w": (_draw(lead + (cfg.ssm.conv_dim, conv_ch), device,
                         lambda t: t.normal_(0.0, 1.0, generator=gen))
                   * 0.2).to(dtype),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=device),
        # A_log, D and dt_bias stay fp32 whatever the param dtype
        "A_log": a_log.expand(lead + (H,)).contiguous(),
        "D": torch.ones(lead + (H,), **fp32),
        "dt_bias": _draw(lead + (H,), device,
                         lambda t: t.uniform_(0.0, 1.0, generator=gen))
                   * 2.0 - 4.0,
        "gate_norm": init_rmsnorm(inner, dtype, device, lead),
        "w_out": _dense_init(gen, lead + (inner, d), inner, dtype, device),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                   ) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); w: (K, C). Accumulates in
    x's dtype, tap by tap in the reference's order."""
    K, S = w.shape[0], x.shape[1]
    xpad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):                                   # K is tiny (4)
        out = out + xpad[:, i:i + S] * w[i]
    return out + b


def mamba2_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                   return_state: bool = False):
    """Full-sequence Mamba2 (chunked SSD). x: (B, S, d). With return_state,
    also returns (conv_window (B, K-1, C) fp32, ssm_state (B, H, N, P))."""
    B, S, _ = x.shape
    inner, H, N, P, _ = _mamba2_dims(cfg)
    proj = x @ p["w_in"].to(x.dtype)
    z, xin, Bc, Cc, dt = torch.split(proj, [inner, inner, N, N, H], dim=-1)
    conv_raw = torch.cat([xin, Bc, Cc], dim=-1)
    conv_in = F.silu(_causal_conv1d(conv_raw, p["conv_w"].to(x.dtype),
                                    p["conv_b"].to(x.dtype)))
    xin, Bc, Cc = torch.split(conv_in, [inner, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                   # (B, S, H)
    A = -torch.exp(p["A_log"])                                   # (H,)
    xh = xin.reshape(B, S, H, P)
    y, ssm_state = ssd_chunked(xh, dt, A, Bc, Cc, chunk=cfg.ssm.chunk,
                               return_state=True)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, inner).to(x.dtype)
    y = apply_rmsnorm(p["gate_norm"], y, cfg.norm_eps) * F.silu(z)
    out = y @ p["w_out"].to(x.dtype)
    if return_state:
        K = cfg.ssm.conv_dim
        conv_window = F.pad(conv_raw, (0, 0, K - 1, 0))[:, -(K - 1):].float()
        return out, (conv_window, ssm_state)
    return out


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bc: torch.Tensor, Cc: torch.Tensor, *, chunk: int,
                return_state: bool = False):
    """Chunked state-space-dual scan (Mamba2).

    xh: (B, S, H, P); dt: (B, S, H) fp32; A: (H,) fp32; Bc / Cc: (B, S, N).
    Returns fp32 (B, S, H, P) (and the final state (B, H, N, P) with
    return_state). Scalar-per-head decay gives (L, L) pairwise matrices a
    chunk. The reference's three-operand einsums are written as named
    steps, each a batched matrix product over two operands, so no order
    an einsum planner might pick makes a (B, nc, L, N, H, P) tensor: the
    largest intermediate is (B, nc, H, L, L) fp32.
    """
    B, S0, H, P = xh.shape
    N = Bc.shape[-1]
    L = min(chunk, S0)
    pad = (-S0) % L
    if pad:
        # dt = 0 -> unit decay and no input at the padded steps, so the
        # final state is the one the unpadded steps left
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
    S = S0 + pad
    nc = S // L
    xb = xh.reshape(B, nc, L, H, P).float()
    dtb = dt.reshape(B, nc, L, H)
    Bb = Bc.reshape(B, nc, L, N).float()
    Cb = Cc.reshape(B, nc, L, N).float()

    cum = torch.cumsum(dtb * A, dim=2)             # (B, nc, L, H) inclusive
    cum_h = cum.transpose(2, 3)                    # (B, nc, H, L)
    diff = cum_h[..., :, None] - cum_h[..., None, :]      # (B, nc, H, Lq, Lk)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=xh.device))
    # mask in log space BEFORE exp: the upper triangle holds positive
    # log-decay sums that would overflow fp32 (and give inf·0 gradients)
    seg = torch.exp(torch.where(causal, diff, NEG_INF))

    # intra-chunk: y[t] = Σ_{i<=t} C_t·B_i seg[t, i] dt_i x_i
    cb = Cb @ Bb.transpose(-1, -2)                 # (B, nc, Lq, Lk)
    scores = cb[:, :, None] * seg                  # (B, nc, H, Lq, Lk)
    xdt = (xb * dtb[..., None]).transpose(2, 3)    # (B, nc, H, L, P)
    y_intra = (scores @ xdt).transpose(2, 3)       # (B, nc, L, H, P)

    # chunk-final states: S_c = Σ_i exp(cum_L - cum_i) dt_i B_i x_iᵀ
    w_end = torch.exp(cum[:, :, -1:] - cum) * dtb  # (B, nc, L, H)
    xw = (xb * w_end[..., None]).reshape(B, nc, L, H * P)
    state_c = (Bb.transpose(-1, -2) @ xw).reshape(B, nc, N, H, P)
    state_c = state_c.permute(0, 1, 3, 2, 4)       # (B, nc, H, N, P)

    # the recurrence over chunks, then their outputs from the entering
    # state: y[t] += C_t · (exp(cum_t) * prev_state)
    chunk_decay = torch.exp(cum[:, :, -1])         # (B, nc, H)
    prev, final_state = _prev_states(chunk_decay, state_c, extra_dims=2)
    prev_n = prev.permute(0, 1, 3, 2, 4).reshape(B, nc, N, H * P)
    y_inter = (Cb @ prev_n).reshape(B, nc, L, H, P) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B, S, H, P)[:, :S0]
    if return_state:
        return y, final_state
    return y


def init_mamba2_cache(cfg: ModelConfig, batch: int, num_layers: int,
                      device) -> Params:
    _, H, N, P, conv_ch = _mamba2_dims(cfg)
    zeros = lambda *shape: torch.zeros((num_layers, batch) + shape,
                                       dtype=torch.float32, device=device)
    return {"conv": zeros(cfg.ssm.conv_dim - 1, conv_ch),
            "ssm": zeros(H, N, P)}


def mamba2_decode_step(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                       conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """Single-token Mamba2 step. x: (B, 1, d); conv_state: (B, K-1, C) fp32;
    ssm_state: (B, H, N, P) fp32. Returns (out (B, 1, d), new conv window,
    new ssm state), the new window a fresh tensor (never a view of
    `conv_state`, so a caller may copy it back in place). Nothing is
    written in place."""
    B = x.shape[0]
    inner, H, N, P, _ = _mamba2_dims(cfg)
    proj = (x @ p["w_in"].to(x.dtype))[:, 0]
    z, xin, Bc, Cc, dt = torch.split(proj, [inner, inner, N, N, H], dim=-1)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)                   # (B, C)
    window = torch.cat([conv_state, conv_in[:, None].float()], dim=1)
    conv_out = (torch.sum(window * p["conv_w"].float(), dim=1)
                + p["conv_b"].float())
    conv_out = F.silu(conv_out).to(x.dtype)
    xin, Bc, Cc = torch.split(conv_out, [inner, N, N], dim=-1)
    dtf = F.softplus(dt.float() + p["dt_bias"])                  # (B, H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dtf * A[None, :])                          # (B, H)
    xhead = xin.reshape(B, H, P).float()
    dBx = (dtf[:, :, None, None] * Bc.float()[:, None, :, None]
           * xhead[:, :, None, :])                               # (B,H,N,P)
    new_ssm = ssm_state * decay[..., None, None] + dBx
    y = (Cc.float()[:, None, None, :] @ new_ssm)[:, :, 0]        # (B, H, P)
    y = y + p["D"][None, :, None] * xhead
    y = y.reshape(B, inner).to(x.dtype)
    y = apply_rmsnorm(p["gate_norm"], y, cfg.norm_eps) * F.silu(z)
    out = y @ p["w_out"].to(x.dtype)
    return out[:, None], window[:, 1:], new_ssm
