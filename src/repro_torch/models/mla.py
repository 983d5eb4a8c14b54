"""Multi-head Latent Attention (DeepSeek-V2), as the JAX package's
``models/mla.py`` computes it.

Prefill and forward use the naive form (per-head K and V materialized from
the latent); decode uses the absorbed form, which attends in the latent
space, so the cache holds only ``kv_lora_rank + qk_rope_head_dim`` values a
token.  The q and v head dims differ (nope + rope against v_head_dim), so
``layers.mha`` keeps the naive form on its einsum path, never on
``flash_attention``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.util import resolve_device


class MLA(nn.Module):
    """MLA weights: wq (d, H*(nope+rope)) (no q compression), wkv_a
    (d, rank+rope) the joint down-projection to [c_kv | k_rope], kv_norm
    (rank,), wkv_b (rank, H*(nope+v)) the up-projection to per-head
    [k_nope | v], wo (H*v, d)."""

    def __init__(self, cfg, *, device):
        super().__init__()
        device = resolve_device(device)
        a = cfg.attention
        d, H, dt = cfg.d_model, a.num_heads, L.param_dtype(cfg)
        nope, rope_d, vh, rank = (a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim,
                                  a.kv_lora_rank)
        for name, shape in (("wq", (d, H * (nope + rope_d))), ("wkv_a", (d, rank + rope_d)),
                            ("wkv_b", (rank, H * (nope + vh))), ("wo", (H * vh, d))):
            setattr(self, name, L._param(torch.empty(shape, dtype=dt, device=device)))
        self.kv_norm = L._param(torch.ones((rank,), dtype=L.F32, device=device))


def init_mla(key: L.Key, cfg) -> MLA:
    p = MLA(cfg, device=key.device)
    # split(key, 5): the fifth key is unused (no q compression)
    for k, name in zip(key.split(5), ("wq", "wkv_a", "wkv_b", "wo")):
        w = getattr(p, name)
        L.dense_init(k, tuple(w.shape), dtype=w.dtype, out=w.data)
    return p


def _latent(p: MLA, cfg, x, positions):
    """(c_kv (B, S, rank) normed, k_rope (B, S, rope) rotated)."""
    a = cfg.attention
    kv_a = x @ p.wkv_a
    c_kv = L.rms_norm(kv_a[..., :a.kv_lora_rank], p.kv_norm, cfg.norm_eps)
    k_rope = L.apply_rope(kv_a[..., None, a.kv_lora_rank:], positions, a.rope_theta)
    return c_kv, k_rope[..., 0, :]


def _project_common(p: MLA, cfg, x, positions):
    a = cfg.attention
    B, S, _ = x.shape
    H, nope, rope_d = a.num_heads, a.qk_nope_head_dim, a.qk_rope_head_dim
    q = (x @ p.wq).reshape(B, S, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = L.apply_rope(q_rope, positions, a.rope_theta)
    c_kv, k_rope = _latent(p, cfg, x, positions)
    return q_nope, q_rope, c_kv, k_rope


def mla_attend(p: MLA, cfg, x, positions):
    """Naive MLA for forward and prefill: materialize per-head K and V."""
    a = cfg.attention
    B, S, _ = x.shape
    H, nope, rope_d, vh = a.num_heads, a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim
    q_nope, q_rope, c_kv, k_rope = _project_common(p, cfg, x, positions)
    kv = (c_kv @ p.wkv_b).reshape(B, S, H, nope + vh)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rope_d)], dim=-1)
    out = L.mha(q, k, v, causal=True, q_positions=positions, kv_positions=positions)
    return out.reshape(B, S, H * vh) @ p.wo


def mla_prefill(p: MLA, cfg, x, positions):
    """Prefill: the output and the latent cache entries (c_kv, k_rope)."""
    out = mla_attend(p, cfg, x, positions)
    c_kv, k_rope = _latent(p, cfg, x, positions)
    return out, c_kv, k_rope


def mla_decode(p: MLA, cfg, x, cache_ckv, cache_krope, pos: int):
    """Absorbed decode: scores and values in the latent space.

    x: (B, 1, d); cache_ckv (B, T, rank) and cache_krope (B, T, rope) are
    written at ``pos`` in place (the JAX package returns updated copies).
    Scores are f32 products of the stored values (JAX's
    ``preferred_element_type=f32``), slots past ``pos`` masked to the f32
    minimum.  Returns (out (B, 1, d), cache_ckv, cache_krope)."""
    a = cfg.attention
    B = x.shape[0]
    H, nope, rope_d, vh = a.num_heads, a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim
    rank = a.kv_lora_rank
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = _project_common(p, cfg, x, positions)
    cache_ckv[:, pos] = c_kv_new[:, 0]
    cache_krope[:, pos] = k_rope_new[:, 0]
    wkv_b = p.wkv_b.reshape(rank, H, nope + vh)
    w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)  # absorb W_uk into q
    T = cache_ckv.shape[1]
    scores = torch.einsum("bshr,btr->bhst", q_lat.to(L.F32), cache_ckv.to(L.F32))
    scores = scores + torch.einsum("bshn,btn->bhst", q_rope.to(L.F32),
                                   cache_krope.to(L.F32))
    scores = scores / math.sqrt(nope + rope_d)
    valid = torch.arange(T, device=x.device) <= pos
    scores = scores.masked_fill(~valid, torch.finfo(L.F32).min)
    probs = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bhst,btr->bshr", probs.to(cache_ckv.dtype), cache_ckv)
    out = torch.einsum("bshr,rhn->bshn", ctx_lat, w_uv).reshape(B, 1, H * vh)
    return out @ p.wo, cache_ckv, cache_krope
