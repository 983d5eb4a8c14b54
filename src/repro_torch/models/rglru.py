"""RecurrentGemma / Griffin hybrid family: RG-LRU recurrent blocks and local
(sliding-window) MQA in a repeating pattern (rec, rec, attn), as the JAX
package's ``models/rglru.py``.

The family API:

    init(seed, cfg, device)              -> Griffin (an nn.Module)
    forward(params, cfg, batch)          -> logits (B,S,V) fp32
    loss(params, cfg, batch)             -> (scalar, aux)
    init_cache(cfg, batch, max_len)      -> cache dict
    prefill(params, cfg, batch)          -> (last_logits, cache)
    decode_step(params, cfg, cache, tok) -> (logits, cache)

Train and prefill run the RG-LRU's linear recurrence h_t = a_t h_{t-1} +
b_t over the sequence as a doubling scan on whole tensors (``linear_scan``:
ceil(log2 S) steps, 12 at S 4,096), where the JAX package takes
``lax.associative_scan``; both sum in f32 but in other trees, so they agree
to f32 rounding (the tests' 1e-5).  Decode is the O(1) recurrent step and a
ring buffer of the window's K/V.  The local attention (window 2,048) takes
``layers.mha``'s einsum path on every device: the ``flash_attention``
kernel serves full causal attention only.  Blocks differ in kind, so
``params.blocks`` is a ``ModuleList`` of unstacked blocks in the JAX
package's tuple order, each optionally recomputed in the backward
(``cfg.remat``).  A cache is {"blocks": a tuple of {"conv": (B, K-1, w),
"h": (B, w) f32} or {"k", "v": (B, W, K, hd)}, "pos": int}; ``decode_step``
writes into its tensors in place.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import ctx
from repro_torch.models import layers as L
from repro_torch.util import prng, resolve_device

F32 = torch.float32
_C = 8.0  # RG-LRU exponent scale (Griffin paper)


# --------------------------------------------------------------- RG-LRU
class RGLRU(nn.Module):
    """The recurrent branch's weights, named as the JAX package's keys
    (``lambda`` included, registered by name).  Drawn from ``key`` (an
    ``L.Key``) as the JAX package's ``init_rglru``: ``split(key, 6)``, the
    out projection from ``fold_in(key, 7)``."""

    def __init__(self, cfg, key=None, *, device):
        super().__init__()
        h = cfg.hybrid
        d, w = cfg.d_model, h.lru_width
        dt = L.param_dtype(cfg)

        def empty(shape, dtype=dt):
            return L._param(torch.empty(shape, dtype=dtype, device=device))

        self.wx = empty((d, w))
        self.wgate = empty((d, w))
        self.conv_w = empty((h.conv_width, w))
        self.conv_b = L._param(torch.zeros((w,), dtype=dt, device=device))
        self.wa = empty((w, w))
        self.ba = L._param(torch.zeros((w,), dtype=F32, device=device))
        self.wi = empty((w, w))
        self.bi = L._param(torch.zeros((w,), dtype=F32, device=device))
        self.register_parameter("lambda", empty((w,), F32))
        self.wo = empty((w, d))
        if key is not None:
            ks = key.split(6)
            with torch.no_grad():
                getattr(self, "lambda").copy_(lru_lambda(ks[0], w))
            for k, name in zip(ks[1:], ("wx", "wgate", "conv_w", "wa", "wi")):
                p = getattr(self, name)
                L.dense_init(k, tuple(p.shape), dtype=dt, out=p.data,
                             times=0.1 if name == "conv_w" else None)
            L.dense_init(key.fold_in(7), (w, d), dtype=dt, out=self.wo.data)


def lru_lambda(key: L.Key, w: int) -> torch.Tensor:
    """``lambda = log(expm1(-log(u) / c))``, u uniform on [0.9, 0.999) drawn
    on the key's device, so that a = exp(-c softplus(lambda)) lies in [0.9,
    0.999]: ``w`` f32 values computed on the host through XLA's CPU ``log``
    and ``expm1`` (``util/prng.py``), as the JAX package computes them;
    torch's differ by an ulp."""
    u = prng.uniform(key.key, (w,), 0.9, 0.999, device=key.device).cpu().numpy()
    lam = prng.log32(prng.expm1_32(-prng.log32(u) / np.float32(_C)))
    return torch.from_numpy(lam)


def _lru_gates(p: RGLRU, x):
    """x: (..., w) post-conv activations -> (log_a, gated input b) f32."""
    xf = x.to(F32)
    r = torch.sigmoid(xf @ p.wa.to(F32) + p.ba)
    i = torch.sigmoid(xf @ p.wi.to(F32) + p.bi)
    log_a = -_C * F.softplus(getattr(p, "lambda")) * r
    a2 = torch.exp(2.0 * log_a)
    b = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * xf)
    return log_a, b


def _conv1d(x, w, b):
    """Causal depthwise conv along the sequence as K shifted multiply-adds
    in the working type (the JAX package's loop).  x: (B,S,C), w: (K,C)."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + pad[:, i:i + S, :] * w[i]
    return out + b


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, for every t: a
    doubling (Hillis-Steele) scan of the pairs (a, b) under (a1, b1) then
    (a2, b2) = (a1 a2, a2 b1 + b2), ceil(log2 S) steps on whole tensors
    (the JAX package's ``lax.associative_scan`` sums in another tree)."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _gate(p: RGLRU, x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu((x @ p.wgate).to(F32), approximate="tanh")


def _rglru_scan(p: RGLRU, x):
    """(branch output (B,S,d), pre-conv x @ wx (B,S,w), h (B,S,w) f32)."""
    gate = _gate(p, x)
    xi_raw = x @ p.wx
    xi = _conv1d(xi_raw, p.conv_w, p.conv_b)
    log_a, bseq = _lru_gates(p, xi)
    hs = linear_scan(torch.exp(log_a), bseq)
    y = (hs * gate).to(x.dtype)
    return y @ p.wo, xi_raw, hs


def rglru_seq(p: RGLRU, cfg, x):
    """Full-sequence recurrent branch. x: (B,S,D) -> (B,S,D)."""
    return _rglru_scan(p, x)[0]


def rglru_step(p: RGLRU, cfg, x, conv_state, h_state):
    """Single-token step. x: (B,1,D); conv_state: (B,K-1,w); h_state:
    (B,w) f32.  Returns (out (B,1,D), new conv_state, new h)."""
    gate = _gate(p, x[:, 0])
    xi_raw = x[:, 0] @ p.wx
    full = torch.cat([conv_state, xi_raw[:, None, :]], dim=1)
    xi = torch.einsum("bkc,kc->bc", full, p.conv_w) + p.conv_b
    log_a, b = _lru_gates(p, xi)
    h_new = torch.exp(log_a) * h_state + b
    y = (h_new * gate).to(x.dtype)
    return (y @ p.wo)[:, None, :], full[:, 1:], h_new


# --------------------------------------------------------------- blocks
class Block(nn.Module):
    """One block: ``ln1``, ``ln2``, ``mlp`` and ``rec`` (an RG-LRU) or
    ``attn`` (local MQA), as the JAX package's block dict."""

    def __init__(self, cfg, kind: str, key=None, *, device):
        super().__init__()
        drawn = key is not None
        k1, k2 = key.split() if drawn else (None, None)
        self.ln1 = L.init_rms_for(cfg, cfg.d_model, device)
        self.ln2 = L.init_rms_for(cfg, cfg.d_model, device)
        if kind == "rec":
            self.rec = RGLRU(cfg, k1, device=device)
        else:
            self.attn = L.init_gqa(k1, cfg) if drawn else L.GQA(cfg, device=device)
        self.mlp = L.init_mlp(k2, cfg) if drawn else L.MLP(cfg, device=device)


class Griffin(nn.Module):
    """The model's weights: ``embed``, ``blocks`` (heterogeneous, in
    ``cfg.layer_kinds()`` order) and ``final_norm``.  Drawn from
    ``key`` (an ``L.Key``: ``k_emb, k_blocks = split(key)``, block i from
    ``split(k_blocks, L)[i]``) when one is given, else left empty for
    ``interop.rglru_params`` to fill."""

    def __init__(self, cfg, key=None, *, device):
        super().__init__()
        device = resolve_device(device)
        k_emb, block_keys = L.split_stack(key, cfg.num_layers)
        self.embed = (L.init_embed(k_emb, cfg) if key is not None
                      else L.Embedding(cfg, device=device))
        self.blocks = nn.ModuleList(Block(cfg, kind, k, device=device)
                                    for kind, k in zip(cfg.layer_kinds(), block_keys))
        self.final_norm = L.init_rms_for(cfg, cfg.d_model, device)


def init(key, cfg, device="cuda") -> Griffin:
    """The JAX package's initial weights for ``key`` (an int read as
    ``PRNGKey(key)``, or a (2,) uint32 key); on "meta" the shapes and types
    alone (``layers.seeded``)."""
    dev = resolve_device(device)
    return Griffin(cfg, L.seeded(key, dev), device=dev)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _block_fwd(cfg, kind: str, x, bp: Block, positions):
    h = L.apply_norm(cfg, x, bp.ln1)
    if kind == "rec":
        x = x + rglru_seq(bp.rec, cfg, h)
    else:
        x = x + L.gqa_attend(bp.attn, cfg, h, positions, causal=True)
    h = L.apply_norm(cfg, x, bp.ln2)
    return ctx.constrain_tokens(x + L.mlp_apply(bp.mlp, cfg, h))


def _logits(params: Griffin, cfg, batch):
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    x = L.embed_tokens(params.embed, cfg, tokens)
    for bp, kind in zip(params.blocks, cfg.layer_kinds()):
        x = L.remat(cfg, _block_fwd, cfg, kind, x, bp, positions)
    x = L.apply_norm(cfg, x, params.final_norm)
    return L.lm_logits(params.embed, cfg, x)


forward = torch.no_grad()(_logits)


def loss(params: Griffin, cfg, batch):
    """(mean cross-entropy of the next-token ``labels``, {}), differentiable
    in the parameters (``layers.trainable``)."""
    logits = _logits(params, cfg, batch)
    return L.cross_entropy(logits, batch["labels"], batch.get("loss_mask")), {}


# --------------------------------------------------------------- serving
def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    a, h = cfg.attention, cfg.hybrid
    dt = L.param_dtype(cfg)
    dev = resolve_device(device)
    W = min(a.window, max_len)
    blocks = []
    for kind in cfg.layer_kinds():
        if kind == "rec":
            blocks.append({"conv": torch.zeros((batch, h.conv_width - 1, h.lru_width), dtype=dt,
                                               device=dev),
                           "h": torch.zeros((batch, h.lru_width), dtype=F32, device=dev)})
        else:
            shape = (batch, W, a.num_kv_heads, a.head_dim)
            blocks.append({"k": torch.zeros(shape, dtype=dt, device=dev),
                           "v": torch.zeros(shape, dtype=dt, device=dev)})
    return {"blocks": tuple(blocks), "pos": 0}


@torch.no_grad()
def prefill(params: Griffin, cfg, batch):
    """Processes the prompt: logits at the last position and the cache after
    it: each recurrent block's last K-1 pre-conv inputs (zeros in front of a
    shorter prompt) and final h, each attention block's last W = min(window,
    S) K/V arranged so that slot pos % W holds position pos."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    a = cfg.attention
    keep = cfg.hybrid.conv_width - 1
    positions = _positions(B, S, tokens.device)
    x = L.embed_tokens(params.embed, cfg, tokens)
    W = min(a.window, S)
    blocks = []
    for bp, kind in zip(params.blocks, cfg.layer_kinds()):
        h = L.apply_norm(cfg, x, bp.ln1)
        if kind == "rec":
            out, xi_raw, hs = _rglru_scan(bp.rec, h)
            x = x + out
            tail = xi_raw[:, S - min(S, keep):]
            pad = torch.zeros((B, keep - tail.shape[1], xi_raw.shape[-1]), dtype=xi_raw.dtype,
                              device=x.device)
            conv = torch.cat([pad, tail], dim=1)  # a DTensor under a mesh: not written in place
            blocks.append({"conv": conv, "h": hs[:, -1]})
        else:
            q, k, v = L.gqa_project_qkv(bp.attn, cfg, h)
            q = L.apply_rope(q, positions, a.rope_theta)
            k = L.apply_rope(k, positions, a.rope_theta)
            out = L.mha(q, k, v, causal=True, q_positions=positions, kv_positions=positions,
                        window=a.window)
            x = x + out.reshape(B, S, -1) @ bp.attn.wo
            kW, vW = k[:, S - W:], v[:, S - W:]
            if S >= W:  # slot (pos % W) holds position pos
                idx = (torch.arange(W, device=x.device) - S % W) % W
                kW, vW = kW[:, idx], vW[:, idx]
            blocks.append({"k": kW.contiguous(), "v": vW.contiguous()})
        h = L.apply_norm(cfg, x, bp.ln2)
        x = ctx.constrain_tokens(x + L.mlp_apply(bp.mlp, cfg, h))
    x = L.apply_norm(cfg, x, params.final_norm)
    logits = L.lm_logits(params.embed, cfg, x[:, -1:, :])
    return logits[:, 0], {"blocks": tuple(blocks), "pos": S}


@torch.no_grad()
def decode_step(params: Griffin, cfg, cache, tokens):
    """tokens: (B,) int -> (logits (B,V) fp32, cache).  The new states and
    K/V go into ``cache``'s tensors in place; the returned cache shares
    them, with ``pos`` advanced by one."""
    a = cfg.attention
    pos = cache["pos"]
    x = L.embed_tokens(params.embed, cfg, tokens[:, None])
    for bp, kind, c in zip(params.blocks, cfg.layer_kinds(), cache["blocks"]):
        h = L.apply_norm(cfg, x, bp.ln1)
        if kind == "rec":
            out, conv, hs = rglru_step(bp.rec, cfg, h, c["conv"], c["h"])
            c["conv"].copy_(conv)
            c["h"].copy_(hs)
        else:
            out, _, _ = L.gqa_decode(bp.attn, cfg, h, c["k"], c["v"], pos, window=a.window)
        x = x + out
        h = L.apply_norm(cfg, x, bp.ln2)
        x = ctx.constrain_tokens(x + L.mlp_apply(bp.mlp, cfg, h))
    x = L.apply_norm(cfg, x, params.final_norm)
    logits = L.lm_logits(params.embed, cfg, x)
    return logits[:, 0], {"blocks": cache["blocks"], "pos": pos + 1}
