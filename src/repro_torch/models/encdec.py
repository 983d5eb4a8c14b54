"""Encoder-decoder family (seamless-m4t-medium backbone), as the JAX
package's ``models/encdec.py``.

The family API:

    enc_len_for(cfg, seq_len)            -> encoder length
    init(key, cfg, device)               -> EncDec (an nn.Module)
    encode(params, cfg, frames)          -> memory (B,E,d)
    forward(params, cfg, batch)          -> logits (B,S,V) fp32
    loss(params, cfg, batch)             -> (scalar, aux)
    init_cache(cfg, batch, max_len)      -> cache dict
    prefill(params, cfg, batch)          -> (last_logits, cache)
    decode_step(params, cfg, cache, tok) -> (logits, cache)

The audio frontend is a stub: a batch carries precomputed frame embeddings
``frames`` (B, E, d_model), E = ``enc_len_for(cfg, S)``.  Encoder layers
attend bidirectionally, decoder layers causally to themselves and then to
the encoder's memory; RoPE on self-attention only.  The decoder's causal
self-attention goes through ``layers.mha``, which sends it to the
``flash_attention`` kernel on the card (its autograd Function under
``loss``); the encoder's attention and the cross-attention are not causal
and take the einsum path, as in the JAX package.  The JAX package stacks
each side's layers on a leading dim (``enc_layers``, ``dec_layers``); here
they are two ``nn.ModuleList``s.  A cache is {"k", "v": (L, B, T, K, hd),
"xk", "xv": (L, B, E, K, hd) (the memory's cross K/V), "pos": int};
``decode_step`` writes the new K/V into it in place.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed import ctx
from repro_torch.models import layers as L
from repro_torch.util import resolve_device


def enc_len_for(cfg, seq_len: int) -> int:
    return max(1, seq_len // cfg.encoder.frame_ratio)


class EncLayer(nn.Module):
    def __init__(self, cfg, key=None, *, device):
        super().__init__()
        drawn = key is not None
        k1, k2 = key.split() if drawn else (None, None)
        self.ln1 = L.init_rms_for(cfg, cfg.d_model, device)
        self.attn = L.init_gqa(k1, cfg) if drawn else L.GQA(cfg, device=device)
        self.ln2 = L.init_rms_for(cfg, cfg.d_model, device)
        self.mlp = L.init_mlp(k2, cfg) if drawn else L.MLP(cfg, device=device)


class DecLayer(nn.Module):
    def __init__(self, cfg, key=None, *, device):
        super().__init__()
        drawn = key is not None
        k1, k2, k3 = key.split(3) if drawn else (None, None, None)
        self.ln1 = L.init_rms_for(cfg, cfg.d_model, device)
        self.self_attn = L.init_gqa(k1, cfg) if drawn else L.GQA(cfg, device=device)
        self.ln_x = L.init_rms_for(cfg, cfg.d_model, device)
        self.cross_attn = L.init_gqa(k2, cfg) if drawn else L.GQA(cfg, device=device)
        self.ln2 = L.init_rms_for(cfg, cfg.d_model, device)
        self.mlp = L.init_mlp(k3, cfg) if drawn else L.MLP(cfg, device=device)


class EncDec(nn.Module):
    """The model's weights: ``embed`` (token embedding and head),
    ``enc_layers``, ``dec_layers``, ``enc_norm`` and ``final_norm``.
    Drawn from ``key`` (an ``L.Key``: ``k_emb, k_enc, k_dec = split(key,
    3)``, each stack's layers from ``split(k, n)``) when one is given, else
    left empty for ``interop.encdec_params`` to fill."""

    def __init__(self, cfg, key=None, *, device):
        super().__init__()
        device = resolve_device(device)
        n_enc, n_dec = cfg.encoder.num_layers, cfg.num_layers
        if key is not None:
            k_emb, k_enc, k_dec = key.split(3)
            enc_keys, dec_keys = k_enc.split(n_enc), k_dec.split(n_dec)
        else:
            enc_keys, dec_keys = [None] * n_enc, [None] * n_dec
        self.embed = (L.init_embed(k_emb, cfg) if key is not None
                      else L.Embedding(cfg, device=device))
        self.enc_layers = nn.ModuleList(EncLayer(cfg, k, device=device) for k in enc_keys)
        self.dec_layers = nn.ModuleList(DecLayer(cfg, k, device=device) for k in dec_keys)
        self.enc_norm = L.init_rms_for(cfg, cfg.d_model, device)
        self.final_norm = L.init_rms_for(cfg, cfg.d_model, device)


def init(key, cfg, device="cuda") -> EncDec:
    """The JAX package's initial weights for ``key`` (an int read as
    ``PRNGKey(key)``, or a (2,) uint32 key); on "meta" the shapes and types
    alone (``layers.seeded``)."""
    dev = resolve_device(device)
    return EncDec(cfg, L.seeded(key, dev), device=dev)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _enc_layer(cfg, h, lp: EncLayer, positions):
    hn = L.apply_norm(cfg, h, lp.ln1)
    h = h + L.gqa_attend(lp.attn, cfg, hn, positions, causal=False)
    hn = L.apply_norm(cfg, h, lp.ln2)
    return ctx.constrain_tokens(h + L.mlp_apply(lp.mlp, cfg, hn))


def encode(params: EncDec, cfg, frames):
    """frames: (B, E, d_model) precomputed frame embeddings -> the encoder's
    normed memory (B, E, d_model) in the param type."""
    B, E, _ = frames.shape
    positions = _positions(B, E, frames.device)
    x = frames.to(L.param_dtype(cfg))
    for lp in params.enc_layers:
        x = L.remat(cfg, _enc_layer, cfg, x, lp, positions)
    return L.apply_norm(cfg, x, params.enc_norm)


def _cross_kv(p: L.GQA, cfg, memory):
    """The encoder memory projected to one layer's cross K/V."""
    a = cfg.attention
    k, v = memory @ p.wk, memory @ p.wv
    if a.qkv_bias:
        k, v = k + p.bk, v + p.bv
    k = L.split_heads(k, a.num_kv_heads, a.head_dim)
    v = L.split_heads(v, a.num_kv_heads, a.head_dim)
    return k, v


def _cross(lp: DecLayer, cfg, hn, positions, kv, mem_positions):
    return L.gqa_attend(lp.cross_attn, cfg, hn, positions, causal=False, rope=False,
                        kv_override=kv, kv_positions=mem_positions)


def _dec_layer(cfg, x, lp: DecLayer, positions, memory, mem_positions):
    h = L.apply_norm(cfg, x, lp.ln1)
    x = x + L.gqa_attend(lp.self_attn, cfg, h, positions, causal=True)
    h = L.apply_norm(cfg, x, lp.ln_x)
    x = x + _cross(lp, cfg, h, positions, _cross_kv(lp.cross_attn, cfg, memory), mem_positions)
    h = L.apply_norm(cfg, x, lp.ln2)
    return ctx.constrain_tokens(x + L.mlp_apply(lp.mlp, cfg, h))


def _logits(params: EncDec, cfg, batch):
    tokens = batch["tokens"]
    B, S = tokens.shape
    memory = encode(params, cfg, batch["frames"])
    positions = _positions(B, S, tokens.device)
    mem_positions = _positions(B, memory.shape[1], tokens.device)
    x = L.embed_tokens(params.embed, cfg, tokens)
    for lp in params.dec_layers:
        x = L.remat(cfg, _dec_layer, cfg, x, lp, positions, memory, mem_positions)
    x = L.apply_norm(cfg, x, params.final_norm)
    return L.lm_logits(params.embed, cfg, x)


forward = torch.no_grad()(_logits)


def loss(params: EncDec, cfg, batch):
    """(mean cross-entropy of the next-token ``labels``, {}), differentiable
    in the parameters (``layers.trainable``); each layer of both stacks
    recomputed in the backward under ``cfg.remat``."""
    logits = _logits(params, cfg, batch)
    return L.cross_entropy(logits, batch["labels"], batch.get("loss_mask")), {}


# --------------------------------------------------------------- serving
def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    a = cfg.attention
    dt = L.param_dtype(cfg)
    dev = resolve_device(device)
    E = enc_len_for(cfg, max_len)
    Ld = cfg.num_layers

    def zeros(T):
        return torch.zeros((Ld, batch, T, a.num_kv_heads, a.head_dim), dtype=dt, device=dev)

    return {"k": zeros(max_len), "v": zeros(max_len), "xk": zeros(E), "xv": zeros(E), "pos": 0}


@torch.no_grad()
def prefill(params: EncDec, cfg, batch):
    """Encodes the frames and runs the decoder over the prompt: logits at
    the last position and a cache sized to the prompt (the caller may
    re-pad ``k`` / ``v``) holding each layer's self K/V and cross K/V."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    a = cfg.attention
    memory = encode(params, cfg, batch["frames"])
    positions = _positions(B, S, tokens.device)
    mem_positions = _positions(B, memory.shape[1], tokens.device)
    x = L.embed_tokens(params.embed, cfg, tokens)
    ks, vs, xks, xvs = [], [], [], []
    for lp in params.dec_layers:
        hn = L.apply_norm(cfg, x, lp.ln1)
        q, k, v = L.gqa_project_qkv(lp.self_attn, cfg, hn)
        q = L.apply_rope(q, positions, a.rope_theta)
        k = L.apply_rope(k, positions, a.rope_theta)
        out = L.mha(q, k, v, causal=True, q_positions=positions, kv_positions=positions)
        x = x + out.reshape(B, S, -1) @ lp.self_attn.wo
        hn = L.apply_norm(cfg, x, lp.ln_x)
        xk, xv = _cross_kv(lp.cross_attn, cfg, memory)
        x = x + _cross(lp, cfg, hn, positions, (xk, xv), mem_positions)
        hn = L.apply_norm(cfg, x, lp.ln2)
        x = ctx.constrain_tokens(x + L.mlp_apply(lp.mlp, cfg, hn))
        ks.append(k)
        vs.append(v)
        xks.append(xk)
        xvs.append(xv)
    x = L.apply_norm(cfg, x, params.final_norm)
    logits = L.lm_logits(params.embed, cfg, x[:, -1:, :])
    cache = {"k": torch.stack(ks), "v": torch.stack(vs), "xk": torch.stack(xks),
             "xv": torch.stack(xvs), "pos": S}
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(params: EncDec, cfg, cache, tokens):
    """tokens: (B,) int -> (logits (B,V) fp32, cache).  The new self K/V go
    into ``cache``'s tensors in place; the returned cache shares them, with
    ``pos`` advanced by one."""
    B = tokens.shape[0]
    pos = cache["pos"]
    x = L.embed_tokens(params.embed, cfg, tokens[:, None])
    mem_positions = _positions(B, cache["xk"].shape[2], tokens.device)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=tokens.device)
    for i, lp in enumerate(params.dec_layers):
        hn = L.apply_norm(cfg, x, lp.ln1)
        out, _, _ = L.gqa_decode(lp.self_attn, cfg, hn, cache["k"][i], cache["v"][i], pos)
        x = x + out
        hn = L.apply_norm(cfg, x, lp.ln_x)
        x = x + _cross(lp, cfg, hn, positions, (cache["xk"][i], cache["xv"][i]), mem_positions)
        hn = L.apply_norm(cfg, x, lp.ln2)
        x = ctx.constrain_tokens(x + L.mlp_apply(lp.mlp, cfg, hn))
    x = L.apply_norm(cfg, x, params.final_norm)
    logits = L.lm_logits(params.embed, cfg, x)
    return logits[:, 0], {"k": cache["k"], "v": cache["v"], "xk": cache["xk"],
                          "xv": cache["xv"], "pos": pos + 1}
