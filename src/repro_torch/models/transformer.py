"""Dense decoder-only transformer (llama/qwen/deepseek-dense style).

The family API of the JAX package's ``models/transformer.py``:

    init(key, cfg, device)               -> Transformer (an nn.Module)
    forward(params, cfg, batch)          -> logits (B,S,V) fp32
    loss(params, cfg, batch)             -> (scalar, aux)
    init_cache(cfg, batch, max_len)      -> cache dict
    prefill(params, cfg, batch)          -> (last_logits, cache)
    decode_step(params, cfg, cache, tok) -> (logits, cache)

The JAX package stacks the layers' params on a leading L dim and scans
them; here they are an ``nn.ModuleList`` walked in a loop.  A cache is
{"k", "v": (L, B, T, K, hd) tensors, "pos": int}; ``decode_step`` writes
into its tensors in place.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed import ctx
from repro_torch.models import layers as L
from repro_torch.util import resolve_device


class Layer(nn.Module):
    def __init__(self, cfg, key=None, *, device):
        super().__init__()
        device = resolve_device(device)
        k1, k2 = key.split() if key is not None else (None, None)
        self.ln1 = L.init_rms_for(cfg, cfg.d_model, device)
        self.attn = L.init_gqa(k1, cfg) if key is not None else L.GQA(cfg, device=device)
        self.ln2 = L.init_rms_for(cfg, cfg.d_model, device)
        self.mlp = L.init_mlp(k2, cfg) if key is not None else L.MLP(cfg, device=device)


class Transformer(nn.Module):
    """The model's weights: ``embed`` (token embedding and head), ``layers``
    and ``final_norm``.  Drawn from ``key`` (an ``L.Key``) with the JAX
    package's split tree when one is given, else left empty for
    ``interop.transformer_params`` to fill."""

    def __init__(self, cfg, key=None, *, device):
        super().__init__()
        device = resolve_device(device)
        k_emb, layer_keys = L.split_stack(key, cfg.num_layers)
        self.embed = (L.init_embed(k_emb, cfg) if key is not None
                      else L.Embedding(cfg, device=device))
        self.layers = nn.ModuleList(Layer(cfg, k, device=device) for k in layer_keys)
        self.final_norm = L.init_rms_for(cfg, cfg.d_model, device)


def init(key, cfg, device="cuda") -> Transformer:
    """The JAX package's initial weights for ``key`` (an int read as
    ``PRNGKey(key)``, or a (2,) uint32 key); on "meta" the shapes and types
    alone (``layers.seeded``)."""
    dev = resolve_device(device)
    return Transformer(cfg, L.seeded(key, dev), device=dev)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _layer_fwd(cfg, x, lp: Layer, positions):
    h = L.apply_norm(cfg, x, lp.ln1)
    x = ctx.constrain_mid(x + L.gqa_attend(lp.attn, cfg, h, positions, causal=True))
    h = L.apply_norm(cfg, x, lp.ln2)
    return ctx.constrain_tokens(x + L.mlp_apply(lp.mlp, cfg, h))


def backbone(params: Transformer, cfg, x, positions):
    """x: (B,S,d) embeddings -> (B,S,d) final-normed activations; each
    layer recomputed in the backward under ``cfg.remat``."""
    for lp in params.layers:
        x = L.remat(cfg, _layer_fwd, cfg, x, lp, positions)
    return L.apply_norm(cfg, x, params.final_norm)


def _logits(params: Transformer, cfg, batch):
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.embed_tokens(params.embed, cfg, tokens)
    x = backbone(params, cfg, x, _positions(B, S, tokens.device))
    return L.lm_logits(params.embed, cfg, x)


forward = torch.no_grad()(_logits)


def loss(params: Transformer, cfg, batch):
    """(mean cross-entropy of the next-token ``labels``, {}), differentiable
    in the parameters (``layers.trainable``)."""
    logits = _logits(params, cfg, batch)
    return L.cross_entropy(logits, batch["labels"], batch.get("loss_mask")), {}


# -------------------------------------------------------------- serving
def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    a = cfg.attention
    window = a.window if a.kind == "local" else 0
    T = min(max_len, window) if window else max_len
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, T, a.num_kv_heads, a.head_dim)
    dt = L.param_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev), "pos": 0}


@torch.no_grad()
def prefill(params: Transformer, cfg, batch):
    """Processes the full prompt, returns logits at the last position and a
    populated cache sized to the prompt (caller may re-pad)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.embed_tokens(params.embed, cfg, tokens)
    return prefill_embedded(params, cfg, x, _positions(B, S, tokens.device))


@torch.no_grad()
def prefill_embedded(params: Transformer, cfg, x, positions):
    """``prefill`` from (B, S, d) input embeddings at ``positions``."""
    B, S = x.shape[:2]
    a = cfg.attention
    window = a.window if a.kind == "local" else 0
    ks, vs = [], []
    for lp in params.layers:
        hn = L.apply_norm(cfg, x, lp.ln1)
        q, k, v = L.gqa_project_qkv(lp.attn, cfg, hn)
        q = L.apply_rope(q, positions, a.rope_theta)
        k = L.apply_rope(k, positions, a.rope_theta)
        out = L.mha(q, k, v, causal=True, q_positions=positions, kv_positions=positions,
                    window=window)
        x = x + out.reshape(B, S, -1) @ lp.attn.wo
        hn = L.apply_norm(cfg, x, lp.ln2)
        x = ctx.constrain_tokens(x + L.mlp_apply(lp.mlp, cfg, hn))
        ks.append(k)
        vs.append(v)
    x = L.apply_norm(cfg, x, params.final_norm)
    logits = L.lm_logits(params.embed, cfg, x[:, -1:, :])
    cache = {"k": torch.stack(ks), "v": torch.stack(vs), "pos": S}
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(params: Transformer, cfg, cache, tokens):
    """tokens: (B,) int -> (logits (B,V) fp32, cache).  The new K/V go into
    ``cache``'s tensors in place; the returned cache shares them, with
    ``pos`` advanced by one."""
    a = cfg.attention
    x = L.embed_tokens(params.embed, cfg, tokens[:, None])
    pos = cache["pos"]
    window = a.window if a.kind == "local" else 0
    for i, lp in enumerate(params.layers):
        hn = L.apply_norm(cfg, x, lp.ln1)
        out, _, _ = L.gqa_decode(lp.attn, cfg, hn, cache["k"][i], cache["v"][i], pos,
                                 window=window)
        x = x + out
        hn = L.apply_norm(cfg, x, lp.ln2)
        x = ctx.constrain_tokens(x + L.mlp_apply(lp.mlp, cfg, hn))
    x = L.apply_norm(cfg, x, params.final_norm)
    logits = L.lm_logits(params.embed, cfg, x)
    return logits[:, 0], {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
