"""Shared model building blocks in PyTorch.

Conventions (those of the JAX package, kept so that the same weights give
the same numbers):

* Matmul weights are stored as (in, out) in ``cfg.dtype`` (bf16) and applied
  as ``x @ w``; norms, softmax and RoPE run in f32 and cast back to the
  input's type; attention scores and logits accumulate in f32.
* The GQA block, the gated MLP and the embedding are ``nn.Module``s that
  hold their weights (no ``forward``); the plain functions beside them
  (``gqa_attend``, ``mlp_apply``, ...) take the module as ``p`` and do the
  arithmetic, under the names the JAX package gives them.
* Initialisation takes a ``jax.random`` key (``Key``: the key and the
  device its draws land on) and follows the JAX package's split tree, each
  weight drawn by ``util/prng.py`` (threefry2x32: numpy on the CPU, the
  ``threefry`` kernel on the card, straight into the parameter), so one key
  gives the JAX package's initial weights bit for bit on either device.
* Parameters are created with ``requires_grad=False`` (the serving paths
  never build a graph); ``trainable`` turns gradients on for training, and
  ``remat`` runs a layer under ``torch.utils.checkpoint`` where the JAX
  package's ``scan_layers`` takes ``jax.checkpoint``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch._dynamo  # noqa: F401  (see remat)
from torch import nn
from torch.utils import checkpoint

from repro_torch.distributed import ctx
from repro_torch.kernels import _mesh
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.util import prng, resolve_device

F32 = torch.float32


def param_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class Key(NamedTuple):
    """A ``jax.random`` key (a ``(2,)`` uint32 array) and the device its
    draws land on: what the inits pass down where the JAX package passes a
    key."""

    key: np.ndarray
    device: torch.device

    def split(self, n: int = 2) -> list:
        """``jax.random.split(key, n)``, each on this device."""
        return [Key(k, self.device) for k in prng.split(self.key, n)]

    def fold_in(self, data: int) -> "Key":
        return Key(prng.fold_in(self.key, data), self.device)


def dense_init(key: Key, shape, in_axis: int = -2, dtype=torch.bfloat16, *, out=None,
               times=None) -> torch.Tensor:
    """Truncated-normal fan-in init, as the JAX package's:
    ``(truncated_normal(key, -2, 2, shape) * (1 / sqrt(fan_in))).astype(dtype)``,
    into ``out`` (a parameter) when given; ``times`` multiplies the result
    in ``dtype`` (a ``conv_w``'s ``* 0.1``)."""
    std = np.float32(1.0 / math.sqrt(shape[in_axis]))
    return prng.truncated_normal(key.key, shape, std=std, dtype=dtype, times=times,
                                 device=key.device, out=out)


def seeded(key, device: torch.device) -> Optional[Key]:
    """The family inits' ``Key``: ``key`` an int (read as
    ``jax.random.PRNGKey(key)``) or a ``(2,)`` uint32 key.  None on "meta",
    where a family's ``init`` then builds its weights' shapes and types
    without drawing them (``registry.params_spec``)."""
    if device.type == "meta":
        return None
    return Key(prng.as_key(key), device)


def split_stack(key: Optional[Key], n: int):
    """A family init's ``k_emb, k_layers = split(key)`` and ``stack_init``'s
    ``split(k_layers, n)``: (the embedding's key, the n layers' keys), or
    (None, [None] * n) without a key.  ``stack_init`` vmaps the layer init
    over those keys, which draws what a loop over them draws."""
    if key is None:
        return None, [None] * n
    k_emb, k_layers = key.split()
    return k_emb, k_layers.split(n)


def draw_into(key: Key, module: nn.Module, names) -> None:
    """``dense_init`` each of ``module``'s weights ``names`` in place, the
    i-th from ``key.split(len(names))[i]`` (an init's ``jax.random.split``
    and one draw a key)."""
    for k, name in zip(key.split(len(names)), names):
        w = getattr(module, name)
        dense_init(k, tuple(w.shape), dtype=w.dtype, out=w.data)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def trainable(model: nn.Module) -> nn.Module:
    """Turn gradients on for every parameter of ``model``."""
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def remat(cfg, fn, *args):
    """``fn(*args)``, recomputed in the backward instead of keeping its
    activations when ``cfg.remat`` is set and a graph is being built (the
    JAX package's ``jax.checkpoint`` around each scanned layer).
    ``checkpoint`` imports ``torch._dynamo`` on its first call, and that
    import keeps the frames on the stack alive for the life of the
    process: a train step's gradients and activations, which no collection
    frees.  This module imports it first, with no step on the stack."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ----------------------------------------------------------------- RMSNorm
def rms_norm(x, w, eps: float, plus_one: bool = False):
    xf = x.to(F32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = w.to(F32)
    if plus_one:
        scale = scale + 1.0
    return (y * scale).to(x.dtype)


def init_rms_for(cfg, d: int, device) -> nn.Parameter:
    # gemma-style norms are stored as zeros and applied as (1 + w)
    fill = torch.zeros if cfg.gemma_scaling else torch.ones
    return _param(fill((d,), dtype=F32, device=device))


def apply_norm(cfg, x, w):
    return rms_norm(x, w, cfg.norm_eps, plus_one=cfg.gemma_scaling)


# -------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None):
    exponents = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=F32, device=device), exponents)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].to(F32) * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- attention
def mha(q, k, v, *, causal: bool, q_positions, kv_positions, kv_valid=None, window: int = 0):
    """Grouped-query attention.

    q: (B, S, H, hd); k/v: (B, T, K, hd_k/hd_v).  H must be a multiple of K.
    ``q_positions``/``kv_positions``: (B, S) / (B, T) absolute positions used
    for causal/window masking.  ``kv_valid``: optional (B, T) bool mask for
    cache slots beyond the current length.

    On the card, plain-causal full-length attention (no window, no
    ``kv_valid``, S == T, equal q and v head dims) goes to the
    ``flash_attention`` kernel, which takes positions to be 0..S-1, and so
    does it on "meta" (the dry run, where the kernel's wrapper gives the
    output's shape and runs nothing); everything else, and everything on
    the CPU, takes the einsum path below.  Under a mesh the kernel runs on
    each device's shard of DTensor operands (``flash_attention``), and so
    does the einsum path (``_mha_on_mesh``).
    """
    if ((q.is_cuda or q.is_meta) and causal and window == 0 and kv_valid is None
            and q.shape[1] == k.shape[1] and q.shape[-1] == v.shape[-1]):
        return flash_attention(q, k, v, causal=True)
    if ctx.get_mesh() is not None and _mesh.is_dtensor(q):
        return _mha_on_mesh(q, k, v, causal, q_positions, kv_positions, kv_valid, window)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd)
    # f32 products of the stored values: JAX's preferred_element_type=f32
    scores = torch.einsum("bskgh,btkh->bkgst", qg.to(F32), k.to(F32))
    scores = scores / math.sqrt(hd)
    mask = torch.ones((B, S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_positions[:, :, None] >= kv_positions[:, None, :]
    if window:
        mask &= q_positions[:, :, None] - kv_positions[:, None, :] < window
    if kv_valid is not None:
        mask &= kv_valid[:, None, :]
    scores = scores.masked_fill(~mask[:, None, None, :, :], torch.finfo(F32).min)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)
    return out.reshape(B, S, H, v.shape[-1])


def _mha_on_mesh(q, k, v, causal, q_positions, kv_positions, kv_valid, window):
    """The einsum attention on each device's shard (``local_map``): batch
    over the batch axes, heads over "model" where the KV heads divide it,
    else replicated; the key sequence whole (a decode cache laid out by
    ``cache_sharding`` is gathered on it).  With ``attn_seq`` on and heads
    that do not divide "model", q's sequence is split over it instead (the
    JAX package's rule), and K/V's gradients are then partial sums."""
    mesh = ctx.get_mesh()
    B, S, H, _ = q.shape
    q_spec, kv_spec, select = _mesh.head_layout(mesh, B, H, k.shape[2])
    grad = None
    if select or q_spec[2] is None:
        q_spec = kv_spec = (q_spec[0], None, None)
        if ctx.attn_seq_enabled() and ctx.spec_for(mesh, (S,), "model") == ("model",):
            q_spec, grad = (q_spec[0], "model", None), "partial"
    pos_q, pos_kv = q_spec[:2], (kv_spec[0], None)
    operands = [q, k, v, q_positions, kv_positions]
    specs = [q_spec, kv_spec, kv_spec, pos_q, pos_kv]
    if kv_valid is not None:
        operands.append(kv_valid)
        specs.append(pos_kv)
    operands = [t if _mesh.is_dtensor(t) else _mesh.replicated(t, mesh) for t in operands]

    def local(ql, kl, vl, qp, kp, valid=None):
        return mha(ql, kl, vl, causal=causal, q_positions=qp, kv_positions=kp, kv_valid=valid,
                   window=window)

    return _mesh.local_call(local, mesh, operands, specs,
                            [None, grad, grad] + [None] * (len(specs) - 3), [q_spec])


# ------------------------------------------------------------ GQA block
class GQA(nn.Module):
    """Grouped-query attention weights: wq (d, H*hd), wk/wv (d, K*hd),
    wo (H*hd, d); biases with ``qkv_bias``, per-head norms with
    ``qk_norm``."""

    def __init__(self, cfg, d_model: Optional[int] = None, *, device):
        super().__init__()
        device = resolve_device(device)
        a = cfg.attention
        d = d_model or cfg.d_model
        dt = param_dtype(cfg)
        qd, kvd = a.num_heads * a.head_dim, a.num_kv_heads * a.head_dim
        for name, shape in (("wq", (d, qd)), ("wk", (d, kvd)), ("wv", (d, kvd)), ("wo", (qd, d))):
            setattr(self, name, _param(torch.empty(shape, dtype=dt, device=device)))
        if a.qkv_bias:
            self.bq = _param(torch.zeros((qd,), dtype=dt, device=device))
            self.bk = _param(torch.zeros((kvd,), dtype=dt, device=device))
            self.bv = _param(torch.zeros((kvd,), dtype=dt, device=device))
        if a.qk_norm:
            self.q_norm = _param(torch.ones((a.head_dim,), dtype=F32, device=device))
            self.k_norm = _param(torch.ones((a.head_dim,), dtype=F32, device=device))


def init_gqa(key: Key, cfg, d_model: Optional[int] = None) -> GQA:
    p = GQA(cfg, d_model, device=key.device)
    draw_into(key, p, ("wq", "wk", "wv", "wo"))  # split(key, 4)
    return p


def split_heads(t, n: int, hd: int):
    """(B, S, n * hd) -> (B, S, n, hd).  Under a mesh, a projection whose n
    heads do not divide the model axis is gathered on its last dim first:
    DTensor splits a sharded dim only along whole shards."""
    if ctx.get_mesh() is not None and ctx.spec_for(ctx.get_mesh(), (n,), "model") == (None,):
        t = ctx.constrain(t, "batch", None, None)
    return t.reshape(t.shape[0], t.shape[1], n, hd)


def gqa_project_qkv(p: GQA, cfg, x):
    a = cfg.attention
    B, S, _ = x.shape
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if a.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = split_heads(q, a.num_heads, a.head_dim)
    k = split_heads(k, a.num_kv_heads, a.head_dim)
    v = split_heads(v, a.num_kv_heads, a.head_dim)
    if a.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return q, k, v


def gqa_attend(p: GQA, cfg, x, positions, *, causal=True, rope=True,
               kv_override=None, kv_positions=None, kv_valid=None):
    """Full (training/prefill) attention.  ``kv_override``: (k, v) for
    cross-attention."""
    a = cfg.attention
    q, k, v = gqa_project_qkv(p, cfg, x)
    if kv_override is not None:
        k, v = kv_override
    if rope and kv_override is None:
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)
    kv_pos = kv_positions if kv_positions is not None else positions
    out = mha(q, k, v, causal=causal, q_positions=positions, kv_positions=kv_pos,
              kv_valid=kv_valid, window=a.window if a.kind == "local" else 0)
    B, S = x.shape[:2]
    return out.reshape(B, S, -1) @ p.wo


def gqa_decode(p: GQA, cfg, x, cache_k, cache_v, pos: int, *, rope=True, window: int = 0):
    """One-token decode against a preallocated KV cache.

    x: (B, 1, d); cache_k/v: (B, T, K, hd); pos: the current length.  The
    new K/V are written into the cache in place (the JAX package returns
    updated copies from ``dynamic_update_slice``).  Returns
    (out (B,1,d), cache_k, cache_v).
    """
    a = cfg.attention
    B = x.shape[0]
    q, k, v = gqa_project_qkv(p, cfg, x)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if rope:
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)
    T = cache_k.shape[1]
    idx = torch.arange(T, dtype=torch.int32, device=x.device)[None, :]
    if window and T >= window:
        # cache is sized exactly to the window -> ring buffer indexing
        slot = pos % window
        # in place, where the JAX package's dynamic_update_slice makes a copy
        cache_k[:, slot] = k[:, 0]
        cache_v[:, slot] = v[:, 0]
        # ring buffer: slot i holds position pos-slot+i (i<=slot) else one
        # window earlier
        kv_positions = torch.where(idx <= slot, idx + (pos - slot), idx + (pos - slot) - T)
        kv_positions = kv_positions.expand(B, T)
        kv_valid = (kv_positions >= 0) & (kv_positions <= pos)
    else:
        # in place, where the JAX package's dynamic_update_slice makes a copy
        cache_k[:, pos] = k[:, 0]
        cache_v[:, pos] = v[:, 0]
        kv_positions = idx.expand(B, T)
        kv_valid = kv_positions <= pos
    out = mha(q, cache_k, cache_v, causal=False, q_positions=positions,
              kv_positions=kv_positions, kv_valid=kv_valid)
    return out.reshape(B, 1, -1) @ p.wo, cache_k, cache_v


# --------------------------------------------------------------- gated MLP
class MLP(nn.Module):
    """Gated MLP weights: wg, wi (d, f) and wo (f, d)."""

    def __init__(self, cfg, d_ff: Optional[int] = None, d_model: Optional[int] = None, *,
                 device):
        super().__init__()
        device = resolve_device(device)
        d = d_model or cfg.d_model
        f = d_ff or cfg.d_ff
        dt = param_dtype(cfg)
        self.wg = _param(torch.empty((d, f), dtype=dt, device=device))
        self.wi = _param(torch.empty((d, f), dtype=dt, device=device))
        self.wo = _param(torch.empty((f, d), dtype=dt, device=device))


def init_mlp(key: Key, cfg, d_ff: Optional[int] = None, d_model: Optional[int] = None) -> MLP:
    p = MLP(cfg, d_ff, d_model, device=key.device)
    draw_into(key, p, ("wg", "wi", "wo"))  # split(key, 3)
    return p


def mlp_apply(p: MLP, cfg, x):
    if cfg.act == "silu":
        gate = nn.functional.silu(x @ p.wg)
    else:  # jax.nn.gelu's default is the tanh approximation
        gate = nn.functional.gelu(x @ p.wg, approximate="tanh")
    return (gate * (x @ p.wi)) @ p.wo


# ------------------------------------------------------------- embeddings
class Embedding(nn.Module):
    """Token embedding (V, d) and, unless tied, the output head (d, V)."""

    def __init__(self, cfg, *, device):
        super().__init__()
        device = resolve_device(device)
        dt = param_dtype(cfg)
        self.embed = _param(torch.empty((cfg.vocab_size, cfg.d_model), dtype=dt, device=device))
        if not cfg.tie_embeddings:
            self.lm_head = _param(torch.empty((cfg.d_model, cfg.vocab_size), dtype=dt,
                                              device=device))


def init_embed(key: Key, cfg) -> Embedding:
    p = Embedding(cfg, device=key.device)
    k1, k2 = key.split()
    dense_init(k1, tuple(p.embed.shape), in_axis=-1, dtype=p.embed.dtype, out=p.embed.data)
    if not cfg.tie_embeddings:
        dense_init(k2, tuple(p.lm_head.shape), dtype=p.lm_head.dtype, out=p.lm_head.data)
    return p


def embed_tokens(p: Embedding, cfg, tokens):
    # a gather whose backward sums rows in a fixed order on the card
    # (indexing's backward accumulates with atomics)
    if ctx.get_mesh() is not None and _mesh.is_dtensor(p.embed):
        x = _embed_on_mesh(p.embed, tokens)
    else:
        x = nn.functional.embedding(tokens, p.embed)
    if cfg.gemma_scaling:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return ctx.constrain_tokens(x)


def _embed_on_mesh(table, tokens):
    """The vocab-parallel lookup (``local_map``): each "model" rank holds
    rows [r * V / tp, (r + 1) * V / tp) of the table (gathered on any other
    axis), looks up the tokens of its batch shard that fall there (zeros
    for the rest), and the partial rows are summed over "model" when the
    residual stream is laid out.  DTensor's own sharded embedding cannot
    take a gradient back into its masked partial layout."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import placements

    mesh = ctx.get_mesh()
    names = mesh.mesh_dim_names
    if "model" not in names or table.shape[0] % mesh["model"].size():
        return nn.functional.embedding(tokens, table)
    if not _mesh.is_dtensor(tokens):
        tokens = _mesh.replicated(tokens, mesh)
    tok = placements(ctx.spec_for(mesh, tokens.shape, "batch", *([None] * (tokens.dim() - 1))),
                     mesh)
    w = [Shard(0) if a == "model" else Replicate() for a in names]
    w_grad = [Shard(0) if a == "model" else (Partial() if t.is_shard() else Replicate())
              for a, t in zip(names, tok)]
    out = [Partial() if a == "model" else t for a, t in zip(names, tok)]

    def local(tl, wl):
        n = wl.shape[0]
        ids = tl.long() - mesh.get_local_rank("model") * n
        mine = (ids >= 0) & (ids < n)
        rows = nn.functional.embedding(ids.clamp(0, n - 1), wl)
        return rows * mine[..., None].to(rows.dtype)

    return local_map(local, out_placements=out, in_placements=(tok, w),
                     in_grad_placements=(tok, w_grad), device_mesh=mesh,
                     redistribute_inputs=True)(tokens, table)


def lm_logits(p: Embedding, cfg, x):
    """(B, S, d) -> (B, S, V) f32 logits, f32 products of the stored
    values (JAX's preferred_element_type=f32)."""
    w = p.embed.T if cfg.tie_embeddings else p.lm_head
    return ctx.constrain_logits(x.to(F32) @ w.to(F32))


def cross_entropy(logits, labels, mask=None):
    """logits (B,S,V), labels (B,S) int; mask optional (B,S).  The mean
    negative log-likelihood in f32 (over the mask's positions).  Under a
    mesh the vocab dim is gathered first: DTensor's gather along a sharded
    dim is not supported."""
    logits = ctx.constrain(logits.to(F32), "batch", None, None)
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[..., None].long())[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.to(F32)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
