"""Mixture-of-Experts decoder family (qwen3-moe, deepseek-v2-lite): the
family API of the JAX package's ``models/moe.py``:

    init(key, cfg, device)               -> MoETransformer (an nn.Module)
    forward(params, cfg, batch)          -> logits (B,S,V) fp32
    backbone(params, cfg, x, positions)  -> (activations, aux loss)
    loss(params, cfg, batch)             -> (ce + aux, {"aux", "ce"})
    init_cache(cfg, batch, max_len)      -> cache dict
    prefill(params, cfg, batch)          -> (last_logits, cache)
    decode_step(params, cfg, cache, tok) -> (logits, cache)

Token dispatch is the argsort-capacity scheme: assignments sorted by expert
(a stable sort, as ``jnp.argsort``), each expert runs a fixed (C, D) slice
of an (E, C, D) buffer, assignments past an expert's capacity go to a trash
row and contribute nothing.  The router's top-k is a stable descending sort
cut to k, which breaks ties toward the lower expert as ``lax.top_k`` does.
The combine gathers each token's k contributions and adds them in the
reference's order (ascending expert) one at a time, so a token's sum does
not depend on the card's scheduling: no atomics.

qwen3 layers use GQA (qk-norm) and reach ``flash_attention`` through
``layers.mha``; deepseek-v2-lite layers use MLA (``models/mla.py``, the
einsum path), two shared experts beside 64 routed ones, and a dense first
layer.

Under a mesh (``distributed/ctx.py``) the dispatch runs on each device's
tokens through ``local_map``: ``moe_apply_ep`` (with ``ep`` on) keeps each
"model" rank's E / tp experts where they lie and sums the partial outputs
with one all-reduce over "model", as the JAX package's ``shard_map`` does;
``moe_apply`` gathers the experts and routes each batch shard's tokens.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.distributed import ctx
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.util import resolve_device


# ------------------------------------------------------------ expert layer
class Experts(nn.Module):
    """Router (d, E) f32; per-expert gated MLPs wg, wi (E, d, f) and wo
    (E, f, d); ``shared`` experts as one MLP of num_shared * f when the
    config has them."""

    def __init__(self, cfg, *, device):
        super().__init__()
        device = resolve_device(device)
        m, d, dt = cfg.moe, cfg.d_model, L.param_dtype(cfg)
        E, f = m.num_experts, m.expert_ff
        self.router = L._param(torch.empty((d, E), dtype=L.F32, device=device))
        self.wg = L._param(torch.empty((E, d, f), dtype=dt, device=device))
        self.wi = L._param(torch.empty((E, d, f), dtype=dt, device=device))
        self.wo = L._param(torch.empty((E, f, d), dtype=dt, device=device))
        if m.num_shared:
            self.shared = L.MLP(cfg, d_ff=m.num_shared * f, device=device)


def init_experts(key: L.Key, cfg) -> Experts:
    """split(key, 5): the f32 router (d, E), the experts' (E, d, f) / (E,
    f, d) weights (fan-in on axis -2) and the shared MLP."""
    p = Experts(cfg, device=key.device)
    ks = key.split(5)
    for k, w in zip(ks, (p.router, p.wg, p.wi, p.wo)):
        L.dense_init(k, tuple(w.shape), dtype=w.dtype, out=w.data)
    if cfg.moe.num_shared:
        p.shared = L.init_mlp(ks[4], cfg, d_ff=cfg.moe.num_shared * cfg.moe.expert_ff)
    return p


def moe_capacity(cfg, n_tokens: int) -> int:
    m = cfg.moe
    c = int(m.top_k * n_tokens / m.num_experts * m.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8


def route(p: Experts, cfg, xt):
    """xt (N, D) -> (probs (N, E), top_p (N, k) renormalized, top_e (N, k)):
    f32 router products of the stored values; top-k by a stable descending
    sort (ties to the lower expert, as ``lax.top_k``)."""
    logits = xt.to(L.F32) @ p.router
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    return probs, top_p / top_p.sum(dim=-1, keepdim=True), top_e


def _aux(cfg, probs, top_e, n_tokens: int):
    """The load-balancing aux loss (Switch-style)."""
    m = cfg.moe
    flat = top_e.reshape(-1)
    # a count an expert (exact in f32), of a static shape that "meta" can trace
    counts = torch.zeros(m.num_experts, dtype=L.F32, device=flat.device).scatter_add_(
        0, flat, torch.ones(flat.shape, dtype=L.F32, device=flat.device))
    density = counts / n_tokens
    return torch.sum(density * probs.mean(dim=0)) * m.num_experts * m.router_aux_weight


def dispatch(top_e, cfg, n_tokens: int):
    """The argsort-capacity slots: (C, sort_idx, dest).  ``sort_idx`` orders
    the N*k assignments by expert (stable); ``dest`` is each sorted
    assignment's row of the (E*C + 1, D) buffer, E*C (the trash row) past
    its expert's capacity."""
    m = cfg.moe
    E = m.num_experts
    C = moe_capacity(cfg, n_tokens)
    flat_e = top_e.reshape(-1)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    group_start = torch.searchsorted(sorted_e, torch.arange(E, device=top_e.device))
    rank = torch.arange(flat_e.numel(), device=top_e.device) - group_start[sorted_e]
    dest = torch.where(rank < C, sorted_e * C + rank, E * C)
    return C, sort_idx, dest


def _act(cfg, x):
    if cfg.act == "silu":
        return nn.functional.silu(x)
    return nn.functional.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _experts_and_combine(cfg, xt, p, sort_idx, dest, top_p, top_e, n_slots: int, C: int):
    """Run the (n_slots, C, D) buffer's gated MLPs and combine: each token's
    k weighted expert rows, added in ascending expert order (the order the
    reference's scatter-add meets them).  ``dest`` is a sorted
    assignment's buffer row, n_slots * C (the trash row, which outputs
    zeros) for one that is dropped or not this buffer's."""
    N, D = xt.shape
    K = top_e.shape[1]
    buf = torch.zeros((n_slots * C + 1, D), dtype=xt.dtype, device=xt.device)
    buf[dest] = xt[sort_idx // K]  # only the trash row takes several writes
    buf = buf[:-1].reshape(n_slots, C, D)
    h = _act(cfg, torch.bmm(buf, p.wg)) * torch.bmm(buf, p.wi)
    eout = torch.bmm(h, p.wo).reshape(n_slots * C, D)
    eout = torch.cat([eout, eout.new_zeros((1, D))])
    slot = torch.empty_like(dest)
    slot[sort_idx] = dest  # each assignment's buffer row, in (token, k) order
    order = torch.argsort(top_e, dim=1)
    slot = slot.reshape(N, K).gather(1, order)
    weight = top_p.gather(1, order).to(eout.dtype)
    out = torch.zeros((N, D), dtype=xt.dtype, device=xt.device)
    for j in range(K):
        out = out + eout[slot[:, j]] * weight[:, j, None]
    return out


def _routed(cfg, x, p):
    """The routed experts of ``moe_apply`` on one device: (out, aux).  ``p``
    holds ``router``, ``wg``, ``wi`` and ``wo``."""
    B, S, D = x.shape
    N = B * S
    xt = x.reshape(N, D)
    probs, top_p, top_e = route(p, cfg, xt)
    aux = _aux(cfg, probs, top_e, N)
    C, sort_idx, dest = dispatch(top_e, cfg, N)
    out = _experts_and_combine(cfg, xt, p, sort_idx, dest, top_p, top_e, cfg.moe.num_experts, C)
    return out.reshape(B, S, D), aux


def _routed_ep(cfg, x, p, rank: int):
    """The routed experts of ``moe_apply_ep`` on "model" rank ``rank``,
    which holds experts [rank * e_local, (rank + 1) * e_local): every token
    is routed, the assignments to the local experts are kept (the others
    go to the trash slot e_local), each local expert takes up to C of them
    in token order, and the partial output and the aux come back."""
    B, S, D = x.shape
    N, K = B * S, cfg.moe.top_k
    e_local = p.wg.shape[0]
    xt = x.reshape(N, D)
    probs, top_p, top_e = route(p, cfg, xt)
    aux = _aux(cfg, probs, top_e, N)
    flat_e = top_e.reshape(-1)
    mine = (flat_e // e_local) == rank
    local_e = torch.where(mine, flat_e - rank * e_local, e_local)
    C = moe_capacity(cfg, N)
    sort_idx = torch.argsort(local_e, stable=True)
    sorted_e = local_e[sort_idx]
    group_start = torch.searchsorted(sorted_e, torch.arange(e_local, device=x.device))
    rank_in = (torch.arange(N * K, device=x.device)
               - group_start[torch.clamp_max(sorted_e, e_local - 1)])
    valid = (sorted_e < e_local) & (rank_in < C)
    dest = torch.where(valid, sorted_e * C + rank_in, e_local * C)
    out = _experts_and_combine(cfg, xt, p, sort_idx, dest, top_p, top_e, e_local, C)
    return out.reshape(B, S, D), aux


def moe_apply(p: Experts, cfg, x):
    """x: (B, S, D) -> (out, aux_loss).  On a DTensor under a mesh, each
    batch shard routes its own tokens (its capacity from its own count,
    where the JAX package's GSPMD routes the global batch) against the
    gathered experts, and the aux loss is the shards' mean."""
    if ctx.get_mesh() is not None and isinstance(x, DTensor):
        out, aux = _on_mesh(cfg, p, x, ep=False)
    else:
        out, aux = _routed(cfg, x, p)
    if cfg.moe.num_shared:
        out = out + L.mlp_apply(p.shared, cfg, x)
    return out, aux


def moe_apply_ep(p: Experts, cfg, x):
    """Expert-parallel MoE (the JAX package's ``shard_map`` version).

    Under TP the token activations are replicated across "model", so the
    dispatch needs no collective: through ``local_map`` each "model" rank
    routes all of its batch shard's tokens, keeps the assignments to its
    E / tp experts, runs them, and returns a partial output; one all-reduce
    over "model" sums the top-k contributions, and the aux loss is
    averaged (over every mesh axis: the shards' mean, where the JAX package
    declares each batch shard's own replicated).  Without a mesh, or when
    E does not divide the model axis, it is ``moe_apply``.  At tp 1 it
    equals ``moe_apply``: the same slots, the same order of sums."""
    mesh = ctx.get_mesh()
    E = cfg.moe.num_experts
    if mesh is None or "model" not in mesh.mesh_dim_names or E % mesh["model"].size():
        return moe_apply(p, cfg, x)
    out, aux = _on_mesh(cfg, p, x, ep=True)
    if cfg.moe.num_shared:
        out = out + L.mlp_apply(p.shared, cfg, x)
    return out, aux


def _on_mesh(cfg, p: Experts, x, *, ep: bool):
    """The routed experts through ``local_map``: x over the batch axes (a
    plain tensor is taken as replicated), the router replicated, the
    experts over "model" with ``ep`` (else replicated); the output's
    partial sums reduced over the mesh."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import placements
    from repro_torch.kernels import _mesh

    mesh = ctx.get_mesh()
    rep = [Replicate()] * mesh.ndim

    def dt(t):
        return t if isinstance(t, DTensor) else _mesh.replicated(t, mesh)

    x = dt(x)
    x_pl = placements(ctx.spec_for(mesh, x.shape, "batch", None, None), mesh)
    e_pl = [Shard(0) if a == "model" else Replicate() for a in mesh.mesh_dim_names] if ep else rep
    def local(xl, router, wg, wi, wo):
        lp = SimpleNamespace(router=router, wg=wg, wi=wi, wo=wo)
        if ep:
            return _routed_ep(cfg, xl, lp, mesh.get_local_rank("model"))
        return _routed(cfg, xl, lp)

    out_pl = ([Partial() if a == "model" else pl for a, pl in zip(mesh.mesh_dim_names, x_pl)]
              if ep else x_pl)
    out, aux = local_map(local, out_placements=(out_pl, [Partial("avg")] * mesh.ndim),
                         in_placements=(x_pl, rep, e_pl, e_pl, e_pl), device_mesh=mesh,
                         redistribute_inputs=True)(
        x, *(dt(w) for w in (p.router, p.wg, p.wi, p.wo)))
    # the one all-reduce over "model" (a no-op without ep)
    return out.redistribute(mesh, x_pl), aux.redistribute(mesh, rep)


def _moe_dispatch(p: Experts, cfg, x):
    if ctx.ep_enabled():
        return moe_apply_ep(p, cfg, x)
    return moe_apply(p, cfg, x)


# --------------------------------------------------------------- families
def _is_mla(cfg) -> bool:
    return cfg.attention.kind == "mla"


def _init_attn(key, cfg, device):
    if _is_mla(cfg):
        return MLA.init_mla(key, cfg) if key is not None else MLA.MLA(cfg, device=device)
    return L.init_gqa(key, cfg) if key is not None else L.GQA(cfg, device=device)


class MoELayer(nn.Module):
    def __init__(self, cfg, key=None, *, device):
        super().__init__()
        device = resolve_device(device)
        k1, k2 = key.split() if key is not None else (None, None)
        self.ln1 = L.init_rms_for(cfg, cfg.d_model, device)
        self.attn = _init_attn(k1, cfg, device)
        self.ln2 = L.init_rms_for(cfg, cfg.d_model, device)
        self.experts = init_experts(k2, cfg) if key is not None else Experts(cfg, device=device)


class DenseLayer(nn.Module):
    """A leading dense layer (deepseek-v2-lite's layer 0): its MLP is
    ``dense_ff`` wide."""

    def __init__(self, cfg, key=None, *, device):
        super().__init__()
        device = resolve_device(device)
        ff = cfg.moe.dense_ff
        k1, k2 = key.split() if key is not None else (None, None)
        self.ln1 = L.init_rms_for(cfg, cfg.d_model, device)
        self.attn = _init_attn(k1, cfg, device)
        self.ln2 = L.init_rms_for(cfg, cfg.d_model, device)
        self.mlp = (L.init_mlp(k2, cfg, d_ff=ff) if key is not None
                    else L.MLP(cfg, d_ff=ff, device=device))


def init_moe_layer(key: L.Key, cfg) -> MoELayer:
    return MoELayer(cfg, key, device=key.device)


def init_dense_layer(key: L.Key, cfg) -> DenseLayer:
    return DenseLayer(cfg, key, device=key.device)


class MoETransformer(nn.Module):
    """The model's weights: ``embed``, ``dense_layers`` (the first
    ``moe.first_dense``), ``layers`` (the MoE layers) and ``final_norm``.
    Drawn from ``key`` (``k_emb, k_dense, k_layers = split(key, 3)``, each
    stack's layers from ``split(k, n)``) when one is given, else left empty
    for ``interop.moe_params`` to fill."""

    def __init__(self, cfg, key=None, *, device):
        super().__init__()
        device = resolve_device(device)
        n_dense, n_moe = cfg.moe.first_dense, cfg.num_layers - cfg.moe.first_dense
        if key is not None:
            k_emb, k_dense, k_layers = key.split(3)
            dense_keys, moe_keys = k_dense.split(n_dense), k_layers.split(n_moe)
        else:
            dense_keys, moe_keys = [None] * n_dense, [None] * n_moe
        self.embed = (L.init_embed(k_emb, cfg) if key is not None
                      else L.Embedding(cfg, device=device))
        self.dense_layers = nn.ModuleList(DenseLayer(cfg, k, device=device) for k in dense_keys)
        self.layers = nn.ModuleList(MoELayer(cfg, k, device=device) for k in moe_keys)
        self.final_norm = L.init_rms_for(cfg, cfg.d_model, device)


def init(key, cfg, device="cuda") -> MoETransformer:
    """The JAX package's initial weights for ``key`` (an int read as
    ``PRNGKey(key)``, or a (2,) uint32 key); on "meta" the shapes and types
    alone (``layers.seeded``)."""
    dev = resolve_device(device)
    return MoETransformer(cfg, L.seeded(key, dev), device=dev)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _attend(lp, cfg, h, positions):
    if _is_mla(cfg):
        return MLA.mla_attend(lp.attn, cfg, h, positions)
    return L.gqa_attend(lp.attn, cfg, h, positions, causal=True)


def _dense_layer(cfg, x, lp, positions):
    x = x + _attend(lp, cfg, L.apply_norm(cfg, x, lp.ln1), positions)
    return ctx.constrain_tokens(x + L.mlp_apply(lp.mlp, cfg, L.apply_norm(cfg, x, lp.ln2)))


def _moe_layer(cfg, x, lp, positions):
    x = x + _attend(lp, cfg, L.apply_norm(cfg, x, lp.ln1), positions)
    mo, aux = _moe_dispatch(lp.experts, cfg, L.apply_norm(cfg, x, lp.ln2))
    return ctx.constrain_tokens(x + mo), aux


def backbone(params: MoETransformer, cfg, x, positions):
    """x: (B,S,d) embeddings -> ((B,S,d) final-normed activations, the
    summed router aux loss); each layer recomputed in the backward under
    ``cfg.remat``."""
    aux_total = torch.zeros((), dtype=L.F32, device=x.device)
    for lp in params.dense_layers:
        x = L.remat(cfg, _dense_layer, cfg, x, lp, positions)
    for lp in params.layers:
        x, aux = L.remat(cfg, _moe_layer, cfg, x, lp, positions)
        aux_total = aux_total + aux
    return L.apply_norm(cfg, x, params.final_norm), aux_total


@torch.no_grad()
def forward(params: MoETransformer, cfg, batch):
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.embed_tokens(params.embed, cfg, tokens)
    x, _aux = backbone(params, cfg, x, _positions(B, S, tokens.device))
    return L.lm_logits(params.embed, cfg, x)


def loss(params: MoETransformer, cfg, batch):
    """(cross-entropy + the router aux loss, {"aux", "ce"})."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.embed_tokens(params.embed, cfg, tokens)
    x, aux = backbone(params, cfg, x, _positions(B, S, tokens.device))
    logits = L.lm_logits(params.embed, cfg, x)
    ce = L.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return ce + aux, {"aux": aux, "ce": ce}


# --------------------------------------------------------------- serving
def _cache_keys(cfg):
    return ("ckv", "krope") if _is_mla(cfg) else ("k", "v")


def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """{"k", "v": (L_moe, B, T, K, hd)} (GQA) or {"ckv": (L_moe, B, T, rank),
    "krope": (L_moe, B, T, rope)} (MLA), the same under "dense_" for the
    leading dense layers, and "pos"."""
    a, m = cfg.attention, cfg.moe
    dev = resolve_device(device)
    dt = L.param_dtype(cfg)
    if _is_mla(cfg):
        tails = ((a.kv_lora_rank,), (a.qk_rope_head_dim,))
    else:
        tails = ((a.num_kv_heads, a.head_dim),) * 2
    cache = {}
    for prefix, n in (("", cfg.num_layers - m.first_dense), ("dense_", m.first_dense)):
        if n:
            for key, tail in zip(_cache_keys(cfg), tails):
                cache[prefix + key] = torch.zeros((n, batch, max_len) + tail, dtype=dt,
                                                  device=dev)
    cache["pos"] = 0
    return cache


def _attn_prefill(lp, cfg, h, positions):
    """(attention output, this layer's cache entries)."""
    if _is_mla(cfg):
        out, ckv, krope = MLA.mla_prefill(lp.attn, cfg, h, positions)
        return out, (ckv, krope)
    a = cfg.attention
    B, S = h.shape[:2]
    q, k, v = L.gqa_project_qkv(lp.attn, cfg, h)
    q = L.apply_rope(q, positions, a.rope_theta)
    k = L.apply_rope(k, positions, a.rope_theta)
    out = L.mha(q, k, v, causal=True, q_positions=positions, kv_positions=positions)
    return out.reshape(B, S, -1) @ lp.attn.wo, (k, v)


@torch.no_grad()
def prefill(params: MoETransformer, cfg, batch):
    """Processes the full prompt, returns logits at the last position and a
    populated cache sized to the prompt (caller may re-pad)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    x = L.embed_tokens(params.embed, cfg, tokens)
    cache = {"pos": S}
    k1, k2 = _cache_keys(cfg)
    for prefix, layers in (("dense_", params.dense_layers), ("", params.layers)):
        entries = []
        for lp in layers:
            out, kv = _attn_prefill(lp, cfg, L.apply_norm(cfg, x, lp.ln1), positions)
            x = x + out
            hn = L.apply_norm(cfg, x, lp.ln2)
            x = ctx.constrain_tokens(x + (L.mlp_apply(lp.mlp, cfg, hn) if prefix
                                          else _moe_dispatch(lp.experts, cfg, hn)[0]))
            entries.append(kv)
        if entries:
            cache[prefix + k1] = torch.stack([e[0] for e in entries])
            cache[prefix + k2] = torch.stack([e[1] for e in entries])
    x = L.apply_norm(cfg, x, params.final_norm)
    return L.lm_logits(params.embed, cfg, x[:, -1:, :])[:, 0], cache


@torch.no_grad()
def decode_step(params: MoETransformer, cfg, cache, tokens):
    """tokens: (B,) int -> (logits (B,V) fp32, cache).  The new entries go
    into ``cache``'s tensors in place; the returned cache shares them, with
    ``pos`` advanced by one."""
    pos = cache["pos"]
    x = L.embed_tokens(params.embed, cfg, tokens[:, None])
    k1, k2 = _cache_keys(cfg)
    for prefix, layers in (("dense_", params.dense_layers), ("", params.layers)):
        for i, lp in enumerate(layers):
            hn = L.apply_norm(cfg, x, lp.ln1)
            c1, c2 = cache[prefix + k1][i], cache[prefix + k2][i]
            if _is_mla(cfg):
                out, _, _ = MLA.mla_decode(lp.attn, cfg, hn, c1, c2, pos)
            else:
                out, _, _ = L.gqa_decode(lp.attn, cfg, hn, c1, c2, pos)
            x = x + out
            hn = L.apply_norm(cfg, x, lp.ln2)
            x = ctx.constrain_tokens(x + (L.mlp_apply(lp.mlp, cfg, hn) if prefix
                                          else _moe_dispatch(lp.experts, cfg, hn)[0]))
    x = L.apply_norm(cfg, x, params.final_norm)
    return L.lm_logits(params.embed, cfg, x)[:, 0], {**cache, "pos": pos + 1}
