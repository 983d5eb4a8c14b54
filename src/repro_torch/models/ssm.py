"""Mamba-2 (SSD — state-space duality) family.

The family API of the JAX package's ``models/ssm.py``:

    init(seed, cfg, device)              -> Mamba2 (an nn.Module)
    forward(params, cfg, batch)          -> logits (B,S,V) fp32
    loss(params, cfg, batch)             -> (scalar, aux)
    init_cache(cfg, batch, max_len)      -> cache dict
    prefill(params, cfg, batch)          -> (last_logits, cache)
    decode_step(params, cfg, cache, tok) -> (logits, cache)

Prefill, forward and loss run the chunked SSD through ``kernels/ops.py::ssd``,
whose intra-chunk block is the ``ssd_chunk`` kernel on the card (the JAX
model runs its plain ``ssd_chunked`` instead; both compute the same
function); ``loss`` differentiates it with the ``ssd_chunk`` backward
kernel (the JAX package differentiates ``ssd_chunked``).  Decode is the
O(1) recurrent step in plain PyTorch.  The JAX package stacks the layers'
params on a leading L dim and scans them; here they are an
``nn.ModuleList`` walked in a loop.  A cache is {"conv":
(L, B, d_conv-1, conv_dim) in the param type, "ssm": (L, B, h, p, n)
float32, "pos": int}; ``decode_step`` writes into its tensors in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.distributed import ctx
from repro_torch.models import layers as L
from repro_torch.util import resolve_device

F32 = torch.float32


def _widths(cfg):
    """(d_inner, heads, ngroups * d_state, conv_dim, in_proj width)."""
    s = cfg.ssm
    di, h = cfg.d_inner, cfg.ssm_heads
    gn = s.ngroups * s.d_state
    conv_dim = di + 2 * gn
    return di, h, gn, conv_dim, di + conv_dim + h  # in_proj: [z, x, B, C, dt]


class Layer(nn.Module):
    """One SSD block's weights, named as the JAX package's dict keys.
    Drawn from ``key`` (an ``L.Key``) when one is given, with the JAX
    package's init: ``split(key, 4)`` for in_proj, conv_w (fan-in normal
    times 0.1 in bf16) and out_proj; ``A_log`` 0, ``D`` 1, ``dt_bias`` 0."""

    def __init__(self, cfg, key=None, *, device):
        super().__init__()
        device = resolve_device(device)
        s = cfg.ssm
        d = cfg.d_model
        di, h, _gn, conv_dim, in_dim = _widths(cfg)
        dt = L.param_dtype(cfg)

        def empty(shape):
            return L._param(torch.empty(shape, dtype=dt, device=device))

        self.norm = L.init_rms_for(cfg, d, device)
        self.in_proj = empty((d, in_dim))
        self.conv_w = empty((s.d_conv, conv_dim))
        self.conv_b = L._param(torch.zeros((conv_dim,), dtype=dt, device=device))
        self.A_log = L._param(torch.zeros((h,), dtype=F32, device=device))
        self.D = L._param(torch.ones((h,), dtype=F32, device=device))
        self.dt_bias = L._param(torch.zeros((h,), dtype=F32, device=device))
        self.gate_norm = L._param(torch.ones((di,), dtype=F32, device=device))
        self.out_proj = empty((di, d))
        if key is not None:
            ks = key.split(4)
            L.dense_init(ks[0], (d, in_dim), dtype=dt, out=self.in_proj.data)
            L.dense_init(ks[1], (s.d_conv, conv_dim), dtype=dt, out=self.conv_w.data, times=0.1)
            L.dense_init(ks[2], (di, d), dtype=dt, out=self.out_proj.data)


class Mamba2(nn.Module):
    """The model's weights: ``embed`` (token embedding and head),
    ``layers`` and ``final_norm``.  Drawn from ``key`` (an ``L.Key``) with
    the JAX package's split tree when one is given, else left empty for
    ``interop.ssm_params`` to fill."""

    def __init__(self, cfg, key=None, *, device):
        super().__init__()
        device = resolve_device(device)
        k_emb, layer_keys = L.split_stack(key, cfg.num_layers)
        self.embed = (L.init_embed(k_emb, cfg) if key is not None
                      else L.Embedding(cfg, device=device))
        self.layers = nn.ModuleList(Layer(cfg, k, device=device) for k in layer_keys)
        self.final_norm = L.init_rms_for(cfg, cfg.d_model, device)


def init(key, cfg, device="cuda") -> Mamba2:
    """The JAX package's initial weights for ``key`` (an int read as
    ``PRNGKey(key)``, or a (2,) uint32 key); on "meta" the shapes and types
    alone (``layers.seeded``)."""
    dev = resolve_device(device)
    return Mamba2(cfg, L.seeded(key, dev), device=dev)


def _split_proj(cfg, proj):
    di, _h, gn, _conv_dim, _in_dim = _widths(cfg)
    z = proj[..., :di]
    xBC = proj[..., di:di + di + 2 * gn]
    dt = proj[..., di + di + 2 * gn:]
    return z, xBC, dt


def _silu(x):
    """jax.nn.silu as XLA expands it: x * (1 / (1 + exp(-x))), every op
    rounded to x's type.  In bf16 ``F.silu`` rounds once and differs from
    the JAX package by a bf16 step in about 40% of the elements."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def _conv1d(xBC, w, b):
    """Causal depthwise conv along the sequence, as K shifted multiply-adds
    in the working type (the JAX package's loop; no cuDNN, which would run
    f32 in TF32 and round bf16 otherwise).  xBC: (B,S,C), w: (K,C)."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(K):
        out = out + pad[:, i:i + S, :] * w[i]
    return _silu(out + b)


def _block(lp: Layer, cfg, x):
    """The full-sequence SSD block.  Returns (x + block(x), the block's
    pre-conv xBC (B,S,conv_dim), the final SSM state (B,h,p,n) f32)."""
    s = cfg.ssm
    Bsz, S, _ = x.shape
    di, h, gn, _conv_dim, _in_dim = _widths(cfg)
    hn = L.apply_norm(cfg, x, lp.norm)
    proj = hn @ lp.in_proj
    z, xBC, dt_raw = _split_proj(cfg, proj)
    xBC_conv = _conv1d(xBC, lp.conv_w, lp.conv_b)
    xi = xBC_conv[..., :di].reshape(Bsz, S, h, s.head_dim)
    Bm = xBC_conv[..., di:di + gn].reshape(Bsz, S, s.ngroups, s.d_state)
    Cm = xBC_conv[..., di + gn:].reshape(Bsz, S, s.ngroups, s.d_state)
    dt = F.softplus(dt_raw.to(F32) + lp.dt_bias)
    y, final = ops.ssd(xi, dt, lp.A_log, Bm, Cm, lp.D, s.chunk)
    y = y.reshape(Bsz, S, di)
    # the gate's product unrounded into the norm, as XLA's fusion computes
    # the JAX package's bf16 expression
    gated = y.to(F32) * _silu(z.to(F32)).to(y.dtype)
    y = L.rms_norm(gated, lp.gate_norm, cfg.norm_eps).to(y.dtype)
    return ctx.constrain_tokens(x + y @ lp.out_proj), xBC, final


def layer_fwd(lp: Layer, cfg, x):
    """Full-sequence (train/prefill) SSD block."""
    return _block(lp, cfg, x)[0]


def layer_decode(lp: Layer, cfg, x, conv_state, ssm_state):
    """Single-token recurrent step.

    conv_state: (B, d_conv-1, conv_dim); ssm_state: (B, h, p, n) fp32.
    Returns (x + block(x), new conv_state, new ssm_state)."""
    s = cfg.ssm
    Bsz = x.shape[0]
    di, h, gn, _conv_dim, _in_dim = _widths(cfg)
    hn = L.apply_norm(cfg, x, lp.norm)
    proj = (hn @ lp.in_proj)[:, 0]  # (B, in_dim)
    z, xBC, dt_raw = _split_proj(cfg, proj)
    # conv ring: append, apply, shift
    full = torch.cat([conv_state, xBC[:, None, :]], dim=1)  # (B, K, C)
    xBC = _silu(torch.einsum("bkc,kc->bc", full, lp.conv_w) + lp.conv_b)
    new_conv_state = full[:, 1:]
    xi = xBC[..., :di].reshape(Bsz, h, s.head_dim)
    Bm = xBC[..., di:di + gn].reshape(Bsz, s.ngroups, s.d_state)
    Cm = xBC[..., di + gn:].reshape(Bsz, s.ngroups, s.d_state)
    rep = h // s.ngroups
    Bh = Bm.repeat_interleave(rep, dim=1).to(F32)  # (B, h, n)
    Ch = Cm.repeat_interleave(rep, dim=1).to(F32)
    dt = F.softplus(dt_raw.to(F32) + lp.dt_bias)  # (B, h)
    A = -torch.exp(lp.A_log.to(F32))
    decay = torch.exp(dt * A[None, :])  # (B, h)
    xf = xi.to(F32) * dt[..., None]
    new_state = ssm_state * decay[..., None, None] + torch.einsum("bhp,bhn->bhpn", xf, Bh)
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch) + xi.to(F32) * lp.D[None, :, None]
    y = y.reshape(Bsz, 1, di)
    gated = y.to(x.dtype).to(F32) * _silu(z[:, None].to(F32)).to(x.dtype)  # as in _block
    y = L.rms_norm(gated, lp.gate_norm, cfg.norm_eps).to(x.dtype)
    return ctx.constrain_tokens(x + y @ lp.out_proj), new_conv_state, new_state


# ------------------------------------------------------------- family API
def _logits(params: Mamba2, cfg, batch):
    x = L.embed_tokens(params.embed, cfg, batch["tokens"])
    for lp in params.layers:
        x = L.remat(cfg, layer_fwd, lp, cfg, x)
    x = L.apply_norm(cfg, x, params.final_norm)
    return L.lm_logits(params.embed, cfg, x)


forward = torch.no_grad()(_logits)


def loss(params: Mamba2, cfg, batch):
    """(mean cross-entropy of the next-token ``labels``, {}), differentiable
    in the parameters (``layers.trainable``): each layer recomputed in the
    backward under ``cfg.remat``, its ``ssd_chunk`` through the autograd
    Function (the backward kernel on the card)."""
    logits = _logits(params, cfg, batch)
    return L.cross_entropy(logits, batch["labels"], batch.get("loss_mask")), {}


def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """Zero conv and SSM states (their size does not depend on
    ``max_len``)."""
    s = cfg.ssm
    _di, h, _gn, conv_dim, _in_dim = _widths(cfg)
    dev = resolve_device(device)
    return {
        "conv": torch.zeros((cfg.num_layers, batch, s.d_conv - 1, conv_dim),
                            dtype=L.param_dtype(cfg), device=dev),
        "ssm": torch.zeros((cfg.num_layers, batch, h, s.head_dim, s.d_state), dtype=F32,
                           device=dev),
        "pos": 0,
    }


@torch.no_grad()
def prefill(params: Mamba2, cfg, batch):
    """Processes the full prompt (its length a multiple of the chunk);
    returns logits at the last position and the cache after it: each
    layer's last d_conv-1 pre-conv inputs (zeros in front of a shorter
    prompt) and its final SSM state."""
    tokens = batch["tokens"]
    Bsz, S = tokens.shape
    keep = cfg.ssm.d_conv - 1
    x = L.embed_tokens(params.embed, cfg, tokens)
    convs, finals = [], []
    for lp in params.layers:
        x, xBC, final = _block(lp, cfg, x)
        tail = xBC[:, S - min(S, keep):].to(L.param_dtype(cfg))
        # stacked, not written into a zeroed cache: a DTensor under a mesh
        # does not copy into a plain tensor
        pad = torch.zeros((Bsz, keep - tail.shape[1], tail.shape[2]), dtype=tail.dtype,
                          device=x.device)
        convs.append(torch.cat([pad, tail], dim=1))
        finals.append(final.to(F32))
    x = L.apply_norm(cfg, x, params.final_norm)
    logits = L.lm_logits(params.embed, cfg, x[:, -1:, :])
    return logits[:, 0], {"conv": torch.stack(convs), "ssm": torch.stack(finals), "pos": S}


@torch.no_grad()
def decode_step(params: Mamba2, cfg, cache, tokens):
    """tokens: (B,) int -> (logits (B,V) fp32, cache).  The new conv and
    SSM states go into ``cache``'s tensors in place; the returned cache
    shares them, with ``pos`` advanced by one."""
    x = L.embed_tokens(params.embed, cfg, tokens[:, None])
    for i, lp in enumerate(params.layers):
        x, conv, st = layer_decode(lp, cfg, x, cache["conv"][i], cache["ssm"][i])
        cache["conv"][i] = conv
        cache["ssm"][i] = st
    x = L.apply_norm(cfg, x, params.final_norm)
    logits = L.lm_logits(params.embed, cfg, x)
    return logits[:, 0], {"conv": cache["conv"], "ssm": cache["ssm"], "pos": cache["pos"] + 1}
