"""Plain PyTorch oracles for the kernels (the allclose references)."""
from __future__ import annotations

import math

import torch


def cascade_score_ref(x, w1, b1, w2, b2, thresholds, out_scale=None):
    """Two-pass packed-cascade oracle for ``cascade_score``.

    x: (N, F); w1: (F, HP) stacked folded hidden weights (float32 or int8
    codes); b1: (HP,); w2: (HP, P) readout; b2, thresholds: (P,);
    ``out_scale`` (P,) the per-stage dequantizing scales of a quantized
    cascade (None: the fp32 path).  Returns (scores (N, P) f32, mask (N, P)
    bool, packed) where ``packed[p]`` are the ascending row indices (int32
    tensors) where stage p's mask is True.
    """
    f32 = torch.float32
    if out_scale is None:
        out_scale = torch.ones_like(b2.to(f32))
    hid = torch.relu(x.to(f32) @ w1.to(f32) + b1.to(f32))
    scores = (hid @ w2.to(f32)) * out_scale.to(f32) + b2.to(f32)
    mask = scores >= thresholds.to(f32)
    packed = [torch.nonzero(mask[:, p]).flatten().to(torch.int32)
              for p in range(mask.shape[1])]
    return scores, mask, packed


def flash_attention_ref(q, k, v, *, causal: bool = True, scale: float | None = None):
    """q: (B, Sq, H, D); k/v: (B, Sk, K, D) with H % K == 0.  fp32 softmax."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    f32 = torch.float32
    qg = q.reshape(B, Sq, K, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(f32), k.to(f32)) * scale
    if causal:
        mask = torch.arange(Sq, device=q.device)[:, None] >= torch.arange(Sk, device=q.device)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return o.reshape(B, Sq, H, D)


def ssd_chunk_ref(x, dA, B, C):
    """Per-chunk SSD terms (the kernel computes these for every chunk):

    x: (nc, Q, H, P) inputs (pre-multiplied by dt)
    dA: (nc, Q, H) per-step log-decay (dt * A, negative)
    B, C: (nc, Q, H, N) input/output projections (groups pre-broadcast)

    Returns:
      y_diag: (nc, Q, H, P) intra-chunk output
      states: (nc, H, P, N) per-chunk end state contribution
      chunk_decay: (nc, H) exp(sum dA) per chunk
    """
    f32 = torch.float32
    dAc = torch.movedim(dA.to(f32), -1, 1)  # (nc, H, Q)
    cum = torch.cumsum(dAc, dim=-1)  # (nc, H, Q)
    Q = x.shape[1]
    seg = cum[..., :, None] - cum[..., None, :]  # (nc, H, Q, Q)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.where(mask, torch.exp(seg), torch.zeros((), dtype=f32, device=x.device))
    scores = torch.einsum("cqhn,cshn->chqs", C.to(f32), B.to(f32))
    y_diag = torch.einsum("chqs,chqs,cshp->cqhp", scores, L, x.to(f32))
    decay_states = torch.exp(cum[..., -1:] - cum)  # (nc, H, Q)
    states = torch.einsum("cqhn,chq,cqhp->chpn", B.to(f32), decay_states, x.to(f32))
    return y_diag, states, torch.exp(cum[..., -1])
