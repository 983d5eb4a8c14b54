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
