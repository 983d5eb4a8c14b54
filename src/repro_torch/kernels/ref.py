"""Plain PyTorch oracles for the kernels (the allclose references)."""
from __future__ import annotations

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
