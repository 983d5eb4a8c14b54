"""Proxy-model trainers: linear SVM (hinge) and shallow NN, in PyTorch.

These are the cheap classifiers M inside a proxy model sigma-hat.  Training
is full-batch gradient descent with momentum 0.9 on the given device, with
the gradients written out (no autograd graph) so each step is a handful of
kernels and follows the JAX package's ``jax.grad`` term for term, ties
included.  Class imbalance is handled with inverse-frequency loss weights.

Parameters are frozen dataclasses of tensors on the training device.  They
compare and hash by identity, so ``kernels/ops.py`` can memoize their
packed form in a ``WeakKeyDictionary`` (no ``id()`` keys).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.util import resolve_device


@dataclass(frozen=True, eq=False)
class LinearParams:
    w: torch.Tensor  # (F,)
    b: torch.Tensor  # ()
    mean: torch.Tensor  # (F,) feature standardization
    scale: torch.Tensor  # (F,)


@dataclass(frozen=True, eq=False)
class MLPParams:
    w1: torch.Tensor  # (F, hidden)
    b1: torch.Tensor  # (hidden,)
    w2: torch.Tensor  # (hidden,)
    b2: torch.Tensor  # ()
    mean: torch.Tensor  # (F,)
    scale: torch.Tensor  # (F,)


class PackedProxy(NamedTuple):
    """Family-agnostic host format of ONE proxy: a folded depth-1 MLP,
    ``score(x) = relu(x @ w1 + b1) @ w2 + b2`` with the feature
    standardizer folded into ``(w1, b1)``.  ``hidden`` is the family's true
    hidden width before any cascade-level bucket padding."""

    w1: np.ndarray  # (F, hidden)
    b1: np.ndarray  # (hidden,)
    w2: np.ndarray  # (hidden,)
    b2: np.float32
    hidden: int


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def pack_linear(params: LinearParams) -> PackedProxy:
    """Linear proxies pack exactly via the +/- trick: hidden units
    ``(z, -z)`` and readout ``(+1, -1)`` give ``relu(z) - relu(-z) == z``
    bit for bit.  The fold is computed in numpy exactly as the JAX package
    does, so equal params give byte-equal packed arrays."""
    w = (_host(params.w).astype(np.float32)
         / _host(params.scale).astype(np.float32)).astype(np.float32)
    b = np.float32(float(_host(params.b)) - float(_host(params.mean) @ w))
    w1 = np.stack([w, -w], axis=1)  # (F, 2)
    b1 = np.asarray([b, -b], np.float32)
    w2 = np.asarray([1.0, -1.0], np.float32)
    return PackedProxy(w1=w1, b1=b1, w2=w2, b2=np.float32(0.0), hidden=2)


def pack_mlp(params: MLPParams) -> PackedProxy:
    """Depth-1 MLP: fold the standardizer into the first layer —
    ``((x - mean) / scale) @ w1 == x @ (w1 / scale[:, None]) - (mean / scale) @ w1``."""
    mean = _host(params.mean).astype(np.float32)
    scale = _host(params.scale).astype(np.float32)
    raw_w1 = _host(params.w1).astype(np.float32)
    w1 = (raw_w1 / scale[:, None]).astype(np.float32)
    b1 = (_host(params.b1).astype(np.float32) - (mean / scale) @ raw_w1).astype(np.float32)
    return PackedProxy(w1=w1, b1=b1, w2=_host(params.w2).astype(np.float32),
                       b2=np.float32(_host(params.b2)), hidden=int(w1.shape[1]))


def packed_score(packed: PackedProxy, x: np.ndarray) -> np.ndarray:
    """Reference evaluation of the packed form (numpy, no kernel)."""
    h = np.maximum(x.astype(np.float32) @ packed.w1 + packed.b1, 0.0)
    return h @ packed.w2 + packed.b2


def _as_tensor(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev, torch.float32)
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def _standardizer(x: torch.Tensor):
    return x.mean(0), x.std(0, correction=0) + 1e-6


def _class_weights(pos: torch.Tensor) -> torch.Tensor:
    n = pos.shape[0]
    n_pos = pos.sum().clamp_min(1).to(torch.float32)
    n_neg = (~pos).sum().clamp_min(1).to(torch.float32)
    return torch.where(pos, n / (2.0 * n_pos), n / (2.0 * n_neg))


def train_linear_svm(x, y, *, steps: int = 200, lr: float = 0.1, l2: float = 1e-4,
                     device="cuda") -> LinearParams:
    """x: (N, F) float32; y: (N,) in {-1, +1}.  Zero init, full-batch
    weighted hinge loss + L2, momentum 0.9 — deterministic."""
    dev = resolve_device(device)
    x = _as_tensor(x, dev)
    y = _as_tensor(y, dev)
    mean, scale = _standardizer(x)
    xs = (x - mean) / scale
    n = x.shape[0]
    wts = _class_weights(y > 0)
    w = torch.zeros(x.shape[1], device=dev)
    b = torch.zeros((), device=dev)
    mw, mb = torch.zeros_like(w), torch.zeros_like(b)
    for _ in range(steps):
        margin = y * (xs @ w + b)
        # d max(0, 1 - m)/dm: -1 below the hinge, 0 above, -0.5 at the tie
        # (the balanced subgradient jax.grad takes for max)
        dh = -((margin < 1.0).to(torch.float32) + 0.5 * (margin == 1.0).to(torch.float32))
        g = wts * dh * y / n
        gw = xs.T @ g + 2.0 * l2 * w
        gb = g.sum()
        mw = 0.9 * mw + gw
        mb = 0.9 * mb + gb
        w = w - lr * mw
        b = b - lr * mb
    return LinearParams(w=w, b=b, mean=mean, scale=scale)


def linear_score(params: LinearParams, x) -> torch.Tensor:
    x = _as_tensor(x, params.w.device)
    return ((x - params.mean) / params.scale) @ params.w + params.b


def train_mlp(x, y, *, seed: int = 0, steps: int = 300, hidden: int = 32,
              lr: float = 0.05, init: Optional[Sequence] = None,
              device="cuda") -> MLPParams:
    """Shallow NN proxy: one hidden layer, weighted BCE loss, y in {-1, +1}.

    ``init`` injects the initial ``(w1, b1, w2, b2)``; without it they are
    drawn from a ``torch.Generator`` on ``device`` seeded with ``seed``
    (``randn / sqrt(fan_in)``, zero biases).  torch cannot reproduce the
    JAX package's ``jax.random`` draws, so parity runs inject its init."""
    dev = resolve_device(device)
    x = _as_tensor(x, dev)
    y = _as_tensor(y, dev)
    mean, scale = _standardizer(x)
    xs = (x - mean) / scale
    n, F = x.shape
    yb = (y > 0).to(torch.float32)
    wts = _class_weights(y > 0)
    if init is None:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        w1 = torch.randn(F, hidden, generator=gen, device=dev) / float(np.sqrt(F))
        b1 = torch.zeros(hidden, device=dev)
        w2 = torch.randn(hidden, generator=gen, device=dev) / float(np.sqrt(hidden))
        b2 = torch.zeros((), device=dev)
    else:
        w1, b1, w2, b2 = (_as_tensor(a, dev) for a in init)
    p = [w1, b1, w2, b2]
    m = [torch.zeros_like(t) for t in p]
    for _ in range(steps):
        w1, b1, w2, b2 = p
        pre = xs @ w1 + b1
        h = torch.relu(pre)
        lg = h @ w2 + b2
        # d/dlg of max(lg,0) - lg*yb + log1p(exp(-|lg|)), term by term as
        # jax.grad takes it: max splits its tie (0.5 at lg == 0) and
        # d|lg|/dlg is +1 at lg == 0 (a row whose hidden units are all off)
        e = torch.exp(-lg.abs())
        step = (lg > 0).to(torch.float32) + 0.5 * (lg == 0).to(torch.float32)
        sign = torch.where(lg >= 0, 1.0, -1.0)
        dlg = wts * (step - yb - sign * e / (1.0 + e)) / n
        dpre = dlg[:, None] * w2[None, :] * (pre > 0).to(torch.float32)
        g = [xs.T @ dpre, dpre.sum(0), h.T @ dlg, dlg.sum()]
        m = [0.9 * mm + gg for mm, gg in zip(m, g)]
        p = [pp - lr * mm for pp, mm in zip(p, m)]
    return MLPParams(w1=p[0], b1=p[1], w2=p[2], b2=p[3], mean=mean, scale=scale)


def mlp_score(params: MLPParams, x) -> torch.Tensor:
    x = _as_tensor(x, params.w1.device)
    h = torch.relu(((x - params.mean) / params.scale) @ params.w1 + params.b1)
    return h @ params.w2 + params.b2


def f1_score(scores: np.ndarray, y: np.ndarray, threshold: float = 0.0) -> float:
    """F1 of sign(score - threshold) vs y in {-1,+1} (the epsilon-approximate
    classifier-reuse test, Eq. 4.7)."""
    pred = scores >= threshold
    pos = y > 0
    tp = float(np.sum(pred & pos))
    fp = float(np.sum(pred & ~pos))
    fn = float(np.sum(~pred & pos))
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 1.0
