"""AdamW, Adafactor and SGD(+momentum) in PyTorch, with the JAX package's
formulas (``repro/training/optim.py``): the bias correction in f32, the
weight decay added to the update, the update in f32 and the cast back to
the parameter's type (Adafactor: the scaled update cast to the parameter's
type and applied there, its row and column factors for leaves of two or
more dimensions).

Parameters, gradients and states are dicts of tensors under one set of
keys.  The update functions write the new parameters and moments into the
given tensors in place (the JAX package returns new pytrees) and return the
new state; ``step`` is a Python int.  Gradients may be in the parameter's
type or in f32; each leaf is upcast on its own, so no f32 copy of the whole
gradient tree is made.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

F32 = torch.float32
Tree = Dict[str, torch.Tensor]


def _f32_step(step: int) -> torch.Tensor:
    return torch.tensor(float(step), dtype=F32)


class AdamWState(NamedTuple):
    step: int
    mu: Tree  # f32, like params
    nu: Tree  # f32, like params


def adamw_init(params: Tree) -> AdamWState:
    zeros = {k: torch.zeros(p.shape, dtype=F32, device=p.device) for k, p in params.items()}
    return AdamWState(step=0, mu=zeros,
                      nu={k: torch.zeros_like(z) for k, z in zeros.items()})


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: AdamWState, *, lr=1e-4, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.0) -> AdamWState:
    step = state.step + 1
    t = _f32_step(step)
    c1 = float(1.0 - torch.tensor(b1, dtype=F32) ** t)
    c2 = float(1.0 - torch.tensor(b2, dtype=F32) ** t)
    for key, p in params.items():
        gf = grads[key].to(F32)
        m, v = state.mu[key], state.nu[key]
        m.mul_(b1).add_(gf * (1 - b1))
        v.mul_(b2).add_(gf.square() * (1 - b2))
        update = (m / c1).div_((v / c2).sqrt_().add_(eps))
        pf = p.to(F32)  # p itself when p is f32
        if weight_decay:
            update.add_(pf * weight_decay)
        pf = pf.sub_(update.mul_(lr))
        if pf is not p:
            p.copy_(pf)
    return AdamWState(step=step, mu=state.mu, nu=state.nu)


class AdafactorState(NamedTuple):
    """Factored second moments (Shazeer & Stern, 2018): row and column
    factors for leaves of two or more dimensions, the full moment (in
    ``vr``) and a (1,)-shaped placeholder (in ``vc``) for the others."""

    step: int
    vr: Tree
    vc: Tree


def _factored(p: torch.Tensor) -> bool:
    return p.dim() >= 2


def adafactor_init(params: Tree) -> AdafactorState:
    vr, vc = {}, {}
    for k, p in params.items():
        if _factored(p):
            vr[k] = torch.zeros(p.shape[:-1], dtype=F32, device=p.device)
            vc[k] = torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=F32, device=p.device)
        else:
            vr[k] = torch.zeros(p.shape, dtype=F32, device=p.device)
            vc[k] = torch.zeros((1,) * max(p.dim(), 1), dtype=F32, device=p.device)
    return AdafactorState(step=0, vr=vr, vc=vc)


@torch.no_grad()
def adafactor_update(params: Tree, grads: Tree, state: AdafactorState, *, lr=1e-4, decay=0.8,
                     eps=1e-30, clip_threshold=1.0) -> AdafactorState:
    step = state.step + 1
    beta2 = float(1.0 - _f32_step(step) ** (-decay))
    for key, p in params.items():
        gf = grads[key].to(F32)
        g2 = gf.square().add_(eps)
        vr, vc = state.vr[key], state.vc[key]
        if _factored(p):
            vr.mul_(beta2).add_(g2.mean(dim=-1) * (1 - beta2))
            vc.mul_(beta2).add_(g2.mean(dim=-2) * (1 - beta2))
            r = vr / vr.mean(dim=-1, keepdim=True).clamp_min(eps)
            update = gf / (r.sqrt()[..., None] * vc.sqrt()[..., None, :] + eps)
        else:
            vr.mul_(beta2).add_(g2 * (1 - beta2))
            update = gf / (vr.sqrt() + eps)
        rms = torch.sqrt(update.square().mean() + 1e-12)
        scale = lr / torch.clamp_min(rms / clip_threshold, 1.0)
        # applied in the parameter's type: no full-f32 update tree
        p.sub_((scale * update).to(p.dtype))
    return AdafactorState(step=step, vr=state.vr, vc=state.vc)


class SGDState(NamedTuple):
    step: int
    momentum: Tree


def sgd_init(params: Tree) -> SGDState:
    return SGDState(step=0, momentum={k: torch.zeros(p.shape, dtype=F32, device=p.device)
                                      for k, p in params.items()})


@torch.no_grad()
def sgd_update(params: Tree, grads: Tree, state: SGDState, *, lr=1e-2, momentum=0.9,
               weight_decay=0.0) -> SGDState:
    for key, p in params.items():
        gf = grads[key].to(F32)
        pf = p.to(F32)
        if weight_decay:
            gf = gf + weight_decay * pf
        m = state.momentum[key]
        m.mul_(momentum).add_(gf)
        p.copy_(pf - lr * m)
    return SGDState(step=state.step + 1, momentum=state.momentum)
