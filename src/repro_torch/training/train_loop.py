"""The train step for every ported family (the JAX package's
``repro/training/train_loop.py``).

``make_train_step(cfg)`` builds ``train_step(params, opt_state, batch) ->
(params, opt_state, {"loss"})``: the batch's leading dim is cut into
``cfg.accum_steps`` micro-batches in order, each one's gradients are added
in ``cfg.grad_accum_dtype`` (f32) and the sum divided by the count, then
one AdamW (or Adafactor) update.  ``params`` is the family's ``nn.Module``
with gradients on (``init_train_state``); the update writes the new
parameters and moments in place (the JAX package returns new pytrees).

On the card full causal attention goes through ``flash_attention``'s
autograd Function and the SSM's intra-chunk block through ``ssd_chunk``'s
(forward and backward kernels; under ``cfg.remat`` each layer's forward
runs twice, once more in the backward).  Adafactor's factored statistics
are taken over the JAX package's leaves, whose layer stacks carry a leading
layer dim (``models/leaves.py``), so its state and update equal the JAX
package's; AdamW's are elementwise and keep one tensor a parameter.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import leaves
from repro_torch.models.registry import get_family
from repro_torch.training import optim
from repro_torch.util import resolve_device

def make_loss_fn(cfg):
    """``loss_fn(params, batch) -> (loss, aux)`` of ``cfg``'s family."""
    fam = get_family(cfg)

    def loss_fn(params, batch):
        return fam.loss(params, cfg, batch)

    return loss_fn


def _micro_batches(batch: dict, accum: int):
    """The batch's leading dim cut into ``accum`` equal parts, in order."""
    B = next(iter(batch.values())).shape[0]
    if B % accum:
        raise ValueError(f"batch {B} is not a multiple of accum_steps {accum}")
    return [{k: v[i * (B // accum):(i + 1) * (B // accum)] for k, v in batch.items()}
            for i in range(accum)]


def _adafactor_step(named: dict, grads: dict, state, lr: float):
    """Adafactor over the JAX package's leaves: each layer stack's
    parameters and gradients stacked (copies), updated, written back."""
    p_leaves = leaves.stacked(named)
    g_leaves = leaves.stacked(grads)
    state = optim.adafactor_update(p_leaves, g_leaves, state, lr=lr)
    leaves.unstack_into(p_leaves, named)
    return state


def _grads(loss, tensors):
    """d loss / d tensors; zeros for a parameter the loss does not reach
    (as ``jax.grad`` gives)."""
    return torch.autograd.grad(loss, tensors, allow_unused=True, materialize_grads=True)


def make_train_step(cfg, *, lr=1e-4, weight_decay=0.0):
    loss_fn = make_loss_fn(cfg)
    accum = max(1, cfg.accum_steps)
    acc_dtype = getattr(torch, cfg.grad_accum_dtype)

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        tensors = list(named.values())
        if accum == 1:
            loss, _aux = loss_fn(params, batch)
            # in the parameters' type: each optimizer leaf upcasts its own
            grads = dict(zip(named, _grads(loss, tensors)))
            loss = loss.detach()
        else:
            gsum = {n: torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                    for n, p in named.items()}
            lsum = torch.zeros((), dtype=L.F32, device=tensors[0].device)
            for mb in _micro_batches(batch, accum):
                loss, _aux = loss_fn(params, mb)
                for n, g in zip(named, _grads(loss, tensors)):
                    gsum[n].add_(g.to(acc_dtype))
                lsum = lsum + loss.detach()
            # divided in the accumulation type; the optimizer upcasts a leaf at a time
            grads = {n: g.div_(accum) for n, g in gsum.items()}
            loss = lsum / accum
        if cfg.optimizer == "adafactor":
            opt_state = _adafactor_step(named, grads, opt_state, lr)
        else:
            opt_state = optim.adamw_update(named, grads, opt_state, lr=lr,
                                           weight_decay=weight_decay)
        return params, opt_state, {"loss": loss}

    return train_step


def init_opt_state(cfg, params):
    """AdamW's moments a parameter, or Adafactor's factors a JAX leaf."""
    named = dict(params.named_parameters())
    if cfg.optimizer != "adafactor":
        return optim.adamw_init(named)
    dev = next(iter(named.values())).device
    shapes = {path: torch.empty(leaf.shape, device="meta")
              for path, leaf in leaves.stacked({n: p.to("meta") for n, p in named.items()}).items()}
    st = optim.adafactor_init(shapes)
    return optim.AdafactorState(
        step=0, vr={k: torch.zeros_like(v, device=dev) for k, v in st.vr.items()},
        vc={k: torch.zeros_like(v, device=dev) for k, v in st.vc.items()})


def init_train_state(cfg, seed: int = 0, device="cuda"):
    """(params with gradients on, optimizer state): the family's weights
    from ``torch.Generator(device).manual_seed(seed)``."""
    params = L.trainable(get_family(cfg).init(seed, cfg, resolve_device(device)))
    return params, init_opt_state(cfg, params)
