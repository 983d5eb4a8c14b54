"""The train step for every ported family (the JAX package's
``repro/training/train_loop.py``).

``make_train_step(cfg)`` builds ``train_step(params, opt_state, batch) ->
(params, opt_state, {"loss"})``: the batch's leading dim is cut into
``cfg.accum_steps`` micro-batches in order, each one's gradients are added
in ``cfg.grad_accum_dtype`` (f32) and the sum divided by the count, then
one AdamW (or Adafactor) update.  ``params`` is the family's ``nn.Module``
with gradients on (``init_train_state``); the update writes the new
parameters and moments in place (the JAX package returns new pytrees).

``make_sharded_train_step(cfg)`` is the same step under a device mesh
(``distributed/ctx.py``), where the JAX package jits ``make_train_step``
with shardings: its ``params`` are the JAX package's leaves (``{path:
leaf}``, layer stacks on a leading dim, ``models/leaves.py``) as DTensors
laid out by ``distributed/sharding.py``, and its optimizer state is keyed
the same way.  The family's module is built once on "meta" and each
micro-batch runs it through ``torch.func.functional_call`` over the
leaves' layer views (one ``unbind`` a stack), forward and gradient inside
the call, so that a layer recomputed under remat reads the same views.

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


class _LossAndGrads(torch.nn.Module):
    """The family's loss and its gradients in ``wrt``, for
    ``functional_call``: computed inside the call, so that a remat layer's
    recomputation in the backward still reads the substituted tensors."""

    def __init__(self, cfg, model):
        super().__init__()
        self.cfg, self.model, self.loss_fn = cfg, model, make_loss_fn(cfg)

    def forward(self, batch, wrt):
        loss, _aux = self.loss_fn(self.model, batch)
        return loss.detach(), _grads(loss, wrt)


def _layers(stack) -> tuple:
    """A stack's layers (``unbind`` on its leading dim); a DTensor split
    over that dim (a norm's stack under the train rule) is gathered on it
    first."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(stack, DTensor) and any(p.is_shard(0) for p in stack.placements):
        stack = stack.redistribute(stack.device_mesh, [Replicate() if p.is_shard(0) else p
                                                       for p in stack.placements])
    return stack.unbind(0)


def _views(groups: dict, params: dict) -> dict:
    """{"model.<parameter name>": its view of a leaf}: a stack unbound on
    its layer dim, any other leaf as it is."""
    out = {}
    for path, names in groups.items():
        vs = _layers(params[path]) if leaves.is_stacked(path) else (params[path],)
        out.update(("model." + n, v) for n, v in zip(names, vs))
    return out


class _Call(torch.nn.Module):
    def __init__(self, cfg, name: str):
        super().__init__()
        self.cfg, self.fam = cfg, get_family(cfg)
        self.name, self.model = name, self.fam.init(0, cfg, "meta")

    def forward(self, *args):
        return getattr(self.fam, self.name)(self.model, self.cfg, *args)


def apply_with_leaves(cfg, name: str, params: dict, *args):
    """The family's function ``name`` (``prefill``, ``decode_step``, ...)
    with ``{path: leaf}`` params in place of its module's weights."""
    from torch.func import functional_call

    module = _Call(cfg, name)
    return functional_call(module, _views(leaves.groups(dict(module.model.named_parameters())),
                                          params), args)


def _local_micro_batches(batch: dict, accum: int):
    """``_micro_batches`` with no communication: micro-batch i of a DTensor
    leaf is the i-th of ``accum`` equal parts of each device's shard of the
    batch dim (the whole batch's i-th part when that dim is not sharded),
    in the leaf's layout.  Cutting the global batch into contiguous parts
    would gather it for every part; these parts hold the same rows in all,
    so the summed gradient and the mean loss are the same sums."""
    from torch.distributed.tensor import DTensor

    if not any(isinstance(v, DTensor) for v in batch.values()):
        yield from _micro_batches(batch, accum)
        return
    B = next(iter(batch.values())).shape[0]
    if B % accum:
        raise ValueError(f"batch {B} is not a multiple of accum_steps {accum}")
    for i in range(accum):
        mb = {}
        for k, v in batch.items():
            local = v.to_local()
            n = local.shape[0] // accum
            shape = (B // accum, *v.shape[1:])
            mb[k] = DTensor.from_local(local[i * n:(i + 1) * n], v.device_mesh, v.placements,
                                       run_check=False, shape=shape,
                                       stride=torch.empty(shape, device="meta").stride())
        yield mb


def make_sharded_train_step(cfg, *, lr=1e-4, weight_decay=0.0):
    """``train_step(params, opt_state, batch)`` over ``{path: leaf}``
    params (DTensors under ``ctx.use_mesh``, or plain tensors), each a
    leaf with gradients on; the optimizer state keyed by the same paths
    (``init_leaf_opt_state``).  Accumulation and the update are
    ``make_train_step``'s; the micro-batches are each device's own
    (``_local_micro_batches``)."""
    from torch.func import functional_call

    accum = max(1, cfg.accum_steps)
    acc_dtype = getattr(torch, cfg.grad_accum_dtype)
    module = _LossAndGrads(cfg, get_family(cfg).init(0, cfg, "meta"))
    groups = leaves.groups(dict(module.model.named_parameters()))

    def train_step(params, opt_state, batch):
        keys = list(params)
        wrt = [params[k] for k in keys]
        gsum, lsum = None, None
        for mb in _local_micro_batches(batch, accum):
            loss, grads = functional_call(module, _views(groups, params), (mb, wrt))
            if accum == 1:
                gsum, lsum = dict(zip(keys, grads)), loss
                break
            if gsum is None:
                gsum = {k: torch.zeros_like(p, dtype=acc_dtype) for k, p in params.items()}
                lsum = torch.zeros_like(loss, dtype=L.F32)
            for k, g in zip(keys, grads):
                gsum[k].add_(g.to(acc_dtype))
            lsum = lsum + loss
        grads = gsum if accum == 1 else {k: g.div_(accum) for k, g in gsum.items()}
        loss = lsum if accum == 1 else lsum / accum
        if cfg.optimizer == "adafactor":
            opt_state = optim.adafactor_update(params, grads, opt_state, lr=lr)
        else:
            opt_state = optim.adamw_update(params, grads, opt_state, lr=lr,
                                           weight_decay=weight_decay)
        return params, opt_state, {"loss": loss}

    return train_step


def init_leaf_opt_state(cfg, params: dict):
    """The optimizer state of ``{path: leaf}`` params (plain tensors; lay
    it out with ``sharding.opt_shardings``)."""
    if cfg.optimizer == "adafactor":
        return optim.adafactor_init(params)
    return optim.adamw_init(params)


def leaf_params(params) -> dict:
    """A family module's parameters as the JAX package's leaves, ``{path:
    leaf}`` (stacks are copies), detached."""
    return {path: t.detach() if leaves.is_stacked(path) else t.detach().clone()
            for path, t in leaves.stacked(dict(params.named_parameters())).items()}


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


def init_train_state(cfg, key=0, device="cuda"):
    """(params with gradients on, optimizer state): the family's weights
    for ``key`` (an int read as ``PRNGKey(key)``, or a (2,) uint32 key), the
    JAX package's ``init_train_state(cfg, key)``'s."""
    params = L.trainable(get_family(cfg).init(key, cfg, resolve_device(device)))
    return params, init_opt_state(cfg, params)
