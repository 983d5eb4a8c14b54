"""Ambient mesh context for activation layouts (the JAX package's
``distributed/ctx.py``).

Model code is mesh-agnostic: it calls ``constrain(x, *dim_kinds)``, which
is a no-op without an active mesh or on a plain tensor (CPU tests, one
device) and ``DTensor.redistribute`` to the kinds' placements on a DTensor
under a mesh, where the JAX package takes ``with_sharding_constraint``.
DTensor propagates a layout op by op; these anchors pin the residual
stream's to the batch axes where propagation would leave it elsewhere.

A kind degrades to replication on a dim it does not divide (``_maybe``, as
the JAX package's): DTensor's uneven sharding would give another layout.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional

from repro_torch.launch.mesh import axis_sizes, batch_axes

_MESH = None
# residual-stream (B, S, D) anchor: dim kinds per axis.  Default shards the
# batch; decode under 2-D tensor-parallel serving may shard d_model instead.
_TOKEN_SPEC: tuple = ("batch", None, None)
# also anchor the residual after every sub-block (attention and MLP)
_MID_ANCHORS: bool = False
# expert-parallel MoE (models.moe.moe_apply_ep)
_EP: bool = False
# sequence-shard attention scores when q-heads do not divide the model axis
_ATTN_SEQ: bool = False


def set_mesh(mesh, token_spec: tuple = ("batch", None, None), mid_anchors: bool = False,
             ep: bool = False, attn_seq: bool = False):
    global _MESH, _TOKEN_SPEC, _MID_ANCHORS, _EP, _ATTN_SEQ
    _MESH = mesh
    _TOKEN_SPEC = token_spec
    _MID_ANCHORS = mid_anchors
    _EP = ep
    _ATTN_SEQ = attn_seq


def ep_enabled() -> bool:
    return _EP and _MESH is not None


def attn_seq_enabled() -> bool:
    return _ATTN_SEQ and _MESH is not None


def get_mesh():
    return _MESH


@contextmanager
def use_mesh(mesh, token_spec: tuple = ("batch", None, None), mid_anchors: bool = False,
             ep: bool = False, attn_seq: bool = False):
    """The mesh and flags for the block; DTensors and plain tensors mix
    inside it, a plain one taken as replicated (DTensor's
    ``implicit_replication``: positions, masks and other tensors the models
    make from shapes)."""
    from torch.distributed.tensor.experimental import implicit_replication

    prev = (_MESH, _TOKEN_SPEC, _MID_ANCHORS, _EP, _ATTN_SEQ)
    set_mesh(mesh, token_spec, mid_anchors, ep, attn_seq)
    try:
        with implicit_replication():
            yield
    finally:
        set_mesh(*prev)


def _maybe(mesh, dim: int, axes):
    if axes is None:
        return None
    names = (axes,) if isinstance(axes, str) else axes
    sizes = axis_sizes(mesh)
    return axes if dim % math.prod(sizes[a] for a in names) == 0 else None


def spec_for(mesh, shape, *dim_kinds: Optional[str]) -> tuple:
    """The spec (``sharding.param_spec``'s form) of ``dim_kinds`` on
    ``shape``: "batch" | "model" | "data" | "pod" | None a dim."""
    spec = []
    for i, kind in enumerate(dim_kinds):
        if kind == "batch":
            spec.append(_maybe(mesh, shape[i], batch_axes(mesh)))
        elif kind in ("model", "data"):
            spec.append(_maybe(mesh, shape[i], kind))
        elif kind == "pod":
            spec.append(_maybe(mesh, shape[i], "pod") if "pod" in mesh.mesh_dim_names else None)
        else:
            spec.append(None)
    return tuple(spec)


def constrain(x, *dim_kinds: Optional[str]):
    """Redistribute a DTensor to ``dim_kinds``' layout; a no-op without a
    mesh or on a plain tensor."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import placements

    mesh = _MESH
    if mesh is None or not isinstance(x, DTensor):
        return x
    want = placements(spec_for(mesh, x.shape, *dim_kinds), mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def constrain_tokens(x):
    """Residual stream (B, S, D): anchored per the active token spec."""
    return constrain(x, *_TOKEN_SPEC)


def constrain_mid(x):
    """Sub-block residual anchor (only with ``mid_anchors``)."""
    if not _MID_ANCHORS:
        return x
    return constrain(x, *_TOKEN_SPEC)


def constrain_logits(x):
    """(B, S, V): batch over data axes, vocab over model."""
    return constrain(x, "batch", None, "model")
