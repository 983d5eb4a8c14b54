"""Sharding rules: parameter, optimizer, cache and batch layouts per mode
(the JAX package's ``distributed/sharding.py``), as DTensor placements.

Modes
-----
* ``train``      — ZeRO-style FSDP + TP: matmul weights shard
                   (second-to-last dim over the batch axes, last over
                   "model"); optimizer states follow params.
* ``serve_tp``   — inference TP: column-parallel weights shard their output
                   dim over "model", row-parallel their input dim; experts
                   shard over "model" (EP).
* ``serve_2d``   — big-model serving: TP plus the other matmul dim over the
                   batch axes.  Picked by ``serve_mode_for``.

A rule's result is a spec: a tuple with one entry a tensor dim, each entry
None (replicated), an axis name, or a tuple of axis names (the dim split
over those axes, the first the outer one), as JAX's ``PartitionSpec``;
``placements`` turns it into one DTensor placement a mesh dim.  Every rule
degrades to replication when a dim does not divide the axis size
(``_maybe``), so every (arch x mesh) pair places evenly: DTensor's uneven
sharding would give another layout.

The rules read leaf names from the JAX package's layout (``models/
leaves.py``): a tree whose layer stacks carry a leading layer dim, as
``registry.params_spec`` builds it, so a stacked expert weight has ndim 4
and a stacked norm ndim 2, as under JAX's ``_names_of``.  They read a
mesh's axis names and sizes alone, so an ``AbstractMesh`` takes a
``DeviceMesh``'s place wherever nothing is placed.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.launch.mesh import axis_sizes, batch_axes

# weights whose LAST dim is the parallel (output) dim under TP
_COL_PARALLEL = {
    "wq", "wk", "wv", "wg", "wi", "wkv_a", "wkv_b", "in_proj", "wx", "wgate",
    "wa",
}
# weights whose FIRST matmul dim is the parallel (input) dim under TP
_ROW_PARALLEL = {"wo", "out_proj"}
_EXPERT_STACKED = 4  # (L, E, d, f)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _maybe(mesh, dim: int, axes):
    """axes if dim divides evenly, else None (replicate).  A one-axis tuple
    unwraps, so that a spec built from ``batch_axes`` equals a written
    one."""
    if axes is None:
        return None
    if dim % _axis_size(mesh, axes) != 0:
        return None
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def serve_mode_for(cfg, mesh) -> str:
    """Choose TP vs 2-D serving sharding from the per-chip footprint."""
    tp = axis_sizes(mesh)["model"]
    per_chip_gb = cfg.n_params() * 2 / tp / 1e9
    return "serve_2d" if per_chip_gb > 6.0 else "serve_tp"


def param_spec(path_names: Tuple[str, ...], shape: Tuple[int, ...], mesh, mode: str) -> tuple:
    name = path_names[-1] if path_names else ""
    fsdp = batch_axes(mesh)
    ndim = len(shape)
    if ndim <= 1 or name in ("conv_w", "conv_b"):
        return ()
    is_expert = name in ("wg", "wi", "wo") and ndim == _EXPERT_STACKED
    spec = [None] * ndim
    if mode == "train":
        if name == "embed":
            # vocab over model only (the JAX package's rule)
            return (_maybe(mesh, shape[0], "model"), None)
        if name == "lm_head":
            return (_maybe(mesh, shape[-2], fsdp), _maybe(mesh, shape[-1], "model"))
        if is_expert:
            spec[1] = _maybe(mesh, shape[1], "model")  # EP for experts
            spec[-1] = _maybe(mesh, shape[-1], fsdp)
        elif name in _ROW_PARALLEL:
            spec[-2] = _maybe(mesh, shape[-2], "model")
            spec[-1] = _maybe(mesh, shape[-1], fsdp)
        else:
            spec[-2] = _maybe(mesh, shape[-2], fsdp)
            spec[-1] = _maybe(mesh, shape[-1], "model")
        return tuple(spec)
    # serving modes
    data = fsdp if mode == "serve_2d" else None
    if name == "embed":
        return (_maybe(mesh, shape[0], "model"), _maybe(mesh, shape[1], data) if data else None)
    if name == "lm_head":
        return (_maybe(mesh, shape[0], data) if data else None, _maybe(mesh, shape[1], "model"))
    if is_expert:
        spec[1] = _maybe(mesh, shape[1], "model")  # experts over model (EP)
    elif name in _ROW_PARALLEL:
        spec[-2] = _maybe(mesh, shape[-2], "model")
        if data:
            spec[-1] = _maybe(mesh, shape[-1], data)
    elif name in _COL_PARALLEL or name == "router":
        spec[-1] = _maybe(mesh, shape[-1], "model")
        if data:
            spec[-2] = _maybe(mesh, shape[-2], data)
    else:
        spec[-1] = _maybe(mesh, shape[-1], "model")
    return tuple(spec)


def placements(spec: tuple, mesh) -> list:
    """One DTensor placement a mesh dim: ``Shard(i)`` where the spec puts
    that axis on tensor dim i, else ``Replicate()``.  A tuple entry shards
    its dim over each of its axes, the first the outer split; the rules
    build such tuples in the mesh's order (``batch_axes``), which is the
    order DTensor splits a dim sharded on several mesh dims."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {}
    for i, entry in enumerate(spec):
        for axis in (entry,) if isinstance(entry, str) else (entry or ()):
            dim_of[axis] = i
    return [Shard(dim_of[a]) if a in dim_of else Replicate() for a in mesh.mesh_dim_names]


class NamedSharding(NamedTuple):
    """A mesh and a spec: how one leaf is laid out."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def _names(key) -> tuple:
    return tuple(str(k) for k in key) if isinstance(key, tuple) else (str(key),)


def tree_map_with_names(fn, tree, names: tuple = ()):
    """``fn(names, leaf)`` over a tree of dicts (a tuple key contributes
    each of its parts, as a JAX path would), named tuples (their field
    names), lists and tuples (their indices); the same structure back.  A
    leaf is anything else: a tensor, or a python int (a step, a cache's
    position) or a ``NamedSharding``."""
    if isinstance(tree, NamedSharding):
        return fn(names, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_names(fn, v, names + _names(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_names(fn, getattr(tree, f), names + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_names(fn, v, names + (str(i),))
                          for i, v in enumerate(tree))
    return fn(names, tree)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


def params_shardings(params_tree, mesh, mode: str):
    """A ``NamedSharding`` a leaf of ``params_tree`` (meta trees too)."""
    return tree_map_with_names(
        lambda names, leaf: NamedSharding(mesh, param_spec(names, _shape(leaf), mesh, mode)),
        params_tree)


def opt_shardings(opt_state_tree, mesh, mode: str = "train"):
    """Optimizer states (mu/nu) mirror the param rules; scalars replicate."""
    def f(names, leaf):
        shape = _shape(leaf)
        return NamedSharding(mesh, param_spec(names, shape, mesh, mode) if shape else ())

    return tree_map_with_names(f, opt_state_tree)


# ------------------------------------------------------------ data / cache
def batch_sharding(batch_tree, mesh):
    """Shard the leading (batch) dim of every input over the batch axes."""
    fsdp = batch_axes(mesh)

    def f(_names, leaf):
        shape = _shape(leaf)
        if not shape:
            return NamedSharding(mesh, ())
        return NamedSharding(mesh, (_maybe(mesh, shape[0], fsdp),) + (None,) * (len(shape) - 1))

    return tree_map_with_names(f, batch_tree)


def cache_sharding(cache_tree, mesh, *, seq_axis_by_len: bool = True):
    """KV / state cache sharding for decode.

    Layout per leaf (L, B, T, ...):
      * B over the batch axes when divisible;
      * the longest remaining dim (sequence T for KV, heads or width for
        an SSM state) over "model" when divisible (the first of equals).
    Scalars (the position) replicate.
    """
    fsdp = batch_axes(mesh)

    def f(_names, leaf):
        shape = _shape(leaf)
        if not shape:
            return NamedSharding(mesh, ())
        spec = [None] * len(shape)
        b_dim = 1 if len(shape) >= 2 else 0
        spec[b_dim] = _maybe(mesh, shape[b_dim], fsdp)
        cand = [i for i in range(len(shape)) if i > b_dim]
        if cand:
            i_big = max(cand, key=lambda i: shape[i])
            spec[i_big] = _maybe(mesh, shape[i_big], "model")
        return NamedSharding(mesh, tuple(spec))

    return tree_map_with_names(f, cache_tree)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def distribute(tree, shardings, *, requires_grad: bool = False):
    """Each tensor leaf of ``tree`` as a DTensor laid out by its
    ``NamedSharding`` (``shardings`` has ``tree``'s structure and a
    ``DeviceMesh`` in each); a non-tensor leaf as it is.  Every rank holds
    the whole tree and keeps its own shard of each leaf, with no
    communication; a shard that is the whole leaf shares its storage (no
    copy: a card of one holds a model's state once)."""
    from torch.distributed.tensor import DTensor

    flat_sh = {}
    tree_map_with_names(lambda names, sh: flat_sh.setdefault(names, sh), shardings)

    def f(names, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        sh = flat_sh[names]
        pls = sh.placements
        coord = sh.mesh.get_coordinate()
        local = leaf.detach()
        for mesh_dim, pl in enumerate(pls):  # the first mesh dim the outer split
            if pl.is_shard():
                n = sh.mesh.size(mesh_dim)
                size = local.shape[pl.dim] // n
                local = local.narrow(pl.dim, coord[mesh_dim] * size, size)
        out = DTensor.from_local(local.contiguous(), sh.mesh, pls, run_check=False,
                                 shape=leaf.shape, stride=leaf.stride())
        return out.requires_grad_(True) if requires_grad else out

    return tree_map_with_names(f, tree)


def local_bytes(tree) -> int:
    """Bytes one device holds of a tree's tensor leaves (a DTensor's local
    shard, a plain tensor whole)."""
    from torch.distributed.tensor import DTensor

    total = 0

    def f(_names, leaf):
        nonlocal total
        if isinstance(leaf, torch.Tensor):
            t = leaf.to_local() if isinstance(leaf, DTensor) else leaf
            total += t.numel() * t.element_size()

    tree_map_with_names(f, tree)
    return total
