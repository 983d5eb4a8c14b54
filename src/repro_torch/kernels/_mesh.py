"""The kernels' wrappers under a device mesh and on "meta".

Under a mesh (``distributed/ctx.py``) a model hands a kernel's wrapper
DTensors.  The kernels take raw data pointers, so no DTensor reaches them:
the wrapper runs through ``local_map``, batch over the batch axes and
heads over "model", and each device's hand-written kernel (forward and
backward) works on its own shard.

Heads whose group does not divide the model axis.  Query head h reads KV
head (or B/C group) h // G, G = H / K.  When K divides the model axis the
local heads read their own K / tp groups.  Otherwise (llama3-405b's 8 KV
heads on 16 model ranks, mamba2's one group) the groups are replicated
over "model" and each rank selects the ones its heads read
(``local_groups``): a rank's n = H / tp heads starting at a = rank * n
read groups a // G ... (a + n - 1) // G.  When n is a multiple of G (and so
is a) those are n / G whole groups; when G is a multiple of n, one group
serves all n heads; otherwise each head gets its own copy of its group.
The gradient of a replicated group is then a partial sum over "model"
(``in_grad_placements``), which DTensor reduces.  When the query heads do
not divide the model axis either, every rank runs every head.

On "meta" (the dry run) a wrapper returns its outputs' shapes, runs
nothing, and tells ``observe``'s observers the work the kernel would do
(its flops and the bytes it must move), which ``launch/cost_analysis.py``
counts.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch

_OBSERVERS: list = []


@contextmanager
def observe(fn):
    """Call ``fn(kernel, flops, bytes)`` for every kernel call on "meta"
    in the block."""
    _OBSERVERS.append(fn)
    try:
        yield
    finally:
        _OBSERVERS.remove(fn)


def note(kernel: str, flops: float, bytes_moved: float) -> None:
    for fn in list(_OBSERVERS):
        fn(kernel, float(flops), float(bytes_moved))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def replicated(t, mesh):
    """A plain tensor as a DTensor replicated on ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _axis(mesh, name: str) -> int:
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get(name, 1)


def _batch_entry(mesh, B: int):
    axes = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    return axes if axes and B % math.prod(_axis(mesh, a) for a in axes) == 0 else None


def local_groups(H: int, K: int, tp: int, rank: int):
    """(index of the groups a rank's heads read, in order; the heads each
    of those serves) for query heads sharded over ``tp`` ranks and K
    groups replicated: see the module's docstring."""
    n, G = H // tp, H // K
    a = rank * n
    if n % G == 0:
        return torch.arange(a // G, a // G + n // G), G
    if G % n == 0:
        return torch.tensor([a // G]), n
    return torch.arange(a, a + n) // G, 1


def head_layout(mesh, B: int, H: int, K: int):
    """The layout a head-parallel kernel call takes on ``mesh``: (q's
    spec over (B, S, H, ...), the groups' spec over (B, S, K, ...), whether
    each rank selects its groups from replicated ones)."""
    batch = _batch_entry(mesh, B)
    tp = _axis(mesh, "model")
    heads = "model" if "model" in mesh.mesh_dim_names and H % tp == 0 else None
    groups = "model" if heads and K % tp == 0 else None
    return (batch, None, heads), (batch, None, groups), bool(heads) and not groups


def local_call(fn, mesh, operands, specs, grad_specs, out_specs):
    """``fn`` on each device's shards of the DTensor ``operands`` (laid out
    by ``specs``, redistributed to them first), its outputs DTensors laid
    out by ``out_specs``; ``grad_specs`` are the operands' gradients'
    layouts, where a replicated operand is read in part on each rank
    ("partial" entries: summed over "model")."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import placements

    def pl(spec):
        return placements(spec, mesh)

    def grad_pl(spec, grad):
        if grad != "partial":
            return pl(spec)
        return [Partial() if a == "model" else p
                for a, p in zip(mesh.mesh_dim_names, placements(spec, mesh))]

    outs = tuple(pl(s) for s in out_specs)
    return local_map(fn, out_placements=outs if len(outs) > 1 else outs[0],
                     in_placements=tuple(pl(s) for s in specs),
                     in_grad_placements=tuple(grad_pl(s, g) for s, g in zip(specs, grad_specs)),
                     device_mesh=mesh, redistribute_inputs=True)(*operands)
