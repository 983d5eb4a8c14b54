"""The JAX package's parameter layout, for checkpoints and optimizer state
that both packages read.

The JAX package keeps a model's parameters as a nested dict whose layer
stacks (``layers``, ``dense_layers``, ``enc_layers``, ``dec_layers``)
carry a leading layer dim, and flattens it with dict keys sorted; the
hybrid family's heterogeneous ``blocks`` are a tuple of unstacked dicts.
This package keeps one tensor a layer under ``nn.Module`` names.  A name
maps to a leaf path and a layer:

    "layers.3.attn.wq"  -> (("layers", "attn", "wq"), 3)
    "blocks.3.rec.wx"   -> (("blocks", 3, "rec", "wx"), None)  # a tuple entry
    "embed.lm_head"     -> (("lm_head",), None)      # top level: last part

and ``stacked`` / ``unstack_into`` move between the two.  Paths sort as
the JAX package's flatten order does (tuple order is the nested sorted
order; a tuple's index sorts as an int, as the tuple flattens in order).
``nest`` makes a block tuple a dict keyed by the int index, which flattens
in the same order.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple, Union

import torch

STACKS = ("layers", "dense_layers", "enc_layers", "dec_layers")  # stacked on a leading dim
TUPLES = ("blocks",)  # a tuple of unstacked per-layer dicts
Path = Tuple[Union[str, int], ...]


def leaf_of(name: str) -> Tuple[Path, Optional[int]]:
    """The JAX leaf path of parameter ``name`` and its layer (None for a
    leaf that is not stacked)."""
    parts = name.split(".")
    if parts[0] in STACKS:
        return (parts[0], *parts[2:]), int(parts[1])
    if parts[0] in TUPLES:
        return (parts[0], int(parts[1]), *parts[2:]), None
    return (parts[-1],), None


def groups(names: Iterable[str]) -> Dict[Path, List[str]]:
    """{path: the parameter names of that leaf, in layer order}, in the JAX
    package's flatten order."""
    out: Dict[Path, Dict[int, str]] = {}
    for name in names:
        path, layer = leaf_of(name)
        out.setdefault(path, {})[-1 if layer is None else layer] = name
    return {path: [by_layer[i] for i in sorted(by_layer)] for path, by_layer in sorted(out.items())}


def is_stacked(path: Path) -> bool:
    return path[0] in STACKS


def stacked(named: Dict[str, torch.Tensor]) -> Dict[Path, torch.Tensor]:
    """{path: leaf}: the tensors of a stacked leaf stacked on a new leading
    dim (a copy), the others as they are."""
    return {path: torch.stack([named[n] for n in names]) if is_stacked(path) else named[names[0]]
            for path, names in groups(named).items()}


@torch.no_grad()
def unstack_into(leaves: Dict[Path, torch.Tensor], named: Dict[str, torch.Tensor]) -> None:
    """Copy each leaf (or its layer slices) into the tensors of ``named``,
    in place, converting type and device."""
    for path, names in groups(named).items():
        leaf = leaves[path]
        if is_stacked(path):
            if leaf.shape[0] != len(names):
                raise ValueError(f"{'/'.join(path)}: {leaf.shape[0]} layers, model has "
                                 f"{len(names)}")
            for i, n in enumerate(names):
                named[n].copy_(leaf[i])
        else:
            named[names[0]].copy_(leaf)


def nest(flat: Dict[Path, object]) -> dict:
    """{("a", "b"): x} -> {"a": {"b": x}}."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def flat(tree: dict, prefix: Path = ()) -> Dict[Path, object]:
    """The inverse of ``nest``, in sorted key order."""
    out: Dict[Path, object] = {}
    for key in sorted(tree):
        sub = tree[key]
        if isinstance(sub, dict):
            out.update(flat(sub, prefix + (key,)))
        else:
            out[prefix + (key,)] = sub
    return out
