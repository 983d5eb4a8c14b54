"""Checkpoints of arbitrary trees (parameters, optimizer states, data
cursors) with async writes and integrity metadata, in the JAX package's
layout (``repro/checkpoint/checkpointer.py``), so that each package
restores the other's:

    <dir>/step_00000100/
        meta.json            # step, leaf count, shapes, dtypes, sha256
        shard_0.npz          # leaf_00000, leaf_00001, ... (np.savez_compressed)

A tree is a dict (flattened in sorted key order), a tuple, list or
NamedTuple (in order), None (no leaves), or a leaf: a tensor, a numpy array
or a Python / numpy scalar.  The order is the JAX package's
``tree_flatten`` order for the same structure, so a state laid out as the
JAX package lays it out (``models/leaves.py``) gives the same leaf list.
bfloat16 leaves are stored as their uint16 bits with "bfloat16" in meta;
the sha256 runs over every leaf's true-dtype bytes in order.  No
``ml_dtypes`` is needed: bits become ``torch.bfloat16`` by a view.  A
checkpoint is written into a temporary directory and renamed into place.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, List, Optional

import numpy as np
import torch

LEAF_TYPES = (torch.Tensor, np.ndarray, np.generic, int, float, bool)


def _key(i: int) -> str:
    return f"leaf_{i:05d}"


def flatten(tree: Any, is_leaf=lambda _node: False) -> List[Any]:
    """The leaves of ``tree`` in the JAX package's flatten order (a node
    for which ``is_leaf`` holds is a leaf too)."""
    if tree is None:
        return []
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k], is_leaf)]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in flatten(sub, is_leaf)]
    if isinstance(tree, LEAF_TYPES):
        return [tree]
    raise TypeError(f"not a tree node or leaf: {type(tree).__name__}")


def unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree of ``like``'s structure over ``leaves`` (in flatten order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(x) for x in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(like)


def _host(leaf) -> np.ndarray:
    """A host numpy copy of the leaf (the caller may go on updating it
    while the write runs); bfloat16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _restored(arr: np.ndarray, dtype: str, like):
    """``arr`` (stored ``dtype``) as a leaf of ``like``'s kind and type."""
    if isinstance(like, torch.Tensor):
        if dtype == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        dev = like.device if like.device.type != "meta" else "cpu"
        return t.to(device=dev, dtype=like.dtype)
    if dtype == "bfloat16":
        raise TypeError("a bfloat16 leaf restores only into a tensor leaf")
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    return type(like)(arr.item()) if isinstance(like, (int, float, bool)) else arr


class Checkpointer:
    def __init__(self, directory, *, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, *, blocking: bool = False) -> Path:
        """Write ``tree`` as ``step_<step>``.  The leaves are copied to the
        host before this returns; the write runs on a thread unless
        ``blocking`` or the checkpointer is synchronous."""
        leaves = flatten(tree)
        stored = [_host(leaf) for leaf in leaves]
        dtypes = [_dtype_name(leaf, a) for leaf, a in zip(leaves, stored)]
        target = self.dir / f"step_{step:08d}"

        def _write():
            tmp = Path(tempfile.mkdtemp(dir=self.dir, prefix=".tmp_ckpt_"))
            try:
                np.savez_compressed(tmp / "shard_0.npz",
                                    **{_key(i): a for i, a in enumerate(stored)})
                digest = hashlib.sha256()
                for a in stored:  # a bfloat16 leaf's bits are its bytes
                    digest.update(np.ascontiguousarray(a).tobytes())
                meta = {
                    "step": step,
                    "n_leaves": len(stored),
                    "treedef": f"{len(stored)} leaves in jax.tree_util flatten order",
                    "shapes": [list(a.shape) for a in stored],
                    "dtypes": dtypes,
                    "sha256": digest.hexdigest(),
                    "time": time.time(),
                }
                (tmp / "meta.json").write_text(json.dumps(meta))
                if target.exists():
                    shutil.rmtree(target)
                os.replace(tmp, target)  # atomic publish
            finally:
                if tmp.exists():
                    shutil.rmtree(tmp, ignore_errors=True)
            self._gc()

        self.wait()
        if self.async_save and not blocking:
            self._pending = threading.Thread(target=_write, daemon=True)
            self._pending.start()
        else:
            _write()
        return target

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None, *, shardings=None) -> Any:
        """A tree of ``like``'s structure from checkpoint ``step`` (the
        latest by default), each leaf in the type of ``like``'s, a tensor
        leaf on ``like``'s device (the CPU for a "meta" tensor).  Raises
        ``IOError`` when the sha256 disagrees.  ``shardings``: a tree of
        ``distributed.sharding.NamedSharding``s of ``like``'s structure;
        each tensor leaf is then laid out on its mesh as a DTensor (on the
        mesh's device), resharding a checkpoint for a new mesh."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        target = self.dir / f"step_{step:08d}"
        meta = json.loads((target / "meta.json").read_text())
        with np.load(target / "shard_0.npz") as data:
            arrays = [data[_key(i)] for i in range(meta["n_leaves"])]
        digest = hashlib.sha256()
        for a in arrays:
            digest.update(np.ascontiguousarray(a).tobytes())
        if digest.hexdigest() != meta["sha256"]:
            raise IOError(f"checkpoint {target} failed integrity check")
        leaves = flatten(like)
        if len(leaves) != len(arrays):
            raise ValueError(f"checkpoint has {len(arrays)} leaves; target needs {len(leaves)}")
        out = [_restored(a, dt, tgt) for a, dt, tgt in zip(arrays, meta["dtypes"], leaves)]
        if shardings is not None:
            from torch.distributed.tensor import distribute_tensor

            shs = flatten(shardings, is_leaf=lambda n: hasattr(n, "placements"))
            if len(shs) != len(out):
                raise ValueError(f"{len(shs)} shardings for {len(out)} leaves")
            out = [distribute_tensor(t.to(sh.mesh.device_type), sh.mesh, sh.placements)
                   if isinstance(t, torch.Tensor) else t for t, sh in zip(out, shs)]
        return unflatten(like, out)
