"""Per-device flops, memory traffic, collective bytes and live memory of one
step (the counterpart of the JAX package's ``launch/hlo_analysis.py``).

There is no HLO in PyTorch.  ``CostMode`` is a ``TorchDispatchMode`` that
sees every aten op one device runs inside it: under a DTensor mesh it
steps aside for each DTensor op (``NotImplemented``), so that it counts the
local ops DTensor then runs on the device's shards, and the collectives
DTensor emits, all per device; the ops DTensor's sharding propagator runs
on meta tensors to infer a shape are not counted.  On "meta" (the dry
run) nothing runs, and the fake process group's collectives move
nothing, but every op's shapes are those of the real run.  It accumulates:

  * matmul flops   : hlo_analysis's dot rule, 2 * prod(out) *
                     prod(contracting dims), over mm, bmm, addmm, baddbmm
                     and convolutions, plus the flops a hand-written
                     kernel's wrapper reports while it runs on meta
                     (``kernels/_mesh.py``: ``flash_attention``,
                     ``ssd_chunk`` and their backwards);
  * "HBM" bytes    : each op's operand plus output bytes (views, detaches,
                     empty allocations and collectives' waits are free); a
                     kernel's its wrapper's count of the bytes it must
                     move.  PyTorch fuses nothing here, so this overstates
                     XLA's fusion-aware count;
  * collective bytes by kind (all-gather / all-reduce / reduce-scatter /
                     all-to-all / broadcast), at their output bytes, from
                     the ``_c10d_functional`` ops DTensor emits and the
                     ``c10d`` ops of ``torch.distributed`` calls;
  * a live-bytes high-water mark: each op's new output counted from when it
                     is made to when its tensor is freed, the counterpart
                     of ``memory_analysis()``'s temp bytes (the step's
                     arguments, live before it, are not in it).

The top lists are labelled with the innermost frame of the port's code
(``models/layers.py:123 mha``): the models reach their ``nn.Module``s'
weights from plain functions, not through ``forward`` calls, so no module
hook sees where an op runs, and a source frame is the provenance JAX's
``op_name`` gives.
"""
from __future__ import annotations

import math
import sys
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import _mesh

_KIND = (("all_gather", "all-gather"), ("allgather", "all-gather"),
         ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
         ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
         ("broadcast", "broadcast"))
_FREE = {"view", "_unsafe_view", "alias", "as_strided", "detach", "expand", "permute",
         "transpose", "t", "unsqueeze", "squeeze", "select", "slice", "split", "split_with_sizes",
         "unbind", "chunk", "empty", "empty_like", "empty_strided", "new_empty", "wait_tensor",
         "lift_fresh", "_to_copy_meta", "unflatten", "view_as", "narrow", "diagonal", "real",
         "imag", "_reshape_alias", "set_", "resize_"}
_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "_scaled_mm"}
_TOP = 40
_SRC = "repro_torch"
_SKIP = ("kernels/_mesh.py", "launch/cost_analysis.py")


def shape_bytes(t) -> int:
    """Bytes of a tensor (a meta one's too)."""
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _label() -> str:
    """The innermost frame of the port's own code, not this module's nor a
    kernel wrapper's mesh plumbing."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if _SRC in name and not name.endswith(_SKIP):
            return f"{name.split(_SRC + '/')[-1]}:{f.f_lineno} {f.f_code.co_name}"
        f = f.f_back
    return "?"


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagator is running this op on meta
    tensors to infer an output's shape (on a cache miss; nothing the
    device would run)."""
    f = sys._getframe(2)
    for _ in range(10):
        if f is None:
            return False
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _dot_flops(name: str, args, out) -> float:
    if name in ("mm", "bmm", "_scaled_mm"):
        a = args[0]
    elif name in ("addmm", "baddbmm", "addbmm"):
        a = args[1]
    else:
        return 0.0
    return 2.0 * out.numel() * a.shape[-1] if name != "addbmm" else (
        2.0 * out.numel() * a.shape[-1] * a.shape[0])


def _conv_flops(args, out) -> float:
    w = args[1]
    return 2.0 * out.numel() * math.prod(w.shape[1:])


@dataclass
class Costs:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_count: Dict[str, int] = field(default_factory=dict)
    kernel_flops: Dict[str, float] = field(default_factory=dict)
    kernel_calls: Dict[str, int] = field(default_factory=dict)
    high_water_bytes: float = 0.0
    ops: int = 0
    # (bytes or flops, kind, label): the largest contributions, summed by
    # kind and line
    top_collectives: List[tuple] = field(default_factory=list)
    top_hbm: List[tuple] = field(default_factory=list)
    top_flops: List[tuple] = field(default_factory=list)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


class CostMode(TorchDispatchMode):
    """Counts one device's costs of the ops run inside it (see the
    module's docstring); ``costs`` holds them."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self._live = 0
        self._hbm = defaultdict(float)
        self._coll = defaultdict(float)
        self._flops = defaultdict(float)

    def __enter__(self):
        self._observer = _mesh.observe(self._kernel)
        self._observer.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._observer.__exit__(*exc)
        c = self.costs
        c.top_hbm = sorted(((b, k) + (lab,) for (k, lab), b in self._hbm.items()),
                           reverse=True)[:_TOP]
        c.top_collectives = sorted(((b, k) + (lab,) for (k, lab), b in self._coll.items()),
                                   reverse=True)[:_TOP]
        c.top_flops = sorted(((f, k) + (lab,) for (k, lab), f in self._flops.items()),
                             reverse=True)[:_TOP]
        return out

    def _kernel(self, kernel: str, flops: float, bytes_moved: float) -> None:
        c = self.costs
        c.flops += flops
        c.hbm_bytes += bytes_moved
        c.kernel_flops[kernel] = c.kernel_flops.get(kernel, 0.0) + flops
        c.kernel_calls[kernel] = c.kernel_calls.get(kernel, 0) + 1
        label = _label()
        self._hbm[(kernel, label)] += bytes_moved
        self._flops[(kernel, label)] += flops

    def _track(self, t: torch.Tensor) -> None:
        n = shape_bytes(t)
        self._live += n
        self.costs.high_water_bytes = max(self.costs.high_water_bytes, self._live)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self._live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            return out
        c = self.costs
        c.ops += 1
        name = func._opname
        ns = func.namespace
        outs = _tensors(out)
        if ns in ("_c10d_functional", "c10d", "c10d_functional"):
            kind = next((k for key, k in _KIND if key in name), None)
            if kind is not None:
                b = sum(shape_bytes(t) for t in outs)
                c.collective_bytes[kind] = c.collective_bytes.get(kind, 0.0) + b
                c.collective_count[kind] = c.collective_count.get(kind, 0) + 1
                self._coll[(kind, _label())] += b
                if ns == "_c10d_functional":
                    for t in outs:
                        self._track(t)
            return out
        if name in _FREE:
            return out
        flops = 0.0
        if name in _MATMULS:
            flops = _dot_flops(name, args, outs[0])
        elif name in ("convolution", "_convolution"):
            flops = _conv_flops(args, outs[0])
        if flops:
            c.flops += flops
            self._flops[(name, _label())] += flops
        ins = _tensors((args, kwargs))
        b = sum(shape_bytes(t) for t in ins) + sum(shape_bytes(t) for t in outs)
        c.hbm_bytes += b
        self._hbm[(name, _label())] += b
        for t in outs:  # an in-place op returns its operand: nothing new
            if t._base is None and not any(t is x for x in ins):
                self._track(t)
        return out


def analyze(fn, *args, **kwargs):
    """(fn(*args, **kwargs), its ``Costs``) on one device."""
    with CostMode() as mode:
        out = fn(*args, **kwargs)
    return out, mode.costs
