"""Host-side scoring around the ``cascade_score`` kernel.

``CascadeScorer`` packs a plan's proxies once, keeps the operands on its
device, and scores numpy record tiles through ``cascade_score``: one launch
yields every stage's keep mask plus on-device-compacted survivor lists.
Host fetches (``.cpu()``) live here, never in ``proxy_score.py``.
"""
from __future__ import annotations

import hashlib
import weakref

import numpy as np
import torch

from repro_torch.core.proxy_family import (
    cascade_kernel_operands,
    family_of,
    pack_cascade,
    quantize_cascade,
)
from repro_torch.kernels.proxy_score import cascade_score
from repro_torch.training.proxy_models import PackedProxy
from repro_torch.util import resolve_device

# Packing (standardizer fold + lowering to the depth-1 MLP form) is pure
# per parameter set.  Params compare and hash by identity, and these caches
# hold them weakly: an entry lives exactly as long as its params object, so
# no recycled identity can alias a stale entry.
_PACK_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_OPERAND_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def pack_proxy_cached(params) -> PackedProxy:
    """Memoized ``family_of(params).pack``: repeated scoring of the same
    proxy packs once.  ``PackedProxy`` params are already packed."""
    if isinstance(params, PackedProxy):
        return params
    packed = _PACK_CACHE.get(params)
    if packed is None:
        packed = family_of(params).pack(params)
        _PACK_CACHE[params] = packed
    return packed


def _to_device(arrays, dev: torch.device):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)


def _kernel_operands_cached(params, dev: torch.device):
    """Device-resident (w1, b1, w2, b2) for a single proxy, per device."""
    per_params = None if isinstance(params, PackedProxy) else _OPERAND_CACHE.get(params)
    ops = None if per_params is None else per_params.get(str(dev))
    if ops is None:
        ops = _to_device(cascade_kernel_operands(
            pack_cascade([params], pack_fn=pack_proxy_cached)), dev)
        if not isinstance(params, PackedProxy):
            _OPERAND_CACHE.setdefault(params, {})[str(dev)] = ops
    return ops


def proxy_score_batch(params, x, threshold: float, *, device="cuda") -> np.ndarray:
    """Single-proxy keep mask (the per-stage kernel path), any family."""
    dev = resolve_device(device)
    w1, b1, w2, b2 = _kernel_operands_cached(params, dev)
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    thr = torch.tensor([threshold], dtype=torch.float32, device=dev)
    _scores, mask, _pk, _cnt = cascade_score(
        xt, w1, b1, w2, b2, thr, x.shape[0], with_scores=False, with_compaction=False)
    return mask[:, 0].cpu().numpy()


class CascadeScorer:
    """Whole-cascade fused scorer, every proxy family.

    Packs every stage's params ONCE at construction via the family
    registry (standardizers folded, the cascade stacked into bucket-padded
    ``(F, H, P)`` arrays, optionally quantized), uploads the kernel
    operands to ``device``, and scores record tiles through
    ``cascade_score``.  Input tiles are zero-padded to a geometric ladder
    of row counts starting at ``block_m`` (so a handful of shapes recur);
    batches larger than ``max_tile`` are chunked.
    """

    def __init__(self, param_list, thresholds, *, block_m: int = 256,
                 max_tile: int = 8192, dtype: str = "float32", packed=None,
                 device="cuda"):
        if not param_list:
            raise ValueError("CascadeScorer needs at least one proxy")
        self.device = resolve_device(device)
        if packed is None:
            packed = pack_cascade(list(param_list), pack_fn=pack_proxy_cached)
            if dtype != "float32":
                packed = quantize_cascade(packed, dtype)
        self.packed = packed
        self.dtype = packed.dtype
        self.w1, self.b1, self.w2, self.b2 = _to_device(
            cascade_kernel_operands(self.packed), self.device)
        self.out_scale = (None if self.packed.out_scale is None
                          else _to_device([self.packed.out_scale], self.device)[0])
        self.thr = torch.tensor(np.asarray(thresholds, np.float32), device=self.device)
        self.families = self.packed.families
        self.n_proxies = len(param_list)
        self.n_features = int(self.w1.shape[0])
        self.block_m = min(block_m, max_tile)
        buckets = []
        size = self.block_m
        while size < max_tile:
            buckets.append(size)
            size *= 2
        buckets.append(max_tile)
        self.buckets = tuple(buckets)
        self.max_tile = max_tile
        # stage index -> proxy column (filled by from_plan; identity default)
        self.stage_cols = list(range(self.n_proxies))

    @classmethod
    def from_plan(cls, plan, **kw):
        """Scorer over ALL of the plan's proxied stages (any family), or
        None when no stage carries a proxy.  ``scorer.stage_cols[si]`` maps
        stage index to its proxy column (None for proxy-less stages).  A
        plan stamped with ``meta["quant_dtype"]`` builds its scorer at that
        weight dtype unless the caller overrides."""
        kw.setdefault("dtype", plan.meta.get("quant_dtype", "float32"))
        params, thrs, cols = [], [], []
        for stage in plan.stages:
            if stage.proxy is not None:
                cols.append(len(params))
                params.append(stage.proxy.params)
                thrs.append(stage.threshold)
            else:
                cols.append(None)
        if not params:
            return None
        scorer = cls(params, thrs, **kw)
        scorer.stage_cols = cols
        return scorer

    def covers_all(self, plan) -> bool:
        """Every proxied stage has a column (the packed format covers every
        registered family; kept as an API invariant check)."""
        return all(
            col is not None
            for col, stage in zip(self.stage_cols, plan.stages)
            if stage.proxy is not None
        )

    def _bucket(self, n: int) -> int:
        for size in self.buckets:
            if n <= size:
                return size
        return self.max_tile

    def _pad_tile(self, x_tile: np.ndarray) -> torch.Tensor:
        """Zero-pad to the ladder bucket and upload."""
        n = x_tile.shape[0]
        bucket = self._bucket(n)
        if n < bucket:
            xp = np.zeros((bucket, x_tile.shape[1]), np.float32)
            xp[:n] = x_tile
        else:
            xp = np.ascontiguousarray(x_tile, np.float32)
        return torch.from_numpy(xp).to(self.device)

    def _score_tile(self, x_tile: np.ndarray, need_scores: bool,
                    need_compaction: bool = True, compact_cols=None):
        n = x_tile.shape[0]
        scores, mask, packed, counts = cascade_score(
            self._pad_tile(x_tile), self.w1, self.b1, self.w2, self.b2, self.thr, n,
            out_scale=self.out_scale, block_m=self.block_m,
            with_scores=need_scores, with_compaction=need_compaction,
            compact_cols=compact_cols,
        )
        return (scores[:n].cpu().numpy() if need_scores else None,
                mask[:n].cpu().numpy(),
                packed.cpu().numpy() if need_compaction else None,
                counts.cpu().numpy() if need_compaction else None)

    def score_compact(self, x: np.ndarray, *, need_scores: bool = False,
                      compact_cols=None):
        """Score every stage over ``x`` (N, F) in one fused pass per tile.

        Returns (scores (N, P) | None, masks (N, P), packed, counts) where
        ``packed[p][:counts[p]]`` are the ascending row indices surviving
        stage p's proxy gate.  ``compact_cols`` restricts survivor-list
        assembly to the named proxy columns; unassembled entries of
        ``packed`` are None.  ``counts`` covers every column either way.
        """
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        cols_sel = (tuple(range(self.n_proxies)) if compact_cols is None
                    else tuple(int(c) for c in compact_cols))
        kernel_cols = None if compact_cols is None else cols_sel
        if n <= self.max_tile:
            scores, masks, packed, counts = self._score_tile(
                x, need_scores, compact_cols=kernel_cols)
            out = [None] * self.n_proxies
            for ci, col in enumerate(cols_sel):
                out[col] = packed[ci, :counts[col]]
            return scores, masks, out, counts
        scores = np.empty((n, self.n_proxies), np.float32) if need_scores else None
        masks = np.empty((n, self.n_proxies), bool)
        parts = {col: [] for col in cols_sel}
        counts = np.zeros(self.n_proxies, np.int32)
        for start in range(0, n, self.max_tile):
            stop = min(start + self.max_tile, n)
            s, m, pk, cnt = self._score_tile(
                x[start:stop], need_scores, compact_cols=kernel_cols)
            if need_scores:
                scores[start:stop] = s
            masks[start:stop] = m
            counts += cnt
            for ci, col in enumerate(cols_sel):
                parts[col].append(pk[ci, :cnt[col]] + start)
        packed = [None] * self.n_proxies
        for col in cols_sel:
            packed[col] = (np.concatenate(parts[col]) if parts[col]
                           else np.empty(0, np.int32))
        return scores, masks, packed, counts

    def score_masks(self, x: np.ndarray) -> np.ndarray:
        """Per-stage keep masks only (N, P), without the compaction
        outputs."""
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        masks = np.empty((n, self.n_proxies), bool)
        for start in range(0, n, self.max_tile):
            stop = min(start + self.max_tile, n)
            _s, mask, _pk, _cnt = self._score_tile(
                x[start:stop], need_scores=False, need_compaction=False)
            masks[start:stop] = mask
        return masks


# --------------------------------------------- scorer cache (plan re-entry)
# Keyed on a CONTENT fingerprint of every stage's packed parameters, never
# on object identity: byte-identical params hit the same entry, and an
# evicted plan's params can be collected.
_SCORER_CACHE: dict = {}
_SCORER_CACHE_MAX = 64


def params_fingerprint(params) -> str:
    """Content digest of one proxy's PACKED parameters (folded depth-1
    form, family-agnostic)."""
    pk = pack_proxy_cached(params)
    h = hashlib.blake2b(digest_size=16)
    h.update(str((pk.hidden,) + tuple(pk.w1.shape)).encode())
    for a in (pk.w1, pk.b1, pk.w2):
        h.update(np.ascontiguousarray(a, np.float32).tobytes())
    h.update(np.float32(pk.b2).tobytes())
    return h.hexdigest()


def _plan_scorer_key(plan, max_tile: int, device: torch.device):
    return tuple(
        (s.pred_idx,
         params_fingerprint(s.proxy.params) if s.proxy is not None else None,
         float(s.threshold))
        for s in plan.stages
    ) + (int(max_tile), str(plan.meta.get("quant_dtype", "float32")), str(device))


def cascade_scorer_for_plan(plan, *, max_tile: int = 8192, device="cuda"):
    """Memoized ``CascadeScorer.from_plan``.  Returns (scorer | None,
    cache_hit); None means the plan has no proxied stage (cached too)."""
    dev = resolve_device(device)
    key = _plan_scorer_key(plan, max_tile, dev)
    if key in _SCORER_CACHE:
        return _SCORER_CACHE[key], True
    scorer = CascadeScorer.from_plan(plan, max_tile=max_tile, device=dev)
    if len(_SCORER_CACHE) >= _SCORER_CACHE_MAX:
        _SCORER_CACHE.pop(next(iter(_SCORER_CACHE)))
    _SCORER_CACHE[key] = scorer
    return scorer, False
