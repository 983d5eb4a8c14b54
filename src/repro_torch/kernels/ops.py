"""Host-side scoring around the ``cascade_score`` kernel and the full SSD
(``ssd``) over the ``ssd_chunk`` kernel.

``CascadeScorer`` packs a plan's proxies once, keeps the operands on its
device, and scores numpy record tiles through the ``cascade_score`` kernel:
one launch yields every stage's keep mask plus on-device-compacted survivor
lists.  On a card each tile goes up in one copy from pinned memory and its
results come back in one copy into pinned memory.  Host fetches live here,
never in ``proxy_score.py``.
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
from repro_torch.kernels import proxy_score
from repro_torch.kernels.proxy_score import cascade_score, cascade_score_plain
from repro_torch.kernels.ssd_scan import ssd_chunk
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


def _align16(n: int) -> int:
    return (n + 15) & ~15


class _TileBuffers:
    """One bucket's buffers for one output layout (C compacted columns or
    None for masks only, with or without scores):

    * ``x``: the device input (rows, F); ``x_host`` its staging copy, pinned
      on a card (on the CPU it is ``x`` itself).  A tile of n rows fills the
      first n; the rows after them keep what an earlier tile left, since the
      kernel masks every row from ``n_valid`` = n out of every output;
    * ``result``: one device buffer ``[counts (P) | packed (C, rows) |
      mask (rows, P) | scores (rows, P)?]``, and ``result_host`` its pinned
      mirror (on the CPU, ``result`` itself), with numpy views cut from it.
    """

    def __init__(self, rows: int, F: int, P: int, C, with_scores: bool,
                 device: torch.device):
        cuda = device.type == "cuda"
        nc = C or 0
        off_packed = 4 * P
        off_mask = off_packed + 4 * nc * rows
        off_scores = _align16(off_mask + rows * P)
        nbytes = off_scores + (4 * rows * P if with_scores else 0)
        self.rows, self.cuda = rows, cuda
        self.x = torch.zeros((rows, F), dtype=torch.float32, device=device)
        self.x_host = (torch.zeros((rows, F), dtype=torch.float32, pin_memory=True)
                       if cuda else self.x)
        self.result = torch.empty(nbytes, dtype=torch.uint8, device=device)
        self.result_host = (torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                            if cuda else self.result)
        self.ready = torch.cuda.Event() if cuda else None

        def views(buf):
            counts = buf[:off_packed].view(torch.int32)
            packed = buf[off_packed:off_mask].view(torch.int32).view(nc, rows)
            mask = buf[off_mask:off_mask + rows * P].view(torch.bool).view(rows, P)
            scores = (buf[off_scores:].view(torch.float32).view(rows, P)
                      if with_scores else None)
            return counts, packed, mask, scores

        self.counts, self.packed, self.mask, self.scores = views(self.result)
        self.host = tuple(None if v is None else v.numpy()
                          for v in views(self.result_host))

    def stage(self, x_tile: np.ndarray) -> None:
        """Copy the tile into ``x_host`` (torch's copy, threaded for a large
        tile), and on a card upload those rows in one copy."""
        n = x_tile.shape[0]
        self.x_host[:n].copy_(torch.from_numpy(x_tile))
        if self.cuda:
            self.x[:n].copy_(self.x_host[:n], non_blocking=True)


class CascadeScorer:
    """Whole-cascade fused scorer, every proxy family.

    Packs every stage's params ONCE at construction via the family
    registry (standardizers folded, the cascade stacked into bucket-padded
    ``(F, H, P)`` arrays, optionally quantized), uploads the kernel
    operands to ``device`` and checks them once, and scores record tiles
    through the ``cascade_score`` kernel (on the CPU, its plain version).
    A tile is scored at the first size of a geometric ladder of row counts
    starting at ``block_m`` that holds it (so a handful of shapes recur),
    each size with its own input and result buffers; batches larger than
    ``max_tile`` are chunked.
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
        self.thr_host = np.asarray(thresholds, np.float32).reshape(-1)
        self.thr = torch.tensor(self.thr_host, device=self.device)
        self.ops = proxy_score.KernelOperands(self.w1, self.b1, self.w2, self.b2, self.thr,
                                              self.out_scale)
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
        self._buffers: dict = {}  # (bucket, C or None, with scores) -> _TileBuffers
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

    @classmethod
    def from_plans(cls, plans, **kw):
        """Stack several plans' proxied stages into ONE packed cascade
        (multi-query serving).  Returns ``(scorer | None, col_maps)`` where
        ``col_maps[qi][si]`` is the stacked scorer's column for plan
        ``qi``'s stage ``si`` (None for proxy-less stages).  Stages whose
        packed params AND threshold are byte-identical (keyed on the content
        fingerprint, never on object identity) share one column, so a
        predicate proxied identically by two queries is scored once.

        The readout is block-diagonal, so a column's score sums only its own
        hidden block; every cross-block term is an exact zero.  Whether the
        sum is bit-identical to the isolated scorer's depends on the route's
        summation order at the wider width, so callers that need bit
        identity measure it.

        The weights' storage dtype is the plans' common ``quant_dtype`` when
        they agree; otherwise float32 (one shared launch must not quantize a
        tenant that asked for full precision).  A None scorer means no plan
        has a proxied stage."""
        params, thrs = [], []
        col_of = {}
        col_maps = []
        for plan in plans:
            cols = []
            for stage in plan.stages:
                if stage.proxy is None:
                    cols.append(None)
                    continue
                key = (params_fingerprint(stage.proxy.params), float(stage.threshold))
                col = col_of.get(key)
                if col is None:
                    col = col_of[key] = len(params)
                    params.append(stage.proxy.params)
                    thrs.append(stage.threshold)
                cols.append(col)
            col_maps.append(cols)
        if not params:
            return None, col_maps
        dtypes = {str(plan.meta.get("quant_dtype", "float32")) for plan in plans}
        kw.setdefault("dtype", dtypes.pop() if len(dtypes) == 1 else "float32")
        scorer = cls(params, thrs, **kw)
        scorer.stage_cols = list(range(len(params)))
        return scorer, col_maps

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

    def _tile_buffers(self, rows: int, C, with_scores: bool) -> _TileBuffers:
        key = (rows, C, with_scores)
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = _TileBuffers(rows, self.n_features, self.n_proxies, C,
                                                    with_scores, self.device)
        return buf

    def _score_tile(self, x_tile: np.ndarray, need_scores: bool,
                    need_compaction: bool = True, compact_cols=None):
        """Score one tile (at most ``max_tile`` rows).  Returns numpy views
        (scores (n, P) | None, mask (n, P), packed (C, bucket) | None,
        counts (P,) | None) into the tile's result buffer: valid until the
        next call with the same bucket and layout."""
        n = x_tile.shape[0]
        cols = (tuple(range(self.n_proxies)) if compact_cols is None
                else tuple(compact_cols)) if need_compaction else None
        C = None if cols is None else len(cols)
        buf = self._tile_buffers(self._bucket(n), C, need_scores)
        buf.stage(x_tile)
        if buf.cuda:
            ptr = proxy_score._ptr
            if cols is None:
                proxy_score.launch(self.ops, buf.x.data_ptr(), buf.rows, n, ptr(buf.scores),
                                   buf.mask.data_ptr())
            else:
                cols_t = proxy_score.cols_tensor(cols, self.device) if cols else None
                proxy_score.launch(self.ops, buf.x.data_ptr(), buf.rows, n, ptr(buf.scores),
                                   buf.mask.data_ptr(), buf.counts.data_ptr(),
                                   buf.packed.data_ptr() if cols else None, ptr(cols_t), C)
            buf.result_host.copy_(buf.result, non_blocking=True)
            buf.ready.record()
            buf.ready.synchronize()
        else:
            s, m, pk, cnt = cascade_score_plain(
                buf.x, self.w1, self.b1, self.w2, self.b2, self.thr, n,
                out_scale=self.out_scale, with_scores=need_scores,
                with_compaction=cols is not None, compact_cols=cols)
            buf.mask.copy_(m)
            if need_scores:
                buf.scores.copy_(s)
            if cols is not None:
                buf.counts.copy_(cnt)
                buf.packed.copy_(pk)
        counts, packed, mask, scores = buf.host
        return (scores[:n] if need_scores else None, mask[:n],
                packed if cols is not None else None, counts if cols is not None else None)

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
                out[col] = packed[ci, :counts[col]].copy()
            return (None if scores is None else scores.copy(), masks.copy(), out,
                    counts.copy())
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

    def score_margins(self, x: np.ndarray):
        """Masks (N, P) plus each record's distance to the NEAREST stage
        threshold, ``min_p |s_p - thr_p|`` (N,): the importance-audit
        signal.  A tile is one pinned upload, one launch with the scores on
        and compaction off, and one fetch; the scores arrive in the copy
        that carries the masks (P x 4 bytes a row), so the min reduction
        runs on the host over the fetched scores, in float32."""
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        masks = np.empty((n, self.n_proxies), bool)
        margins = np.empty(n, np.float32)
        for start in range(0, n, self.max_tile):
            stop = min(start + self.max_tile, n)
            scores, mask, _pk, _cnt = self._score_tile(
                x[start:stop], need_scores=True, need_compaction=False)
            masks[start:stop] = mask
            np.min(np.abs(scores - self.thr_host), axis=1, out=margins[start:stop])
        return masks, margins


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


# ------------------------------------------------------------------- SSD
def ssd(x, dt, A_log, B, C, D, chunk: int):
    """Full SSD forward: the ``ssd_chunk`` kernel for the intra-chunk block,
    then the inter-chunk recurrence and its output term in PyTorch.

    x: (b, s, h, p); dt: (b, s, h) softplus'd timesteps; A_log, D: (h,);
    B, C: (b, s, g, n), h % g == 0 (groups are indexed, never repeated).
    ``s`` must be a multiple of ``chunk``.  Returns (y (b, s, h, p) in x's
    type, final state (b, h, p, n) float32)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {chunk}")
    nc, rep = s // chunk, h // g
    f32 = torch.float32
    A = -torch.exp(A_log.to(f32))
    dA = dt.to(f32) * A[None, None, :]  # (b, s, h)
    xdt = x * dt[..., None].to(x.dtype)
    y_diag, states, chunk_decay = ssd_chunk(
        xdt.reshape(b * nc, chunk, h, p), dA.reshape(b * nc, chunk, h),
        B.reshape(b * nc, chunk, g, n), C.reshape(b * nc, chunk, g, n))
    # inter-chunk recurrence over the nc chunks, in f32 (the JAX package's
    # lax.scan): prev[:, c] is the state entering chunk c
    states = states.view(b, nc, h, p, n)
    chunk_decay = chunk_decay.view(b, nc, h)
    prev = torch.empty_like(states)
    carry = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    for c in range(nc):
        prev[:, c] = carry
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    cum = torch.cumsum(dA.view(b, nc, chunk, h), dim=2)  # (b, nc, Q, h)
    y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", C.to(f32).reshape(b, nc, chunk, g, n),
                         prev.view(b, nc, g, rep, p, n)).reshape(b, nc, chunk, h, p)
    y_off = y_off * torch.exp(cum)[..., None]
    y = (y_diag.view(b, nc, chunk, h, p) + y_off).reshape(b, s, h, p)
    y = y + x.to(f32) * D.to(f32)[None, None, :, None]
    return y.to(x.dtype), carry
