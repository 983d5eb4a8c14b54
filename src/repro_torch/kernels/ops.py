"""Host-side scoring around the ``cascade_score`` kernel, the COREWIRE
scorer artifacts and control frames, and the full SSD (``ssd``) over the
``ssd_chunk`` kernel.

``CascadeScorer`` packs a plan's proxies once, keeps the operands on its
device, and scores numpy record tiles through the ``cascade_score`` kernel:
one launch yields every stage's keep mask plus on-device-compacted survivor
lists.  On a card each tile goes up in one copy from pinned memory and its
results come back in one copy into pinned memory.  Host fetches live here,
never in ``proxy_score.py``.

COREWIRE (``serialize_scorer`` / ``deserialize_scorer``, ``serialize_frame``
/ ``deserialize_frame``) is byte-compatible with the JAX package's: either
package reads what the other wrote and writes it back byte for byte.
"""
from __future__ import annotations

import hashlib
import json
import weakref

import numpy as np
import torch

from repro_torch.core.proxy import ProxyModel, RCurve
from repro_torch.core.proxy_family import (
    PackedCascade,
    cascade_kernel_operands,
    family_of,
    pack_cascade,
    quantize_cascade,
    unpack_cascade,
)
from repro_torch.core.query import PhysicalPlan, PlanStage
from repro_torch.kernels import _mesh, autotune, proxy_score
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
        off_packed, off_mask, off_scores, nbytes = autotune.result_layout(rows, P, C,
                                                                          with_scores)
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
    ``max_tile`` are chunked.  ``block_m=None`` tunes it
    (``autotune.choose_block_m`` on the device's backend, for chunks of
    ``n_rows_hint`` rows, full tiles when None), as the JAX package's
    scorer does; results do not depend on it, only the padding does.
    """

    def __init__(self, param_list, thresholds, *, block_m: int = None,
                 max_tile: int = 8192, dtype: str = "float32", n_rows_hint: int = None,
                 packed=None, device="cuda"):
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
        if block_m is None:
            block_m = autotune.choose_block_m(
                self.n_features, int(self.w1.shape[1]), self.n_proxies, self.dtype,
                n_rows_hint=n_rows_hint, max_tile=max_tile,
                backend=autotune.backend_of(self.device)).block_m
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


# ------------------------------------------------- scorer wire format (v1)
# A scorer artifact carries a plan's stage metadata, its bucket-padded
# packed cascade and its thresholds:
#
#   b"COREWIRE" | u16 version | u16 minor | u64 header_len
#   | header (canonical JSON, utf-8) | concatenated raw array payloads
#
# Every array travels as raw dtype bytes (descriptors in the header) and
# scalar floats as JSON (float64 round-trips exactly), so deserializing
# then serializing reproduces the bytes, and the receiver's scorer computes
# the sender's masks.  Deserialized plans carry ``packed1`` proxies: the
# folded form is what travels, never the training-side parameters.
WIRE_MAGIC = b"COREWIRE"
WIRE_VERSION = 1
# minor 0: the v1 scorer artifact; minor 1: a control FRAME wrapping a
# kind-tagged payload; minor 2: a QUANTIZED scorer artifact (int8 or fp8
# codes, the header gaining "dtype" and a per-stage "out_scale" array).
# Readers reject any other minor.
WIRE_MINOR_FRAME = 1
FRAME_RESYNC = "resync"  # payload: a scorer artifact for a fenced host
FRAME_DELTA = "delta"  # payload: JSON-encoded coordinator state delta
# payload: a scorer artifact; meta: the plan cache's stats sidecar (one
# frame per persisted entry, core/plan_cache.py)
FRAME_PLANCACHE = "plancache"
WIRE_MINOR_QUANT = 2


class WireFormatError(ValueError):
    """Malformed / incompatible scorer artifact."""


def pack_le(value: int, width: int) -> bytes:
    """Canonical little-endian unsigned field for COREWIRE containers
    (scorer artifacts, control frames, the plan-cache file): the byte
    layout lives in this module alone."""
    return int(value).to_bytes(width, "little")


def unpack_le(buf, start: int, width: int) -> int:
    """Inverse of :func:`pack_le`: read ``width`` bytes at ``start``."""
    return int.from_bytes(bytes(buf[start:start + width]), "little")


class _ArrayPool:
    """Array blob registry for one serialization pass."""

    def __init__(self):
        self.descs: list = []
        self.blobs: list = []
        self._offset = 0

    def put(self, a: np.ndarray) -> int:
        a = np.ascontiguousarray(a)
        raw = a.tobytes()
        self.descs.append({
            "dtype": a.dtype.str, "shape": list(a.shape),
            "offset": self._offset, "nbytes": len(raw),
        })
        self.blobs.append(raw)
        self._offset += len(raw)
        return len(self.descs) - 1


def _pool_get(descs, payload: memoryview, ref: int) -> np.ndarray:
    d = descs[ref]
    if d["offset"] + d["nbytes"] > len(payload):
        raise WireFormatError(
            f"artifact payload truncated: array {ref} ends at byte "
            f"{d['offset'] + d['nbytes']} of {len(payload)}")
    a = np.frombuffer(
        payload[d["offset"]:d["offset"] + d["nbytes"]], dtype=np.dtype(d["dtype"])
    )
    return a.reshape(d["shape"]).copy()


def _wire_header(blob: bytes, what: str):
    """(minor, header dict, payload view) of a COREWIRE blob; raises on a
    bad magic, version or header."""
    if blob[:len(WIRE_MAGIC)] != WIRE_MAGIC:
        raise WireFormatError(f"bad magic: not a {what}")
    ver = unpack_le(blob, 8, 2)
    if ver != WIRE_VERSION:
        raise WireFormatError(f"wire version {ver} != supported {WIRE_VERSION}")
    hdr_len = unpack_le(blob, 12, 8)
    if 20 + hdr_len > len(blob):
        raise WireFormatError(f"{what} header truncated")
    try:
        header = json.loads(bytes(blob[20:20 + hdr_len]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireFormatError(f"{what} header is not JSON ({e})") from None
    return unpack_le(blob, 10, 2), header, memoryview(blob)[20 + hdr_len:]


def serialize_scorer(plan, scorer=None, *, max_tile: int = 8192) -> bytes:
    """Pack ``(plan, fused scorer)`` into the versioned wire artifact.

    Reads the scorer's host copies only (``packed``, ``thr_host``), never
    its device tensors, so serializing a card's scorer costs no device
    sync.  ``scorer=None`` packs the plan on the host (a CPU scorer: no
    device touched).  Only stage metadata plus the packed cascade travels,
    never UDFs: the receiver binds its own ``Query``."""
    if scorer is None:
        scorer = CascadeScorer.from_plan(plan, max_tile=max_tile, device="cpu")
    if scorer is None:
        raise WireFormatError("plan has no proxied stage: nothing to ship")
    pool = _ArrayPool()
    packed = scorer.packed
    src_families = plan.meta.get("wire_src_families") or tuple(
        s.proxy.family for s in plan.stages if s.proxy is not None)
    stages = []
    for s in plan.stages:
        entry = {
            "pred_idx": int(s.pred_idx), "alpha": float(s.alpha),
            "threshold": float(s.threshold),
            "est_reduction": float(s.est_reduction),
            "est_selectivity": float(s.est_selectivity),
            "est_cost": float(s.est_cost),
            "proxy": None,
        }
        if s.proxy is not None:
            rc = s.proxy.r_curve
            entry["proxy"] = {
                "d": [int(i) for i in s.proxy.d],
                "cost": float(s.proxy.cost),
                "train_f1": float(s.proxy.train_f1),
                "n_train": int(s.proxy.n_train),
                "r_curve": {
                    "alphas": pool.put(np.asarray(rc.alphas)),
                    "thresholds": pool.put(np.asarray(rc.thresholds)),
                    "reductions": pool.put(np.asarray(rc.reductions)),
                },
            }
        stages.append(entry)
    header = {
        "wire_version": WIRE_VERSION,
        "plan": {
            "stages": stages,
            "est_total_cost": float(plan.est_total_cost),
            "plan_version": int(plan.meta.get("plan_version", 0)),
            "accuracy_target": float(plan.query.accuracy_target),
            "n_predicates": int(plan.query.n),
            "src_families": list(src_families),
        },
        "scorer": {
            "w1": pool.put(packed.w1), "b1": pool.put(packed.b1),
            "w2": pool.put(packed.w2), "b2": pool.put(packed.b2),
            "thr": pool.put(np.asarray(scorer.thr_host, np.float32)),
            "hidden": [int(h) for h in packed.hidden],
            "stage_cols": [None if c is None else int(c)
                           for c in scorer.stage_cols],
            "block_m": int(scorer.block_m),
            "max_tile": int(scorer.max_tile),
        },
        "arrays": pool.descs,
    }
    # fp32 keeps minor 0 and no quant header keys, byte for byte the v1.0
    # layout; a quantized cascade is minor 2
    minor = 0
    if packed.dtype != "float32":
        minor = WIRE_MINOR_QUANT
        header["scorer"]["dtype"] = str(packed.dtype)
        header["scorer"]["out_scale"] = pool.put(
            np.asarray(packed.out_scale, np.float32))
    hdr = json.dumps(header, sort_keys=True,
                     separators=(",", ":")).encode("utf-8")
    out = bytearray()
    out += WIRE_MAGIC
    out += pack_le(WIRE_VERSION, 2)
    out += pack_le(minor, 2)
    out += pack_le(len(hdr), 8)
    out += hdr
    for raw in pool.blobs:
        out += raw
    return bytes(out)


def serialize_frame(kind: str, epoch: int, payload: bytes,
                    meta: dict | None = None) -> bytes:
    """Wrap a control payload in a COREWIRE v1.1 frame:

      b"COREWIRE" | u16 major=1 | u16 minor=1 | u64 header_len
      | header JSON {"kind", "epoch", "meta", "payload_len"} | payload

    ``deserialize_scorer`` rejects frames and ``deserialize_frame`` rejects
    scorer artifacts, so the two channels cannot be confused."""
    hdr = json.dumps(
        {"kind": str(kind), "epoch": int(epoch), "meta": meta or {},
         "payload_len": len(payload)},
        sort_keys=True, separators=(",", ":")).encode("utf-8")
    out = bytearray()
    out += WIRE_MAGIC
    out += pack_le(WIRE_VERSION, 2)
    out += pack_le(WIRE_MINOR_FRAME, 2)
    out += pack_le(len(hdr), 8)
    out += hdr
    out += payload
    return bytes(out)


def deserialize_frame(blob: bytes):
    """Inverse of ``serialize_frame``: returns (kind, epoch, payload,
    meta).  Raises ``WireFormatError`` on scorer artifacts (minors 0 and
    2), on any other minor, and on a truncated payload."""
    minor, header, payload = _wire_header(blob, "COREWIRE frame")
    if minor != WIRE_MINOR_FRAME:
        raise WireFormatError(
            f"wire {WIRE_VERSION}.{minor} is not a v{WIRE_VERSION}.{WIRE_MINOR_FRAME} "
            f"control frame")
    payload = bytes(payload)
    if len(payload) != int(header["payload_len"]):
        raise WireFormatError(
            f"frame payload truncated: {len(payload)} != "
            f"{header['payload_len']}")
    return header["kind"], int(header["epoch"]), payload, header["meta"]


def deserialize_scorer(blob: bytes, query, *, device="cuda"):
    """Inverse of ``serialize_scorer``: rebuild ``(plan, scorer)`` against
    the locally bound ``query``, the scorer's operands uploaded to
    ``device``.  The packed codes go to the scorer as they came
    (``packed=``: no re-pack, no re-quantize), so its masks are the
    sender's and serializing it again reproduces the blob; ``block_m`` and
    ``max_tile`` are kept verbatim.  Proxies come back as ``packed1``
    models."""
    minor, header, payload = _wire_header(blob, "CORE scorer artifact")
    if minor == WIRE_MINOR_FRAME:
        raise WireFormatError(
            f"wire minor {minor} is a control frame, not a scorer artifact "
            f"(use deserialize_frame)")
    if minor not in (0, WIRE_MINOR_QUANT):
        raise WireFormatError(
            f"unknown wire minor {minor}: this reader supports scorer "
            f"artifacts v{WIRE_VERSION}.0 (fp32) and "
            f"v{WIRE_VERSION}.{WIRE_MINOR_QUANT} (quantized)")
    descs = header["arrays"]
    ph = header["plan"]
    if int(ph["n_predicates"]) != query.n:
        raise WireFormatError(
            f"artifact built for {ph['n_predicates']} predicates; local "
            f"query has {query.n}")
    if abs(float(ph["accuracy_target"]) - float(query.accuracy_target)) > 1e-12:
        raise WireFormatError("artifact/query accuracy targets differ")
    sh = header["scorer"]
    quant_dtype = str(sh.get("dtype", "float32"))
    packed = PackedCascade(
        w1=_pool_get(descs, payload, sh["w1"]),
        b1=_pool_get(descs, payload, sh["b1"]),
        w2=_pool_get(descs, payload, sh["w2"]),
        b2=_pool_get(descs, payload, sh["b2"]),
        hidden=tuple(int(h) for h in sh["hidden"]),
        families=tuple(ph["src_families"]),
        dtype=quant_dtype,
        out_scale=(_pool_get(descs, payload, sh["out_scale"])
                   if minor == WIRE_MINOR_QUANT else None),
    )
    thr = _pool_get(descs, payload, sh["thr"])
    params_by_col = [unpack_cascade(packed, c) for c in range(packed.n_stages)]
    stages = []
    for st in ph["stages"]:
        proxy = None
        col = sh["stage_cols"][len(stages)]
        if st["proxy"] is not None:
            if col is None:
                raise WireFormatError("proxied stage without a scorer column")
            rc = st["proxy"]["r_curve"]
            proxy = ProxyModel(
                pred_idx=int(st["pred_idx"]),
                d=tuple(st["proxy"]["d"]),
                family="packed1",
                params=params_by_col[col],
                r_curve=RCurve(
                    alphas=_pool_get(descs, payload, rc["alphas"]),
                    thresholds=_pool_get(descs, payload, rc["thresholds"]),
                    reductions=_pool_get(descs, payload, rc["reductions"]),
                ),
                cost=float(st["proxy"]["cost"]),
                train_f1=float(st["proxy"]["train_f1"]),
                n_train=int(st["proxy"]["n_train"]),
            )
        stages.append(PlanStage(
            pred_idx=int(st["pred_idx"]), proxy=proxy,
            alpha=float(st["alpha"]), threshold=float(st["threshold"]),
            est_reduction=float(st["est_reduction"]),
            est_selectivity=float(st["est_selectivity"]),
            est_cost=float(st["est_cost"]),
        ))
    meta = {
        "mode": "wire",
        "plan_version": int(ph["plan_version"]),
        "wire_src_families": tuple(ph["src_families"]),
    }
    if quant_dtype != "float32":
        meta["quant_dtype"] = quant_dtype
    plan = PhysicalPlan(
        query=query, stages=stages,
        est_total_cost=float(ph["est_total_cost"]),
        meta=meta,
    )
    scorer = CascadeScorer(
        params_by_col, thr, block_m=int(sh["block_m"]), max_tile=int(sh["max_tile"]),
        packed=packed, device=device,
    )
    scorer.stage_cols = [None if c is None else int(c)
                         for c in sh["stage_cols"]]
    return plan, scorer


# ------------------------------------------------------ quant parity gate
def quant_parity_report(plan, x, *, dtype: str = "int8",
                        calib_frac: float = 0.5,
                        max_tile: int = 8192, device="cuda") -> dict:
    """Decision-flip audit of a quantized cascade against its fp32 twin,
    both scored on ``device`` (through ``cascade_score`` on a card).

    Quantization may flip a keep decision ONLY for records whose fp32
    score sits within ``tol`` of the stage threshold; ``tol`` is 2x the
    max |quant - fp32| score error over the first ``calib_frac`` of ``x``
    and is validated on the rest.  ``flips_within_tol`` is the gate bit;
    the other fields (score errors, per-stage selectivity deltas) are
    advisory."""
    x = np.asarray(x, np.float32)
    f32 = CascadeScorer.from_plan(plan, max_tile=max_tile, dtype="float32", device=device)
    if f32 is None:
        raise ValueError("plan has no proxied stage: nothing to audit")
    qs = CascadeScorer.from_plan(plan, max_tile=max_tile, dtype=dtype, device=device)
    n_cal = int(np.clip(int(len(x) * calib_frac), 1, len(x) - 1))
    thr = f32.thr_host

    def _scores_masks(scorer, chunk):
        s, m, _pk, _cnt = scorer.score_compact(chunk, need_scores=True)
        return s, m

    s_f, _m_f = _scores_masks(f32, x[:n_cal])
    s_q, _ = _scores_masks(qs, x[:n_cal])
    tol = 2.0 * float(np.max(np.abs(s_q - s_f)))
    ev_f, mask_f = _scores_masks(f32, x[n_cal:])
    ev_q, mask_q = _scores_masks(qs, x[n_cal:])
    flips = mask_f != mask_q
    near = np.abs(ev_f - thr[None, :]) <= tol
    sel_f = mask_f.mean(axis=0)
    sel_q = mask_q.mean(axis=0)
    return {
        "dtype": dtype,
        "tol": tol,
        "max_err_calib": float(np.max(np.abs(s_q - s_f))),
        "max_err_eval": float(np.max(np.abs(ev_q - ev_f))),
        "n_eval": int(flips.shape[0]),
        "n_flips": int(flips.sum()),
        "flip_rate": float(flips.mean()),
        "flips_within_tol": bool(np.all(near[flips])),
        "max_sel_delta": float(np.max(np.abs(sel_f - sel_q))),
        "sel_fp32": [float(v) for v in sel_f],
        "sel_quant": [float(v) for v in sel_q],
    }


# ------------------------------------------------------------------- SSD
def ssd(x, dt, A_log, B, C, D, chunk: int):
    """Full SSD forward: the ``ssd_chunk`` kernel for the intra-chunk block,
    then the inter-chunk recurrence and its output term in PyTorch.
    Differentiable: under grad ``ssd_chunk`` goes through its autograd
    Function (the backward kernel on the card), the rest through autograd.

    x: (b, s, h, p); dt: (b, s, h) softplus'd timesteps; A_log, D: (h,);
    B, C: (b, s, g, n), h % g == 0 (groups are indexed, never repeated).
    ``s`` must be a multiple of ``chunk``.  Returns (y (b, s, h, p) in x's
    type, final state (b, h, p, n) float32).  A DTensor x (under a device
    mesh) runs the whole function on each device's shard: batch over the
    batch axes, heads over "model", the B/C groups replicated and selected
    per rank where they do not divide it (``kernels/_mesh.py``)."""
    if _mesh.is_dtensor(x):
        return _ssd_on_mesh(x, dt, A_log, B, C, D, chunk)
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
    # lax.scan): prev[:, c] is the state entering chunk c, stacked (not
    # written in place) so that autograd differentiates the loop
    states = states.view(b, nc, h, p, n)
    chunk_decay = chunk_decay.view(b, nc, h)
    entering = []
    carry = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    for c in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(entering, dim=1)
    cum = torch.cumsum(dA.view(b, nc, chunk, h), dim=2)  # (b, nc, Q, h)
    y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", C.to(f32).reshape(b, nc, chunk, g, n),
                         prev.view(b, nc, g, rep, p, n)).reshape(b, nc, chunk, h, p)
    y_off = y_off * torch.exp(cum)[..., None]
    y = (y_diag.view(b, nc, chunk, h, p) + y_off).reshape(b, s, h, p)
    y = y + x.to(f32) * D.to(f32)[None, None, :, None]
    return y.to(x.dtype), carry


def _ssd_on_mesh(x, dt, A_log, B, C, D, chunk: int):
    mesh = x.device_mesh
    b, _, h, _ = x.shape
    g = B.shape[2]
    x_spec, g_spec, select = _mesh.head_layout(mesh, b, h, g)
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    heads = (x_spec[2],)

    def local(xl, dtl, al, Bl, Cl, Dl):
        if select:
            idx, _ = _mesh.local_groups(h, g, tp, mesh.get_local_rank("model"))
            Bl, Cl = Bl.index_select(2, idx.to(Bl.device)), Cl.index_select(2, idx.to(Bl.device))
        return ssd(xl, dtl, al, Bl, Cl, Dl, chunk)

    grad = "partial" if select else None
    operands = [t if _mesh.is_dtensor(t) else _mesh.replicated(t, mesh)
                for t in (x, dt, A_log, B, C, D)]
    return _mesh.local_call(local, mesh, operands, (x_spec, x_spec, heads, g_spec, g_spec, heads),
                            (None, None, None, grad, grad, None),
                            (x_spec, (x_spec[0], x_spec[2])))
