"""Cross-query plan cache with similarity warm-start (DESIGN.md §8), on
this package's optimizer and scorer.

CORE builds its proxy models *online per query* — the whole optimizer
exists to amortize that build cost inside one query.  At production
scale most new queries resemble old ones, so the remaining hot path is
the optimizer itself.  This module closes that loop:

* **Fingerprint** — a query maps to (a) an exact-identity blake2b digest
  over its predicate identities (UDF name, literal set, declared cost,
  class count), proxy family assignment, accuracy target, and the
  cost-model constants (step/eps), and (b) a normalized *stat vector*
  [accuracy target | per-predicate selectivities | per-predicate UDF
  cost shares | pairwise kappa² correlations] fed by audited reservoir
  statistics.  The digest answers "is this literally the same query?";
  the stat vector answers "how far have its statistics drifted?".
* **Index** — an append-bounded ``OrderedDict`` keyed by digest.  Exact
  lookups and nearest-neighbor probes both refresh recency, so eviction
  at capacity drops the least-recently-HIT entry.
* **Warm start** — on a match, ``warm_optimize`` (1) transplants the
  donor's trained-classifier cache into the fresh builder (the same
  mechanism ``ProxyBuilder.rebase`` uses across samples, re-validated
  per proxy by the Eq.-4.7 eps-approx test before any reuse) and
  (2) seeds the branch-and-bound tree with the donor's stale L-node
  measurements + surviving candidate set and ``resume``s — fresh search
  effort goes only where the widened stale bounds cannot prune.
* **Fallbacks** — a nearest neighbor beyond ``similarity_threshold``,
  or whose plan order carries ``estimate_order_regret`` beyond
  ``regret_tol`` under the probe's fresh selectivities, is rejected and
  the query cold-optimizes; the cold result is written back so the miss
  pays for the next query's hit.
* **Persistence** — entries serialize as COREWIRE ``plancache`` frames
  (payload = the entry's v1/v1.2 scorer artifact, meta = the JSON stats
  sidecar), length-prefixed in one container blob, so the cache
  survives restarts and ships coordinator->fleet byte-stably.  A
  corrupt entry is skipped with a warning; the rest of the file loads.

Correctness does not depend on any similarity judgment: an exact hit
replays a plan only for a digest-identical query at (near-)identical
stats, and a warm start still trains/validates every proxy against the
*new* query's labels — a bad neighbor can cost search visits, never
accuracy.

Builds (cold and warm) train on ``device``, and an exact hit uploads the
replayed scorer there; on a card it scores through ``cascade_score``.  The
COREPLNC container is the JAX package's byte for byte: either package
loads what the other saved.
"""
from __future__ import annotations

import hashlib
import json
import warnings
from collections import OrderedDict
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.proxy_family import get_family
from repro_torch.core.query import PhysicalPlan, Query
from repro_torch.util import advisory_wall_ms, atomic_write_bytes


PLANCACHE_MAGIC = b"COREPLNC"
PLANCACHE_VERSION = 1


def _families_for(query: Query, kind) -> List[str]:
    """Canonical per-predicate family names, mirroring
    ``ProxyBuilder.family_for`` so fingerprints computed before building
    match fingerprints recorded from built plans."""
    out = []
    for p in range(query.n):
        if isinstance(kind, dict):
            out.append(get_family(kind.get(p, "svm")).name)
        elif kind == "mixed":
            out.append("linear" if p % 2 == 0 else "mlp1")
        else:
            out.append(get_family(kind).name)
    return out


@dataclass(frozen=True)
class QueryFingerprint:
    """Exact-identity digest + normalized drift-stat vector for a query."""

    digest: str
    stat_vec: np.ndarray
    n_predicates: int
    schema: dict  # the JSON-safe fields the digest/vector were built from

    def distance(self, other_vec: np.ndarray) -> float:
        """Mean absolute componentwise distance — every component lives
        in [0, 1] (selectivities, cost shares, kappa², accuracy target),
        so the distance does too."""
        a, b = self.stat_vec, np.asarray(other_vec, np.float64)
        if a.shape != b.shape:
            return float("inf")
        return float(np.mean(np.abs(a - b)))


def fingerprint_query(
    query: Query,
    *,
    kind="svm",
    selectivities: Optional[Dict[int, float]] = None,
    correlations: Optional[Dict[Tuple[int, int], float]] = None,
    step: float = 0.02,
    eps: float = 0.1,
) -> QueryFingerprint:
    """Fingerprint ``query`` for the plan cache.

    ``selectivities``: audited per-predicate unconditional selectivities
    (reservoir / audit-monitor estimates); missing predicates default to
    0.5 (maximum-uncertainty prior) so a stats-free probe is still
    comparable with a stats-free entry.  ``correlations``: pairwise
    kappa² values keyed ``(i, j), i < j``; missing pairs default to 0.
    """
    sels = {int(p): float(v) for p, v in (selectivities or {}).items()}
    costs = [float(p.udf.cost) for p in query.predicates]
    total_cost = sum(costs) or 1.0
    families = _families_for(query, kind)
    preds = [
        {
            "udf": p.udf.name,
            "values": sorted(int(v) for v in p.values),
            "cost": float(p.udf.cost),
            "n_classes": int(p.udf.n_classes),
        }
        for p in query.predicates
    ]
    ident = {
        "preds": preds,
        "families": families,
        "accuracy_target": float(query.accuracy_target),
        "step": float(step),
        "eps": float(eps),
    }
    digest = hashlib.blake2b(
        json.dumps(ident, sort_keys=True, separators=(",", ":")).encode(),
        digest_size=16,
    ).hexdigest()
    vec = [float(query.accuracy_target)]
    vec += [sels.get(p, 0.5) for p in range(query.n)]
    vec += [c / total_cost for c in costs]
    corr = {tuple(sorted(k)): float(v) for k, v in (correlations or {}).items()}
    for i in range(query.n):
        for j in range(i + 1, query.n):
            vec.append(corr.get((i, j), 0.0))
    return QueryFingerprint(
        digest=digest,
        stat_vec=np.asarray(vec, np.float64),
        n_predicates=query.n,
        schema={"ident": ident, "stat_vec": [float(v) for v in vec]},
    )


@dataclass
class WarmStart:
    """Donor state ``build_plan(warm_start=...)`` consumes: the trained-
    classifier cache, the donor B&B's L-node measurements, and its
    surviving candidate orders."""

    classifiers: Optional[dict] = None
    s_stars: Optional[Dict[Tuple[int, ...], float]] = None
    orders: Optional[List[Tuple[int, ...]]] = None


@dataclass
class PlanCacheStats:
    hits_exact: int = 0
    hits_warm: int = 0
    misses: int = 0
    fallbacks_similarity: int = 0  # nearest neighbor too far
    fallbacks_regret: int = 0      # neighbor's order regret too high
    writes: int = 0
    evictions: int = 0
    corrupt_skipped: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


@dataclass
class PlanCacheEntry:
    digest: str
    stat_vec: np.ndarray
    artifact: bytes          # COREWIRE scorer artifact (exact-hit replay)
    sidecar: dict            # JSON-safe stats sidecar (persisted in the frame)
    classifiers: Optional[dict] = None  # in-memory only: live ProxyModels
    hits: int = 0

    @property
    def n_predicates(self) -> int:
        return int(self.sidecar.get("n_predicates", 0))


def _shim_plan(sidecar: dict) -> Optional[SimpleNamespace]:
    """Duck-typed plan for ``estimate_order_regret``: stages carrying the
    cached pricing fields plus a query shim with the UDF costs — enough
    to re-price the cached ORDER under a probe's fresh selectivities
    without deserializing the artifact or holding the donor query."""
    stages = sidecar.get("stages")
    if not stages:
        return None
    shim_stages = [
        SimpleNamespace(
            pred_idx=int(s["pred_idx"]),
            alpha=float(s["alpha"]),
            est_reduction=float(s["est_reduction"]),
            est_selectivity=float(s["est_selectivity"]),
            proxy=(None if s.get("proxy_cost") is None
                   else SimpleNamespace(cost=float(s["proxy_cost"]))),
        )
        for s in stages
    ]
    preds = [SimpleNamespace(udf=SimpleNamespace(cost=float(s["udf_cost"])))
             for s in sorted(stages, key=lambda s: s["pred_idx"])]
    return SimpleNamespace(
        stages=shim_stages,
        order=tuple(s.pred_idx for s in shim_stages),
        query=SimpleNamespace(predicates=preds),
    )


class PlanCache:
    """Append-bounded fingerprint index of past optimized plans.

    ``capacity`` bounds the entry count (least-recently-hit evicts);
    ``similarity_threshold`` is the maximum stat-vector distance a
    nearest neighbor may have to warm-start; ``regret_tol`` is the
    maximum Eq.-3.1 order regret of the neighbor's plan under the
    probe's fresh selectivities; ``exact_tol`` is the distance under
    which a digest-identical entry replays as an exact HIT (skipping
    proxy training entirely) instead of warm-starting a re-search.
    """

    def __init__(self, capacity: int = 32, *,
                 similarity_threshold: float = 0.15,
                 regret_tol: float = 0.1,
                 exact_tol: float = 1e-3,
                 k_donors: int = 3):
        self.capacity = int(capacity)
        self.similarity_threshold = float(similarity_threshold)
        self.regret_tol = float(regret_tol)
        self.exact_tol = float(exact_tol)
        # distance-weighted multi-donor blending: a warm start merges the
        # k nearest same-arity entries' s* maps instead of trusting the
        # single nearest (k_donors=1 restores single-donor seeding); with
        # one entry in range the behavior is identical by construction
        self.k_donors = max(1, int(k_donors))
        self._entries: "OrderedDict[str, PlanCacheEntry]" = OrderedDict()
        self.stats = PlanCacheStats()

    def __len__(self) -> int:
        return len(self._entries)

    def digests(self) -> List[str]:
        """Entry digests in recency order (least-recently-hit first)."""
        return list(self._entries)

    # ---------------------------------------------------------------- insert
    def put(self, fp: QueryFingerprint, plan: PhysicalPlan, *,
            artifact: Optional[bytes] = None, scorer=None) -> Optional[PlanCacheEntry]:
        """Record an optimized plan under ``fp``.  Harvests whatever
        donor state the plan carries: the builder's classifier cache and
        the B&B tree's measurements (``build_plan(keep_state=True)`` /
        ``rebuild_plan``); a state-less plan still caches for exact-hit
        replay.  The artifact is serialized from ``scorer``'s host copies
        when one is given (a server's installed scorer), else packed on
        the host.  Returns the entry, or None if the plan cannot be
        serialized (no proxied stage)."""
        from repro_torch.kernels.ops import WireFormatError, serialize_scorer

        if artifact is None:
            try:
                artifact = serialize_scorer(plan, scorer)
            except WireFormatError:
                return None
        orders: List[List[int]] = []
        s_stars: Dict[str, float] = {}
        bb = plan.meta.get("bnb")
        if bb is not None:
            raw_s, raw_o = bb.export_state()
            s_stars = {",".join(str(i) for i in k): float(v)
                       for k, v in raw_s.items()}
            orders = [list(o) for o in raw_o]
        classifiers = None
        builder = plan.meta.get("builder")
        if builder is not None:
            classifiers = builder.export_classifiers()
        stages = [
            {
                "pred_idx": int(s.pred_idx),
                "alpha": float(s.alpha),
                "est_reduction": float(s.est_reduction),
                "est_selectivity": float(s.est_selectivity),
                "proxy_cost": None if s.proxy is None else float(s.proxy.cost),
                "udf_cost": float(plan.query.predicates[s.pred_idx].udf.cost),
            }
            for s in plan.stages
        ]
        prev = self._entries.get(fp.digest)
        sidecar = {
            "digest": fp.digest,
            "n_predicates": int(fp.n_predicates),
            "stat_vec": [float(v) for v in fp.stat_vec],
            "ident": fp.schema["ident"],
            "plan_cost": float(plan.est_total_cost),
            "plan_version": int(plan.meta.get("plan_version", 0)),
            "stages": stages,
            "orders": orders,
            "s_stars": s_stars,
            "hits": prev.hits if prev is not None else 0,
        }
        entry = PlanCacheEntry(
            digest=fp.digest, stat_vec=np.asarray(fp.stat_vec, np.float64),
            artifact=artifact, sidecar=sidecar, classifiers=classifiers,
            hits=prev.hits if prev is not None else 0,
        )
        self._entries[fp.digest] = entry
        self._entries.move_to_end(fp.digest)
        self.stats.writes += 1
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats.evictions += 1
        return entry

    # ---------------------------------------------------------------- lookup
    def lookup(self, fp: QueryFingerprint
               ) -> Tuple[Optional[str], Optional[PlanCacheEntry], float]:
        """(kind, entry, distance): kind is "exact" (digest match at
        ~identical stats), "warm" (nearest neighbor within the
        similarity threshold — including a digest match whose stats
        drifted), or None.  A returned entry's recency refreshes."""
        same = self._entries.get(fp.digest)
        if same is not None:
            d = fp.distance(same.stat_vec)
            if d <= self.exact_tol:
                same.hits += 1
                same.sidecar["hits"] = same.hits
                self._entries.move_to_end(fp.digest)
                return "exact", same, d
        best: Optional[PlanCacheEntry] = None
        best_d = float("inf")
        for e in self._entries.values():
            if e.n_predicates != fp.n_predicates:
                continue
            d = fp.distance(e.stat_vec)
            if d < best_d:
                best, best_d = e, d
        if best is not None and best_d <= self.similarity_threshold:
            best.hits += 1
            best.sidecar["hits"] = best.hits
            self._entries.move_to_end(best.digest)
            return "warm", best, best_d
        return None, None, best_d

    def _drop(self, digest: str) -> None:
        self._entries.pop(digest, None)

    def _neighbors(self, fp: QueryFingerprint, k: int
                   ) -> List[Tuple[PlanCacheEntry, float]]:
        """The k nearest same-arity entries within the similarity
        threshold, nearest first.  Read-only: recency bookkeeping stays
        with ``lookup`` (which already refreshed the nearest)."""
        cands = []
        for e in self._entries.values():
            if e.n_predicates != fp.n_predicates:
                continue
            d = fp.distance(e.stat_vec)
            if d <= self.similarity_threshold:
                cands.append((e, d))
        cands.sort(key=lambda ed: (ed[1], ed[0].digest))
        return cands[:k]

    @staticmethod
    def _blend_donors(donors: List[Tuple[PlanCacheEntry, float]]
                      ) -> Tuple[Dict[Tuple[int, ...], float],
                                 List[Tuple[int, ...]]]:
        """Distance-weighted merge of the donors' exported search state.

        s* maps merge per prefix as an inverse-distance weighted mean
        over the donors that measured that prefix — a far donor's stale
        selectivity nudges, a near donor's dominates.  Candidate orders
        union: every donor's surviving set stays alive, so the merged
        seed can only widen (never wrongly narrow) the re-opened search.
        """
        num: Dict[Tuple[int, ...], float] = {}
        den: Dict[Tuple[int, ...], float] = {}
        orders: List[Tuple[int, ...]] = []
        seen = set()
        for entry, dist in donors:
            w = 1.0 / (dist + 1e-6)
            for key, s in entry.sidecar.get("s_stars", {}).items():
                prefix = tuple(int(i) for i in key.split(","))
                num[prefix] = num.get(prefix, 0.0) + w * float(s)
                den[prefix] = den.get(prefix, 0.0) + w
            for o in entry.sidecar.get("orders", []):
                t = tuple(int(i) for i in o)
                if t not in seen:
                    seen.add(t)
                    orders.append(t)
        s_stars = {p: num[p] / den[p] for p in num}
        return s_stars, orders

    # ----------------------------------------------------------- optimization
    def optimize_query(
        self,
        query: Query,
        x_sample: np.ndarray,
        options=None,
        *,
        selectivities: Optional[Dict[int, float]] = None,
        correlations: Optional[Dict[Tuple[int, int], float]] = None,
        accept_hit: bool = True,
        device="cuda",
    ) -> Tuple[PhysicalPlan, dict]:
        """Cache-aware ``build_plan``: exact HIT replays the cached plan
        (no proxy training at all); similar neighbors warm-start the
        builder + B&B (distance-weighted blend of the ``k_donors``
        nearest same-arity entries); anything else cold-optimizes.
        Every non-hit result is written back.  Returns ``(plan, info)``
        where ``info`` carries {path, distance, regret, donors,
        build_ms, digest}, and on a hit ``scorer``: the replayed
        artifact's scorer, uploaded to ``device``.  Builds train on
        ``device``.

        ``accept_hit=False`` forces a digest-identical match down the
        warm path — callers that need live builder/B&B state (adaptive
        serving wants ``keep_state``) cannot serve a wire-replayed plan.
        """
        from repro_torch.core.api import OptimizeOptions, build_plan
        from repro_torch.kernels.ops import WireFormatError, deserialize_scorer
        from repro_torch.serving.stats import estimate_order_regret

        opts = options or OptimizeOptions()
        fp = fingerprint_query(query, kind=opts.kind,
                               selectivities=selectivities,
                               correlations=correlations,
                               step=opts.step, eps=opts.eps)
        match, entry, dist = self.lookup(fp)
        info = {"path": "cold", "digest": fp.digest,
                "distance": dist, "regret": None, "donors": 0}
        if match == "exact" and accept_hit:
            t0 = advisory_wall_ms()
            try:
                plan, scorer = deserialize_scorer(entry.artifact, query, device=device)
            except WireFormatError as e:
                warnings.warn(
                    f"plan cache entry {entry.digest} failed to replay "
                    f"({e}); dropping it and cold-optimizing",
                    RuntimeWarning, stacklevel=2)
                self._drop(entry.digest)
                self.stats.corrupt_skipped += 1
            else:
                self.stats.hits_exact += 1
                plan.meta["plan_cache"] = {
                    "path": "hit", "digest": fp.digest, "distance": dist}
                info.update(path="hit", scorer=scorer,
                            build_ms=advisory_wall_ms() - t0)
                return plan, info
        warm: Optional[WarmStart] = None
        if match in ("exact", "warm") and entry is not None:
            # price the nearest neighbor's ORDER under the probe's fresh
            # stats; high regret means the order optimum moved and the
            # donors' candidate sets would steer the search wrong — fall
            # back cold
            regret = 0.0
            shim = _shim_plan(entry.sidecar)
            best_order = None
            if shim is not None:
                regret, best_order = estimate_order_regret(
                    shim, dict(selectivities or {}))
            info["regret"] = regret
            if regret > self.regret_tol:
                self.stats.fallbacks_regret += 1
            else:
                donors = self._neighbors(fp, self.k_donors)
                if not any(e is entry for e, _ in donors):
                    # lookup's pick always participates (an exact-digest
                    # match at drifted stats may sort behind strangers)
                    donors = [(entry, dist)] + donors[:self.k_donors - 1]
                s_stars, orders = self._blend_donors(donors)
                if shim is not None and orders and best_order not in orders:
                    # fresh stats prefer an order every donor search had
                    # pruned: keep the measurements, re-open the full
                    # candidate set
                    orders = []
                info["donors"] = len(donors)
                warm = WarmStart(classifiers=entry.classifiers,
                                 s_stars=s_stars or None,
                                 orders=orders or None)
        elif match is None and dist <= 1.0:
            self.stats.fallbacks_similarity += 1
        t0 = advisory_wall_ms()
        plan = build_plan(query, x_sample, opts.replace(keep_state=True),
                          warm_start=warm, device=device)
        build_ms = advisory_wall_ms() - t0
        if warm is not None:
            self.stats.hits_warm += 1
            info["path"] = "warm"
        else:
            self.stats.misses += 1
        self.put(fp, plan)
        if not opts.keep_state:
            plan.meta.pop("builder", None)
            plan.meta.pop("bnb", None)
        plan.meta["plan_cache"] = {
            "path": info["path"], "digest": fp.digest, "distance": dist}
        info["build_ms"] = build_ms
        info["trace"] = plan.meta.get("trace")
        return plan, info

    def warm_optimize(
        self,
        query: Query,
        x_sample: np.ndarray,
        *,
        selectivities: Optional[Dict[int, float]] = None,
        correlations: Optional[Dict[Tuple[int, int], float]] = None,
        mode: str = "core",
        kind="svm",
        step: float = 0.02,
        eps: float = 0.1,
        framework: str = "exhaustive",
        fine_grained: bool = True,
        seed: int = 0,
        keep_state: bool = False,
        quant_dtype: Optional[str] = None,
        accept_hit: bool = True,
        device="cuda",
    ) -> Tuple[PhysicalPlan, dict]:
        """Deprecated: use ``optimize_query(query, x, OptimizeOptions(...))``."""
        from repro_torch.core.api import OptimizeOptions

        warnings.warn(
            "PlanCache.warm_optimize() is deprecated; use "
            "PlanCache.optimize_query(query, x_sample, OptimizeOptions(...))",
            DeprecationWarning, stacklevel=2)
        return self.optimize_query(
            query, x_sample,
            OptimizeOptions(mode=mode, kind=kind, step=step, eps=eps,
                            framework=framework, fine_grained=fine_grained,
                            seed=seed, keep_state=keep_state,
                            quant_dtype=quant_dtype),
            selectivities=selectivities, correlations=correlations,
            accept_hit=accept_hit, device=device)

    # ------------------------------------------------------------- write-back
    def record_plan(self, plan: PhysicalPlan, *,
                    selectivities: Optional[Dict[int, float]] = None,
                    step: float = 0.02, eps: float = 0.1,
                    scorer=None) -> Optional[str]:
        """Write-back hook for the serving layers: fingerprint ``plan``'s
        query from its own stage estimates (the reservoir-fresh
        selectivities a re-optimization just measured) and insert/update,
        the artifact serialized from ``scorer``'s host copies when given.
        Returns the digest, or None if the plan cannot be cached (wire
        plans carry ``packed1`` proxies that cannot seed a builder —
        recording them would poison future warm starts)."""
        fams = {s.pred_idx: s.proxy.family
                for s in plan.stages if s.proxy is not None}
        if any(f == "packed1" for f in fams.values()):
            return None
        if len(fams) < plan.query.n:
            return None
        if selectivities is None:
            selectivities = {int(s.pred_idx): float(s.est_selectivity)
                             for s in plan.stages}
        fp = fingerprint_query(plan.query, kind=fams,
                               selectivities=selectivities,
                               step=step, eps=eps)
        entry = self.put(fp, plan, scorer=scorer)
        return entry.digest if entry is not None else None

    # ------------------------------------------------------------ persistence
    def to_bytes(self) -> bytes:
        """One length-prefixed COREWIRE ``plancache`` frame per entry:

            b"COREPLNC" | u16 version | u16 pad | u32 count
            | [u64 frame_len | frame]*

        Deterministic for a given cache state (canonical-JSON sidecars,
        artifact bytes verbatim), so save -> load -> save is byte-stable.
        """
        from repro_torch.kernels.ops import FRAME_PLANCACHE, pack_le, serialize_frame

        out = bytearray()
        out += PLANCACHE_MAGIC
        out += pack_le(PLANCACHE_VERSION, 2)
        out += pack_le(0, 2)
        out += pack_le(len(self._entries), 4)
        for i, entry in enumerate(self._entries.values()):
            frame = serialize_frame(FRAME_PLANCACHE, i, entry.artifact,
                                    meta=entry.sidecar)
            out += pack_le(len(frame), 8)
            out += frame
        return bytes(out)

    @classmethod
    def from_bytes(cls, blob: bytes, **kwargs) -> "PlanCache":
        """Inverse of ``to_bytes``.  A corrupt entry (bad frame, wrong
        kind, mangled sidecar) is skipped with a warning — one poisoned
        entry must not take down the whole cache; a corrupt container
        header raises."""
        from repro_torch.kernels.ops import (
            FRAME_PLANCACHE,
            WireFormatError,
            deserialize_frame,
            unpack_le,
        )

        cache = cls(**kwargs)
        if blob[:len(PLANCACHE_MAGIC)] != PLANCACHE_MAGIC:
            raise ValueError("bad magic: not a plan-cache container")
        ver = unpack_le(blob, 8, 2)
        if ver != PLANCACHE_VERSION:
            raise ValueError(f"unknown plan-cache container version {ver}")
        count = unpack_le(blob, 12, 4)
        off = 16
        for _ in range(count):
            if off + 8 > len(blob):
                warnings.warn(
                    "plan-cache container truncated: missing entries "
                    "skipped", RuntimeWarning, stacklevel=2)
                break
            flen = unpack_le(blob, off, 8)
            off += 8
            frame = blob[off:off + flen]
            off += flen
            if len(frame) != flen:
                warnings.warn(
                    "plan-cache container truncated mid-entry: entry "
                    "skipped", RuntimeWarning, stacklevel=2)
                cache.stats.corrupt_skipped += 1
                break
            try:
                kind, _epoch, payload, sidecar = deserialize_frame(frame)
                if kind != FRAME_PLANCACHE:
                    raise WireFormatError(f"unexpected frame kind {kind!r}")
                digest = str(sidecar["digest"])
                vec = np.asarray(sidecar["stat_vec"], np.float64)
                hits = int(sidecar.get("hits", 0))
            except (WireFormatError, KeyError, TypeError, ValueError) as e:
                warnings.warn(
                    f"corrupt plan-cache entry skipped ({e})",
                    RuntimeWarning, stacklevel=2)
                cache.stats.corrupt_skipped += 1
                continue
            cache._entries[digest] = PlanCacheEntry(
                digest=digest, stat_vec=vec, artifact=payload,
                sidecar=dict(sidecar), classifiers=None, hits=hits)
        return cache

    def save(self, path) -> None:
        atomic_write_bytes(path, self.to_bytes())

    @classmethod
    def load(cls, path, **kwargs) -> "PlanCache":
        from pathlib import Path

        return cls.from_bytes(Path(path).read_bytes(), **kwargs)
