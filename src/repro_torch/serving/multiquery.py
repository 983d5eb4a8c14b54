"""Multi-query, multi-tenant cascade serving (DESIGN.md §10): the JAX
package's ``serving/multiquery.py`` over this package's engine and scorer.

One ``CoreSession`` registers N concurrent cascade queries
(``core.api.QueryHandle``) and serves them through this shared engine:

* **One fused launch per chunk** — every tenant's proxied stages stack
  into a single block-diagonal packed cascade
  (``CascadeScorer.from_plans``), deduping columns whose packed params
  AND threshold are byte-identical; each tenant's engine receives its
  own column slice of the stacked mask matrix.  The readout is
  block-diagonal, so a column's score sums only its own hidden block; a
  sliced mask can differ from the tenant's isolated scorer only where the
  wider stack sums that block in another order, on a score that ties the
  threshold.
* **Cross-query UDF dedupe** — identical (udf, record) predicate
  evaluations run ONCE per session: a result cache keyed on the UDF
  content fingerprint (name, declared cost, class count) serves repeat
  lookups for free, and only fresh evaluations are charged to the cost
  model.  The session assumes one shared record-id space (the same
  global index always denotes the same row).
* **Weighted-fair scheduling** — device time is allocated by marginal
  Eq. 3.1 benefit: each tenant's default weight is the cost the cascade
  saves per unit of device cost it spends, and a virtual-time WFQ picks
  the backlogged tenant with the smallest served-cost/weight.  A
  newly-backlogged tenant syncs to the minimum backlogged virtual time,
  so idle periods cannot bank credit; the starvation bound (no
  continuously-backlogged tenant falls behind its weighted share by
  more than a constant number of batches) is property-tested.
* **Per-tenant isolation under swaps** — each tenant keeps its own
  ``CascadeServer`` (versioned ``_PlanState``s, drift monitors,
  conservation); a swap restacks the SHARED scorer but never reinstalls
  the other tenants' plans, so their in-flight masks stay valid and
  their traffic never stalls.

The stacked scorer and every tenant's engine live on the engine's
``device`` (CUDA by default; raises without a card).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.kernels.ops import CascadeScorer
from repro_torch.serving.engine import CascadeServer
from repro_torch.util import advisory_wall_ms, resolve_device


def udf_fingerprint(udf) -> str:
    """Content identity of an ML UDF for cross-query dedupe: the same
    convention the plan cache's predicate idents use (name, declared
    cost, class count) — two queries naming the same model share its
    evaluations."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((str(udf.name), float(udf.cost),
                   int(udf.n_classes))).encode())
    return h.hexdigest()


class UdfResultCache:
    """(udf fingerprint, record idx) -> label store shared by every
    tenant engine in a session.  ``runner`` plugs into
    ``CascadeServer.udf_runner``: it evaluates only the records the
    session has never run through this UDF, charges only those to the
    cost model, and replays the rest bit-identically."""

    def __init__(self):
        self._results: Dict[str, Dict[int, object]] = {}
        self.hits = 0
        self.misses = 0
        self.saved_cost_ms = 0.0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def runner(self, pred, idxs: np.ndarray, x: np.ndarray):
        fp = udf_fingerprint(pred.udf)
        store = self._results.setdefault(fp, {})
        missing = [k for k, i in enumerate(idxs) if int(i) not in store]
        if missing:
            fresh = pred.udf(x[missing])
            for k, lab in zip(missing, fresh):
                store[int(idxs[k])] = lab
        labels = np.asarray([store[int(i)] for i in idxs])
        n_hit = len(idxs) - len(missing)
        self.hits += n_hit
        self.misses += len(missing)
        self.saved_cost_ms += n_hit * pred.udf.cost
        return labels, len(missing) * pred.udf.cost

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": self.hit_rate,
                "saved_cost_ms": self.saved_cost_ms,
                "udfs": len(self._results)}


def eq31_benefit(plan) -> float:
    """Marginal Eq. 3.1 benefit of serving through ``plan``'s cascade
    instead of the unproxied conjunction: cost saved per unit of device
    cost spent.  The scheduler's default per-tenant weight — device time
    flows toward the tenants whose cascades buy the most."""
    orig = sum(p.udf.cost for p in plan.query.predicates)
    spent = max(float(plan.est_total_cost), 1e-9)
    return float(np.clip((orig - spent) / spent, 0.1, 100.0))


class FairScheduler:
    """Weighted-fair queueing over tenant service on the cost-model
    clock.  ``pick`` returns the backlogged tenant with minimum virtual
    time (served cost / weight, ties to the heavier weight then the
    lower qid); ``charge`` advances it by one service quantum.  The
    ``service_log`` keeps every (qid, cost) grant so fairness is
    auditable after the fact."""

    def __init__(self, weights: Dict[int, float]):
        self.weights = {int(q): max(float(w), 1e-6)
                        for q, w in weights.items()}
        self.vtime = {q: 0.0 for q in self.weights}
        self.served_cost = {q: 0.0 for q in self.weights}
        self.service_log: List[Tuple[int, float]] = []
        self._backlogged = {q: False for q in self.weights}

    def pick(self, backlogged: Sequence[int]) -> int:
        incumbents = [q for q in backlogged if self._backlogged[q]]
        if incumbents:
            # v-time sync on re-entry: an idle tenant resumes at the floor
            # of the tenants that STAYED backlogged, not at its own stale
            # clock — a newcomer's vtime must not define the floor, or it
            # replays banked credit and starves the incumbents for a
            # stretch proportional to its idle time
            floor = min(self.vtime[q] for q in incumbents)
            for q in backlogged:
                if not self._backlogged[q]:
                    self.vtime[q] = max(self.vtime[q], floor)
        active = set(backlogged)
        for q in self._backlogged:
            self._backlogged[q] = q in active
        return min(backlogged,
                   key=lambda q: (self.vtime[q], -self.weights[q], q))

    def charge(self, qid: int, cost_ms: float) -> None:
        cost_ms = max(float(cost_ms), 1e-9)
        self.vtime[qid] += cost_ms / self.weights[qid]
        self.served_cost[qid] += cost_ms
        self.service_log.append((qid, cost_ms))

    def as_dict(self) -> dict:
        return {"weights": dict(self.weights),
                "served_cost_ms": dict(self.served_cost),
                "grants": len(self.service_log)}


@dataclass
class SessionStats:
    queries: int = 0
    restacks: int = 0
    shared_cols: int = 0          # columns in the stacked scorer
    stacked_cols_saved: int = 0   # columns deduped across tenants
    shared_score_ms: float = 0.0  # wall inside the stacked fused pass
    finalized_per_query: List[int] = field(default_factory=list)


class MultiQueryEngine:
    """The shared serving engine behind ``CoreSession.serve()`` for N>1
    registered queries.  Owns one ``CascadeServer`` per tenant (so every
    single-query invariant — versioned swaps, conservation, drift state
    — holds per tenant), one stacked ``CascadeScorer`` across all
    tenants' plans, one cross-query ``UdfResultCache``, and one
    ``FairScheduler`` granting device time by Eq. 3.1 benefit."""

    def __init__(self, handles, *, tile: int = 1024,
                 adaptive: bool = False,
                 policy=None, seed: int = 0, plan_cache=None,
                 weights: Optional[Dict[int, float]] = None,
                 max_tile: int = 8192, device="cuda"):
        self.device = resolve_device(device)
        self.handles = list(handles)
        if len(self.handles) < 2:
            raise ValueError("MultiQueryEngine needs >= 2 query handles")
        for h in self.handles:
            if h.plan is None:
                raise ValueError(
                    f"query {h.qid} has no plan: optimize before serving")
        self.tile = tile
        self.adaptive = adaptive
        self.max_tile = max_tile
        self.udf_cache = UdfResultCache()
        self.stats = SessionStats(queries=len(self.handles),
                                  finalized_per_query=[0] * len(self.handles))
        self.servers: List[CascadeServer] = []
        for h in self.handles:
            srv = CascadeServer(
                h.plan, tile=tile, adaptive=adaptive, policy=policy,
                seed=seed + 101 * h.qid, plan_cache=plan_cache, device=self.device)
            srv.udf_runner = self.udf_cache.runner
            srv.add_finalize_hook(self._finalize_hook(h.qid))
            self.servers.append(srv)
        self._versions = [s.plan_version for s in self.servers]
        self.scorer = None
        self._gcols: List[List[int]] = []
        self._restack()
        self.stats.restacks = 0  # the initial stack is not a re-stack
        if weights is None:
            weights = {h.qid: eq31_benefit(h.plan) for h in self.handles}
        self.scheduler = FairScheduler(weights)

    def _finalize_hook(self, qid: int):
        def hook(emitted, rejected, _version):
            self.stats.finalized_per_query[qid] += len(emitted) + len(rejected)
        return hook

    # ------------------------------------------------------------- stacking
    def _restack(self) -> None:
        """(Re)build the shared stacked scorer over every tenant's
        CURRENT plan.  Per-tenant engines are untouched: their local
        column layouts — and therefore every in-flight mask row — stay
        valid, so one tenant's swap never invalidates another's
        traffic."""
        plans = [s.plan for s in self.servers]
        self.scorer, col_maps = CascadeScorer.from_plans(
            plans, max_tile=self.max_tile, device=self.device)
        # per-tenant shared->local slice: the tenant's local scorer
        # numbers its proxied stages 0..P_q-1 in stage order, so the
        # slice is just the shared columns of those stages in order
        self._gcols = [[c for c in cols if c is not None]
                       for cols in col_maps]
        if self.scorer is not None:
            total_local = sum(len(g) for g in self._gcols)
            self.stats.shared_cols = self.scorer.n_proxies
            self.stats.stacked_cols_saved = total_local - self.scorer.n_proxies
        self.stats.restacks += 1

    def _sync_plans(self) -> None:
        cur = [s.plan_version for s in self.servers]
        if cur != self._versions:
            self._versions = cur
            for h, s in zip(self.handles, self.servers):
                h.plan = s.plan
            self._restack()

    def install_plan(self, qid: int, plan, *, scorer=None,
                     version: Optional[int] = None) -> int:
        """Hot-swap ONE tenant's plan (the session analogue of
        ``CascadeServer.install_plan``); the shared scorer restacks, the
        other tenants' states and in-flight masks are untouched."""
        v = self.servers[qid].install_plan(plan, scorer=scorer,
                                           version=version)
        self._sync_plans()
        return v

    # -------------------------------------------------------------- serving
    def submit(self, indices, rows, *, qids=None) -> None:
        """Coalesced cross-tenant submission: ONE stacked fused launch
        scores the chunk for every target query, then each tenant's
        engine receives its own mask slice."""
        indices = np.asarray(indices)
        rows = np.asarray(rows, np.float32)
        if len(rows) == 0:
            return
        targets = range(len(self.servers)) if qids is None else qids
        full = None
        if self.scorer is not None:
            t0 = advisory_wall_ms()
            full = self.scorer.score_masks(rows)
            self.stats.shared_score_ms += advisory_wall_ms() - t0
        for q in targets:
            srv = self.servers[q]
            if full is not None and self._gcols[q]:
                srv.submit(indices, rows, masks=full[:, self._gcols[q]])
            else:
                srv.submit(indices, rows)

    def _ready(self, srv: CascadeServer, drain: bool) -> bool:
        return srv.has_ready_batch(drain=drain)

    def pump(self, *, drain: bool = False) -> None:
        """Scheduler loop: grant one stage batch at a time to the
        backlogged tenant with minimum virtual time, charging the exact
        cost-model delta of that batch."""
        while True:
            backlogged = [q for q, s in enumerate(self.servers)
                          if self._ready(s, drain)]
            if not backlogged:
                return
            q = self.scheduler.pick(backlogged)
            srv = self.servers[q]
            cost0 = srv.stats.model_cost_ms
            if not srv.pump_one(drain=drain):
                return
            self.scheduler.charge(q, srv.stats.model_cost_ms - cost0)

    def maybe_reoptimize(self) -> bool:
        swapped = False
        for srv in self.servers:
            if srv.maybe_reoptimize():
                swapped = True
        if swapped:
            self._sync_plans()
        return swapped

    def drain(self) -> None:
        while any(s.in_flight() for s in self.servers):
            self.pump(drain=True)

    def run_stream(self, x: np.ndarray, *, chunk: int = 4096
                   ) -> "SessionStats":
        """Broadcast the stream to every registered query (the shared-
        corpus workload the session exists for) and drive to drain."""
        t0 = advisory_wall_ms()
        n = x.shape[0]
        for s0 in range(0, n, chunk):
            idx = np.arange(s0, min(s0 + chunk, n))
            self.submit(idx, x[idx])
            self.pump()
            if self.adaptive:
                self.maybe_reoptimize()
        self.drain()
        for srv in self.servers:
            srv.stats.wall_ms = advisory_wall_ms() - t0
            srv.stats.rejected = n - srv.stats.emitted
        return self.stats

    # ------------------------------------------------------------ accounting
    @property
    def emitted(self) -> List[List[int]]:
        return [srv.emitted for srv in self.servers]

    def model_cost_ms(self) -> float:
        """Total session device cost on the cost-model clock (each
        tenant's charges already exclude deduped UDF evaluations)."""
        return float(sum(s.stats.model_cost_ms for s in self.servers))

    def query_stats(self, qid: int) -> dict:
        srv = self.servers[qid]
        return {
            "qid": qid,
            "emitted": srv.stats.emitted,
            "rejected": srv.stats.rejected,
            "model_cost_ms": srv.stats.model_cost_ms,
            "plan_version": srv.plan_version,
            "plan_swaps": srv.stats.plan_swaps,
            "in_flight": srv.in_flight(),
            "served_cost_ms": self.scheduler.served_cost.get(qid, 0.0),
            "weight": self.scheduler.weights.get(qid),
            "finalized": self.stats.finalized_per_query[qid],
        }

    def conserved(self) -> Tuple[bool, str]:
        """Per-query conservation: nothing in flight after a drain, and
        no record emitted twice by any tenant."""
        for q, srv in enumerate(self.servers):
            if srv.in_flight():
                return False, f"query {q}: {srv.in_flight()} in flight"
            if len(srv.emitted) != len(set(srv.emitted)):
                return False, f"query {q}: duplicate emissions"
        return True, "ok"

    def session_stats(self) -> dict:
        return {
            "queries": self.stats.queries,
            "restacks": self.stats.restacks,
            "shared_cols": self.stats.shared_cols,
            "stacked_cols_saved": self.stats.stacked_cols_saved,
            "shared_score_ms": self.stats.shared_score_ms,
            "model_cost_ms": self.model_cost_ms(),
            "dedupe": self.udf_cache.as_dict(),
            "scheduler": self.scheduler.as_dict(),
            "finalized_per_query": list(self.stats.finalized_per_query),
        }
