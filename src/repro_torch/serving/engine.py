"""Batched cascade serving engine (continuous batching over the proxy
cascade) with optional drift-adaptive re-optimization: the JAX package's
``serving/engine.py`` on this package's scorer and optimizer.

The paper's executor streams rows; here (DESIGN.md §3):

  * every cascade stage has a fixed-size device microbatch;
  * proxy scoring runs the ``cascade_score`` kernel over tiles on the card;
  * survivors are pushed to the next stage's HOST queue; the scheduler
    drains whichever stage has a full tile ready (UDFs always run dense);
  * a final drain pass flushes partial tiles at end-of-stream.

Fused hot path: a ``CascadeScorer`` covers EVERY proxied stage — linear,
MLP, or mixed, all lowered to the packed ProxyFamily format — and scores
each incoming chunk ONCE at submit time: one ``cascade_score`` launch per
tile yields every stage's keep decision, and the per-record mask rows ride
through the stage queues with the record.  Stage execution then never
re-packs or re-scores: the gate is a mask lookup.  With the importance
audit on, the same launch also returns the scores, from which
``score_margins`` takes each record's distance to the nearest threshold.

Adaptive serving (DESIGN.md §4): with ``adaptive=True`` the server keeps
streaming statistics — per-stage observed keep-rates vs the plan's
estimates, an audited unbiased per-predicate selectivity, pairwise
kappa^2 over audit labels, and a reservoir of recent (partially labeled)
rows.  A CUSUM trigger on any signal re-optimizes mid-stream: a cheap
re-allocation on the incumbent order, or a warm-started branch-and-bound
``resume`` when the correlation structure shifted.  The new plan is
hot-swapped behind a versioned ``_PlanState``: in-flight queue entries
finish under the plan (and mask rows) they were scored with, so record
conservation holds across swaps; new submissions score through the new
plan's ``CascadeScorer`` (cached per plan version by content).

Nothing is dropped: hypothesis property tests assert conservation (every
record is either rejected by some stage or emitted exactly once), on the
static AND the drift-swapping paths.

Every server takes ``device`` (CUDA by default; raises without a card):
the scorer's operands live there, and drift re-optimization trains and
scores there.  Every proxied stage is gated by the plan's fused scorer at
submit time: ``cascade_score`` on a card, its plain route on the CPU.  With a
cross-query plan cache (``core/plan_cache.py``), every plan the server
commits is written back to it, serialized from the installed scorer's host
copies: a write-back adds no launch and no device sync.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.api import REBUILD_DEFAULTS, rebuild_plan
from repro_torch.core.correlation import StreamingKappa2
from repro_torch.core.query import PhysicalPlan
from repro_torch.serving.stats import (
    AdaptivePolicy,
    CusumDetector,
    DriftEvent,
    ImportanceAuditSampler,
    Reservoir,
    StreamingRate,
)
from repro_torch.util import advisory_wall_ms, resolve_device


@dataclass
class ServeStats:
    stage_in: List[int]
    stage_udf_batches: List[int]
    stage_kept: List[int]
    stage_proxy_ms: List[float]
    stage_used_kernel: List[bool]
    emitted: int = 0
    rejected: int = 0
    wall_ms: float = 0.0
    model_cost_ms: float = 0.0
    fused_score_ms: float = 0.0  # submit-time fused whole-cascade scoring
    # ----- adaptive serving -----
    plan_swaps: int = 0
    reopt_ms: float = 0.0  # wall time inside re-optimization
    reopt_udf_cost_ms: float = 0.0  # cost-model charge for reservoir labeling
    audit_records: int = 0
    audit_cost_ms: float = 0.0  # cost-model charge for audit UDF runs
    scorer_cache_hits: int = 0
    plan_cache_writebacks: int = 0  # committed plans recorded cross-query
    drift_events: List[DriftEvent] = field(default_factory=list)

    @property
    def proxy_total_ms(self) -> float:
        return self.fused_score_ms + sum(self.stage_proxy_ms)


class _AuditMonitor:
    """Unconditional per-predicate selectivity watcher over audit records.

    Audit records are importance-sampled toward proxy thresholds, so every
    update carries inverse-propensity-corrected totals: ``kept_w`` /
    ``seen_w`` are Horvitz-Thompson sums (sigma_i / p_i and 1 / p_i over
    the audited subset) whose ratio is an unbiased selectivity estimate,
    while ``n_audited`` (the actual UDF runs) drives the baseline freeze,
    the recency window, and the CUSUM weight — statistical information
    scales with labels paid for, not with IPW-expanded pseudo-counts.

    The first ``baseline_n`` audited records after a plan install define
    the reference rate; afterwards a CUSUM accumulates sustained
    deviation.  (Per-stage keep-rates are conditioned on the prefix, so
    only the audit stream gives an unbiased drift signal per predicate.)
    """

    def __init__(self, policy: AdaptivePolicy):
        self.rate = StreamingRate()
        self.baseline: Optional[float] = None
        self.baseline_n = policy.audit_baseline
        self.cusum = CusumDetector(policy.slack, policy.threshold)
        self._window: deque = deque()  # (kept_w, seen_w, n_audited), recent only
        self._window_n = policy.audit_window
        self._audited = 0

    def update(self, kept_w: float, seen_w: float, n_audited: int) -> bool:
        self.rate.update(kept_w, seen_w)
        self._audited += int(n_audited)
        self._window.append((kept_w, seen_w, n_audited))
        while sum(a for _, _, a in self._window) - self._window[0][2] >= self._window_n:
            self._window.popleft()
        if self.baseline is None:
            if self._audited >= self.baseline_n:
                self.baseline = self.rate.rate
            return False
        return self.cusum.update(kept_w / seen_w if seen_w else 0.0,
                                 self.baseline, n_audited)

    @property
    def has_window(self) -> bool:
        return any(s > 0 for _, s, _ in self._window)

    @property
    def recent_rate(self) -> float:
        seen = sum(s for _, s, _ in self._window)
        return sum(k for k, _, _ in self._window) / seen if seen else 0.0


class _PlanState:
    """One installed plan version: its compiled scorer, its stage queues,
    and (while current) its drift monitors.  Queue entries are
    (global idx, feature row, mask row | None); the mask row is only ever
    interpreted through THIS state's ``stage_cols`` — versioned masks."""

    def __init__(self, version: int, plan: PhysicalPlan, cascade,
                 policy: Optional[AdaptivePolicy]):
        self.version = version
        self.plan = plan
        self.cascade = cascade
        n = len(plan.stages)
        self.queues: List[deque] = [deque() for _ in range(n)]
        self.stage_rate = [StreamingRate() for _ in range(n)]
        self.stage_cusum = (
            [CusumDetector(policy.slack, policy.threshold) for _ in range(n)]
            if policy is not None else None
        )

    def expected_keep(self, si: int) -> float:
        s = self.plan.stages[si]
        return s.est_selectivity * (s.alpha if s.proxy is not None else 1.0)

    def empty(self) -> bool:
        return all(not q for q in self.queues)


class CascadeServer:
    """Continuous-batching executor for a compiled cascade plan.

    ``adaptive=True`` turns on the drift-triggered re-optimization loop;
    the plan should then come from ``optimize(..., keep_state=True)`` so
    re-search can warm-start from the previous branch-and-bound tree (a
    stateless plan still adapts, but re-search cold-starts).  ``device``
    holds the scorer's operands (CUDA by default; raises without a card).
    """

    def __init__(self, plan: PhysicalPlan, *, tile: int = 1024,
                 adaptive: bool = False,
                 policy: Optional[AdaptivePolicy] = None, seed: int = 0,
                 plan_cache=None, scorer=None, device="cuda"):
        self.device = resolve_device(device)
        self.query = plan.query
        self.tile = tile
        self.adaptive = adaptive
        self.policy = policy or AdaptivePolicy()
        # cross-query plan cache (core.plan_cache.PlanCache): every plan
        # this server commits (the initial install and each drift
        # re-optimization) is written back so a similar future query can
        # warm-start its optimization
        self.plan_cache = plan_cache
        n = len(plan.stages)
        self.emitted: List[int] = []
        # plan version each emission was scored AND served under (parallel
        # to ``emitted``): queue entries never migrate between _PlanStates,
        # so the draining state's version IS the scoring version
        self.emitted_versions: List[int] = []
        self.stats = ServeStats(
            stage_in=[0] * n, stage_udf_batches=[0] * n, stage_kept=[0] * n,
            stage_proxy_ms=[0.0] * n, stage_used_kernel=[False] * n,
        )
        # cross-query UDF evaluation hook (serving/multiquery.py): when a
        # session installs a runner, ``_eval_udf`` routes every stage and
        # audit UDF call through it — fn(pred, idxs, x) -> (labels,
        # cost_ms) — so identical (udf, record) evaluations dedupe across
        # the session's queries and only fresh work is charged
        self.udf_runner = None
        self._states: List[_PlanState] = []
        self._install(plan, scorer=scorer)
        self._record_to_cache(plan)
        # adaptive machinery
        self._rng = np.random.RandomState(seed)
        self._audit_sampler = ImportanceAuditSampler(
            self.policy.audit_rate, floor=self.policy.audit_floor)
        self._reservoir = Reservoir(
            self.query.n, capacity=self.policy.reservoir_capacity,
            stride=self.policy.reservoir_stride,
        )
        self._records_submitted = 0
        self._last_swap_at = 0
        self._drift: Optional[Tuple[str, float, float]] = None
        # record-finalization hooks (the serving front end's completion
        # attribution): fn(emitted_ids, rejected_ids, plan_version) fires
        # once per executed stage batch with the indices that left the
        # pipeline there — emitted at the last stage, rejected anywhere
        self._finalize_hooks: List = []

    # ------------------------------------------------------------ versioning
    @property
    def plan(self) -> PhysicalPlan:
        return self._states[-1].plan

    @property
    def plan_version(self) -> int:
        return self._states[-1].version

    def _install(self, plan: PhysicalPlan, *, scorer=None,
                 version: Optional[int] = None):
        # every proxied stage is scored at submit time by one fused
        # scorer (cascade_score on a card, its plain route on the CPU);
        # None only when the plan gates no stage with a proxy
        if scorer is None:
            from repro_torch.kernels.ops import cascade_scorer_for_plan

            scorer, hit = cascade_scorer_for_plan(
                plan, max_tile=max(self.tile, 1024), device=self.device)
            self.stats.scorer_cache_hits += int(hit and scorer is not None)
        if scorer is not None and not scorer.covers_all(plan):
            raise ValueError("the fused scorer does not cover every proxied stage")
        cascade = scorer
        if version is None:
            version = self._states[-1].version + 1 if self._states else 0
        elif self._states and version <= self._states[-1].version:
            raise ValueError(
                f"plan version must advance: {version} <= "
                f"{self._states[-1].version}")
        self._states.append(_PlanState(
            version, plan, cascade, self.policy if self.adaptive else None))
        # fresh drift baselines for the new plan
        self._audit_mon = {p: _AuditMonitor(self.policy)
                           for p in range(self.query.n)}
        self._kappa: Dict[Tuple[int, int], StreamingKappa2] = {
            (i, j): StreamingKappa2()
            for i in range(self.query.n) for j in range(i + 1, self.query.n)
        }
        self._kappa_snapshot: Optional[Dict[Tuple[int, int], float]] = None

    def _record_to_cache(self, plan: PhysicalPlan) -> None:
        """Write a committed plan back to the cross-query plan cache.
        Fingerprinted with this server's re-optimization step so the
        initial plan and every drift re-plan of the same query land on
        one entry, each write refreshing it with reservoir-fresh
        selectivities.  The artifact comes from the installed scorer's
        host copies."""
        if self.plan_cache is None:
            return
        if self.plan_cache.record_plan(plan, step=self.policy.step,
                                       scorer=self._states[-1].cascade) is not None:
            self.stats.plan_cache_writebacks += 1

    # -------------------------------------------------- external plan swaps
    def install_plan(self, plan: PhysicalPlan, *, scorer=None,
                     version: Optional[int] = None) -> int:
        """Hot-swap to an externally decided plan (the front end's degrade
        ladder, a multi-query session's swap of one tenant): ``scorer`` may
        be a pre-built ``CascadeScorer``; ``version`` pins the version
        number.  In-flight entries still finish under the version that
        scored them.  Returns the installed version."""
        self._install(plan, scorer=scorer, version=version)
        self.stats.plan_swaps += 1
        self._last_swap_at = self._records_submitted
        self._drift = None  # stale local trigger: superseded by the swap
        return self._states[-1].version

    def has_ready_batch(self, *, drain: bool = False) -> bool:
        """Whether ``pump_one(drain=drain)`` would find work: a
        superseded version with anything queued, a full tile at the
        current version, or (under ``drain``) anything at all."""
        for st in self._states[:-1]:
            if not st.empty():
                return True
        if drain:
            return not self._states[-1].empty()
        return any(len(q) >= self.tile for q in self._states[-1].queues)

    def in_flight(self) -> int:
        """Records sitting in ANY plan version's stage queues — zero after
        a full drain, or something was lost in the pipe (the falsifiable
        half of the conservation check; emitted-list uniqueness is the
        other)."""
        return sum(len(q) for s in self._states for q in s.queues)

    # ------------------------------------------------------------- plumbing
    def add_finalize_hook(self, fn) -> None:
        """Register ``fn(emitted_ids, rejected_ids, plan_version)`` to be
        called whenever records leave the pipeline (emitted from the last
        stage, or rejected by a proxy gate / predicate at any stage).
        Every submitted record is reported to the hooks exactly once —
        the serving front end leans on this for per-request completion
        latency attribution (DESIGN.md §7)."""
        self._finalize_hooks.append(fn)

    def _notify_finalized(self, emitted: List[int], rejected: List[int],
                          version: int) -> None:
        if not self._finalize_hooks or not (emitted or rejected):
            return
        for fn in self._finalize_hooks:
            fn(emitted, rejected, version)

    def submit(self, indices: np.ndarray, rows: np.ndarray, *,
               masks: Optional[np.ndarray] = None,
               margins: Optional[np.ndarray] = None):
        """``masks`` (N, P in THIS plan's column layout) short-circuits
        the fused scoring pass — the multi-query session scores one
        stacked launch for every tenant and hands each engine its own
        column slice.  Mask rows are versioned exactly like locally
        scored ones: they ride the current state's queues and are only
        read through its ``stage_cols``."""
        if len(rows) == 0:
            # short-circuit: the front end's batching loop ticks on every
            # arrival-poll, so idle ticks would otherwise still walk the
            # zip-append path and count into ``_records_submitted`` (whose
            # delta since the last swap feeds the ``_may_trigger``
            # cooldown arithmetic) — an empty submission must be a no-op
            return
        cur = self._states[-1]
        rows = np.asarray(rows, np.float32)
        if masks is not None:
            masks = np.asarray(masks, bool)
            for i, r, m in zip(indices, rows, masks):
                cur.queues[0].append((int(i), r, m))
        elif cur.cascade is not None and len(rows):
            t0 = advisory_wall_ms()
            if self.adaptive and self.policy.audit_importance:
                # the importance-audit weights need score-to-threshold
                # distances: the same launch that produces the masks
                # returns the scores, reduced to margins on the host
                masks, margins = cur.cascade.score_margins(rows)
            else:
                masks = cur.cascade.score_masks(rows)
            self.stats.fused_score_ms += advisory_wall_ms() - t0
            for i, r, m in zip(indices, rows, masks):
                cur.queues[0].append((int(i), r, m))
        else:
            for i, r in zip(indices, rows):
                cur.queues[0].append((int(i), r, None))
        if self.adaptive and len(rows):
            self._observe_chunk(np.asarray(indices), rows, margins)
        self._records_submitted += len(rows)

    def _eval_udf(self, pred, idxs: np.ndarray, x: np.ndarray):
        """Run ``pred``'s UDF over ``x`` and return (labels, cost_ms).
        The default path runs and charges everything; a session-installed
        ``udf_runner`` dedupes repeat (udf, record) evaluations across
        queries and charges only the fresh ones."""
        if self.udf_runner is not None:
            return self.udf_runner(pred, idxs, x)
        return pred.udf(x), len(x) * pred.udf.cost

    def _observe_chunk(self, indices: np.ndarray, rows: np.ndarray,
                       margins: Optional[np.ndarray] = None):
        """Reservoir-sample the chunk and audit a small subset: audit
        records get EVERY UDF run up front (charged to the cost model),
        yielding drift-grade selectivity/correlation statistics and
        pre-labeled reservoir rows for re-optimization.

        The audit subset is importance-sampled toward records near proxy
        thresholds (``margins`` = score distance to the nearest stage
        threshold): those labels carry the most information about whether
        the thresholds still sit where the optimizer put them.  The
        induced bias is removed with inverse-propensity weights before the
        selectivity monitors see the totals, so corrected estimates stay
        unbiased on any stream (property-tested)."""
        for i, r in zip(indices, rows):
            self._reservoir.add(int(i), r)
        sel, ipw = self._audit_sampler.select(
            margins if self.policy.audit_importance else None,
            len(rows), self._rng)
        if not sel.any():
            return
        xa, ia = rows[sel], indices[sel]
        for i, r in zip(ia, xa):  # audited rows always enter the reservoir
            self._reservoir.add(int(i), r, force=True)
        labels_by_pred = {}
        for p, pred in enumerate(self.query.predicates):
            labels, cost = self._eval_udf(pred, ia, xa)
            labels_by_pred[p] = labels
            sigma = pred.evaluate(labels)
            self.stats.audit_cost_ms += cost
            self.stats.model_cost_ms += cost
            for idx, s, w in zip(ia, sigma, ipw):
                self._reservoir.observe(int(idx), p, bool(s), weight=float(w))
            kept_w = float(np.sum(sigma * ipw))
            seen_w = float(np.sum(ipw))
            if self._audit_mon[p].update(kept_w, seen_w, len(xa)) \
                    and self._may_trigger():
                self._drift = (
                    f"audit:sel:{p}", self._audit_mon[p].recent_rate,
                    self._audit_mon[p].baseline,
                )
        for (i, j), k in self._kappa.items():
            # IPW weights keep the contingency table a population estimate
            # despite the threshold-weighted audit subset
            k.update(labels_by_pred[i], labels_by_pred[j], weights=ipw)
        if self._kappa_snapshot is None and all(
                m.baseline is not None for m in self._audit_mon.values()):
            self._kappa_snapshot = {k: v.value() for k, v in self._kappa.items()}
        self.stats.audit_records += int(sel.sum())

    def _may_trigger(self) -> bool:
        return (
            self.adaptive
            and self._drift is None
            and self._reservoir.size >= self.policy.min_reservoir
            and (self._records_submitted - self._last_swap_at
                 >= self.policy.cooldown_records)
        )

    def _run_stage_batch(self, state: _PlanState, si: int, batch: List):
        stage = state.plan.stages[si]
        idxs = np.asarray([b[0] for b in batch])
        x = np.stack([b[1] for b in batch])
        mrows = [b[2] for b in batch]
        self.stats.stage_in[si] += len(batch)
        n_enter = len(batch)
        rejected_ids: List[int] = []
        if stage.proxy is not None:
            t0 = advisory_wall_ms()
            # the gate was computed once at submit time, by the fused
            # scorer or by a multi-query session's stacked launch
            col = state.cascade.stage_cols[si]
            keep = np.asarray([m[col] for m in mrows], bool)
            self.stats.stage_used_kernel[si] = True
            self.stats.stage_proxy_ms[si] += advisory_wall_ms() - t0
            self.stats.model_cost_ms += len(x) * stage.proxy.cost
            rejected_ids.extend(int(i) for i in idxs[~keep])
            idxs, x = idxs[keep], x[keep]
            mrows = [m for m, k in zip(mrows, keep) if k]
        if len(idxs) == 0:
            self._note_stage_outcome(state, si, 0, n_enter)
            self._notify_finalized([], rejected_ids, state.version)
            return
        pred = state.plan.query.predicates[stage.pred_idx]
        labels, udf_cost = self._eval_udf(pred, idxs, x)
        self.stats.model_cost_ms += udf_cost
        self.stats.stage_udf_batches[si] += 1
        passed = pred.evaluate(labels)
        self.stats.stage_kept[si] += int(passed.sum())
        rejected_ids.extend(int(i) for i in idxs[~passed])
        survivors = [
            (int(i), r, m) for i, r, m, p in zip(idxs, x, mrows, passed) if p
        ]
        self._note_stage_outcome(state, si, len(survivors), n_enter)
        emitted_ids: List[int] = []
        if si + 1 < len(state.plan.stages):
            state.queues[si + 1].extend(survivors)
        else:
            emitted_ids = [i for i, _, _ in survivors]
            self.emitted.extend(emitted_ids)
            self.emitted_versions.extend([state.version] * len(survivors))
            self.stats.emitted += len(survivors)
        self._notify_finalized(emitted_ids, rejected_ids, state.version)

    def _note_stage_outcome(self, state: _PlanState, si: int, kept: int,
                            seen: int):
        """Per-stage combined keep-rate (proxy gate AND predicate) vs the
        plan's estimate ``s_i * alpha_i`` — the conditioned drift signal."""
        state.stage_rate[si].update(kept, seen)
        if state.stage_cusum is None or state is not self._states[-1]:
            return  # superseded versions just drain; no drift bookkeeping
        batch_rate = kept / seen if seen else 0.0
        if state.stage_cusum[si].update(
                batch_rate, state.expected_keep(si), seen) \
                and self._may_trigger():
            # record the BATCH rate: the escalation decision reads the
            # magnitude of the fresh deviation, not the diluted cumulative
            self._drift = (
                f"stage{si}:keep", batch_rate, state.expected_keep(si),
            )

    def _pump_state(self, state: _PlanState, *, drain: bool):
        """Steady state drains later stages first (keeps output latency
        low); drains run FORWARD so survivors flow through every stage."""
        n = len(state.plan.stages)
        order = range(n) if drain else reversed(range(n))
        for si in order:
            q = state.queues[si]
            while len(q) >= self.tile or (drain and q):
                take = min(self.tile, len(q))
                batch = [q.popleft() for _ in range(take)]
                self._run_stage_batch(state, si, batch)

    def pump(self, *, drain: bool = False):
        """Run every stage whose queue holds >= one full tile.  Superseded
        plan versions flush completely first — their in-flight entries
        finish under the plan (and masks) that scored them."""
        for state in self._states[:-1]:
            self._pump_state(state, drain=True)
        self._states = [s for s in self._states
                        if s is self._states[-1] or not s.empty()]
        self._pump_state(self._states[-1], drain=drain)

    def pump_one(self, *, drain: bool = False) -> bool:
        """Run AT MOST one stage batch — the multi-query scheduler's
        service quantum: it charges the cost-model delta of exactly one
        batch to the tenant it picked.  Superseded versions still take
        precedence (same ordering as ``pump``); returns False when no
        batch was ready (nothing >= a tile, or nothing at all under
        ``drain``)."""
        self._states = [s for s in self._states
                        if s is self._states[-1] or not s.empty()]
        for state in self._states:
            is_cur = state is self._states[-1]
            flush = drain or not is_cur
            n = len(state.plan.stages)
            order = range(n) if flush else reversed(range(n))
            for si in order:
                q = state.queues[si]
                if len(q) >= self.tile or (flush and q):
                    take = min(self.tile, len(q))
                    batch = [q.popleft() for _ in range(take)]
                    self._run_stage_batch(state, si, batch)
                    return True
        return False

    # ----------------------------------------------------------- adaptivity
    def _escalate(self) -> Tuple[str, bool]:
        """Decide re-optimization depth from the stale plan's estimated
        COST-MODEL REGRET (``AdaptivePolicy.choose_escalation``): the
        audit monitors' corrected selectivities re-cost the incumbent
        order against every permutation (Eq. 3.1); only a regret beyond
        ``regret_tol`` — a drift a re-allocation cannot fix, because the
        order optimum moved — pays for the warm branch-and-bound resume.
        A kappa² correlation-structure shift also escalates: the regret
        estimate only has marginals, so a correlation change invalidates
        it and re-opens the order question directly."""
        if self.policy.escalate in ("alloc", "bnb"):
            return self.policy.escalate, self.policy.escalate == "bnb"
        if self._kappa_snapshot is not None:
            for key, k in self._kappa.items():
                if abs(k.value() - self._kappa_snapshot[key]) > self.policy.kappa_tol:
                    return "bnb", True
        # freshest selectivities first: the reservoir spans only the last
        # ~capacity*stride records (IPW-corrected labels), while the audit
        # monitors' window can stretch tens of thousands of records back
        fresh_sels = {}
        for p in range(self.query.n):
            sel = self._reservoir.selectivity(p)
            if sel is None:
                mon = self._audit_mon[p]
                if mon.baseline is not None and mon.has_window:
                    sel = mon.recent_rate
            if sel is not None:
                # 0.0 is EVIDENCE (a collapsed predicate is the strongest
                # reorder signal there is), not absence of data — absence
                # is the None above
                fresh_sels[p] = sel
        mode, _regret = self.policy.choose_escalation(
            self._states[-1].plan, fresh_sels)
        return mode, mode == "bnb"

    def maybe_reoptimize(self) -> bool:
        """Re-optimize and hot-swap if a drift trigger is pending.  Called
        between chunks by ``run_stream``; external callers can call it at
        any batch boundary."""
        if not (self.adaptive and self._drift):
            return False
        signal, observed, expected = self._drift
        # the triggering deviation is recorded in the DriftEvent below; the
        # escalation decision itself reads fresh statistics, not magnitude
        mode, escalated = self._escalate()
        old = self._states[-1]
        t0 = advisory_wall_ms()
        x_s, known_sigma = self._reservoir.sample()
        new_plan = rebuild_plan(
            old.plan, x_s,
            REBUILD_DEFAULTS.replace(reopt=mode, step=self.policy.step),
            known_sigma=known_sigma, device=self.device)
        reopt_ms = advisory_wall_ms() - t0
        self.stats.reopt_ms += reopt_ms
        # the builder's UDF labeling on reservoir rows is real model work
        for p, cnt in new_plan.meta["stats"]["udf_calls"].items():
            charge = cnt * self.query.predicates[p].udf.cost
            self.stats.reopt_udf_cost_ms += charge
            self.stats.model_cost_ms += charge
        self._install(new_plan)
        self.stats.plan_swaps += 1
        self._record_to_cache(new_plan)
        trace = new_plan.meta.get("trace") or {}
        self.stats.drift_events.append(DriftEvent(
            at_record=self._records_submitted, signal=signal,
            observed=float(observed), expected=float(expected),
            escalated=escalated, reopt_ms=reopt_ms,
            nodes_visited=int(trace.get("nodes_visited", 0)),
            plan_version=self._states[-1].version,
            order_before=old.plan.order, order_after=new_plan.order,
        ))
        self._last_swap_at = self._records_submitted
        self._drift = None
        return True

    # ------------------------------------------------------------ serving loop
    def run_stream(self, x: np.ndarray, *, chunk: int = 4096) -> ServeStats:
        t0 = advisory_wall_ms()
        n = x.shape[0]
        for s in range(0, n, chunk):
            idx = np.arange(s, min(s + chunk, n))
            self.submit(idx, x[idx])
            self.pump()
            if self.adaptive:
                self.maybe_reoptimize()
        self.pump(drain=True)
        self.stats.wall_ms = advisory_wall_ms() - t0
        self.stats.rejected = n - self.stats.emitted
        return self.stats
