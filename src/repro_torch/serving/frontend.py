"""SLO-aware request front end over the continuous-batching engine: the
JAX package's ``serving/frontend.py`` over this package's engine.

The engine (``serving/engine.py``) scores whatever chunk ``submit`` hands
it — there is no notion of a *request*, no admission control, and no
latency metric.  This module adds the request level (DESIGN.md §7):

  * requests (a contiguous index range + feature rows + a per-request
    latency deadline) arrive on a queue with an arrival timestamp;
  * a batching loop coalesces pending rows into micro-batches sized to
    the fused scorer's bucket ladder (``CascadeScorer.buckets``), so
    coalescing only ever produces tile sizes whose buffers the scorer
    already holds;
  * each tick drives ``CascadeServer.submit`` + ``pump(drain=True)`` and
    attributes completion latency per request from arrival to the tick
    in which its last record left the pipeline (via the engine's
    finalize hooks);
  * **goodput** — requests/s that met their SLO — is reported next to
    raw cost-model throughput, and a backpressure policy degrades to a
    cheaper plan (dropping trailing cascade stages, each ladder level
    priced exactly by Eq. 3.1 ``plan_cost``) when the predicted queue
    wait exceeds the deadline budget, instead of queueing forever.
    Requests whose deadline expires before their rows were submitted are
    **shed explicitly** — counted, attributed, and never silently lost.

Time base: everything is the engine's deterministic cost-model clock
(``ServeStats.model_cost_ms``), NOT wall-clock — ``fused_score_ms`` is
host time and never enters any decision or reported metric here, so runs
are bit-reproducible and gateable (DESIGN.md §2).

Conservation contract (property-tested): every admitted record is
exactly one of {emitted, rejected-by-the-cascade, explicitly shed};
admission-rejected requests (deadline provably unmeetable at the
cheapest degrade rung — refused up front, distinct from shed) never
contribute records to any of the three;
``engine.in_flight() == 0`` after ``drain()``; shed records never appear
in ``engine.emitted``.  This holds across deadline expiry, degrade
installs, and external (quorum) plan hot-swaps.

Record indices must be globally unique across requests — they are the
attribution key back to the owning request (the engine's
emitted-uniqueness invariant already demands this).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cost import plan_cost
from repro_torch.core.query import PhysicalPlan
from repro_torch.kernels.ops import cascade_scorer_for_plan
from repro_torch.serving.engine import CascadeServer


# ------------------------------------------------------------- degrade ladder
def degrade_ladder(plan: PhysicalPlan, *, min_stages: int = 1) -> List[PhysicalPlan]:
    """Cheaper-plan ladder for backpressure: level k drops the last k
    cascade stages (level 0 is the full plan), down to ``min_stages``.

    Trailing stages are the cheapest to cut: the prefix product already
    made them rare, so dropping them sheds the *most expensive
    per-surviving-record* work while leaving the heavily-reducing front
    of the cascade intact.  Each level is re-priced exactly with the
    Eq. 3.1 cost model over the stages it keeps — the same estimates the
    optimizer priced the full plan with — so the backpressure loop can
    reason about capacity in the same (cost-model ms / record) currency
    as throughput.  Semantics under degrade are a documented relaxation:
    dropped predicates are not evaluated, so emission is a superset of
    the exact answer (recall preserved, precision degraded) for the
    records served at that level.

    ``meta`` is shared with the base plan (quant_dtype etc. must carry so
    the degraded scorer packs at the same dtype) plus a ``degrade_level``
    stamp.
    """
    ladder = [plan]
    n = len(plan.stages)
    for k in range(1, n - min_stages + 1):
        stages = list(plan.stages[: n - k])
        est = plan_cost(
            [s.alpha if s.proxy is not None else 1.0 for s in stages],
            [s.est_reduction if s.proxy is not None else 0.0 for s in stages],
            [s.est_selectivity for s in stages],
            [s.proxy.cost if s.proxy is not None else 0.0 for s in stages],
            [plan.query.predicates[s.pred_idx].udf.cost for s in stages],
        )
        meta = dict(plan.meta)
        meta["degrade_level"] = k
        ladder.append(PhysicalPlan(plan.query, stages, est, meta))
    return ladder


# ------------------------------------------------------------------ requests
@dataclass
class Request:
    """One client request: serve ``indices``/``rows`` within
    ``deadline_ms`` (cost-model ms, relative to ``arrival_ms``)."""

    rid: int
    indices: np.ndarray
    rows: np.ndarray
    arrival_ms: float
    deadline_ms: float
    # ---- bookkeeping (owned by the front end) ----
    cursor: int = 0           # rows [0, cursor) submitted or shed
    outstanding: int = 0      # submitted, not yet finalized by the engine
    emitted: int = 0
    rejected: int = 0
    shed_ids: List[int] = field(default_factory=list)
    done_ms: Optional[float] = None
    # refused at admission: no row was ever submitted or shed — the
    # deadline was provably unmeetable even at the cheapest degrade rung
    admission_rejected: bool = False

    @property
    def n(self) -> int:
        return len(self.rows)

    @property
    def shed(self) -> int:
        return len(self.shed_ids)

    @property
    def submitted(self) -> int:
        return self.cursor - self.shed

    @property
    def absolute_deadline(self) -> float:
        return self.arrival_ms + self.deadline_ms

    @property
    def done(self) -> bool:
        return self.done_ms is not None

    @property
    def latency_ms(self) -> Optional[float]:
        return None if self.done_ms is None else self.done_ms - self.arrival_ms

    @property
    def met_slo(self) -> bool:
        """A request meets its SLO iff it finished within the deadline
        AND nothing was shed — shed work is an explicit SLO miss, never a
        silent success.  An admission-rejected request finishes instantly
        but served zero records: never an SLO success."""
        return (self.done_ms is not None and self.shed == 0
                and not self.admission_rejected
                and self.latency_ms <= self.deadline_ms + 1e-9)


# -------------------------------------------------------------------- policy
@dataclass
class SLOPolicy:
    """Knobs for the admission / backpressure / degrade loop.

    ``degrade_headroom`` / ``restore_headroom`` are hysteresis fractions
    of the tightest pending deadline budget: degrade (as many ladder
    levels as the burst requires, re-predicting after each) when the
    predicted queue wait exceeds ``degrade_headroom`` of it, restore one
    level per tick when the wait falls below ``restore_headroom``.  The
    gap between them prevents flapping.  ``degrade=False`` turns the ladder off entirely
    (shed-only backpressure — the sharded fleet mode, where plan
    versions are pinned to quorum epochs and a local install would break
    the epoch ordering; see DESIGN.md §7)."""

    shed_expired: bool = True
    # refuse (at admission) requests whose deadline cannot be met even at
    # the cheapest degrade rung with ZERO queueing — rejecting up front
    # costs nothing; shedding later costs the capacity already spent
    admission_control: bool = True
    degrade: bool = True
    min_stages: int = 1
    degrade_headroom: float = 0.85
    restore_headroom: float = 0.30
    # wait-for-coalesce: hold a sub-bucket batch if the next arrival is
    # within this fraction of the tightest pending budget
    coalesce_wait_frac: float = 0.25
    max_batch: Optional[int] = None  # cap rows per submit (default: top bucket)
    cost_ewma: float = 0.25          # smoothing for observed per-row cost


@dataclass
class FrontEndStats:
    requests_total: int = 0
    requests_done: int = 0
    requests_met_slo: int = 0
    requests_shed: int = 0        # requests with >= 1 shed record
    # admission-time refusals: distinct from shed — a rejected request
    # never occupied queue capacity or engine work at all
    requests_rejected_admission: int = 0
    records_rejected_admission: int = 0
    records_submitted: int = 0
    records_emitted: int = 0
    records_rejected: int = 0
    records_shed: int = 0
    batches: int = 0
    degrades: int = 0
    restores: int = 0
    final_level: int = 0
    served_ms: float = 0.0        # cost-model ms spanned by the run

    @property
    def throughput_rps(self) -> float:
        """Raw request throughput: completed requests per cost-model
        second (shed-or-late requests still complete and count here)."""
        return self.requests_done / (self.served_ms / 1e3) if self.served_ms else 0.0

    @property
    def goodput_rps(self) -> float:
        """Requests per cost-model second that met their SLO
        (SNIPPETS.md §2's latency/goodput framing)."""
        return self.requests_met_slo / (self.served_ms / 1e3) if self.served_ms else 0.0

    @property
    def goodput_ratio(self) -> float:
        """goodput / throughput over the same run — the gated quantity
        (requests_met / requests_done; time base cancels)."""
        return self.requests_met_slo / self.requests_done if self.requests_done else 0.0


# ----------------------------------------------------------------- front end
class ServingFrontEnd:
    """Request queue + batching loop + SLO accounting over a
    ``CascadeServer``.

    Usage::

        fe = ServingFrontEnd(engine, policy=SLOPolicy())
        fe.submit_request(idx, rows, deadline_ms=50.0, arrival_ms=0.0)
        fe.run()          # drive to completion (offline trace)
        fe.stats.goodput_ratio

    or tick-at-a-time via ``step()`` for callers that interleave other
    work (quorum swaps, drift re-optimization) between ticks.
    """

    def __init__(self, engine: CascadeServer, *,
                 policy: Optional[SLOPolicy] = None):
        self.engine = engine
        self.policy = policy or SLOPolicy()
        self.stats = FrontEndStats()
        self.now_ms = 0.0
        self.requests: Dict[int, Request] = {}
        self._arrivals: List[Request] = []   # not yet admitted, arrival order
        self._pending: Deque[Request] = deque()  # admitted, rows left to submit
        self._owner: Dict[int, int] = {}     # record idx -> rid
        self._next_rid = 0
        self._cost_seen = float(engine.stats.model_cost_ms)
        self._t0_ms: Optional[float] = None
        self._just_finalized: List[int] = []  # rids whose outstanding hit 0
        # degrade ladder: scorers are prebuilt ONCE here, on the engine's
        # device, so a mid-stream degrade install packs and uploads nothing
        self._ladder: List[Tuple[PhysicalPlan, object]] = []
        self.level = 0
        base = engine.plan
        self._base_cost = base.est_total_cost or 1.0
        if self.policy.degrade and len(base.stages) > self.policy.min_stages:
            for p in degrade_ladder(base, min_stages=self.policy.min_stages):
                scorer, _ = cascade_scorer_for_plan(
                    p, max_tile=max(engine.tile, 1024), device=engine.device)
                self._ladder.append((p, scorer))
        # per-row cost estimate (cost-model ms) for wait prediction,
        # seeded from the plan's own Eq. 3.1 estimate
        self._row_ms = float(self._base_cost)
        # called with the index array right before each engine.submit —
        # the batching loop defers rows past their chunk arrival, so
        # anything keyed to "version current at submission" (e.g. the
        # sharded submit_version cross-check) must attach HERE, not at
        # request ingestion
        self._submit_hooks: List = []
        engine.add_finalize_hook(self._on_finalized)
        cascade = engine._states[-1].cascade
        top = cascade.buckets[-1] if cascade is not None else engine.tile
        # coalescing ladder: geometric from the engine tile up to the
        # scorer's top bucket.  The scorer scores EVERY submission in one
        # of its bucket-sized buffers, so a sub-bucket micro-batch costs
        # no new buffer, and small requests are not held hostage while
        # their deadline burns.
        buckets = []
        size = min(max(engine.tile, 1), top)
        while size < top:
            buckets.append(size)
            size *= 2
        buckets.append(top)
        self._buckets: Tuple[int, ...] = tuple(buckets)

    def add_submit_hook(self, fn) -> None:
        """Register ``fn(indices)`` to run right before every
        ``engine.submit`` the batching loop issues."""
        self._submit_hooks.append(fn)

    # ------------------------------------------------------------- ingestion
    def submit_request(self, indices, rows, *, deadline_ms: float,
                       arrival_ms: float = 0.0) -> int:
        """Enqueue a request; returns its rid.  ``arrival_ms`` is on the
        cost-model clock (an offline trace replays arrivals by passing
        increasing stamps)."""
        indices = np.asarray(indices)
        rows = np.asarray(rows, np.float32)
        if len(indices) != len(rows):
            raise ValueError("indices/rows length mismatch")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, indices, rows, float(arrival_ms), float(deadline_ms))
        self.requests[rid] = req
        self._arrivals.append(req)
        self._arrivals.sort(key=lambda r: r.arrival_ms)
        self.stats.requests_total += 1
        for i in indices:
            i = int(i)
            if i in self._owner:
                raise ValueError(
                    f"record index {i} already owned by request "
                    f"{self._owner[i]}: indices must be globally unique")
            self._owner[i] = rid
        return rid

    # ------------------------------------------------------- engine callback
    def _on_finalized(self, emitted: List[int], rejected: List[int],
                      version: int) -> None:
        for ids, what in ((emitted, "emitted"), (rejected, "rejected")):
            for i in ids:
                rid = self._owner.get(int(i))
                if rid is None:
                    continue  # records submitted around the front end
                req = self.requests[rid]
                req.outstanding -= 1
                if what == "emitted":
                    req.emitted += 1
                    self.stats.records_emitted += 1
                else:
                    req.rejected += 1
                    self.stats.records_rejected += 1
                if req.outstanding == 0 and req.cursor >= req.n:
                    self._just_finalized.append(rid)

    # ------------------------------------------------------------ inner gear
    def _tightest_budget(self) -> Optional[float]:
        """min over pending requests of (absolute deadline - now)."""
        budgets = [r.absolute_deadline - self.now_ms for r in self._pending]
        return min(budgets) if budgets else None

    def _queued_rows(self) -> int:
        return sum(r.n - r.cursor for r in self._pending)

    def _predicted_wait_ms(self) -> float:
        """Queue-drain estimate: unsubmitted rows x EWMA per-row
        cost-model cost (observed at the CURRENT degrade level)."""
        return self._queued_rows() * self._row_ms

    def _cheapest_row_ms(self) -> float:
        """Per-row cost-model estimate at the degrade ladder's CHEAPEST
        rung: the observed EWMA (tracking the current level) rescaled by
        the Eq. 3.1 price ratio — the best-case service rate any amount
        of degrading could reach."""
        cur_est = (self._ladder[self.level][0].est_total_cost
                   if self._ladder else self._base_cost) or self._base_cost
        cheap_est = (self._ladder[-1][0].est_total_cost
                     if self._ladder else cur_est) or cur_est
        return self._row_ms * cheap_est / max(cur_est, 1e-12)

    def _admit(self) -> int:
        n = 0
        while self._arrivals and self._arrivals[0].arrival_ms <= self.now_ms + 1e-9:
            req = self._arrivals.pop(0)
            if self._t0_ms is None:
                self._t0_ms = req.arrival_ms
            if req.n == 0:  # degenerate empty request: done on arrival
                self._finish(req)
                continue
            if self.policy.admission_control \
                    and req.n * self._cheapest_row_ms() > req.deadline_ms + 1e-9:
                # provably unmeetable: even with an empty queue at the
                # cheapest rung, pure service time exceeds the deadline.
                # Refuse now — the client learns immediately, and no
                # queue slot or engine work is wasted on a lost cause
                req.admission_rejected = True
                self.stats.requests_rejected_admission += 1
                self.stats.records_rejected_admission += req.n
                self._finish(req)
                continue
            self._pending.append(req)
            n += 1
        return n

    def _shed_expired(self) -> None:
        """Drop the *unsubmitted* remainder of any pending request whose
        deadline has already passed — submitted rows still finish (the
        engine never abandons in-flight work), but spending more capacity
        on a lost cause only makes the next request late too.  Shedding
        is explicit: ids are recorded on the request and counted."""
        if not self.policy.shed_expired:
            return
        keep: Deque[Request] = deque()
        for req in self._pending:
            if req.absolute_deadline < self.now_ms - 1e-9 and req.cursor < req.n:
                shed = [int(i) for i in req.indices[req.cursor:]]
                req.shed_ids.extend(shed)
                req.cursor = req.n
                self.stats.records_shed += len(shed)
                self.stats.requests_shed += 1
                if req.outstanding == 0:
                    self._finish(req)
            else:
                keep.append(req)
        self._pending = keep

    def _backpressure(self) -> None:
        """One hysteresis ladder step per tick, driven by predicted wait
        vs the tightest pending deadline budget."""
        if not self._ladder:
            return
        budget = self._tightest_budget()
        if budget is None:
            # idle queue: drift back toward the full plan
            if self.level > 0:
                self._set_level(self.level - 1, restore=True)
            return
        wait = self._predicted_wait_ms()
        if wait > self.policy.degrade_headroom * max(budget, 0.0):
            # escalate as many levels as the burst needs IN THIS TICK —
            # an arrival burst can outrun a one-level-per-tick ladder
            # before the queue ever drains (_set_level rescales _row_ms,
            # so the re-predicted wait reflects each cheaper level)
            while wait > self.policy.degrade_headroom * max(budget, 0.0) \
                    and self.level < len(self._ladder) - 1:
                self._set_level(self.level + 1)
                wait = self._predicted_wait_ms()
        elif wait < self.policy.restore_headroom * max(budget, 0.0) \
                and self.level > 0:
            self._set_level(self.level - 1, restore=True)

    def _set_level(self, level: int, *, restore: bool = False) -> None:
        plan, scorer = self._ladder[level]
        # scale the per-row cost estimate to the new level's Eq. 3.1
        # price so the next tick's wait prediction doesn't lag a ladder
        # step behind reality
        old_est = (self._ladder[self.level][0].est_total_cost or self._base_cost)
        new_est = plan.est_total_cost or self._base_cost
        self._row_ms *= new_est / max(old_est, 1e-12)
        self.level = level
        self.engine.install_plan(plan, scorer=scorer)
        if restore:
            self.stats.restores += 1
        else:
            self.stats.degrades += 1
        self.stats.final_level = level

    def _coalesce(self) -> Tuple[List[int], List[np.ndarray]]:
        """FIFO-assemble the next micro-batch: fill to the largest
        coalescing-ladder rung that the queue can cover (requests split
        freely across batches), never beyond the scorer's top bucket —
        the scorer bucket-pads every rung, so each resulting shape is
        already among the fused scorer's buffers."""
        queued = self._queued_rows()
        if queued == 0:
            return [], []
        cap = self.policy.max_batch or self._buckets[-1]
        budget = self._tightest_budget()
        if budget is not None and self._row_ms > 0:
            # completion is attributed per batch, so the head-of-queue
            # request waits for EVERY row coalesced in front of its last
            # one — never grow the batch past what its remaining deadline
            # budget can pay for (degrade_headroom keeps slack for EWMA
            # noise; floor 1 so the queue always makes progress — an
            # already-expired head is _shed_expired's problem, not ours)
            afford = int(self.policy.degrade_headroom
                         * max(budget, 0.0) / self._row_ms)
            cap = max(1, min(cap, afford))
        target = self._buckets[0]
        for b in self._buckets:
            if b <= min(queued, cap):
                target = b
        take = min(queued, target, cap)
        idxs: List[int] = []
        rows: List[np.ndarray] = []
        while take > 0 and self._pending:
            req = self._pending[0]
            k = min(take, req.n - req.cursor)
            sl = slice(req.cursor, req.cursor + k)
            idxs.extend(int(i) for i in req.indices[sl])
            rows.extend(req.rows[sl])
            req.cursor += k
            req.outstanding += k
            take -= k
            if req.cursor >= req.n:
                self._pending.popleft()
        return idxs, rows

    def _should_wait(self) -> bool:
        """Hold a sub-bucket batch when another arrival is imminent
        relative to the tightest deadline — classic batching/latency
        tradeoff, resolved in favor of the deadline."""
        if not self._arrivals or self._queued_rows() >= self._buckets[0]:
            return False
        budget = self._tightest_budget()
        if budget is None:
            return True  # nothing pending at all: just jump to the arrival
        gap = self._arrivals[0].arrival_ms - self.now_ms
        return gap <= self.policy.coalesce_wait_frac * budget

    def _advance_clock(self) -> None:
        cost = float(self.engine.stats.model_cost_ms)
        self.now_ms += cost - self._cost_seen
        self._cost_seen = cost

    def _finish(self, req: Request) -> None:
        if req.done_ms is not None:
            return
        req.done_ms = self.now_ms
        self.stats.requests_done += 1
        if req.met_slo:
            self.stats.requests_met_slo += 1

    def _flush_finalized(self) -> None:
        for rid in self._just_finalized:
            self._finish(self.requests[rid])
        self._just_finalized.clear()

    # ------------------------------------------------------------------ loop
    def step(self) -> bool:
        """One tick: admit, shed, backpressure, coalesce+submit, drain,
        advance the clock, stamp completions.  Returns False when no work
        remains anywhere (arrivals, queue, engine)."""
        self._admit()
        self._shed_expired()
        self._backpressure()
        idxs, rows = ([], []) if self._should_wait() else self._coalesce()
        if idxs:
            submitted = len(idxs)
            arr = np.asarray(idxs)
            for hook in self._submit_hooks:
                hook(arr)
            self.engine.submit(arr, np.stack(rows))
            # drain-mode pump: a serving loop flushes partial tiles every
            # tick — deadline latency beats tile efficiency, and the
            # cost model charges per record either way
            self.engine.pump(drain=True)
            self.stats.records_submitted += submitted
            self.stats.batches += 1
            before = self.now_ms
            self._advance_clock()
            tick_ms = self.now_ms - before
            if submitted and tick_ms > 0:
                a = self.policy.cost_ewma
                self._row_ms += a * (tick_ms / submitted - self._row_ms)
            self._flush_finalized()
            self._shed_expired()  # the tick may have blown deadlines
        elif self._arrivals and not self._pending:
            # idle: jump the clock to the next arrival
            self.now_ms = max(self.now_ms, self._arrivals[0].arrival_ms)
        elif self._arrivals:
            # waiting to coalesce: time passes to the arrival we held for
            self.now_ms = max(self.now_ms, self._arrivals[0].arrival_ms)
        self.stats.served_ms = self.now_ms - (self._t0_ms or 0.0)
        return bool(self._arrivals or self._pending
                    or self.engine.in_flight() > 0)

    def drain(self) -> None:
        """Flush everything in flight and stamp the stragglers."""
        self.engine.pump(drain=True)
        self._advance_clock()
        self._flush_finalized()
        for req in list(self._pending):
            if req.cursor >= req.n and req.outstanding == 0:
                self._finish(req)
        self.stats.served_ms = self.now_ms - (self._t0_ms or 0.0)

    def run(self, *, max_ticks: int = 1_000_000) -> FrontEndStats:
        ticks = 0
        while self.step():
            ticks += 1
            if ticks >= max_ticks:  # pragma: no cover - safety valve
                break
        self.drain()
        return self.stats

    # -------------------------------------------------------------- external
    def on_external_swap(self) -> None:
        """Tell the front end an external (quorum) plan swap happened:
        the degrade ladder belongs to the OLD plan, so it is rebuilt only
        on the next explicit request — here we just drop it and reset the
        level (sharded mode runs shed-only anyway; DESIGN.md §7)."""
        self.level = 0
        self._ladder = []

    # ---------------------------------------------------------- verification
    def conserved(self) -> Tuple[bool, str]:
        """The falsifiable conservation statement, checkable after
        ``drain()``: per request submitted == emitted + rejected,
        cursor covered every row, engine pipe empty, and no shed id was
        ever emitted."""
        if self.engine.in_flight() != 0:
            return False, f"in_flight={self.engine.in_flight()} after drain"
        emitted = set(self.engine.emitted)
        if len(emitted) != len(self.engine.emitted):
            return False, "duplicate emissions"
        for req in self.requests.values():
            if req.admission_rejected:
                # never entered the pipeline: nothing submitted, shed,
                # emitted, or in flight may be attributed to it
                if (req.cursor, req.outstanding, req.emitted,
                        req.rejected, req.shed) != (0, 0, 0, 0, 0):
                    return False, (f"rid {req.rid}: admission-rejected "
                                   f"request has pipeline activity")
                continue
            if req.cursor != req.n:
                return False, f"rid {req.rid}: {req.n - req.cursor} rows unaccounted"
            if req.submitted != req.emitted + req.rejected:
                return False, (f"rid {req.rid}: submitted {req.submitted} != "
                               f"emitted {req.emitted} + rejected {req.rejected}")
            for i in req.shed_ids:
                if i in emitted:
                    return False, f"rid {req.rid}: shed record {i} was emitted"
        return True, "ok"
