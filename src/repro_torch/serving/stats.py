"""Streaming statistics for the adaptive serving loop (DESIGN.md §4),
numpy only: the JAX package's ``serving/stats.py`` with its cost-model
import pointed at this package.

The server maintains, per installed plan version:

* ``StreamingRate`` per stage — observed proxy keep-rates and UDF pass
  rates, compared against the plan's ``est_reduction`` /
  ``est_selectivity``;
* ``CusumDetector`` per signal — a one-sided CUSUM on the absolute
  deviation between observed and expected rates, so a sustained shift
  triggers re-optimization while sampling noise does not;
* ``Reservoir`` — a strided ring buffer of recent feature rows (with any
  UDF labels the server has already paid for) that becomes the fresh
  optimization sample when drift fires;
* pairwise ``StreamingKappa2`` (core/correlation.py) over audited label
  columns — a shift in predicate correlation structure escalates the
  cheap re-allocation to a warm-started branch-and-bound re-search.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class AdaptivePolicy:
    """Knobs for drift detection and re-optimization."""

    slack: float = 0.08  # deviation below this is ignored (CUSUM drift term)
    threshold: float = 120.0  # cumulative deviation-weighted records to trigger
    audit_rate: float = 0.02  # fraction of records with ALL UDFs run (unbiased stats)
    audit_baseline: int = 200  # audit records that freeze the reference rates
    audit_window: int = 400  # recent-audit window for the escalation decision
    audit_importance: bool = True  # score-distance-weighted audit sampling (IPW-corrected)
    audit_floor: float = 0.25  # min propensity as a fraction of audit_rate (IPW weights stay bounded)
    reservoir_capacity: int = 1024
    reservoir_stride: int = 2  # keep every k-th record (widens the recency window)
    min_reservoir: int = 256  # don't re-optimize on fewer sampled rows
    cooldown_records: int = 2048  # records between consecutive swaps
    kappa_tol: float = 0.08  # |kappa^2 shift| that escalates alloc -> B&B resume
    # pooled labels (fleet-wide, IPW-weighted) that freeze the coordinator's
    # cross-host kappa^2 baseline — reached ~K× sooner than any single
    # host's local audit_baseline, which is what makes evenly-split
    # correlation drifts visible at the fleet level (DESIGN.md §6).
    # 0 (default) disables coordinator-initiated pooled swaps: pooling
    # changes WHO may open a swap (the coordinator, without any vote
    # quorum), so fleets opt in explicitly; ~120 is a typical setting
    kappa_pool_baseline: int = 0
    regret_tol: float = 0.1  # relative cost-model regret that escalates alloc -> B&B
    step: float = 0.05  # Algorithm-1 grid for re-optimization
    escalate: str = "auto"  # "auto" (cost-model regret) | "alloc" | "bnb"

    def choose_escalation(self, plan, fresh_sels: Dict[int, float]) -> Tuple[str, float]:
        """Pick re-optimization depth from the stale plan's estimated
        COST-MODEL REGRET, not the raw rate-shift magnitude: a large
        selectivity shift that leaves the incumbent order optimal only
        needs a re-allocation, while a mild shift that inverts the order
        optimum needs the B&B re-search.  Returns (mode, regret)."""
        regret, _best = estimate_order_regret(plan, fresh_sels)
        return ("bnb" if regret > self.regret_tol else "alloc"), regret


def estimate_order_regret(plan, fresh_sels: Dict[int, float]) -> Tuple[float, Tuple[int, ...]]:
    """Relative Eq.-3.1 regret of keeping the incumbent stage ORDER under
    fresh unconditional selectivity estimates (audit/reservoir statistics).

    Each stage keeps its built proxy (cost, reduction, alpha); only the
    selectivities are refreshed and the order permuted — exactly the part
    of the plan a cheap re-allocation cannot change.  Predicate
    independence is assumed (the estimate has only marginals); a
    correlation-structure shift is escalated separately via kappa².
    Returns (relative regret in [0, 1), best order found).

    Orders are enumerated exhaustively only up to 6 stages; beyond that
    the candidate is the rank-ordering greedy (ascending per-stage cost /
    (1 - pass-rate), the classic optimal rule for independent filters) —
    this runs inside the serving loop on every auto-mode drift trigger,
    so it must stay far cheaper than the B&B it decides whether to pay
    for.
    """
    from itertools import permutations

    from repro_torch.core.cost import plan_cost

    by_pred = {s.pred_idx: s for s in plan.stages}

    def stage_terms(p: int) -> Tuple[float, float]:
        """(unit cost at the stage, pass-rate) under fresh selectivities."""
        s = by_pred[p]
        alpha = s.alpha if s.proxy is not None else 1.0
        red = s.est_reduction if s.proxy is not None else 0.0
        sel = float(fresh_sels.get(p, s.est_selectivity))
        pcost = s.proxy.cost if s.proxy is not None else 0.0
        unit = pcost + (1.0 - red) * plan.query.predicates[p].udf.cost
        return unit, sel * alpha

    def cost_of(order: Tuple[int, ...]) -> float:
        alphas, reds, sels, pcosts, ucosts = [], [], [], [], []
        for p in order:
            s = by_pred[p]
            alphas.append(s.alpha if s.proxy is not None else 1.0)
            reds.append(s.est_reduction if s.proxy is not None else 0.0)
            sels.append(float(fresh_sels.get(p, s.est_selectivity)))
            pcosts.append(s.proxy.cost if s.proxy is not None else 0.0)
            ucosts.append(plan.query.predicates[p].udf.cost)
        return plan_cost(alphas, reds, sels, pcosts, ucosts)

    if len(plan.order) <= 6:
        candidates = permutations(plan.order)
    else:
        greedy = tuple(sorted(
            plan.order,
            key=lambda p: stage_terms(p)[0] / max(1.0 - stage_terms(p)[1], 1e-9),
        ))
        candidates = [greedy]
    incumbent = cost_of(plan.order)
    best_order, best_cost = plan.order, incumbent
    for order in candidates:
        c = cost_of(order)
        if c < best_cost:
            best_order, best_cost = order, c
    regret = (incumbent - best_cost) / max(incumbent, 1e-12)
    return float(regret), tuple(best_order)


class ImportanceAuditSampler:
    """Score-distance-weighted audit selection with inverse-propensity
    correction.

    Uniform auditing spends most of its UDF budget on records far from
    every proxy threshold — records whose labels the proxies already get
    right.  This sampler up-weights records NEAR a decision boundary
    (small ``margin`` = distance from the record's score to the nearest
    stage threshold) and corrects the induced bias by weighting each
    audited record by ``1 / propensity`` (Horvitz-Thompson), so corrected
    selectivity estimates stay unbiased on any stream — property-tested in
    ``tests/test_streaming_stats.py``.

    Propensities are floored at ``floor * rate`` so IPW weights stay
    bounded, and mean-normalized so the expected audit budget stays
    ``rate * N`` per chunk.
    """

    def __init__(self, rate: float, floor: float = 0.25):
        self.rate = float(rate)
        self.floor = float(floor)

    def propensities(self, margins: Optional[np.ndarray], n: int) -> np.ndarray:
        """Per-record audit probability.  ``margins=None`` (no fused scorer
        to read distances from) degrades to uniform ``rate``."""
        if margins is None:
            return np.full(n, self.rate)
        m = np.abs(np.asarray(margins, np.float64))
        scale = np.median(m)
        if not np.isfinite(scale) or scale <= 0.0:
            return np.full(n, self.rate)
        w = 2.0 / (1.0 + m / scale)  # (0, 2]: ~2 at the boundary, ->0 far away
        w /= max(w.mean(), 1e-12)  # E[#audits] stays rate * N
        return np.clip(self.rate * w, self.floor * self.rate, 1.0)

    def select(self, margins: Optional[np.ndarray], n: int,
               rng: np.random.RandomState):
        """Returns (selected bool (n,), ipw weights (n_selected,))."""
        p = self.propensities(margins, n)
        sel = rng.random_sample(n) < p
        return sel, 1.0 / p[sel]


class StreamingRate:
    """Chunk-wise keep-rate estimator: exactly matches the batch empirical
    rate over the same rows, regardless of chunking.  Counts may be
    fractional (importance-weighted audit totals)."""

    def __init__(self):
        self.kept = 0.0
        self.seen = 0.0

    def update(self, kept: float, seen: float) -> None:
        self.kept += kept
        self.seen += seen

    @property
    def rate(self) -> float:
        return self.kept / self.seen if self.seen else 0.0


class CusumDetector:
    """One-sided CUSUM on |observed - expected| with a slack deadband.

    ``update`` folds one batch: the score grows by
    ``weight * (|obs - exp| - slack)`` and is clamped at zero, so short
    noise bursts decay while a sustained shift accumulates to the
    threshold.  ``weight`` is the number of records in the batch — the
    threshold therefore reads as "deviation-weighted records".
    """

    def __init__(self, slack: float, threshold: float):
        self.slack = slack
        self.threshold = threshold
        self.score = 0.0

    def update(self, observed: float, expected: float, weight: float) -> bool:
        dev = abs(observed - expected) - self.slack
        self.score = max(0.0, self.score + weight * dev)
        return self.score >= self.threshold

    def reset(self) -> None:
        self.score = 0.0


class Reservoir:
    """Strided ring buffer of recent stream rows + observed sigma labels.

    Every ``stride``-th submitted record lands in a slot (round-robin), so
    the buffer always holds the last ``capacity * stride`` records'
    subsample — recency is what drift re-optimization needs, not a uniform
    all-history sample.  ``observe`` attaches per-predicate sigma outcomes
    for rows whose UDFs the server has already run (audit records mainly);
    those labels seed the rebased ProxyBuilder so re-optimization does not
    re-pay UDF calls it already made.
    """

    def __init__(self, n_preds: int, capacity: int = 1024, stride: int = 2):
        self.n_preds = n_preds
        self.capacity = capacity
        self.stride = max(1, stride)
        self._rows: List[Optional[np.ndarray]] = [None] * capacity
        self._known: List[np.ndarray] = [np.zeros(capacity, bool)
                                         for _ in range(n_preds)]
        self._sigma: List[np.ndarray] = [np.zeros(capacity, bool)
                                         for _ in range(n_preds)]
        self._weight: np.ndarray = np.ones(capacity)  # IPW audit weights
        self._slot_of: Dict[int, int] = {}  # global record idx -> slot
        self._idx_at: List[Optional[int]] = [None] * capacity
        self._tick = 0
        self._write = 0

    def add(self, idx: int, row: np.ndarray, *, force: bool = False) -> bool:
        """Offer one record; returns True when it was sampled in.

        ``force=True`` bypasses the stride gate (no-op if already
        resident): audited records are force-added so their paid-for UDF
        labels always ride into the next re-optimization sample and the
        reservoir's selectivity estimates.  This tilts the ROW sample
        slightly toward proxy thresholds (forced rows are an ~audit_rate
        share of entries, with a bounded propensity ratio): the
        ``selectivity`` estimator undoes the tilt with the stored IPW
        weights, while the re-optimization training sample accepts it —
        boundary-heavy labeled rows are where a retrained proxy's
        decision surface needs resolution (active-learning flavored, and
        the rebuilt plan's thresholds are re-validated on the full
        R-curve either way)."""
        if force:
            if int(idx) in self._slot_of:
                return True
        else:
            take = self._tick % self.stride == 0
            self._tick += 1
            if not take:
                return False
        slot = self._write % self.capacity
        self._write += 1
        old = self._idx_at[slot]
        if old is not None:
            self._slot_of.pop(old, None)
        self._rows[slot] = np.asarray(row, np.float32)
        self._idx_at[slot] = int(idx)
        self._slot_of[int(idx)] = slot
        for p in range(self.n_preds):
            self._known[p][slot] = False
            self._sigma[p][slot] = False
        self._weight[slot] = 1.0
        return True

    def observe(self, idx: int, pred_idx: int, sigma: bool,
                weight: float = 1.0) -> None:
        """Attach an observed sigma label; ``weight`` is the record's
        inverse audit propensity, so reservoir selectivities can undo the
        importance sampling bias (labels arrive via threshold-weighted
        audits, not uniformly)."""
        slot = self._slot_of.get(int(idx))
        if slot is None:
            return
        self._known[pred_idx][slot] = True
        self._sigma[pred_idx][slot] = bool(sigma)
        self._weight[slot] = float(weight)

    def selectivity(self, pred_idx: int, *, min_labels: int = 16) -> Optional[float]:
        """IPW-corrected unconditional selectivity estimate over the
        reservoir's labeled rows — the freshest drift-grade statistic the
        server has (the reservoir spans only the last
        ``capacity * stride`` records).  None below ``min_labels``."""
        known = self._known[pred_idx]
        if int(known.sum()) < min_labels:
            return None
        w = self._weight[known]
        s = self._sigma[pred_idx][known]
        denom = float(w.sum())
        return float((w * s).sum() / denom) if denom > 0 else None

    @property
    def size(self) -> int:
        return sum(r is not None for r in self._rows)

    def export(self) -> "ReservoirSample":
        """Full weighted snapshot — rows, labels, AND the per-row IPW
        weights.  ``sample()`` used to drop the weights, which silently
        broke any downstream estimator over the exported rows (the audit
        tilt toward proxy thresholds became uncorrectable once the rows
        left the reservoir); multi-host merging needs them preserved."""
        slots = [s for s, r in enumerate(self._rows) if r is not None]
        x = (np.stack([self._rows[s] for s in slots]) if slots
             else np.empty((0, 0), np.float32))
        known_sigma = {
            p: (self._known[p][slots].copy(), self._sigma[p][slots].copy())
            for p in range(self.n_preds)
        }
        return ReservoirSample(
            indices=np.asarray([self._idx_at[s] for s in slots], np.int64),
            x=x, known_sigma=known_sigma,
            weights=self._weight[slots].copy(),
        )

    def sample(self) -> Tuple[np.ndarray, Dict[int, Tuple[np.ndarray, np.ndarray]]]:
        """(x (M, F), {pred_idx: (known_mask (M,), sigma (M,))}) — the
        re-optimization sample.  Use ``export()`` when the consumer needs
        the IPW weights too (selectivity estimation, multi-host merge)."""
        exp = self.export()
        return exp.x, exp.known_sigma


@dataclass
class ReservoirSample:
    """One reservoir's exported snapshot (or a merge of several).

    ``weights[i]`` is row i's inverse inclusion propensity into the
    LABELED pool (audit IPW; 1.0 for unlabeled strided rows), so any
    Horvitz-Thompson estimator over the export matches the reservoir's own
    ``selectivity`` — including after concatenating exports from many
    hosts (``merge_reservoir_samples``, order-insensitive by symmetry of
    the weighted sums).
    """

    indices: np.ndarray  # (M,) global record indices
    x: np.ndarray  # (M, F)
    known_sigma: Dict[int, Tuple[np.ndarray, np.ndarray]]
    weights: np.ndarray  # (M,) inverse inclusion propensities

    @property
    def n_rows(self) -> int:
        return int(self.x.shape[0])


def merge_reservoir_samples(samples: List["ReservoirSample"]) -> "ReservoirSample":
    """Pool per-host reservoir exports into one optimization sample,
    IPW weights preserved.  Pure concatenation: each row keeps the weight
    its own host assigned (inclusion was decided host-locally), so the
    merged HT estimator equals the one a single reservoir holding the
    union would produce — the multi-host merge property test."""
    samples = [s for s in samples if s.n_rows]
    if not samples:
        return ReservoirSample(
            indices=np.empty(0, np.int64), x=np.empty((0, 0), np.float32),
            known_sigma={}, weights=np.empty(0))
    preds = sorted({p for s in samples for p in s.known_sigma})
    known_sigma = {}
    for p in preds:
        ks = [s.known_sigma.get(
            p, (np.zeros(s.n_rows, bool), np.zeros(s.n_rows, bool)))
            for s in samples]
        known_sigma[p] = (np.concatenate([k for k, _ in ks]),
                         np.concatenate([g for _, g in ks]))
    return ReservoirSample(
        indices=np.concatenate([s.indices for s in samples]),
        x=np.concatenate([s.x for s in samples]),
        known_sigma=known_sigma,
        weights=np.concatenate([s.weights for s in samples]),
    )


def ipw_selectivity(sample: "ReservoirSample", pred_idx: int,
                    *, min_labels: int = 1) -> Optional[float]:
    """Horvitz-Thompson selectivity over an exported (or merged) sample:
    ``Σ w·σ / Σ w`` across labeled rows.  None below ``min_labels``."""
    ks = sample.known_sigma.get(pred_idx)
    if ks is None:
        return None
    known, sigma = ks
    if int(known.sum()) < min_labels:
        return None
    w = sample.weights[known]
    denom = float(w.sum())
    return float((w * sigma[known]).sum() / denom) if denom > 0 else None


@dataclass
class DriftEvent:
    """One trigger of the drift detector (recorded in ServeStats)."""

    at_record: int
    signal: str  # e.g. "stage1:udf", "stage0:proxy", "audit:sel:2"
    observed: float
    expected: float
    escalated: bool  # True -> warm B&B resume, False -> re-allocation
    reopt_ms: float = 0.0
    nodes_visited: int = 0
    plan_version: int = 0
    order_before: tuple = ()
    order_after: tuple = ()
