"""Baseline optimizers reproduced for comparison (§6.1):

* ORIG — run the query as-is (no proxies).
* NS   — NoScope-style: ONE proxy for the whole conjunction, trained on the
         raw input, inserted at the front with accuracy A.
* PP   — Probabilistic Predicates: per-predicate proxies trained on the RAW
         input (independence assumption); order + accuracies chosen with the
         same cost model but with *unconditional* selectivities and
         raw-input reduction curves — exactly the over-estimate the paper
         fixes.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.accuracy import alpha_frontier
from repro_torch.core.builder import ProxyBuilder
from repro_torch.core.cost import plan_cost
from repro_torch.core.proxy import ProxyModel, train_proxy
from repro_torch.core.query import PhysicalPlan, PlanStage, Query, all_orders
from repro_torch.util import advisory_wall_ms



def orig_plan(query: Query) -> PhysicalPlan:
    stages = [PlanStage(pred_idx=i, proxy=None, alpha=1.0) for i in range(query.n)]
    cost = 0.0
    prefix = 1.0
    for i, p in enumerate(query.predicates):
        cost += prefix * p.udf.cost
        prefix *= 0.5  # nominal; ORIG cost is measured empirically anyway
    return PhysicalPlan(query=query, stages=stages, est_total_cost=cost,
                        meta={"mode": "orig", "stats": {}, "wall_ms": 0.0})


def ns_plan(query: Query, x_sample: np.ndarray, *, kind: str = "svm",
            seed: int = 0, device="cuda") -> PhysicalPlan:
    """Single conjunction proxy at the front (NoScope-style), trained on
    ``device``."""
    t0 = advisory_wall_ms()
    builder = ProxyBuilder(query, x_sample, kind=kind, seed=seed, device=device)
    rows = np.arange(builder.n)
    conj = np.ones(builder.n, bool)
    for i in range(query.n):
        conj &= builder.sigma_mask(i, rows)
    t1 = advisory_wall_ms()
    # the single conjunction proxy has no per-predicate family assignment;
    # "mixed" / per-predicate maps degrade to linear (builder.family_for
    # needs a pred index)
    conj_kind = kind if isinstance(kind, str) and kind != "mixed" else "linear"
    proxy = train_proxy(builder.x, conj, pred_idx=-1, d=(), kind=conj_kind, seed=seed,
                        device=builder.device)
    training_ms = advisory_wall_ms() - t1
    A = query.accuracy_target
    stages = [
        PlanStage(
            pred_idx=0, proxy=proxy, alpha=A,
            threshold=proxy.r_curve.threshold_for(A),
            est_reduction=proxy.r_curve.reduction_for(A),
        )
    ] + [PlanStage(pred_idx=i, proxy=None, alpha=1.0) for i in range(1, query.n)]
    stats = builder.stats.as_dict()
    stats["training_ms"] += training_ms
    return PhysicalPlan(
        query=query, stages=stages, est_total_cost=0.0,
        meta={"mode": "ns", "stats": stats, "wall_ms": advisory_wall_ms() - t0},
    )


def pp_plan(query: Query, x_sample: np.ndarray, *, kind: str = "svm",
            step: float = 0.02, seed: int = 0, device="cuda") -> PhysicalPlan:
    """Probabilistic Predicates: offline-style independent proxies.

    Each proxy is trained on the raw sample (d = empty) with labels from its
    own predicate; the optimizer then assembles them assuming independence:
    s_i = unconditional selectivity, r_i = raw R-curve reduction.  Proxies
    train on ``device``.
    """
    t0 = advisory_wall_ms()
    builder = ProxyBuilder(query, x_sample, kind=kind, seed=seed, device=device)
    rows = np.arange(builder.n)
    proxies: List[ProxyModel] = []
    sel: List[float] = []
    for i in range(query.n):
        proxy, _ = builder.get_proxy(i, (), ())  # raw input relation
        proxies.append(proxy)
        sel.append(builder.selectivity(i, rows))
    A = query.accuracy_target
    best = None
    for order in all_orders(query.n):
        for alphas in alpha_frontier(query.n, A, step):
            reds = [proxies[p].r_curve.reduction_for(alphas[i]) for i, p in enumerate(order)]
            cost = plan_cost(
                alphas, reds, [sel[p] for p in order],
                [proxies[p].cost for p in order],
                [query.predicates[p].udf.cost for p in order],
            )
            if best is None or cost < best[0]:
                best = (cost, order, tuple(alphas), reds)
    cost, order, alphas, reds = best
    stages = [
        PlanStage(
            pred_idx=p, proxy=proxies[p], alpha=alphas[i],
            threshold=proxies[p].r_curve.threshold_for(alphas[i]),
            est_reduction=reds[i], est_selectivity=sel[p],
        )
        for i, p in enumerate(order)
    ]
    return PhysicalPlan(
        query=query, stages=stages, est_total_cost=cost,
        meta={"mode": "pp", "stats": builder.stats.as_dict(),
              "wall_ms": advisory_wall_ms() - t0},
    )
