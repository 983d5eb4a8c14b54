"""CORE optimizer entry points: ``OptimizeOptions``, ``build_plan`` and
``rebuild_plan``.

``OptimizeOptions`` carries every optimizer knob; ``build_plan`` builds
proxies online on the optimization sample and searches the plan,
``rebuild_plan`` re-optimizes a plan against fresh statistics.  Proxies
train and score on ``device`` (CUDA by default; raises without a card).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.accuracy import Allocation, accuracy_allocation
from repro_torch.core.bnb import BranchAndBound, SearchTrace
from repro_torch.core.builder import ProxyBuilder
from repro_torch.core.proxy_family import QUANT_DTYPES
from repro_torch.core.query import PhysicalPlan, PlanStage, Query, all_orders
from repro_torch.util import advisory_wall_ms


@dataclass(frozen=True)
class OptimizeOptions:
    """Every optimizer knob in one place.

    ``mode`` picks the initial search ("core" | "core-a" | "core-h");
    ``reopt`` picks the re-optimization depth ``rebuild_plan`` uses
    ("alloc" = Algorithm 1 on the incumbent order, "bnb" = warm
    branch-and-bound resume).  ``kind`` is a family name, "mixed", or a
    per-predicate ``{pred_idx: family}`` dict.  ``keep_state=True``
    attaches the live builder (and B&B tree) to ``plan.meta`` so a later
    rebuild can warm-start.  ``quant_dtype`` ("int8" | "fp8") stamps the
    packed-cascade storage dtype onto the plan.
    """

    mode: str = "core"
    kind: object = "svm"
    step: float = 0.02
    eps: float = 0.1
    framework: str = "exhaustive"
    fine_grained: bool = True
    seed: int = 0
    keep_state: bool = False
    quant_dtype: Optional[str] = None
    reopt: str = "alloc"

    def replace(self, **kw) -> "OptimizeOptions":
        return dataclasses.replace(self, **kw)


#: ``rebuild_plan`` defaults to a coarser step and keeps state (an
#: adaptive loop warm-starts the next rebuild from it).
REBUILD_DEFAULTS = OptimizeOptions(step=0.05, keep_state=True)


def _plan_from_allocation(query: Query, alloc: Allocation, meta: dict) -> PhysicalPlan:
    stages = []
    for i, p in enumerate(alloc.order):
        proxy = alloc.proxies[i]
        stages.append(
            PlanStage(
                pred_idx=p,
                proxy=proxy,
                alpha=alloc.alphas[i],
                threshold=proxy.r_curve.threshold_for(alloc.alphas[i]),
                est_reduction=alloc.reductions[i],
                est_selectivity=alloc.selectivities[i],
                est_cost=alloc.stage_costs[i],
            )
        )
    return PhysicalPlan(query=query, stages=stages, est_total_cost=alloc.total_cost, meta=meta)


def _trace_dict(trace: SearchTrace) -> dict:
    return {
        "nodes_total": trace.nodes_total,
        "nodes_visited": trace.nodes_visited,
        "nodes_pruned_frac": trace.nodes_pruned_frac,
        "plans_pruned": trace.plans_pruned,
    }


def build_plan(
    query: Query,
    x_sample: np.ndarray,
    options: Optional[OptimizeOptions] = None,
    *,
    builder: Optional[ProxyBuilder] = None,
    device="cuda",
) -> PhysicalPlan:
    """Build proxy models ONLINE on the optimization sample (on ``device``)
    and return a PhysicalPlan.

    * mode="core"    — branch-and-bound over orders (Alg. 2, fine-grained
                       tree) + accuracy allocation (Alg. 1). [the paper]
    * mode="core-a"  — input order, accuracy allocation only. [§6.5 CORE-a]
    * mode="core-h"  — exhaustive order search.               [§6.5 CORE-h]
    """
    opt = options or OptimizeOptions()
    t_start = advisory_wall_ms()
    A = query.accuracy_target
    builder = builder or ProxyBuilder(query, x_sample, kind=opt.kind,
                                      eps=opt.eps, seed=opt.seed, device=device)
    trace: Optional[SearchTrace] = None
    bb: Optional[BranchAndBound] = None
    if opt.mode == "core-a":
        alloc = accuracy_allocation(builder, tuple(range(query.n)), A,
                                    step=opt.step, framework=opt.framework)
    elif opt.mode == "core-h":
        best = None
        for order in all_orders(query.n):
            alloc = accuracy_allocation(builder, order, A, step=opt.step,
                                        framework=opt.framework)
            if best is None or alloc.total_cost < best.total_cost:
                best = alloc
        alloc = best
    elif opt.mode == "core":
        bb = BranchAndBound(builder, A, step=opt.step,
                            fine_grained=opt.fine_grained,
                            framework=opt.framework)
        alloc, trace = bb.run()
    else:
        raise ValueError(f"unknown mode {opt.mode!r}")
    meta = {
        "mode": opt.mode,
        "stats": builder.stats.as_dict(),
        "wall_ms": advisory_wall_ms() - t_start,
        "plan_version": 0,
    }
    if opt.quant_dtype is not None and opt.quant_dtype != "float32":
        if opt.quant_dtype not in QUANT_DTYPES:
            raise ValueError(f"unknown quant_dtype {opt.quant_dtype!r}")
        meta["quant_dtype"] = opt.quant_dtype
    if trace is not None:
        meta["trace"] = _trace_dict(trace)
    if opt.keep_state:
        meta["builder"] = builder
        if bb is not None:
            meta["bnb"] = bb
    return _plan_from_allocation(query, alloc, meta)


def rebuild_plan(
    plan: PhysicalPlan,
    x_sample: np.ndarray,
    options: Optional[OptimizeOptions] = None,
    *,
    known_sigma: Optional[Dict[int, Tuple[np.ndarray, np.ndarray]]] = None,
    device="cuda",
) -> PhysicalPlan:
    """Re-optimize ``plan`` against fresh statistics.

    ``x_sample`` is the new optimization sample; ``known_sigma`` pre-seeds
    UDF labels already observed (pred_idx -> (known_mask, sigma)).
    ``options.reopt`` picks depth: "alloc" re-runs Algorithm 1 on the
    incumbent stage order, "bnb" re-searches the order space, warm-starting
    from the previous search tree when ``plan.meta["bnb"]`` is present.  A
    carried builder keeps its own device; a fresh one trains on
    ``device``."""
    opt = options or REBUILD_DEFAULTS
    t_start = advisory_wall_ms()
    query = plan.query
    A = query.accuracy_target
    prev_builder: Optional[ProxyBuilder] = plan.meta.get("builder")
    prev_bnb: Optional[BranchAndBound] = plan.meta.get("bnb")
    if prev_builder is None and prev_bnb is not None:
        prev_builder = prev_bnb.builder
    if prev_builder is not None:
        builder = prev_builder.rebase(x_sample, known_sigma=known_sigma)
    else:
        # no carried builder: keep the incumbent plan's exact
        # per-predicate family assignment
        fam_map = {s.pred_idx: s.proxy.family
                   for s in plan.stages if s.proxy is not None}
        builder = ProxyBuilder(query, x_sample, kind=fam_map or opt.kind,
                               eps=opt.eps, seed=opt.seed, device=device)
        if known_sigma:
            builder.seed_labels(known_sigma)
    trace: Optional[SearchTrace] = None
    warm = False
    bb: Optional[BranchAndBound] = None
    if opt.reopt == "alloc":
        alloc = accuracy_allocation(builder, plan.order, A, step=opt.step,
                                    framework=opt.framework)
        bb = prev_bnb  # keep the tree for a later escalation
    elif opt.reopt == "bnb":
        if prev_bnb is not None:
            bb = prev_bnb
            alloc, trace = bb.resume(builder)
            warm = True
        else:
            bb = BranchAndBound(builder, A, step=opt.step,
                                framework=opt.framework)
            alloc, trace = bb.run()
    else:
        raise ValueError(f"unknown reoptimize mode {opt.reopt!r}")
    meta = {
        "mode": f"reopt-{opt.reopt}",
        "stats": builder.stats.as_dict(),
        "wall_ms": advisory_wall_ms() - t_start,
        "plan_version": int(plan.meta.get("plan_version", 0)) + 1,
        "warm_start": warm,
    }
    # a quantized incumbent stays quantized across re-plans
    if plan.meta.get("quant_dtype"):
        meta["quant_dtype"] = plan.meta["quant_dtype"]
    if trace is not None:
        meta["trace"] = _trace_dict(trace)
    if opt.keep_state:
        meta["builder"] = builder
        if bb is not None:
            meta["bnb"] = bb
    return _plan_from_allocation(query, alloc, meta)
