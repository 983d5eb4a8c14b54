"""CORE's session API: the optimizer entry points (``OptimizeOptions``,
``build_plan``, ``rebuild_plan``) and the serving surface (``ServeConfig``,
``QueryHandle``, ``CoreSession``).

``OptimizeOptions`` carries every optimizer knob; ``build_plan`` builds
proxies online on the optimization sample and searches the plan,
``rebuild_plan`` re-optimizes a plan against fresh statistics.
``ServeConfig`` carries the serving knobs that ``CoreSession.serve`` and
the ``launch/serve.py`` CLI share; ``CoreSession`` registers N queries,
optimizes each, and serves them: one query through ``CascadeServer`` (or
the SLO front end), across K hosts through ``ShardedCascadeServer`` (the
fleet, ``distributed/serving.py``), several queries through
``MultiQueryEngine``.  Proxies train and score on ``device`` (CUDA by
default; raises without a card).  A session, a query or a server may take
a cross-query plan cache (``core/plan_cache.py``): queries optimize through
it, servers write their committed plans back to it.

Serving modules are imported inside methods: ``core`` does not depend on
``serving`` or ``distributed`` at import time (both import core).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.accuracy import Allocation, accuracy_allocation
from repro_torch.core.bnb import BranchAndBound, SearchTrace
from repro_torch.core.builder import ProxyBuilder
from repro_torch.core.proxy_family import QUANT_DTYPES
from repro_torch.core.query import PhysicalPlan, PlanStage, Query, all_orders
from repro_torch.util import advisory_wall_ms, resolve_device


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
    warm_start=None,
    device="cuda",
) -> PhysicalPlan:
    """Build proxy models ONLINE on the optimization sample (on ``device``)
    and return a PhysicalPlan.

    * mode="core"    — branch-and-bound over orders (Alg. 2, fine-grained
                       tree) + accuracy allocation (Alg. 1). [the paper]
    * mode="core-a"  — input order, accuracy allocation only. [§6.5 CORE-a]
    * mode="core-h"  — exhaustive order search.               [§6.5 CORE-h]

    ``warm_start`` is a cross-query donor state from the plan cache
    (``plan_cache.WarmStart``: classifiers / s_stars / orders): the
    builder adopts the donor's trained-classifier cache (re-validated by
    the Eq.-4.7 eps test before any reuse), and mode="core" seeds the
    branch-and-bound tree with the donor's stale L-node measurements and
    surviving candidate set, then ``resume``s instead of cold-running."""
    opt = options or OptimizeOptions()
    t_start = advisory_wall_ms()
    A = query.accuracy_target
    builder = builder or ProxyBuilder(query, x_sample, kind=opt.kind,
                                      eps=opt.eps, seed=opt.seed, device=device)
    if warm_start is not None and warm_start.classifiers:
        builder.adopt_classifiers(warm_start.classifiers)
    trace: Optional[SearchTrace] = None
    bb: Optional[BranchAndBound] = None
    warmed = False
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
        if warm_start is not None and warm_start.s_stars:
            bb.seed_from(warm_start.s_stars, orders=warm_start.orders)
            alloc, trace = bb.resume()
            warmed = True
        else:
            alloc, trace = bb.run()
    else:
        raise ValueError(f"unknown mode {opt.mode!r}")
    meta = {
        "mode": opt.mode,
        "stats": builder.stats.as_dict(),
        "wall_ms": advisory_wall_ms() - t_start,
        "plan_version": 0,
    }
    if warmed:
        meta["warm_start"] = True
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


# --------------------------------------------------------------- serving API
@dataclass
class ServeConfig:
    """Serving knobs, shared between ``CoreSession.serve`` and the
    ``launch/serve.py`` CLI (every flag maps onto one field).  ``slo_ms``
    wraps the engine in the deadline-aware request front end;
    ``queries_path`` points at a multi-query JSON spec served through one
    ``CoreSession``.  ``plan_cache_path`` names the serve CLI's plan-cache
    file (only the CLI reads it; a session takes a ``PlanCache`` object).
    ``hosts > 1`` serves across K simulated hosts (the fleet), with
    ``transport``, ``kill_coordinator_at`` and ``straggler_host``;
    ``drift_skew`` shapes the serve CLI's sharded drifting streams.  With
    ``hosts == 1`` the fleet's knobs are left unread.  There is no switch
    around the scorer: every proxied stage is scored by ``cascade_score``
    on a card, by its plain route on the CPU."""

    tile: int = 1024
    adaptive: bool = False
    hosts: int = 1
    transport: str = "inline"
    slo_ms: Optional[float] = None
    arrival_rate: Optional[float] = None
    request_rows: int = 128
    backpressure: bool = True
    seed: int = 0
    drift: bool = False
    drift_skew: float = 0.3
    kill_coordinator_at: Optional[str] = None
    straggler_host: Optional[int] = None
    plan_cache_path: Optional[str] = None
    queries_path: Optional[str] = None

    def replace(self, **kw) -> "ServeConfig":
        return dataclasses.replace(self, **kw)


class QueryHandle:
    """One registered query inside a ``CoreSession``: its options, its
    optimized plan, and per-query serving stats.  ``handle.optimize()``
    builds the plan on the session's device (through the query's plan
    cache when one is attached); ``handle.submit()`` routes records to
    this query only; ``handle.stats()`` reads this query's serving
    counters."""

    def __init__(self, session: "CoreSession", qid: int, query: Query,
                 x_sample: Optional[np.ndarray], *, options: OptimizeOptions,
                 plan_cache=None, slo: Optional[float] = None):
        self.session = session
        self.qid = qid
        self.query = query
        self.x_sample = x_sample
        self.options = options
        self.plan_cache = plan_cache
        self.slo = slo
        self.plan: Optional[PhysicalPlan] = None
        self.optimize_info: Optional[dict] = None

    def optimize(self, x_sample: Optional[np.ndarray] = None, *,
                 options: Optional[OptimizeOptions] = None,
                 warm_start=None) -> PhysicalPlan:
        x = self.x_sample if x_sample is None else x_sample
        if x is None:
            raise ValueError("no optimization sample: pass x_sample to register_query "
                             "or to handle.optimize")
        opts = self.options if options is None else options
        dev = self.session.device
        if self.plan_cache is not None:
            # serving needs live builder/B&B state when keep_state is on,
            # which an exact-hit wire replay cannot carry
            plan, info = self.plan_cache.optimize_query(
                self.query, x, opts, accept_hit=not opts.keep_state, device=dev)
            self.optimize_info = info
        else:
            plan = build_plan(self.query, x, opts, warm_start=warm_start, device=dev)
            self.optimize_info = {"path": "cold", "trace": plan.meta.get("trace")}
        self.plan = plan
        return plan

    def submit(self, indices, rows) -> None:
        self.session.submit(indices, rows, qids=(self.qid,))

    def stats(self) -> dict:
        return self.session.query_stats(self.qid)


class CoreSession:
    """Registry of N concurrent cascade queries served as one unit.

    ``register_query`` hands out ``QueryHandle``s; ``serve()`` builds the
    serving stack once every query is registered: a single query goes to
    ``CascadeServer``, ``ShardedCascadeServer`` (``hosts > 1``) or, with an
    SLO, ``ServingFrontEnd``; several queries go to the shared
    ``MultiQueryEngine`` (one stacked scorer, cross-query
    UDF dedupe, weighted-fair scheduling).  ``submit`` / ``run_stream`` /
    ``query_stats`` then route through whichever stack was built.  Plans
    are built and scored on ``device`` (CUDA by default; raises without a
    card).  ``plan_cache`` is the session's default ``PlanCache``: queries
    optimize through it and the servers write committed plans back."""

    def __init__(self, *, options: Optional[OptimizeOptions] = None,
                 plan_cache=None, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.options = options or OptimizeOptions()
        self.plan_cache = plan_cache
        self.seed = seed
        self.handles: List[QueryHandle] = []
        self.server = None  # whatever serve() built
        self._multi = False

    # ------------------------------------------------------------- registry
    def register_query(self, query: Query, x_sample: Optional[np.ndarray] = None, *,
                       quant_dtype: Optional[str] = None, plan_cache=None,
                       slo: Optional[float] = None,
                       options: Optional[OptimizeOptions] = None) -> QueryHandle:
        if self.server is not None:
            raise RuntimeError("register_query must precede serve()")
        opts = options or self.options
        if quant_dtype is not None:
            opts = opts.replace(quant_dtype=(
                None if quant_dtype in ("fp32", "float32") else quant_dtype))
        handle = QueryHandle(
            self, len(self.handles), query, x_sample, options=opts,
            plan_cache=self.plan_cache if plan_cache is None else plan_cache, slo=slo)
        self.handles.append(handle)
        return handle

    def optimize_all(self, *, keep_state: Optional[bool] = None) -> List[PhysicalPlan]:
        """Optimize every registered query that has no plan yet.
        ``keep_state=True`` forces live builder/B&B state onto the plans
        (adaptive serving warm-starts rebuilds from it)."""
        plans = []
        for h in self.handles:
            if h.plan is None:
                opts = (h.options if keep_state is None
                        else h.options.replace(keep_state=keep_state))
                h.optimize(options=opts)
            plans.append(h.plan)
        return plans

    # -------------------------------------------------------------- serving
    def serve(self, *, transport: Optional[str] = None, hosts: Optional[int] = None,
              slo: Optional[float] = None, config: Optional[ServeConfig] = None,
              policy=None, worker_spec=None):
        """Build the serving stack for the registered queries.  The keyword
        shortcuts override ``config`` fields; both roads lead to the same
        ``ServeConfig``.  Returns the server (also kept on ``self.server``);
        drive it with ``submit``/``run_stream`` here or use its own
        interface.  ``hosts > 1`` builds a ``ShardedCascadeServer`` on the
        session's device (its plan keeps builder state so the coordinator's
        re-optimizations warm-start); ``worker_spec`` is the seeds the
        process transport's workers rebuild the workload from."""
        if not self.handles:
            raise RuntimeError("serve() with no registered query")
        if self.server is not None:
            raise RuntimeError("serve() already built a server")
        cfg = config or ServeConfig()
        if transport is not None:
            cfg = cfg.replace(transport=transport)
        if hosts is not None:
            cfg = cfg.replace(hosts=hosts)
        if slo is not None:
            cfg = cfg.replace(slo_ms=slo)
        needs_state = cfg.adaptive or cfg.hosts > 1
        self.optimize_all(keep_state=True if needs_state else None)
        if len(self.handles) > 1:
            if cfg.hosts > 1:
                raise ValueError(
                    "multi-query sharded serving is not wired yet "
                    "(ROADMAP follow-up); serve each tenant fleet "
                    "separately or use hosts=1")
            from repro_torch.serving.multiquery import MultiQueryEngine

            self.server = MultiQueryEngine(
                self.handles, tile=cfg.tile, adaptive=cfg.adaptive, policy=policy,
                seed=cfg.seed, plan_cache=self.plan_cache, device=self.device)
            self._multi = True
            return self.server
        h = self.handles[0]
        slo_ms = cfg.slo_ms if cfg.slo_ms is not None else h.slo
        if cfg.hosts > 1:
            from repro_torch.distributed.serving import ShardedCascadeServer

            self.server = ShardedCascadeServer(
                h.plan, cfg.hosts, tile=cfg.tile, seed=cfg.seed,
                policy=policy, transport=cfg.transport,
                kill_coordinator_at=cfg.kill_coordinator_at,
                straggler_host=cfg.straggler_host, worker_spec=worker_spec,
                slo_ms=slo_ms, plan_cache=h.plan_cache, device=self.device)
            return self.server
        from repro_torch.serving.engine import CascadeServer

        engine = CascadeServer(h.plan, tile=cfg.tile, adaptive=cfg.adaptive,
                               policy=policy, seed=cfg.seed, plan_cache=h.plan_cache,
                               device=self.device)
        if slo_ms is not None:
            from repro_torch.serving.frontend import ServingFrontEnd, SLOPolicy

            self.server = ServingFrontEnd(engine, policy=SLOPolicy(
                degrade=cfg.backpressure, shed_expired=cfg.backpressure))
        else:
            self.server = engine
        return self.server

    def submit(self, indices, rows, *, qids=None) -> None:
        if self.server is None:
            raise RuntimeError("serve() before submit()")
        if self._multi:
            self.server.submit(indices, rows, qids=qids)
        else:
            self.server.submit(indices, rows)

    def run_stream(self, x: np.ndarray, *, chunk: int = 4096):
        if self.server is None:
            self.serve()
        return self.server.run_stream(x, chunk=chunk)

    def query_stats(self, qid: int) -> dict:
        if self._multi:
            return self.server.query_stats(qid)
        if qid != 0:
            raise KeyError(f"no query {qid} in a single-query session")
        if self.server is None:
            return {}
        stats = getattr(self.server, "stats", None)
        return dict(stats.__dict__) if stats is not None else {}
