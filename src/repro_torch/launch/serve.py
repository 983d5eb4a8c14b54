"""Serving launcher: build a CORE-optimized cascade for an ML inference
query and serve a record stream with continuous batching, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --n 20000 --correlation 0.9 \\
        --accuracy 0.9 --mode core [--device cpu]

``--device`` picks where UDFs, proxies and the fused scorer run: CUDA by
default (raises without a card), ``cpu`` for the kernel's plain version.
``--drift`` serves an order-inverting drifting stream instead of held-out
rows; add ``--adaptive`` to let the server detect the drift and
re-optimize mid-stream (DESIGN.md §4).  ``--slo-ms`` serves the held-out
rows as deadline-carrying requests through the SLO front end (DESIGN.md
§7).  ``--queries spec.json`` registers SEVERAL concurrent queries in one
``CoreSession`` (DESIGN.md §10): shared fused scoring, cross-query UDF
dedupe, and weighted-fair device-time scheduling.  ``--plan-cache PATH``
optimizes through the cross-query plan cache persisted at PATH (a COREPLNC
file either package reads, DESIGN.md §8): an exact repeat replays the
cached artifact (HIT), a similar query warm-starts (WARM), anything else
builds COLD, and the servers' committed plans are written back and saved.
``--hosts K`` with K > 1 and the fleet-only flags (``--drift-skew``,
``--transport``, ``--kill-coordinator-at``, ``--straggler-host``; the
fleet is ROADMAP item 10) are not ported yet: set away from their
defaults, they exit with an error instead of being ignored.

Every CLI flag maps onto a typed config field via ``FLAG_MAP`` — the
parser is a thin veneer over ``(WorkloadConfig, OptimizeOptions,
ServeConfig)``, and every flag round-trips through ``config_from_args`` so
the CLI can never drift from the session API.
"""
from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass

import numpy as np

from repro_torch.core import (
    CoreSession,
    OptimizeOptions,
    PlanCache,
    ServeConfig,
    build_plan,
    execute_plan,
    ns_plan,
    orig_plan,
    pp_plan,
)
from repro_torch.core.api import reject_fleet
from repro_torch.data.synthetic import (
    make_dataset,
    make_drifting_stream,
    make_query,
    make_udfs,
)
from repro_torch.serving.engine import CascadeServer
from repro_torch.serving.frontend import ServingFrontEnd, SLOPolicy
from repro_torch.util import resolve_device


@dataclass
class WorkloadConfig:
    """Launch-local knobs: the synthetic dataset/query the launcher
    builds (not part of the session API — a real deployment brings its
    own records and UDFs)."""

    n: int = 20_000
    correlation: float = 0.9
    accuracy: float = 0.9
    preds: int = 2
    udf_cost_ms: float = 20.0
    mode: str = "core"  # includes the non-CORE baselines pp/ns/orig
    seed: int = 0
    device: str = "cuda"


@dataclass
class LaunchConfig:
    workload: WorkloadConfig
    optimize: OptimizeOptions
    serve: ServeConfig


# argparse dest -> (config section, field).  Golden-tested: every parser
# action must appear here, and every non-default flag value must survive
# the round trip into its config field.
FLAG_MAP = {
    "n": ("workload", "n"),
    "correlation": ("workload", "correlation"),
    "accuracy": ("workload", "accuracy"),
    "preds": ("workload", "preds"),
    "udf_cost_ms": ("workload", "udf_cost_ms"),
    "mode": ("workload", "mode"),
    "device": ("workload", "device"),
    "proxy_kind": ("optimize", "kind"),
    "quant_dtype": ("optimize", "quant_dtype"),
    "tile": ("serve", "tile"),
    "seed": ("serve", "seed"),
    "adaptive": ("serve", "adaptive"),
    "drift": ("serve", "drift"),
    "hosts": ("serve", "hosts"),
    "drift_skew": ("serve", "drift_skew"),
    "transport": ("serve", "transport"),
    "kill_coordinator_at": ("serve", "kill_coordinator_at"),
    "straggler_host": ("serve", "straggler_host"),
    "slo_ms": ("serve", "slo_ms"),
    "arrival_rate": ("serve", "arrival_rate"),
    "request_rows": ("serve", "request_rows"),
    "no_backpressure": ("serve", "backpressure"),  # inverted, see below
    "plan_cache": ("serve", "plan_cache_path"),
    "queries": ("serve", "queries_path"),
}

# flags whose config field is the NEGATION of the CLI switch
_INVERTED = {"no_backpressure"}


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--correlation", type=float, default=0.9)
    ap.add_argument("--accuracy", type=float, default=0.9)
    ap.add_argument("--mode", default="core", choices=["core", "core-a", "core-h", "pp", "ns", "orig"])
    ap.add_argument("--proxy-kind", default="svm", choices=["svm", "mlp", "mixed"],
                    help="proxy family per predicate: all-linear, all-MLP, "
                         "or alternating (every kind rides the fused scorer)")
    ap.add_argument("--quant-dtype", default="fp32",
                    choices=["fp32", "int8", "fp8"],
                    help="weight storage dtype for the packed cascade: "
                         "int8/fp8 quantize at plan-compile time (scales "
                         "folded into the readout; masks flip only within "
                         "the calibrated threshold tolerance)")
    ap.add_argument("--device", default="cuda",
                    help="where UDFs, proxies and the fused scorer run: cuda "
                         "(the default; raises without a card) or cpu")
    ap.add_argument("--preds", type=int, default=2)
    ap.add_argument("--tile", type=int, default=1024)
    ap.add_argument("--udf-cost-ms", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--adaptive", action="store_true",
                    help="drift-triggered online re-optimization")
    ap.add_argument("--drift", action="store_true",
                    help="serve a drifting stream (selectivity + correlation shift)")
    ap.add_argument("--hosts", type=int, default=1,
                    help="shard serving across K simulated hosts with "
                         "quorum-voted plan swaps; K > 1 is not ported yet "
                         "(ROADMAP item 10) and exits with an error")
    ap.add_argument("--drift-skew", type=float, default=0.3,
                    help="per-shard drift magnitude skew (the fleet, not "
                         "ported yet: a non-default value exits with an error)")
    ap.add_argument("--transport", default="inline",
                    choices=["inline", "thread", "process"],
                    help="multi-host transport (the fleet, not ported yet: "
                         "a non-default value exits with an error)")
    ap.add_argument("--kill-coordinator-at", default=None,
                    help="fleet failure injection (not ported yet: exits "
                         "with an error)")
    ap.add_argument("--straggler-host", type=int, default=None,
                    help="fleet failure injection (not ported yet: exits "
                         "with an error)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="serve through the SLO-aware request front end "
                         "(DESIGN.md §7): the stream becomes deadline-"
                         "carrying requests, goodput (requests/s meeting "
                         "the SLO) is reported next to raw throughput, "
                         "and backpressure degrades to cheaper plans / "
                         "sheds expired work instead of queueing forever")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="request arrivals per cost-model second (Poisson; "
                         "default ~1.3x the full plan's capacity, i.e. "
                         "mild overload so the backpressure policy has "
                         "something to do); needs --slo-ms")
    ap.add_argument("--request-rows", type=int, default=128,
                    help="records per request on the front-end path")
    ap.add_argument("--no-backpressure", action="store_true",
                    help="disable degrade + shedding on the front end "
                         "(watch the latency collapse under overload)")
    ap.add_argument("--plan-cache", default=None, metavar="PATH",
                    help="cross-query plan cache file (DESIGN.md §8): "
                         "optimize through it (HIT / WARM / COLD), write the "
                         "served plans back, and save it")
    ap.add_argument("--queries", default=None, metavar="SPEC.JSON",
                    help="multi-query session (DESIGN.md §10): JSON list "
                         "of query specs ({columns, accuracy?, seed?, "
                         "slo_ms?, quant_dtype?}) all registered in one "
                         "CoreSession — shared fused scoring, cross-query "
                         "UDF dedupe, weighted-fair scheduling.  Overrides "
                         "--preds/--accuracy for the query shapes")
    return ap


def config_from_args(args: argparse.Namespace) -> LaunchConfig:
    """Fold the parsed namespace into the typed config triple.  The CLI
    owns no state of its own: every dest routes through ``FLAG_MAP``."""
    sections = {"workload": {}, "optimize": {}, "serve": {}}
    for dest, (section, fld) in FLAG_MAP.items():
        val = getattr(args, dest)
        if dest in _INVERTED:
            val = not val
        sections[section][fld] = val
    # normalize: "fp32" means full precision, i.e. no quantization pass
    if sections["optimize"].get("quant_dtype") in ("fp32", "float32"):
        sections["optimize"]["quant_dtype"] = None
    # the optimizer only sees CORE modes; baselines stay workload-level
    if sections["workload"]["mode"] in ("core", "core-a", "core-h"):
        sections["optimize"]["mode"] = sections["workload"]["mode"]
    # one --seed feeds all three sections (the golden test pins it to
    # serve; workload/optimize inherit)
    seed = sections["serve"]["seed"]
    sections["workload"]["seed"] = seed
    sections["optimize"]["seed"] = seed
    return LaunchConfig(
        workload=WorkloadConfig(**sections["workload"]),
        optimize=OptimizeOptions(**sections["optimize"]),
        serve=ServeConfig(**sections["serve"]),
    )


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    cfg = config_from_args(args)
    wl, opt, sv = cfg.workload, cfg.optimize, cfg.serve
    try:
        reject_fleet(sv)
    except NotImplementedError as e:
        raise SystemExit(f"repro_torch.launch.serve: {e}")
    dev = resolve_device(wl.device)

    ds = make_dataset(n=wl.n, correlation=wl.correlation, seed=wl.seed)
    udfs = make_udfs(ds, hidden=64, depth=2, train_rows=3000, seed=wl.seed,
                     declared_cost_ms=wl.udf_cost_ms, device=dev)
    k = max(1000, int(0.05 * wl.n))
    cache = None
    if sv.plan_cache_path and wl.mode in ("core", "core-a", "core-h"):
        cache = (PlanCache.load(sv.plan_cache_path)
                 if os.path.exists(sv.plan_cache_path) else PlanCache())
        print(f"plan cache: {sv.plan_cache_path} ({len(cache)} entries)")

    if sv.queries_path is not None:
        _serve_multiquery(cfg, ds, udfs, k, cache)
        _save_cache(cache, sv)
        return

    q = make_query(ds, udfs, columns=list(range(wl.preds)),
                   target_selectivity=0.5, accuracy_target=wl.accuracy,
                   seed=wl.seed + 1)
    print("query:", " AND ".join(q.names()), f"A={wl.accuracy}")
    if wl.mode == "orig":
        plan = orig_plan(q)
    elif wl.mode == "ns":
        plan = ns_plan(q, ds.x[:k], kind=opt.kind, device=dev)
    elif wl.mode == "pp":
        plan = pp_plan(q, ds.x[:k], kind=opt.kind, device=dev)
    else:
        build_opts = opt.replace(keep_state=sv.adaptive)
        if cache is not None:
            # adaptive serving needs a live builder/B&B on the plan, which
            # an exact-hit wire replay cannot carry: it takes the warm path
            # instead of the HIT fast path
            plan, info = cache.optimize_query(
                q, ds.x[:k], build_opts, accept_hit=not sv.adaptive, device=dev)
            print(f"plan cache: {info['path'].upper()} "
                  f"(distance {info['distance']:.4f}, "
                  f"build {info['build_ms']:.0f} ms)")
        else:
            plan = build_plan(q, ds.x[:k], build_opts, device=dev)
    print(plan.describe())
    if plan.meta.get("quant_dtype"):
        print(f"packed cascade weights: {plan.meta['quant_dtype']}")
    if any(s.proxy is not None for s in plan.stages):
        print("proxy families:",
              " ".join(s.proxy.family for s in plan.stages if s.proxy is not None))

    if sv.slo_ms is not None:
        _serve_frontend(cfg, ds, plan, k, dev, cache)
        _save_cache(cache, sv)
        return

    if sv.drift:
        stream = make_drifting_stream(
            ds, max(wl.n // 4, 2000), wl.n - k,
            shift_targets={c: (2.8 if c != 1 else -2.6) for c in range(wl.preds)},
            corr_gain=2.5, seed=wl.seed,
        )
        x_serve = stream.x
        print(f"drifting stream: {stream.n} records, boundary at "
              f"{stream.boundary}")
    else:
        x_serve = ds.x[k:]
    server = CascadeServer(plan, tile=sv.tile, adaptive=sv.adaptive, seed=sv.seed,
                           plan_cache=cache, device=dev)
    stats = server.run_stream(x_serve)
    orig_res = execute_plan(orig_plan(q), x_serve, device=dev)
    # accuracy of what was actually SERVED (mid-stream swaps included),
    # not a re-execution of the final plan over the whole stream
    orig_set = set(orig_res.passed.tolist())
    served_acc = (sum(1 for i in server.emitted if i in orig_set)
                  / max(len(orig_set), 1))
    print(f"\nserved {len(x_serve)} records in {stats.wall_ms:.0f} ms wall; "
          f"emitted {stats.emitted} (+{stats.rejected} rejected)")
    if sv.adaptive:
        print(f"adaptive: {stats.plan_swaps} plan swap(s), "
              f"{stats.audit_records} audit records "
              f"({stats.audit_cost_ms:.0f} ms cost), reopt "
              f"{stats.reopt_ms:.0f} ms wall")
        for ev in stats.drift_events:
            print(f"  drift@{ev.at_record} [{ev.signal}] obs={ev.observed:.3f} "
                  f"exp={ev.expected:.3f} -> "
                  f"{'warm B&B' if ev.escalated else 're-allocation'} "
                  f"({ev.nodes_visited} nodes), order "
                  f"{ev.order_before} -> {ev.order_after}")
    print(f"cost model: {stats.model_cost_ms / len(x_serve):.3f} ms/rec "
          f"(ORIG {orig_res.cost_per_record(len(x_serve)):.3f}); "
          f"served accuracy {served_acc:.3f}")
    _save_cache(cache, sv)


def _save_cache(cache, sv: ServeConfig):
    """Persist the plan cache (COREPLNC container) with this run's
    write-backs so the next ``--plan-cache`` run warm-starts from them."""
    if cache is None:
        return
    cache.save(sv.plan_cache_path)
    st = cache.stats
    print(f"plan cache saved: {len(cache)} entries -> {sv.plan_cache_path} "
          f"({st.hits_exact} exact / {st.hits_warm} warm hits, "
          f"{st.writes} writes)")


def _load_query_specs(path: str):
    with open(path) as f:
        specs = json.load(f)
    if not isinstance(specs, list) or not specs:
        raise SystemExit(f"--queries {path}: expected a non-empty JSON "
                         f"list of query specs")
    for i, spec in enumerate(specs):
        if "columns" not in spec:
            raise SystemExit(f"--queries {path}: spec #{i} missing "
                             f"'columns'")
    return specs


def _serve_multiquery(cfg: LaunchConfig, ds, udfs, k: int, cache=None):
    """N concurrent queries through one CoreSession (DESIGN.md §10):
    shared block-diagonal fused scoring, cross-query UDF dedupe, and
    Eq. 3.1-weighted fair scheduling across the tenants."""
    wl, opt, sv = cfg.workload, cfg.optimize, cfg.serve
    specs = _load_query_specs(sv.queries_path)
    session = CoreSession(options=opt, plan_cache=cache, seed=sv.seed, device=wl.device)
    queries = []
    for i, spec in enumerate(specs):
        q = make_query(ds, udfs, columns=[int(c) for c in spec["columns"]],
                       target_selectivity=float(spec.get("selectivity", 0.5)),
                       accuracy_target=float(spec.get("accuracy", wl.accuracy)),
                       seed=int(spec.get("seed", wl.seed + 1 + i)))
        h = session.register_query(
            q, ds.x[:k],
            quant_dtype=spec.get("quant_dtype", opt.quant_dtype),
            slo=spec.get("slo_ms"))
        queries.append(q)
        print(f"q{h.qid}: {' AND '.join(q.names())} "
              f"A={spec.get('accuracy', wl.accuracy)}")
    eng = session.serve(config=sv)
    x_serve = ds.x[k:]
    session.run_stream(x_serve)
    st = eng.session_stats()
    ok, msg = eng.conserved()
    ded = st["dedupe"]
    print(f"\nsession: {st['queries']} queries over {len(x_serve)} records; "
          f"conservation {'OK' if ok else 'VIOLATED: ' + msg}")
    print(f"shared scorer: {st['shared_cols']} packed columns "
          f"({st['stacked_cols_saved']} deduped), {st['restacks']} "
          f"restack(s)")
    print(f"UDF dedupe: {ded['hits']} hits / {ded['misses']} misses "
          f"(rate {ded['hit_rate']:.3f}), {ded['saved_cost_ms']:.0f} ms "
          f"cost saved")
    sched = st["scheduler"]
    for h in session.handles:
        qs = eng.query_stats(h.qid)
        print(f"  q{h.qid}: emitted {qs['emitted']} "
              f"(+{qs['rejected']} rejected), cost "
              f"{qs['model_cost_ms']:.0f} ms, weight {qs['weight']:.2f}, "
              f"served {qs['served_cost_ms']:.0f} ms device time")
    # served-accuracy audit per tenant, same recipe as the 1-query path
    for h, q in zip(session.handles, queries):
        orig_set = set(execute_plan(orig_plan(q), x_serve,
                                    device=wl.device).passed.tolist())
        srv = eng.servers[h.qid]
        acc = (sum(1 for i in srv.emitted if i in orig_set)
               / max(len(orig_set), 1))
        print(f"  q{h.qid} served accuracy {acc:.3f}")
    print(f"scheduler: {sched['grants']} service quanta, "
          f"total {st['model_cost_ms']:.0f} ms model cost")


def _serve_frontend(cfg: LaunchConfig, ds, plan, k, dev, cache=None):
    """Single-host serving through the SLO-aware request front end: the
    held-out stream arrives as Poisson requests with per-request
    deadlines; goodput is reported next to raw throughput (DESIGN.md
    §7).  All timing is the cost-model clock, so runs are deterministic
    for a fixed seed."""
    sv = cfg.serve
    held = ds.x[k:]
    rows_per = max(1, sv.request_rows)
    n_req = len(held) // rows_per
    if n_req == 0:
        raise SystemExit(f"--request-rows {rows_per} larger than the "
                         f"held-out stream ({len(held)} rows)")
    # capacity on the cost-model clock: the plan's Eq. 3.1 estimate says
    # one request costs est_total_cost * rows_per ms at the full plan
    req_ms = plan.est_total_cost * rows_per
    rate = sv.arrival_rate or 1.3 / (req_ms / 1e3)
    rng = np.random.RandomState(sv.seed)
    arrivals = np.cumsum(rng.exponential(1e3 / rate, n_req))
    bp = sv.backpressure
    server = CascadeServer(plan, tile=sv.tile, seed=sv.seed, plan_cache=cache, device=dev)
    fe = ServingFrontEnd(server, policy=SLOPolicy(degrade=bp,
                                                  shed_expired=bp))
    for r in range(n_req):
        idx = np.arange(k + r * rows_per, k + (r + 1) * rows_per)
        fe.submit_request(idx, ds.x[idx], deadline_ms=sv.slo_ms,
                          arrival_ms=float(arrivals[r]))
    st = fe.run()
    ok, msg = fe.conserved()
    lat = [r.latency_ms for r in fe.requests.values() if r.done]
    print(f"\nfront end: {st.requests_total} requests x {rows_per} rows, "
          f"SLO {sv.slo_ms:.0f} ms, arrivals {rate:.2f} req/s "
          f"(backpressure {'on' if bp else 'OFF'})")
    print(f"goodput {st.goodput_rps:.2f} req/s vs throughput "
          f"{st.throughput_rps:.2f} req/s (ratio {st.goodput_ratio:.3f}); "
          f"p50/p95 latency {np.percentile(lat, 50):.0f}/"
          f"{np.percentile(lat, 95):.0f} ms")
    print(f"backpressure: {st.degrades} degrade(s), {st.restores} "
          f"restore(s), final ladder level {st.final_level}; shed "
          f"{st.records_shed} records across {st.requests_shed} "
          f"request(s) [explicit, never silent]")
    print(f"records: {st.records_submitted} submitted -> "
          f"{st.records_emitted} emitted + {st.records_rejected} "
          f"rejected; conservation {'OK' if ok else 'VIOLATED: ' + msg}")


if __name__ == "__main__":
    main()
