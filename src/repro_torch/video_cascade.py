"""A three-predicate video-style cascade: the branch-and-bound order search
(Algorithm 2, mode "core") against CORE-a and CORE-h, with the optimizer's
cost split into labeling, training and search (Table 5 in miniature).

    PYTHONPATH=src python -m repro_torch.video_cascade [--device cuda] [--n N]

The flow of the JAX package's ``examples/video_cascade.py``: a 96-feature
stream with four label columns and UDFs of heterogeneous declared cost
(activity recognition > object detection > tagger), a query over columns
0, 1 and 2 at target accuracy 0.9, plans built on the first 1,500 records
by each mode (``build_plan``; the JAX example calls its deprecated
``optimize`` shim with the same options), each executed over the rest on
the fused scorer (``cascade_score`` on a card) beside ORIG.  Costs are the
Eq. 3.1 cost model's (ms/record), not timings.
"""
from __future__ import annotations

import argparse

from repro_torch.core import OptimizeOptions, build_plan, execute_plan, orig_plan, plan_accuracy
from repro_torch.data.synthetic import make_dataset, make_query, make_udfs

MODES = ("core-a", "core-h", "core")
SAMPLE = 1500  # the optimization sample: the stream's first records


def run(n: int = 10_000, device="cuda", *, udf_weights=None, log=print) -> dict:
    """Run the three modes; returns {"query", "orig", "modes": {mode:
    {"plan", "result", "accuracy", "exec_ms_per_record", "stats",
    "trace"}}}.  ``udf_weights`` carries trained UDF layers in (per column)
    instead of training them."""
    ds = make_dataset(name="ucf", n=n, n_features=96, correlation=0.95, feature_noise=1.1,
                      seed=7)
    udfs = make_udfs(ds, hidden=48, depth=2, train_rows=2500, seed=7, declared_cost_ms=100.0,
                     cost_scale={0: 2.0, 1: 0.2, 2: 1.0, 3: 0.5}, weights=udf_weights,
                     device=device)
    query = make_query(ds, udfs, columns=[0, 1, 2], target_selectivity=0.5,
                       accuracy_target=0.9, seed=8)
    log("query: " + " AND ".join(query.names()))

    rest = ds.x[SAMPLE:]
    orig = execute_plan(orig_plan(query), rest, device=device)
    modes = {}
    for mode in MODES:
        plan = build_plan(query, ds.x[:SAMPLE], OptimizeOptions(mode=mode, step=0.05),
                          device=device)
        res = execute_plan(plan, rest, use_kernel=True, fused=True, device=device)
        st, trace = plan.meta["stats"], plan.meta.get("trace")
        extra = ""
        if trace is not None:
            extra = (f" | B&B visited {trace['nodes_visited']}/{trace['nodes_total']} nodes"
                     f" ({trace['nodes_pruned_frac']:.0%} pruned)")
        accuracy = plan_accuracy(res, orig)
        log(f"{mode:7s} order={plan.order} exec={res.cost_per_record(len(rest)):7.3f} ms/rec "
            f"acc={accuracy:.3f} QO: label {st['labeling_ms']:.0f}ms "
            f"train {st['training_ms']:.0f}ms search {st['search_ms']:.0f}ms{extra}")
        modes[mode] = dict(plan=plan, result=res, accuracy=accuracy,
                           exec_ms_per_record=res.cost_per_record(len(rest)), stats=st,
                           trace=trace)
    log(f"ORIG    exec={orig.cost_per_record(len(rest)):7.3f} ms/rec")
    return dict(query=query, orig=orig, modes=modes, records=len(rest))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=10_000, help="records in the dataset")
    args = ap.parse_args(argv)
    return run(args.n, args.device)


if __name__ == "__main__":
    main()
