"""Quickstart: optimize an ML inference query with CORE and execute it on
the card through the fused ``cascade_score`` kernel.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cuda] [--n N]

The flow of the JAX package's ``examples/quickstart.py``: a correlated
record stream and two UDFs, a two-predicate query at target accuracy 0.9,
proxies built online on the first 1500 records, then the plan and ORIG
executed over the rest.  The costs printed are the Eq. 3.1 cost model's
(ms/record), not timings.
"""
from __future__ import annotations

import argparse

from repro_torch.core import (
    OptimizeOptions,
    build_plan,
    execute_plan,
    orig_plan,
    plan_accuracy,
    query_correlation,
)
from repro_torch.data.synthetic import make_dataset, make_query, make_udfs


def run(n: int = 20_000, device="cuda", *, udf_weights=None, verbose: bool = True) -> dict:
    """Run the quickstart; returns the plan order, costs and accuracy.
    ``udf_weights`` carries trained UDF layers in (per column) instead of
    training them."""
    say = print if verbose else (lambda *a, **kw: None)
    ds = make_dataset(name="tweets", n=n, correlation=0.9, seed=0)
    udfs = make_udfs(ds, hidden=64, depth=2, train_rows=3000, seed=0,
                     declared_cost_ms=20.0, weights=udf_weights, device=device)
    say(f"dataset: {ds.n} records, predicate correlation kappa^2 = "
        f"{query_correlation(ds.truth[:, :2]):.2f}")
    query = make_query(ds, udfs, columns=[0, 1], target_selectivity=0.5,
                       accuracy_target=0.9, seed=1)
    say("query:", " AND ".join(query.names()), f" target A={query.accuracy_target}")

    k = 1500  # the optimization sample: the stream's first k records
    plan = build_plan(query, ds.x[:k], OptimizeOptions(mode="core"), device=device)
    say("\noptimized plan:")
    say(plan.describe())
    say("optimizer stats:", plan.meta["stats"])

    rest = ds.x[k:]
    orig = execute_plan(orig_plan(query), rest, device=device)
    res = execute_plan(plan, rest, use_kernel=True, fused=True, device=device)
    saving = 1 - res.model_cost_ms / orig.model_cost_ms
    accuracy = plan_accuracy(res, orig)
    say(f"\nORIG cost: {orig.cost_per_record(len(rest)):.3f} ms/record")
    say(f"CORE cost: {res.cost_per_record(len(rest)):.3f} ms/record ({saving:.1%} saved)")
    say(f"empirical accuracy vs ORIG: {accuracy:.3f}")
    return {"order": plan.order, "orig_cost": orig.cost_per_record(len(rest)),
            "core_cost": res.cost_per_record(len(rest)), "saving": saving,
            "accuracy": accuracy, "plan": plan, "query": query,
            "used_kernel": [s.used_kernel for s in res.stages]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=20_000, help="records in the dataset")
    args = ap.parse_args(argv)
    run(args.n, args.device)


if __name__ == "__main__":
    main()
