"""The queries ``make_query`` builds in both packages, with each package's
own UDFs trained from the same initial weights: quickstart's data and
query, and ``chip_smoke.py``'s phase 3 (the ``twitter`` profile, queries
quickstart and mixed3).  Prints one JSON line a query with both packages'
value sets and, per predicate, each label's fraction of the 20,000-record
sample in the order ``make_query`` takes them, beside the target
selectivity.  Reports; asserts nothing.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/paper_loop_queries.py
"""
import json
import sys
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

TW = chip_smoke.TWITTER
WORKLOADS = {  # name: (make_dataset kwargs, make_udfs kwargs, queries)
    "quickstart": (dict(name="tweets", n=20_000, correlation=0.9, seed=0),
                   dict(hidden=64, depth=2, train_rows=3000, seed=0, declared_cost_ms=20.0),
                   [("quickstart", [0, 1], 0.5, 0.9, 1)]),
    "phase3_twitter": (
        dict(name="twitter", n=TW["n"], n_features=TW["n_features"],
             n_columns=TW["n_columns"], correlation=TW["correlation"],
             feature_noise=TW["feature_noise"], label_noise=TW["label_noise"], seed=0),
        dict(hidden=TW["udf_hidden"], depth=TW["udf_depth"], train_rows=TW["udf_train_rows"],
             seed=0, declared_cost_ms=TW["declared_cost_ms"], cost_scale=TW["cost_scale"]),
        [(name, cols, sel, A, seed) for name, cols, sel, A, _kind, seed in chip_smoke.QUERIES]),
}


def _fractions(ds, udfs, q):
    """Per predicate: (value, fraction) of its UDF's labels on the sample,
    sorted by fraction."""
    sample = ds.x[: min(ds.n, 20_000)]
    out = []
    for p in q.predicates:
        labels = p.udf(sample)
        vals, counts = np.unique(labels, return_counts=True)
        out.append(sorted(((int(v), round(float(c) / len(labels), 4))
                           for v, c in zip(vals, counts)), key=lambda t: -t[1]))
    return out


def report(workloads=WORKLOADS):
    """One row a query: both packages' value sets and label fractions."""
    rows = []
    for wname, (data_kw, udf_kw, queries) in workloads.items():
        jds, tds = jsyn.make_dataset(**data_kw), tsyn.make_dataset(**data_kw)
        judfs = jsyn.make_udfs(jds, **udf_kw)
        tudfs = tsyn.make_udfs(tds, **udf_kw, device="cpu")
        for qname, cols, sel, A, seed in queries:
            kw = dict(columns=cols, target_selectivity=sel, accuracy_target=A, seed=seed)
            jq, tq = jsyn.make_query(jds, judfs, **kw), tsyn.make_query(tds, tudfs, **kw)
            rows.append(dict(
                workload=wname, query=qname, target_selectivity=sel,
                reference=[sorted(p.values) for p in jq.predicates],
                port=[sorted(p.values) for p in tq.predicates],
                same=[p.values == r.values for p, r in zip(tq.predicates, jq.predicates)],
                reference_fractions=_fractions(jds, judfs, jq),
                port_fractions=_fractions(tds, tudfs, tq)))
    return rows


def main() -> None:
    warnings.simplefilter("ignore")
    for row in report():
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
