"""The serve CLI's fleet flow (``--n 8000 --preds 2 --hosts 4 --drift``) in
both packages, in one process: each host's votes (host, signal, record,
observed and expected rate), the committed swaps and each host's stage
CUSUM scores at the end.  Three runs: the JAX package; the port with its
own UDFs (trained by torch from the reference's initial weights) and its
own plan; the port with the JAX package's trained UDFs carried across and
its own plan.  Shows whether a difference in votes comes from the UDFs'
training or from the port's serving.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/fleet_cli_votes.py [--threads N]
"""
import argparse
import sys
import warnings
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import build_plan as j_build_plan  # noqa: E402
from repro.core.query import MLUDF  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.distributed.serving import ShardedCascadeServer as JFleet  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.serving.stats import AdaptivePolicy as JPolicy  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import build_plan  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.distributed.serving import ShardedCascadeServer  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving.stats import AdaptivePolicy  # noqa: E402

ARGV = ["--n", "8000", "--preds", "2", "--hosts", "4", "--drift"]
# the CLI's demo-scale detector policy (launch/serve.py::_serve_sharded)
POLICY = dict(audit_rate=0.03, threshold=50.0, min_reservoir=128, cooldown_records=1024,
              reservoir_capacity=512)


def _tap_votes(srv) -> list:
    votes = []
    for h in srv.hosts:
        def poll(_poll=h.poll_vote):
            v = _poll()
            if v is not None:
                e = v.event
                votes.append((v.host, e.signal, e.at_record, round(e.observed, 3),
                              round(e.expected, 3)))
            return v
        h.poll_vote = poll
    return votes


def _report(name, plan, srv, xs) -> None:
    votes = _tap_votes(srv)
    st = srv.run_streams(xs)
    print(f"{name}: order {plan.order}, thresholds "
          f"{[round(s.threshold, 4) for s in plan.stages]}, votes {votes}, "
          f"swaps committed {st.swaps_committed}")
    print(f"  stage CUSUM scores {[[round(c.score, 1) for c in h.engine._states[-1].stage_cusum] for h in srv.hosts]}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=1, help="torch CPU threads")
    torch.set_num_threads(ap.parse_args().threads)
    warnings.simplefilter("ignore")
    jcfg = jserve.config_from_args(jserve.build_arg_parser().parse_args(ARGV))
    tcfg = tserve.config_from_args(tserve.build_arg_parser().parse_args(ARGV + ["--device", "cpu"]))
    wl, sv = tcfg.workload, tcfg.serve
    k = max(1000, int(0.05 * wl.n))
    per_host = max(wl.n // (2 * sv.hosts), 1500)
    streams = dict(shift_targets={c: (2.8 if c != 1 else -2.6) for c in range(wl.preds)},
                   corr_gain=2.5, drift_skew=sv.drift_skew, seed=sv.seed)
    qkw = dict(columns=list(range(wl.preds)), target_selectivity=0.5,
               accuracy_target=wl.accuracy, seed=wl.seed + 1)

    jds = jsyn.make_dataset(n=wl.n, correlation=wl.correlation, seed=wl.seed)
    idx = np.random.RandomState(wl.seed).choice(jds.n, min(3000, jds.n), replace=False)
    judfs, layers = [], []
    for j in range(jds.truth.shape[1]):
        params, predict, _ = jsyn._train_udf_model(jds.x[idx], jds.truth[idx, j],
                                                   jds.n_classes[j], 64, 2, wl.seed + j)
        judfs.append(MLUDF(name=f"{jds.name}.udf{j}", cost=wl.udf_cost_ms,
                           n_classes=jds.n_classes[j],
                           fn=lambda xx, _p=predict: np.asarray(_p(jnp.asarray(xx, jnp.float32)))))
        layers.append(interop.udf_layers(params))
    jq = jsyn.make_query(jds, judfs, **qkw)
    print("reference query:", " AND ".join(jq.names()))
    jxs = [s.x for s in jsyn.make_sharded_drifting_streams(
        jds, sv.hosts, max(per_host // 4, 500), per_host, **streams)]
    jplan = j_build_plan(jq, jds.x[:k], jcfg.optimize.replace(keep_state=True))
    _report("reference", jplan, JFleet(jplan, sv.hosts, tile=sv.tile, seed=sv.seed,
                                       policy=JPolicy(**POLICY)), jxs)

    tds = tsyn.make_dataset(n=wl.n, correlation=wl.correlation, seed=wl.seed)
    txs = [s.x for s in tsyn.make_sharded_drifting_streams(
        tds, sv.hosts, max(per_host // 4, 500), per_host, **streams)]
    for name, weights in (("port, own UDFs", None), ("port, carried UDFs", layers)):
        udfs = tsyn.make_udfs(tds, hidden=64, depth=2, train_rows=3000, seed=wl.seed,
                              declared_cost_ms=wl.udf_cost_ms, weights=weights, device="cpu")
        q = tsyn.make_query(tds, udfs, **qkw)
        print(f"{name}: query equals the reference's:",
              [p.values for p in q.predicates] == [p.values for p in jq.predicates])
        plan = build_plan(q, tds.x[:k], tcfg.optimize.replace(keep_state=True), device="cpu")
        _report(name, plan, ShardedCascadeServer(plan, sv.hosts, tile=sv.tile, seed=sv.seed,
                                                 policy=AdaptivePolicy(**POLICY), device="cpu"),
                txs)


if __name__ == "__main__":
    main()
