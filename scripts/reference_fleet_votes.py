"""Why the JAX package's cold-interpreter fleet tests swap no plan on a
toolchain: run their workload in one process and print each host's votes
and drift detectors.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_fleet_votes.py

The workload is that of ``tests/test_sharded_serving.py::SUBPROC`` (K = 4)
and ``tests/test_ft_serving.py::test_process_transport_fleet`` (K = 2):
``make_dataset(n=7000)``, UDFs of hidden 16, skewed drifting shards of 700
+ 2,000 records, tile 256, chunks of 400.  It prints the query the
toolchain's UDF training yields, the plan, every vote (host, epoch,
signal, record, observed and expected rate), the quorum, and at the end
each host's audit baselines and stage CUSUM scores against the threshold.
"""
import sys
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro.core import OptimizeOptions, build_plan  # noqa: E402
from repro.data.synthetic import (make_dataset, make_query,  # noqa: E402
                                  make_sharded_drifting_streams, make_udfs)
from repro.distributed.serving import ShardedCascadeServer  # noqa: E402
from repro.serving.stats import AdaptivePolicy  # noqa: E402

POLICY = dict(cooldown_records=1024, min_reservoir=128, threshold=50.0, audit_rate=0.03,
              reservoir_capacity=512)


def main() -> None:
    warnings.simplefilter("ignore")
    ds = make_dataset(n=7000, n_features=64, n_columns=3, correlation=0.9, feature_noise=0.9,
                      label_noise=0.2, seed=41)
    udfs = make_udfs(ds, hidden=16, depth=1, train_rows=1000, seed=41, declared_cost_ms=10.0)
    q = make_query(ds, udfs, columns=[0, 1, 2], target_selectivity=0.5, accuracy_target=0.9,
                   seed=42)
    opts = OptimizeOptions(mode="core", step=0.05, keep_state=True)
    plan = build_plan(q, ds.x[:1200], opts)
    print("query:", " AND ".join(q.names()))
    print("plan order", plan.order, "expected keep",
          [round(s.est_selectivity * s.alpha, 3) for s in plan.stages])
    for n_hosts in (4, 2):
        streams = make_sharded_drifting_streams(
            ds, n_hosts, 700, 2000, shift_targets={0: 2.8, 1: -2.6, 2: 2.8}, corr_gain=2.5,
            drift_skew=0.3, seed=41)
        srv = ShardedCascadeServer(build_plan(q, ds.x[:1200], opts), n_hosts, tile=256,
                                   policy=AdaptivePolicy(**POLICY), seed=3)
        votes = []
        for h in srv.hosts:
            def poll(_poll=h.poll_vote):
                v = _poll()
                if v is not None:
                    e = v.event
                    votes.append((v.host, v.epoch, e.signal, e.at_record, round(e.observed, 3),
                                  round(e.expected, 3)))
                return v
            h.poll_vote = poll
        st = srv.run_streams([s.x for s in streams], chunk=400)
        print(f"K {n_hosts}: drift scales {[round(s.meta['drift_scale'], 2) for s in streams]}, "
              f"quorum {srv.coordinator.quorum_size}, votes {votes}, "
              f"swaps committed {st.swaps_committed}")
        for h, s in zip(srv.hosts, streams):
            e = h.engine
            print(f"  host {h.host_id}: {h.submitted} records, audit baselines "
                  f"{[m.baseline for m in e._audit_mon.values()]}, stage CUSUM scores "
                  f"{[round(c.score, 1) for c in e._states[-1].stage_cusum]} "
                  f"(threshold {POLICY['threshold']})")


if __name__ == "__main__":
    main()
