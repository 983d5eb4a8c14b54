"""The port's fleet (``ShardedCascadeServer`` and its hosts, the fleet hooks
of ``CascadeServer``) against the JAX package's, on the JAX package's own
sharded-serving workload (tests/test_sharded_serving.py: K = 4 skewed
drifting shards of 3,200 records, tile 256, chunks of 400), on which the
reference commits quorum swaps on this CPU.  The reference's UDF weights
are carried across (``make_udfs(weights=...)``) and so is its plan with
its live optimizer state (``interop.physical_plan(keep_state=True)``: the
builder's trained classifiers and the B&B tree's measured nodes and
surviving orders), as tests/test_torch_serve_cli.py carries them.

Both fleets see the same votes and reach quorum at the same record with
the same voters, signals, mode and merged rows, through every swap of the
run; each package re-optimizes in its own numerics, so the runs are held
to exact conservation, equal epochs and served accuracy within 0.01 of
the reference's.  The failure injections give the reference's
resolution, failover, fence and re-sync counts, its decisions and its
swap log.  The thread transport equals the
inline one exactly, and a two-worker process fleet on the CPU commits a
swap and equals an inline run on the same streams: the JAX package's
process-transport workload, with the port's own UDFs (which start from the
reference's initial weights and ask the reference's query), on shards
that drift alike."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import OptimizeOptions as JOptions, build_plan as j_build_plan
from repro.core import execute_plan as j_execute, orig_plan as j_orig
from repro.core.query import MLUDF
from repro.data import synthetic as jsyn
from repro.distributed.serving import ShardedCascadeServer as JFleet
from repro.serving.engine import CascadeServer as JServer
from repro.serving.stats import AdaptivePolicy as JPolicy

from repro_torch import interop
from repro_torch.core import OptimizeOptions, build_plan, execute_plan, orig_plan
from repro_torch.data import synthetic as tsyn
from repro_torch.distributed.serving import ShardedCascadeServer
from repro_torch.serving.engine import CascadeServer
from repro_torch.serving.stats import AdaptivePolicy
from _one_thread import one_thread  # noqa: F401

DATA = dict(n=9000, n_features=64, n_columns=3, correlation=0.9, feature_noise=0.9,
            label_noise=0.2, seed=41)
POLICY = dict(cooldown_records=1024, min_reservoir=128, threshold=50.0, audit_rate=0.03,
              reservoir_capacity=512)
STREAMS = dict(shift_targets={0: 2.8, 1: -2.6, 2: 2.8}, corr_gain=2.5, drift_skew=0.3, seed=41)
ACC_TOL = 0.01


@pytest.fixture(scope="module")
def ref():
    """The reference's workload (its ``make_udfs(hidden=16, depth=1,
    train_rows=1200, seed=41)``, the trained params kept) and the port's,
    with the reference's UDF weights; the drifting shards of both."""
    ds = jsyn.make_dataset(**DATA)
    idx = np.random.RandomState(41).choice(ds.n, 1200, replace=False)
    udfs, layers = [], []
    for j in range(ds.truth.shape[1]):
        params, predict, _ = jsyn._train_udf_model(ds.x[idx], ds.truth[idx, j],
                                                   ds.n_classes[j], 16, 1, 41 + j)
        udfs.append(MLUDF(name=f"{ds.name}.udf{j}", cost=10.0, n_classes=ds.n_classes[j],
                          fn=lambda xx, _p=predict: np.asarray(_p(jnp.asarray(xx, jnp.float32)))))
        layers.append(interop.udf_layers(params))
    jq = jsyn.make_query(ds, udfs, columns=[0, 1, 2], target_selectivity=0.5,
                         accuracy_target=0.9, seed=42)
    tds = tsyn.make_dataset(**DATA)
    tudfs = tsyn.make_udfs(tds, hidden=16, depth=1, train_rows=1200, seed=41,
                           declared_cost_ms=10.0, weights=layers, device="cpu")
    tq = tsyn.make_query(tds, tudfs, columns=[0, 1, 2], target_selectivity=0.5,
                         accuracy_target=0.9, seed=42)
    assert [p.values for p in tq.predicates] == [p.values for p in jq.predicates]
    jstreams = jsyn.make_sharded_drifting_streams(ds, 4, 800, 2400, **STREAMS)
    tstreams = tsyn.make_sharded_drifting_streams(tds, 4, 800, 2400, **STREAMS)
    xs = [s.x for s in jstreams]
    assert all(np.array_equal(a, b.x) for a, b in zip(xs, tstreams))
    x_all = np.concatenate(xs)
    return dict(ds=ds, jq=jq, tq=tq, xs=xs, x_all=x_all,
                j_orig=set(j_execute(j_orig(jq), x_all).passed.tolist()),
                t_orig=set(execute_plan(orig_plan(tq), x_all, device="cpu").passed.tolist()))


def _jplan(ref):
    """A fresh reference plan (a fleet's re-optimizations advance its
    live B&B state, so every run starts from its own)."""
    return j_build_plan(ref["jq"], ref["ds"].x[:1500],
                        JOptions(mode="core", step=0.05, keep_state=True))


def _record(srv):
    """Wrap the fleet's hosts and its swap step so the run logs every vote (with
    the fleet's submitted records when it was polled) and every quorum."""
    events = []
    for h in srv.hosts:
        def poll(_h=h, _orig=h.poll_vote):
            v = _orig()
            if v is not None:
                e = v.event
                events.append(("vote", v.host, v.epoch, e.signal, e.at_record, e.escalated,
                               e.observed, e.expected))
            return v
        h.poll_vote = poll
    run_swap = srv._run_swap

    def quorum():
        events.append(("quorum", sum(h.submitted for h in srv.hosts),
                       list(srv.coordinator.voters)))
        run_swap()
    srv._run_swap = quorum
    return events


def _run(fleet, plan, xs, orig, **kw):
    srv = fleet(plan, len(xs), tile=256, seed=3, **kw)
    for h in srv.hosts:
        h.track_versions = True
    events = _record(srv)
    stats = srv.run_streams(xs, chunk=400)
    emitted = [list(h.engine.emitted) for h in srv.hosts]
    acc = sum(1 for e in emitted for i in e if i in orig) / max(len(orig), 1)
    return dict(srv=srv, stats=stats, events=events, emitted=emitted, accuracy=acc,
                log=[(r.epoch, list(r.voters), list(r.signals), r.mode, r.merged_rows,
                      r.committed, r.aborted_by, list(r.fenced), r.initiated_by)
                     for r in stats.swap_log])


def _reference(ref, **kw):
    return _run(JFleet, _jplan(ref), ref["xs"], ref["j_orig"], policy=JPolicy(**POLICY), **kw)


def _port(ref, plan=None, **kw):
    plan = plan if plan is not None else interop.physical_plan(_jplan(ref), ref["tq"], "cpu",
                                                               keep_state=True)
    return _run(ShardedCascadeServer, plan, ref["xs"], ref["t_orig"],
                policy=AdaptivePolicy(**POLICY), device="cpu", **kw)


def _assert_conserved(run):
    srv, stats = run["srv"], run["stats"]
    assert stats.submitted == stats.emitted + stats.rejected
    all_emitted = []
    for h in srv.hosts:
        e = h.engine
        assert e.in_flight() == 0
        assert len(e.emitted) == len(set(e.emitted)) == len(e.emitted_versions)
        for i, v in zip(e.emitted, e.emitted_versions):
            assert h.submit_version[i] == v
        all_emitted.extend(e.emitted)
    assert len(all_emitted) == len(set(all_emitted))
    assert {h.epoch for h in srv.hosts} == {stats.final_epoch}


def _until_first_commit(run):
    """The run's events through the quorum of its first committed swap,
    and that swap's record."""
    first = next(i for i, r in enumerate(run["log"]) if r[5])
    quorums = [i for i, e in enumerate(run["events"]) if e[0] == "quorum"]
    cut = quorums[first] + 1
    return run["events"][:cut], run["log"][first]


@pytest.fixture(scope="module")
def base(ref):
    return _reference(ref), _port(ref)


def test_fleet_matches_reference_up_to_first_swap(base):
    jrun, trun = base
    assert jrun["stats"].swaps_committed >= 1 and trun["stats"].swaps_committed >= 1
    jev, jswap = _until_first_commit(jrun)
    tev, tswap = _until_first_commit(trun)
    assert tev == jev
    assert tswap == jswap
    assert jev[-1][0] == "quorum" and jev[-1][2] == jswap[1]
    # past the first commit too: the carried builder and B&B tree resume
    # as the reference's own do
    assert trun["events"] == jrun["events"]
    assert trun["log"] == jrun["log"]


def test_fleet_conserves_and_serves_the_reference_accuracy(base):
    jrun, trun = base
    for run in base:
        _assert_conserved(run)
        for r in run["stats"].swap_log:
            assert r.lag_records == 0
    assert trun["stats"].final_epoch >= 1
    assert {h.engine.plan_version for h in trun["srv"].hosts} == {trun["stats"].final_epoch}
    assert abs(trun["accuracy"] - jrun["accuracy"]) <= ACC_TOL, (trun["accuracy"],
                                                                 jrun["accuracy"])


FAULTS = [dict(kill_coordinator_at="prepare"), dict(kill_coordinator_at="commit"),
          dict(kill_coordinator_at="mid-commit"), dict(straggler_host=2),
          dict(straggler_host=2, straggler_policy="nack")]


@pytest.mark.parametrize("kw", FAULTS, ids=["kill_prepare", "kill_commit", "kill_mid_commit",
                                            "straggler_fence", "straggler_nack"])
def test_failure_injection_matches_reference(ref, kw):
    jrun, trun = _reference(ref, **kw), _port(ref, **kw)
    counts = [(r["stats"].failovers, r["stats"].failover_resolution, r["stats"].fences,
               r["stats"].resyncs) for r in (jrun, trun)]
    assert counts[1] == counts[0]
    want = {"prepare": (1, "aborted"), "commit": (1, "resync"),
            "mid-commit": (1, "resync")}.get(kw.get("kill_coordinator_at"))
    if want is not None:
        assert counts[0][:2] == want
    elif kw.get("straggler_policy") == "nack":
        assert counts[0][2] == 0 and any(r[6] == 2 for r in jrun["log"] if not r[5])
        assert any(r[6] == 2 for r in trun["log"] if not r[5])
    else:
        assert counts[0][2] == 1 and counts[0][3] >= 1
        fenced = [r for r in trun["log"] if r[5] and r[7]]
        assert fenced and fenced[0][7] == [2]
    # the same decisions through the first committed swap and after it:
    # the carried builder and B&B tree resume as the reference's own do
    assert _until_first_commit(trun) == _until_first_commit(jrun)
    assert trun["events"] == jrun["events"]
    assert trun["log"] == jrun["log"]
    for run in (jrun, trun):
        _assert_conserved(run)
        assert run["accuracy"] >= ref["jq"].accuracy_target - 0.05
    assert abs(trun["accuracy"] - jrun["accuracy"]) <= ACC_TOL, (trun["accuracy"],
                                                                 jrun["accuracy"])


def test_thread_transport_equals_inline(ref, base):
    _jrun, trun = base
    threaded = _port(ref, transport="thread")
    assert threaded["log"] == trun["log"]
    assert threaded["events"] == trun["events"]
    assert threaded["emitted"] == trun["emitted"]
    _assert_conserved(threaded)


def test_process_transport_commits_a_swap_on_the_cpu():
    """Two worker processes rebuild the workload from the spec's seeds on
    the CPU (the JAX package's process-transport spec); the fleet commits
    a swap and decides as an inline run on the same streams does.  Each
    worker has its own start deadline, so a hung worker fails the test.

    The port's UDFs ask the reference's query of this spec.  Its two shards
    drift alike (drift skew 0): at the JAX package's skew of 0.3 only the
    shard that drifts harder votes, short of K 2's quorum of 2, in both
    packages (``scripts/reference_fleet_votes.py``)."""
    spec = {"dataset": dict(n=7000, n_features=64, n_columns=3, correlation=0.9,
                            feature_noise=0.9, label_noise=0.2, seed=41),
            "udfs": dict(hidden=16, depth=1, train_rows=1000, seed=41, declared_cost_ms=10.0),
            "query": dict(columns=[0, 1, 2], target_selectivity=0.5, accuracy_target=0.9,
                          seed=42)}
    ds = tsyn.make_dataset(**spec["dataset"])
    udfs = tsyn.make_udfs(ds, **spec["udfs"], device="cpu")
    q = tsyn.make_query(ds, udfs, **spec["query"])
    jds = jsyn.make_dataset(**spec["dataset"])
    jq = jsyn.make_query(jds, jsyn.make_udfs(jds, **spec["udfs"]), **spec["query"])
    assert [p.values for p in q.predicates] == [p.values for p in jq.predicates]
    opts = OptimizeOptions(mode="core", step=0.05, keep_state=True)
    streams = dict(STREAMS, drift_skew=0.0)
    xs = [s.x for s in tsyn.make_sharded_drifting_streams(ds, 2, 700, 2000, **streams)]
    orig = set(execute_plan(orig_plan(q), np.concatenate(xs), device="cpu").passed.tolist())
    runs = [_run(ShardedCascadeServer, build_plan(q, ds.x[:1200], opts, device="cpu"), xs,
                 orig, policy=AdaptivePolicy(**POLICY), device="cpu", **kw)
            for kw in (dict(transport="process", worker_spec=spec, init_timeout_s=120.0), {})]
    proc, inline = runs
    assert proc["stats"].swaps_committed >= 1
    assert proc["log"] == inline["log"]
    assert [set(e) for e in proc["emitted"]] == [set(e) for e in inline["emitted"]]
    assert [h.engine.device for h in proc["srv"].hosts] == ["cpu", "cpu"]
    assert [h.engine.launches for h in proc["srv"].hosts] == [0, 0]
    assert all(h._proc.poll() is not None for h in proc["srv"].hosts)  # workers stopped
    _assert_conserved(proc)


def test_process_worker_that_cannot_start_fails_the_fleet(ref):
    """A worker whose spec cannot build its workload fails its init reply:
    the fleet raises and no worker is left running."""
    from repro_torch.distributed import procworker

    started = []
    real = procworker.ProcessHost.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        started.append(self)

    bad = {"dataset": dict(n=100, n_columns=3, seed=41), "udfs": dict(bogus=1),
           "query": dict(columns=[0, 1, 2])}
    plan = interop.physical_plan(_jplan(ref), ref["tq"], "cpu")
    procworker.ProcessHost.__init__ = spy
    try:
        with pytest.raises(RuntimeError, match="'init' failed"):
            ShardedCascadeServer(plan, 2, transport="process", worker_spec=bad, device="cpu",
                                 init_timeout_s=120.0)
    finally:
        procworker.ProcessHost.__init__ = real
    assert len(started) == 2 and all(h._proc.poll() is not None for h in started)


# ------------------------------------------------------------ engine hooks
def test_engine_fleet_hooks_match_reference(ref):
    """One host's shard through both engines, chunk by chunk: the pending
    drift trigger (popped by ``take_drift``), the escalation hint, the
    reservoir export and the kappa export after every chunk."""
    jplan = _jplan(ref)
    tplan = interop.physical_plan(jplan, ref["tq"], "cpu")
    jsrv = JServer(jplan, tile=256, adaptive=True, policy=JPolicy(**POLICY), seed=3)
    tsrv = CascadeServer(tplan, tile=256, adaptive=True, policy=AdaptivePolicy(**POLICY),
                         seed=3, device="cpu")
    x = ref["xs"][3]
    drifts = []
    for s in range(0, len(x), 400):
        idx = np.arange(s, min(s + 400, len(x)))
        for srv in (jsrv, tsrv):
            srv.submit(idx, x[idx])
            srv.pump()
        assert tsrv.escalation_hint() == jsrv.escalation_hint()
        jd, td = jsrv.take_drift(), tsrv.take_drift()
        assert td == jd
        drifts.append(td)
        jr, tr = jsrv.reservoir_export(), tsrv.reservoir_export()
        for f in ("indices", "x", "weights"):
            np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f))
        assert tr.known_sigma.keys() == jr.known_sigma.keys()
        for p in jr.known_sigma:
            for a, b in zip(tr.known_sigma[p], jr.known_sigma[p]):
                np.testing.assert_array_equal(a, b)
        assert tsrv.kappa_export() == jsrv.kappa_export()
    assert any(d is not None for d in drifts)  # the shard's detector fired
    assert tsrv.take_drift() is None


def test_carried_optimizer_state_matches_reference(ref):
    """``physical_plan(keep_state=True)``: the port's builder holds the
    reference's classifiers under the same keys (same F1 at insert), and its
    B&B tree the reference's measured nodes and surviving orders."""
    jplan = _jplan(ref)
    tplan = interop.physical_plan(jplan, ref["tq"], "cpu", keep_state=True)
    jb, tb = jplan.meta["builder"], tplan.meta["builder"]
    jcls, tcls = jb.export_classifiers(), tb.export_classifiers()
    assert tcls.keys() == jcls.keys() and len(tcls) > 0
    for key, (proxy, phi) in tcls.items():
        assert phi == float(jcls[key][1]) and proxy.family == jcls[key][0].family
    assert (tb.kind, tb.eps, tb.seed, tb.device.type) == (jb.kind, jb.eps, jb.seed, "cpu")
    np.testing.assert_array_equal(tb.x, np.asarray(jb.x))
    assert tplan.meta["bnb"].builder is tb
    js, jq = jplan.meta["bnb"].export_state()
    ts, tq = tplan.meta["bnb"].export_state()
    assert ts == {k: float(v) for k, v in js.items()} and tq == [tuple(o) for o in jq]
    assert "builder" not in interop.physical_plan(jplan, ref["tq"], "cpu").meta
