"""The port's serving stack against the JAX package's on the same inputs:
``serving/stats.py`` unit by unit, the static ``CascadeServer`` at odd and
even tiles, the adaptive server over a drifting stream, and the SLO front
end.  The UDFs are the JAX package's trained weights carried across with
``interop.udf_layers`` (torch cannot reproduce ``jax.random``), and both
engines serve the JAX package's plan (``interop.physical_plan``), so the
two differ only in how they score.

Emissions agree except tie rows: a proxy score within ``FOLD_TOL``
(1e-4*max(1,|thr|)) of its threshold (the packed form folds the
standardizer into the weights, a float32 reassociation) or a UDF whose top
two logits lie within 1e-4.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OptimizeOptions as JOptions, build_plan as j_build_plan
from repro.core import execute_plan as j_execute, orig_plan as j_orig
from repro.core.query import MLUDF
from repro.data import synthetic as jsyn
from repro.serving import stats as jstats
from repro.serving.engine import CascadeServer as JServer
from repro.serving.frontend import ServingFrontEnd as JFrontEnd, SLOPolicy as JSLOPolicy

from repro_torch import interop
from repro_torch.core import execute_plan, orig_plan
from repro_torch.data import synthetic as tsyn
from repro_torch.serving import stats as tstats
from repro_torch.serving.engine import CascadeServer
from repro_torch.serving.frontend import ServingFrontEnd, SLOPolicy
from _one_thread import one_thread  # noqa: F401


N, K = 6000, 1200  # dataset rows; the first K are the optimization sample
DATA = dict(n=N, n_features=64, n_columns=3, correlation=0.9, feature_noise=0.9,
            label_noise=0.2, seed=41)
DRIFT = dict(shift_targets={0: 2.8, 1: -2.6, 2: 2.8}, corr_gain=2.5, seed=41)
FOLD_TOL = 1e-4


@pytest.fixture(scope="module")
def workload():
    """The JAX package's dataset, UDFs (hidden 16, depth 1) and plan over
    three predicates, and their counterparts in the port."""
    ds = jsyn.make_dataset(**DATA)
    idx = np.random.RandomState(41).choice(ds.n, 1200, replace=False)
    udfs, layers, logit_fns = [], [], []
    for j in range(ds.truth.shape[1]):
        params, predict, logits_fn = jsyn._train_udf_model(
            ds.x[idx], ds.truth[idx, j], ds.n_classes[j], 16, 1, 41 + j)
        udfs.append(MLUDF(name=f"{ds.name}.udf{j}", cost=10.0, n_classes=ds.n_classes[j],
                          fn=lambda xx, _p=predict: np.asarray(_p(jnp.asarray(xx, jnp.float32)))))
        layers.append(interop.udf_layers(params))
        logit_fns.append(lambda xx, _f=logits_fn, _p=params: np.asarray(_f(_p, jnp.asarray(xx))))
    jq = jsyn.make_query(ds, udfs, columns=[0, 1, 2], target_selectivity=0.5,
                         accuracy_target=0.9, seed=42)
    jplan = j_build_plan(jq, ds.x[:K], JOptions(mode="core", step=0.05, seed=41))
    tds = tsyn.make_dataset(**DATA)
    tudfs = tsyn.make_udfs(tds, hidden=16, depth=1, train_rows=1200, seed=41,
                           declared_cost_ms=10.0, weights=layers, device="cpu")
    tq = tsyn.make_query(tds, tudfs, columns=[0, 1, 2], target_selectivity=0.5,
                         accuracy_target=0.9, seed=42)
    assert [p.values for p in tq.predicates] == [p.values for p in jq.predicates]
    return dict(ds=ds, tds=tds, jplan=jplan, tplan=interop.physical_plan(jplan, tq, "cpu"),
                logit_fns=logit_fns)


def _tie_rows(w, x, rows):
    """Rows of ``rows`` (indices into ``x``) at a proxy-threshold or
    UDF-logit tie (module doc)."""
    rows = np.asarray(sorted(rows), np.int64)
    if len(rows) == 0:
        return set()
    xr = x[rows]
    near = np.zeros(len(rows), bool)
    for st in w["jplan"].stages:
        if st.proxy is not None:
            s = np.asarray(st.proxy.score(xr))
            near |= np.abs(s - st.threshold) <= FOLD_TOL * max(1.0, abs(st.threshold))
        lg = np.sort(w["logit_fns"][st.pred_idx](xr), axis=1)
        near |= lg[:, -1] - lg[:, -2] < FOLD_TOL
    return set(rows[near].tolist())


def _assert_conserved(srv, stats, n):
    assert stats.emitted + stats.rejected == n
    assert srv.in_flight() == 0
    assert len(srv.emitted) == len(set(srv.emitted)) == stats.emitted


# ------------------------------------------------------------- stats, unit by unit
def test_cusum_trips_like_reference():
    rng = np.random.RandomState(0)
    steps = [(float(rng.uniform(0, 1)), float(rng.uniform(0, 1)), float(rng.randint(1, 300)))
             for _ in range(400)]
    ref, port = jstats.CusumDetector(0.08, 120.0), tstats.CusumDetector(0.08, 120.0)
    trips = []
    for i, step in enumerate(steps):
        a, b = ref.update(*step), port.update(*step)
        assert a == b and ref.score == port.score
        if a:
            trips.append(i)
            ref.reset()
            port.reset()
    assert trips  # the sequence does trip it


def test_reservoir_and_ipw_match_reference():
    """The same offers, forced audits and labels give the same contents,
    IPW weights and selectivities, and the same merged export."""
    rng = np.random.RandomState(1)
    pair = [(jstats.Reservoir(3, capacity=64, stride=3), tstats.Reservoir(3, capacity=64, stride=3))
            for _ in range(2)]
    for host, (ref, port) in enumerate(pair):
        for i in range(host * 1000, host * 1000 + 500):
            row = rng.randn(8).astype(np.float32)
            force = rng.random_sample() < 0.05
            assert ref.add(i, row, force=force) == port.add(i, row, force=force)
            if force or rng.random_sample() < 0.3:
                for p in range(3):
                    s, w = bool(rng.random_sample() < 0.4), float(rng.uniform(1, 20))
                    ref.observe(i, p, s, weight=w)
                    port.observe(i, p, s, weight=w)
        assert ref.size == port.size
        for p in range(3):
            assert ref.selectivity(p, min_labels=4) == port.selectivity(p, min_labels=4)
    exports = [(r.export(), t.export()) for r, t in pair]
    for a, b in exports + [(jstats.merge_reservoir_samples([e[0] for e in exports]),
                            tstats.merge_reservoir_samples([e[1] for e in exports]))]:
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.weights, b.weights)
        for p in range(3):
            for u, v in zip(a.known_sigma[p], b.known_sigma[p]):
                np.testing.assert_array_equal(u, v)
            assert jstats.ipw_selectivity(a, p) == tstats.ipw_selectivity(b, p)
    rate_a, rate_b = jstats.StreamingRate(), tstats.StreamingRate()
    for kept, seen in ((3.5, 10.0), (0.0, 4.0), (7.25, 9.0)):
        rate_a.update(kept, seen)
        rate_b.update(kept, seen)
    assert rate_a.rate == rate_b.rate


@pytest.mark.parametrize("margins", ["spread", "zeros", "none"])
def test_importance_audit_propensities_match_reference(margins):
    rng = np.random.RandomState(2)
    m = {"spread": np.abs(rng.randn(5000)).astype(np.float32), "zeros": np.zeros(5000, np.float32),
         "none": None}[margins]
    ref, port = jstats.ImportanceAuditSampler(0.02, 0.25), tstats.ImportanceAuditSampler(0.02, 0.25)
    np.testing.assert_array_equal(ref.propensities(m, 5000), port.propensities(m, 5000))
    sel_a, w_a = ref.select(m, 5000, np.random.RandomState(3))
    sel_b, w_b = port.select(m, 5000, np.random.RandomState(3))
    np.testing.assert_array_equal(sel_a, sel_b)
    np.testing.assert_array_equal(w_a, w_b)


def _fake_plan(n_stages, seed):
    """A plan-shaped object with what ``estimate_order_regret`` reads."""
    rng = np.random.RandomState(seed)
    stages, preds = [], []
    for p in range(n_stages):
        proxy = types.SimpleNamespace(cost=float(rng.uniform(0.01, 0.2))) if p % 3 else None
        stages.append(types.SimpleNamespace(
            pred_idx=p, proxy=proxy, alpha=float(rng.uniform(0.9, 1.0)),
            est_reduction=float(rng.uniform(0, 0.6)), est_selectivity=float(rng.uniform(0.2, 0.9))))
        preds.append(types.SimpleNamespace(udf=types.SimpleNamespace(cost=float(rng.uniform(1, 30)))))
    order = tuple(rng.permutation(n_stages).tolist())
    by = {s.pred_idx: s for s in stages}
    return types.SimpleNamespace(stages=[by[p] for p in order], order=order,
                                 query=types.SimpleNamespace(predicates=preds))


@pytest.mark.parametrize("n_stages", [3, 7])
def test_order_regret_matches_reference(workload, n_stages):
    """Exhaustive orders (up to 6 stages) and the greedy rank order beyond,
    on the same plan and fresh selectivities; and on the carried plan."""
    for plan in (_fake_plan(n_stages, seed=n_stages), None):
        jp, tp = (workload["jplan"], workload["tplan"]) if plan is None else (plan, plan)
        for shift in (0.0, 0.3, -0.4):
            fresh = {s.pred_idx: float(np.clip(s.est_selectivity + shift * (-1) ** s.pred_idx,
                                               0.0, 1.0)) for s in jp.stages}
            regret, best = tstats.estimate_order_regret(tp, fresh)
            ref_regret, ref_best = jstats.estimate_order_regret(jp, fresh)
            assert regret == pytest.approx(ref_regret, rel=1e-12, abs=1e-15)
            assert best == ref_best
            assert (tstats.AdaptivePolicy().choose_escalation(tp, fresh)
                    == jstats.AdaptivePolicy().choose_escalation(jp, fresh))


# ------------------------------------------------------------- the engine
@pytest.mark.parametrize("tile", [257, 256])
def test_static_server_matches_reference(workload, tile):
    x = workload["ds"].x[K:]
    ref = JServer(workload["jplan"], tile=tile)
    ref_stats = ref.run_stream(x, chunk=1500)
    srv = CascadeServer(workload["tplan"], tile=tile, device="cpu")
    stats = srv.run_stream(x, chunk=1500)
    _assert_conserved(srv, stats, len(x))
    _assert_conserved(ref, ref_stats, len(x))
    assert all(stats.stage_used_kernel)
    diff = set(srv.emitted) ^ set(ref.emitted)
    assert diff <= _tie_rows(workload, x, diff)
    assert stats.stage_in[0] == ref_stats.stage_in[0] == len(x)


@pytest.fixture(scope="module")
def drift_runs(workload):
    """Both adaptive servers over the same drifting stream with the same
    demo-scale policy; both re-optimize from the stateless carried plan."""
    kw = dict(cooldown_records=1024, min_reservoir=128, threshold=50.0, audit_rate=0.03,
              reservoir_capacity=512)
    js = jsyn.make_drifting_stream(workload["ds"], 2000, 6000, **DRIFT)
    ts = tsyn.make_drifting_stream(workload["tds"], 2000, 6000, **DRIFT)
    assert np.array_equal(js.x, ts.x)
    ref = JServer(workload["jplan"], tile=257, adaptive=True, policy=jstats.AdaptivePolicy(**kw),
                  seed=3)
    ref_stats = ref.run_stream(js.x, chunk=1024)
    srv = CascadeServer(workload["tplan"], tile=257, adaptive=True,
                        policy=tstats.AdaptivePolicy(**kw), seed=3, device="cpu")
    stats = srv.run_stream(ts.x, chunk=1024)
    orig = set(j_execute(j_orig(workload["jplan"].query), js.x).passed.tolist())
    torig = set(execute_plan(orig_plan(workload["tplan"].query), ts.x, device="cpu").passed.tolist())
    return dict(n=js.n, ref=ref, ref_stats=ref_stats, srv=srv, stats=stats,
                acc=sum(i in torig for i in srv.emitted) / len(torig),
                ref_acc=sum(i in orig for i in ref.emitted) / len(orig))


def test_adaptive_server_matches_reference(drift_runs):
    r = drift_runs
    stats, ref_stats = r["stats"], r["ref_stats"]
    _assert_conserved(r["srv"], stats, r["n"])
    _assert_conserved(r["ref"], ref_stats, r["n"])
    assert stats.plan_swaps == ref_stats.plan_swaps >= 1
    first, ref_first = stats.drift_events[0], ref_stats.drift_events[0]
    assert (first.signal, first.at_record, first.escalated, first.order_before) == (
        ref_first.signal, ref_first.at_record, ref_first.escalated, ref_first.order_before)
    assert abs(r["acc"] - r["ref_acc"]) <= 0.02
    assert stats.audit_records > 0 and stats.fused_score_ms > 0


# ------------------------------------------------------------- the SLO front end
def _serve_requests(fe, x, base, seed, slo_factor):
    """Random-size requests with exponential gaps, deadlines scaled by each
    request's full-plan cost (the JAX package's front-end test recipe)."""
    rng = np.random.RandomState(seed)
    req_ms = fe.engine.plan.est_total_cost
    taken, arrival = 0, 0.0
    while True:
        rows = int(rng.randint(1, 220))
        if taken + rows > len(x):
            break
        idx = np.arange(base + taken, base + taken + rows)
        arrival += float(rng.exponential(req_ms * rows))
        fe.submit_request(idx, x[taken:taken + rows], deadline_ms=float(slo_factor * req_ms * rows),
                          arrival_ms=arrival)
        taken += rows
    return fe.run()


@pytest.mark.parametrize("slo_factor", [0.6, 3.0])
def test_frontend_matches_reference(workload, slo_factor):
    x = workload["ds"].x[K:K + 3000]
    ref = JFrontEnd(JServer(workload["jplan"], tile=128), policy=JSLOPolicy())
    fe = ServingFrontEnd(CascadeServer(workload["tplan"], tile=128, device="cpu"),
                         policy=SLOPolicy())
    a = _serve_requests(ref, x, K, 5, slo_factor)
    b = _serve_requests(fe, x, K, 5, slo_factor)
    assert fe.conserved() == (True, "ok") and ref.conserved() == (True, "ok")
    for name in ("requests_total", "requests_rejected_admission", "records_rejected_admission",
                 "requests_shed", "records_shed", "records_submitted", "degrades", "restores",
                 "batches"):
        assert getattr(b, name) == getattr(a, name), name
    assert b.records_emitted + b.records_rejected == b.records_submitted
    assert a.requests_total - a.requests_rejected_admission > 0
