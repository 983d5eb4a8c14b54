"""The port's cross-query plan cache (``core/plan_cache.py``) against the JAX
package's: the counterparts of ``tests/test_plan_cache.py``, fingerprints
equal to the reference's, COREPLNC containers read and written by both
packages byte for byte, ``BranchAndBound.seed_from`` / ``export_state``
against the reference's trees, the classifier transplant across devices,
and the serving engine's write-back.

The UDFs are the JAX package's trained weights carried across with
``interop.udf_layers`` (torch cannot reproduce ``jax.random``), so both
packages ask the same query of the same data and its fingerprint is the
same; the port trains its own proxies, on the CPU.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OptimizeOptions as JOptions, PlanCache as JPlanCache
from repro.core import build_plan as j_build_plan, fingerprint_query as j_fingerprint
from repro.core.bnb import BranchAndBound as JBranchAndBound
from repro.core.builder import ProxyBuilder as JProxyBuilder
from repro.core.query import MLUDF
from repro.data import synthetic as jsyn

from repro_torch import interop
from repro_torch.core import OptimizeOptions, PlanCache, build_plan, fingerprint_query
from repro_torch.core.bnb import BranchAndBound
from repro_torch.core.builder import ProxyBuilder
from repro_torch.core.plan_cache import PLANCACHE_MAGIC, PlanCacheEntry
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels.ops import deserialize_scorer, serialize_scorer
from _one_thread import one_thread  # noqa: F401


DATA = dict(n=6000, correlation=0.9, feature_noise=1.0, seed=21)
K = 1200  # the optimization sample
OPTS = OptimizeOptions(step=0.05, seed=0)
FAR_SELS = {0: 0.05, 1: 0.95, 2: 0.05}


@pytest.fixture(scope="module")
def workload():
    """The JAX package's ``make_udfs(hidden=24, depth=1, train_rows=1200,
    seed=21)`` UDFs over four columns, and the query on columns (0, 1, 2)
    in both packages."""
    ds = jsyn.make_dataset(**DATA)
    idx = np.random.RandomState(21).choice(ds.n, K, replace=False)
    udfs, layers = [], []
    for j in range(ds.truth.shape[1]):
        params, predict, _ = jsyn._train_udf_model(
            ds.x[idx], ds.truth[idx, j], ds.n_classes[j], 24, 1, 21 + j)
        udfs.append(MLUDF(name=f"{ds.name}.udf{j}", cost=10.0, n_classes=ds.n_classes[j],
                          fn=lambda xx, _p=predict: np.asarray(_p(jnp.asarray(xx, jnp.float32)))))
        layers.append(interop.udf_layers(params))
    tds = tsyn.make_dataset(**DATA)
    tudfs = tsyn.make_udfs(tds, hidden=24, depth=1, train_rows=K, seed=21,
                           declared_cost_ms=10.0, weights=layers, device="cpu")

    def queries(columns, **kw):
        jq = jsyn.make_query(ds, udfs, columns=columns, seed=22, **kw)
        tq = tsyn.make_query(tds, tudfs, columns=columns, seed=22, **kw)
        assert [p.values for p in tq.predicates] == [p.values for p in jq.predicates]
        return jq, tq

    jq, q = queries([0, 1, 2])
    return dict(ds=tds, x=tds.x[:K], q=q, jq=jq, queries=queries,
                q_other=queries([0, 1, 3])[1], q_far=queries([0, 1, 2], accuracy_target=0.95)[1])


@pytest.fixture(scope="module")
def primed(workload):
    """A cache primed with the workload query's cold-optimized plan."""
    cache = PlanCache()
    plan, info = cache.optimize_query(workload["q"], workload["x"], OPTS, device="cpu")
    assert info["path"] == "cold"
    return cache, plan


# -------------------------------------------------------------- fingerprints
@pytest.mark.parametrize("kw", [
    {},
    dict(selectivities={0: 0.45, 1: 0.5, 2: 0.55}, correlations={(0, 1): 0.3, (2, 1): 0.1}),
    dict(kind="mixed", step=0.05, eps=0.2),
    dict(kind={0: "svm", 1: "mlp", 2: "linear"}, selectivities={1: 0.05}),
])
def test_digest_and_stat_vector_equal_reference(workload, kw):
    fp = fingerprint_query(workload["q"], **kw)
    ref = j_fingerprint(workload["jq"], **kw)
    assert fp.digest == ref.digest
    assert np.array_equal(fp.stat_vec, ref.stat_vec) and fp.schema == ref.schema


def test_digest_separates_same_stats_different_predicates(workload):
    q, q_other = workload["q"], workload["q_other"]
    assert [p.udf.name for p in q.predicates] != [p.udf.name for p in q_other.predicates]
    sels = {0: 0.5, 1: 0.5, 2: 0.5}
    fp_a = fingerprint_query(q, selectivities=sels, step=0.05)
    fp_b = fingerprint_query(q_other, selectivities=sels, step=0.05)
    assert fp_a.distance(fp_b.stat_vec) < 1e-6
    assert fp_a.digest != fp_b.digest


def test_stat_collision_never_serves_wrong_plan(workload, primed):
    cache, _plan = primed
    q_other = workload["q_other"]
    kind, _entry, _dist = cache.lookup(fingerprint_query(q_other, step=0.05))
    assert kind != "exact"
    plan, info = cache.optimize_query(q_other, workload["x"], OPTS, device="cpu")
    assert info["path"] != "hit"
    assert plan.query is q_other and {s.pred_idx for s in plan.stages} == {0, 1, 2}


def test_digest_covers_accuracy_target_and_step(workload):
    fp = fingerprint_query(workload["q"], step=0.05)
    assert fingerprint_query(workload["q_far"], step=0.05).digest != fp.digest
    assert fingerprint_query(workload["q"], step=0.02).digest != fp.digest
    assert fingerprint_query(workload["q"], kind="mlp", step=0.05).digest != fp.digest


# ------------------------------------------------------------ exact vs warm
def test_exact_repeat_is_hit_and_skips_training(workload, primed):
    cache, plan = primed
    trained_before = cache.stats.misses + cache.stats.hits_warm
    p2, info = cache.optimize_query(workload["q"], workload["x"], OPTS, device="cpu")
    assert info["path"] == "hit" and p2.meta["mode"] == "wire"
    assert cache.stats.misses + cache.stats.hits_warm == trained_before
    assert p2.order == plan.order
    # the replayed scorer, on the requested device, scores as the cold plan's
    sc = info["scorer"]
    assert sc.device.type == "cpu"
    x = workload["ds"].x[K:K + 3000]
    want = serialize_scorer(plan)
    assert serialize_scorer(p2, sc) == want
    from repro_torch.kernels.ops import CascadeScorer

    cold = CascadeScorer.from_plan(plan, device="cpu").score_compact(x, need_scores=True)
    got = sc.score_compact(x, need_scores=True)
    for a, b in zip(cold[:2] + (cold[3],), got[:2] + (got[3],)):
        assert np.array_equal(a, b)
    assert all(np.array_equal(a, b) for a, b in zip(cold[2], got[2]))


def test_accept_hit_false_takes_warm_path_with_live_state(workload, primed):
    cache, _ = primed
    plan, info = cache.optimize_query(workload["q"], workload["x"], OPTS.replace(keep_state=True),
                                      accept_hit=False, device="cpu")
    assert info["path"] == "warm"
    assert "builder" in plan.meta and "bnb" in plan.meta
    assert plan.meta.get("warm_start") is True


def test_warm_start_visits_fewer_nodes_same_cost(workload):
    """A similar query (same predicates, shifted stats) warm-starts to the
    same Eq. 3.1 plan cost (within 5%) with strictly fewer B&B visits."""
    q, x = workload["q"], workload["x"]
    cold = build_plan(q, x, OPTS.replace(keep_state=True), device="cpu")
    cache = PlanCache()
    cache.record_plan(cold, step=0.05)
    warm, info = cache.optimize_query(q, x, OPTS, selectivities={0: 0.45, 1: 0.5, 2: 0.55},
                                      device="cpu")
    assert info["path"] == "warm"
    assert info["trace"]["nodes_visited"] < cold.meta["trace"]["nodes_visited"]
    assert warm.est_total_cost == pytest.approx(cold.est_total_cost, rel=0.05)
    assert warm.order == cold.order


def test_cold_fallback_leaves_cache_consistent(workload, primed):
    cache, _ = primed
    before = set(cache.digests())
    plan, info = cache.optimize_query(workload["q_far"], workload["x"], OPTS,
                                      selectivities=FAR_SELS, device="cpu")
    assert info["path"] == "cold"
    after = set(cache.digests())
    assert before <= after and len(after) == len(before) + 1
    _p2, i2 = cache.optimize_query(workload["q_far"], workload["x"], OPTS,
                                   selectivities=FAR_SELS, device="cpu")
    assert i2["path"] == "hit"


@pytest.mark.parametrize("regret_tol", [0.0, -1.0])
def test_regret_guard_falls_back_cold(workload, primed, regret_tol):
    """The guard's rule: a neighbor within the similarity threshold whose
    cached order's regret under the probe's selectivities exceeds
    ``regret_tol`` is rejected, and the query builds cold; otherwise it
    warm-starts.  (Whether the inverted selectivities below make the cached
    order's regret positive depends on the plan; at ``regret_tol`` -1 any
    regret exceeds it.)"""
    cache, _ = primed
    restored = PlanCache.from_bytes(cache.to_bytes(), similarity_threshold=1.0,
                                    regret_tol=regret_tol)
    _plan, info = restored.optimize_query(workload["q"], workload["x"], OPTS,
                                          selectivities={0: 0.95, 1: 0.05, 2: 0.95},
                                          device="cpu")
    assert info["regret"] is not None and info["regret"] >= 0.0
    rejected = info["regret"] > regret_tol
    assert info["path"] == ("cold" if rejected else "warm")
    assert restored.stats.fallbacks_regret == int(rejected)
    if regret_tol < 0:
        assert info["path"] == "cold"


# ------------------------------------------------------------------ eviction
def _stub_entry(cache, digest, vec, n_preds=3):
    cache._entries[digest] = PlanCacheEntry(
        digest=digest, stat_vec=np.asarray(vec, np.float64),
        artifact=b"", sidecar={"digest": digest, "n_predicates": n_preds,
                               "stat_vec": list(map(float, vec)),
                               "stages": [], "orders": [], "s_stars": {}, "hits": 0})
    cache._entries.move_to_end(digest)


def test_eviction_keeps_most_recently_hit():
    cache = PlanCache(capacity=2)
    va = [0.9, 0.1, 0.1, 0.1, 0.5, 0.5, 0.0, 0.0, 0.0, 0.0]
    vb = [0.9, 0.9, 0.9, 0.9, 0.5, 0.5, 0.9, 0.9, 0.9, 0.9]
    _stub_entry(cache, "aaaa", va)
    _stub_entry(cache, "bbbb", vb)

    class FP:  # minimal QueryFingerprint stand-in
        digest = "aaaa"
        stat_vec = np.asarray(va)
        n_predicates = 3

        def distance(self, other):
            o = np.asarray(other, np.float64)
            return (float(np.mean(np.abs(self.stat_vec - o)))
                    if o.shape == self.stat_vec.shape else float("inf"))

    kind, entry, _ = cache.lookup(FP())
    assert kind == "exact" and entry.digest == "aaaa"
    _stub_entry(cache, "cccc", [0.5] * 10)
    while len(cache._entries) > cache.capacity:
        cache._entries.popitem(last=False)
    assert "aaaa" in cache._entries and "cccc" in cache._entries
    assert "bbbb" not in cache._entries


def test_put_at_capacity_evicts_lru(workload):
    cache = PlanCache(capacity=1)
    cache.optimize_query(workload["q"], workload["x"], OPTS, device="cpu")
    d1 = cache.digests()[0]
    cache.optimize_query(workload["q_far"], workload["x"], OPTS, selectivities=FAR_SELS,
                         device="cpu")
    assert len(cache) == 1 and cache.digests()[0] != d1
    assert cache.stats.evictions >= 1


# --------------------------------------------------------------- persistence
def test_round_trip_byte_stable(primed):
    cache, _ = primed
    blob = cache.to_bytes()
    assert blob[:8] == PLANCACHE_MAGIC
    restored = PlanCache.from_bytes(blob)
    assert restored.to_bytes() == blob
    assert restored.digests() == cache.digests()


def test_restored_cache_exact_hits(workload):
    cache = PlanCache()
    cache.optimize_query(workload["q"], workload["x"], OPTS, device="cpu")
    restored = PlanCache.from_bytes(cache.to_bytes())
    _plan, info = restored.optimize_query(workload["q"], workload["x"], OPTS, device="cpu")
    assert info["path"] == "hit"


def test_corrupt_entry_skipped_with_warning(workload):
    cache = PlanCache()
    cache.optimize_query(workload["q"], workload["x"], OPTS, device="cpu")
    cache.optimize_query(workload["q_far"], workload["x"], OPTS, selectivities=FAR_SELS,
                         device="cpu")
    blob = bytearray(cache.to_bytes())
    # bytes inside the FIRST entry's frame header (after the 16-byte
    # container header and the 8-byte length prefix)
    for off in range(24 + 16, 24 + 32):
        blob[off] ^= 0xFF
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        restored = PlanCache.from_bytes(bytes(blob))
    assert any("corrupt" in str(w.message).lower() for w in caught)
    assert restored.stats.corrupt_skipped == 1 and len(restored) == 1
    _plan, info = restored.optimize_query(workload["q_far"], workload["x"], OPTS,
                                          selectivities=FAR_SELS, device="cpu")
    assert info["path"] == "hit"


def test_truncated_container_skips_tail(primed):
    cache, _ = primed
    blob = cache.to_bytes()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        restored = PlanCache.from_bytes(blob[: len(blob) - 10])
    assert any("truncated" in str(w.message).lower() for w in caught)
    assert len(restored) == len(cache) - 1


def test_bad_magic_raises():
    with pytest.raises(ValueError, match="magic"):
        PlanCache.from_bytes(b"NOTCACHE" + b"\x00" * 16)


def test_save_load_file(tmp_path, primed):
    cache, _ = primed
    p = tmp_path / "plans.coreplnc"
    cache.save(p)
    assert PlanCache.load(p).to_bytes() == cache.to_bytes()
    assert not list(tmp_path.glob("*.tmp.*"))  # published by os.replace


# ----------------------------------------------- the two packages' containers
def test_reference_container_exact_hits_in_the_port(workload):
    """A COREPLNC container the JAX package wrote loads in the port,
    exact-hits (the replayed plan is the reference's cold plan), and saves
    to the same bytes."""
    jcache = JPlanCache()
    jplan, jinfo = jcache.optimize_query(workload["jq"], workload["x"],
                                         JOptions(step=0.05, seed=0))
    assert jinfo["path"] == "cold"
    blob = jcache.to_bytes()
    cache = PlanCache.from_bytes(blob)
    assert cache.digests() == jcache.digests() and cache.to_bytes() == blob
    plan, info = cache.optimize_query(workload["q"], workload["x"], OPTS, device="cpu")
    assert info["path"] == "hit" and plan.order == jplan.order
    assert plan.est_total_cost == jplan.est_total_cost
    # the same hit in the reference leaves both caches in the same bytes
    assert jcache.optimize_query(workload["jq"], workload["x"],
                                 JOptions(step=0.05, seed=0))[1]["path"] == "hit"
    assert cache.to_bytes() == jcache.to_bytes() != blob


def test_port_container_exact_hits_in_the_reference(workload, primed):
    cache, plan = primed
    blob = PlanCache.from_bytes(cache.to_bytes()).to_bytes()
    jcache = JPlanCache.from_bytes(blob)
    assert jcache.to_bytes() == blob
    jplan, jinfo = jcache.optimize_query(workload["jq"], workload["x"],
                                         JOptions(step=0.05, seed=0))
    assert jinfo["path"] == "hit" and jplan.order == plan.order


# ------------------------------------------------- search-tree warm start
def _trees(workload):
    """The reference's cold keep-state plan, and two fresh trees (one per
    package) over builders that adopted its trained classifiers (the port's
    carried across with ``interop.proxy_model``)."""
    jcold = j_build_plan(workload["jq"], workload["x"],
                         JOptions(step=0.05, seed=0, keep_state=True))
    donor = jcold.meta["builder"].export_classifiers()
    jb = JProxyBuilder(workload["jq"], workload["x"], seed=0)
    jb.adopt_classifiers(donor)
    tb = ProxyBuilder(workload["q"], workload["x"], seed=0, device="cpu")
    tb.adopt_classifiers({k: (interop.proxy_model(p, "cpu"), phi)
                          for k, (p, phi) in donor.items()})
    A = workload["q"].accuracy_target
    return jcold, JBranchAndBound(jb, A, step=0.05), BranchAndBound(tb, A, step=0.05)


def _node_states(bb):
    return {k: (v.state, v.s_star, v.epoch) for k, v in bb.nodes.items()}


def test_seed_from_and_export_state_match_reference(workload):
    """Seeded with the same s* values and candidate orders, the port's tree
    holds the reference's node states, epochs and bounds (stale slack
    included), and its seeded resume visits as many nodes and picks the
    same order as the reference's."""
    jcold, jbb, tbb = _trees(workload)
    s_stars, orders = jcold.meta["bnb"].export_state()
    assert s_stars and orders
    s_stars[(9, 9)] = 0.5  # a prefix this tree does not have: ignored
    for bb in (jbb, tbb):
        bb.seed_from(s_stars, orders=orders + [(7, 8, 9)])
    assert _node_states(tbb) == _node_states(jbb) and tbb.epoch == jbb.epoch == 1
    assert tbb._Q == jbb._Q == [tuple(o) for o in orders]
    for o in tbb.orders:
        tb, jb = tbb._plan_bounds(o), jbb._plan_bounds(o)
        assert (tb.lower, tb.upper) == (jb.lower, jb.upper)
    talloc, ttrace = tbb.resume()
    jalloc, jtrace = jbb.resume()
    assert talloc.order == jalloc.order
    assert ttrace.nodes_visited == jtrace.nodes_visited
    assert {k: v[0] for k, v in _node_states(tbb).items()} == {
        k: v[0] for k, v in _node_states(jbb).items()}
    t_s, t_o = tbb.export_state()
    j_s, j_o = jbb.export_state()
    assert set(t_s) == set(j_s) and t_o == j_o


def test_adopted_classifiers_move_to_the_builder_device(workload, primed):
    """A transplanted classifier is copied onto the adopting builder's
    device; the donor's entry is left where it was, and a classifier
    already there is adopted as it is."""
    import torch

    _cache, plan = primed
    donor = plan.meta.get("builder")
    if donor is None:
        donor = build_plan(workload["q"], workload["x"], OPTS.replace(keep_state=True),
                           device="cpu").meta["builder"]
    classifiers = donor.export_classifiers()
    same = ProxyBuilder(workload["q"], workload["x"], device="cpu")
    same.adopt_classifiers(classifiers)
    assert all(same._proxies[k][0] is p for k, (p, _phi) in classifiers.items())
    other = ProxyBuilder(workload["q"], workload["x"], device="meta")
    other.adopt_classifiers(classifiers)
    for k, (p, phi) in classifiers.items():
        moved, moved_phi = other._proxies[k]
        assert moved_phi == phi and moved.r_curve is p.r_curve and moved.params is not p.params
        for f in dataclasses.fields(p.params):
            assert getattr(moved.params, f.name).device == torch.device("meta")
            assert getattr(p.params, f.name).device.type == "cpu"


# ----------------------------------------------------------- serving wiring
def test_engine_writes_back_committed_reopt(workload):
    """An adaptive CascadeServer on a drifting stream re-optimizes; the
    initial plan and every committed swap land in the cache, each artifact
    serialized from the scorer the engine installed, and a fresh probe at
    the drifted statistics finds the entry."""
    from repro_torch.serving.engine import CascadeServer
    from repro_torch.serving.stats import AdaptivePolicy

    q, x = workload["q"], workload["x"]
    plan = build_plan(q, x, OPTS.replace(keep_state=True), device="cpu")
    cache = PlanCache()
    cache.record_plan(plan, step=0.05)
    n_writes = cache.stats.writes
    stream = tsyn.make_drifting_stream(workload["ds"], 1500, 4000,
                                       shift_targets={0: 2.8, 1: -2.6, 2: 2.8},
                                       corr_gain=2.5, seed=5)
    policy = AdaptivePolicy(audit_rate=0.05, threshold=20.0, min_reservoir=96,
                            cooldown_records=512, reservoir_capacity=384)
    srv = CascadeServer(plan, tile=512, adaptive=True, policy=policy, seed=0,
                        plan_cache=cache, device="cpu")
    srv.run_stream(stream.x, chunk=512)
    st = srv.stats
    assert st.plan_swaps >= 1, "drift scenario produced no swap"
    assert st.plan_cache_writebacks == 1 + st.plan_swaps
    assert cache.stats.writes == n_writes + st.plan_cache_writebacks
    entry = cache._entries[cache.digests()[-1]]
    assert entry.artifact == serialize_scorer(srv.plan, srv._states[-1].cascade)
    assert st.emitted + st.rejected == stream.n and srv.in_flight() == 0
    drifted = {int(s["pred_idx"]): float(s["est_selectivity"]) for s in entry.sidecar["stages"]}
    _plan2, info = cache.optimize_query(q, x, OPTS, selectivities=drifted, device="cpu")
    assert info["path"] in ("hit", "warm")


def test_noncacheable_plan_is_refused(workload, primed):
    _cache, plan = primed
    wire_plan, _ = deserialize_scorer(serialize_scorer(plan), workload["q"], device="cpu")
    cache = PlanCache()
    assert cache.record_plan(wire_plan, step=0.05) is None
    assert len(cache) == 0


def test_warm_optimize_is_a_deprecated_alias(workload, primed):
    cache, plan = primed
    with pytest.warns(DeprecationWarning):
        p2, info = cache.warm_optimize(workload["q"], workload["x"], step=0.05, seed=0,
                                       device="cpu")
    assert info["path"] == "hit" and p2.order == plan.order
