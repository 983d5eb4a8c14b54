"""Slice A end to end: the port's optimize-and-execute path against the JAX
package on the same data, with the JAX package's trained UDF weights
carried across (torch cannot reproduce ``jax.random``).

* A reduced quickstart (the flow of ``examples/quickstart.py``): the same
  ``make_query`` value sets, the same stage order, and a cost-model saving
  and an accuracy vs ORIG each within 0.02 of the JAX package's.
* A JAX-built plan converted by ``interop`` executes to the same passed set
  through the port's fused scorer, except rows at a threshold tie: a proxy
  score within 1e-4*max(1,|thr|) of its threshold (the packed form folds
  the standardizer into the weights, a float32 reassociation) or a UDF
  whose top two logits lie within 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (OptimizeOptions as JOptions, build_plan as j_build_plan,
                        execute_plan as j_execute, ns_plan as j_ns_plan,
                        orig_plan as j_orig, plan_accuracy, pp_plan as j_pp_plan,
                        rebuild_plan as j_rebuild_plan)
from repro.core.query import MLUDF
from repro.data import synthetic as jsyn

from repro_torch import interop, quickstart
from repro_torch.core import (OptimizeOptions, execute_plan, ns_plan, orig_plan, pp_plan,
                              rebuild_plan)
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels.ops import CascadeScorer, cascade_scorer_for_plan
from _one_thread import one_thread  # noqa: F401


N, K = 7000, 1500  # quickstart: n=20,000 and k=1500; the dataset is cut to 7000
FOLD_TOL = 1e-4


@pytest.fixture(scope="module")
def reference():
    """The JAX package's quickstart flow (build_plan in place of the
    deprecated optimize shim), keeping each UDF's trained layers."""
    ds = jsyn.make_dataset(name="tweets", n=N, correlation=0.9, seed=0)
    idx = np.random.RandomState(0).choice(ds.n, min(3000, ds.n), replace=False)
    udfs, layers, logit_fns = [], [], []
    for j in range(ds.truth.shape[1]):
        params, predict, logits_fn = jsyn._train_udf_model(
            ds.x[idx], ds.truth[idx, j], ds.n_classes[j], 64, 2, j)
        udfs.append(MLUDF(name=f"{ds.name}.udf{j}", cost=20.0, n_classes=ds.n_classes[j],
                          fn=lambda xx, _p=predict: np.asarray(_p(jnp.asarray(xx, jnp.float32)))))
        layers.append(interop.udf_layers(params))
        logit_fns.append(lambda xx, _f=logits_fn, _p=params: np.asarray(_f(_p, jnp.asarray(xx))))
    query = jsyn.make_query(ds, udfs, columns=[0, 1], target_selectivity=0.5,
                            accuracy_target=0.9, seed=1)
    plan = j_build_plan(query, ds.x[:K], JOptions(mode="core"))
    rest = ds.x[K:]
    orig = j_execute(j_orig(query), rest)
    res = j_execute(plan, rest)
    return dict(ds=ds, query=query, plan=plan, layers=layers, logit_fns=logit_fns,
                orig=orig, res=res, saving=1 - res.model_cost_ms / orig.model_cost_ms,
                accuracy=plan_accuracy(res, orig))


@pytest.fixture(scope="module")
def port(reference):
    return quickstart.run(N, "cpu", udf_weights=reference["layers"], verbose=False)


def test_streams_reproduce_bit_for_bit():
    kw = dict(name="t", n=2500, n_columns=3, correlation=0.7, seed=5)
    a, b = jsyn.make_dataset(**kw), tsyn.make_dataset(**kw)
    for field in ("x", "truth", "directions", "w_feat"):
        assert np.array_equal(getattr(a, field), getattr(b, field))
    sa = jsyn.make_drifting_stream(a, 300, 200, shift_targets={0: 1.5}, corr_gain=2.0, seed=3)
    sb = tsyn.make_drifting_stream(b, 300, 200, shift_targets={0: 1.5}, corr_gain=2.0, seed=3)
    assert np.array_equal(sa.x, sb.x) and np.array_equal(sa.truth, sb.truth)
    ha = jsyn.make_sharded_drifting_streams(a, 3, 100, 100, shift_targets={1: 1.0},
                                            boundary_jitter=0.2, seed=2)
    hb = tsyn.make_sharded_drifting_streams(b, 3, 100, 100, shift_targets={1: 1.0},
                                            boundary_jitter=0.2, seed=2)
    for u, v in zip(ha, hb):
        assert np.array_equal(u.x, v.x) and u.boundary == v.boundary


def test_quickstart_matches_reference(reference, port):
    ref_q, port_q = reference["query"], port["query"]
    assert [p.values for p in port_q.predicates] == [p.values for p in ref_q.predicates]
    assert port["order"] == reference["plan"].order
    assert abs(port["saving"] - reference["saving"]) <= 0.02
    assert abs(port["accuracy"] - reference["accuracy"]) <= 0.02
    assert port["accuracy"] >= 0.9 - 0.05
    assert all(port["used_kernel"])


def _tie_rows(reference, rows):
    """Rows of ``rows`` at a proxy-threshold or UDF-logit tie (module doc)."""
    ds, plan = reference["ds"], reference["plan"]
    x = reference["ds"].x[K:][rows]
    near = np.zeros(len(rows), bool)
    for st in plan.stages:
        if st.proxy is not None:
            near |= np.abs(st.proxy.score(x) - st.threshold) <= FOLD_TOL * max(1.0, abs(st.threshold))
        lg = np.sort(reference["logit_fns"][st.pred_idx](x), axis=1)
        near |= lg[:, -1] - lg[:, -2] < FOLD_TOL
    assert ds.x.shape[0] == N
    return set(np.asarray(rows)[near].tolist())


@pytest.mark.parametrize("fused", [True, False])
def test_interop_plan_executes_like_reference(reference, port, fused):
    """The JAX package's plan over the port's query: same passed set except
    ties, on the fused scorer and on the one-call-per-stage path."""
    plan = interop.physical_plan(reference["plan"], port["query"], "cpu")
    assert plan.order == reference["plan"].order
    assert [s.threshold for s in plan.stages] == [s.threshold for s in reference["plan"].stages]
    rest = reference["ds"].x[K:]
    res = execute_plan(plan, rest, use_kernel=True, fused=fused, batch_size=2048, device="cpu")
    assert all(s.used_kernel for s in res.stages)
    diff = set(res.passed.tolist()) ^ set(reference["res"].passed.tolist())
    assert diff <= _tie_rows(reference, np.asarray(sorted(diff), np.int64))
    orig = execute_plan(orig_plan(port["query"]), rest, device="cpu")
    assert orig.model_cost_ms == pytest.approx(reference["orig"].model_cost_ms, rel=1e-3)


def test_scorer_cache_keys_on_content(reference, port):
    plan_a = interop.physical_plan(reference["plan"], port["query"], "cpu")
    plan_b = interop.physical_plan(reference["plan"], port["query"], "cpu")
    s_a, hit_a = cascade_scorer_for_plan(plan_a, device="cpu")
    s_b, hit_b = cascade_scorer_for_plan(plan_b, device="cpu")
    assert hit_b and s_a is s_b and (not hit_a or s_a is s_b)
    assert s_a.covers_all(plan_a)
    direct = CascadeScorer.from_plan(plan_a, device="cpu")
    x = reference["ds"].x[K:K + 500]
    np.testing.assert_array_equal(direct.score_masks(x), s_b.score_masks(x))


def _assert_plans_agree(port_plan, ref_plan, thr_rel=1e-3):
    """Same order and accuracy allocation; thresholds and the Eq. 3.1
    estimate equal to float32 training noise (``thr_rel``)."""
    assert port_plan.order == ref_plan.order
    assert [s.alpha for s in port_plan.stages] == pytest.approx(
        [s.alpha for s in ref_plan.stages])
    for a, b in zip(port_plan.stages, ref_plan.stages):
        assert (a.proxy is None) == (b.proxy is None)
        assert a.threshold == pytest.approx(b.threshold, rel=thr_rel, abs=1e-3)
    assert port_plan.est_total_cost == pytest.approx(ref_plan.est_total_cost,
                                                     rel=max(thr_rel, 1e-3))


def test_baselines_and_rebuild_match_reference(reference, port):
    """PP and NS baselines on the raw sample, and a re-optimization
    (Algorithm 1 on the incumbent order) over a fresh sample."""
    x_opt = reference["ds"].x[:K]
    _assert_plans_agree(pp_plan(port["query"], x_opt, step=0.05, device="cpu"),
                        j_pp_plan(reference["query"], x_opt, step=0.05))
    # a hinge-loss proxy's training can flip one margin across 1 at a
    # different step under another summation order (w then moves by ~1e-2
    # after agreeing to 1e-6): thresholds of the NS conjunction proxy and of
    # the proxies retrained on the fresh sample are held to 5%
    _assert_plans_agree(ns_plan(port["query"], x_opt, device="cpu"),
                        j_ns_plan(reference["query"], x_opt), thr_rel=0.05)
    x_new = reference["ds"].x[K:2 * K]
    rebuilt = rebuild_plan(port["plan"], x_new, device="cpu")
    _assert_plans_agree(rebuilt, j_rebuild_plan(reference["plan"], x_new), thr_rel=0.05)
    assert rebuilt.meta["plan_version"] == 1 and "builder" in rebuilt.meta
    deeper = rebuild_plan(rebuilt, x_new, OptimizeOptions(reopt="bnb"), device="cpu")
    assert sorted(deeper.order) == sorted(port["plan"].order)
    assert deeper.meta["mode"] == "reopt-bnb" and deeper.meta["plan_version"] == 2
