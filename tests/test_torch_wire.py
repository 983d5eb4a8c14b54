"""COREWIRE across the two packages: the port's scorer artifacts (minor 0
fp32, minor 2 int8 / fp8) and control frames (minor 1) against the JAX
package's, byte for byte and both ways, on the same plan.

The plan is the JAX package's (mixed linear / mlp1 stages over three
predicates, as its own wire tests build it), carried across with
``interop.physical_plan``; the UDFs are its trained weights carried across
with ``interop.udf_layers``.  The JAX scorer runs in interpret mode (its
default on the CPU), the port's through the plain route.

Keep decisions agree except tie rows: a score within ``FOLD_TIE_TOL``
(1e-4 * max(1, |thr|)) of its threshold, the tolerance the port's checks
use for folded scores (the two packages sum the same products in other
orders).
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import OptimizeOptions as JOptions, build_plan as j_build_plan
from repro.core.query import MLUDF, Predicate as JPredicate, Query as JQuery
from repro.data import synthetic as jsyn
from repro.kernels import ops as jops

from repro_torch import interop
from repro_torch.core import execute_plan
from repro_torch.core.proxy_family import get_family
from repro_torch.core.query import Predicate, Query
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops
from repro_torch.kernels.ops import (
    FRAME_DELTA,
    FRAME_PLANCACHE,
    FRAME_RESYNC,
    WIRE_MINOR_QUANT,
    CascadeScorer,
    WireFormatError,
    deserialize_frame,
    deserialize_scorer,
    pack_le,
    serialize_frame,
    serialize_scorer,
)
from _one_thread import one_thread  # noqa: F401


DATA = dict(n=6000, n_features=64, n_columns=3, correlation=0.9, feature_noise=0.9,
            label_noise=0.2, seed=41)
K = 1200  # the optimization sample
FOLD_TIE_TOL = 1e-4
DTYPES = ("float32", "int8", "fp8")


@pytest.fixture(scope="module")
def workload():
    """The JAX package's dataset, UDFs (hidden 16, depth 1) and mixed plan,
    and their counterparts in the port."""
    ds = jsyn.make_dataset(**DATA)
    idx = np.random.RandomState(41).choice(ds.n, K, replace=False)
    udfs, layers = [], []
    for j in range(ds.truth.shape[1]):
        params, predict, _ = jsyn._train_udf_model(
            ds.x[idx], ds.truth[idx, j], ds.n_classes[j], 16, 1, 41 + j)
        udfs.append(MLUDF(name=f"{ds.name}.udf{j}", cost=10.0, n_classes=ds.n_classes[j],
                          fn=lambda xx, _p=predict: np.asarray(_p(jnp.asarray(xx, jnp.float32)))))
        layers.append(interop.udf_layers(params))
    jq = jsyn.make_query(ds, udfs, columns=[0, 1, 2], target_selectivity=0.5,
                         accuracy_target=0.9, seed=42)
    jplan = j_build_plan(jq, ds.x[:K], JOptions(mode="core-a", kind="mixed", step=0.05))
    tds = tsyn.make_dataset(**DATA)
    tudfs = tsyn.make_udfs(tds, hidden=16, depth=1, train_rows=K, seed=41,
                           declared_cost_ms=10.0, weights=layers, device="cpu")
    tq = tsyn.make_query(tds, tudfs, columns=[0, 1, 2], target_selectivity=0.5,
                         accuracy_target=0.9, seed=42)
    assert [p.values for p in tq.predicates] == [p.values for p in jq.predicates]
    assert {s.proxy.family for s in jplan.stages} == {"linear", "mlp1"}
    return dict(ds=ds, jq=jq, tq=tq, jplan=jplan,
                tplan=interop.physical_plan(jplan, tq, "cpu"))


def _at(plan, dtype):
    """``plan`` stamped with a weight storage dtype (fp32: unstamped)."""
    if dtype == "float32":
        return plan
    return dataclasses.replace(plan, meta={**plan.meta, "quant_dtype": dtype})


def _header(blob):
    n = int.from_bytes(blob[12:20], "little")
    return json.loads(blob[20:20 + n].decode("utf-8"))


def _tie(scores, thr):
    return np.abs(scores - thr) <= FOLD_TIE_TOL * np.maximum(1.0, np.abs(thr))


# ------------------------------------------------------------- artifacts
@pytest.mark.parametrize("dtype", DTYPES)
def test_reference_blob_round_trips_through_the_port(workload, dtype):
    """A blob the JAX package writes (its autotuned block_m included) loads
    in the port, keeps its codes, dtype and block_m, and serializes again to
    the same bytes."""
    jplan = _at(workload["jplan"], dtype)
    blob = jops.serialize_scorer(jplan)
    minor = int.from_bytes(blob[10:12], "little")
    assert minor == (0 if dtype == "float32" else WIRE_MINOR_QUANT)
    plan2, sc2 = deserialize_scorer(blob, workload["tq"], device="cpu")
    assert serialize_scorer(plan2, sc2) == blob
    assert sc2.dtype == dtype and sc2.block_m == _header(blob)["scorer"]["block_m"]
    assert sc2.buckets[0] == sc2.block_m
    jsc = jops.cascade_scorer_for_plan(jplan)[0]
    for a, b in zip(jsc.packed[:4], sc2.packed[:4]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert plan2.order == jplan.order and plan2.meta["mode"] == "wire"
    assert plan2.meta.get("quant_dtype") == (None if dtype == "float32" else dtype)
    assert all(s.proxy.family == "packed1" for s in plan2.stages)
    for s1, s2 in zip(jplan.stages, plan2.stages):
        assert (s2.threshold, s2.alpha) == (float(s1.threshold), float(s1.alpha))
        assert np.array_equal(np.asarray(s1.proxy.r_curve.thresholds),
                              s2.proxy.r_curve.thresholds)


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_blob_round_trips_through_the_reference(workload, dtype):
    blob = serialize_scorer(_at(workload["tplan"], dtype))
    jplan2, jsc2 = jops.deserialize_scorer(blob, workload["jq"])
    assert jops.serialize_scorer(jplan2, jsc2) == blob
    # the port's tuned block_m travels, and is the reference's own choice
    want = jops.CascadeScorer.from_plan(_at(workload["jplan"], dtype), max_tile=8192).block_m
    assert jsc2.dtype == dtype and jsc2.block_m == _header(blob)["scorer"]["block_m"] == want
    plan2, sc2 = deserialize_scorer(blob, workload["tq"], device="cpu")
    assert serialize_scorer(plan2, sc2) == blob


@pytest.mark.parametrize("dtype", DTYPES)
def test_equal_block_m_writes_identical_bytes(workload, dtype):
    """Both packages' scorers tune block_m to the same value on the CPU, so
    at their defaults they write the same artifact for the same plan (the
    JAX-trained proxy params carried across)."""
    jplan, tplan = _at(workload["jplan"], dtype), _at(workload["tplan"], dtype)
    jsc = jops.CascadeScorer.from_plan(jplan, max_tile=8192)
    assert CascadeScorer.from_plan(tplan, device="cpu").block_m == jsc.block_m
    want = jops.serialize_scorer(jplan, jsc)
    assert serialize_scorer(tplan, CascadeScorer.from_plan(tplan, device="cpu")) == want
    assert serialize_scorer(tplan) == want  # no scorer: packed on the host


@pytest.mark.parametrize("dtype", DTYPES)
def test_deserialized_keep_decisions_agree_with_reference(workload, dtype):
    """The port's scorer rebuilt from the JAX package's blob keeps what the
    JAX package's own deserialized scorer keeps, except tie rows; and it is
    bit-identical to the port's scorer of the original plan (same codes,
    same route)."""
    x = workload["ds"].x[2000:3000]
    blob = jops.serialize_scorer(_at(workload["jplan"], dtype))
    _jp, jsc = jops.deserialize_scorer(blob, workload["jq"])
    _tp, tsc = deserialize_scorer(blob, workload["tq"], device="cpu")
    jscores, jmasks, _pk, jcounts = jsc.score_compact(x, need_scores=True)
    tscores, tmasks, tpacked, tcounts = tsc.score_compact(x, need_scores=True)
    assert tmasks.shape == jmasks.shape == (len(x), 3)
    differ = tmasks != np.asarray(jmasks)
    assert not (differ & ~_tie(np.asarray(jscores), tsc.thr_host)).any()
    own = CascadeScorer.from_plan(_at(workload["tplan"], dtype), device="cpu")
    oscores, omasks, opacked, ocounts = own.score_compact(x, need_scores=True)
    assert np.array_equal(oscores, tscores) and np.array_equal(omasks, tmasks)
    assert np.array_equal(ocounts, tcounts)
    assert all(np.array_equal(a, b) for a, b in zip(opacked, tpacked))


def test_deserialized_plan_executes_like_the_original(workload):
    x = workload["ds"].x[K:]
    plan2, _ = deserialize_scorer(serialize_scorer(workload["tplan"]), workload["tq"],
                                  device="cpu")
    want = execute_plan(workload["tplan"], x, use_kernel=True, device="cpu")
    got = execute_plan(plan2, x, use_kernel=True, device="cpu")
    assert np.array_equal(got.passed, want.passed)


# ---------------------------------------------------------------- frames
FRAMES = [(FRAME_RESYNC, 7, {"host": 3}), (FRAME_DELTA, 3, {"kind": "prepare", "host": None}),
          (FRAME_PLANCACHE, 0, {"digest": "ab", "stat_vec": [0.9, 0.5]})]


@pytest.mark.parametrize("kind,epoch,meta", FRAMES)
def test_frames_are_byte_identical_across_packages(workload, kind, epoch, meta):
    payload = (serialize_scorer(workload["tplan"]) if kind != FRAME_DELTA
               else b"\x00\x01binary-artifact-bytes\xff")
    frame = serialize_frame(kind, epoch, payload, meta=meta)
    assert frame == jops.serialize_frame(kind, epoch, payload, meta=meta)
    assert frame[10:12] == b"\x01\x00"
    assert deserialize_frame(frame) == (kind, epoch, payload, meta)
    assert jops.deserialize_frame(frame) == (kind, epoch, payload, meta)


def test_frame_and_artifact_channels_cannot_be_confused(workload):
    artifact = serialize_scorer(workload["tplan"])
    frame = serialize_frame(FRAME_RESYNC, 7, artifact, meta={"host": 3})
    plan2, _ = deserialize_scorer(deserialize_frame(frame)[2], workload["tq"], device="cpu")
    assert plan2.order == workload["tplan"].order
    assert artifact[:8] == b"COREWIRE" and artifact[10:12] == b"\x00\x00"
    with pytest.raises(WireFormatError, match="control frame"):
        deserialize_scorer(frame, workload["tq"], device="cpu")
    with pytest.raises(jops.WireFormatError, match="control frame"):
        jops.deserialize_scorer(frame, workload["jq"])
    for blob in (artifact, serialize_scorer(_at(workload["tplan"], "int8"))):
        with pytest.raises(WireFormatError):
            deserialize_frame(blob)
        with pytest.raises(jops.WireFormatError):
            jops.deserialize_frame(blob)
    with pytest.raises(WireFormatError, match="truncated"):
        deserialize_frame(frame[:-10])
    with pytest.raises(jops.WireFormatError, match="truncated"):
        jops.deserialize_frame(frame[:-10])


# ------------------------------------------------------------ rejections
def _garbled(blob):
    """Each planted fault: (name, blob, query or None for the workload's)."""
    return [
        ("bad magic", b"NOTAWIRE" + blob[8:]),
        ("version 99", blob[:8] + pack_le(99, 2) + blob[10:]),
        ("minor 3", blob[:10] + pack_le(3, 2) + blob[12:]),
        ("truncated payload", blob[:-7]),
        ("truncated header", blob[:40]),
    ]


@pytest.mark.parametrize("dtype", ("float32", "int8"))
def test_planted_faults_raise_wire_format_error(workload, dtype):
    """The rejections of the JAX package's wire tests, and a truncated
    payload or header: the port raises ``WireFormatError`` on each; the
    JAX package rejects each too (a truncated payload there as a plain
    ``ValueError`` from numpy)."""
    blob = serialize_scorer(_at(workload["tplan"], dtype))
    for name, bad in _garbled(blob):
        with pytest.raises(WireFormatError):
            deserialize_scorer(bad, workload["tq"], device="cpu")
        with pytest.raises(ValueError):
            jops.deserialize_scorer(bad, workload["jq"])
    with pytest.raises(WireFormatError, match="unknown wire minor"):
        deserialize_scorer(_garbled(blob)[2][1], workload["tq"], device="cpu")
    # wrong query shape and wrong accuracy target
    u = [p.udf for p in workload["tq"].predicates]
    q2 = Query([Predicate(udf=v, values=frozenset({1})) for v in u[:2]], accuracy_target=0.9)
    ju = [p.udf for p in workload["jq"].predicates]
    jq2 = JQuery([JPredicate(udf=v, values=frozenset({1})) for v in ju[:2]],
                 accuracy_target=0.9)
    with pytest.raises(WireFormatError, match="predicates"):
        deserialize_scorer(blob, q2, device="cpu")
    with pytest.raises(jops.WireFormatError, match="predicates"):
        jops.deserialize_scorer(blob, jq2)
    q95 = dataclasses.replace(workload["tq"], accuracy_target=0.95)
    with pytest.raises(WireFormatError, match="accuracy"):
        deserialize_scorer(blob, q95, device="cpu")


def test_packed1_is_not_trainable(workload):
    plan2, _ = deserialize_scorer(serialize_scorer(workload["tplan"]), workload["tq"],
                                  device="cpu")
    assert plan2.stages[0].proxy.family == "packed1"
    with pytest.raises(TypeError):
        get_family("packed1").train(workload["ds"].x[:32], np.ones(32), 0, "cpu")


def test_no_proxied_stage_has_nothing_to_ship(workload):
    from repro_torch.core import orig_plan

    with pytest.raises(WireFormatError, match="nothing to ship"):
        serialize_scorer(orig_plan(workload["tq"]))


# ------------------------------------------------------- quant parity gate
@pytest.mark.parametrize("dtype", ("int8", "fp8"))
def test_quant_parity_report_matches_reference(workload, dtype):
    """The port's report against the JAX package's on the same plan and
    rows: the gate bit agrees, and every count differs by at most the rows
    at a tie (the two packages' fp32 and quantized scores are each within
    float rounding of the other's)."""
    x = workload["ds"].x[K:K + 2000]
    got = ops.quant_parity_report(workload["tplan"], x, dtype=dtype, device="cpu")
    want = jops.quant_parity_report(workload["jplan"], x, dtype=dtype)
    assert got["flips_within_tol"] is want["flips_within_tol"] is True
    assert (got["dtype"], got["n_eval"]) == (want["dtype"], want["n_eval"])
    assert got["tol"] == pytest.approx(want["tol"], rel=1e-3, abs=1e-5)
    assert got["max_err_eval"] <= 2.0 * got["tol"]
    sc = CascadeScorer.from_plan(workload["tplan"], device="cpu")
    n_cal = len(x) // 2
    s = sc.score_compact(x[n_cal:], need_scores=True)[0]
    ties = int((np.abs(s - sc.thr_host) <= max(got["tol"], want["tol"])
                + FOLD_TIE_TOL * np.maximum(1.0, np.abs(sc.thr_host))).any(axis=1).sum())
    assert abs(got["n_flips"] - want["n_flips"]) <= ties
    np.testing.assert_allclose(got["sel_fp32"], want["sel_fp32"], atol=ties / got["n_eval"])
    np.testing.assert_allclose(got["sel_quant"], want["sel_quant"], atol=ties / got["n_eval"])
