"""The port's ``cascade_score`` (its plain route, on the CPU) against the JAX
package: the Pallas kernel run in interpret mode, and the ``kernels/ref.py``
oracle over the fused-parity and quantization shapes (ragged N, P > 128,
empty and keep-all stages, every hidden-bucket edge, int8 / fp8, chunking
above ``max_tile``).

Tolerances: scores atol=rtol=1e-5 (both fp32, summed in different orders);
masks, survivor lists and counts equal except rows whose reference score
lies within 1e-5*max(1,|thr|) of the threshold.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import proxy_family as jpf
from repro.kernels import ref as jref
from repro.kernels.proxy_score import cascade_score as jax_cascade_score
from repro.training.proxy_models import LinearParams, MLPParams

from repro_torch import interop
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ops import CascadeScorer
from repro_torch.kernels.proxy_score import cascade_score, proxy_score
from _one_thread import one_thread  # noqa: F401


TOL = 1e-5


def _linear(rng, F):
    return LinearParams(
        w=rng.randn(F).astype(np.float32), b=np.float32(rng.randn()),
        mean=rng.randn(F).astype(np.float32),
        scale=(np.abs(rng.randn(F)) + 0.5).astype(np.float32))


def _mlp(rng, F, H):
    return MLPParams(
        w1=rng.randn(F, H).astype(np.float32), b1=rng.randn(H).astype(np.float32),
        w2=(rng.randn(H) / np.sqrt(H)).astype(np.float32), b2=np.float32(rng.randn()),
        mean=rng.randn(F).astype(np.float32),
        scale=(np.abs(rng.randn(F)) + 0.5).astype(np.float32))


def _mixed(rng, F, P, widths=(1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33)):
    return [_linear(rng, F) if p % 2 == 0 else _mlp(rng, F, widths[p % len(widths)])
            for p in range(P)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tie(ref_scores, thr):
    thr = np.asarray(thr, np.float32)
    return np.abs(ref_scores - thr[None, :]) <= TOL * np.maximum(1.0, np.abs(thr))[None, :]


def _assert_matches(masks, packed, counts, ref_scores, ref_mask, thr, cols=None):
    """Masks equal off ties; each survivor list ascending, equal to the
    reference's off ties, and consistent with the port's own mask."""
    tie = _tie(ref_scores, thr)
    assert not np.any((masks != ref_mask) & ~tie)
    cols = range(ref_mask.shape[1]) if cols is None else cols
    for col in cols:
        rows = packed[col]
        np.testing.assert_array_equal(rows, np.flatnonzero(masks[:, col]))
        assert counts[col] == len(rows)
        diff = set(rows.tolist()) ^ set(np.flatnonzero(ref_mask[:, col]).tolist())
        assert diff <= set(np.flatnonzero(tie[:, col]).tolist())


# --------------------------------------------- against the Pallas kernel
PALLAS_CASES = [
    # (N, n_valid, F, P, weights, with_scores, compact_cols)
    (257, 257, 16, 3, "float32", True, None),
    (300, 211, 24, 4, "int8", True, (1,)),
    (128, 128, 8, 2, "float32", False, (0, 1)),
]


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_plain_matches_pallas_interpret(case):
    N, n_valid, F, P, weights, with_scores, cols = case
    rng = np.random.RandomState(N + P)
    packed = jpf.pack_cascade(_mixed(rng, F, P))
    if weights != "float32":
        packed = jpf.quantize_cascade(packed, weights)
    w1, b1, w2, b2 = jpf.cascade_kernel_operands(packed)
    thr = (0.3 * rng.randn(P)).astype(np.float32)
    x = rng.randn(N, F).astype(np.float32)
    scale = packed.out_scale
    js, jm, jp, jc = jax_cascade_score(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2), jnp.asarray(b2),
        jnp.asarray(thr), n_valid, out_scale=None if scale is None else jnp.asarray(scale),
        block_m=128, interpret=True, with_scores=True, compact_cols=cols)
    ts, tm, tp, tc = cascade_score(
        _t(x), _t(w1), _t(b1), _t(w2), _t(b2), _t(thr), n_valid,
        out_scale=None if scale is None else _t(scale), block_m=128,
        with_scores=with_scores, compact_cols=cols)
    js, jm, jp, jc = (np.asarray(a) for a in (js, jm, jp, jc))
    if with_scores:
        np.testing.assert_allclose(ts.numpy(), js, rtol=TOL, atol=TOL)
    else:
        assert ts is None
    tie = _tie(js, thr)
    assert not np.any((tm.numpy() != jm) & ~tie)
    assert not tm.numpy()[n_valid:].any()
    np.testing.assert_array_equal(tc.numpy(), tm.numpy().sum(0))
    assert tp.shape == jp.shape and tp.dtype == torch.int32
    sel = range(P) if cols is None else cols
    for ci, col in enumerate(sel):
        if not tie[:, col].any():
            np.testing.assert_array_equal(tp[ci].numpy(), jp[ci])  # -1 tail included
        n = int(tc[col])
        np.testing.assert_array_equal(tp[ci, :n].numpy(), np.flatnonzero(tm[:, col].numpy()))
        assert (tp[ci, n:] == -1).all()


# ------------------------------------------------ against the jnp oracle
def _ref_oracle(packed, thr, x):
    w1, b1, w2, b2 = jpf.cascade_kernel_operands(packed)
    scale = packed.out_scale
    s, m, _ = jref.cascade_score_ref(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2), jnp.asarray(b2),
        jnp.asarray(thr), out_scale=None if scale is None else jnp.asarray(scale))
    return np.asarray(s), np.asarray(m)


def _port_scorer(params, thr, **kw):
    return CascadeScorer([interop.proxy_params(p, "cpu") for p in params], thr,
                         device="cpu", **kw)


@pytest.mark.parametrize("n,f,p,seed", [
    (1, 4, 1, 0), (127, 17, 3, 1), (300, 96, 6, 2), (513, 64, 5, 3), (700, 33, 2, 4)])
def test_scorer_matches_oracle_ragged(n, f, p, seed):
    """Ragged N around the ladder and above max_tile (chunked), mixed
    families with hidden widths across the bucket ladder."""
    rng = np.random.RandomState(seed)
    params = _mixed(rng, f, p)
    thr = rng.randn(p).astype(np.float32)
    x = rng.randn(n, f).astype(np.float32)
    scorer = _port_scorer(params, thr, block_m=128, max_tile=512)
    s, masks, packed, counts = scorer.score_compact(x, need_scores=True)
    rs, rm = _ref_oracle(jpf.pack_cascade(params), thr, x)
    np.testing.assert_allclose(s, rs, rtol=TOL, atol=TOL)
    _assert_matches(masks, packed, counts, rs, rm, thr)


@pytest.mark.parametrize("family", ["linear", "mlp"])
def test_scorer_p_over_128(family):
    rng = np.random.RandomState(7)
    F, P, N = 12, 130, 300
    params = [_linear(rng, F) if family == "linear" else _mlp(rng, F, 2) for _ in range(P)]
    thr = rng.randn(P).astype(np.float32)
    x = rng.randn(N, F).astype(np.float32)
    _s, masks, packed, counts = _port_scorer(params, thr, block_m=128).score_compact(x)
    rs, rm = _ref_oracle(jpf.pack_cascade(params), thr, x)
    _assert_matches(masks, packed, counts, rs, rm, thr)


def test_scorer_empty_and_keep_all_stages():
    rng = np.random.RandomState(23)
    F, N = 16, 257
    params = [_linear(rng, F), _mlp(rng, F, 8), _linear(rng, F)]
    thr = np.asarray([-1e30, np.finfo(np.float32).max, 0.0], np.float32)
    x = rng.randn(N, F).astype(np.float32)
    _s, masks, packed, counts = _port_scorer(params, thr, block_m=128).score_compact(x)
    assert counts[0] == N and len(packed[0]) == N
    assert counts[1] == 0 and len(packed[1]) == 0 and not masks[:, 1].any()
    rs, rm = _ref_oracle(jpf.pack_cascade(params), thr, x)
    _assert_matches(masks, packed, counts, rs, rm, thr)


@pytest.mark.parametrize("h", [1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33, 64, 65, 128, 129])
def test_scorer_hidden_bucket_edges(h):
    rng = np.random.RandomState(29 + h)
    F, N = 10, 200
    params = [_mlp(rng, F, h), _linear(rng, F)]
    thr = rng.randn(2).astype(np.float32)
    x = rng.randn(N, F).astype(np.float32)
    scorer = _port_scorer(params, thr, block_m=128)
    s, masks, packed, counts = scorer.score_compact(x, need_scores=True)
    ref_packed = jpf.pack_cascade(params)
    assert scorer.packed.H == ref_packed.H
    rs, rm = _ref_oracle(ref_packed, thr, x)
    np.testing.assert_allclose(s, rs, rtol=TOL, atol=TOL)
    _assert_matches(masks, packed, counts, rs, rm, thr)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_scorer_quantized_matches_oracle(dtype):
    rng = np.random.RandomState(5)
    params = [_linear(rng, 20), _mlp(rng, 20, 7), _mlp(rng, 20, 3)]
    thr = rng.randn(3).astype(np.float32)
    x = rng.randn(300, 20).astype(np.float32)
    scorer = _port_scorer(params, thr, block_m=128, max_tile=512, dtype=dtype)
    s, masks, packed, counts = scorer.score_compact(x, need_scores=True)
    assert scorer.dtype == dtype and scorer.out_scale is not None
    assert scorer.w1.dtype == (torch.int8 if dtype == "int8" else torch.float32)
    rs, rm = _ref_oracle(jpf.quantize_cascade(jpf.pack_cascade(params), dtype), thr, x)
    np.testing.assert_allclose(s, rs, rtol=TOL, atol=TOL)
    _assert_matches(masks, packed, counts, rs, rm, thr)


def test_scorer_chunked_matches_single_tile():
    rng = np.random.RandomState(11)
    params = [_linear(rng, 20), _mlp(rng, 20, 6)]
    thr = np.zeros(2, np.float32)
    x = rng.randn(1500, 20).astype(np.float32)
    _, m1, p1, c1 = _port_scorer(params, thr, block_m=128, max_tile=512).score_compact(x)
    _, m2, p2, c2 = _port_scorer(params, thr, block_m=128, max_tile=4096).score_compact(x)
    np.testing.assert_array_equal(m1, m2)
    np.testing.assert_array_equal(c1, c2)
    for col in range(2):
        np.testing.assert_array_equal(p1[col], p2[col])
    masks = _port_scorer(params, thr, block_m=128, max_tile=512).score_masks(x)
    np.testing.assert_array_equal(masks, m1)


def test_ref_oracle_and_linear_wrapper_match_jax():
    rng = np.random.RandomState(3)
    F, P, N = 12, 4, 90
    x = rng.randn(N, F).astype(np.float32)
    w = rng.randn(F, P).astype(np.float32)
    b = rng.randn(P).astype(np.float32)
    thr = (0.5 * rng.randn(P)).astype(np.float32)
    js, jm = (np.asarray(a) for a in jref.proxy_score_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(thr)))
    ts, tm = proxy_score(_t(x), _t(w), _t(b), _t(thr))
    np.testing.assert_allclose(ts.numpy(), js, rtol=TOL, atol=TOL)
    assert not np.any((tm.numpy() != jm) & ~_tie(js, thr))
    packed = jpf.quantize_cascade(jpf.pack_cascade(_mixed(rng, F, 3)), "int8")
    ops = jpf.cascade_kernel_operands(packed)
    js, jm, jp = jref.cascade_score_ref(jnp.asarray(x), *(jnp.asarray(a) for a in ops),
                                        jnp.asarray(thr[:3]),
                                        out_scale=jnp.asarray(packed.out_scale))
    ts, tm, tp = tref.cascade_score_ref(_t(x), *(_t(a) for a in ops), _t(thr[:3]),
                                        out_scale=_t(packed.out_scale))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=TOL, atol=TOL)
    tie = _tie(np.asarray(js), thr[:3])
    assert not np.any((tm.numpy() != np.asarray(jm)) & ~tie)
    for col in range(3):
        if not tie[:, col].any():
            np.testing.assert_array_equal(tp[col].numpy(), jp[col])


def test_wrapper_rejects_bad_operands():
    x = torch.zeros(4, 3)
    w1, b1 = torch.zeros(3, 2), torch.zeros(2)
    w2, b2, thr = torch.zeros(2, 1), torch.zeros(1), torch.zeros(1)
    with pytest.raises(ValueError, match="w1 must be"):
        cascade_score(x, torch.zeros(4, 2), b1, w2, b2, thr, 4)
    with pytest.raises(ValueError, match="both be float32 or both int8"):
        cascade_score(x, w1.to(torch.int8), b1, w2, b2, thr, 4)
    with pytest.raises(ValueError, match="contiguous"):
        cascade_score(torch.zeros(3, 4).T, w1, b1, w2, b2, thr, 4)
    with pytest.raises(ValueError, match="compact_cols"):
        cascade_score(x, w1, b1, w2, b2, thr, 4, compact_cols=(1,))
