"""The port's packed format against the JAX package's: equal params give
byte-equal packed cascades, kernel operands, quantized codes and content
fingerprints; the fp8 grid (torch's native float8_e4m3fn) equals the one
the JAX package builds with ml_dtypes."""
import gc

import numpy as np
import pytest
import torch

from repro.core import proxy_family as jpf
from repro.kernels import ops as jops
from repro.training.proxy_models import LinearParams, MLPParams, PackedProxy

from repro_torch import interop
from repro_torch.core import proxy_family as tpf
from repro_torch.kernels import ops as tops
from repro_torch.training import proxy_models as tpm


def _linear(rng, F):
    return LinearParams(
        w=rng.randn(F).astype(np.float32), b=np.float32(rng.randn()),
        mean=rng.randn(F).astype(np.float32),
        scale=(np.abs(rng.randn(F)) + 0.5).astype(np.float32))


def _mlp(rng, F, H):
    return MLPParams(
        w1=rng.randn(F, H).astype(np.float32), b1=rng.randn(H).astype(np.float32),
        w2=rng.randn(H).astype(np.float32), b2=np.float32(rng.randn()),
        mean=rng.randn(F).astype(np.float32),
        scale=(np.abs(rng.randn(F)) + 0.5).astype(np.float32))


def _cascade(seed, F=24, widths=(None, 7, None, 33, 2)):
    rng = np.random.RandomState(seed)
    return [_linear(rng, F) if h is None else _mlp(rng, F, h) for h in widths]


def _assert_bytes_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _assert_cascades_equal(tp, jp):
    for field in ("w1", "b1", "w2", "b2"):
        _assert_bytes_equal(getattr(tp, field), getattr(jp, field))
    assert tp.hidden == jp.hidden and tp.families == jp.families and tp.dtype == jp.dtype
    if jp.out_scale is None:
        assert tp.out_scale is None
    else:
        _assert_bytes_equal(tp.out_scale, jp.out_scale)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_cascade_byte_equal(seed):
    ref = _cascade(seed)
    port = [interop.proxy_params(p, "cpu") for p in ref]
    tp, jp = tpf.pack_cascade(port), jpf.pack_cascade(ref)
    _assert_cascades_equal(tp, jp)
    for a, b in zip(tpf.cascade_kernel_operands(tp), jpf.cascade_kernel_operands(jp)):
        _assert_bytes_equal(a, b)
    for col in range(len(ref)):
        for a, b in zip(tpf.unpack_cascade(tp, col), jpf.unpack_cascade(jp, col)):
            _assert_bytes_equal(a, b)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantize_cascade_byte_equal(dtype):
    ref = _cascade(4)
    port = [interop.proxy_params(p, "cpu") for p in ref]
    tq = tpf.quantize_cascade(tpf.pack_cascade(port), dtype)
    jq = jpf.quantize_cascade(jpf.pack_cascade(ref), dtype)
    _assert_cascades_equal(tq, jq)
    for a, b in zip(tpf.cascade_kernel_operands(tq), jpf.cascade_kernel_operands(jq)):
        _assert_bytes_equal(a, b)
    for col in range(len(ref)):
        for a, b in zip(tpf.unpack_cascade(tq, col), jpf.unpack_cascade(jq, col)):
            _assert_bytes_equal(a, b)
    with pytest.raises(ValueError, match="already quantized"):
        tpf.quantize_cascade(tq, "int8")
    with pytest.raises(ValueError, match="unknown quantization dtype"):
        tpf.quantize_cascade(tpf.pack_cascade(port), "int4")


def test_fp8_grid_matches_reference():
    """Every value class: normals, subnormals, exact halfway points, zero,
    signs, and values past the ±448 clip."""
    rng = np.random.RandomState(0)
    codes = torch.arange(256, dtype=torch.int16).to(torch.uint8).view(torch.float8_e4m3fn)
    reps = codes.to(torch.float32).numpy()
    reps = reps[np.isfinite(reps)]
    mids = (np.sort(reps)[:-1] + np.sort(reps)[1:]) / 2
    x = np.concatenate([
        rng.randn(4000) * 50, rng.randn(1000) * 1e-2, rng.randn(200) * 1e-3,
        reps, mids, [0.0, -0.0, 447.9, 448.0, 449.0, 1e6, -1e6, -448.0],
    ]).astype(np.float32)
    _assert_bytes_equal(tpf._fp8_grid(x), jpf._fp8_grid(x))


def test_hidden_bucket_and_registry_match():
    assert tpf.HIDDEN_BUCKETS == jpf.HIDDEN_BUCKETS
    for h in range(1, 600):
        assert tpf.hidden_bucket(h) == jpf.hidden_bucket(h)
    assert tpf.family_names() == jpf.family_names()
    for alias in ("svm", "linear", "mlp", "mlp1", "packed1"):
        assert tpf.get_family(alias).name == jpf.get_family(alias).name
    with pytest.raises(KeyError):
        tpf.get_family("gbdt")
    with pytest.raises(TypeError, match="not a trainable one"):
        tpf.get_family("packed1").train(None, None, 0, "cpu")


def test_fingerprint_matches_reference_and_packed1_is_identity():
    """The content fingerprint hashes packed bytes, so the port and the
    JAX package agree on it; a PackedProxy carried across packs to
    itself."""
    for ref in _cascade(5):
        port = interop.proxy_params(ref, "cpu")
        assert tops.params_fingerprint(port) == jops.params_fingerprint(ref)
        jpk = jpf.family_of(ref).pack(ref)
        ppk = interop.proxy_params(PackedProxy(*jpk), "cpu")
        assert tops.pack_proxy_cached(ppk) is ppk
        assert tops.params_fingerprint(ppk) == jops.params_fingerprint(ref)


def test_pack_cache_is_weak_and_memoizes():
    port = interop.proxy_params(_cascade(6)[1], "cpu")
    first = tops.pack_proxy_cached(port)
    assert tops.pack_proxy_cached(port) is first
    n = len(tops._PACK_CACHE)
    del port
    gc.collect()
    assert len(tops._PACK_CACHE) == n - 1


def test_packed_score_matches_family_score():
    rng = np.random.RandomState(8)
    x = rng.randn(50, 24).astype(np.float32)
    for ref in _cascade(7):
        port = interop.proxy_params(ref, "cpu")
        fam = tpf.family_of(port)
        np.testing.assert_allclose(tpm.packed_score(fam.pack(port), x), fam.score(port, x),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(fam.score(port, x), jpf.family_of(ref).score(ref, x),
                                   rtol=1e-5, atol=1e-5)
