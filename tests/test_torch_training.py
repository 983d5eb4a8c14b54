"""The port's proxy and UDF trainers against the JAX package's on the same
numpy-seeded data.

* ``train_linear_svm`` is deterministic (zero init): params agree at
  rtol=1e-4 (atol=1e-6 for entries near zero).
* ``train_mlp`` draws its init from ``jax.random``, which torch cannot
  reproduce, so the port is given the reference's init: params agree at
  atol=1e-4.
* UDFs trained by the JAX package and carried across label rows the same
  except where the top two logits tie within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.data import synthetic as jsyn
from repro.training import proxy_models as jpm

from repro_torch.data import synthetic as tsyn
from repro_torch import interop
from repro_torch.training import proxy_models as tpm


def _data(seed, n=600, F=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, F).astype(np.float32) * rng.uniform(0.5, 2.0, F).astype(np.float32)
    w = rng.randn(F)
    y = np.where(x @ w + 0.7 * rng.randn(n) > 0.4, 1.0, -1.0).astype(np.float32)
    return x, y


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_train_linear_svm_matches_reference(seed):
    x, y = _data(seed)
    ref = jpm.train_linear_svm(jnp.asarray(x), jnp.asarray(y))
    port = tpm.train_linear_svm(x, y, device="cpu")
    for field in ("w", "b", "mean", "scale"):
        np.testing.assert_allclose(_np(getattr(port, field)), np.asarray(getattr(ref, field)),
                                   rtol=1e-4, atol=1e-6, err_msg=field)
    np.testing.assert_allclose(_np(tpm.linear_score(port, x)),
                               np.asarray(jpm.linear_score(ref, jnp.asarray(x))),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed,hidden", [(0, 32), (3, 8)])
def test_train_mlp_matches_reference_given_its_init(seed, hidden):
    x, y = _data(seed + 10, F=12)
    F = x.shape[1]
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    init = (np.asarray(jax.random.normal(k1, (F, hidden)) / jnp.sqrt(F)),
            np.zeros(hidden, np.float32),
            np.asarray(jax.random.normal(k2, (hidden,)) / jnp.sqrt(hidden)),
            np.zeros((), np.float32))
    ref = jpm.train_mlp(jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(seed),
                        hidden=hidden)
    port = tpm.train_mlp(x, y, hidden=hidden, init=init, device="cpu")
    for field in ("w1", "b1", "w2", "b2", "mean", "scale"):
        np.testing.assert_allclose(_np(getattr(port, field)), np.asarray(getattr(ref, field)),
                                   atol=1e-4, err_msg=field)
    np.testing.assert_allclose(_np(tpm.mlp_score(port, x)),
                               np.asarray(jpm.mlp_score(ref, jnp.asarray(x))), atol=1e-3)


def test_train_mlp_generator_init_is_seeded():
    x, y = _data(4, n=200, F=8)
    a = tpm.train_mlp(x, y, seed=5, steps=20, device="cpu")
    b = tpm.train_mlp(x, y, seed=5, steps=20, device="cpu")
    c = tpm.train_mlp(x, y, seed=6, steps=20, device="cpu")
    assert np.array_equal(_np(a.w1), _np(b.w1))
    assert not np.array_equal(_np(a.w1), _np(c.w1))


def test_f1_and_pack_match_reference():
    x, y = _data(2)
    ref = jpm.train_linear_svm(jnp.asarray(x), jnp.asarray(y))
    port = interop.linear_params(ref, "cpu")
    s = np.asarray(jpm.linear_score(ref, jnp.asarray(x)))
    for thr in (-0.5, 0.0, 0.5):
        assert tpm.f1_score(s, y, thr) == jpm.f1_score(s, y, thr)
    for a, b in zip(tpm.pack_linear(port), jpm.pack_linear(ref)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_udf_weights_carried_across_label_like_reference():
    ds = jsyn.make_dataset(name="t", n=3000, n_columns=2, seed=3)
    port_ds = tsyn.make_dataset(name="t", n=3000, n_columns=2, seed=3)
    assert np.array_equal(ds.x, port_ds.x) and np.array_equal(ds.truth, port_ds.truth)
    rows = np.random.RandomState(3).choice(ds.n, 800, replace=False)
    params, predict, logits_fn = jsyn._train_udf_model(
        ds.x[rows], ds.truth[rows, 0], 4, 24, 2, 3, steps=100)
    udf = tsyn.make_udfs(port_ds, hidden=24, depth=2, train_rows=800, seed=3,
                         declared_cost_ms=5.0, device="cpu",
                         weights=[interop.udf_layers(params)] * 2)[0]
    assert udf.cost == 5.0
    ref_labels = np.asarray(predict(jnp.asarray(ds.x)))
    logits = np.sort(np.asarray(logits_fn(params, jnp.asarray(ds.x))), axis=1)
    near_tie = logits[:, -1] - logits[:, -2] < 1e-4
    assert not np.any((udf(ds.x) != ref_labels) & ~near_tie)


def test_udf_training_is_seeded_and_learns():
    ds = tsyn.make_dataset(name="t", n=2000, n_columns=1, seed=1)
    a = tsyn._train_udf_model(ds.x, ds.truth[:, 0], 4, 16, 1, 7, steps=60, device="cpu")
    b = tsyn._train_udf_model(ds.x, ds.truth[:, 0], 4, 16, 1, 7, steps=60, device="cpu")
    assert all(np.array_equal(_np(wa), _np(wb)) for (wa, _), (wb, _) in zip(a, b))
    udf = tsyn.make_udfs(ds, hidden=16, depth=1, train_rows=2000, seed=1, device="cpu")[0]
    assert udf.cost > 0.0  # profiled, no declared cost
    assert udf.train_accuracy > 0.5  # four balanced classes: chance is 0.25
