"""The port's threefry2x32 (``repro_torch.util.prng``) against ``jax.random``,
and the paper loop's initial weights drawn from it against the JAX
package's.

Keys, splits and bits must be equal bit for bit.  ``uniform`` and
``normal`` are held bit for bit too: the port evaluates XLA's f32
``erfinv`` polynomial over XLA's CPU ``log1p`` / ``log`` with the same fused
multiply-adds, so the draws equal the reference's on the CPU exactly (a
tolerance of one ulp would also pass; none is used).
"""
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro.training import proxy_models as jpm

from repro_torch.data import synthetic as tsyn
from repro_torch.training import proxy_models as tpm
from repro_torch.util import prng
from _one_thread import one_thread  # noqa: F401

SEEDS = (0, 1, 7, 12345, 2**31 - 1)
SHAPES = ((1,), (3, 5), (64, 256), (4099,))


def _bits_equal(got, want) -> bool:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return got.dtype == want.dtype and got.shape == want.shape and np.array_equal(
        got.view(np.uint32), want.view(np.uint32))


def test_reference_uses_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_match_jax(seed):
    jk, k = jax.random.PRNGKey(seed), prng.key(seed)
    assert _bits_equal(k, jk)
    for n in (1, 2, 3, 9):
        assert _bits_equal(prng.split(k, n), jax.random.split(jk, n))
    # a key split from a split key, as the draw sites use them
    assert _bits_equal(prng.split(prng.split(k, 3)[2]), jax.random.split(jax.random.split(jk, 3)[2]))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_draws_match_jax(seed, shape):
    jk, k = jax.random.PRNGKey(seed), prng.key(seed)
    assert _bits_equal(prng.bits(k, shape).numpy().view(np.uint32), jax.random.bits(jk, shape))
    assert _bits_equal(prng.uniform(k, shape), jax.random.uniform(jk, shape))
    assert _bits_equal(prng.uniform(k, shape, -3.0, 2.0),
                       jax.random.uniform(jk, shape, minval=-3.0, maxval=2.0))
    got = prng.normal(k, shape)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert _bits_equal(got, jax.random.normal(jk, shape))


@pytest.mark.parametrize("fan_in", (3, 7, 12, 64))
def test_normal_scale_matches_jitted_division(fan_in):
    """Under ``jit`` XLA folds ``/ jnp.sqrt(n)`` into the normal's sqrt(2)."""
    jk = jax.random.PRNGKey(fan_in)
    want = jax.jit(lambda k: jax.random.normal(k, (fan_in, 32)) / jnp.sqrt(fan_in))(jk)
    scale = np.float32(1.0) / np.sqrt(np.float32(fan_in))
    assert _bits_equal(prng.normal(prng.key(fan_in), (fan_in, 32), scale=scale), want)


@pytest.mark.parametrize("hidden,depth,seed", [(64, 2, 3), (48, 2, 0), (16, 3, 12345), (256, 4, 1)])
def test_udf_initial_weights_match_reference(hidden, depth, seed):
    ds = jsyn.make_dataset(n=600, seed=0)
    x, y = ds.x[:400], ds.truth[:400, 1]
    want, _, _ = jsyn._train_udf_model(x, y, ds.n_classes[1], hidden, depth, seed, steps=0)
    got = tsyn._train_udf_model(x, y, ds.n_classes[1], hidden, depth, seed, steps=0,
                                device="cpu")
    assert len(got) == len(want) == depth + 1
    for (w, b), (jw, jb) in zip(got, want):
        assert _bits_equal(w, jw) and _bits_equal(b, jb)


@pytest.mark.parametrize("n_features,hidden,seed", [(64, 32, 0), (64, 32, 5), (12, 16, 1), (7, 32, 99)])
def test_mlp1_initial_weights_match_reference(n_features, hidden, seed):
    ds = jsyn.make_dataset(n=600, seed=1)
    x = ds.x[:300, :n_features]
    y = np.where(ds.truth[:300, 0] > 1, 1.0, -1.0).astype(np.float32)
    want = jpm.train_mlp(jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(seed), steps=0,
                         hidden=hidden)
    got = tpm.train_mlp(x, y, seed=seed, steps=0, hidden=hidden, device="cpu")
    for name in ("w1", "b1", "w2", "b2"):
        assert _bits_equal(getattr(got, name), getattr(want, name)), name


def test_paper_loop_queries_reported():
    """``make_query``'s value sets on quickstart's data and on phase 3's
    ``twitter`` profile, in both packages, each with its own UDFs trained
    from the same initial weights.  Reported (``pytest -s``), not held:
    trained weights differ by roundoff, so a label fraction near the
    target selectivity may tip a value set (ROADMAP.md, Queue 3)."""
    path = Path(__file__).resolve().parents[1] / "scripts" / "paper_loop_queries.py"
    spec = importlib.util.spec_from_file_location("paper_loop_queries", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rows = mod.report()
    assert [(r["workload"], r["query"]) for r in rows] == [
        ("quickstart", "quickstart"), ("phase3_twitter", "quickstart"),
        ("phase3_twitter", "mixed3")]
    for r in rows:
        print(json.dumps({k: r[k] for k in ("workload", "query", "reference", "port", "same")}))
        for sets in (r["reference"], r["port"]):
            assert all(sets) and all(v in range(4) for vs in sets for v in vs)


# ------------------------------------------------ the model zoo's draws
ZOO_SHAPES = ((1,), (7,), (3, 5), (33, 17), (2, 9, 13), (4099,))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches_jax(seed):
    jk, k = jax.random.PRNGKey(seed), prng.key(seed)
    for data in (0, 1, 7, 123456, 2**32 - 1):
        assert _bits_equal(prng.fold_in(k, data), jax.random.fold_in(jk, data))


@pytest.mark.parametrize("shape", ZOO_SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_truncated_normal_matches_jax(seed, shape):
    """f32 as jax draws it, then ``dense_init``'s ``* std`` and cast to bf16
    and a ``conv_w``'s weakly typed ``* 0.1`` after it."""
    jk, k = jax.random.PRNGKey(seed), prng.key(seed)
    want = jax.random.truncated_normal(jk, -2.0, 2.0, shape, jnp.float32)
    assert _bits_equal(prng.truncated_normal(k, shape), want)
    std = 1.0 / np.sqrt(shape[0])
    got = prng.truncated_normal(k, shape, std=std, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _bits_equal(got.float(), (want * std).astype(jnp.bfloat16).astype(jnp.float32))
    got = prng.truncated_normal(k, shape, std=std, dtype=torch.bfloat16, times=0.1)
    assert _bits_equal(got.float(),
                       ((want * std).astype(jnp.bfloat16) * 0.1).astype(jnp.float32))
    assert _bits_equal(prng.truncated_normal(k, shape, std=std),
                       jax.random.truncated_normal(jk, -2.0, 2.0, shape) * std)


@pytest.mark.parametrize("lower,upper", [(-1.0, 3.0), (-0.5, 0.7)])
def test_truncated_normal_other_bounds_match_jax(lower, upper):
    jk, k = jax.random.PRNGKey(3), prng.key(3)
    assert _bits_equal(prng.truncated_normal(k, (257,), lower, upper),
                       jax.random.truncated_normal(jk, lower, upper, (257,)))


@pytest.mark.parametrize("span", [(0, 256), (0, 128256), (3, 1000), (-5, 17), (0, 1)])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_matches_jax(seed, span):
    jk, k = jax.random.PRNGKey(seed), prng.key(seed)
    for shape in ((1,), (3, 5), (64, 257)):
        want = jax.random.randint(jk, shape, *span, jnp.int32)
        assert _bits_equal(prng.randint(k, shape, *span), want)
        got = prng.randint(k, shape, *span, dtype=torch.int64)
        assert got.dtype == torch.int64 and np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", ZOO_SHAPES + ((4, 64, 48),))
@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_normal_matches_jax(seed, shape):
    jk, k = jax.random.PRNGKey(seed), prng.key(seed)
    got = prng.normal(k, shape, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = jax.random.normal(jk, shape, jnp.bfloat16).astype(jnp.float32)
    assert _bits_equal(got.float(), want)


def test_normal_times_matches_eager_product():
    """``times`` is an eager ``normal(k, shape) * times``: two roundings."""
    jk, k = jax.random.PRNGKey(11), prng.key(11)
    assert _bits_equal(prng.normal(k, (9, 31), times=0.05), jax.random.normal(jk, (9, 31)) * 0.05)


def test_block_matches_jax_past_two_to_the_32():
    """The threefry2x32 block at counters whose high word is not 0, as a
    draw of more than 2^32 elements uses them: against jax's primitive."""
    from jax._src import prng as jprng

    idx = np.array([0, 1, 2**32 - 1, 2**32, 2**32 + 1, 2**32 + 7, 3 * 2**32 + 5, 2**40 + 3],
                   np.uint64)
    hi, lo = (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(
        np.uint32)
    for seed in (0, 5):
        k = prng.key(seed)
        want = jprng.threefry2x32_p.bind(jnp.uint32(k[0]), jnp.uint32(k[1]), jnp.asarray(hi),
                                         jnp.asarray(lo))
        got = prng.threefry2x32(k, hi, lo)
        assert all(_bits_equal(g, w) for g, w in zip(got, want))
        draw = prng.Draw(prng.threefry.BITS, k, torch.int32)
        assert _bits_equal(draw.at(idx).numpy().view(np.uint32), np.asarray(want[0] ^ want[1]))


@pytest.mark.parametrize("name", ["uniform", "normal", "normal_bf16", "truncated_normal",
                                  "randint", "bits"])
def test_draw_at_indices_equals_the_whole_draw(name):
    """``Draw.at`` at sampled flat indices equals the whole draw there, for
    every transform (how a draw of billions of elements on the card is
    checked), and ``recording`` sees each draw with its tensor."""
    k, shape = prng.key(9), (37, 41)
    calls = {"uniform": lambda: prng.uniform(k, shape, -1.0, 3.0),
             "normal": lambda: prng.normal(k, shape, scale=0.5, times=0.25),
             "normal_bf16": lambda: prng.normal(k, shape, dtype=torch.bfloat16),
             "truncated_normal": lambda: prng.truncated_normal(
                 k, shape, std=0.2, dtype=torch.bfloat16, times=0.1),
             "randint": lambda: prng.randint(k, shape, -3, 1000, dtype=torch.int64),
             "bits": lambda: prng.bits(k, shape, device="cpu")}
    with prng.recording() as drawn:
        whole = calls[name]()
    assert len(drawn) == 1 and drawn[0][0] is whole
    idx = np.random.RandomState(0).choice(whole.numel(), 50, replace=False)
    assert torch.equal(drawn[0][1].at(idx), whole.reshape(-1)[torch.from_numpy(idx)])
    out = torch.empty(shape, dtype=whole.dtype)
    prng.sample(drawn[0][1], shape, out=out)
    assert torch.equal(out, whole)
