"""The port's hybrid family (``repro_torch.models.rglru``: RG-LRU blocks and
local MQA) against the JAX package's on the CPU, at reduced
recurrentgemma-2b (6 blocks, two (rec, rec, attn) groups, d_model 64,
window 32): the same weights (drawn by ``jax.random``, carried across by
``interop.rglru_params``) and numpy-seeded tokens go through ``forward``,
``prefill`` then ``decode_step``, and ``loss`` with its gradients.  The
prompt (48 tokens) is longer than the window, so the window's mask and the
prefill's ring buffer (slot pos % W) are exercised, and decode wraps the
ring.

``linear_scan`` sums the recurrence in a doubling tree where the JAX
package's ``lax.associative_scan`` takes another tree: in f32 they agree to
rounding, so f32 is held at 1e-5 (atol = rtol; gradients 1e-5 of their
largest value).  bf16 at 5e-2 (forward, prefill) and 8e-2 (decode), the
JAX package's own serving bounds (``tests/test_models_consistency.py``).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import rglru as jrg

from repro_torch import interop
from repro_torch.configs import reduced_config
from repro_torch.models import layers as L
from repro_torch.models import rglru
from repro_torch.models.leaves import leaf_of
from repro_torch.models.registry import get_family, make_batch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from _one_thread import one_thread  # noqa: F401

ARCH, PROMPT, NEW, BATCH = "recurrentgemma-2b", 48, 4, 2
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
DECODE_TOL = {"float32": 1e-5, "bfloat16": 8e-2}


@pytest.fixture(scope="module", autouse=True)
def quick_compiles():
    """XLA's cheaper compile pipeline for this module's one-off programs
    (restored afterwards)."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", was)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


_CASES = {}


def _case(dtype):
    """(jcfg, cfg, jax params, port model, port tokens, jax tokens) with
    PROMPT + NEW tokens, built once a dtype."""
    if dtype not in _CASES:
        jcfg = jax_reduced_config(ARCH).replace(dtype=dtype, remat=False)
        cfg = reduced_config(ARCH).replace(dtype=dtype)
        assert cfg.attention.window < PROMPT
        jparams = jrg.init(jax.random.PRNGKey(7), jcfg)
        model = interop.rglru_params(jparams, cfg, device="cpu")
        tokens = make_batch(cfg, BATCH, PROMPT + NEW, key=4, device="cpu")["tokens"]
        _CASES[dtype] = (jcfg, cfg, jparams, model, tokens,
                         jnp.asarray(tokens.numpy(), jnp.int32))
    return _CASES[dtype]


@pytest.mark.parametrize("S", [1, 2, 5, 16, 37])
def test_linear_scan_matches_the_recurrence(S):
    rng = np.random.RandomState(S)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, S, 3)).astype(np.float32))
    b = torch.from_numpy(rng.randn(2, S, 3).astype(np.float32))
    h, want = torch.zeros(2, 3), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(rglru.linear_scan(a, b), torch.stack(want, dim=1), 1e-6)


def test_registry_init_and_leaves():
    cfg = reduced_config(ARCH)
    assert get_family(cfg) is rglru
    m = rglru.init(0, cfg, device="cpu")
    kinds = cfg.layer_kinds()
    assert [hasattr(b, "rec") for b in m.blocks] == [k == "rec" for k in kinds]
    lam = getattr(m.blocks[0].rec, "lambda")
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
    assert bool(((a > 0.9 - 1e-6) & (a < 0.999 + 1e-6)).all())
    assert leaf_of("blocks.4.rec.lambda") == (("blocks", 4, "rec", "lambda"), None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_and_decode_match_jax(dtype):
    jcfg, cfg, jparams, model, tokens, jtokens = _case(dtype)
    got = rglru.forward(model, cfg, {"tokens": tokens[:, :PROMPT]})
    assert got.dtype == torch.float32 and got.shape == (BATCH, PROMPT, cfg.vocab_size)
    want = jax.jit(lambda p, t: jrg.forward(p, jcfg, {"tokens": t}))(jparams, jtokens[:, :PROMPT])
    _close(got, want, TOL[dtype])

    logits, cache = rglru.prefill(model, cfg, {"tokens": tokens[:, :PROMPT]})
    jlogits, jcache = jax.jit(lambda p, t: jrg.prefill(p, jcfg, {"tokens": t}))(
        jparams, jtokens[:, :PROMPT])
    _close(logits, jlogits, TOL[dtype])
    for c, jc in zip(cache["blocks"], jcache["blocks"]):
        for k in c:  # the ring buffer's slots and the recurrent states
            _close(c[k], np.asarray(jc[k].astype(jnp.float32)), TOL[dtype])
    jstep = jax.jit(lambda p, c, t: jrg.decode_step(p, jcfg, c, t))
    for i in range(NEW):
        logits, cache = rglru.decode_step(model, cfg, cache, tokens[:, PROMPT + i])
        jlogits, jcache = jstep(jparams, jcache, jtokens[:, PROMPT + i])
        _close(logits, jlogits, DECODE_TOL[dtype])
    assert cache["pos"] == PROMPT + NEW


def test_short_prompt_decode_matches_forward():
    """A prompt shorter than the window, its caches grown for the new
    tokens (``chip_smoke.pad_family_cache``): prefill then decode equals
    ``forward`` over the whole sequence (the JAX package's decode clamps
    its write into a cache of the prompt's length instead)."""
    _jcfg, cfg, _jparams, model, tokens, _ = _case("float32")
    S = cfg.attention.window // 2
    logits, cache = rglru.prefill(model, cfg, {"tokens": tokens[:, :S]})
    cache = chip_smoke.pad_family_cache(cfg, cache, NEW)
    got = [logits]
    for i in range(NEW - 1):
        logits, cache = rglru.decode_step(model, cfg, cache, tokens[:, S + i])
        got.append(logits)
    want = rglru.forward(model, cfg, {"tokens": tokens[:, :S + NEW - 1]})[:, S - 1:]
    _close(torch.stack(got, dim=1), want, 1e-5)


def test_loss_and_gradients_match_jax():
    jcfg, cfg, jparams, _model, tokens, jtokens = _case("float32")
    labels = np.roll(tokens.numpy(), -1, axis=1)
    tb = {"tokens": tokens, "labels": torch.from_numpy(labels)}
    jb = {"tokens": jtokens, "labels": jnp.asarray(labels, jnp.int32)}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jrg.loss(p, jcfg, b), has_aux=True))(jparams, jb)
    rcfg = cfg.replace(remat=True)
    trained = L.trainable(interop.rglru_params(jparams, rcfg, device="cpu"))
    loss, _ = rglru.loss(trained, rcfg, tb)
    names, params = zip(*trained.named_parameters())
    grads = torch.autograd.grad(loss, params)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5
    for name, g in zip(names, grads):
        path, layer = leaf_of(name)
        want = jgrads
        for key in path:
            want = want[key]
        want = np.asarray(want)[layer] if layer is not None else np.asarray(want)
        assert float(np.abs(_np(g) - want).max() / max(np.abs(want).max(), 1e-30)) <= 1e-5, name
