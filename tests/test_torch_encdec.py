"""The port's encoder-decoder family (``repro_torch.models.encdec``) against
the JAX package's on the CPU, at reduced seamless-m4t-medium (2 encoder
and 2 decoder layers, d_model 64): the same weights (drawn by
``jax.random``, carried across by ``interop.encdec_params``) and the same
numpy-seeded tokens and frames go through ``forward``, ``prefill`` then
``decode_step`` (the caches padded for the new tokens), and ``loss`` with
its gradients.

Tolerances: f32 at 1e-5 (atol = rtol; gradients 1e-5 of their largest
value), both f32 summed in other orders; bf16 at 5e-2 (forward, prefill)
and 8e-2 (decode), the bounds ``tests/test_models_consistency.py`` holds
the JAX package's own serving path to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import encdec as jed

from repro_torch import interop
from repro_torch.configs import reduced_config
from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.models.leaves import leaf_of
from repro_torch.models.registry import get_family, make_batch
from _one_thread import one_thread  # noqa: F401

ARCH, PROMPT, NEW, BATCH = "seamless-m4t-medium", 32, 4, 2
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
    """(jcfg, cfg, jax params, port model, port batch, jax batch) with
    PROMPT + NEW tokens, built once a dtype."""
    if dtype not in _CASES:
        jcfg = jax_reduced_config(ARCH).replace(dtype=dtype, remat=False)
        cfg = reduced_config(ARCH).replace(dtype=dtype)
        jparams = jed.init(jax.random.PRNGKey(5), jcfg)
        model = interop.encdec_params(jparams, cfg, device="cpu")
        tb = make_batch(cfg, BATCH, PROMPT + NEW, key=2, device="cpu")
        jb = {"tokens": jnp.asarray(tb["tokens"].numpy(), jnp.int32),
              "frames": jnp.asarray(tb["frames"].float().numpy()).astype(jnp.bfloat16)}
        _CASES[dtype] = (jcfg, cfg, jparams, model, tb, jb)
    return _CASES[dtype]


def test_registry_batch_and_init():
    cfg = reduced_config(ARCH)
    assert get_family(cfg) is encdec
    b = make_batch(cfg, 2, 40, key=1, device="cpu")
    assert b["frames"].shape == (2, encdec.enc_len_for(cfg, 40), cfg.d_model)
    assert b["frames"].dtype == torch.bfloat16 and b["tokens"].shape == (2, 40)
    m = encdec.init(0, cfg, device="cpu")
    assert len(m.enc_layers) == cfg.encoder.num_layers and len(m.dec_layers) == cfg.num_layers
    names = [n for n, _ in m.named_parameters()]
    assert "dec_layers.1.cross_attn.wq" in names and "enc_norm" in names
    assert leaf_of("dec_layers.1.ln_x") == (("dec_layers", "ln_x"), 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_and_decode_match_jax(dtype):
    jcfg, cfg, jparams, model, tb, jb = _case(dtype)
    prompt = {"tokens": tb["tokens"][:, :PROMPT], "frames": tb["frames"]}
    jprompt = {"tokens": jb["tokens"][:, :PROMPT], "frames": jb["frames"]}
    got = encdec.forward(model, cfg, prompt)
    assert got.dtype == torch.float32 and got.shape == (BATCH, PROMPT, cfg.vocab_size)
    _close(got, jax.jit(lambda p, b: jed.forward(p, jcfg, b))(jparams, jprompt), TOL[dtype])

    logits, cache = encdec.prefill(model, cfg, prompt)
    jlogits, jcache = jax.jit(lambda p, b: jed.prefill(p, jcfg, b))(jparams, jprompt)
    _close(logits, jlogits, TOL[dtype])
    assert cache["pos"] == PROMPT and cache["xk"].shape[2] == tb["frames"].shape[1]
    pad = torch.nn.functional.pad
    cache = {**cache, "k": pad(cache["k"], (0, 0, 0, 0, 0, NEW)),
             "v": pad(cache["v"], (0, 0, 0, 0, 0, NEW))}
    jpad = ((0, 0), (0, 0), (0, NEW), (0, 0), (0, 0))
    jcache = {**jcache, "k": jnp.pad(jcache["k"], jpad), "v": jnp.pad(jcache["v"], jpad)}
    jstep = jax.jit(lambda p, c, t: jed.decode_step(p, jcfg, c, t))
    for i in range(NEW):
        tok = tb["tokens"][:, PROMPT + i]
        logits, cache = encdec.decode_step(model, cfg, cache, tok)
        jlogits, jcache = jstep(jparams, jcache, jb["tokens"][:, PROMPT + i])
        _close(logits, jlogits, DECODE_TOL[dtype])
    assert cache["pos"] == PROMPT + NEW


def test_loss_and_gradients_match_jax():
    jcfg, cfg, jparams, model, tb, jb = _case("float32")
    labels = np.roll(tb["tokens"].numpy(), -1, axis=1)
    tbatch = dict(tb, labels=torch.from_numpy(labels))
    jbatch = dict(jb, labels=jnp.asarray(labels, jnp.int32))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jed.loss(p, jcfg, b), has_aux=True))(jparams, jbatch)
    trained = L.trainable(interop.encdec_params(jparams, cfg.replace(remat=True), device="cpu"))
    loss, _ = encdec.loss(trained, cfg.replace(remat=True), tbatch)
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
