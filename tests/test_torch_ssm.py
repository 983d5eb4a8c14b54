"""The port's Mamba-2 family (``repro_torch.models.ssm``) against the JAX
package's on the CPU: the same weights (drawn by ``jax.random`` and carried
across by ``interop.ssm_params``) and the same numpy-seeded tokens go
through both, at the JAX init and with Mamba-2's published ``A_log`` and
``dt_bias`` ranges (``chip_smoke.published_dynamics``), under which the
chunk decays and the carried state are far from 0.

Tolerances: f32 at atol = rtol = 1e-5 (both f32, summed in other orders;
the largest difference seen is 3.3e-6); bf16 at 5e-2 (forward, prefill) and
8e-2 (decode), the bounds ``tests/test_models_consistency.py`` holds the JAX
package's own serving path to (bf16 rounds at other places in the two
frameworks; the largest differences seen are 0.016 and 0.013).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import ssm as jssm

from repro_torch import interop
from repro_torch.configs import reduced_config
from repro_torch.models import ssm
from repro_torch.models.registry import get_family, make_batch


sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from _one_thread import one_thread  # noqa: F401

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
DECODE_TOL = {"float32": 1e-5, "bfloat16": 8e-2}
ARCH, PROMPT, NEW, BATCH = "mamba2-2.7b", 32, 6, 2


def _np(x):
    return np.asarray(x.to(torch.float32) if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


_CASES = {}


def _case(dtype, dynamics):
    """(jcfg, cfg, jax params, port model, port tokens (BATCH, PROMPT + NEW),
    jax tokens), built once per module."""
    key = (dtype, dynamics)
    if key not in _CASES:
        jcfg = jax_reduced_config(ARCH).replace(remat=False, dtype=dtype)
        cfg = reduced_config(ARCH).replace(remat=False, dtype=dtype)
        jparams = jssm.init(jax.random.PRNGKey(3), jcfg)
        if dynamics == "published":
            A_log, dt_bias = chip_smoke.published_dynamics(cfg.num_layers, cfg.ssm_heads, seed=2)
            jparams["layers"]["A_log"] = jnp.asarray(A_log)
            jparams["layers"]["dt_bias"] = jnp.asarray(dt_bias)
        model = interop.ssm_params(jparams, cfg, device="cpu")
        tokens = make_batch(cfg, BATCH, PROMPT + NEW, key=1, device="cpu")["tokens"]
        _CASES[key] = (jcfg, cfg, jparams, model, tokens, jnp.asarray(tokens.numpy(), jnp.int32))
    return _CASES[key]


DTYPES = ["float32", "bfloat16"]
DYNAMICS = ["jax_init", "published"]


@pytest.mark.parametrize("dynamics", DYNAMICS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_jax(dtype, dynamics):
    jcfg, cfg, jparams, model, tokens, jtokens = _case(dtype, dynamics)
    got = ssm.forward(model, cfg, {"tokens": tokens[:, :PROMPT]})
    want = jssm.forward(jparams, jcfg, {"tokens": jtokens[:, :PROMPT]})
    assert got.dtype == torch.float32 and got.shape == (BATCH, PROMPT, cfg.vocab_size)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dynamics", DYNAMICS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_jax(dtype, dynamics):
    """Prefill logits and cache (conv tail, SSM state), then NEW decode
    steps on the batch's next tokens, step by step."""
    jcfg, cfg, jparams, model, tokens, jtokens = _case(dtype, dynamics)
    logits, cache = ssm.prefill(model, cfg, {"tokens": tokens[:, :PROMPT]})
    jlogits, jcache = jssm.prefill(jparams, jcfg, {"tokens": jtokens[:, :PROMPT]})
    _close(logits, jlogits, TOL[dtype])
    assert cache["pos"] == PROMPT == int(jcache["pos"])
    assert cache["conv"].dtype == getattr(torch, dtype) and cache["ssm"].dtype == torch.float32
    _close(cache["conv"], jcache["conv"], TOL[dtype])
    _close(cache["ssm"], jcache["ssm"], TOL[dtype])
    for t in range(PROMPT, PROMPT + NEW):
        logits, cache = ssm.decode_step(model, cfg, cache, tokens[:, t])
        jlogits, jcache = jssm.decode_step(jparams, jcfg, jcache, jtokens[:, t])
        _close(logits, jlogits, DECODE_TOL[dtype])
    assert cache["pos"] == PROMPT + NEW
    _close(cache["ssm"], jcache["ssm"], DECODE_TOL[dtype])
    _close(cache["conv"], jcache["conv"], DECODE_TOL[dtype])


@pytest.mark.parametrize("dynamics", DYNAMICS)
def test_decode_from_scratch_matches_forward(dynamics):
    """The port's serving path against its own training path (the JAX
    package's ``test_decode_path_matches_forward`` for the SSM family)."""
    _jcfg, cfg, _jparams, model, tokens, _jtokens = _case("bfloat16", dynamics)
    full = ssm.forward(model, cfg, {"tokens": tokens[:, :PROMPT]})
    cache = ssm.init_cache(cfg, BATCH, PROMPT, device="cpu")
    for t in range(PROMPT):
        logits, cache = ssm.decode_step(model, cfg, cache, tokens[:, t])
    _close(logits, full[:, -1], DECODE_TOL["bfloat16"])


def test_prefill_refuses_a_ragged_prompt():
    _jcfg, cfg, _jparams, model, tokens, _jtokens = _case("float32", "jax_init")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.prefill(model, cfg, {"tokens": tokens[:, :PROMPT - 3]})


def test_init_and_cache_shapes():
    cfg = reduced_config(ARCH)
    model = ssm.init(0, cfg, device="cpu")
    jparams = jssm.init(jax.random.PRNGKey(0), jax_reduced_config(ARCH))
    assert get_family(cfg) is ssm
    names = dict(model.named_parameters())
    for key, a in jparams["layers"].items():
        for i in range(cfg.num_layers):
            p = names[f"layers.{i}.{key}"]
            assert tuple(p.shape) == a.shape[1:] and str(p.dtype).endswith(str(a.dtype))
    lp = model.layers[0]
    assert torch.all(lp.A_log == 0) and torch.all(lp.D == 1) and torch.all(lp.dt_bias == 0)
    # conv_w is the fan-in normal (std 1/sqrt(d_conv), cut at 2 std) times 0.1
    assert 0 < float(lp.conv_w.float().abs().max()) <= 0.1 * 2 / np.sqrt(cfg.ssm.d_conv) + 1e-3
    again = ssm.init(0, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    cache = ssm.init_cache(cfg, 3, 100, device="cpu")
    jcache = jssm.init_cache(jax_reduced_config(ARCH), 3, 100)
    for key in ("conv", "ssm"):
        assert tuple(cache[key].shape) == jcache[key].shape
        assert str(cache[key].dtype).endswith(str(jcache[key].dtype))
    assert cache["pos"] == 0


def test_constructors_need_a_device():
    cfg = reduced_config(ARCH)
    for make in (lambda: ssm.Mamba2(cfg), lambda: ssm.Layer(cfg)):
        with pytest.raises(TypeError):
            make()
