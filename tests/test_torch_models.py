"""The port's dense transformer (``repro_torch.models``) against the JAX
package's on the CPU: the same weights (drawn by ``jax.random`` and carried
across by ``interop.transformer_params``) and the same numpy-seeded tokens
go through both.

Tolerances: f32 at atol = rtol = 1e-5 (both f32, summed in other orders);
bf16 at 5e-2, the bound ``tests/test_models_consistency.py`` holds the JAX
package's own prefill and forward to (bf16 rounds at other places in the
two frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import layers as JL
from repro.models.registry import get_family as jax_get_family

from repro_torch import interop
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import layers as TL
from repro_torch.models import ssm, transformer
from repro_torch.models.registry import get_family, make_batch
from _one_thread import one_thread  # noqa: F401


TOL = {"float32": 1e-5, "bfloat16": 5e-2}
ARCHS = ("deepseek-67b", "qwen1.5-110b")  # the latter for its qkv bias
PROMPT, TOTAL, BATCH = 24, 36, 2


def _np(x):
    return np.asarray(x.to(torch.float32) if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _configs(arch, dtype, **changes):
    jcfg = jax_reduced_config(arch).replace(remat=False, dtype=dtype, **changes)
    cfg = reduced_config(arch).replace(remat=False, dtype=dtype, **changes)
    return jcfg, cfg


def _jax_params(jcfg, seed=3):
    params = jax_get_family(jcfg).init(jax.random.PRNGKey(seed), jcfg)
    attn = params["layers"]["attn"]
    for i, name in enumerate(("bq", "bk", "bv")):  # zeros at init: make the bias matter
        if name in attn:
            attn[name] = (0.5 * jax.random.normal(jax.random.PRNGKey(10 + i), attn[name].shape)
                          ).astype(attn[name].dtype)
    return params


_CASES = {}


def _case(arch, dtype, **changes):
    """(jcfg, cfg, jax params, port model, port batch, jax tokens, jax
    forward logits over TOTAL tokens), built once per module."""
    key = (arch, dtype, tuple(sorted(changes.items())))
    if key not in _CASES:
        jcfg, cfg = _configs(arch, dtype, **changes)
        jparams = _jax_params(jcfg)
        model = interop.transformer_params(jparams, cfg, device="cpu")
        batch = make_batch(cfg, BATCH, TOTAL, key=1, device="cpu")
        jtokens = jnp.asarray(batch["tokens"].numpy(), jnp.int32)
        jlogits = jax_get_family(jcfg).forward(jparams, jcfg, {"tokens": jtokens})
        _CASES[key] = (jcfg, cfg, jparams, model, batch, jtokens, np.asarray(jlogits))
    return _CASES[key]


# ------------------------------------------------------------ building blocks
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm_matches(dtype, plus_one):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 64).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    got = TL.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w), 1e-6,
                      plus_one=plus_one)
    want = JL.rms_norm(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(w), 1e-6,
                       plus_one=plus_one)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, TOL[dtype] if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches(dtype):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 40, 4, 16).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 140)[None], (2, 40)).astype(np.int32)
    got = TL.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(pos),
                        10000.0)
    want = JL.apply_rope(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(pos), 10000.0)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, TOL[dtype] if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("mode", ["causal", "window", "kv_valid"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_mha_matches(mode, dtype):
    rng = np.random.RandomState(2)
    B, S, H, K, hd = 2, 20, 8, 2, 16
    q, k, v = (rng.randn(B, S, n, hd).astype(np.float32) for n in (H, K, K))
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    valid = np.arange(S)[None, :] < np.array([[13], [20]])
    kw = dict(causal=mode != "kv_valid", window=7 if mode == "window" else 0)
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    j = [jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)]
    got = TL.mha(*t, q_positions=torch.from_numpy(pos), kv_positions=torch.from_numpy(pos),
                 kv_valid=torch.from_numpy(valid) if mode == "kv_valid" else None, **kw)
    want = JL.mha(*j, q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
                  kv_valid=jnp.asarray(valid) if mode == "kv_valid" else None, **kw)
    _close(got, want, TOL[dtype] if dtype == "float32" else 3e-2)


def test_ring_buffer_decode_matches():
    """``gqa_decode``'s local-window branch: the cache is a ring of the
    window's size, written in place."""
    jcfg, cfg = _configs("deepseek-67b", "float32")
    attn = dataclasses.replace(cfg.attention, kind="local", window=8)
    jcfg, cfg = jcfg.replace(attention=attn), cfg.replace(attention=attn)
    jp = JL.init_gqa(jax.random.PRNGKey(0), jcfg)
    p = TL.GQA(cfg, device="cpu")
    with torch.no_grad():
        for name, a in jp.items():
            getattr(p, name).copy_(torch.from_numpy(np.array(a)))
    rng = np.random.RandomState(3)
    jk = jnp.zeros((2, 8, attn.num_kv_heads, attn.head_dim))
    jv = jnp.zeros_like(jk)
    tk, tv = torch.zeros(tuple(jk.shape)), torch.zeros(tuple(jv.shape))
    for pos in range(13):
        x = rng.randn(2, 1, cfg.d_model).astype(np.float32)
        want, jk, jv = JL.gqa_decode(jp, jcfg, jnp.asarray(x), jk, jv, pos, window=8)
        got, tk2, _ = TL.gqa_decode(p, cfg, torch.from_numpy(x), tk, tv, pos, window=8)
        assert tk2 is tk  # written in place
        _close(got, want, 1e-5)
        _close(tk, jk, 1e-5)


def test_init_draws_seeded_truncated_normals():
    cfg = reduced_config("deepseek-67b").replace(dtype="float32")
    a = transformer.init(0, cfg, device="cpu")
    b = transformer.init(0, cfg, device="cpu")
    c = transformer.init(1, cfg, device="cpu")
    wq = a.layers[0].attn.wq
    assert wq.shape == (cfg.d_model, 4 * 16) and wq.dtype == torch.float32
    assert torch.equal(wq, b.layers[0].attn.wq) and not torch.equal(wq, c.layers[0].attn.wq)
    std = 1.0 / np.sqrt(cfg.d_model)
    assert float(wq.abs().max()) <= 2 * std and abs(float(wq.std()) / std - 0.88) < 0.1
    emb = a.embed.embed  # fan-in is its last axis
    assert float(emb.abs().max()) <= 2 / np.sqrt(cfg.d_model)
    assert bool((a.final_norm == 1).all()) and len(a.layers) == cfg.num_layers
    bf = transformer.init(0, reduced_config("deepseek-67b"), device="cpu")
    assert bf.layers[0].mlp.wg.dtype == torch.bfloat16 and bf.layers[0].ln1.dtype == torch.float32


def test_registry():
    cfg = reduced_config("deepseek-67b")
    assert get_family(cfg) is transformer
    assert get_family(reduced_config("mamba2-2.7b")) is ssm
    with pytest.raises(NotImplementedError, match="no family"):
        get_family(cfg.replace(family="speech"))
    a = make_batch(cfg, 2, 10, key=5, device="cpu")["tokens"]
    assert a.shape == (2, 10) and a.dtype == torch.int64
    assert torch.equal(a, make_batch(cfg, 2, 10, key=5, device="cpu")["tokens"])
    assert int(a.max()) < cfg.vocab_size
    assert get_config("deepseek-67b").d_ff == 22016


# ------------------------------------------------------------ the family API
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches(arch, dtype):
    _, cfg, _, model, batch, _, jlogits = _case(arch, dtype)
    logits = transformer.forward(model, cfg, batch)
    assert logits.dtype == torch.float32 and logits.shape == (BATCH, TOTAL, cfg.vocab_size)
    _close(logits, jlogits, TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches(arch, dtype):
    jcfg, cfg, jparams, model, batch, jtokens, _ = _case(arch, dtype)
    logits, cache = transformer.prefill(model, cfg, {"tokens": batch["tokens"][:, :PROMPT]})
    jlg, jcache = jax_get_family(jcfg).prefill(jparams, jcfg, {"tokens": jtokens[:, :PROMPT]})
    _close(logits, jlg, TOL[dtype])
    assert cache["pos"] == PROMPT == int(jcache["pos"])
    _close(cache["k"], jcache["k"], TOL[dtype])
    _close(cache["v"], jcache["v"], TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_jax_forward(arch, dtype):
    """Prefill PROMPT tokens, pad the cache to TOTAL, decode the rest: each
    step's logits against the JAX package's forward at that position."""
    _, cfg, _, model, batch, _, jlogits = _case(arch, dtype)
    tokens = batch["tokens"]
    _, cache = transformer.prefill(model, cfg, {"tokens": tokens[:, :PROMPT]})
    pad = (0, 0, 0, 0, 0, TOTAL - PROMPT)
    cache = {"k": torch.nn.functional.pad(cache["k"], pad),
             "v": torch.nn.functional.pad(cache["v"], pad), "pos": cache["pos"]}
    for t in range(PROMPT, TOTAL):
        logits, cache = transformer.decode_step(model, cfg, cache, tokens[:, t])
        assert cache["pos"] == t + 1
        _close(logits, jlogits[:, t], TOL[dtype])


def test_every_branch_of_the_block_matches():
    """qk_norm, gemma scaling (embedding scale and (1 + w) norms), tied
    embeddings and the tanh GELU, through forward and prefill plus decode."""
    attn = dataclasses.replace(reduced_config("deepseek-67b").attention, qk_norm=True)
    changes = dict(gemma_scaling=True, tie_embeddings=True, act="gelu", attention=attn)
    _, cfg, _, model, batch, _, jlogits = _case("deepseek-67b", "float32", **changes)
    assert not hasattr(model.embed, "lm_head") and hasattr(model.layers[0].attn, "q_norm")
    _close(transformer.forward(model, cfg, batch), jlogits, TOL["float32"])
    _, cache = transformer.prefill(model, cfg, {"tokens": batch["tokens"][:, :PROMPT]})
    pad = (0, 0, 0, 0, 0, 1)
    cache = {"k": torch.nn.functional.pad(cache["k"], pad),
             "v": torch.nn.functional.pad(cache["v"], pad), "pos": cache["pos"]}
    logits, _ = transformer.decode_step(model, cfg, cache, batch["tokens"][:, PROMPT])
    _close(logits, jlogits[:, PROMPT], TOL["float32"])
