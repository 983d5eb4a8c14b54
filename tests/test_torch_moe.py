"""The port's MoE (qwen3-moe, deepseek-v2-lite with MLA) and VLM
(paligemma) families against the JAX package's on the CPU, at their reduced
configs: the same weights (drawn by ``jax.random`` and carried across by
``interop.moe_params`` / ``interop.vlm_params``) and the same numpy-seeded
tokens and patches go through both.

Tolerances: f32 at atol = rtol = 1e-5; bf16 at 5e-2 (forward, prefill) and
8e-2 (decode), the bounds tests/test_models_consistency.py holds the JAX
package's own serving path to.  Decode is compared with capacity factor 16,
as that test does: a batched forward may drop assignments at an expert's
capacity where one-token decode never does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import mla as JMLA
from repro.models import moe as JM
from repro.models.registry import get_family as jax_get_family

from repro_torch import interop
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import mla as TMLA
from repro_torch.models import moe as TM
from repro_torch.models import encdec, rglru, transformer, vlm
from repro_torch.models.registry import get_family, make_batch
from _one_thread import one_thread  # noqa: F401

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
DECODE_TOL = {"float32": 1e-5, "bfloat16": 8e-2}
ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "paligemma-3b")
TOTAL, NEW, BATCH = 36, 8, 2  # processed positions, decoded tokens, requests


def _np(x):
    return np.asarray(x.to(torch.float32) if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _lifted(cfg):
    """``cfg`` with capacity factor 16: no assignment drops."""
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))


def _jax_batch(batch):
    out = {"tokens": jnp.asarray(batch["tokens"].numpy(), jnp.int32)}
    if "patches" in batch:
        out["patches"] = jnp.asarray(_np(batch["patches"])).astype(jnp.bfloat16)
    return out


# ------------------------------------------------------------ router pinning
# In bf16 the two packages' hidden states differ by bf16 rounding, which can
# flip a router's top-k where two experts' probabilities nearly tie (and a
# flip moves other assignments past an expert's capacity).  So the bf16
# family checks pin the port's routing to the reference's, layer by layer,
# and hold every routing the port would have chosen itself to the
# reference's up to such near ties (in f32 it must be equal).
ROUTER_TIE_TOL = 2.0 ** -5  # relative gap of two probabilities that tie


def _record_reference_routes(run):
    """``run()`` (a JAX package call) with every ``moe_apply`` recording its
    top-k experts (N, k), in call order (layer by layer)."""
    routes = []
    real = JM.moe_apply

    def spy(p, cfg, x):
        probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ p["router"],
                               axis=-1)
        jax.debug.callback(lambda e: routes.append(np.asarray(e)),
                           jax.lax.top_k(probs, cfg.moe.top_k)[1], ordered=True)
        return real(p, cfg, x)

    JM.moe_apply = spy
    try:
        out = run()
        jax.effects_barrier()
    finally:
        JM.moe_apply = real
    return out, routes


class _Pinned:
    """Context in which the port's ``moe.route`` returns the reference's
    experts (``take(call)`` gives call i's (N, k) expert ids), weighted by
    the port's own probabilities, and counts the tokens whose own top-k set
    differs (each must be a near tie)."""

    def __init__(self, take, dtype):
        self.take, self.dtype, self.calls, self.flips = take, dtype, 0, 0

    def __enter__(self):
        self.real = TM.route

        def pinned(p, cfg, xt):
            probs, _, own = self.real(p, cfg, xt)
            want = torch.tensor(np.asarray(self.take(self.calls)), dtype=own.dtype)
            self.calls += 1
            assert want.shape == own.shape
            differ = (own.sort(1).values != want.sort(1).values).any(1)
            if differ.any():
                kth = probs.gather(1, own)[differ, -1]
                worst = probs.gather(1, want)[differ].min(1).values
                gap = ((kth - worst) / kth).max()
                assert gap <= ROUTER_TIE_TOL, f"a top-k differs by {float(gap)}: not a tie"
                self.flips += int(differ.sum())
            top_p = probs.gather(1, want)
            return probs, top_p / top_p.sum(dim=-1, keepdim=True), want

        TM.route = pinned
        return self

    def __exit__(self, *exc):
        TM.route = self.real
        if exc[0] is None and self.dtype == "float32":
            assert self.flips == 0, "f32 routing differs from the reference's"


_PARAMS = {}


def _jax_params(arch, dtype):
    """The JAX package's init at seed 3 (drawn once per arch in f32; the
    bf16 config's init is the same draw cast to its dtypes)."""
    if arch not in _PARAMS:
        jcfg = jax_reduced_config(arch).replace(remat=False, dtype="float32")
        fam = jax_get_family(jcfg)
        _PARAMS[arch] = jax.jit(lambda k: fam.init(k, jcfg))(jax.random.PRNGKey(3))
    params = _PARAMS[arch]
    if dtype == "float32":
        return params
    jcfg = jax_reduced_config(arch).replace(remat=False, dtype=dtype)
    want = jax.eval_shape(lambda k: jax_get_family(jcfg).init(k, jcfg), jax.random.PRNGKey(3))
    return jax.tree.map(lambda a, s: a.astype(s.dtype), params, want)


_CASES = {}


def _case(arch, dtype, lifted=False):
    """(jcfg, cfg, jax params, port model, port batch, jax batch, jax
    forward logits, the reference forward's routes a MoE layer), built once
    per module."""
    jcfg = jax_reduced_config(arch).replace(remat=False, dtype=dtype)
    cfg = reduced_config(arch).replace(remat=False, dtype=dtype)
    lifted = lifted and cfg.moe is not None
    if lifted:
        jcfg, cfg = _lifted(jcfg), _lifted(cfg)
    key = (arch, dtype, lifted)
    if key not in _CASES:
        jparams = _jax_params(arch, dtype)
        convert = interop.vlm_params if cfg.family == "vlm" else interop.moe_params
        model = convert(jparams, cfg, device="cpu")
        batch = make_batch(cfg, BATCH, TOTAL, key=1, device="cpu")
        jbatch = _jax_batch(batch)
        jlogits, routes = _record_reference_routes(
            lambda: jax_get_family(jcfg).forward(jparams, jcfg, jbatch))
        _CASES[key] = (jcfg, cfg, jparams, model, batch, jbatch, np.asarray(jlogits), routes)
    return _CASES[key]


def _prompt(batch, n_tokens):
    return {k: (v[:, :n_tokens] if k == "tokens" else v) for k, v in batch.items()}


def _pad_cache(cache, new: int):
    """Every (L, B, T, ...) entry padded by ``new`` slots along T."""
    return {k: v if k == "pos" else torch.nn.functional.pad(v, (0, 0) * (v.dim() - 3)
                                                            + (0, new))
            for k, v in cache.items()}


# ------------------------------------------------------------ the family API
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches(arch, dtype):
    _, cfg, _, model, batch, _, jlogits, routes = _case(arch, dtype)
    with _Pinned(lambda i: routes[i], dtype) as pin:
        logits = get_family(cfg).forward(model, cfg, batch)
    assert pin.calls == len(routes)
    n_text = batch["tokens"].shape[1]
    assert logits.dtype == torch.float32 and logits.shape == (BATCH, n_text, cfg.vocab_size)
    _close(logits, jlogits, TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches(arch, dtype):
    jcfg, cfg, jparams, model, batch, jbatch, _, _ = _case(arch, dtype)
    n = batch["tokens"].shape[1] - NEW
    (jlg, jcache), routes = _record_reference_routes(
        lambda: jax_get_family(jcfg).prefill(jparams, jcfg, _prompt(jbatch, n)))
    with _Pinned(lambda i: routes[i], dtype) as pin:
        logits, cache = get_family(cfg).prefill(model, cfg, _prompt(batch, n))
    assert pin.calls == len(routes)
    _close(logits, jlg, TOL[dtype])
    assert cache["pos"] == int(jcache["pos"]) == TOTAL - NEW
    assert cache.keys() == jcache.keys()
    for k in cache:
        if k != "pos":
            _close(cache[k], jcache[k], TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_jax_forward(arch, dtype):
    """Prefill, pad the cache, decode NEW tokens: each step's logits against
    the JAX package's forward at that position (capacity factor 16; the
    routing pinned to the forward's at the same positions)."""
    _, cfg, _, model, batch, _, jlogits, routes = _case(arch, dtype, lifted=True)
    fam = get_family(cfg)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    n = S - NEW
    by_pos = [r.reshape(BATCH, S, -1) for r in routes]
    n_moe = len(routes)

    def take(call):  # the prefill's calls, then n_moe a decode step
        layer, step = call % n_moe if n_moe else 0, call // n_moe if n_moe else 0
        return by_pos[layer][:, :n].reshape(-1, by_pos[layer].shape[-1]) if step == 0 else \
            by_pos[layer][:, n + step - 1]

    with _Pinned(take, dtype) as pin:
        _, cache = fam.prefill(model, cfg, _prompt(batch, n))
        cache = _pad_cache(cache, NEW)
        for t in range(n, S):
            logits, cache = fam.decode_step(model, cfg, cache, tokens[:, t])
            assert cache["pos"] == TOTAL - S + t + 1
            _close(logits, jlogits[:, t], DECODE_TOL[dtype])
    assert pin.calls == n_moe * (NEW + 1)


# ------------------------------------------------------------ expert dispatch
def _experts(arch, dtype, seed=0, **moe_changes):
    jcfg = jax_reduced_config(arch).replace(dtype=dtype)
    cfg = reduced_config(arch).replace(dtype=dtype)
    if moe_changes:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_changes))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_changes))
    jp = jax.jit(lambda k: JM.init_experts(k, jcfg))(jax.random.PRNGKey(seed))
    p = TM.Experts(cfg, device="cpu")
    with torch.no_grad():
        for name, param in p.named_parameters():
            src = jp
            for part in name.split("."):
                src = src[part]
            param.copy_(interop._tensor_as_is(src, torch.device("cpu")))
    return jcfg, cfg, jp, p


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_drops_as_the_reference_does(arch, dtype):
    """Capacity factor 0.5: half the assignments cannot fit, and the same
    ones drop in both packages (the stable sort); outputs and aux agree."""
    jcfg, cfg, jp, p = _experts(arch, dtype, capacity_factor=0.5)
    x = np.random.RandomState(2).randn(2, 40, cfg.d_model).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    out, aux = TM.moe_apply(p, cfg, xt)
    jout, jaux = jax.jit(lambda p_, x_: JM.moe_apply(p_, jcfg, x_))(
        jp, jnp.asarray(x).astype(getattr(jnp, dtype)))
    _, _, top_e = TM.route(p, cfg, xt.reshape(-1, cfg.d_model))
    C, _, dest = TM.dispatch(top_e, cfg, 80)
    assert C == TM.moe_capacity(cfg, 80) == JM.moe_capacity(jcfg, 80) == 16
    assert int((dest == cfg.moe.num_experts * C).sum()) > 0  # something dropped
    assert out.dtype == xt.dtype and out.shape == xt.shape
    _close(out, jout, TOL[dtype])
    _close(aux, jaux, 1e-6)


@pytest.mark.parametrize("tie", ["all_equal", "boundary"])
def test_router_ties_break_to_the_lower_expert(tie):
    """Equal router columns give equal probabilities: top-k keeps the lower
    expert, as ``lax.top_k`` does, and the outputs agree."""
    jcfg, cfg, jp, p = _experts("qwen3-moe-30b-a3b", "float32")
    router = np.array(jp["router"])
    if tie == "all_equal":
        router[:] = router[:, :1]
    else:
        router[:, 5] = router[:, 3]
        router[:, 6] = router[:, 3]
    jp = {**jp, "router": jnp.asarray(router)}
    with torch.no_grad():
        p.router.copy_(torch.from_numpy(router))
    x = np.random.RandomState(4).randn(1, 64, cfg.d_model).astype(np.float32)
    xt = torch.from_numpy(x)
    _, top_p, top_e = TM.route(p, cfg, xt[0])
    probs = jax.nn.softmax(jnp.asarray(x[0]) @ jp["router"], axis=-1)
    _, jtop_e = jax.lax.top_k(probs, cfg.moe.top_k)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop_e))
    if tie == "all_equal":
        assert (top_e.numpy() == [0, 1]).all()
    else:
        tied = top_e.numpy()
        assert ((tied == 3) | (tied == 5) | (tied == 6)).any()
    out, aux = TM.moe_apply(p, cfg, xt)
    jout, jaux = jax.jit(lambda p_, x_: JM.moe_apply(p_, jcfg, x_))(jp, jnp.asarray(x))
    _close(out, jout, TOL["float32"])
    _close(aux, jaux, 1e-6)


# ------------------------------------------------------------------ MLA
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_absorbed_decode_matches_naive_and_reference(dtype):
    """Token-by-token absorbed decode against the naive form (the port's
    and the JAX package's, 2e-3 as its own test in f32), and each decode
    step against the JAX package's."""
    jcfg = jax_reduced_config("deepseek-v2-lite-16b").replace(dtype=dtype)
    cfg = reduced_config("deepseek-v2-lite-16b").replace(dtype=dtype)
    a = cfg.attention
    jp = jax.jit(lambda k: JMLA.init_mla(k, jcfg))(jax.random.PRNGKey(5))
    p = TMLA.MLA(cfg, device="cpu")
    with torch.no_grad():
        for name, param in p.named_parameters():
            param.copy_(interop._tensor_as_is(jp[name], torch.device("cpu")))
    B, S = 2, 12
    x = (0.5 * np.random.RandomState(6).randn(B, S, cfg.d_model)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt, xj = torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    naive = TMLA.mla_attend(p, cfg, xt, pos)
    jnaive = jax.jit(lambda x_, pos_: JMLA.mla_attend(jp, jcfg, x_, pos_))
    _close(naive, jnaive(xj, jnp.asarray(pos.numpy())), TOL[dtype])
    ckv = torch.zeros((B, S, a.kv_lora_rank), dtype=tdt)
    krope = torch.zeros((B, S, a.qk_rope_head_dim), dtype=tdt)
    jckv, jkrope = jnp.zeros(ckv.shape, jdt), jnp.zeros(krope.shape, jdt)
    jdecode = jax.jit(lambda x1, c, k, t: JMLA.mla_decode(jp, jcfg, x1, c, k, t))
    outs = []
    for t in range(S):
        o, ckv2, _ = TMLA.mla_decode(p, cfg, xt[:, t:t + 1], ckv, krope, t)
        assert ckv2 is ckv  # written in place
        jo, jckv, jkrope = jdecode(xj[:, t:t + 1], jckv, jkrope, t)
        _close(o, jo, DECODE_TOL[dtype])
        outs.append(o)
    _close(ckv, jckv, TOL[dtype])
    _close(torch.cat(outs, dim=1), naive, 2e-3 if dtype == "float32" else DECODE_TOL[dtype])


# ------------------------------------------------------------ registry, init
def test_registry_and_batches():
    assert get_family(reduced_config("qwen3-moe-30b-a3b")) is TM
    assert get_family(reduced_config("deepseek-v2-lite-16b")) is TM
    assert get_family(reduced_config("paligemma-3b")) is vlm
    assert vlm.init is transformer.init and vlm.decode_step is transformer.decode_step
    assert get_family(reduced_config("recurrentgemma-2b")) is rglru
    assert get_family(reduced_config("seamless-m4t-medium")) is encdec
    cfg = reduced_config("paligemma-3b")
    b = make_batch(cfg, 2, 20, key=5, device="cpu")
    P = cfg.encoder.num_prefix
    assert b["tokens"].shape == (2, 20 - P) and b["patches"].shape == (2, P, cfg.d_model)
    assert b["patches"].dtype == torch.bfloat16
    again = make_batch(cfg, 2, 20, key=5, device="cpu")
    assert torch.equal(b["patches"], again["patches"]) and torch.equal(b["tokens"],
                                                                         again["tokens"])
    dense = make_batch(reduced_config("qwen3-moe-30b-a3b"), 2, 20, key=5, device="cpu")
    assert dense.keys() == {"tokens", "labels"} and dense["tokens"].shape == (2, 20)


def test_init_draws_every_weight_at_published_shapes():
    """Seeded init of both MoE layouts: dense first layer and shared experts
    for deepseek-v2-lite, none for qwen3; every weight drawn, the same seed
    the same weights.  The published widths are the configs' own."""
    for arch in ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"):
        cfg = reduced_config(arch).replace(dtype="float32")
        a, b = TM.init(0, cfg, device="cpu"), TM.init(0, cfg, device="cpu")
        assert len(a.dense_layers) == cfg.moe.first_dense
        assert len(a.layers) == cfg.num_layers - cfg.moe.first_dense
        e = a.layers[0].experts
        m = cfg.moe
        assert e.wg.shape == (m.num_experts, cfg.d_model, m.expert_ff)
        assert hasattr(e, "shared") == bool(m.num_shared)
        for (name, w), w2 in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(w, w2), name
            if w.dim() >= 2:
                assert float(w.abs().max()) > 0, name
    q = get_config("qwen3-moe-30b-a3b")
    assert (q.d_model, q.attention.num_heads, q.attention.num_kv_heads, q.attention.head_dim,
            q.moe.num_experts, q.moe.top_k, q.moe.expert_ff) == (2048, 32, 4, 128, 128, 8, 768)
    d = get_config("deepseek-v2-lite-16b").attention
    assert d.qk_nope_head_dim + d.qk_rope_head_dim != d.v_head_dim  # MLA stays off the kernel
