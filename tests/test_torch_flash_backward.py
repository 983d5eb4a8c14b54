"""The gradient of the port's ``flash_attention`` on the CPU: its autograd
Function (forward ``flash_attention_plain``, backward
``flash_attention_backward_plain``, the formulas the card's backward kernel
runs) against ``jax.grad`` of the JAX package's ``repro.models.layers.mha``
(its einsum route, which the JAX package trains through: it has no
backward kernel), on the same numpy-seeded q, k, v and output gradient.

Tolerances: 1e-5 in f32 (atol = rtol; both sum in f32 in different
orders), 3e-2 in bf16 (the JAX route rounds the probabilities and its
products to bf16 at other places than the port, which computes in f32 and
rounds each gradient once).  On the CPU no kernel is launched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import (FlashAttention, flash_attention,
                                                 flash_attention_backward,
                                                 flash_attention_backward_plain,
                                                 flash_attention_plain)
from repro_torch.models import layers as TL
from _one_thread import one_thread  # noqa: F401

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
CASES = [  # (B, Sq, Sk, H, K, D)
    (2, 64, 64, 4, 2, 16), (1, 128, 128, 4, 2, 64), (1, 64, 64, 4, 2, 128), (1, 64, 64, 4, 2, 256),
    (2, 64, 64, 4, 1, 16), (1, 96, 96, 4, 1, 64), (1, 128, 128, 4, 1, 128), (1, 64, 64, 4, 1, 256),
]


@pytest.fixture(scope="module", autouse=True)
def quick_compiles():
    """XLA's cheaper compile pipeline for this module's one-off programs
    (restored afterwards): compiling, not running, is their cost here."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", was)


def _inputs(shape, seed):
    B, Sq, Sk, H, K, D = shape
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D), (B, Sq, H, D))]


def _mha_loss(q, k, v, g, causal):
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    qpos = jnp.broadcast_to(jnp.arange(Sq)[None], (B, Sq))
    kpos = jnp.broadcast_to(jnp.arange(Sk)[None], (B, Sk))
    o = JL.mha(q, k, v, causal=causal, q_positions=qpos, kv_positions=kpos)
    return jnp.sum(o.astype(jnp.float32) * g)


_mha_grads = jax.jit(jax.grad(_mha_loss, argnums=(0, 1, 2)), static_argnames="causal")


def _jax_grads(q, k, v, g, causal, dtype):
    args = [jnp.asarray(x).astype(jnp.dtype(dtype)) for x in (q, k, v)]
    return [np.asarray(x.astype(jnp.float32))
            for x in _mha_grads(*args, jnp.asarray(g), causal=causal)]


def _port_grads(q, k, v, g, causal, dtype):
    dt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(dt).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal)
    (out.float() * torch.from_numpy(g)).sum().backward()
    return out, [t.grad for t in (tq, tk, tv)]


@pytest.mark.parametrize("shape", CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_jax_grad_of_mha(shape, causal, dtype):
    q, k, v, g = _inputs(shape, seed=sum(shape) + causal)
    fa.reset_launches()
    out, grads = _port_grads(q, k, v, g, causal, dtype)
    assert fa.flash_attention.launches == 0 and fa.flash_attention.backward_launches == 0
    want = _jax_grads(q, k, v, g, causal, dtype)
    for name, got, ref in zip("qkv", grads, want):
        assert got.dtype == getattr(torch, dtype) and got.shape == ref.shape
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=f"d{name}")
    # the Function's forward is the plain route's output, bit for bit
    dt = getattr(torch, dtype)
    plain = flash_attention_plain(*(torch.from_numpy(x).to(dt) for x in (q, k, v)), causal=causal)
    assert torch.equal(out.detach(), plain)


@pytest.mark.parametrize("causal", [True, False])
def test_unequal_lengths_match_jax_grad(causal):
    """Sq != Sk, positions aligned at 0 on both sides (as the kernel takes
    them)."""
    q, k, v, g = _inputs((1, 48, 80, 4, 2, 32), seed=5)
    _, grads = _port_grads(q, k, v, g, causal, "float32")
    for got, ref in zip(grads, _jax_grads(q, k, v, g, causal, "float32")):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_cpu_backward_is_the_plain_formulas():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs((1, 64, 64, 4, 2, 64), seed=1))
    out = flash_attention_plain(q, k, v)
    fa.reset_launches()
    got = flash_attention_backward(q, k, v, out, g)
    want = flash_attention_backward_plain(q, k, v, out, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fa.flash_attention.backward_launches == 0


def test_function_is_taken_only_when_a_gradient_is_needed():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs((1, 32, 32, 2, 1, 16), seed=2))
    assert flash_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        assert flash_attention(q, k.requires_grad_(), v).grad_fn is None
    out = flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert issubclass(FlashAttention, torch.autograd.Function)


def test_remat_gives_the_same_gradients():
    """The layer recomputed in the backward (``layers.remat``, as under
    ``cfg.remat``) gives the same gradients as the kept activations."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs((1, 64, 64, 4, 2, 32), seed=3))

    def grads(remat: bool):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        cfg = type("C", (), {"remat": remat})()
        out = TL.remat(cfg, lambda a, b, c: flash_attention(a, b, c) * 2.0, *leaves)
        (out * g).sum().backward()
        return [t.grad for t in leaves]

    assert all(torch.equal(a, b) for a, b in zip(grads(False), grads(True)))


@pytest.mark.parametrize("what,change", [
    ("dout shape", lambda q, k, v, o, g: (q, k, v, o, g[:, :-1].contiguous())),
    ("out type", lambda q, k, v, o, g: (q, k, v, o.double(), g)),
    ("dout layout", lambda q, k, v, o, g: (q, k, v, o, g.transpose(1, 2).contiguous().transpose(1, 2))),
    # a device other than q's: "meta" alone is the dry run's (next test)
    ("meta device", lambda q, k, v, o, g: (q, k, v, o, g.to("meta"))),
])
def test_backward_rejects_what_the_kernel_cannot_take(what, change):
    q, k, v, g = (torch.from_numpy(x) for x in _inputs((1, 32, 32, 2, 1, 16), seed=4))
    args = change(q, k, v, flash_attention_plain(q, k, v), g)
    with pytest.raises(ValueError):
        flash_attention_backward(*args)


def test_backward_on_meta_gives_the_shapes_and_runs_nothing():
    """On "meta" (the dry run) the backward returns gradients of the
    operands' shapes and types, launches nothing, runs no plain formula, and
    reports its work to an observer (``kernels/_mesh.py``)."""
    from unittest import mock

    from repro_torch.kernels import _mesh
    from repro_torch.kernels import flash_attention as fm

    q, k, v, g = (torch.from_numpy(x).to("meta") for x in _inputs((1, 32, 32, 2, 1, 16), seed=4))
    seen = []
    fm.reset_launches()
    with mock.patch.object(fm, "flash_attention_backward_plain", side_effect=AssertionError), \
            _mesh.observe(lambda *a: seen.append(a)):
        grads = flash_attention_backward(q, k, v, q, g)
    assert [(t.device.type, t.shape, t.dtype) for t in grads] == \
        [(t.device.type, t.shape, t.dtype) for t in (q, k, v)]
    assert fm.flash_attention.backward_launches == 0
    assert seen and seen[0][0] == "flash_attention_backward" and seen[0][1] > 0


# ---------------------------------------------------------------- the lse
@pytest.mark.parametrize("shape", CASES[:4] + [(1, 48, 80, 4, 2, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_lse_is_the_logsumexp_of_the_scaled_scores(shape, causal):
    """``flash_attention_plain(..., return_lse=True)``'s lse (the one
    convention: natural log of the scaled scores over the unmasked keys)
    against ``jax.nn.logsumexp`` of the JAX package's scaled einsum scores,
    and the same output as without it."""
    q, k, v, _ = _inputs(shape, seed=sum(shape) + 2 * causal)
    B, Sq, Sk, H, K, D = shape
    scores = jnp.einsum("bskgh,btkh->bkgst", jnp.asarray(q).reshape(B, Sq, K, H // K, D),
                        jnp.asarray(k)) / np.sqrt(D)
    if causal:
        keep = np.arange(Sq)[:, None] >= np.arange(Sk)[None, :]
        scores = jnp.where(keep, scores, -jnp.inf)
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1)).reshape(B, H, Sq)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_attention_plain(tq, tk, tv, causal=causal, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)
    assert torch.equal(out, flash_attention_plain(tq, tk, tv, causal=causal))
    got_out, got_lse = flash_attention(tq, tk, tv, causal=causal, return_lse=True)
    assert torch.equal(got_out, out) and torch.equal(got_lse, lse)


# ------------------------------------------- the tensor-core route's arithmetic
def _tc_backward_emulation(q, k, v, out, dout, lse, causal, scale=None,
                           operand=torch.bfloat16):
    """The backward's tensor-core route (csrc/flash_attention_bwd.cu,
    ``tc::``) as arithmetic on the CPU: bf16 operands, f32 sums of their
    exact products, P = exp2(S c - lse log2 e) from the forward's lse,
    Di = rowsum(dO * O), dS = P (dP - Di), P and dS rounded to bf16 as the
    A operands of dV = P^T dO, dK = dS^T Q and dQ = dS K, the scale applied
    to the f32 dK and dQ last.  ``operand``: the type P and dS are rounded
    to (f32: none)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    f32 = torch.float32
    log2e = torch.tensor(1.4426950408889634, dtype=f32)
    c = torch.tensor(scale, dtype=f32) * log2e
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    keep = torch.arange(Sq)[:, None] >= torch.arange(Sk)[None, :]
    for b in range(B):
        for kh in range(K):
            heads = slice(kh * G, (kh + 1) * G)
            qf = q[b, :, heads].to(f32).permute(1, 0, 2)  # (G, Sq, D)
            gf = dout[b, :, heads].to(f32).permute(1, 0, 2)
            of = out[b, :, heads].to(f32).permute(1, 0, 2)
            kf, vf = k[b, :, kh].to(f32), v[b, :, kh].to(f32)
            lse2 = lse[b, heads].to(f32) * log2e  # (G, Sq)
            p = torch.exp2(qf @ kf.T * c - lse2[..., None])
            if causal:
                p = p.masked_fill(~keep, 0.0)
            di = (gf * of).sum(dim=-1, keepdim=True)
            ds = p * (gf @ vf.T - di)
            pb, dsb = p.to(operand).to(f32), ds.to(operand).to(f32)
            dv[b, :, kh] = torch.einsum("gqs,gqd->sd", pb, gf).to(v.dtype)
            dk[b, :, kh] = (torch.einsum("gqs,gqd->sd", dsb, qf) * scale).to(k.dtype)
            dq[b, :, heads] = ((dsb @ kf) * scale).permute(1, 0, 2).to(q.dtype)
    return dq, dk, dv


def _limit_ratio(got, ref, tol):
    """The largest |got - ref| / (tol + tol |ref|): at most 1 is within
    ``assert_allclose(rtol=tol, atol=tol)``."""
    return float(np.max(np.abs(got - ref) / (tol + tol * np.abs(ref))))


@pytest.mark.parametrize("shape", CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_arithmetic_matches_jax_grad_of_mha(shape, causal):
    """The tensor-core route's rounding (P and dS to bf16 as operands, the
    scale last, the forward's lse) held to ``jax.grad`` of ``layers.mha``
    in bf16 within the bf16 limit, as the plain formulas are."""
    q, k, v, g = _inputs(shape, seed=sum(shape) + causal)
    bf16 = torch.bfloat16
    tq, tk, tv = (torch.from_numpy(x).to(bf16) for x in (q, k, v))
    out, lse = flash_attention_plain(tq, tk, tv, causal=causal, return_lse=True)
    got = _tc_backward_emulation(tq, tk, tv, out, torch.from_numpy(g).to(bf16), lse, causal)
    want = _jax_grads(q, k, v, g.astype(jnp.bfloat16).astype(np.float32), causal, "bfloat16")
    for name, a, ref in zip("qkv", got, want):
        ratio = _limit_ratio(a.float().numpy(), ref, TOL["bfloat16"])
        assert ratio <= 1.0, f"d{name}: {ratio} of the bf16 limit"


NEW_TC_SHAPES = {"reduced": (2, 256, 256, 4, 2, 16), "d32": (1, 128, 128, 4, 4, 32)}


@pytest.mark.parametrize("kind", list(NEW_TC_SHAPES))
@pytest.mark.parametrize("route", ["bf16", "split_f32"])
def test_d16_and_d32_arithmetic_matches_jax_grad_of_mha(kind, route):
    """The head dims the tensor cores took over from the CUDA cores (the
    restart check's reduced (2, 256, 256, 4, 2, 16) and D 32 at (1, 128,
    128, 4, 4, 32)), causal: the bf16 route's rounding within the bf16
    limit of ``jax.grad`` of ``layers.mha``, the split route's arithmetic
    within the f32 limit, as at every other head dim."""
    shape = NEW_TC_SHAPES[kind]
    if route == "split_f32":
        ratios = _split_ratio(shape, True)
        assert max(ratios) <= 1.0, f"(dq, dk, dv): {ratios} of the f32 limit"
        return
    q, k, v, g = _inputs(shape, seed=sum(shape))
    bf16 = torch.bfloat16
    tq, tk, tv = (torch.from_numpy(x).to(bf16) for x in (q, k, v))
    out, lse = flash_attention_plain(tq, tk, tv, causal=True, return_lse=True)
    got = _tc_backward_emulation(tq, tk, tv, out, torch.from_numpy(g).to(bf16), lse, True)
    want = _jax_grads(q, k, v, g.astype(jnp.bfloat16).astype(np.float32), True, "bfloat16")
    for name, a, ref in zip("qkv", got, want):
        ratio = _limit_ratio(a.float().numpy(), ref, TOL["bfloat16"])
        assert ratio <= 1.0, f"d{name}: {ratio} of the bf16 limit"


def test_tensor_core_emulation_is_the_plain_formulas_up_to_its_rounding():
    """In f32 operands and without the bf16 rounding of P and dS, the
    emulation's arithmetic is the plain backward's: a fault in the
    emulation itself (a wrong lse, a dropped Di) would show here."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs((1, 64, 64, 4, 2, 32), seed=6))
    out, lse = flash_attention_plain(q, k, v, return_lse=True)
    want = flash_attention_backward_plain(q, k, v, out, g)
    got = _tc_backward_emulation(q, k, v, out, g, lse, True, operand=torch.float32)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


# ------------------------------------------------ the split route's arithmetic
# The f32 route's six products of pieces (0 hi, 1 mid, 2 lo) of A and B, in
# the kernels' order (smallest first); mid.lo, lo.mid and lo.lo drop.
SPLIT_TERMS = ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0))
PIECE = ("hi", "mid", "lo")


def _split_mm(pa, pb, drop=None, chunk=None):
    """a @ b from the pieces of a and b (f32-widened bf16 hi, mid, lo) as
    six products of pieces summed in f32 smallest first, less the one term
    ``drop`` names ("hi.mid", ...); with ``chunk``, chunk by chunk of that
    many columns of a (rows of b), each chunk's six products added to one
    sum in turn."""
    out = torch.zeros((*pa[0].shape[:-1], pb[0].shape[-1]))
    inner = pa[0].shape[-1]
    step = chunk or inner
    for c0 in range(0, inner, step):
        for i, j in SPLIT_TERMS:
            if drop != f"{PIECE[i]}.{PIECE[j]}":
                out = out + pa[i][..., c0:c0 + step] @ pb[j][..., c0:c0 + step, :]
    return out


def _split(t):
    return [x.float() for x in fa.split_bf16_plain(t.contiguous())]


def _split_backward_emulation(q, k, v, out, dout, lse, causal, drop=None):
    """The backward's split route (csrc/flash_attention_bwd.cu,
    ``tc::dkdv_split`` and ``tc::dq_split``) as arithmetic on the CPU: q, k,
    v and dO as three bf16 pieces (``split_bf16_plain``), P and dS split the
    same way, every product six products of pieces smallest first, P =
    exp2(S c - lse log2 e) from the forward's lse, Di = rowsum(dO * O), each
    stage's dV, dK (q stages of 32 rows at D >= 128, else 64, head by head)
    or dQ (KV tiles of as many rows, alternate tiles summed apart and added
    at the end) summed apart and added to the running sum in f32, the scale
    applied to dK and dQ last.  At D 256 (``tc::dkdv_split_wide``,
    ``tc::dq_split_wide``) the scores S, S^T, dP and dP^T are summed over the
    head dim in 64-column chunks, each chunk's six products added to the
    running scores in turn (a dQ stage's 64 keys are two 32-row tiles, one
    a consumer: the alternate tiles above).  Its sums round to nearest; the
    tensor cores' truncation only the card shows.  ``drop``: "S:hi.mid" leaves that term
    out of a product (S, dP, dV, dK or dQ), "q:mid" the mid piece of an
    operand (q, k, v or dout)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G, rows = H // K, 32 if D >= 128 else 64
    chunk = 64 if D >= 256 else None  # the head-dim chunks the scores are summed in
    scale = 1.0 / np.sqrt(D)
    f32 = torch.float32
    log2e = torch.tensor(1.4426950408889634, dtype=f32)
    c = torch.tensor(scale, dtype=f32) * log2e
    term = {}
    if drop and ":" in drop:
        what, name = drop.split(":")
        term[what] = name
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    keep = torch.arange(Sq)[:, None] >= torch.arange(Sk)[None, :]

    def pieces(name, t):
        ps = _split(t)
        if term.get(name) == "mid":
            ps[1] = torch.zeros_like(ps[1])
        return ps

    def t_(ps):
        return [x.transpose(-1, -2) for x in ps]

    for b in range(B):
        for kh in range(K):
            heads = slice(kh * G, (kh + 1) * G)
            qp = pieces("q", q[b, :, heads].permute(1, 0, 2))  # (G, Sq, D)
            gp = pieces("dout", dout[b, :, heads].permute(1, 0, 2))
            kp, vp = pieces("k", k[b, :, kh]), pieces("v", v[b, :, kh])  # (Sk, D)
            of = out[b, :, heads].to(f32).permute(1, 0, 2)
            gf = dout[b, :, heads].to(f32).permute(1, 0, 2)
            lse2 = lse[b, heads] * log2e  # (G, Sq)
            di = (gf * of).sum(dim=-1)  # (G, Sq)

            def probs(s, d, hs, q0, k0):
                """P and dS of the scores s and dP d (heads hs, rows q0..,
                keys k0..)."""
                qs = slice(q0, q0 + s.shape[1])
                p = torch.exp2(s * c - lse2[hs, qs, None])
                if causal:
                    p = p.masked_fill(~keep[qs, k0:k0 + s.shape[2]], 0.0)
                return p, p * (d - di[hs, qs, None])

            # dK / dV: every KV row at once (rows are independent), stage by
            # stage of `rows` q rows, head by head of the group
            acc_k = torch.zeros((Sk, D))
            acc_v = torch.zeros((Sk, D))
            for g in range(G):
                for q0 in range(0, Sq, rows):
                    qs = [x[g, q0:q0 + rows] for x in qp]
                    gs = [x[g, q0:q0 + rows] for x in gp]
                    st = _split_mm(kp, t_(qs), term.get("S"), chunk)  # S^T (Sk, rows)
                    dpt = _split_mm(vp, t_(gs), term.get("dP"), chunk)
                    p, ds = probs(st.T[None], dpt.T[None], slice(g, g + 1), q0, 0)
                    p, ds = p[0].T, ds[0].T  # P^T, dS^T (Sk, rows)
                    acc_v = acc_v + _split_mm(_split(p), gs, term.get("dV"))
                    acc_k = acc_k + _split_mm(_split(ds), qs, term.get("dK"))
            dv[b, :, kh] = acc_v.to(v.dtype)
            dk[b, :, kh] = (acc_k * scale).to(k.dtype)
            # dQ: every q row and head at once, KV tile by tile, alternate
            # tiles summed apart (the two consumers)
            acc = [torch.zeros((G, Sq, D)), torch.zeros((G, Sq, D))]
            for j, k0 in enumerate(range(0, Sk, rows)):
                ks = [x[k0:k0 + rows] for x in kp]
                vs = [x[k0:k0 + rows] for x in vp]
                s = _split_mm(qp, t_(ks), term.get("S"), chunk)  # (G, Sq, rows)
                d = _split_mm(gp, t_(vs), term.get("dP"), chunk)
                _, ds = probs(s, d, slice(None), 0, k0)
                acc[j % 2] = acc[j % 2] + _split_mm(_split(ds), ks, term.get("dQ"))
            dq[b, :, heads] = ((acc[0] + acc[1]) * scale).permute(1, 0, 2).to(q.dtype)
    return dq, dk, dv


def _split_ratio(shape, causal, drop=None):
    """The split emulation's largest error against ``jax.grad`` of
    ``layers.mha`` in f32, as a share of the f32 limit (dq, dk, dv)."""
    q, k, v, g = _inputs(shape, seed=sum(shape) + causal)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = flash_attention_plain(tq, tk, tv, causal=causal, return_lse=True)
    got = _split_backward_emulation(tq, tk, tv, out, tg, lse, causal, drop=drop)
    want = _jax_grads(q, k, v, g, causal, "float32")
    return [_limit_ratio(a.numpy(), ref, TOL["float32"]) for a, ref in zip(got, want)]


@pytest.mark.parametrize("shape", CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_split_arithmetic_matches_jax_grad_of_mha(shape, causal):
    """The split route's arithmetic (three bf16 pieces of every operand, P
    and dS included, six products each, per-stage sums, the scale last, the
    forward's lse) held to ``jax.grad`` of ``layers.mha`` in f32 within the
    f32 limit, as the plain formulas are."""
    ratios = _split_ratio(shape, causal)
    assert max(ratios) <= 1.0, f"(dq, dk, dv): {ratios} of the f32 limit"


@pytest.mark.parametrize("drop", ["S:hi.mid", "dP:mid.hi", "dV:hi.mid", "dK:mid.hi",
                                  "dQ:hi.mid", "q:mid", "k:mid", "v:mid", "dout:mid"])
def test_one_piece_fewer_misses_the_f32_limit(drop):
    """A dropped first-order term (hi.mid or mid.hi) of any of the five
    products, or an operand without its mid piece, moves a gradient past
    the f32 limit: three pieces and all six products are needed."""
    assert max(_split_ratio((1, 128, 128, 4, 1, 128), True, drop=drop)) > 1.0


@pytest.mark.parametrize("drop", ["S:hi.mid", "dP:mid.hi", "dV:hi.mid", "dK:mid.hi",
                                  "dQ:hi.mid", "q:mid", "k:mid", "v:mid", "dout:mid"])
def test_one_piece_fewer_misses_the_f32_limit_at_d256(drop):
    """The same at D 256, in its layout (the scores summed over 64-column
    chunks of the head dim): three pieces and all six products are needed
    there too."""
    assert max(_split_ratio((1, 128, 128, 4, 1, 256), True, drop=drop)) > 1.0


def test_split_emulation_without_rounding_is_the_plain_formulas():
    """On operands that are bf16 values already (exact in their hi piece;
    P and dS within 2^-25 in their three), the emulation is the plain
    backward up to the order of its sums: a fault in the emulation itself
    (a wrong lse, a dropped Di, a stage summed twice) would show here."""
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16).float()
                  for x in _inputs((1, 96, 96, 4, 2, 64), seed=8))
    out, lse = flash_attention_plain(q, k, v, return_lse=True)
    want = flash_attention_backward_plain(q, k, v, out, g)
    got = _split_backward_emulation(q, k, v, out, g, lse, True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- routing
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_route_for_every_head_dim_and_type(D, dtype):
    """bf16 and f32 (split-bf16 operands) at every head dim, D 16 and 32
    included, on the tensor cores: no backward route is left on the CUDA
    cores."""
    assert fa.backward_route(D, dtype) == "tensor_cores"
    assert "cuda_cores" not in fa.ROUTES
    kernels = fa.backward_kernels(D, dtype)
    assert list(kernels) == ["prep", "dkdv", "dq"]
    assert all(kernels[r][0].startswith("tc::") for r in ("dkdv", "dq"))
    split = dtype == torch.float32
    assert all(("split" in kernels[r][0]) == split for r in ("dkdv", "dq"))
    assert ("wgmma" in kernels["dkdv"][0]) == (not split)
    assert kernels["dkdv"][1].endswith(f"ILi{D}E")


def test_cpu_route_launches_nothing():
    """A backward on CPU tensors, through the Function and directly, runs
    the plain formulas: no launch is counted on either route."""
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16) for x in
                  _inputs((1, 64, 64, 4, 2, 64), seed=7))
    fa.reset_launches()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = flash_attention(*leaves, return_lse=True)
    assert not lse.requires_grad
    out.backward(g)
    flash_attention_backward(q, k, v, out.detach(), g, lse)
    assert fa.flash_attention.launches == 0 and fa.flash_attention.backward_launches == 0
    assert fa.flash_attention.backward_route_launches == dict.fromkeys(fa.ROUTES, 0)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_backward(q, k, v, out.detach(), g, lse[:, :-1].contiguous())
