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

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
CASES = [  # (B, Sq, Sk, H, K, D)
    (2, 64, 64, 4, 2, 16), (1, 128, 128, 4, 2, 64), (1, 64, 64, 4, 2, 128), (1, 64, 64, 4, 2, 256),
    (2, 64, 64, 4, 1, 16), (1, 96, 96, 4, 1, 64), (1, 128, 128, 4, 1, 128), (1, 64, 64, 4, 1, 256),
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small products: one torch thread is fastest, and keeps the
    module fast when other test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    ("meta device", lambda q, k, v, o, g: tuple(t.to("meta") for t in (q, k, v, o, g))),
])
def test_backward_rejects_what_the_kernel_cannot_take(what, change):
    q, k, v, g = (torch.from_numpy(x) for x in _inputs((1, 32, 32, 2, 1, 16), seed=4))
    args = change(q, k, v, flash_attention_plain(q, k, v), g)
    with pytest.raises(ValueError):
        flash_attention_backward(*args)
