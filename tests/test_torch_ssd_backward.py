"""The gradient of the port's SSD (``ssd_scan.ssd_chunk_backward`` and the
autograd Function ``SSDChunk`` behind ``ssd_chunk`` and ``ops.ssd``)
against autograd and the JAX package on the CPU, where the backward runs
its plain formulas (``ssd_chunk_backward_plain``); the CUDA kernel is held
to those on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``
``ssd_bwd_kernels``).  Inputs are drawn with numpy from a seed.

The chunk level is compared with ``jax.vjp`` of the JAX package's plain
``repro.kernels.ref.ssd_chunk_ref``: ``jax.vjp`` of its interpret-mode
Pallas ``ssd_chunk`` raises ("Linearization failed to produce known values
for all output primals": ``pallas_call`` has no reverse-mode rule), which is
why the JAX package trains through ``ssd_chunked``.

Tolerances, each over the gradient's largest value: the plain formulas
against ``torch.autograd.grad`` of ``ssd_chunk_plain`` at 1e-5 (both f32, the
same products summed in other orders; the largest seen is 3e-7); the chunk
level and ``ops.ssd`` against the JAX package at 1e-5 in f32 and 3e-2 in
bf16 (bf16 x, B, C: the two frameworks round x * dt and the outputs at
other places).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models.ssm import ssd_chunked as jax_ssd_chunked

from repro_torch.kernels import ops, ssd_scan
from repro_torch.kernels.ssd_scan import (SSDChunk, ssd_chunk, ssd_chunk_backward,
                                          ssd_chunk_backward_plain, ssd_chunk_plain)
from _one_thread import one_thread  # noqa: F401

TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _rel(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _chunk_case(nc, q, h, g, p, n, dA_scale=0.1, *, seed):
    """x, dA, B, C and the output gradients dy, dstates, ddecay as numpy."""
    rng = np.random.RandomState(seed)
    f = np.float32
    return (rng.randn(nc, q, h, p).astype(f), (-np.abs(rng.randn(nc, q, h)) * dA_scale).astype(f),
            rng.randn(nc, q, g, n).astype(f), rng.randn(nc, q, g, n).astype(f),
            rng.randn(nc, q, h, p).astype(f), rng.randn(nc, h, p, n).astype(f),
            rng.randn(nc, h).astype(f))


CHUNK_CASES = [  # (nc, Q, H, G, P, N, dA scale): the JAX test's shapes, G < H, Q 64
    (2, 16, 4, 4, 8, 16, 0.1), (3, 32, 6, 2, 8, 16, 0.1), (2, 64, 4, 1, 16, 32, 0.5),
    (2, 48, 4, 2, 24, 40, 1e-3),
]


@pytest.mark.parametrize("case", CHUNK_CASES)
def test_plain_backward_matches_autograd(case):
    x, dA, B, C, dy, dst, ddec = (torch.from_numpy(a) for a in _chunk_case(*case, seed=7))
    ins = [t.clone().requires_grad_() for t in (x, dA, B, C)]
    want = torch.autograd.grad(ssd_chunk_plain(*ins), ins, (dy, dst, ddec))
    got = ssd_chunk_backward_plain(x, dA, B, C, dy, dst, ddec)
    for name, a, b in zip(("dx", "ddA", "dB", "dC"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel(a, b) <= 1e-5, name


@pytest.mark.parametrize("case", CHUNK_CASES)
def test_chunk_backward_matches_jax_vjp(case):
    """``ssd_chunk_backward`` (the CPU route) against ``jax.vjp`` of the
    JAX package's plain chunk reference, whose B and C are broadcast to the
    heads: a group's gradient is the sum over its heads."""
    nc, q, h, g, p, n, _ = case
    x, dA, B, C, dy, dst, ddec = _chunk_case(*case, seed=11)
    rep = h // g
    out, vjp = jax.vjp(jref.ssd_chunk_ref, *(jnp.asarray(a) for a in
                                              (x, dA, np.repeat(B, rep, 2), np.repeat(C, rep, 2))))
    jdx, jdA, jdB, jdC = vjp((jnp.asarray(dy), jnp.asarray(dst), jnp.asarray(ddec)))
    group = functools.partial(np.sum, axis=3)
    jdB = group(np.asarray(jdB).reshape(nc, q, g, rep, n))
    jdC = group(np.asarray(jdC).reshape(nc, q, g, rep, n))
    got = ssd_chunk_backward(*(torch.from_numpy(a) for a in (x, dA, B, C, dy, dst, ddec)))
    for name, a, b in zip(("dx", "ddA", "dB", "dC"), got, (jdx, jdA, jdB, jdC)):
        assert _rel(a, b) <= TOL["float32"], name


def _ssd_inputs(b, s, h, g, p, n, seed):
    rng = np.random.RandomState(seed)
    f = np.float32
    x = rng.randn(b, s, h, p).astype(f)
    dt = np.log1p(np.exp(rng.randn(b, s, h))).astype(f) * 0.1  # softplus'd timesteps
    A_log = np.log(rng.uniform(1.0, 4.0, h)).astype(f)
    B = rng.randn(b, s, g, n).astype(f)
    C = rng.randn(b, s, g, n).astype(f)
    D = rng.randn(h).astype(f)
    dy = rng.randn(b, s, h, p).astype(f)
    dfinal = rng.randn(b, h, p, n).astype(f)
    return (x, dt, A_log, B, C, D), (dy, dfinal)


SSD_CASES = [(2, 64, 4, 1, 8, 16, 16), (1, 96, 6, 2, 8, 16, 32)]  # (b, s, h, g, p, n, chunk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ops_ssd_gradient_matches_jax_vjp(case, dtype):
    """``ops.ssd`` under autograd (``ssd_chunk`` through ``SSDChunk``, the
    inter-chunk recurrence and output term through autograd) against
    ``jax.vjp`` of the JAX package's ``ssd_chunked``: gradients of x, dt,
    A_log, B, C and D for cotangents on y and the final state."""
    b, s, h, g, p, n, chunk = case
    ins, (dy, dfinal) = _ssd_inputs(b, s, h, g, p, n, seed=s + h)
    jt, tt = jnp.dtype(dtype), getattr(torch, dtype)
    low = (0, 3, 4)  # x, B, C in the working type

    def as_jax(i, a):
        return jnp.asarray(a).astype(jt) if i in low else jnp.asarray(a)

    jins = [as_jax(i, a) for i, a in enumerate(ins)]
    (jy, jfinal), vjp = jax.vjp(lambda *a: jax_ssd_chunked(*a, chunk), *jins)
    jgrads = vjp((jnp.asarray(dy).astype(jy.dtype), jnp.asarray(dfinal)))

    tins = [(torch.from_numpy(a).to(tt) if i in low else torch.from_numpy(a)).requires_grad_()
            for i, a in enumerate(ins)]
    y, final = ops.ssd(*tins, chunk)
    assert y.grad_fn is not None and y.dtype == tt
    grads = torch.autograd.grad((y, final), tins, (torch.from_numpy(dy).to(tt),
                                                   torch.from_numpy(dfinal)))
    tol = TOL[dtype]
    assert _rel(y, np.asarray(jy.astype(jnp.float32))) <= tol
    for name, a, want in zip(("x", "dt", "A_log", "B", "C", "D"), grads, jgrads):
        assert a.dtype == tins[("x", "dt", "A_log", "B", "C", "D").index(name)].dtype, name
        assert _rel(a, np.asarray(want.astype(jnp.float32))) <= tol, name


def test_function_only_under_grad_and_no_launch_on_the_cpu():
    """Serving (no graph) takes the bare forward; a graph goes through
    ``SSDChunk``; on the CPU neither counts a launch."""
    x, dA, B, C, dy, dst, ddec = (torch.from_numpy(a) for a in
                                  _chunk_case(2, 16, 4, 2, 8, 16, seed=3))
    ssd_scan.reset_launches()
    with torch.no_grad():
        plain = ssd_chunk(x, dA, B, C)
    assert all(t.grad_fn is None for t in plain)
    xg = x.clone().requires_grad_()
    out = ssd_chunk(xg, dA, B, C)
    assert type(out[0].grad_fn).__name__ == SSDChunk.__name__ + "Backward"
    (gx,) = torch.autograd.grad(out, (xg,), (dy, dst, ddec))
    assert torch.equal(gx, ssd_chunk_backward_plain(x, dA, B, C, dy, dst, ddec)[0])
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    assert ssd_chunk.launches == 0 and ssd_chunk_backward.launches == 0


@pytest.mark.parametrize("bad", ["dy", "dstates", "ddecay", "device"])
def test_backward_refuses(bad):
    x, dA, B, C, dy, dst, ddec = (torch.from_numpy(a) for a in
                                  _chunk_case(2, 16, 4, 2, 8, 16, seed=3))
    grads = {"dy": dy, "dstates": dst, "ddecay": ddec}
    if bad == "device":  # a gradient on another device than x ("meta" alone is the dry run's)
        with pytest.raises(ValueError, match="on meta"):
            ssd_chunk_backward(x, dA, B, C, dy.to("meta"), dst, ddec)
        out = ssd_chunk_backward(*(t.to("meta") for t in (x, dA, B, C, dy, dst, ddec)))
        assert [t.shape for t in out] == [x.shape, dA.shape, B.shape, C.shape]
        assert all(t.is_meta for t in out)
        return
    grads[bad] = grads[bad][..., :1]
    with pytest.raises(ValueError, match=bad):
        ssd_chunk_backward(x, dA, B, C, grads["dy"], grads["dstates"], grads["ddecay"])
