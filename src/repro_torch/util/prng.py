"""The JAX package's counter-based generator (threefry2x32), on the host.

The paper loop draws its initial weights (the UDF bodies in
``data/synthetic.py``, the ``mlp1`` proxy in ``training/proxy_models.py``)
from ``jax.random``.  This module reproduces those streams in numpy, so
that one seed gives the reference's initial weights on every device: the
draw runs on the host and callers move the result with ``.to(dev)``.

* ``key(seed)`` is ``jax.random.PRNGKey(seed)``: a ``(2,)`` uint32 array.
* ``split(key, n)`` is ``jax.random.split``: ``(n, 2)`` uint32 keys.
* ``bits(key, shape)`` is ``jax.random.bits`` at 32 bits.
* ``uniform(key, shape, lo, hi)`` and ``normal(key, shape)`` are float32
  CPU tensors, as ``jax.random.uniform`` / ``normal`` give them.

Counters follow the partitionable layout (``jax_threefry_partitionable``,
the default since jax 0.5): element ``i`` of a draw is threefry2x32 of the
key over the counter pair ``(i >> 32, i & 0xFFFFFFFF)``.  ``normal`` is
``sqrt(2) * erfinv(u)`` with XLA's f32 ``erfinv`` polynomial and XLA's CPU
``log1p`` / ``log`` under it, each multiply-add that XLA's compiler fuses a
correctly rounded fused multiply-add here, so the draws equal the JAX
package's on the CPU bit for bit.  The uint32 arithmetic runs in uint64
under a 32-bit mask.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = np.uint64(0xFFFFFFFF)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint64(0x1BD11BDA)


def _rotl(v: np.ndarray, d: int) -> np.ndarray:
    return ((v << np.uint64(d)) | (v >> np.uint64(32 - d))) & _MASK


def threefry2x32(k: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The 20-round threefry2x32 block of key ``k`` over the counter words
    ``(x0, x1)`` (uint32 arrays of one shape); returns the two output
    words as uint32 arrays."""
    k = np.asarray(k, np.uint64)
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    x = [(np.asarray(x0, np.uint64) + ks[0]) & _MASK,
         (np.asarray(x1, np.uint64) + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + np.uint64(i + 1)) & _MASK
    return x[0].astype(np.uint32), x[1].astype(np.uint32)


def _counters(shape):
    n = int(np.prod(shape, dtype=np.int64))
    i = np.arange(n, dtype=np.uint64)
    return i >> np.uint64(32), i & _MASK


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def split(k: np.ndarray, n: int = 2) -> np.ndarray:
    """``jax.random.split(k, n)``: ``(n, 2)`` uint32 keys."""
    out0, out1 = threefry2x32(k, *_counters((n,)))
    return np.stack([out0, out1], axis=1)


def bits(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits(k, shape)``: uint32 of ``shape``."""
    shape = tuple(shape)
    out0, out1 = threefry2x32(k, *_counters(shape))
    return (out0 ^ out1).reshape(shape)


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 ``a * b + c`` rounded once.  The f32 product is exact in
    float64; the float64 sum is rounded to odd (TwoSum gives its error),
    which makes the final rounding to float32 the correct one."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    even = (s.view(np.uint64) & np.uint64(1)) == 0
    toward = np.where(err > 0, np.inf, -np.inf)
    s = np.where((err != 0) & even, np.nextafter(s, toward), s)
    return s.astype(np.float32)


def _uniform_np(k: np.ndarray, shape, lo: np.float32, hi: np.float32) -> np.ndarray:
    b = bits(k, shape).astype(np.uint64)
    f = ((b >> np.uint64(9)) | np.uint64(0x3F800000)).astype(np.uint32)
    floats = f.view(np.float32) - np.float32(1.0)
    out = _fma32(floats, np.float32(hi - lo), lo)
    return np.maximum(lo, out)


def uniform(k: np.ndarray, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, lo, hi)``: [lo, hi)."""
    u = _uniform_np(k, tuple(shape), np.float32(lo), np.float32(hi))
    return torch.from_numpy(np.ascontiguousarray(u))


# XLA's f32 log on the CPU (Cephes' logf: the mantissa folded into
# [sqrt(1/2), sqrt(2)), a degree-8 polynomial in it, the exponent times
# ln 2 in two parts), with the multiply-adds its compiler fuses.
_LOG_P = np.array([
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1], np.float32)
# XLA's log1p for |x| < sqrt(2) - 1: Cephes' rational approximation
_LOG1P_NUM = np.array([
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1], np.float32)
_LOG1P_DEN = np.array([
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1], np.float32)


def _log32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU ``log`` for positive float32 ``x``."""
    f32 = np.float32
    x = np.maximum(np.finfo(f32).tiny, x).astype(f32)
    b = x.view(np.uint32)
    e = ((b >> np.uint32(23)).astype(np.int32) - 0x7F).astype(f32) + f32(1)
    m = ((b & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(f32)
    low = m < f32(0.707106781186547524)
    e = e - np.where(low, f32(1), f32(0))
    m = (m - f32(1)) + np.where(low, m, f32(0))
    m2 = m * m
    m3 = m2 * m
    p = _LOG_P
    y = _fma32(_fma32(m, p[0], p[1]), m, p[2])
    y1 = _fma32(_fma32(m, p[3], p[4]), m, p[5])
    y2 = _fma32(_fma32(m, p[6], p[7]), m, p[8])
    y = _fma32(_fma32(y, m3, y1), m3, y2)
    y = _fma32(y, m3, f32(-2.12194440e-4) * e)
    m = _fma32(f32(-0.5), m2, m) + y
    return _fma32(f32(0.693359375), e, m)


def _horner(x: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma32(p, x, c)
    return p


def _log1p32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU ``log1p`` for float32 ``x > -1``."""
    x2 = x * x
    r = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + _fma32(np.float32(-0.5), x2, r)
    return np.where(np.abs(x) < np.float32(0.41421356237309504880), small,
                    _log32(x + np.float32(1.0)))


# XLA's f32 erfinv (Giles, "Approximating the erfinv function"): one
# polynomial in w - 2.5 for w < 5, one in sqrt(w) - 3 for the tail.
_ERFINV_SMALL = np.array([
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941],
    np.float32)
_ERFINV_LARGE = np.array([
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682],
    np.float32)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ``erfinv`` for ``|x| < 1``."""
    w = -_log1p32(-x * x)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    c = np.where(small[None], _ERFINV_SMALL[:, None], _ERFINV_LARGE[:, None])
    p = c[0]
    for i in range(1, len(c)):
        p = _fma32(p, w, c[i])
    return p * x


def normal(k: np.ndarray, shape, scale=None) -> torch.Tensor:
    """``jax.random.normal(k, shape)`` in float32.

    ``scale`` gives ``normal(k, shape) * scale`` as XLA computes it under
    ``jit``, where the constant factor folds into the normal's ``sqrt(2)``:
    ``erfinv(u) * (sqrt(2) * scale)``, each product rounded to float32."""
    shape = tuple(shape)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = _uniform_np(k, shape, lo, np.float32(1.0)).reshape(-1)
    c = np.float32(np.sqrt(2))
    if scale is not None:
        c = c * np.float32(scale)
    z = c * _erfinv32(u)
    return torch.from_numpy(np.ascontiguousarray(z.reshape(shape)))
