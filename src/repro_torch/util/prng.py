"""The JAX package's counter-based generator (threefry2x32): one key gives
``jax.random``'s numbers on the CPU and on the card.

The JAX package draws its initial weights (the paper loop's UDF bodies and
``mlp1`` proxy, every model family's ``init``) and its batches
(``models/registry.py::make_batch``) from ``jax.random``.  This module
reproduces those streams bit for bit, under jax 0.9.0's partitionable
counters (``jax_threefry_partitionable``, the default since jax 0.5):
element ``i`` of a draw is threefry2x32 of the key over the counter pair
``(i >> 32, i & 0xFFFFFFFF)``.

* ``key(seed)`` is ``jax.random.PRNGKey(seed)``: a ``(2,)`` uint32 array;
  ``split(key, n)`` is ``jax.random.split``; ``fold_in(key, data)`` is
  ``jax.random.fold_in``.  Keys are numpy arrays on the host.
* ``bits``, ``uniform``, ``normal`` (f32 or bf16), ``truncated_normal`` and
  ``randint`` take a ``device``.  On "cpu" the draw is computed here in
  numpy (the plain version); on "cuda" one launch of the threefry kernel
  (``kernels/threefry.py``) writes it on the card, in the caller's dtype,
  and nothing crosses from the host.  There is no fallback: a kernel that
  does not build or launch raises.  ``out=`` draws into an existing tensor
  (a parameter) in place.
* ``Draw.at(idx)`` is the plain version at given flat indices, so that a
  draw of billions of elements on the card can be checked at samples.

``normal`` is ``sqrt(2) * erfinv(u)`` with XLA's f32 ``erfinv`` polynomial
and XLA's CPU ``log1p`` / ``log`` under it, each multiply-add that XLA's
compiler fuses a correctly rounded fused multiply-add here (the kernel
calls ``__fmaf_rn`` at the same places, and rounds every other f32
operation on its own), so the draws equal the JAX package's on the CPU bit
for bit.  The uint32 arithmetic runs in uint64 under a 32-bit mask.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import threefry

_MASK = np.uint64(0xFFFFFFFF)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint64(0x1BD11BDA)


def _rotl(v: np.ndarray, d: int) -> np.ndarray:
    return ((v << np.uint64(d)) | (v >> np.uint64(32 - d))) & _MASK


_SMALL = 16  # counters at most this many run on Python ints (numpy's per-op cost)


def _block_int(ks, a: int, b: int):
    a, b = (a + ks[0]) & 0xFFFFFFFF, (b + ks[1]) & 0xFFFFFFFF
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & 0xFFFFFFFF
            b = (((b << r) | (b >> (32 - r))) & 0xFFFFFFFF) ^ a
        a = (a + ks[(i + 1) % 3]) & 0xFFFFFFFF
        b = (b + ks[(i + 2) % 3] + i + 1) & 0xFFFFFFFF
    return a, b


def _blocks(k, counters) -> np.ndarray:
    """(n, 2) uint32: the block of key ``k`` over each (x0, x1) pair of
    Python ints in ``counters``."""
    k0, k1 = int(k[0]), int(k[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    return np.array([_block_int(ks, a, b) for a, b in counters], np.uint32).reshape(-1, 2)


def threefry2x32(k: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The 20-round threefry2x32 block of key ``k`` over the counter words
    ``(x0, x1)`` (uint32 arrays of one shape); returns the two output
    words as uint32 arrays."""
    x0, x1 = np.asarray(x0), np.asarray(x1)
    if x0.size <= _SMALL:  # a split or a fold_in: the same arithmetic on Python ints
        out = _blocks(k, zip(x0.reshape(-1).tolist(), x1.reshape(-1).tolist()))
        return out[:, 0].reshape(x0.shape), out[:, 1].reshape(x0.shape)
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
    return _index_words(np.arange(n, dtype=np.uint64))


def _index_words(idx: np.ndarray):
    """The partitionable counter pair of flat indices ``idx``."""
    i = np.asarray(idx, np.uint64)
    return i >> np.uint64(32), i & _MASK


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def as_key(k) -> np.ndarray:
    """``k`` as a key: an int is read as ``PRNGKey(k)``, a ``(2,)`` uint32
    key is taken as it is."""
    if isinstance(k, (int, np.integer)):
        return key(int(k))
    k = np.asarray(k, np.uint32)
    if k.shape != (2,):
        raise ValueError(f"a key is an int or a (2,) uint32 array, not {k.shape}")
    return k


def split(k: np.ndarray, n: int = 2) -> np.ndarray:
    """``jax.random.split(k, n)``: ``(n, 2)`` uint32 keys."""
    if n <= _SMALL:
        return _blocks(k, ((0, i) for i in range(n)))
    out0, out1 = threefry2x32(k, *_counters((n,)))
    return np.stack([out0, out1], axis=1)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``: threefry2x32 of ``k`` over the
    seed words of the uint32 ``data``, ``(0, data)``."""
    return _blocks(k, [(0, int(data) & 0xFFFFFFFF)])[0]


def _bits_at(k: np.ndarray, idx: np.ndarray) -> np.ndarray:
    out0, out1 = threefry2x32(k, *_index_words(idx))
    return out0 ^ out1


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


def _uniform_bits(b: np.ndarray, lo: np.float32, span: np.float32) -> np.ndarray:
    """``jax.random.uniform``'s f32 transform of 32-bit draws ``b``:
    ``max(lo, (mantissa in [1, 2) - 1) * span + lo)``, the multiply-add
    fused, ``span`` the f32 ``hi - lo``."""
    f = ((b.astype(np.uint64) >> np.uint64(9)) | np.uint64(0x3F800000)).astype(np.uint32)
    floats = f.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma32(floats, span, lo))


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


def log32(x: np.ndarray) -> np.ndarray:
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
                    log32(x + np.float32(1.0)))


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


# XLA's CPU expm1 for f32: exp(x) - 1 above |x| = 0.5, tanh(x / 2) *
# (exp(x) + 1) below, over XLA's own exp (a Cody-Waite reduction by ln 2 and
# a degree-5 polynomial) and tanh (a rational function of x^2, x itself
# below 4e-4), with the multiply-adds its compiler fuses.
_EXP_P = np.array([
    1.9875691214110702e-4, 1.398199936375022e-3, 8.333452045917511e-3,
    4.166579619050026e-2, 1.666666567325592e-1, 0.5], np.float32)
_TANH_NUM = np.array([
    -2.7607683663038313e-16, 2.0001879384549948e-13, -8.604671836165423e-11,
    5.122297253024044e-08, 1.4857223504805006e-05, 6.372619536705315e-4,
    4.893524572253227e-3], np.float32)
_TANH_DEN = np.array([
    1.1982583600911312e-06, 1.1853470641653985e-4, 2.2684347350150347e-3,
    4.8935250379145145e-3], np.float32)


def _exp32(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    x = np.clip(x, f32(-87.80000305175781), f32(88.80000305175781)).astype(f32)
    n = np.clip(np.floor(_fma32(x, f32(1.4426950216293335), f32(0.5))), f32(-127), f32(127))
    r = _fma32(-n, f32(0.693359375), x)
    r = _fma32(-n, f32(-2.1219444170128554e-4), r)
    p = _fma32(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        p = _fma32(p, r, c)
    e = _fma32(p, r * r, r) + f32(1)
    return e * ((n.astype(np.int32) << 23) + 0x3F800000).astype(np.int32).view(f32)


def _tanh32(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    c = np.clip(x, f32(-7.998811721801758), f32(7.998811721801758)).astype(f32)
    c2 = c * c
    num = _fma32(c2, _TANH_NUM[0], _TANH_NUM[1])
    for k in _TANH_NUM[2:]:
        num = _fma32(c2, num, k)
    den = _fma32(c2, _TANH_DEN[0], _TANH_DEN[1])
    for k in _TANH_DEN[2:]:
        den = _fma32(c2, den, k)
    t = np.where(np.abs(x) < f32(3.9999998989515007e-4), x, (c * num) / den)
    return np.where(np.abs(x) >= f32(20), np.copysign(f32(1), x), t)


def expm1_32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU ``expm1`` for float32 ``x``."""
    f32 = np.float32
    x = np.asarray(x, f32)
    e = _exp32(x)
    h = x * f32(0.5)
    out = np.where(np.abs(x) > f32(0.5), e - f32(1), _tanh32(h) * (e + f32(1)))
    return np.where(h == 0, x, out).astype(f32)


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` rounded to bfloat16 (to nearest, ties to even), as
    float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + np.uint64(0x7FFF) + ((b >> np.uint64(16)) & np.uint64(1))) & np.uint64(0xFFFF0000)
    return b.astype(np.uint32).view(np.float32)


_SQRT2 = np.float32(np.sqrt(2))
_NORMAL_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))
_BF16_NORMAL_LO = np.float32(-0.99609375)  # nextafter(-1, 0) in bf16
_BF16_SQRT2 = np.float32(1.4140625)  # sqrt(2) in bf16


class Draw:
    """One draw: the transform ``kind`` (``threefry.BITS`` ...) of the
    threefry2x32 bits of ``keys``, its host constants (``f`` float32, ``i``
    uint32, the kernel's arguments) and the output ``dtype``.  ``at(idx)``
    is the plain version: the draw's elements at flat indices ``idx``, as
    a CPU tensor of ``dtype``."""

    __slots__ = ("kind", "keys", "f", "i", "dtype")

    def __init__(self, kind: int, keys, dtype: torch.dtype, f=(), i=()):
        self.kind = kind
        self.keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        self.f = tuple(np.float32(v) for v in f)
        self.i = tuple(int(v) & 0xFFFFFFFF for v in i)
        self.dtype = dtype

    def at(self, idx) -> torch.Tensor:
        idx = np.asarray(idx, np.uint64).reshape(-1)
        b = _bits_at(self.keys[0], idx)
        f, kind = self.f, self.kind
        if kind == threefry.BITS:
            return torch.from_numpy(b.view(np.int32))
        if kind == threefry.RANDINT:
            lo = _bits_at(self.keys[1], idx).astype(np.uint64)
            span, mult = (np.uint64(v) for v in self.i[1:3])
            off = ((((b.astype(np.uint64) % span) * mult) & _MASK) + lo % span) & _MASK
            out = ((np.uint64(self.i[0]) + off % span) & _MASK).astype(np.uint32)
            return torch.from_numpy(out.view(np.int32)).to(self.dtype)
        if kind == threefry.UNIFORM:
            out = _uniform_bits(b, f[0], f[1])
        elif kind == threefry.NORMAL:
            out = (f[2] * _erfinv32(_uniform_bits(b, f[0], f[1]))) * f[3]
        elif kind == threefry.TRUNC_NORMAL:
            z = np.clip(_SQRT2 * _erfinv32(_uniform_bits(b, f[0], f[1])), f[2], f[3])
            out = self._round(self._round(z * f[4]) * f[5])
        else:  # NORMAL_BF16: 8 random bits, a bf16 uniform, bf16 products
            m = ((b & np.uint32(0xFF)) >> np.uint32(1)) | np.uint32(0x3F80)
            floats = (m << np.uint32(16)).view(np.float32) - np.float32(1.0)
            u = np.maximum(f[0], floats * f[1] + f[0])
            out = _bf16(f[2] * _bf16(_erfinv32(u)))
        return torch.from_numpy(np.ascontiguousarray(out, np.float32)).to(self.dtype)

    def _round(self, x: np.ndarray) -> np.ndarray:
        return _bf16(x) if self.dtype == torch.bfloat16 else x


_RECORDS = []


@contextlib.contextmanager
def recording():
    """``with recording() as drawn:`` collects (tensor, Draw) for every draw
    made inside, so that a caller can check a drawn tensor at sampled
    indices against ``Draw.at``."""
    drawn = []
    _RECORDS.append(drawn)
    try:
        yield drawn
    finally:
        _RECORDS.remove(drawn)


def _device(device) -> torch.device:
    from repro_torch.util import resolve_device

    return resolve_device(device)


def sample(draw: Draw, shape, device="cpu", out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``draw`` of ``shape`` into ``out`` (a contiguous tensor of the draw's
    dtype and shape) or a new tensor on ``device``: the kernel on a CUDA
    tensor, ``draw.at`` on a CPU one (``threefry.fill``)."""
    shape = tuple(int(d) for d in shape)
    if out is None:
        out = torch.empty(shape, dtype=draw.dtype, device=_device(device))
    elif tuple(out.shape) != shape or out.dtype != draw.dtype:
        raise ValueError(f"out is {tuple(out.shape)} {out.dtype}, the draw {shape} {draw.dtype}")
    threefry.fill(out, draw)
    for drawn in _RECORDS:
        drawn.append((out, draw))
    return out


def bits(k: np.ndarray, shape, *, device="cpu", out=None) -> torch.Tensor:
    """``jax.random.bits(k, shape)``: its uint32 bits in an int32 tensor."""
    return sample(Draw(threefry.BITS, k, torch.int32), shape, device, out)


def uniform(k: np.ndarray, shape, lo: float = 0.0, hi: float = 1.0, *, device="cpu",
            out=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, lo, hi)``: [lo, hi)."""
    lo, hi = np.float32(lo), np.float32(hi)
    return sample(Draw(threefry.UNIFORM, k, torch.float32, (lo, hi - lo)), shape, device, out)


def normal(k: np.ndarray, shape, scale=None, *, dtype=torch.float32, times=None,
           device="cpu", out=None) -> torch.Tensor:
    """``jax.random.normal(k, shape, dtype)`` in float32 or bfloat16.

    float32: ``scale`` gives ``normal(k, shape) * scale`` as XLA computes it
    under ``jit``, where the constant factor folds into the normal's
    ``sqrt(2)``: ``erfinv(u) * (sqrt(2) * scale)``, each product rounded to
    float32; ``times`` gives it as an eager ``normal(k, shape) * times``
    computes it, a second product rounded on its own.

    bfloat16 (``_normal_real`` on XLA's CPU): 8 random bits make a bf16
    uniform on [nextafter(-1, 0), 1), its f32 ``erfinv`` is rounded to bf16
    and multiplied by bf16 ``sqrt(2)``, rounded again."""
    if dtype == torch.bfloat16:
        if scale is not None or times is not None:
            raise ValueError("a bfloat16 normal takes no scale")
        draw = Draw(threefry.NORMAL_BF16, k, dtype, (_BF16_NORMAL_LO, 2.0, _BF16_SQRT2))
    elif dtype == torch.float32:
        c = _SQRT2 if scale is None else _SQRT2 * np.float32(scale)
        t = np.float32(1.0) if times is None else np.float32(times)
        draw = Draw(threefry.NORMAL, k, dtype, (_NORMAL_LO, np.float32(1.0) - _NORMAL_LO, c, t))
    else:
        raise ValueError(f"normal draws float32 or bfloat16, not {dtype}")
    return sample(draw, shape, device, out)


def _erf32(x: float) -> np.float32:
    """``erf`` of a float32, rounded to float32 (equal to XLA's f32 ``erf``
    at the bounds the zoo uses, -2 / sqrt(2) and 2 / sqrt(2))."""
    return np.float32(math.erf(float(x)))


def truncated_normal(k: np.ndarray, shape, lower: float = -2.0, upper: float = 2.0, *,
                     std=None, dtype=torch.float32, times=None, device="cpu",
                     out=None) -> torch.Tensor:
    """``jax.random.truncated_normal(k, lower, upper, shape, float32)``
    (``_truncated_normal``): a uniform on [erf(lower / sqrt2), erf(upper /
    sqrt2)), ``sqrt(2) * erfinv`` of it, clipped to [nextafter(lower, inf),
    nextafter(upper, -inf)].  ``std`` multiplies it in float32, the result
    is cast to ``dtype`` (float32 or bfloat16), and ``times`` multiplies
    that in ``dtype`` (an eager ``* times`` of a weakly typed constant):
    ``dense_init``'s ``(truncated_normal(...) * std).astype(dtype)`` and a
    ``conv_w``'s ``* 0.1``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"truncated_normal draws float32 or bfloat16, not {dtype}")
    f32 = np.float32
    t = f32(1.0)
    if times is not None:
        t = _bf16(f32(times))[()] if dtype == torch.bfloat16 else f32(times)
    draw = Draw(threefry.TRUNC_NORMAL, k, dtype,
                _truncation(float(lower), float(upper)) + (f32(1.0) if std is None else f32(std), t))
    return sample(draw, shape, device, out)


@functools.lru_cache(maxsize=None)
def _truncation(lower: float, upper: float) -> tuple:
    """``truncated_normal``'s uniform range and clip bounds, float32: (a,
    b - a, nextafter(lower, inf), nextafter(upper, -inf))."""
    f32 = np.float32
    lower, upper = f32(lower), f32(upper)
    a, b = _erf32(lower / _SQRT2), _erf32(upper / _SQRT2)
    return a, b - a, np.nextafter(lower, f32(np.inf)), np.nextafter(upper, f32(-np.inf))


def randint(k: np.ndarray, shape, lo: int, hi: int, *, dtype=torch.int32, device="cpu",
            out=None) -> torch.Tensor:
    """``jax.random.randint(k, shape, lo, hi, int32)`` (``_randint``): two
    32-bit draws from ``split(k)``, ``((hi_bits % span) * m + lo_bits %
    span) % span`` with ``m = (2^16 % span)^2 % span`` and uint32
    wrap-around, plus ``lo``.  ``dtype`` is the tensor's index type
    (int32 or int64: the values are the int32 draw's)."""
    if not (-2**31 <= lo < hi <= 2**31 - 1):
        raise ValueError(f"randint takes int32 bounds lo < hi, not [{lo}, {hi})")
    span = hi - lo
    mult = ((2**16 % span) ** 2 & 0xFFFFFFFF) % span
    return sample(Draw(threefry.RANDINT, split(k), dtype, (), (lo, span, mult)), shape, device,
                  out)
