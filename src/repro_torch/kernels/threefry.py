"""``jax.random``'s threefry2x32 draws on the card: the ``threefry``
kernel wrapper.

``util/prng.py`` describes a draw as a ``Draw`` (its transform, keys,
host constants and output dtype) and hands it here with the tensor to fill.
``fill`` takes its route from the tensor's device: a CUDA tensor launches
the hand-written kernel in ``csrc/threefry.cu`` (or raises), one launch
for the whole tensor; a CPU tensor takes ``draw.at``, the plain version
(numpy, equal to jax 0.9.0 on the CPU bit for bit).  The kernel replaces no
TPU kernel: the JAX package draws with XLA's threefry2x32 primitive, not
through Pallas.  Its transforms:

    BITS          the 32 bits, in an int32 tensor
    UNIFORM       f32 on [lo, hi)
    NORMAL        f32 sqrt(2) * erfinv(u), times a scale
    TRUNC_NORMAL  f32 clipped sqrt(2) * erfinv(u), times std, cast to f32 or
                  bf16, times a constant in that dtype
    RANDINT       int32 (stored as int32 or int64) from two keys' bits
    NORMAL_BF16   jax's bf16 normal: 8 random bits, bf16 products

``fill.launches`` counts the CUDA launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

BITS, UNIFORM, NORMAL, TRUNC_NORMAL, RANDINT, NORMAL_BF16 = range(6)
KINDS = ("bits", "uniform", "normal", "truncated_normal", "randint", "normal_bf16")
# the output types the kernel writes: (kind, dtype) -> its out_type code
_OUT = {(BITS, torch.int32): 0, (UNIFORM, torch.float32): 1, (NORMAL, torch.float32): 1,
        (TRUNC_NORMAL, torch.float32): 1, (TRUNC_NORMAL, torch.bfloat16): 2,
        (RANDINT, torch.int32): 0, (RANDINT, torch.int64): 3,
        (NORMAL_BF16, torch.bfloat16): 2}

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build.build("threefry")))
        vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.threefry_fill.argtypes = [vp, ctypes.c_ulonglong, i, i, u, u, u, u, vp, vp, vp]
        lib.threefry_fill.restype = i
        lib.threefry_error_string.argtypes = [i]
        lib.threefry_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def fill(out: torch.Tensor, draw) -> torch.Tensor:
    """Write ``draw`` (a ``util.prng.Draw``) into every element of ``out``,
    a contiguous tensor of the draw's dtype, in flat index order.  Returns
    ``out``."""
    code = _OUT.get((draw.kind, out.dtype))
    if code is None or out.dtype != draw.dtype:
        raise ValueError(f"no {KINDS[draw.kind]} draw into {out.dtype}")
    if not out.is_contiguous():
        raise ValueError("a draw fills a contiguous tensor")
    n = out.numel()
    if out.device.type == "cpu":
        if n:
            out.view(-1).copy_(draw.at(np.arange(n, dtype=np.uint64)))
        return out
    if out.device.type != "cuda":
        raise ValueError(f"a draw fills a CPU or CUDA tensor, not {out.device}")
    if n == 0:
        return out
    (k0, k1), (k2, k3) = draw.keys[0].tolist(), draw.keys[-1].tolist()
    f = (ctypes.c_float * 6)(*draw.f)
    iv = (ctypes.c_uint * 3)(*draw.i)
    lib = _lib()
    with _build.on_device(out.device) as stream:
        rc = lib.threefry_fill(out.data_ptr(), n, draw.kind, code, k0, k1, k2, k3, f, iv, stream)
    if rc != 0:
        msg = lib.threefry_error_string(rc).decode()
        raise RuntimeError(f"threefry {KINDS[draw.kind]} launch failed: CUDA error {rc} ({msg})")
    fill.launches += 1
    return out


fill.launches = 0


def reset_launches() -> None:
    fill.launches = 0
