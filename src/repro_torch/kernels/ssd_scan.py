"""Mamba-2 SSD intra-chunk block: the ``ssd_chunk`` kernel wrapper.

The SSM family's prefill and forward send every layer's chunked SSD here
through ``kernels/ops.py::ssd``.  Per chunk c and head h, with head h
reading group h // (H // G) of B and C:

    cum         = cumsum(dA)                         (Q,)   f32
    L[i, j]     = exp(cum[i] - cum[j]) for j <= i, else 0
    y_diag      = ((C B^T) * L) @ x                  (Q, P)
    states      = (x * exp(cum[-1] - cum))^T @ B     (P, N)
    chunk_decay = exp(cum[-1])

with x, B, C widened to f32 and every sum in f32.  ``ssd_chunk`` takes its
route from the tensors' device: a CUDA tensor launches a hand-written
kernel in ``csrc/ssd_chunk.cu`` (or raises), a CPU tensor runs
``ssd_chunk_plain``, the same function in plain PyTorch.

On the card ``route`` picks the kernel from dtype, shape and layout alone,
before the launch: operands with P in ``TC_P``, N in ``TC_N``, 16-byte
aligned data and 16-byte token strides go to the tensor cores
(``"tensor_cores"``): bf16 to wgmma with M and x*w split into bf16 hi + lo,
each within 2^-17 of its f32 value; f32 to the split kernel, which splits
x, B and C as well and runs each product as three (hi.hi + lo.hi + hi.lo).
Everything else goes to the CUDA-core kernel (``"cuda_cores"``, IEEE f32).
Nothing retries on another route: a failed build or launch raises.
``ssd_chunk.launches`` counts the CUDA launches, ``ssd_chunk.route_launches``
the same per route.

Under grad ``ssd_chunk`` goes through the autograd Function ``SSDChunk``,
whose backward ``ssd_chunk_backward`` launches ``csrc/ssd_chunk_bwd.cu``
on the card (f32 sums in a fixed order, no atomics; the JAX package
differentiates its plain ``ssd_chunked`` instead) and runs
``ssd_chunk_backward_plain`` on the CPU.  ``backward_route`` picks its
kernels before the launch: operands that the forward's tensor-core route
takes (P in ``TC_P``, N in ``TC_N``, 16-byte alignment) go to the tensor
cores (``"tensor_cores"``: wgmma, with the f32 operands dy, dstates, M = S
* L, w * x and the group's sum of dS split into bf16 hi + lo, and f32 x,
B and C too, with v = B dstates^T computed into the scratch by a kernel of
its own); the rest to the CUDA cores (``"cuda_cores"``, IEEE f32).
``ssd_chunk_backward.launches`` counts its launches,
``ssd_chunk_backward.route_launches`` the same per route.  Serving, under
``no_grad``, takes the bare forward.

All take cum in the cumsum-difference form of the JAX package's kernel
and reference, so they round alike; L is selected to 0 above the diagonal
before anything multiplies it (exp overflows there).  The CUDA-core kernel
sums the cumsum in sequence, as the CPU does, the tensor-core kernel in a
warp scan; a CUDA ``torch.cumsum`` sums in yet another order, so on the
card they agree to the f32 rounding of |cum|, not bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _mesh

DTYPES = (torch.float32, torch.bfloat16)
MAX_Q, MAX_P, MAX_N = 256, 64, 128
Q_STEP = 16  # chunk lengths are multiples of this
MAX_BLOCKS = 2**31 - 1  # the kernel's grid puts chunks * heads on its x axis
ROUTES = ("tensor_cores", "cuda_cores")
TC_P, TC_N = (16, 32, 64), (16, 32, 64, 128)  # the tensor-core kernels' head and state dims
ALIGN = 16  # bytes: a base address and a token stride for TMA and 16-byte loads

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build.build("ssd_chunk")))
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_chunk_launch.argtypes = [vp] * 7 + [i] * 6 + [ll] * 3 + [i, i, vp]
        lib.ssd_chunk_launch.restype = i
        lib.ssd_chunk_split_launch.argtypes = [vp] * 8 + [ll] + [i] * 6 + [ll] * 3 + [vp]
        lib.ssd_chunk_split_launch.restype = i
        lib.ssd_chunk_split_scratch.argtypes = [i] * 4 + [ctypes.POINTER(ll)]
        lib.ssd_chunk_split_scratch.restype = i
        ip = ctypes.POINTER(ctypes.c_int)
        lib.ssd_chunk_resources.argtypes = [i] * 5 + [ip, ip]
        lib.ssd_chunk_resources.restype = i
        lib.ssd_chunk_error_string.argtypes = [i]
        lib.ssd_chunk_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _token_stride(t: torch.Tensor, name: str) -> int:
    """Elements between consecutive tokens of a (nc, Q, K, D) operand whose
    (K, D) rows are packed and whose tokens are evenly spaced (a slice of
    a wider projection qualifies); raises on any other layout."""
    nc, Q, K, D = t.shape
    packed = (D == 1 or t.stride(3) == 1) and (K == 1 or t.stride(2) == D)
    even = nc == 1 or t.stride(0) == Q * t.stride(1)
    if not (packed and even and t.stride(1) >= K * D):
        raise ValueError(f"{name}: layout {tuple(t.stride())} for shape {tuple(t.shape)} is not "
                         "(tokens evenly spaced, each token's (heads, dim) packed)")
    return t.stride(1)


def _check_operands(x, dA, B, C):
    """Raise on what the kernel does not take; returns (nc, Q, H, G, P, N)."""
    if x.dim() != 4 or dA.dim() != 3 or B.dim() != 4 or C.dim() != 4:
        raise ValueError(f"need x (nc, Q, H, P), dA (nc, Q, H), B and C (nc, Q, G, N); got "
                         f"{tuple(x.shape)}, {tuple(dA.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    nc, Q, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if tuple(dA.shape) != (nc, Q, H) or B.shape != C.shape or tuple(B.shape[:2]) != (nc, Q):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, dA {tuple(dA.shape)}, "
                         f"B {tuple(B.shape)}, C {tuple(C.shape)}")
    if nc < 1 or G < 1 or H % G != 0:
        raise ValueError(f"need nc >= 1 and H % G == 0, got nc={nc}, H={H}, G={G}")
    if Q % Q_STEP or not Q_STEP <= Q <= MAX_Q:
        raise ValueError(f"chunk length {Q} is not a multiple of {Q_STEP} in [{Q_STEP}, {MAX_Q}]")
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N):
        raise ValueError(f"head dim {P} or state dim {N} outside [1, {MAX_P}] / [1, {MAX_N}]")
    if x.dtype not in DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"x, B, C must share one type of {DTYPES}, got {x.dtype}, {B.dtype}, "
                         f"{C.dtype}")
    if dA.dtype != torch.float32 or not dA.is_contiguous():
        raise ValueError(f"dA must be contiguous float32, got {dA.dtype}")
    if nc * H > MAX_BLOCKS:
        raise ValueError(f"chunks * heads = {nc * H} exceeds {MAX_BLOCKS}")
    for t in (dA, B, C):
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}: all must share one device")
    return nc, Q, H, G, P, N


def route(x, B, C) -> str:
    """The kernel a CUDA call takes, from dtype, shape and layout alone
    (operands already checked by ``_check_operands``)."""
    P, N = x.shape[3], B.shape[3]
    aligned = all(t.data_ptr() % ALIGN == 0 and t.stride(1) * t.element_size() % ALIGN == 0
                  for t in (x, B, C))
    if P in TC_P and N in TC_N and aligned:
        return "tensor_cores"
    return "cuda_cores"


def ssd_chunk_plain(x, dA, B, C):
    """The same function as the kernel in plain PyTorch (the CPU route and
    the on-card reference).  Groups broadcast to heads by views, never by
    copies."""
    f32 = torch.float32
    nc, Q, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    cum = torch.cumsum(dA.to(f32).transpose(1, 2), dim=-1)  # (nc, H, Q)
    seg = cum[..., :, None] - cum[..., None, :]  # (nc, H, Q, Q)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.where(tri, torch.exp(seg), torch.zeros((), dtype=f32, device=x.device))
    scores = torch.einsum("cqgn,csgn->cgqs", C.to(f32), B.to(f32))  # (nc, G, Q, Q)
    mix = scores[:, :, None] * L.view(nc, G, rep, Q, Q)
    xg = x.to(f32).reshape(nc, Q, G, rep, P)
    y_diag = torch.einsum("cgrqs,csgrp->cqgrp", mix, xg).reshape(nc, Q, H, P)
    decay_states = torch.exp(cum[..., -1:] - cum)  # (nc, H, Q)
    xw = xg * decay_states.transpose(1, 2).reshape(nc, Q, G, rep, 1)
    states = torch.einsum("csgn,csgrp->cgrpn", B.to(f32), xw).reshape(nc, H, P, N)
    return y_diag, states, torch.exp(cum[..., -1])


def ssd_chunk(x, dA, B, C):
    """x: (nc, Q, H, P) and B, C: (nc, Q, G, N) of one type of float32 or
    bfloat16, H % G == 0; dA: (nc, Q, H) contiguous float32.  Q is a
    multiple of 16 up to 256, P <= 64, N <= 128.  Each token's (heads, dim)
    row of x, B and C is packed and tokens are evenly spaced, so slices of
    one wider projection pass without a copy.  Returns (y_diag
    (nc, Q, H, P), states (nc, H, P, N), chunk_decay (nc, H)), all float32.
    All tensors share one device, which picks the route: CUDA launches the
    kernel, CPU runs ``ssd_chunk_plain``.  When a graph is being built and
    an operand needs a gradient, the call goes through ``SSDChunk``, whose
    backward is ``ssd_chunk_backward``; otherwise (serving) it is the bare
    forward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dA, B, C)):
        return SSDChunk.apply(x, dA, B, C)
    return _forward(x, dA, B, C)


class SSDChunk(torch.autograd.Function):
    """``ssd_chunk`` with ``ssd_chunk_backward`` as its gradient (the JAX
    package differentiates its plain ``ssd_chunked`` instead).  Saves the
    four operands (B and C as the strided views they came as); the
    gradients of unused outputs arrive as zeros."""

    @staticmethod
    def forward(ctx, x, dA, B, C):
        ctx.save_for_backward(x, dA, B, C)
        return _forward(x, dA, B, C)

    @staticmethod
    def backward(ctx, dy, dstates, ddecay):
        return ssd_chunk_backward(*ctx.saved_tensors, dy, dstates, ddecay)


def _forward(x, dA, B, C):
    nc, Q, H, G, P, N = _check_operands(x, dA, B, C)
    strides = [_token_stride(t, name) for t, name in ((x, "x"), (B, "B"), (C, "C"))]
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dA, B, C)
    if x.device.type == "meta":
        f32 = torch.float32
        outs = (torch.empty((nc, Q, H, P), dtype=f32, device=x.device),
                torch.empty((nc, H, P, N), dtype=f32, device=x.device),
                torch.empty((nc, H), dtype=f32, device=x.device))
        _mesh.note("ssd_chunk", 2.0 * nc * H * (Q * Q * (N + P) + Q * P * N),
                   _mesh.nbytes(x, dA, B, C, *outs))
        return outs
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk runs on CUDA or the CPU, not {x.device}")
    path = route(x, B, C)
    lib = _lib()
    f32 = torch.float32
    y = torch.empty((nc, Q, H, P), dtype=f32, device=x.device)
    states = torch.empty((nc, H, P, N), dtype=f32, device=x.device)
    decay = torch.empty((nc, H), dtype=f32, device=x.device)
    split = path == "tensor_cores" and x.dtype == torch.float32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if split:
            n = ctypes.c_longlong(0)
            rc = lib.ssd_chunk_split_scratch(nc, Q, H, G, ctypes.byref(n))
            if rc == 0:
                scores = torch.empty(n.value, dtype=f32, device=x.device)
                rc = lib.ssd_chunk_split_launch(
                    x.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
                    states.data_ptr(), decay.data_ptr(), scores.data_ptr(), n.value, nc, Q, H,
                    G, P, N, *strides, stream)
        else:
            rc = lib.ssd_chunk_launch(
                x.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
                states.data_ptr(), decay.data_ptr(), nc, Q, H, G, P, N, *strides,
                int(x.dtype == torch.bfloat16), int(path == "tensor_cores"), stream)
    if rc != 0:
        msg = lib.ssd_chunk_error_string(rc).decode()
        raise RuntimeError(f"ssd_chunk launch failed ({path}): CUDA error {rc} ({msg})")
    ssd_chunk.launches += 1
    ssd_chunk.route_launches[path] += 1
    return y, states, decay


def ssd_chunk_backward_plain(x, dA, B, C, dy, dstates, ddecay):
    """The gradient of ``ssd_chunk_plain`` written out step by step in plain
    PyTorch (not autograd; the CPU route and the on-card reference).  Per
    chunk and head, with M = (C B^T) * L and w_j = exp(cum[-1] - cum[j]):
    v = B dst^T, dx = M^T dy + w * v; dM = dy x^T, dS = dM * L summed over
    the group's heads, dC = dS B, dB = dS^T C + sum_h (w * x) dst; with G =
    dM * M, dcum_i = sum_j G_ij - sum_k G_ki - u_i (u_j = w_j x_j . v_j),
    dcum[-1] += sum_j u_j + ddecay * chunk_decay; ddA the reverse cumsum of
    dcum.  Returns (dx, ddA, dB, dC): dx, dB and dC in their inputs' types,
    ddA float32; every sum in f32."""
    f32 = torch.float32
    nc, Q, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    xf = x.to(f32).reshape(nc, Q, G, rep, P)
    Bf, Cf = B.to(f32), C.to(f32)
    dyf = dy.to(f32).reshape(nc, Q, G, rep, P)
    dst = dstates.to(f32).reshape(nc, G, rep, P, N)
    cum = torch.cumsum(dA.to(f32).transpose(1, 2), dim=-1).reshape(nc, G, rep, Q)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]),
                    torch.zeros((), dtype=f32, device=x.device))  # (nc, G, rep, Q, Q)
    M = torch.einsum("cqgn,csgn->cgqs", Cf, Bf)[:, :, None] * L
    w = torch.exp(cum[..., -1:] - cum)  # (nc, G, rep, Q)
    w_tok = w.permute(0, 3, 1, 2)[..., None]  # (nc, Q, G, rep, 1)
    v = torch.einsum("csgn,cgrpn->csgrp", Bf, dst)  # B dst^T per head
    dx = torch.einsum("cgrqs,cqgrp->csgrp", M, dyf) + w_tok * v
    dM = torch.einsum("cqgrp,csgrp->cgrqs", dyf, xf)
    dS = (dM * L).sum(dim=2)  # (nc, G, Q, Q): summed over the group's heads
    dC = torch.einsum("cgqs,csgn->cqgn", dS, Bf)
    dB = (torch.einsum("cgqs,cqgn->csgn", dS, Cf)
          + torch.einsum("csgrp,cgrpn->csgn", xf * w_tok, dst))
    Gm = dM * M  # 0 above the diagonal, where M is
    u = w * (xf * v).sum(dim=-1).permute(0, 2, 3, 1)  # (nc, G, rep, Q)
    dcum = Gm.sum(dim=-1) - Gm.sum(dim=-2) - u
    last = u.sum(dim=-1) + ddecay.to(f32).reshape(nc, G, rep) * torch.exp(cum[..., -1])
    dcum = torch.cat([dcum[..., :-1], dcum[..., -1:] + last[..., None]], dim=-1)
    ddA = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), dim=-1), (-1,))
    ddA = ddA.reshape(nc, H, Q).transpose(1, 2).contiguous()
    return dx.reshape(nc, Q, H, P).to(x.dtype), ddA, dB.to(B.dtype), dC.to(C.dtype)


_BWD_LIB = None
MAX_GRID_Y = 65535  # the group kernels put chunks * groups on their y axis


def _bwd_lib() -> ctypes.CDLL:
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = ctypes.CDLL(str(_build.build("ssd_chunk_bwd")))
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ip = ctypes.POINTER(ctypes.c_int)
        lib.ssd_chunk_bwd_launch.argtypes = [vp] * 12 + [ll] + [i] * 6 + [ll] * 3 + [i, vp]
        lib.ssd_chunk_bwd_launch.restype = i
        lib.ssd_chunk_bwd_scratch_floats.argtypes = [i] * 4
        lib.ssd_chunk_bwd_scratch_floats.restype = ll
        lib.ssd_chunk_bwd_resources.argtypes = [i, i, i, ip, ip]
        lib.ssd_chunk_bwd_resources.restype = i
        lib.ssd_chunk_bwd_tc_launch.argtypes = [vp] * 12 + [ll] + [i] * 6 + [ll] * 3 + [i, vp]
        lib.ssd_chunk_bwd_tc_launch.restype = i
        lib.ssd_chunk_bwd_tc_scratch_floats.argtypes = [i] * 6
        lib.ssd_chunk_bwd_tc_scratch_floats.restype = ll
        lib.ssd_chunk_bwd_tc_resources.argtypes = [i, i, i, i, ip, ip]
        lib.ssd_chunk_bwd_tc_resources.restype = i
        lib.ssd_chunk_bwd_error_string.argtypes = [i]
        lib.ssd_chunk_bwd_error_string.restype = ctypes.c_char_p
        _BWD_LIB = lib
    return _BWD_LIB


def backward_route(x, B, C) -> str:
    """The kernels a CUDA backward call takes, from dtype, shape and layout
    alone (operands already checked by ``_check_operands``): the tensor
    cores wherever the forward takes them, in bf16 and f32 alike (f32 x, B
    and C as bf16 hi and lo pieces), otherwise the CUDA cores."""
    return route(x, B, C)


def ssd_chunk_backward(x, dA, B, C, dy, dstates, ddecay):
    """The gradient of ``ssd_chunk`` at (x, dA, B, C) (operands as
    ``ssd_chunk`` takes them) given the output gradients dy (nc, Q, H, P),
    dstates (nc, H, P, N) and ddecay (nc, H).  Returns (dx, ddA, dB, dC):
    dx, dB and dC in their inputs' types (contiguous), ddA float32.  A CUDA
    tensor launches the ``backward_route`` kernels of
    ``csrc/ssd_chunk_bwd.cu`` (or raises), a CPU tensor runs
    ``ssd_chunk_backward_plain``.  ``ssd_chunk_backward.launches`` counts the
    CUDA launches, ``ssd_chunk_backward.route_launches`` the same per
    route."""
    nc, Q, H, G, P, N = _check_operands(x, dA, B, C)
    strides = [_token_stride(t, name) for t, name in ((x, "x"), (B, "B"), (C, "C"))]
    f32 = torch.float32
    grads = []
    for t, name, shape in ((dy, "dy", (nc, Q, H, P)), (dstates, "dstates", (nc, H, P, N)),
                           (ddecay, "ddecay", (nc, H))):
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name}: {tuple(t.shape)} on {t.device}, need {shape} on {x.device}")
        grads.append(t.to(f32).contiguous())
    dy, dstates, ddecay = grads
    if x.device.type == "cpu":
        return ssd_chunk_backward_plain(x, dA, B, C, dy, dstates, ddecay)
    if x.device.type == "meta":
        grads = (torch.empty_like(x), torch.empty((nc, Q, H), dtype=f32, device=x.device),
                 torch.empty_like(B), torch.empty_like(C))
        # the plain formulas' products: S again, dx (two), dM, dC, dB (two)
        _mesh.note("ssd_chunk_backward", 2.0 * nc * H * (2 * Q * Q * P + 3 * Q * Q * N
                                                         + 2 * Q * P * N),
                   _mesh.nbytes(x, dA, B, C, dy, dstates, ddecay, *grads))
        return grads
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_backward runs on CUDA or the CPU, not {x.device}")
    if nc * G > MAX_GRID_Y:
        raise ValueError(f"chunks * groups = {nc * G} exceeds {MAX_GRID_Y}")
    lib = _bwd_lib()
    dev = x.device
    dx = torch.empty((nc, Q, H, P), dtype=x.dtype, device=dev)
    ddA = torch.empty((nc, Q, H), dtype=f32, device=dev)
    dB = torch.empty((nc, Q, G, N), dtype=B.dtype, device=dev)
    dC = torch.empty((nc, Q, G, N), dtype=C.dtype, device=dev)
    path = backward_route(x, B, C)
    is_bf16 = int(x.dtype == torch.bfloat16)
    n = (lib.ssd_chunk_bwd_tc_scratch_floats(nc, Q, H, G, P, is_bf16) if path == "tensor_cores"
         else lib.ssd_chunk_bwd_scratch_floats(nc, Q, H, G))
    scratch = torch.empty(n, dtype=f32, device=dev)
    if path == "tensor_cores":  # the tensor-core kernels read dy and dstates 16 bytes at a time
        dy, dstates = (t if t.data_ptr() % ALIGN == 0 else t.clone() for t in (dy, dstates))
    args = (x.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
            dstates.data_ptr(), ddecay.data_ptr(), dx.data_ptr(), ddA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), scratch.data_ptr(), n, nc, Q, H, G, P, N, *strides)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if path == "tensor_cores":
            rc = lib.ssd_chunk_bwd_tc_launch(*args, is_bf16, stream)
        else:
            rc = lib.ssd_chunk_bwd_launch(*args, is_bf16, stream)
    if rc != 0:
        msg = lib.ssd_chunk_bwd_error_string(rc).decode()
        raise RuntimeError(f"ssd_chunk_backward launch failed ({path}): CUDA error {rc} ({msg})")
    ssd_chunk_backward.launches += 1
    ssd_chunk_backward.route_launches[path] += 1
    return dx, ddA, dB, dC


BWD_KERNELS = {"cuda_cores": ("bwd_scores", "bwd_head", "bwd_dssum", "bwd_dc", "bwd_db"),
               "tensor_cores": ("tc::bwd_scores", "tc::bwd_dx", "tc::bwd_group", "bwd_dc")}


def backward_kernels(path: str, dtype: torch.dtype) -> tuple:
    """The kernels a backward call on ``path`` with inputs of ``dtype``
    launches, in order: f32 on the tensor cores runs ``tc::bwd_v`` (v = B
    dstates^T into the scratch) after ``tc::bwd_scores``."""
    names = BWD_KERNELS[path]
    if path == "tensor_cores" and dtype == torch.float32:
        names = names[:1] + ("tc::bwd_v",) + names[1:]
    return names


def backward_resources(P: int, dtype: torch.dtype, path: str = "cuda_cores",
                       N: int = MAX_N) -> dict:
    """Registers a thread and shared memory a block (static plus dynamic;
    the tensor-core kernels' at Q 256) of each of a backward route's kernels
    (``backward_kernels(path, dtype)``) at head dim P, state dim N (the
    tensor-core route's) and input ``dtype``."""
    out = {}
    lib = _bwd_lib()
    for which, name in enumerate(backward_kernels(path, dtype)):
        regs, smem = ctypes.c_int(0), ctypes.c_int(0)
        if path == "tensor_cores":
            rc = lib.ssd_chunk_bwd_tc_resources(which, int(dtype == torch.bfloat16), P, N,
                                                ctypes.byref(regs), ctypes.byref(smem))
        else:
            rc = lib.ssd_chunk_bwd_resources(which, int(dtype == torch.bfloat16), P,
                                             ctypes.byref(regs), ctypes.byref(smem))
        if rc != 0:
            raise RuntimeError(f"ssd_chunk_bwd_resources: CUDA error {rc}")
        out[name] = {"registers_at_launch": regs.value, "smem_bytes": smem.value}
    return out


def reset_launches() -> None:
    """Set ``ssd_chunk.launches``, ``ssd_chunk_backward.launches`` and
    their per-route counts to 0."""
    ssd_chunk.launches = 0
    ssd_chunk.route_launches = dict.fromkeys(ROUTES, 0)
    ssd_chunk_backward.launches = 0
    ssd_chunk_backward.route_launches = dict.fromkeys(ROUTES, 0)


reset_launches()


def resources(path: str, Q: int, P: int, N: int, dtype: torch.dtype) -> dict:
    """A route's registers a thread and shared memory a block (static plus
    dynamic) at chunk length Q, head dim P, state dim N and input ``dtype``
    (the tensor-core route's f32 kernel is the split one)."""
    regs, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = _lib().ssd_chunk_resources(int(path == "tensor_cores"), int(dtype == torch.bfloat16),
                                    Q, P, N, ctypes.byref(regs), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"ssd_chunk_resources: CUDA error {rc}")
    return {"registers_at_launch": regs.value, "smem_bytes": smem.value}
