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

On the card one rule, ``route``, picks the kernels of both directions from
dtype, shape and layout alone, before the launch.  Operands with P in
``TC_P``, N in ``TC_N``, 16-byte aligned data and 16-byte token strides go
to the wgmma kernels (``"tensor_cores"``): bf16 with M and x*w split into
bf16 hi + lo, each within 2^-17 of its f32 value; f32 to the split kernel,
which splits x, B and C as well and runs each product as three (hi.hi +
lo.hi + hi.lo).  Elsewhere (P off ``TC_P``, N off ``TC_N``, data or token
strides not 16-byte aligned): at chunks of at most ``ONE_PASS_MAX_Q``
tokens the one-pass kernel (``"one_pass"``: one launch, a block a chunk and
run of four heads of one group, a warp a head, mma.sync on the same split
pieces); longer chunks take the wgmma kernels on operands zero-padded to
the next head and state dims of ``TC_P`` and ``TC_N`` in fresh aligned
copies (``pad_operands``), the outputs cut back: zero columns add exact
zeros to every sum.  Nothing retries on another route: a failed build or
launch raises.  ``ssd_chunk.launches`` counts the CUDA launches,
``ssd_chunk.route_launches`` the same per route.

Under grad ``ssd_chunk`` goes through the autograd Function ``SSDChunk``,
whose backward ``ssd_chunk_backward`` launches ``csrc/ssd_chunk_bwd.cu``
on the card (f32 sums in a fixed order, no atomics; the JAX package
differentiates its plain ``ssd_chunked`` instead) and runs
``ssd_chunk_backward_plain`` on the CPU.  It takes the route the forward
takes (``route``): the wgmma kernels (the f32
operands dy, dstates, M = S * L, w * x and the group's sum of dS split into
bf16 hi + lo, and f32 x, B and C too, with v = B dstates^T computed into
the scratch by a kernel of its own), the one-pass kernel, or the wgmma
kernels on padded operands (``pad_to_tensor_cores``, the gradients cut back
by ``unpad_grads``).  ``ssd_chunk_backward.launches`` counts its launches,
``ssd_chunk_backward.route_launches`` the same per route.  Serving, under
``no_grad``, takes the bare forward.

All take cum in the cumsum-difference form of the JAX package's kernel
and reference, so they round alike; L is selected to 0 above the diagonal
before anything multiplies it (exp overflows there).  The kernels sum the
cumsum in a warp scan (the one-pass kernels a lane a token); a CUDA
``torch.cumsum`` sums in another order, so on the card they agree to the
f32 rounding of |cum|, not bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _mesh

DTYPES = (torch.float32, torch.bfloat16)
MAX_Q, MAX_P, MAX_N = 256, 64, 128
Q_STEP = 16  # chunk lengths are multiples of this
MAX_BLOCKS = 2**31 - 1  # the kernel's grid puts chunks * heads on its x axis
ROUTES = ("tensor_cores", "one_pass")  # both directions' (``route``)
TC_P, TC_N = (16, 32, 64), (16, 32, 64, 128)  # the tensor-core kernels' head and state dims
ALIGN = 16  # bytes: a base address and a token stride for TMA and 16-byte loads
ONE_PASS_MAX_Q = 32  # the one-pass kernels: chunks of at most 32 tokens
ONE_PASS_MAX_REP = 256  # and at most 256 heads a group

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build.build("ssd_chunk")))
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_chunk_launch.argtypes = [vp] * 7 + [i] * 6 + [ll] * 3 + [vp]
        lib.ssd_chunk_launch.restype = i
        lib.ssd_chunk_op_launch.argtypes = [vp] * 7 + [i] * 6 + [ll] * 3 + [i, vp]
        lib.ssd_chunk_op_launch.restype = i
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
    s0, s1, s2, s3 = t.stride()
    if not ((D == 1 or s3 == 1) and (K == 1 or s2 == D) and (nc == 1 or s0 == Q * s1)
            and s1 >= K * D):
        raise ValueError(f"{name}: layout {(s0, s1, s2, s3)} for shape {tuple(t.shape)} is not "
                         "(tokens evenly spaced, each token's (heads, dim) packed)")
    return s1


def _check_operands(x, dA, B, C):
    """Raise on what the kernels do not take, in one pass over the
    operands' shapes, types, devices and layouts; returns (nc, Q, H, G, P,
    N) and the token strides of x, B and C."""
    xs, As, Bs = x.shape, dA.shape, B.shape
    if len(xs) != 4 or len(As) != 3 or len(Bs) != 4 or C.dim() != 4:
        raise ValueError(f"need x (nc, Q, H, P), dA (nc, Q, H), B and C (nc, Q, G, N); got "
                         f"{tuple(xs)}, {tuple(As)}, {tuple(Bs)}, {tuple(C.shape)}")
    nc, Q, H, P = xs
    G, N = Bs[2], Bs[3]
    if As != (nc, Q, H) or C.shape != Bs or Bs[:2] != (nc, Q):
        raise ValueError(f"shapes disagree: x {tuple(xs)}, dA {tuple(As)}, B {tuple(Bs)}, "
                         f"C {tuple(C.shape)}")
    if nc < 1 or G < 1 or H % G != 0:
        raise ValueError(f"need nc >= 1 and H % G == 0, got nc={nc}, H={H}, G={G}")
    if Q % Q_STEP or not Q_STEP <= Q <= MAX_Q:
        raise ValueError(f"chunk length {Q} is not a multiple of {Q_STEP} in [{Q_STEP}, {MAX_Q}]")
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N):
        raise ValueError(f"head dim {P} or state dim {N} outside [1, {MAX_P}] / [1, {MAX_N}]")
    dt = x.dtype
    if dt not in DTYPES or B.dtype != dt or C.dtype != dt:
        raise ValueError(f"x, B, C must share one type of {DTYPES}, got {dt}, {B.dtype}, "
                         f"{C.dtype}")
    if dA.dtype != torch.float32 or not dA.is_contiguous():
        raise ValueError(f"dA must be contiguous float32, got {dA.dtype}")
    if nc * H > MAX_BLOCKS:
        raise ValueError(f"chunks * heads = {nc * H} exceeds {MAX_BLOCKS}")
    dev = x.device
    if dA.device != dev or B.device != dev or C.device != dev:
        raise ValueError(f"operands on {dA.device}, {B.device}, {C.device} and {dev}: all must "
                         "share one device")
    strides = (_token_stride(x, "x"), _token_stride(B, "B"), _token_stride(C, "C"))
    return nc, Q, H, G, P, N, strides


def _aligned(t) -> bool:
    """Whether operand ``t``'s data and token stride are 16-byte aligned
    (TMA's and the tensor-core kernels' 16-byte loads)."""
    return t.data_ptr() % ALIGN == 0 and t.stride(1) * t.element_size() % ALIGN == 0


def at_tensor_core_shapes(x, B, C) -> bool:
    """Whether the wgmma kernels take x, B and C as they are: P in TC_P,
    N in TC_N, data and token strides 16-byte aligned."""
    return x.shape[3] in TC_P and B.shape[3] in TC_N and all(map(_aligned, (x, B, C)))


def route(x, B, C) -> str:
    """The kernels a CUDA call takes, forward and backward alike, from
    dtype, shape and layout alone (operands already checked by
    ``_check_operands``): ``"tensor_cores"`` where ``at_tensor_core_shapes``
    holds; else ``"one_pass"`` at chunks of at most ``ONE_PASS_MAX_Q``
    tokens and ``ONE_PASS_MAX_REP`` heads a group; else ``"tensor_cores"``
    on the operands ``pad_operands`` makes."""
    if at_tensor_core_shapes(x, B, C):
        return "tensor_cores"
    Q, rep = x.shape[1], x.shape[2] // B.shape[2]
    return "one_pass" if Q <= ONE_PASS_MAX_Q and rep <= ONE_PASS_MAX_REP else "tensor_cores"


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
    forward.  On the card y_diag and states are contiguous views of one
    allocation (under grad, outputs of one Function: not to be changed in
    place)."""
    if torch.is_grad_enabled() and (x.requires_grad or dA.requires_grad or B.requires_grad
                                    or C.requires_grad):
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


def _outputs(nc: int, Q: int, H: int, P: int, N: int, dev):
    """(y_diag (nc, Q, H, P), states (nc, H, P, N), chunk_decay (nc, H)),
    f32 and contiguous on ``dev``, and their data pointers: y_diag and
    states views of one allocation (a reduced-shape call's host time is
    mostly its wrapper's, and there each allocation counts), chunk_decay
    one of its own.  ``ops.ssd``'s recurrence saves chunk_decay for the
    backward; were it a view of the same storage, y_diag and states would
    live on until the backward too."""
    n1 = nc * Q * H * P
    out = torch.empty(n1 + nc * H * P * N, dtype=torch.float32, device=dev)
    decay = torch.empty((nc, H), dtype=torch.float32, device=dev)
    base = out.data_ptr()
    return ((out.as_strided((nc, Q, H, P), (Q * H * P, H * P, P, 1)),
             out.as_strided((nc, H, P, N), (H * P * N, P * N, N, 1), n1), decay),
            (base, base + 4 * n1, decay.data_ptr()))


def _forward(x, dA, B, C):
    nc, Q, H, G, P, N, strides = _check_operands(x, dA, B, C)
    dev = x.device
    if dev.type == "cpu":
        return ssd_chunk_plain(x, dA, B, C)
    f32 = torch.float32
    if dev.type == "meta":
        outs = (torch.empty((nc, Q, H, P), dtype=f32, device=dev),
                torch.empty((nc, H, P, N), dtype=f32, device=dev),
                torch.empty((nc, H), dtype=f32, device=dev))
        _mesh.note("ssd_chunk", 2.0 * nc * H * (Q * Q * (N + P) + Q * P * N),
                   _mesh.nbytes(x, dA, B, C, *outs))
        return outs
    if dev.type != "cuda":
        raise ValueError(f"ssd_chunk runs on CUDA or the CPU, not {dev}")
    lib = _lib()
    path = route(x, B, C)
    Pk, Nk = P, N  # the head and state dims the kernel sees
    if path == "tensor_cores" and not at_tensor_core_shapes(x, B, C):
        x, B, C = pad_operands(x, B, C)
        Pk, Nk = x.shape[3], B.shape[3]
        strides = (x.stride(1), B.stride(1), C.stride(1))
    (y, states, decay), outs = _outputs(nc, Q, H, Pk, Nk, dev)
    ptrs = (x.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(), *outs)
    bf16 = x.dtype == torch.bfloat16
    with _build.on_device(dev) as stream:
        if path == "one_pass":
            rc = lib.ssd_chunk_op_launch(*ptrs, nc, Q, H, G, P, N, *strides, int(bf16), stream)
        elif bf16:
            rc = lib.ssd_chunk_launch(*ptrs, nc, Q, H, G, Pk, Nk, *strides, stream)
        else:
            n = ctypes.c_longlong(0)
            rc = lib.ssd_chunk_split_scratch(nc, Q, H, G, ctypes.byref(n))
            if rc == 0:
                scores = torch.empty(n.value, dtype=f32, device=dev)
                rc = lib.ssd_chunk_split_launch(*ptrs, scores.data_ptr(), n.value, nc, Q, H, G,
                                                Pk, Nk, *strides, stream)
    if rc != 0:
        msg = lib.ssd_chunk_error_string(rc).decode()
        raise RuntimeError(f"ssd_chunk launch failed ({path}): CUDA error {rc} ({msg})")
    ssd_chunk.launches += 1
    ssd_chunk.route_launches[path] += 1
    if Pk != P or Nk != N:
        y, states = unpad_outputs(y, states, P, N)
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
        lib.ssd_chunk_bwd_tc_launch.argtypes = [vp] * 12 + [ll] + [i] * 6 + [ll] * 3 + [i, vp]
        lib.ssd_chunk_bwd_tc_launch.restype = i
        lib.ssd_chunk_bwd_tc_scratch_floats.argtypes = [i] * 6
        lib.ssd_chunk_bwd_tc_scratch_floats.restype = ll
        lib.ssd_chunk_bwd_tc_resources.argtypes = [i, i, i, i, ip, ip]
        lib.ssd_chunk_bwd_tc_resources.restype = i
        lib.ssd_chunk_bwd_op_launch.argtypes = [vp] * 11 + [i] * 6 + [ll] * 3 + [i, vp]
        lib.ssd_chunk_bwd_op_launch.restype = i
        lib.ssd_chunk_bwd_op_resources.argtypes = [i] * 4 + [ip, ip]
        lib.ssd_chunk_bwd_op_resources.restype = i
        lib.ssd_chunk_bwd_error_string.argtypes = [i]
        lib.ssd_chunk_bwd_error_string.restype = ctypes.c_char_p
        _BWD_LIB = lib
    return _BWD_LIB


def _tc_width(n: int, dims: tuple) -> int:
    """The smallest of the tensor-core kernels' ``dims`` at least ``n``."""
    return next(d for d in dims if d >= n)


def _fit(t, width: int):
    """``t`` as the wgmma kernels take it at ``width`` in its last dim:
    unchanged where it is that wide and 16-byte aligned, else a fresh
    contiguous copy (zero-padded where narrower; 16-byte aligned, as
    every new allocation is)."""
    if t.shape[-1] == width and _aligned(t):
        return t
    if t.shape[-1] == width:  # misaligned: a fresh copy
        return t.clone(memory_format=torch.contiguous_format)
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def pad_operands(x, B, C):
    """(x, B, C) as the wgmma kernels take them: x zero-padded to the head
    dim ``_tc_width(P, TC_P)``, B and C to the state dim ``_tc_width(N,
    TC_N)``, each padded or misaligned operand in a fresh contiguous copy
    of its type; operands taken as they are pass unchanged.  A plain
    function of tensors on any device.  Zero columns of x, B and C add
    exact zeros to every sum of the forward and leave its cumsum as it
    was, so ``unpad_outputs`` of the padded call's outputs are the
    unpadded call's."""
    Pp, Np = _tc_width(x.shape[3], TC_P), _tc_width(B.shape[3], TC_N)
    return _fit(x, Pp), _fit(B, Np), _fit(C, Np)


def unpad_outputs(y, states, P: int, N: int):
    """(y_diag, states) of a padded forward call cut back to head dim
    ``P`` and state dim ``N``, contiguous."""
    return y[..., :P].contiguous(), states[..., :P, :N].contiguous()


def pad_to_tensor_cores(x, B, C, dy, dstates):
    """(x, B, C, dy, dstates) of a backward call as the tensor-core kernels
    take them: x, B and C as ``pad_operands`` makes them, dy zero-padded to
    x's head dim and dstates to both dims (a misaligned dstates in a fresh
    copy).  Zero columns of x, dy, B, C and dstates add exact zeros to
    every sum of the backward and leave dA's gradient as it was, so
    ``unpad_grads`` of the padded call's gradients are the unpadded
    call's."""
    P, N = x.shape[3], B.shape[3]
    x, B, C = pad_operands(x, B, C)
    Pp, Np = x.shape[3], B.shape[3]
    if dstates.shape[2:] != (Pp, Np):
        dstates = torch.nn.functional.pad(dstates, (0, Np - N, 0, Pp - P))
    elif dstates.data_ptr() % ALIGN:
        dstates = dstates.clone()
    return x, B, C, _fit(dy, Pp), dstates


def unpad_grads(grads, P: int, N: int):
    """(dx, ddA, dB, dC) of a padded call cut back to head dim ``P`` and
    state dim ``N``, contiguous (unchanged where nothing was padded)."""
    dx, ddA, dB, dC = grads
    if dx.shape[3] != P:
        dx = dx[..., :P].contiguous()
    if dB.shape[3] != N:
        dB, dC = dB[..., :N].contiguous(), dC[..., :N].contiguous()
    return dx, ddA, dB, dC


def ssd_chunk_backward(x, dA, B, C, dy, dstates, ddecay):
    """The gradient of ``ssd_chunk`` at (x, dA, B, C) (operands as
    ``ssd_chunk`` takes them) given the output gradients dy (nc, Q, H, P),
    dstates (nc, H, P, N) and ddecay (nc, H).  Returns (dx, ddA, dB, dC):
    dx, dB and dC in their inputs' types (contiguous), ddA float32.  A CUDA
    tensor launches the ``route`` kernels of
    ``csrc/ssd_chunk_bwd.cu`` (or raises), a CPU tensor runs
    ``ssd_chunk_backward_plain``.  ``ssd_chunk_backward.launches`` counts the
    CUDA launches, ``ssd_chunk_backward.route_launches`` the same per
    route."""
    nc, Q, H, G, P, N, _strides = _check_operands(x, dA, B, C)
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
    path = route(x, B, C)
    if path == "one_pass":
        return _one_pass(lib, x, dA, B, C, dy, dstates, ddecay)
    x, B, C, dy, dstates = pad_to_tensor_cores(x, B, C, dy, dstates)
    Pp, Np = x.shape[3], B.shape[3]
    strides = [t.stride(1) for t in (x, B, C)]
    dx = torch.empty((nc, Q, H, Pp), dtype=x.dtype, device=dev)
    ddA = torch.empty((nc, Q, H), dtype=f32, device=dev)
    dB = torch.empty((nc, Q, G, Np), dtype=B.dtype, device=dev)
    dC = torch.empty((nc, Q, G, Np), dtype=C.dtype, device=dev)
    is_bf16 = int(x.dtype == torch.bfloat16)
    n = lib.ssd_chunk_bwd_tc_scratch_floats(nc, Q, H, G, Pp, is_bf16)
    scratch = torch.empty(n, dtype=f32, device=dev)
    args = (x.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
            dstates.data_ptr(), ddecay.data_ptr(), dx.data_ptr(), ddA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), scratch.data_ptr(), n, nc, Q, H, G, Pp, Np, *strides)
    with _build.on_device(dev) as stream:
        rc = lib.ssd_chunk_bwd_tc_launch(*args, is_bf16, stream)
    if rc != 0:
        msg = lib.ssd_chunk_bwd_error_string(rc).decode()
        raise RuntimeError(f"ssd_chunk_backward launch failed ({path}): CUDA error {rc} ({msg})")
    ssd_chunk_backward.launches += 1
    ssd_chunk_backward.route_launches[path] += 1
    return unpad_grads((dx, ddA, dB, dC), P, N)


def _one_pass(lib, x, dA, B, C, dy, dstates, ddecay):
    """``ssd_chunk_backward`` on the one-pass kernel (``route`` says
    ``"one_pass"``): operands as they came, one launch, no scratch."""
    nc, Q, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    dev = x.device
    dx = torch.empty((nc, Q, H, P), dtype=x.dtype, device=dev)
    ddA = torch.empty((nc, Q, H), dtype=torch.float32, device=dev)
    dB = torch.empty((nc, Q, G, N), dtype=B.dtype, device=dev)
    dC = torch.empty((nc, Q, G, N), dtype=C.dtype, device=dev)
    with _build.on_device(dev) as stream:
        rc = lib.ssd_chunk_bwd_op_launch(
            x.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
            dstates.data_ptr(), ddecay.data_ptr(), dx.data_ptr(), ddA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), nc, Q, H, G, P, N, x.stride(1), B.stride(1), C.stride(1),
            int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        msg = lib.ssd_chunk_bwd_error_string(rc).decode()
        raise RuntimeError(f"ssd_chunk_backward launch failed (one_pass): CUDA error {rc} ({msg})")
    ssd_chunk_backward.launches += 1
    ssd_chunk_backward.route_launches["one_pass"] += 1
    return dx, ddA, dB, dC


BWD_KERNELS = {"tensor_cores": ("tc::bwd_scores", "tc::bwd_dx", "tc::bwd_group", "bwd_dc"),
               "one_pass": ("op::bwd_chunk",)}


def backward_kernels(path: str, dtype: torch.dtype) -> tuple:
    """The kernels a backward call on ``path`` with inputs of ``dtype``
    launches, in order: f32 on the wgmma route runs ``tc::bwd_v`` (v = B
    dstates^T into the scratch) after ``tc::bwd_scores``."""
    names = BWD_KERNELS[path]
    if path == "tensor_cores" and dtype == torch.float32:
        names = names[:1] + ("tc::bwd_v",) + names[1:]
    return names


def backward_resources(P: int, dtype: torch.dtype, path: str = "tensor_cores",
                       N: int = MAX_N, Q: int = ONE_PASS_MAX_Q, rep: int = 1) -> dict:
    """Registers a thread and shared memory a block (static plus dynamic)
    of each of a backward route's kernels (``backward_kernels(path,
    dtype)``) at head dim P, state dim N and input ``dtype``: the wgmma
    kernels' at Q 256, the one-pass kernel's at chunk length Q and ``rep``
    heads a group."""
    out = {}
    lib = _bwd_lib()
    is_bf16 = int(dtype == torch.bfloat16)
    for which, name in enumerate(backward_kernels(path, dtype)):
        regs, smem = ctypes.c_int(0), ctypes.c_int(0)
        if path == "one_pass":
            rc = lib.ssd_chunk_bwd_op_resources(is_bf16, Q, N, rep, ctypes.byref(regs),
                                                ctypes.byref(smem))
        else:
            rc = lib.ssd_chunk_bwd_tc_resources(which, is_bf16, P, N, ctypes.byref(regs),
                                                ctypes.byref(smem))
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
    (the tensor-core route's f32 kernel is the split one; P and N there
    are the dims the kernel sees, after any padding)."""
    regs, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = _lib().ssd_chunk_resources(int(path == "one_pass"), int(dtype == torch.bfloat16), Q, P,
                                    N, ctypes.byref(regs), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"ssd_chunk_resources: CUDA error {rc}")
    return {"registers_at_launch": regs.value, "smem_bytes": smem.value}
