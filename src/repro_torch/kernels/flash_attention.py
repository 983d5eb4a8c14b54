"""Blockwise causal or full GQA attention: the ``flash_attention`` kernel wrapper.

The dense transformer's prefill and forward send every causal, unwindowed,
full-length attention here (``models/layers.py::mha``).  For q (B, Sq, H, D)
and k, v (B, Sk, K, D) with H % K == 0, query head h attends to KV head
h // (H // K):

    s = (f32(q) * scale) @ f32(k)^T,  masked to -1e30 where causal and k > q
    o = softmax(s) @ v   (p cast to v's type before the product, f32 sums)

and the output comes back in q's type.  ``flash_attention`` takes its route
from the tensors' device: a CUDA tensor launches the hand-written kernel in
``csrc/flash_attention.cu`` (or raises), a CPU tensor runs
``flash_attention_plain``, the same function in plain PyTorch.

On the card every forward call takes the tensor cores (``route`` says
``"tensor_cores"``): bf16 as it is, f32 at every head dim as bf16 pieces
(the split route; at D = 256 one 64-row consumer warpgroup a block, 32-row
KV tiles in separate K and V rings, and P.V in two column halves).
Nothing retries on another route: a failed build or launch raises.
``flash_attention.launches`` counts the CUDA launches,
``flash_attention.route_launches`` the same per route.

Short sequences in bf16 (a transformer UDF's 8 tokens; ``packed_plan``
says which) take the packed route (``"packed"``) forward and backward
instead: a 128-row tile there would hold 8 rows of one (batch, head).  A
unit is one (record b, KV head kv), its q rows the G = H / K heads of the
group at every position in the order of ``q.reshape(B, Sq, K, G, D)`` (row
(s, g)); a tile holds U whole units (or, where a unit is longer than a
tile, P positions of one), and its keys are the U units' keys, masked
block-diagonally (and causally within a unit).  All of a tile's keys fit
one key tile, so the forward needs no online softmax; the backward's block
holds U units' keys and every row that attends them, so one pass computes
Di, P, dS, dQ, and dK and dV summed over its rows in a fixed order.

The kernels keep a running row max and sum (an online softmax) and divide
once at the end, as the Pallas kernel does; the plain version takes the
whole row at once.  In bf16 the kernel runs both products on the tensor
cores (wgmma, f32 accumulation: exact bf16 products, so the reference's f32
scores up to the order of summation) with q unscaled and the scale folded
into ``exp2``.  In f32 the tensor-core route splits every operand into bf16
hi, mid and lo pieces (K and V by ``split_bf16`` beforehand, q inside the
kernel, p in registers), together within 2^-25 of the f32 value, and runs
each product as six products of pieces (every pair but mid.lo, lo.mid and
lo.lo).
Both sum in f32 in different orders, and in bf16 they round p to bf16
against different running maxima, so they agree to about 1e-6 in f32 and to
bf16's precision in bf16.  The tensor-core kernels read their operands with
TMA, which needs 16-byte aligned data pointers; the wrapper refuses others
on every device and every route.

The row log-sum-exp (``return_lse=True``): lse[b, h, i] = log sum_j
exp(s[i, j]) over the unmasked keys j, the natural log of the scaled scores
s above, f32, shape (B, H, Sq).  Every forward route writes it when asked
(the kernels from their running max and sum; serving does not ask, and its
kernels then take the same path as before), and ``flash_attention_plain``
returns the same.

Gradients: whenever grad is enabled and q, k or v requires it,
``flash_attention`` goes through ``FlashAttention`` (a
``torch.autograd.Function``).  Its forward is the route above and keeps
the lse; its backward is ``flash_attention_backward``: on the card the
hand-written kernels of ``csrc/flash_attention_bwd.cu``, on the CPU
``flash_attention_backward_plain``, the same formulas in plain PyTorch.
``backward_route`` picks the card's kernels before the launch: the packed
route where the forward takes it, else the tensor cores at every head dim
(``"tensor_cores"``): bf16 as wgmma with bf16 P and dS as operands and f32
sums, f32 on the split route (``split_bf16`` cuts q, k, v and dO into bf16
hi, mid and lo pieces first, P and dS are split in registers, and each
product runs as six products of pieces, as the forward's f32 route does;
at D 256 the pieces stream through the kernels in 64-column chunks of the
head dim; below D 64 the tiles take the forward's narrower swizzle).  Both
read the forward's lse, compute Di = rowsum(dO * O) in a pre-pass, then
dK/dV with one block owning a KV tile across its query-head group and dQ
with one block a q tile: no atomics, so two calls give the same bits.
``flash_attention.backward_launches`` counts
the backward's CUDA calls (one a call, three kernels each, after the split
route's pre-pass over q, k, v and dO in one launch, which
``split_bf16.launches`` counts), ``flash_attention.backward_route_launches``
the same per route.
``flash_attention_plain`` itself cannot be differentiated (it works on its
scores in place): it stays the forward's oracle.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import _build, _mesh

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
NEG_INF = -1e30
MAX_BATCH_HEADS = 2**31 - 1  # batch * heads the C entries take: every grid's x dim
ALIGN = 16  # bytes: TMA's alignment of a tensor's base address
ROUTES = ("tensor_cores", "packed")
BWD_FLOPS_FACTOR = 2.5  # FlashAttention-2's count: the backward is 2.5 forwards
TC_BWD_ROW_ALIGN = 64  # its scratch rows: Sq padded to a stage's q rows (tc::kRows in the .cu)
_KERNEL_CODE = {torch.bfloat16: 1, torch.float32: 2}  # the C entry's resource selector
PACKED_ROWS = 128  # q rows a packed tile (packed::kRows in csrc/hopper.cuh)
PACKED_MAX_SEQ = 64  # the longest Sq and Sk the packed route takes
PACKED_KEYS = (16, 32, 64)  # key columns a packed tile: the kernels' N instantiations
PACKED_MAX_KEYS = {16: 64, 32: 64, 64: 64, 128: 64, 256: 32}  # N's largest at each head dim

_LIB = None
_BWD_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build.build("flash_attention")))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [vp] * 5 + [i] * 7 + [ctypes.c_float, vp]
        lib.flash_attention_launch.restype = i
        pieces = ctypes.c_void_p * 3
        lib.flash_attention_split_launch.argtypes = [vp, pieces, pieces, vp, vp] + [i] * 7 + [
            ctypes.c_float, vp]
        lib.flash_attention_split_launch.restype = i
        lib.split_bf16_launch.argtypes = [vp] * 4 + [ctypes.c_longlong, vp]
        lib.split_bf16_launch.restype = i
        ip = ctypes.POINTER(ctypes.c_int)
        lib.flash_attention_resources.argtypes = [i, i, ip, ip]
        lib.flash_attention_resources.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_packed_launch.argtypes = [vp] * 5 + [i] * 11 + [ctypes.c_float, vp]
        lib.flash_attention_packed_launch.restype = i
        lib.flash_attention_packed_resources.argtypes = [i, i, i, ip, ip, ip]
        lib.flash_attention_packed_resources.restype = i
        _LIB = lib
    return _LIB


def _bwd_lib() -> ctypes.CDLL:
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = ctypes.CDLL(str(_build.build("flash_attention_bwd")))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_bwd_tc_launch.argtypes = [vp] * 10 + [i] * 7 + [ctypes.c_float, vp]
        lib.flash_attention_bwd_tc_launch.restype = i
        lib.flash_attention_bwd_split_launch.argtypes = [vp] * 11 + [i] * 7 + [ctypes.c_float,
                                                                                vp]
        lib.flash_attention_bwd_split_launch.restype = i
        ip = ctypes.POINTER(ctypes.c_int)
        lib.flash_attention_bwd_resources.argtypes = [i, i, i, ip, ip, ip]
        lib.flash_attention_bwd_resources.restype = i
        lib.flash_attention_bwd_error_string.argtypes = [i]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        lib.flash_attention_bwd_packed_launch.argtypes = [vp] * 9 + [i] * 11 + [ctypes.c_float,
                                                                                vp]
        lib.flash_attention_bwd_packed_launch.restype = i
        lib.flash_attention_bwd_packed_resources.argtypes = [i, i, ip, ip, ip]
        lib.flash_attention_bwd_packed_resources.restype = i
        _BWD_LIB = lib
    return _BWD_LIB


def _check_operands(q, k, v):
    """Raise on what the kernel does not take; returns (B, Sq, Sk, H, K, D)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-D (B, S, heads, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k and v must both be (B={B}, Sk, K, D={D}), got {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    if Sq < 1 or Sk < 1 or K < 1 or H % K != 0:
        raise ValueError(f"need Sq, Sk >= 1 and H % K == 0, got Sq={Sq}, Sk={Sk}, H={H}, K={K}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one type of {DTYPES}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if B * H > MAX_BATCH_HEADS:
        raise ValueError(f"batch * heads = {B * H} exceeds {MAX_BATCH_HEADS}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"operands on {t.device} and {q.device}: all must share one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention operands must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name}'s data pointer is not {ALIGN}-byte aligned")
    return B, Sq, Sk, H, K, D


@dataclasses.dataclass(frozen=True)
class PackedPlan:
    """How the packed route lays a call out (``packed_plan``)."""
    U: int  # records a tile: U whole units (1 where a unit spans tiles)
    P: int  # positions a tile: Sq, or a unit's share of a tile where it spans several
    tiles: int  # tiles a unit (the backward's bands, in order)
    rows: int  # q rows a tile holds: G * P * U
    keys: int  # key rows a tile holds: U * Sk
    N: int  # key columns of a tile: keys rounded up to one of PACKED_KEYS
    groups: int  # tiles across the batch: ceil(B / U)
    blocks: int  # the forward's grid: groups * K * tiles
    bwd_blocks: int  # the backward's grid: groups * K


@functools.lru_cache(maxsize=256)
def packed_plan(B: int, Sq: int, Sk: int, H: int, K: int, D: int,
                dtype: torch.dtype) -> PackedPlan | None:
    """The packed route's layout of a call, or None where the call does not
    take that route.  It takes bf16 with Sq and Sk at most PACKED_MAX_SEQ
    and Sk at most PACKED_MAX_KEYS[D] (a group of at most PACKED_ROWS
    heads): a unit (one record's KV head: G = H / K heads at Sq positions,
    G * Sq rows) is short, so a tile holds U = PACKED_ROWS // (G * Sq) of
    them, no more than PACKED_MAX_KEYS[D] keys and no more than B records;
    a unit longer than a tile spans ceil(Sq / P) tiles of P =
    PACKED_ROWS // G positions.  The kernels take exactly this plan
    (``packed::bad_geo`` in csrc/hopper.cuh refuses any other)."""
    if (dtype != torch.bfloat16 or D not in PACKED_MAX_KEYS or K < 1 or H % K
            or min(B, Sq, Sk) < 1):
        return None
    G, max_keys = H // K, PACKED_MAX_KEYS[D]
    if Sq > PACKED_MAX_SEQ or Sk > min(PACKED_MAX_SEQ, max_keys) or G > PACKED_ROWS:
        return None
    if G * Sq <= PACKED_ROWS:
        U, P, tiles = min(PACKED_ROWS // (G * Sq), max_keys // Sk, B), Sq, 1
    else:
        U, P = 1, PACKED_ROWS // G
        tiles = -(-Sq // P)
    N = next(n for n in PACKED_KEYS if n >= U * Sk)
    groups = -(-B // U)
    return PackedPlan(U=U, P=P, tiles=tiles, rows=G * P * U, keys=U * Sk, N=N, groups=groups,
                      blocks=groups * K * tiles, bwd_blocks=groups * K)


def route_for(D: int, dtype: torch.dtype, shape: tuple | None = None) -> str:
    """The kernel a CUDA call of head dim ``D`` and ``dtype`` takes: the
    packed route where ``shape`` (B, Sq, Sk, H, K) is short enough for
    ``packed_plan``, else the tensor cores at every head dim in both types
    (f32 on the split route)."""
    if D not in HEAD_DIMS or dtype not in DTYPES:
        raise ValueError(f"no forward route for head dim {D} in {dtype}")
    if shape is not None and packed_plan(*shape, D, dtype) is not None:
        return "packed"
    return "tensor_cores"


def route(q, k, v) -> str:
    """The kernel a CUDA call takes, from dtype, head dim and the lengths
    (operands already checked by ``_check_operands``, which refuses a layout
    or an alignment that no route takes)."""
    B, Sq, H, D = q.shape
    return route_for(D, q.dtype, (B, Sq, k.shape[1], H, k.shape[2]))


def split_bf16_plain(t):
    """(hi, mid, lo) bf16 of an f32 tensor: hi = bf16(t), mid = bf16(t -
    hi), lo = bf16(t - hi - mid), each rounded to nearest even (every
    difference is exact in f32); |t - hi - mid - lo| <= 2^-25 |t|, and
    |t - hi - mid| <= 2^-17 |t|."""
    hi = t.to(torch.bfloat16)
    rest = t - hi.to(torch.float32)
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.to(torch.float32)).to(torch.bfloat16)


def split_bf16(t):
    """``split_bf16_plain`` of a contiguous f32 tensor: a CUDA tensor
    launches ``split_bf16_segments`` (bit for bit the plain version), a CPU
    tensor runs the plain version.  Returns (hi, mid, lo), bf16 of t's
    shape.  ``split_bf16.launches`` counts the launches."""
    if t.dtype != torch.float32 or not t.is_contiguous() or t.numel() == 0:
        raise ValueError(f"split_bf16 takes a non-empty contiguous float32 tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.data_ptr() % ALIGN:
        raise ValueError(f"split_bf16: data pointer is not {ALIGN}-byte aligned")
    if t.device.type == "cpu":
        return split_bf16_plain(t)
    if t.device.type != "cuda":
        raise ValueError(f"split_bf16 runs on CUDA or the CPU, not {t.device}")
    lib = _lib()
    n = t.numel()
    out = torch.empty((3, -(-n // 8) * 8), dtype=torch.bfloat16, device=t.device)  # 16 B rows
    pieces = tuple(out[i, :n].view(t.shape) for i in range(3))
    with _build.on_device(t.device) as stream:
        rc = lib.split_bf16_launch(t.data_ptr(), *(x.data_ptr() for x in pieces), n, stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"split_bf16 launch failed: CUDA error {rc} ({msg})")
    split_bf16.launches += 1
    return pieces


split_bf16.launches = 0


PLAIN_SCORES = 2**24  # f32 scores the plain versions hold at once (at least one row's)


def _row_chunks(B: int, per_row: int):
    """Batch slices of the plain versions: as many rows a step as keep
    their ``per_row`` f32 scores within PLAIN_SCORES, at least one."""
    rows = max(1, PLAIN_SCORES // max(per_row, 1))
    return [slice(b, min(b + rows, B)) for b in range(0, B, rows)]


def flash_attention_plain(q, k, v, *, causal: bool = True, scale: float | None = None,
                          return_lse: bool = False):
    """The same function as the kernel in plain PyTorch (the CPU route and
    the on-card reference).  A few batch rows at a time (``_row_chunks``),
    so that at most PLAIN_SCORES f32 scores, or one row's (H, Sq, Sk), are
    held at once.  With ``return_lse`` also each row's log-sum-exp (the
    module's convention): (out, lse)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    keep = None
    if causal:
        keep = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
    for rows in _row_chunks(B, H * Sq * Sk):
        n = rows.stop - rows.start
        qg = (q[rows].to(torch.float32) * scale).reshape(n, Sq, K, G, D)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, k[rows].to(torch.float32))
        if keep is not None:
            s.masked_fill_(~keep, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = s.sub_(m).exp_()
        l = p.sum(dim=-1)  # (n, K, G, Sq)
        if lse is not None:
            lse[rows] = (m[..., 0] + torch.log(l)).reshape(n, H, Sq)
        o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).to(torch.float32),
                         v[rows].to(torch.float32))
        o = o / l.clamp_min(1e-20).permute(0, 3, 1, 2)[..., None]
        out[rows] = o.reshape(n, Sq, H, D).to(q.dtype)
    return (out, lse) if return_lse else out


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    return_lse: bool = False):
    """q: (B, Sq, H, D); k, v: (B, Sk, K, D), H % K == 0, one type of
    float32 or bfloat16, D in ``HEAD_DIMS``, contiguous.  Returns
    (B, Sq, H, D) in q's type.  ``scale`` defaults to 1/sqrt(D).  The
    causal mask aligns both sequences at position 0.  All tensors share one
    device, which picks the route: CUDA launches the kernel, CPU runs
    ``flash_attention_plain``.  With grad enabled and an operand that
    requires it, the call goes through ``FlashAttention``, whose backward
    is ``flash_attention_backward``.  ``return_lse``: also return each
    row's log-sum-exp, (B, H, Sq) f32 (the module's convention), as
    (out, lse).  DTensor operands (under a device mesh) run the call on
    each device's shard (``kernels/_mesh.py``); "meta" ones give the
    outputs' shapes and run nothing."""
    if _mesh.is_dtensor(q):
        return _on_mesh(q, k, v, causal, scale, return_lse)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out, lse = FlashAttention.apply(q, k, v, causal, scale)
        return (out, lse) if return_lse else out
    return _attend(q, k, v, causal, scale, want_lse=return_lse)


def _attend(q, k, v, causal: bool, scale: float | None, want_lse: bool = False):
    """The forward on q's device: the kernel on CUDA, the plain version on
    the CPU.  Returns out, or (out, lse) when ``want_lse``."""
    B, Sq, Sk, H, K, D = _check_operands(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale, return_lse=want_lse)
    if q.device.type == "meta":
        out = torch.empty_like(q)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        _mesh.note("flash_attention", _flops(B, Sq, Sk, H, D, causal),
                   _mesh.nbytes(q, k, v, out, lse if want_lse else None))
        return (out, lse) if want_lse else out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not {q.device}")
    path = route(q, k, v)
    lib = _lib()
    split = q.dtype == torch.float32
    if split:
        kp, vp = split_bf16(k), split_bf16(v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if want_lse else None
    lse_ptr = lse.data_ptr() if want_lse else None  # null: the kernel writes no lse
    with _build.on_device(q.device) as stream:
        if path == "packed":
            plan = packed_plan(B, Sq, Sk, H, K, D, q.dtype)
            rc = lib.flash_attention_packed_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr, B, Sq, Sk, H,
                K, D, plan.U, plan.P, plan.tiles, plan.N, int(causal), scale, stream)
        elif split:
            ptrs = ctypes.c_void_p * 3
            rc = lib.flash_attention_split_launch(
                q.data_ptr(), ptrs(*(t.data_ptr() for t in kp)),
                ptrs(*(t.data_ptr() for t in vp)), out.data_ptr(), lse_ptr, B, Sq, Sk, H, K, D,
                int(causal), scale, stream)
        else:
            rc = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr, B, Sq, Sk, H,
                K, D, int(causal), scale, stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed ({path}): CUDA error {rc} ({msg})")
    flash_attention.launches += 1
    flash_attention.route_launches[path] += 1
    return (out, lse) if want_lse else out


def _flops(B, Sq, Sk, H, D, causal: bool) -> float:
    """The forward's products: 2 flops a multiply-add, two products (S and
    P.V) over the (q, k) pairs it computes (the causal kernel skips the
    masked half)."""
    pairs = Sq * (Sq + 1) // 2 if causal and Sq == Sk else Sq * Sk
    return 4.0 * B * H * D * pairs


def _on_mesh(q, k, v, causal: bool, scale, return_lse: bool):
    """``flash_attention`` on each device's shard of DTensor q, k, v:
    batch over the batch axes, heads over "model" (KV heads replicated and
    selected per rank where they do not divide it; ``kernels/_mesh.py``)."""
    mesh = q.device_mesh
    B, _, H, _ = q.shape
    K = k.shape[2]
    q_spec, kv_spec, select = _mesh.head_layout(mesh, B, H, K)
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)

    def local(ql, kl, vl):
        if select:
            idx, _ = _mesh.local_groups(H, K, tp, mesh.get_local_rank("model"))
            kl, vl = kl.index_select(2, idx.to(kl.device)), vl.index_select(2, idx.to(kl.device))
        return flash_attention(ql.contiguous(), kl.contiguous(), vl.contiguous(), causal=causal,
                               scale=scale, return_lse=return_lse)

    grad = "partial" if select else None
    outs = (q_spec, (q_spec[0], q_spec[2], None)) if return_lse else (q_spec,)
    return _mesh.local_call(local, mesh, (q, k, v), (q_spec, kv_spec, kv_spec),
                            (None, grad, grad), outs)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward returns and saves
    the output and its row lse (not differentiable) with q, k and v; the
    backward runs ``flash_attention_backward`` on them and the output's
    gradient (the kernel on the card, the plain formulas on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _attend(q, k, v, causal, scale, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.causal, ctx.scale = causal, scale
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout.contiguous(), lse,
                                              causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_backward_plain(q, k, v, out, dout, *, causal: bool = True,
                                   scale: float | None = None):
    """The backward's formulas in plain PyTorch (the CPU route and the
    on-card reference), one KV head and a few batch rows at a time
    (``_row_chunks``: at most PLAIN_SCORES f32 scores of the group, or one
    row's (G, Sq, Sk), a step), all in f32:
    s = (q * scale) @ k^T masked as the forward masks it, p = exp(s -
    logsumexp(s)), Di = rowsum(dO * O), dP = dO @ v^T, dS = p * (dP - Di),
    dV = p^T @ dO with p rounded to v's type (as the forward rounds it
    before P.V), dK = dS^T @ (q * scale), dQ = scale * dS @ k.  Returns
    (dq, dk, dv) in the operands' type.  The log-sum-exp is recomputed
    from the scores, so the reference does not depend on the forward's."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    f32 = torch.float32
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    keep = None
    if causal:
        keep = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
    for kh in range(K):
        heads = slice(kh * G, (kh + 1) * G)
        for rows in _row_chunks(B, G * Sq * Sk):
            qs = q[rows, :, heads].to(f32).permute(0, 2, 1, 3) * scale  # (n, G, Sq, D)
            g = dout[rows, :, heads].to(f32).permute(0, 2, 1, 3)
            o = out[rows, :, heads].to(f32).permute(0, 2, 1, 3)
            kf, vf = k[rows, :, kh, None].to(f32), v[rows, :, kh, None].to(f32)  # (n, Sk, 1, D)
            kf, vf = kf.permute(0, 2, 1, 3), vf.permute(0, 2, 1, 3)  # (n, 1, Sk, D)
            s = qs @ kf.transpose(-1, -2)
            if keep is not None:
                s = s.masked_fill(~keep, NEG_INF)
            p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
            di = (g * o).sum(dim=-1, keepdim=True)
            ds = p * (g @ vf.transpose(-1, -2) - di)
            pv = p.to(v.dtype).to(f32)
            dv[rows, :, kh] = torch.einsum("ngqs,ngqd->nsd", pv, g).to(v.dtype)
            dk[rows, :, kh] = torch.einsum("ngqs,ngqd->nsd", ds, qs).to(k.dtype)
            dq[rows, :, heads] = ((ds @ kf) * scale).permute(0, 2, 1, 3).to(q.dtype)
    return dq, dk, dv


def backward_route(D: int, dtype: torch.dtype, shape: tuple | None = None) -> str:
    """The backward kernels a CUDA call of head dim ``D`` and ``dtype``
    takes: the packed kernel where ``shape`` (B, Sq, Sk, H, K) is short
    enough for ``packed_plan`` (the forward's rule), else the tensor cores
    (f32 on the split route)."""
    if D not in HEAD_DIMS or dtype not in DTYPES:
        raise ValueError(f"no backward route for head dim {D} in {dtype}")
    if shape is not None and packed_plan(*shape, D, dtype) is not None:
        return "packed"
    return "tensor_cores"


def flash_attention_backward(q, k, v, out, dout, lse=None, *, causal: bool = True,
                             scale: float | None = None):
    """Gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` = ``out``
    for the output gradient ``dout``.  Operands as ``flash_attention``
    takes them; ``out`` and ``dout`` (B, Sq, H, D) contiguous, of q's type;
    ``lse`` the forward's row log-sum-exp, (B, H, Sq) f32 contiguous
    (``flash_attention(..., return_lse=True)``).  A CUDA tensor launches
    the ``backward_route`` kernels of ``csrc/flash_attention_bwd.cu``, which
    need ``lse`` (or raises); a CPU tensor runs
    ``flash_attention_backward_plain``, which recomputes it.  On the split
    route (f32 on the tensor cores) the same C call first cuts q, k, v and
    dout into their bf16 pieces (one launch over the four, counted in
    ``split_bf16.launches``)."""
    B, Sq, Sk, H, K, D = _check_operands(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(q.shape)} {q.dtype} on {q.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if lse is not None and (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
                            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be ({B}, {H}, {Sq}) float32 contiguous on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, out, dout, causal=causal, scale=scale)
    if q.device.type == "meta":
        grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        _mesh.note("flash_attention_backward",
                   BWD_FLOPS_FACTOR * _flops(B, Sq, Sk, H, D, causal),
                   _mesh.nbytes(q, k, v, out, dout, lse, *grads))
        return grads
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward runs on CUDA or the CPU, not {q.device}")
    if lse is None:
        raise ValueError("flash_attention_backward on CUDA needs the forward's lse")
    path = backward_route(D, q.dtype, (B, Sq, Sk, H, K))
    # dout goes through TMA on both routes; the packed kernel reads out 16 bytes a load
    aligned = {"tensor_cores": {"dout": dout}, "packed": {"dout": dout, "out": out}}
    for name, t in aligned.get(path, {}).items():
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name}'s data pointer is not {ALIGN}-byte aligned")
    lib = _bwd_lib()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if path == "packed":  # one kernel, one pass: no scratch
        plan = packed_plan(B, Sq, Sk, H, K, D, q.dtype)
        with _build.on_device(q.device) as stream:
            rc = lib.flash_attention_bwd_packed_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, K, D,
                plan.U, plan.P, plan.tiles, plan.N, int(causal), scale, stream)
        _count_backward(lib, rc, path)
        return dq, dk, dv
    split = q.dtype == torch.float32
    rows = -(-Sq // TC_BWD_ROW_ALIGN) * TC_BWD_ROW_ALIGN
    if B * H * rows > MAX_BATCH_HEADS:  # the scratch's rows are counted in an int
        raise ValueError(f"batch * heads * rows = {B * H * rows} exceeds {MAX_BATCH_HEADS}")
    # one scratch allocation (a host call costs as much as these kernels at
    # small shapes): the (2, B, H, rows) f32 lse and Di rows, then on the
    # split route the bf16 pieces of q, k, v and dout (rows * 8 bytes keep
    # them 16-byte aligned)
    stats_bytes = 8 * B * H * rows
    pieces_bytes = 6 * (2 * q.numel() + 2 * k.numel()) if split else 0
    scratch = torch.empty(stats_bytes + pieces_bytes, dtype=torch.uint8, device=q.device)
    stats = scratch.data_ptr()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), stats, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Sq, Sk, H, K, D, int(causal))
    with _build.on_device(q.device) as stream:
        if split:  # q, k, v, dout's bf16 pieces: one split_bf16 launch in the same call
            rc = lib.flash_attention_bwd_split_launch(*args[:7], stats + stats_bytes, *args[7:],
                                                      scale, stream)
        else:
            rc = lib.flash_attention_bwd_tc_launch(*args, scale, stream)
    _count_backward(lib, rc, path)
    if split:
        split_bf16.launches += 1
    return dq, dk, dv


def _count_backward(lib, rc: int, path: str) -> None:
    """Raise on a failed backward launch, else count it on ``path``."""
    if rc != 0:
        msg = lib.flash_attention_bwd_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_backward launch failed ({path}): CUDA error {rc} "
                           f"({msg})")
    flash_attention.backward_launches += 1
    flash_attention.backward_route_launches[path] += 1


def reset_launches() -> None:
    """Set ``flash_attention.launches``, its per-route counts,
    ``flash_attention.backward_launches``, its per-route counts and
    ``split_bf16.launches`` to 0."""
    flash_attention.launches = 0
    flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
    flash_attention.backward_launches = 0
    flash_attention.backward_route_launches = dict.fromkeys(ROUTES, 0)
    split_bf16.launches = 0


reset_launches()


def resources(D: int, dtype: torch.dtype, shape: tuple | None = None) -> dict:
    """The registers a thread at launch and shared memory a block (static
    plus dynamic) of the kernel that head dim ``D``, ``dtype`` and ``shape``
    (B, Sq, Sk, H, K; see ``route_for``) route to, with that route.  With
    two consumer warpgroups (every tensor-core kernel but f32 at D 256) the
    kernel then moves registers between its warpgroups with ``setmaxnreg``:
    240 a consumer thread, 24 a producer thread.  The packed kernel (256
    threads, no transfer) also gives its local memory a thread (spills)."""
    path = route_for(D, dtype, shape)
    if path == "packed":
        vals = [ctypes.c_int(0) for _ in range(3)]
        N = packed_plan(*shape, D, dtype).N
        rc = _lib().flash_attention_packed_resources(D, N, 0, *(ctypes.byref(x) for x in vals))
        if rc != 0:
            raise RuntimeError(f"flash_attention_packed_resources: CUDA error {rc}")
        return dict(route=path, kernel=f"pk::packed_fwd<{D}, {N}, false>",
                    **dict(zip(("registers_at_launch", "smem_bytes", "local_bytes"),
                               (x.value for x in vals))))
    regs, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = _lib().flash_attention_resources(D, _KERNEL_CODE[dtype], ctypes.byref(regs),
                                          ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"flash_attention_resources: CUDA error {rc}")
    return {"route": path, "registers_at_launch": regs.value, "smem_bytes": smem.value}


def backward_kernels(D: int, dtype: torch.dtype, shape: tuple | None = None) -> dict:
    """{role: (kernel, a fragment of its mangled name)} of the kernels a
    backward call of head dim ``D``, ``dtype`` and ``shape`` (B, Sq, Sk, H,
    K; see ``backward_route``) launches, in order: the names the compiler's
    report (``-Xptxas -v``) gives them.  Roles "prep", "dkdv", "dq", or on
    the packed route its one kernel, "packed".  The split route's
    ``split_bf16`` pre-pass is the forward library's kernel and not listed
    here."""
    if backward_route(D, dtype, shape) == "packed":
        N = packed_plan(*shape, D, dtype).N
        return {"packed": (f"pk::packed_bwd<{D}, {N}>", f"packed_bwdILi{D}ELi{N}E")}
    t = "13__nv_bfloat16" if dtype == torch.bfloat16 else "f"
    tname = "bf16" if dtype == torch.bfloat16 else "float"
    kind = "wgmma" if dtype == torch.bfloat16 else "split_wide" if D >= 256 else "split"
    return {"prep": (f"bwd_prep<{tname}>", f"bwd_prepI{t}E"),
            "dkdv": (f"tc::dkdv_{kind}<{D}>", f"dkdv_{kind}ILi{D}E"),
            "dq": (f"tc::dq_{kind}<{D}>", f"dq_{kind}ILi{D}E")}


def backward_resources(D: int, dtype: torch.dtype, shape: tuple | None = None) -> dict:
    """{role: kernel, registers a thread at launch, shared memory a block,
    local memory a thread} of the kernels of ``backward_kernels``, with the
    route.  The tensor-core kernels then move registers between their
    warpgroups with ``setmaxnreg``: 240 a consumer thread, 24 a producer
    thread."""
    lib = _bwd_lib()
    path = backward_route(D, dtype, shape)
    out = {"route": path}
    for which, (role, (name, _)) in enumerate(backward_kernels(D, dtype, shape).items()):
        vals = [ctypes.c_int(0) for _ in range(3)]
        if path == "packed":
            rc = lib.flash_attention_bwd_packed_resources(
                D, packed_plan(*shape, D, dtype).N, *(ctypes.byref(x) for x in vals))
        else:
            rc = lib.flash_attention_bwd_resources(D, int(dtype == torch.bfloat16), which,
                                                   *(ctypes.byref(x) for x in vals))
        if rc != 0:
            raise RuntimeError(f"flash_attention_bwd_resources: CUDA error {rc}")
        out[role] = dict(kernel=name, **dict(zip(("registers", "smem_bytes", "local_bytes"),
                                                 (x.value for x in vals))))
    return out
