"""Fused whole-cascade proxy scoring: the ``cascade_score`` kernel wrapper.

This is the paper's hot loop — every record in the stream is scored by the
cascade's proxies.  Every proxy family lowers to one packed depth-1 MLP
form (``core/proxy_family.py``), so one kernel covers every stage:

    hid    = relu(x @ w1 + b1)        # hidden GEMM over ALL stages at once
    scores = hid @ w2 * out_scale + b2
    mask   = (scores >= thresholds) & (row < n_valid)

plus dense ascending survivor row lists per stage, compacted on the device.

``cascade_score`` takes its route from the tensors' device: a CUDA tensor
launches the hand-written kernel in ``csrc/cascade_score.cu`` (or raises),
a CPU tensor runs ``cascade_score_plain``, the same function in plain
PyTorch.  ``cascade_score.launches`` counts the CUDA launches.

On the card one launch does all of it, the survivor scan and compaction
included (a decoupled look-back across the kernel's blocks): no PyTorch op
runs before or after it.  The look-back's scratch, kept per stream, is a
ticket counter and a buffer of status words that is zeroed once and never
cleared again: each call tags its words with a new epoch.  ``launch``
takes raw pointers to preallocated outputs, for callers such as
``ops.CascadeScorer`` that check their operands once (``KernelOperands``)
and reuse their buffers.

Both routes are IEEE fp32: the kernel uses fp32 FMAs on CUDA cores, and a
caller timing the plain version on the card keeps
``torch.backends.cuda.matmul.allow_tf32`` False (TF32 would flip keep /
reject decisions near thresholds).  Summation order differs between the
two, so scores agree to about 1e-6 relative and masks agree except on rows
whose score ties the threshold at that precision.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

ROWS_PER_BLOCK = 64  # rows a kernel block scores (kRows in csrc/cascade_score.cu)
_EPOCH_LIMIT = 1 << 30  # status-word epochs run 1 .. 2^30 - 1

_LIB = None
_COLS: dict = {}  # (columns, device) -> int32 index tensor on that device
_LOOKBACK: dict = {}  # (device index, stream) -> _LookBack
_SMEM: dict = {}  # (F, HP, P, int8, device) -> (shared memory needed, allowed)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build.build("cascade_score")))
        vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.cascade_score_launch.argtypes = ([vp] * 7 + [i] * 6 + [vp] * 5 + [i] + [vp] * 2
                                             + [u] * 2 + [vp])
        lib.cascade_score_launch.restype = i
        lib.cascade_rows_per_block.argtypes = []
        lib.cascade_rows_per_block.restype = i
        lib.cascade_smem_bytes.argtypes = [i] * 4
        lib.cascade_smem_bytes.restype = ctypes.c_long
        lib.cascade_smem_limit.argtypes = []
        lib.cascade_smem_limit.restype = i
        lib.cascade_error_string.argtypes = [i]
        lib.cascade_error_string.restype = ctypes.c_char_p
        if lib.cascade_rows_per_block() != ROWS_PER_BLOCK:
            raise RuntimeError("csrc/cascade_score.cu and ROWS_PER_BLOCK disagree")
        _LIB = lib
    return _LIB


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().cascade_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def _ptr(t) -> int:
    return None if t is None else t.data_ptr()


def _check_x(x, F: int) -> int:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be a 2-D float32 tensor, got {tuple(x.shape)} {x.dtype}")
    if x.shape[0] < 1:
        raise ValueError("x must hold at least one row")
    if x.shape[1] != F:
        raise ValueError(f"w1 must be (F={x.shape[1]}, HP), got F={F}")
    if not x.is_contiguous():
        raise ValueError("cascade_score operands must be contiguous")
    return x.shape[0]


def _check_cols(compact_cols, P: int) -> tuple:
    cols = tuple(range(P)) if compact_cols is None else tuple(int(c) for c in compact_cols)
    if any(not 0 <= c < P for c in cols):
        raise ValueError(f"compact_cols {cols} out of range for {P} stages")
    return cols


class KernelOperands:
    """A cascade's weights checked once for ``cascade_score``: shapes,
    types, one device, contiguity, and on a CUDA device that the kernel's
    shared memory for these extents fits a block (else ValueError, before
    any launch).  Holds the tensors and, for the CUDA route, their
    pointers."""

    def __init__(self, w1, b1, w2, b2, thresholds, out_scale=None):
        if w1.dim() != 2:
            raise ValueError(f"w1 must be (F, HP), got {tuple(w1.shape)}")
        F, HP = w1.shape
        if w2.dim() != 2 or w2.shape[0] != HP:
            raise ValueError(f"w2 must be (HP={HP}, P), got {tuple(w2.shape)}")
        P = w2.shape[1]
        if w1.dtype != w2.dtype or w1.dtype not in (torch.float32, torch.int8):
            raise ValueError(f"w1/w2 must both be float32 or both int8, got "
                             f"{w1.dtype}/{w2.dtype}")
        vectors = {"b1": (b1, HP), "b2": (b2, P), "thresholds": (thresholds, P)}
        if out_scale is not None:
            vectors["out_scale"] = (out_scale, P)
        for name, (v, n) in vectors.items():
            if v.shape != (n,) or v.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 of shape ({n},), got "
                                 f"{tuple(v.shape)} {v.dtype}")
        for t in [w1, w2] + [v for v, _ in vectors.values()]:
            if t.device != w1.device:
                raise ValueError(f"operands on {t.device} and {w1.device}: all must share "
                                 "one device")
            if not t.is_contiguous():
                raise ValueError("cascade_score operands must be contiguous")
        self.tensors = (w1, b1, w2, b2, thresholds, out_scale)
        self.device = w1.device
        self.F, self.HP, self.P = int(F), int(HP), int(P)
        self.int8 = int(w1.dtype == torch.int8)
        if self.device.type == "cuda":
            key = (self.F, self.HP, self.P, self.int8, str(self.device))
            if key not in _SMEM:
                lib = _lib()
                with torch.cuda.device(self.device):
                    _SMEM[key] = (lib.cascade_smem_bytes(self.F, self.HP, self.P, self.int8),
                                  lib.cascade_smem_limit())
            need, limit = _SMEM[key]
            if need > limit:
                raise ValueError(f"cascade_score needs {need} B of shared memory a block at "
                                 f"F={F}, HP={HP}, P={P}; the card allows {limit}")
            self.ptrs = tuple(_ptr(t) for t in self.tensors)
        elif self.device.type != "cpu":
            raise ValueError(f"cascade_score runs on CUDA or the CPU, not {self.device}")


class _LookBack:
    """Scratch of the kernel's decoupled look-back on one stream: 64-bit
    status words (zeroed when allocated, tagged by each call with its own
    epoch, so none is ever cleared) and the ticket counter the blocks draw
    their tiles from (``base`` tracks its value, modulo 2^32)."""

    def __init__(self, device):
        self.device = device
        self.ticket = torch.zeros(1, dtype=torch.int32, device=device)
        self.ticket_ptr = self.ticket.data_ptr()
        self.status = torch.zeros(0, dtype=torch.int64, device=device)
        self.status_ptr = self.status.data_ptr()
        self.epoch = 0
        self.base = 0

    def reserve(self, n_blocks: int, P: int):
        """(status, ticket, ticket base, epoch) for one launch of n_blocks."""
        words = n_blocks * P
        if words > self.status.numel() or self.epoch + 1 >= _EPOCH_LIMIT:
            self.status = torch.zeros(max(words, 2 * self.status.numel()),
                                      dtype=torch.int64, device=self.device)
            self.status_ptr = self.status.data_ptr()
            self.epoch = 0
        self.epoch += 1
        base = self.base
        self.base = (base + n_blocks) & 0xFFFFFFFF
        return self.status_ptr, self.ticket_ptr, base, self.epoch


def cols_tensor(cols, device) -> torch.Tensor:
    """int32 tensor of ``cols`` on ``device`` (cached)."""
    key = (cols, str(device))
    t = _COLS.get(key)
    if t is None:
        t = torch.tensor(cols, dtype=torch.int32, device=device)
        _COLS[key] = t
    return t


def launch(ops: KernelOperands, x_ptr: int, N: int, n_valid: int, scores_ptr, mask_ptr: int,
           counts_ptr=None, packed_ptr=None, cols_ptr=None, C: int = 0) -> None:
    """One launch of the kernel on the current stream into preallocated
    outputs (raw pointers: x (N, F) f32; scores (N, P) f32 or None; mask
    (N, P) bool; counts (P,) int32, packed (C, N) int32 and cols (C,) int32,
    or counts None for no compaction).  Scoring, the survivor scan and the
    compaction are all in this launch: no PyTorch op runs here.  The caller
    has checked every operand."""
    lib = _LIB or _lib()
    stream = torch.cuda.current_stream(ops.device).cuda_stream
    if counts_ptr is None:
        status = ticket = None
        base = epoch = 0
    else:
        key = (ops.device.index, stream)
        lb = _LOOKBACK.get(key)
        if lb is None:
            lb = _LOOKBACK[key] = _LookBack(ops.device)
        status, ticket, base, epoch = lb.reserve(-(-N // ROWS_PER_BLOCK), ops.P)
    w1, b1, w2, b2, thr, out_scale = ops.ptrs
    rc = lib.cascade_score_launch(
        x_ptr, w1, b1, w2, b2, thr, out_scale, ops.int8, N, ops.F, ops.HP, ops.P,
        int(n_valid), scores_ptr, mask_ptr, counts_ptr, packed_ptr, cols_ptr, C, status,
        ticket, base, epoch, stream)
    if rc != 0 and counts_ptr is not None:
        # no block drew a ticket, so the counter is behind this scratch's base
        del _LOOKBACK[(ops.device.index, stream)]
    _raise_on(rc, "cascade_score launch")
    cascade_score.launches += 1


def cascade_score_plain(x, w1, b1, w2, b2, thresholds, n_valid, *, out_scale=None,
                        with_scores=True, with_compaction=True, compact_cols=None):
    """The same function as the kernel in plain PyTorch (the CPU route and
    the on-card reference).  ``compact_cols`` selects the columns whose
    survivor lists are assembled; ``counts`` covers every column."""
    N = x.shape[0]
    P = w2.shape[1]
    hid = torch.relu(x @ w1.to(torch.float32) + b1)
    s = hid @ w2.to(torch.float32)
    if out_scale is not None:
        s = s * out_scale
    s = s + b2
    rows = torch.arange(N, device=x.device)
    mask = (s >= thresholds) & (rows < n_valid)[:, None]
    scores = s if with_scores else None
    if not with_compaction:
        return scores, mask, None, None
    cols = list(range(P)) if compact_cols is None else [int(c) for c in compact_cols]
    counts = mask.sum(0, dtype=torch.int32)
    keep = mask[:, cols].to(torch.int32)  # (N, C)
    slot = torch.cumsum(keep, 0) - keep  # exclusive rank of each survivor
    slot = torch.where(keep.bool(), slot, N).T.to(torch.int64)  # rejects -> sentinel N
    packed = torch.full((len(cols), N + 1), -1, dtype=torch.int32, device=x.device)
    packed.scatter_(1, slot, rows.to(torch.int32).expand(len(cols), N).contiguous())
    return scores, mask, packed[:, :N].contiguous(), counts


def cascade_score(x, w1, b1, w2, b2, thresholds, n_valid, *, out_scale=None,
                  block_m: int = 256, with_scores: bool = True,
                  with_compaction: bool = True, compact_cols=None):
    """One fused pass over a record tile for a whole cascade.

    x: (N, F) float32 record tile (rows >= ``n_valid``, a Python int, are
    padding and masked out of every stage); w1: (F, HP) stacked folded
    hidden weights (h-major, see
    ``core.proxy_family.cascade_kernel_operands``); b1: (HP,); w2: (HP, P)
    readout (block-diagonal in practice, any matrix accepted); b2,
    thresholds: (P,).  ``w1``/``w2`` may be int8 codes with ``out_scale``
    (P,) the per-stage dequantizing scales; None means the fp32 path.
    ``block_m`` is accepted for signature parity with the JAX package and
    does not change results.  All tensors share one device, which picks
    the route: CUDA launches the kernel, CPU runs ``cascade_score_plain``.

    Returns:
      scores (N, P) f32    raw proxy scores (None unless with_scores)
      mask   (N, P) bool   per-stage keep masks (padding rows False)
      packed (C, N) int32  per selected column (``compact_cols``, default
                           all P), the ascending rows where its mask is
                           True, then -1 (None unless with_compaction)
      counts (P,) int32    survivors per stage, every column (None unless
                           with_compaction)
    """
    ops = KernelOperands(w1, b1, w2, b2, thresholds, out_scale)
    N = _check_x(x, ops.F)
    if x.device != ops.device:
        raise ValueError(f"operands on {x.device} and {ops.device}: all must share one device")
    if block_m < 1:
        raise ValueError(f"block_m must be positive, got {block_m}")
    cols = _check_cols(compact_cols, ops.P)
    if x.device.type == "cpu":
        return cascade_score_plain(x, w1, b1, w2, b2, thresholds, n_valid,
                                   out_scale=out_scale, with_scores=with_scores,
                                   with_compaction=with_compaction, compact_cols=cols)
    dev, P = x.device, ops.P
    scores = torch.empty((N, P), dtype=torch.float32, device=dev) if with_scores else None
    mask = torch.empty((N, P), dtype=torch.bool, device=dev)
    if not with_compaction:
        launch(ops, x.data_ptr(), N, n_valid, _ptr(scores), mask.data_ptr())
        return scores, mask, None, None
    counts = torch.empty(P, dtype=torch.int32, device=dev)
    packed = torch.empty((len(cols), N), dtype=torch.int32, device=dev)
    cols_t = cols_tensor(cols, dev) if cols else None
    launch(ops, x.data_ptr(), N, n_valid, _ptr(scores), mask.data_ptr(), counts.data_ptr(),
           _ptr(packed) if cols else None, _ptr(cols_t), len(cols))
    return scores, mask, packed, counts


cascade_score.launches = 0


def proxy_score(x, w, b, thresholds, *, block_m: int = 256):
    """x: (N, F); w: (F, P); b, thresholds: (P,).  Linear-stack convenience
    returning (scores (N, P) f32, mask (N, P) bool) through
    ``cascade_score`` with the exact +/- embedding: hidden units
    ``[w | -w]`` and readout ``[I; -I]``."""
    w = w.to(torch.float32)
    b = b.to(torch.float32)
    P = w.shape[1]
    eye = torch.eye(P, dtype=torch.float32, device=x.device)
    w1 = torch.cat([w, -w], dim=1).contiguous()
    b1 = torch.cat([b, -b]).contiguous()
    w2 = torch.cat([eye, -eye], dim=0).contiguous()
    b2 = torch.zeros(P, dtype=torch.float32, device=x.device)
    scores, mask, _packed, _counts = cascade_score(
        x, w1, b1, w2, b2, thresholds, x.shape[0], block_m=block_m,
        with_scores=True, with_compaction=False)
    return scores, mask
