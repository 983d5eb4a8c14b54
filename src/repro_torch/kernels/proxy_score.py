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

_LIB = None
_COLS: dict = {}  # (columns, device) -> int32 index tensor on that device


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build.build("cascade_score")))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.cascade_score_launch.argtypes = [vp] * 7 + [i] * 6 + [vp] * 4
        lib.cascade_score_launch.restype = i
        lib.cascade_compact_launch.argtypes = [vp] * 4 + [i] * 3 + [vp] * 2
        lib.cascade_compact_launch.restype = i
        lib.cascade_rows_per_block.argtypes = []
        lib.cascade_rows_per_block.restype = i
        lib.cascade_error_string.argtypes = [i]
        lib.cascade_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().cascade_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def _ptr(t) -> int:
    return None if t is None else t.data_ptr()


def _check_operands(x, w1, b1, w2, b2, thresholds, out_scale, block_m, compact_cols):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be a 2-D float32 tensor, got {tuple(x.shape)} {x.dtype}")
    N, F = x.shape
    if N < 1:
        raise ValueError("x must hold at least one row")
    if w1.dim() != 2 or w1.shape[0] != F:
        raise ValueError(f"w1 must be (F={F}, HP), got {tuple(w1.shape)}")
    HP = w1.shape[1]
    if w2.dim() != 2 or w2.shape[0] != HP:
        raise ValueError(f"w2 must be (HP={HP}, P), got {tuple(w2.shape)}")
    P = w2.shape[1]
    if w1.dtype != w2.dtype or w1.dtype not in (torch.float32, torch.int8):
        raise ValueError(f"w1/w2 must both be float32 or both int8, got {w1.dtype}/{w2.dtype}")
    vectors = {"b1": (b1, HP), "b2": (b2, P), "thresholds": (thresholds, P)}
    if out_scale is not None:
        vectors["out_scale"] = (out_scale, P)
    for name, (v, n) in vectors.items():
        if v.shape != (n,) or v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of shape ({n},), got "
                             f"{tuple(v.shape)} {v.dtype}")
    tensors = [x, w1, w2] + [v for v, _ in vectors.values()]
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}: all must share one device")
        if not t.is_contiguous():
            raise ValueError("cascade_score operands must be contiguous")
    if block_m < 1:
        raise ValueError(f"block_m must be positive, got {block_m}")
    cols = tuple(range(P)) if compact_cols is None else tuple(int(c) for c in compact_cols)
    if any(not 0 <= c < P for c in cols):
        raise ValueError(f"compact_cols {cols} out of range for {P} stages")
    return N, F, HP, P, cols


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


def _cols_tensor(cols, device) -> torch.Tensor:
    key = (cols, str(device))
    t = _COLS.get(key)
    if t is None:
        t = torch.tensor(cols, dtype=torch.int32, device=device)
        _COLS[key] = t
    return t


def _cascade_score_cuda(x, w1, b1, w2, b2, thresholds, n_valid, out_scale,
                        with_scores, with_compaction, cols, N, F, HP, P):
    lib = _lib()
    dev = x.device
    rows_per_block = lib.cascade_rows_per_block()
    n_blocks = -(-N // rows_per_block)
    scores = torch.empty((N, P), dtype=torch.float32, device=dev) if with_scores else None
    mask = torch.empty((N, P), dtype=torch.bool, device=dev)
    block_counts = (torch.empty((n_blocks, P), dtype=torch.int32, device=dev)
                    if with_compaction else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cascade_score_launch(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            thresholds.data_ptr(), _ptr(out_scale), int(w1.dtype == torch.int8),
            N, F, HP, P, int(n_valid), _ptr(scores), mask.data_ptr(), _ptr(block_counts),
            stream)
        _raise_on(rc, "cascade_score launch")
        cascade_score.launches += 1
        if not with_compaction:
            return scores, mask, None, None
        counts = block_counts.sum(0, dtype=torch.int32)
        C = len(cols)
        packed = torch.empty((C, N), dtype=torch.int32, device=dev)
        if C:
            cols_t = _cols_tensor(cols, dev)
            cnt_sel = block_counts.index_select(1, cols_t)
            # inter-block exclusive scan: each row block's first packed slot
            block_base = (torch.cumsum(cnt_sel, 0, dtype=torch.int32) - cnt_sel).contiguous()
            totals = counts.index_select(0, cols_t)
            rc = lib.cascade_compact_launch(
                mask.data_ptr(), block_base.data_ptr(), cols_t.data_ptr(),
                totals.data_ptr(), N, P, C, packed.data_ptr(), stream)
            _raise_on(rc, "cascade_score compaction launch")
    return scores, mask, packed, counts


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
    N, F, HP, P, cols = _check_operands(x, w1, b1, w2, b2, thresholds, out_scale,
                                        block_m, compact_cols)
    if x.device.type == "cpu":
        return cascade_score_plain(x, w1, b1, w2, b2, thresholds, n_valid,
                                   out_scale=out_scale, with_scores=with_scores,
                                   with_compaction=with_compaction, compact_cols=cols)
    if x.device.type != "cuda":
        raise ValueError(f"cascade_score runs on CUDA or the CPU, not {x.device}")
    return _cascade_score_cuda(x, w1, b1, w2, b2, thresholds, n_valid, out_scale,
                               with_scores, with_compaction, cols, N, F, HP, P)


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
