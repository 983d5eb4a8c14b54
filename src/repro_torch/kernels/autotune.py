"""Roofline-driven choice of the fused scorer's ``block_m``.

The JAX package's tuner, with one cell model for each route:

* ``"cpu"`` (and any name but ``"cuda"``): the JAX package's model,
  computed exactly as it computes it, under the same nominal constants,
  feasibility bound and tie-break.  A scorer on the CPU therefore picks
  the block the JAX package's scorer picks for the same cascade, and both
  packages write the same COREWIRE bytes for one plan.  For each candidate
  ``block_m`` it counts the bytes one launch moves (the bucket-padded x
  tile, the stacked weights at their storage width, the mask and
  compaction outputs) and the GEMM flops, and scores the cell with a
  two-knee roofline

      t = LAUNCH + nb * STEP + max(bytes / BW, flops / PEAK)

  with ``nb = npad / block_m`` grid steps and a per-row VMEM footprint of
  ``4*(F + HPp) + 9*Pp`` bytes against an 8 MiB budget.

* ``"cuda"``: what ``block_m`` changes on the card.  The ``cascade_score``
  kernel ignores it (its blocks are ``TILE_ROWS`` = 64 rows,
  ``csrc/cascade_score.cu``); ``block_m`` only sets the bottom of the
  scorer's bucket ladder, and with it how many padded rows a tile is
  scored at.  So ``nb = ceil(npad / 64)`` blocks; the bytes are the rows
  the pinned staging uploads plus the one fetch of the result buffer
  ``[counts | mask]`` of ``score_masks``'s layout (the serving engine's)
  at ``npad`` rows; the flops are the kernel's over ``npad`` rows; and a
  cell is feasible when one bucket's pinned and device buffers (the
  scorer's ``_TileBuffers``) fit ``TILE_BUFFER_BUDGET``.  A block's shared
  memory does not depend on ``block_m``, so it bounds nothing here.  A
  tie goes to the smaller block: a lower ladder bottom pads no chunk more
  at any size, while the JAX package's tie-break (the larger block) would
  pad every ragged tile up to the hint's bucket.  Without a hint every
  candidate pads a full tile alike, so the smallest block wins.

The constants are a nominal envelope until ``calibrate_backend`` fits
measured ones for a backend (on the card, from ``measure_cell`` timings).
Winning configs are cached keyed by (F, HP-bucket, P-bucket, dtype,
backend, hint-bucket, max_tile); ``CORE_AUTOTUNE_CACHE=/path.json``
persists the table across processes (merge-on-save, atomic replace).  The
key format is the JAX package's, and its ``"gpu"`` backend is another key
than this package's ``"cuda"``, so a shared file never mixes the two.
"""
from __future__ import annotations

import json
import os
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.proxy_family import QUANT_WEIGHT_BYTES
from repro_torch.kernels.proxy_score import ROWS_PER_BLOCK

# The JAX package's nominal single-core TPU envelope: the "cpu" defaults
# (kept for parity with its choices; no rate here describes this package's
# hardware).
HBM_BYTES_PER_S = 1.2e12
PEAK_FLOPS = 7.0e13
LAUNCH_OVERHEAD_S = 5.0e-6
GRID_STEP_OVERHEAD_S = 1.5e-6
VMEM_BLOCK_BUDGET = 8 << 20  # the JAX package's static heuristic's budget
WEIGHT_RESIDENT_BYTES = 4 << 20  # weights this small stay resident in VMEM

# The card's route.
TILE_ROWS = ROWS_PER_BLOCK  # rows of one cascade_score block (kRows in csrc/cascade_score.cu)
TILE_BUFFER_BUDGET = 64 << 20  # one bucket's pinned + device buffers


class BackendConstants(NamedTuple):
    """Roofline envelope for one backend.  ``source`` records where the
    numbers came from: "default" (the nominal constants) or "measured"
    (``calibrate_backend`` fitted them from wall-clock)."""

    hbm_bytes_per_s: float = HBM_BYTES_PER_S
    peak_flops: float = PEAK_FLOPS
    launch_overhead_s: float = LAUNCH_OVERHEAD_S
    grid_step_overhead_s: float = GRID_STEP_OVERHEAD_S
    source: str = "default"


_DEFAULT_CONSTANTS = BackendConstants()
# Nominal envelope of the card's route before calibration: a cell's bytes
# cross the host link (PCIe 5.0 x16, 64 GB/s a direction), its flops run
# in IEEE f32 on the CUDA cores (67 TFLOP/s, the H100 SXM data sheet), and
# a launch's 64-row blocks run side by side (no per-block term).  The
# ranking the cuda model gives does not depend on these values: bytes,
# flops and blocks all grow with the padded rows alone, so calibrating
# them moves a cell's modelled time and never the pick.
_CUDA_DEFAULTS = BackendConstants(hbm_bytes_per_s=6.4e10, peak_flops=6.7e13,
                                  launch_overhead_s=5.0e-6, grid_step_overhead_s=0.0)
_BACKEND_CONSTANTS: dict = {}  # backend name -> BackendConstants


def _defaults(backend: Optional[str]) -> BackendConstants:
    return _CUDA_DEFAULTS if str(backend) == "cuda" else _DEFAULT_CONSTANTS


def backend_constants(backend: Optional[str] = None) -> BackendConstants:
    """Constants for ``backend``: the calibrated set if one was registered,
    the backend's nominal defaults otherwise."""
    return _BACKEND_CONSTANTS.get(str(backend), _defaults(backend))


def set_backend_constants(backend: str, constants: BackendConstants) -> None:
    """Register measured constants for ``backend`` and drop every cached
    sweep winner keyed to it (a winner picked under the nominal envelope
    may not survive the measured one)."""
    _BACKEND_CONSTANTS[str(backend)] = constants
    for key in [k for k in _CACHE if k[4] == str(backend)]:
        del _CACHE[key]


def reset_backend_constants() -> None:
    _BACKEND_CONSTANTS.clear()


def backend_of(device) -> str:
    """The tuner's backend name for a scorer on ``device``: "cuda" or "cpu"."""
    return "cuda" if torch.device(device).type == "cuda" else "cpu"


def _ceil128(n: int) -> int:
    return -(-int(n) // 128) * 128


def static_heuristic_block_m(n_features: int, hp: int, n_proxies: int,
                             max_tile: int = 8192) -> int:
    """The JAX package's pre-autotune rule: the largest power-of-two block
    >= 256 whose per-row VMEM footprint fits the 8 MiB budget."""
    hpp = _ceil128(hp)
    pp = _ceil128(n_proxies)
    per_row = 4 * (int(n_features) + hpp) + 9 * pp
    budget_rows = VMEM_BLOCK_BUDGET // per_row
    block_m = 256
    while block_m * 2 <= min(budget_rows, max_tile):
        block_m *= 2
    return min(block_m, max_tile)


class CellModel(NamedTuple):
    """Roofline model of one (block_m, dtype) sweep cell."""

    block_m: int
    dtype: str
    n_rows: int
    npad: int          # bucket-padded rows the launch actually scores
    nb: int            # grid steps (the card: 64-row blocks)
    bytes_moved: int   # exact bytes moved per launch
    flops: int
    t_model_s: float
    mbu: float         # model bandwidth utilization: useful bytes / (t*BW)
    feasible: bool     # within the backend's buffer budget


class TunedConfig(NamedTuple):
    block_m: int
    dtype: str
    t_model_s: float
    bytes_moved: int
    mbu: float
    static_block_m: int  # what the JAX package's static heuristic picks
    source: str          # "sweep" | "cache"


def _weight_bytes(n_features: int, hp: int, n_proxies: int, dtype: str) -> int:
    wb = QUANT_WEIGHT_BYTES[dtype]
    hpp = _ceil128(hp)
    pp = _ceil128(n_proxies)
    # w1 (F, HPp) + w2 (HPp, Pp) at storage width; b1/b2/thr/out_scale f32
    return (int(n_features) * hpp * wb + hpp * pp * wb
            + hpp * 4 + 3 * pp * 4)


def padded_rows(n_rows: int, block_m: int, max_tile: int) -> int:
    """The scorer's bucket ladder: block_m * 2^k, capped at max_tile."""
    size = block_m
    while size < min(n_rows, max_tile):
        size *= 2
    return min(size, max_tile)


def result_layout(rows: int, n_proxies: int, n_compact: Optional[int] = None,
                  with_scores: bool = False) -> Tuple[int, int, int, int]:
    """Byte offsets (packed, mask, scores) and size of one bucket's result
    buffer ``[counts (P) int32 | packed (C, rows) int32 | mask (rows, P) bool
    | scores (rows, P) f32]``, the scores 16-byte aligned: what the scorer
    fetches from the card a tile (``ops._TileBuffers`` allocates it)."""
    off_packed = 4 * n_proxies
    off_mask = off_packed + 4 * (n_compact or 0) * rows
    off_scores = -(-(off_mask + rows * n_proxies) // 16) * 16
    return off_packed, off_mask, off_scores, off_scores + (
        4 * rows * n_proxies if with_scores else 0)


def _cuda_cell(n_features, hp, n_proxies, dtype, block_m, n_rows, max_tile,
               bc: BackendConstants) -> CellModel:
    npad = padded_rows(n_rows, block_m, max_tile)
    nb = -(-npad // TILE_ROWS)
    upload = min(int(n_rows), npad) * int(n_features) * 4
    fetch = result_layout(npad, n_proxies)[3]
    bytes_moved = upload + fetch
    flops = 2 * npad * (int(n_features) * int(hp) + int(hp) * int(n_proxies))
    t = (bc.launch_overhead_s + nb * bc.grid_step_overhead_s
         + max(bytes_moved / bc.hbm_bytes_per_s, flops / bc.peak_flops))
    useful = upload + result_layout(min(int(n_rows), npad), n_proxies)[3]
    buffers = 2 * (npad * int(n_features) * 4 + fetch)  # pinned + device
    return CellModel(block_m=int(block_m), dtype=dtype, n_rows=int(n_rows),
                     npad=int(npad), nb=int(nb), bytes_moved=int(bytes_moved),
                     flops=int(flops), t_model_s=float(t),
                     mbu=float(useful / (t * bc.hbm_bytes_per_s)),
                     feasible=buffers <= TILE_BUFFER_BUDGET)


def cell_model(n_features: int, hp: int, n_proxies: int, dtype: str,
               block_m: int, n_rows: int, *,
               max_tile: int = 8192,
               backend: Optional[str] = None) -> CellModel:
    """Roofline-score one sweep cell for a chunk of ``n_rows`` records.

    ``backend="cuda"`` takes the card's model (module docstring); any
    other name the JAX package's.  Each is scored under the backend's
    registered measured constants if it has them, its nominal ones
    otherwise."""
    bc = backend_constants(backend)
    if str(backend) == "cuda":
        return _cuda_cell(n_features, hp, n_proxies, dtype, block_m, n_rows, max_tile, bc)
    hpp = _ceil128(hp)
    pp = _ceil128(n_proxies)
    npad = padded_rows(n_rows, block_m, max_tile)
    nb = -(-npad // block_m)
    wbytes = _weight_bytes(n_features, hp, n_proxies, dtype)
    refetch = 1 if wbytes <= WEIGHT_RESIDENT_BYTES else nb
    x_bytes = npad * n_features * 4
    out_bytes = npad * pp * (1 + 4)  # keep mask + compacted survivor ids
    bytes_moved = x_bytes + out_bytes + wbytes * refetch
    flops = 2 * npad * (n_features * hpp + hpp * pp)
    t_mem = bytes_moved / bc.hbm_bytes_per_s
    t_flop = flops / bc.peak_flops
    t = bc.launch_overhead_s + nb * bc.grid_step_overhead_s + max(t_mem, t_flop)
    # useful bytes: the unpadded rows' traffic + one copy of the weights
    useful = n_rows * (n_features * 4 + pp * 5) + wbytes
    mbu = useful / (t * bc.hbm_bytes_per_s)
    per_row = 4 * (n_features + hpp) + 9 * pp
    feasible = per_row * block_m <= VMEM_BLOCK_BUDGET
    return CellModel(block_m=int(block_m), dtype=dtype, n_rows=int(n_rows),
                     npad=int(npad), nb=int(nb),
                     bytes_moved=int(bytes_moved), flops=int(flops),
                     t_model_s=float(t), mbu=float(mbu), feasible=feasible)


def _candidates(max_tile: int) -> Tuple[int, ...]:
    out, c = [], 128
    while c <= max_tile:
        out.append(c)
        c *= 2
    return tuple(out) or (max_tile,)


# ----------------------------------------------------------------- cache
_CACHE: dict = {}
_STATS = {"sweeps": 0, "hits": 0}
_DISK_LOADED = False


def autotune_stats() -> dict:
    return dict(_STATS)


def reset_autotune_stats() -> None:
    _STATS["sweeps"] = 0
    _STATS["hits"] = 0


def clear_autotune_cache() -> None:
    global _DISK_LOADED
    _CACHE.clear()
    _DISK_LOADED = False


def _hint_bucket(n_rows_hint: int, max_tile: int) -> int:
    return padded_rows(min(int(n_rows_hint), max_tile), 128, max_tile)


def _cache_key(n_features, hp, n_proxies, dtype, backend, hint_b, max_tile):
    return (int(n_features), _ceil128(hp), _ceil128(n_proxies), str(dtype),
            str(backend), int(hint_b), int(max_tile))


def _disk_path() -> Optional[str]:
    return os.environ.get("CORE_AUTOTUNE_CACHE") or None


def _read_disk_table(path: str) -> dict:
    """Parse the on-disk table into {key tuple: TunedConfig}.  A corrupt,
    partial or wrong-schema file yields {} with a warning: the sweep is
    cheap, silently poisoned configs are not."""
    table: dict = {}
    if not os.path.exists(path):
        return table
    try:
        with open(path) as f:
            raw = json.load(f)
        for key_s, cfg in raw.items():
            table[tuple(json.loads(key_s))] = TunedConfig(
                block_m=int(cfg["block_m"]), dtype=str(cfg["dtype"]),
                t_model_s=float(cfg["t_model_s"]),
                bytes_moved=int(cfg["bytes_moved"]), mbu=float(cfg["mbu"]),
                static_block_m=int(cfg["static_block_m"]), source="cache")
    except (OSError, ValueError, KeyError, TypeError):
        import warnings

        warnings.warn(
            f"CORE_AUTOTUNE_CACHE at {path!r} is corrupt or partial; "
            f"ignoring it and falling back to a fresh sweep",
            RuntimeWarning, stacklevel=3)
        return {}
    return table


def _load_disk_cache() -> None:
    global _DISK_LOADED
    _DISK_LOADED = True
    path = _disk_path()
    if not path:
        return
    for key, cfg in _read_disk_table(path).items():
        # disk entries were swept under the nominal envelope; a backend
        # running calibrated constants must re-sweep, not inherit them
        if backend_constants(key[4]).source != "default":
            continue
        _CACHE.setdefault(key, cfg)


def _save_disk_cache() -> None:
    """Persist the in-memory table: merge-on-save and atomic replace.

    Several processes may share one cache file: re-reading it just before
    writing keeps the entries a peer saved meanwhile (ours win only for
    keys we hold, and both sides swept the same deterministic model), and
    a same-directory temp file + ``os.replace`` makes the publish atomic,
    so readers see the old table or the new one, never a torn prefix."""
    path = _disk_path()
    if not path:
        return
    merged = _read_disk_table(path)
    # never publish winners swept under MEASURED constants: they price
    # this machine, and the key does not carry the constants
    merged.update({k: v for k, v in _CACHE.items()
                   if backend_constants(k[4]).source == "default"})
    table = {
        json.dumps(list(k)): {
            "block_m": v.block_m, "dtype": v.dtype,
            "t_model_s": v.t_model_s, "bytes_moved": v.bytes_moved,
            "mbu": v.mbu, "static_block_m": v.static_block_m,
        }
        for k, v in merged.items()
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(table, f, indent=0, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def choose_block_m(n_features: int, hp: int, n_proxies: int,
                   dtype: str = "float32", *,
                   n_rows_hint: Optional[int] = None,
                   max_tile: int = 8192,
                   backend: str = "cuda") -> TunedConfig:
    """Pick ``block_m`` for the fused scorer by roofline sweep.

    ``n_rows_hint`` is the expected chunk size; None means full tiles
    (``max_tile``).  ``backend`` is the scorer's (``backend_of`` its
    device).  The cheapest feasible cell wins; on a tie the larger block
    on the JAX package's model, the smaller on "cuda" (module docstring)."""
    if not _DISK_LOADED:
        _load_disk_cache()
    hint = max_tile if n_rows_hint is None else int(n_rows_hint)
    hint_b = _hint_bucket(max(hint, 1), max_tile)
    key = _cache_key(n_features, hp, n_proxies, dtype, backend, hint_b,
                     max_tile)
    hit = _CACHE.get(key)
    if hit is not None:
        _STATS["hits"] += 1
        return hit._replace(source="cache")
    _STATS["sweeps"] += 1
    static_bm = static_heuristic_block_m(n_features, hp, n_proxies, max_tile)
    cells = [cell_model(n_features, hp, n_proxies, dtype, bm, hint_b,
                        max_tile=max_tile, backend=backend)
             for bm in _candidates(max_tile)]
    feasible = [c for c in cells if c.feasible]
    if not feasible:
        # degenerate shape: even the smallest block blows the budget; keep
        # the static heuristic's pick
        feasible = [c for c in cells if c.block_m == static_bm] or cells[:1]
    smaller = 1 if str(backend) == "cuda" else -1
    best = min(feasible, key=lambda c: (c.t_model_s, smaller * c.block_m))
    cfg = TunedConfig(block_m=best.block_m, dtype=dtype,
                      t_model_s=best.t_model_s,
                      bytes_moved=best.bytes_moved, mbu=best.mbu,
                      static_block_m=static_bm, source="sweep")
    _CACHE[key] = cfg
    # calibrated winners are this process's measurement: persisting them
    # would poison peers under other constants
    if backend_constants(backend).source == "default":
        _save_disk_cache()
    return cfg


# ----------------------------------------------------------------- sweep
def sweep_table(shapes, dtypes=("float32", "int8"), *,
                n_rows_hints=(256, 1024, 8192), max_tile: int = 8192):
    """The JAX package's sweep over workload shapes x dtypes x chunk hints,
    on its model under the nominal constants (backend "model").

    ``shapes``: iterable of (name, F, HP, P).  Returns a list of dicts,
    one per (shape, dtype, hint): the winning cell, the static heuristic's
    cell at the same hint, and whether the tuner's pick strictly beats it
    under the model."""
    rows = []
    for name, f, hp, p in shapes:
        static_bm = static_heuristic_block_m(f, hp, p, max_tile)
        for dtype in dtypes:
            for hint in n_rows_hints:
                cfg = choose_block_m(f, hp, p, dtype, n_rows_hint=hint,
                                     max_tile=max_tile, backend="model")
                stat = cell_model(f, hp, p, dtype, static_bm, hint,
                                  max_tile=max_tile)
                rows.append({
                    "shape": name, "F": int(f), "HP": int(hp), "P": int(p),
                    "dtype": dtype, "n_rows": int(hint),
                    "block_m": cfg.block_m, "static_block_m": static_bm,
                    "t_model_us": cfg.t_model_s * 1e6,
                    "t_static_us": stat.t_model_s * 1e6,
                    "bytes_moved": cfg.bytes_moved,
                    "bytes_static": stat.bytes_moved,
                    "mbu": cfg.mbu,
                    "beats_static": cfg.t_model_s < stat.t_model_s,
                    "source": cfg.source,
                })
    return rows


def calibrate_backend(scorer, *, backend: Optional[str] = None,
                      rows: Tuple[int, int] = (256, 8192),
                      repeats: int = 3,
                      register: bool = True) -> BackendConstants:
    """Fit the roofline constants for ``backend`` (default: the scorer's)
    from measured wall-clock.

    Two ``measure_cell`` points bracket the chunk-size axis: the byte
    delta between them over the time delta is the achieved rate (the fixed
    terms cancel in the difference), the small point's residual after its
    byte time prices the launch, and the compute roof scales with the
    fitted rate (only the knee's position matters for a ranking on one
    backend).  A degenerate measurement (zero or negative deltas) keeps
    the backend's nominal constant instead of registering garbage.
    ``register=True`` installs the result with ``set_backend_constants``."""
    if backend is None:
        backend = backend_of(scorer.device)
    nominal = _defaults(backend)
    f = int(scorer.n_features)
    hp = int(scorer.w1.shape[1])
    p = int(scorer.n_proxies)
    dtype = str(scorer.dtype)
    bm = int(scorer.block_m)
    mt = int(scorer.max_tile)
    r_small, r_large = int(min(rows)), int(max(rows))
    t_small = measure_cell(scorer, r_small, repeats=repeats)
    t_large = measure_cell(scorer, r_large, repeats=repeats)
    model_backend = "cuda" if str(backend) == "cuda" else None
    cm_small = cell_model(f, hp, p, dtype, bm, r_small, max_tile=mt, backend=model_backend)
    cm_large = cell_model(f, hp, p, dtype, bm, r_large, max_tile=mt, backend=model_backend)
    d_bytes = cm_large.bytes_moved - cm_small.bytes_moved
    d_t = t_large - t_small
    if d_bytes > 0 and d_t > 1e-9:
        bw = float(d_bytes) / float(d_t)
    else:
        bw = nominal.hbm_bytes_per_s
    peak = nominal.peak_flops * (bw / nominal.hbm_bytes_per_s)
    launch = t_small - cm_small.bytes_moved / bw - cm_small.nb * nominal.grid_step_overhead_s
    if launch <= 0:
        launch = nominal.launch_overhead_s
    bc = BackendConstants(
        hbm_bytes_per_s=bw, peak_flops=peak,
        launch_overhead_s=float(launch),
        grid_step_overhead_s=nominal.grid_step_overhead_s,
        source="measured")
    if register:
        set_backend_constants(str(backend), bc)
    return bc


def measure_cell(scorer, n_rows: int, *, repeats: int = 3) -> float:
    """Wall-clock seconds of one ``score_masks`` call on a random chunk
    (best of ``repeats``, after one warm-up call).  On the card the clock
    is read after ``torch.cuda.synchronize()``; on the CPU it times the
    plain route, so it is no device number."""
    rng = np.random.RandomState(0)
    x = rng.randn(n_rows, scorer.n_features).astype(np.float32)
    cuda = torch.device(scorer.device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(scorer.device)

    scorer.score_masks(x)  # allocates the bucket's buffers
    best = float("inf")
    for _ in range(max(1, repeats)):
        sync()
        t0 = time.perf_counter()
        scorer.score_masks(x)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best
