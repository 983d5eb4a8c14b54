#!/usr/bin/env python3
"""Where the time goes inside the ``cascade_score`` kernel, phase by phase.

    python3 scripts/cascade_phases.py [--calls 20] [--source FILE.cu]

Needs a CUDA card and ``nvcc``.  Builds a copy of
``src/repro_torch/kernels/csrc/cascade_score.cu`` with timers (thread 0 of
each block reads ``clock64`` and ``%globaltimer`` at the phase boundaries
below) into ``build/cascade_phases/``, runs the main path's two shapes (one
executor tile of 8,192 records, F = 64: quickstart's two linear stages,
HP 4, and mixed3's three stages with an mlp1 of hidden 32, HP 96; one
compacted column) through the ordinary wrapper, and prints one JSON line
per shape: for each phase, the median and largest time over blocks from
the block's entry (microseconds, from the block's own cycle count at the
rate ``%globaltimer`` gives), the spread of block entries, and the
kernel's span.  The timers cost a few instructions per phase: the span
here is not the kernel's time.

Phases: ``ticket`` (the tile drawn, with thread 0's share of the x of
tile blockIdx.x in shared memory), ``x`` (x read again if the tile drawn
was another), ``first_stage`` (the first w1 stage waited for), ``hidden``
(every chunk's hidden product and readout), ``epilogue`` (scores, masks,
the survivor ballots and the publish), ``look_back`` (every stage's
exclusive prefix), ``end`` (the survivor lists written).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("entry", "ticket", "x", "first_stage", "hidden", "epilogue", "look_back", "end")
MAX_BLOCKS = 4096
# (anchor in the source, text put before it); each anchor occurs once
PROBES = (
    ("  unsigned ticket = blockIdx.x;", "  PHASE(0);\n"),
    ("  const int r0 = t * kRows, rows", "  PHASE(1);\n"),
    ("  float h[2][M::NC];", "  PHASE(2);\n"),
    ("    const WT* wb = ws + (s % kRing)", "    if (s == 0) PHASE(3);\n"),
    ("  for (int e = tid; e < O; e += kThreads) {\n    const int r = e / P, q", "  PHASE(4);\n"),
    ("  // publish every stage's aggregate", "  PHASE(5);\n"),
    ("  if (r0 + rows == p.N)", "  PHASE(6);\n"),
    ("\n}\n\n// Widest copy unit", "\n  PHASE(7);"),
)
HEADER = f"""
__device__ unsigned long long g_cycles[{MAX_BLOCKS} * 8];
__device__ unsigned long long g_ns[{MAX_BLOCKS} * 8];
#define PHASE(k)                                                              \\
  if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) {{                        \\
    unsigned long long ns_;                                                   \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns_));                   \\
    g_cycles[blockIdx.x * 8 + (k)] = clock64();                               \\
    g_ns[blockIdx.x * 8 + (k)] = ns_;                                         \\
  }}
"""
FOOTER = """
extern "C" int cascade_phases_read(void* cycles, void* ns, int n) {
  cudaError_t e = cudaMemcpyFromSymbol(cycles, g_cycles, n * sizeof(unsigned long long));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(ns, g_ns, n * sizeof(unsigned long long));
  return (int)e;
}
"""


def build_traced(source: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    src = source.read_text()
    for anchor, probe in PROBES:
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in cascade_score.cu: {anchor!r}")
        src = src.replace(anchor, probe + anchor)
    src = src.replace("namespace {\n", HEADER + "\nnamespace {\n", 1) + FOOTER
    out_dir = ROOT / "build" / "cascade_phases" / source.stem
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, lib = out_dir / "cascade_score_phases.cu", out_dir / "cascade_score_phases.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(lib), str(cu)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def shape_operands(HP_per_stage, P, F, dev, seed):
    """Random w1 / w2 in the packed layout at these widths (one hidden
    width for every stage, h-major), thresholds at the median score."""
    from repro_torch.core.proxy_family import PackedCascade, cascade_kernel_operands
    from repro_torch.kernels.proxy_score import cascade_score_plain

    rng = np.random.RandomState(seed)
    H = HP_per_stage
    packed = PackedCascade(w1=(rng.randn(F, H, P) / np.sqrt(F)).astype(np.float32),
                           b1=(0.1 * rng.randn(H, P)).astype(np.float32),
                           w2=(rng.randn(H, P) / np.sqrt(H)).astype(np.float32),
                           b2=np.zeros(P, np.float32), hidden=(H,) * P,
                           families=("mlp1",) * P)
    ops = [torch.from_numpy(a).to(dev) for a in cascade_kernel_operands(packed)]
    x = torch.from_numpy(rng.randn(8192, F).astype(np.float32)).to(dev)
    s = cascade_score_plain(x, *ops, torch.zeros(P, device=dev), 8192,
                            with_compaction=False)[0]
    return x, ops, s.median(dim=0).values.contiguous()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=20, help="calls per shape (median taken)")
    ap.add_argument("--source", type=Path, default=None,
                    help="time another copy of the kernel's source (default: the package's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cascade_phases: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import proxy_score

    dev = torch.device("cuda", 0)
    proxy_score._lib()  # the real library, then the traced copy in its place
    traced = build_traced(args.source or ROOT / "src/repro_torch/kernels/csrc/cascade_score.cu")
    for name in ("cascade_score_launch", "cascade_rows_per_block", "cascade_smem_bytes",
                 "cascade_smem_limit", "cascade_error_string"):
        f, g = getattr(proxy_score._LIB, name), getattr(traced, name)
        g.argtypes, g.restype = f.argtypes, f.restype
    proxy_score._LIB = traced
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    for name, H, P in (("quickstart", 2, 2), ("mixed3", 32, 3)):
        x, (w1, b1, w2, b2), thr = shape_operands(H, P, 64, dev, seed=P)
        n_blocks = -(-x.shape[0] // proxy_score.ROWS_PER_BLOCK)
        runs = []
        for _ in range(args.calls + 3):
            proxy_score.cascade_score(x, w1, b1, w2, b2, thr, 8192, with_scores=False,
                                      compact_cols=(0,))
            torch.cuda.synchronize()
            cyc = np.zeros(MAX_BLOCKS * 8, np.uint64)
            ns = np.zeros(MAX_BLOCKS * 8, np.uint64)
            rc = traced.cascade_phases_read(cyc.ctypes.data, ns.ctypes.data, MAX_BLOCKS * 8)
            if rc:
                raise SystemExit(f"reading the timers failed: CUDA error {rc}")
            runs.append((cyc.reshape(-1, 8)[:n_blocks].astype(np.int64),
                         ns.reshape(-1, 8)[:n_blocks].astype(np.int64)))
        runs = runs[3:]
        ghz = np.median([(c[:, 7] - c[:, 0]).sum() / max((n[:, 7] - n[:, 0]).sum(), 1)
                         for c, n in runs])
        phase_us = np.median([(c - c[:, :1]) / ghz / 1e3 for c, _n in runs], axis=0)
        entries = np.median([n[:, 0] - n[:, 0].min() for _c, n in runs], axis=0) / 1e3
        span = np.median([(n[:, 7].max() - n[:, 0].min()) / 1e3 for _c, n in runs])
        print(json.dumps({
            "source": str(args.source or "package"), "shape": name, "HP": H * P, "P": P, "blocks": n_blocks, "calls": args.calls,
            "sm_ghz": float(ghz),
            "from_block_entry_us": {ph: {"median": float(np.median(phase_us[:, k])),
                                         "max": float(phase_us[:, k].max())}
                                    for k, ph in enumerate(PHASES)},
            "entry_spread_us": {"median": float(np.median(entries)),
                                "max": float(entries.max())},
            "kernel_span_us": float(span)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
