#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py [--stream-records N]

Needs one CUDA card; exits non-zero without one, and when any phase fails.
Each phase prints one JSON line:

1. device   — torch / CUDA versions, card name, power limit; kernel build.
2. kernels  — the CUDA ``cascade_score`` (scoring, survivor scan and
              compaction in one launch) against its plain PyTorch version
              on the card over ragged shapes, int8 / fp8 / f32 weights,
              every output option, no and all survivors, and 1,024 blocks.
3. main_path — the port's optimize-and-execute path at the ``twitter``
              profile's full width (F=64, four UDFs of hidden 48 and depth
              2, a 5% optimization sample of 40,000 records) over a stream
              of 1,048,576 records, for two queries; then a profile of 16
              tiles of each (device busy share, pinned and pageable
              uploads, the host's busiest calls).
4. timing   — CUDA-event times of the kernel and its plain version at the
              main path's shapes, beside the card's bound for that work;
              the kernel's device µs and device events a call, host µs a
              call, and the scorer's whole route on warm and cold tiles.
5. flash_kernels — the CUDA ``flash_attention`` (bf16, and f32 up to
              D = 128: wgmma on the tensor cores, f32 as three bf16 pieces
              after the ``split_bf16`` pre-pass; f32 at D = 256: CUDA cores)
              against its plain PyTorch version on the card, by absolute and
              per-row limits, each case on the route ``route`` picks (counted
              per route): the JAX package's test shapes, GQA groups 1, 7 and
              8, D = 256, ragged lengths on either side of a 128-row tile,
              D = 16 and 32 over several KV tiles, and the serving shape
              (B 4, S 4096, H 64, K 8, D 128) in f32 and bf16; ``split_bf16``
              against its plain version bit for bit; and planted faults in
              both types (64 keys' P.V skipped, which the per-row limit must
              reject; in f32 also inputs without their mid and lo pieces).
6. dense_path — the dense family's serving path at deepseek-67b's full
              width (d_model 8192, 64 query and 8 KV heads of 128, d_ff
              22016, vocab 102400), depth cut to 4 layers, bf16, seeded
              random weights: prefill of 4 requests of 4,096 tokens, then 32
              greedy ``decode_step``s each; each layer's kernel output held
              against the plain version on the prefill's own inputs, and
              the logits against the same model's ``forward`` with the
              kernel's plain version in its place, one request at a time.
              Then the same in f32 (``dense_path_float32``): every launch on
              the split route, two ``split_bf16`` launches each.
7. flash_timing — CUDA-event times of the kernel, its plain version and
              ``scaled_dot_product_attention`` at the serving shape in bf16
              and f32, beside the route's bound (and in f32 the CUDA-core
              bound), with the route, the kernel's registers and spills from
              the compiler's report and its shared memory a block, and in
              f32 ``split_bf16`` alone; and profiles of one prefill and one
              decode step.
8. ssd_kernels — the CUDA ``ssd_chunk`` (wgmma on the tensor cores where
              shape and layout allow, f32 as two bf16 pieces; otherwise CUDA
              cores)
              against its plain PyTorch version on the card, each output by
              a limit relative to its largest plain value (``chunk_decay``
              element by element): the JAX package's test shapes, G = 2 < H,
              the tensor-core route's edges (ragged Q, P 16 and 32, N 16 to
              64, B and C sliced from one wider tensor), Q = 256 with
              realistic, near-zero and JAX-init log-decays, and the serving
              shape (mamba2-2.7b, 4 x 4,096 tokens) in f32 and bf16, each on
              the route it must take; and planted faults the check must
              reject (``chunk_decay`` forced to 0 in both types; M rounded to
              bf16 alone; in f32 inputs without their lo pieces).
9. ssm_path — the SSM family's serving path at mamba2-2.7b's full width and
              depth (64 layers, d_model 2560, 80 heads of 64, d_state 128,
              vocab 50288), bf16, seeded random weights with Mamba-2's
              published A_log / dt_bias ranges: prefill of 4 requests of
              4,096 tokens, then 32 greedy ``decode_step``s each (64 kernel
              launches in the prefill, all on the tensor cores, none in
              decode); each layer's
              ``ops.ssd`` output and final state held against the plain
              route on the layer's own inputs, a planted fault in one layer
              caught there, and the logits against ``forward`` with the
              plain version in the kernel's place, one request at a time:
              held in f32 at 64 layers (its 64 prefill launches all on the
              tensor cores) and in bf16 at the first 4, reported in bf16 at
              64 (``SSM_LOGIT_LAYERS``).
10. ssd_timing — CUDA-event times of the kernel and its plain version at the
              serving shape in bf16 and f32, beside the route's bound (and
              in f32 the CUDA-core bound), with the route taken
              and the kernel's registers, spills and shared memory a block;
              and profiles of one SSM prefill and one decode step.
11. serving_path — CORE's adaptive serving stack (``CoreSession.serve`` with
              ``ServeConfig(adaptive=True, tile=1024)``, the serve CLI's
              ``--adaptive --drift`` flow) over 1,048,576 records: a 5%
              optimization sample, two predicates, A = 0.9, UDFs of hidden
              64 and depth 2, and a drifting stream over the other 95% with
              the CLI's shift targets and the boundary at a quarter.  Every
              submit-time tile on ``cascade_score`` (launches == tiles),
              emitted + rejected == served, a plan swap after the boundary,
              served accuracy >= A - 0.05, and ``score_margins`` on 4 of the
              stream's tiles against the plain route.
12. multiquery_path — three queries in one ``CoreSession`` (phase 3's
              quickstart and mixed3, and a third that shares the first's
              proxy on their common predicate) over 262,144 held-out records
              of phase 11's dataset: one stacked ``cascade_score`` launch a
              chunk, the stacked (F, HP, P) and its shared columns, each
              query's emissions against an isolated ``CascadeServer`` twin,
              the rows whose stacked mask differs from the isolated one, the
              UDF cache's hit rate, and conservation.  Phases 11 and 12 then
              time the kernel at their launch shapes (``serving_timing``):
              the ``score_margins`` tile and the stacked chunk, each beside
              its plain version and its bound.
13. frontend_path — the SLO front end through ``CoreSession.serve(slo=)``:
              phase 3's mixed3 query over 65,536 held-out rows of phase 11's
              dataset as 128-row requests at 1.3x capacity, each due 3x its
              full-plan cost: conservation, at least one degrade swap, and
              one ``cascade_score`` launch a submitted tile across the swaps.
14. artifact_path — COREWIRE on the card: phase 3's two plans and mixed3
              at int8 and fp8 weights serialized, deserialized onto the card
              (the codes handed to the scorer as they came) and serialized
              again to identical bytes; phase 3's stream scored through the
              original and the deserialized scorer (masks, survivor lists and
              counts equal bit for bit, one launch a tile); ``execute_plan``
              on the deserialized plans against phase 3; frames of the three
              kinds; a frame and an artifact kept apart; three planted faults
              (minor 3, a truncated payload, a wrong predicate count)
              rejected; the int8 and fp8 quant parity gates on the card.
15. plan_cache_path — the cross-query plan cache over phase 11's dataset
              (a query on three columns, proxies trained on the card): cold,
              an exact repeat (HIT, its replayed scorer bit-identical to the
              cold plan's on 262,144 held-out rows through the kernel, build
              time at most 0.2 of cold), the COREPLNC container byte-stable,
              a similar query (WARM, fewer B&B visits, cost within 5%), a
              dissimilar one (COLD, accuracy >= A - 0.05), and an adaptive
              ``CascadeServer`` over a 262,144-record drifting stream that
              writes back its initial plan and every swap.
16. fleet_path — the fleet through ``CoreSession.serve(hosts=4)``: phase
              11's workload and query, its plan optimized with
              ``keep_state``, four inline hosts over ``bench_sharded.py``'s
              skewed drift (4 x 262,144 records, boundary at a quarter),
              tile 1024, ``AdaptivePolicy(audit_rate=0.015)``, every host
              scoring with scorers it deserialized from COREWIRE bytes: a
              committed quorum swap, every host at the final epoch, exact
              conservation (each host's emitted + rejected == submitted,
              nothing in flight, no index twice, disjoint hosts, each
              emission under its submission's version), launches ==
              submitted tiles, served accuracy >= A - 0.05 over the union
              of the streams; records/s, consensus and re-optimization ms a
              swap, the swap log.
17. fleet_thread — the same streams with one thread a host: the swap log
              and every host's emitted list equal phase 16's, launches ==
              tiles.
18. fleet_process — four worker processes (``python -m
              repro_torch.distributed.procworker``), each rebuilding the
              workload from its seeds on the card, over 2^17 records of the
              same generator: a committed swap, conservation, every
              worker's drain reply on the card with its own launches ==
              its tiles, the swap log and emitted sets equal to an inline
              run on the same streams; worker start seconds, and one UDF
              trained twice on the card compared bit for bit.
19. fleet_faults — inline, four hosts, 2^18 records: the primary
              coordinator killed in ``prepare`` (the standby aborts), at
              ``commit`` and ``mid-commit`` (it completes or re-syncs), and
              host 0 silent through the first barrier under ``fence`` (one
              fence, one re-sync, ``fenced [0]``) and ``nack`` (the swap
              aborts); each conserving exactly with launches == tiles.

Then the card's name and power limit as ``nvidia-smi`` gives them, the
``{"kernels": [...]}`` summary, and ``{"ok": true, "device": {...}}`` last.
Weights are random (seeded); nothing is read from disk but the sources.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
import types
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 on CUDA cores and
# dense bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
# kernel vs plain version: both IEEE fp32, summed in different orders
SCORE_TOL = 1e-5
# kernel path vs the raw-params reference path: the packed form folds the
# standardizer into the weights, a float32 reassociation
FOLD_TIE_TOL = 1e-4
# The serving path (phase 11): the serve CLI's --adaptive --drift flow at
# 2^20 records; the multi-query path (phase 12) over 2^18 held-out records
# of the same dataset.
SERVING = dict(n=1_048_576, correlation=0.9, udf_hidden=64, udf_depth=2, udf_train_rows=3000,
               declared_cost_ms=20.0, k_frac=0.05, preds=2, accuracy=0.9, tile=1024)
MULTIQUERY_RECORDS = 262_144
# The SLO front-end path (phase 13): requests of 128 held-out rows at 1.3x
# the full plan's capacity (the serve CLI's default load), each due 3x its
# full-plan cost after it arrives
FRONTEND = dict(records=65_536, request_rows=128, load=1.3, slo_factor=3.0)
# The plan-cache path (phase 15): held-out rows the replayed scorer scores,
# and the drifting stream the write-back server serves
PLAN_CACHE_RECORDS = 262_144
# The fleet (phases 16-19): four simulated hosts on phase 11's workload,
# ``bench_sharded.py``'s skewed drift (shift targets, correlation gain, skew
# 0.3) with each shard's boundary at a quarter, its policy (audit rate
# 0.015), tile 1024 and one 1,024-record chunk a host a round.  Records over
# all hosts: the inline and thread paths 2^20, the process path 2^17 (rows
# travel base64 in JSON), the fault injections 2^18 each.
FLEET = dict(hosts=4, records=1_048_576, process_records=131_072, fault_records=262_144,
             shift_targets={0: 2.8, 1: -2.6, 2: 2.8}, corr_gain=2.5, drift_skew=0.3,
             audit_rate=0.015, tile=1024, chunk=1024)

TWITTER = dict(n=40_000, n_features=64, n_columns=4, correlation=0.9,
               feature_noise=1.1, label_noise=0.25, udf_hidden=48, udf_depth=2,
               udf_train_rows=3000, cost_scale={0: 1.0, 1: 3.0, 2: 0.3, 3: 1.5},
               declared_cost_ms=20.0, k_frac=0.05)
QUERIES = (  # (name, columns, selectivity, A, proxy kind, make_query seed)
    ("quickstart", [0, 1], 0.5, 0.9, "svm", 1),
    ("mixed3", [0, 1, 2], 0.5, 0.9, "mixed", 2),
)
# (N, n_valid, F, H, P, weights, with_scores, compact_cols[, thresholds]):
# compact_cols None (every column), a tuple, or "off" (no compaction
# outputs, as ``score_masks`` and ``score_margins`` launch); thresholds
# "median" (the default: each column's median plain score), "none" (float32
# max: no survivors) or "all" (-max: every valid row)
KERNEL_CASES = (
    (1, 1, 64, 2, 1, "float32", True, None),
    (127, 127, 64, 32, 3, "float32", False, (0, 1, 2)),
    (8191, 8191, 128, 128, 3, "int8", True, (1,)),
    (8192, 5000, 64, 32, 3, "int8", False, None),
    (8192, 8192, 128, 2, 130, "float32", True, None),
    (8192, 8192, 64, 2, 2, "float32", False, (0,)),
    (8192, 8000, 64, 32, 1, "float32", True, (0,)),
    (4096, 4096, 128, 128, 130, "int8", True, (0, 64, 129)),
    # ragged 64-row blocks, F and int8 HP that rule out 16-byte copies
    (255, 200, 64, 2, 2, "float32", True, None),
    (257, 257, 17, 1, 3, "int8", True, (0, 2)),
    (8191, 8191, 33, 3, 5, "float32", True, (4,)),
    # no survivors, every valid row a survivor, fp8 codes
    (8192, 8192, 64, 32, 3, "float32", False, (0,), "none"),
    (8192, 6000, 64, 32, 3, "int8", False, (0, 1, 2), "all"),
    (2048, 2048, 64, 32, 3, "fp8", True, (0,)),
    # 1,024 blocks: many waves, look-back windows of 32 across them
    (65536, 65001, 64, 8, 2, "float32", False, (1,)),
    # the serving path's score_margins tile (scores on, no compaction), full
    # and ragged, and the multi-query path's stacked score_masks chunk
    (1024, 1024, 64, 2, 2, "float32", True, "off"),
    (1024, 847, 64, 2, 2, "float32", True, "off"),
    (4096, 4096, 64, 32, 6, "float32", False, "off"),
)
# flash_attention kernel vs its plain version: the tolerances of the JAX
# package's kernel test (tests/test_kernels.py:68), atol = rtol.  f32: both
# IEEE f32, summed in other orders.  bf16: p is rounded to bf16 against the
# running row max in the kernel and against the whole row's max in the plain
# version.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# ... and, per output row (one query position of one head), the largest
# difference over the row's largest plain value.  A row that attends n
# random keys has values near sqrt(e/n), about 0.03 at n = 4096, as small as
# the absolute tolerance, so the absolute check alone cannot see a dropped KV
# tile there.  bf16: two bf16 steps of the row's largest value (both versions
# round an f32 result that differs by far less than a step, so they differ
# by at most one step).  f32: many f32 steps, far below any fault.
FLASH_ROW_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
SERVING_SHAPE = (4, 4096, 4096, 64, 8, 128)  # (B, Sq, Sk, H, K, D) of the prefill
# The planted fault the row check must catch at the serving shape: the P.V
# product of the last 64-key tile skipped (its values zeroed in the kernel's
# input), which only the rows that attend the most keys see.
FAULT_KEYS = (4032, 4096)
# (B, Sq, Sk, H, K, D, causal, dtype)
FLASH_CASES = tuple(
    (*shape, causal, dtype) for dtype in ("float32", "bfloat16") for shape, causal in (
        # the JAX package's test shapes (tests/test_kernels.py:54-58)
        ((1, 128, 128, 4, 4, 32), True), ((1, 128, 128, 4, 4, 32), False),
        ((2, 256, 256, 8, 2, 64), True), ((2, 256, 256, 8, 2, 64), False),
        ((1, 128, 384, 4, 1, 128), False),
        # GQA groups 1, 7 and 8 at ragged lengths
        ((2, 333, 333, 8, 8, 128), True), ((2, 200, 200, 14, 2, 64), True),
        ((1, 257, 257, 64, 8, 128), True), ((1, 100, 300, 16, 2, 128), False),
        # D = 256, and the smallest head dims
        ((2, 130, 130, 8, 1, 256), True), ((1, 64, 200, 4, 2, 256), False),
        ((3, 1, 1, 4, 2, 32), True), ((1, 77, 131, 8, 1, 16), False),
        # ragged edges on either side of the bf16 kernel's 128-row tile
        ((1, 255, 255, 8, 8, 128), True), ((2, 129, 385, 4, 1, 64), False),
        # the narrow-swizzle head dims (32 B at D = 16, 64 B at D = 32) over
        # more than one KV tile
        ((1, 512, 512, 8, 2, 16), True), ((1, 512, 512, 8, 2, 32), True),
        (SERVING_SHAPE, True)))
# The dense serving path (phase 6) and its logits tolerances against the
# plain-attention forward: those the JAX package holds its own bf16 serving
# path to (tests/test_models_consistency.py:38 for prefill vs forward, :88
# for decode vs forward): bf16 rounds at other places when the kernel and
# the GEMMs see other shapes and orders.
DENSE = dict(arch="deepseek-67b", layers=4, batch=4, prompt=4096, new_tokens=32)
PREFILL_TOL = 5e-2
DECODE_TOL = 8e-2
# The SSM serving path (phases 8-10) at mamba2-2.7b's full width and depth,
# and the shape its prefill gives ``ssd_chunk`` in every layer:
# (nc, Q, H, G, P, N) = (4 x 4096 / 256 chunks, 256, 80, 1, 64, 128).
SSM = dict(arch="mamba2-2.7b", layers=64, batch=4, prompt=4096, new_tokens=32)
SSD_SERVING = (64, 256, 80, 1, 64, 128)
# ssd_chunk kernel vs its plain version, y_diag and states: the largest
# difference over the tensor's largest plain value.  Both widen to f32 and sum
# in f32 in other orders; 1e-4 is the JAX package's kernel test tolerance
# (tests/test_kernels.py:81), taken relative to the largest value because at
# Q = 256 single elements where large terms cancel miss it element by element
# (tests/test_torch_ssd.py::test_ssd_chunk_at_q256).  The same for bf16
# inputs: both versions widen the same bf16 values.
SSD_TOL = 1e-4
# chunk_decay = exp(cum[-1]), element by element: relative error up to
# DECAY_TOL (the JAX test's 1e-5) plus the f32 summation bound of the two
# cumsums, 2 (Q - 1) 2^-24 sum|dA| (the kernel sums in sequence, a CUDA
# torch.cumsum in a scan; exp turns the exponent's absolute error into a
# relative one); below f32's smallest normal, absolutely.
DECAY_TOL = 1e-5
# Per layer of the SSM prefill, the kernel route of ``ops.ssd`` against its
# plain route: y is bf16, so two bf16 steps of its largest value (the f32
# results differ by far less, and each rounds to one step); the final state is
# f32, held like ``states``.
SSM_Y_TOL = 2.0 ** -6
SSM_STATE_TOL = SSD_TOL
# The logits against forward at PREFILL_TOL / DECODE_TOL hold in bf16 at the
# depth the JAX package sets those bounds for (its reduced configs: 4
# layers); at 64 layers bf16 rounding alone moves them by more (two plain
# routes that round at other places differ by 0.15), so there they are held
# in f32 and reported in bf16.
SSM_LOGIT_LAYERS = 4
# (nc, Q, H, G, P, N, dA, dtype[, "sliced"]); dA: how the log-decay is drawn,
# "sliced": B and C slices of one wider tensor, as the model passes them
# (ssd_inputs)
SSD_CASES = (
    # the JAX package's test shapes (tests/test_kernels.py:75); P = 8 in bf16
    # takes the CUDA-core route
    (2, 16, 4, 4, 8, 16, "jax_test", "float32"), (4, 64, 2, 2, 16, 32, "jax_test", "float32"),
    (2, 16, 4, 4, 8, 16, "jax_test", "bfloat16"),
    # G = 2 < H, and chunks that are not a multiple of the 64-row tile
    (3, 128, 8, 2, 64, 128, "published", "float32"),
    (3, 128, 8, 2, 64, 128, "published", "bfloat16"),
    (5, 80, 6, 3, 8, 16, "jax_test", "float32"), (2, 208, 4, 1, 32, 64, "published", "float32"),
    # the tensor-core route's edges: ragged Q (80, 208, and 48 under one
    # 64-row box), G < H, P 16 and 32, N 16 to 64
    (5, 80, 6, 3, 16, 16, "jax_test", "bfloat16"), (2, 208, 4, 1, 32, 64, "published", "bfloat16"),
    (4, 64, 4, 2, 16, 32, "jax_test", "bfloat16"), (3, 48, 4, 2, 32, 32, "published", "bfloat16"),
    # Q = 256 with realistic, near-zero and JAX-init (chunk_decay 0) log-decays
    (8, 256, 16, 1, 64, 128, "published", "float32"),
    (8, 256, 16, 1, 64, 128, "near_zero", "float32"),
    (8, 256, 16, 1, 64, 128, "jax_init", "float32"),
    (8, 256, 16, 1, 64, 128, "near_zero", "bfloat16"),
    (8, 256, 16, 1, 64, 128, "jax_init", "bfloat16"),
    # B and C at the token stride of one wider tensor, as in the model
    (4, 256, 8, 1, 64, 128, "published", "bfloat16", "sliced"),
    # the serving shape
    (*SSD_SERVING, "published", "float32"), (*SSD_SERVING, "published", "bfloat16"),
)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ------------------------------------------------------------- phase 2
def make_kernel_case(case, dev, seed):
    """Random packed cascade operands at one case's shape, thresholds at
    each column's median plain score so masks split."""
    from repro_torch.core.proxy_family import (PackedCascade, cascade_kernel_operands,
                                               quantize_cascade)
    from repro_torch.kernels.proxy_score import cascade_score_plain

    N, n_valid, F, H, P, weights, _scores, _cols = case[:8]
    thr_mode = case[8] if len(case) > 8 else "median"
    rng = np.random.RandomState(seed)
    packed = PackedCascade(
        w1=(rng.randn(F, H, P) / np.sqrt(F)).astype(np.float32),
        b1=(0.1 * rng.randn(H, P)).astype(np.float32),
        w2=(rng.randn(H, P) / np.sqrt(H)).astype(np.float32),
        b2=(0.1 * rng.randn(P)).astype(np.float32),
        hidden=(H,) * P, families=("mlp1",) * P)
    if weights != "float32":
        packed = quantize_cascade(packed, weights)
    ops = [torch.from_numpy(a).to(dev) for a in cascade_kernel_operands(packed)]
    out_scale = (None if packed.out_scale is None
                 else torch.from_numpy(packed.out_scale).to(dev))
    x = torch.from_numpy(rng.randn(N, F).astype(np.float32)).to(dev)
    s, _m, _p, _c = cascade_score_plain(x, *ops, torch.zeros(P, device=dev), N,
                                        out_scale=out_scale, with_compaction=False)
    fmax = float(np.finfo(np.float32).max)
    thr = {"median": s.median(dim=0).values.contiguous(),
           "none": torch.full((P,), fmax, device=dev),
           "all": torch.full((P,), -fmax, device=dev)}[thr_mode]
    return x, ops, thr, out_scale


def check_kernel_case(case, dev, seed=0) -> float:
    """Kernel vs plain version on the card.  Returns the max abs score
    error (0 when the case does not ask for scores).  Scores within
    rtol=atol=1e-5; masks equal except rows whose plain score lies within
    1e-5*max(1,|thr|) of the threshold; packed lists and counts exactly
    what the kernel's own mask implies."""
    from repro_torch.kernels.proxy_score import cascade_score, cascade_score_plain

    N, n_valid, F, H, P, weights, with_scores, cols = case[:8]
    compact = cols != "off"
    x, (w1, b1, w2, b2), thr, out_scale = make_kernel_case(case, dev, seed)
    sk, mk, pk, ck = cascade_score(x, w1, b1, w2, b2, thr, n_valid, out_scale=out_scale,
                                   with_scores=with_scores, with_compaction=compact,
                                   compact_cols=cols if compact else None)
    sp, mp, _pp, _cp = cascade_score_plain(x, w1, b1, w2, b2, thr, n_valid,
                                           out_scale=out_scale, with_compaction=False)
    sync(dev)
    err = 0.0
    if with_scores:
        check(sk.shape == (N, P) and bool(torch.isfinite(sk).all()), f"{case}: bad scores")
        err = float((sk - sp).abs().max())
        check(bool(torch.allclose(sk, sp, rtol=SCORE_TOL, atol=SCORE_TOL)),
              f"{case}: scores differ by {err}")
    else:
        check(sk is None, f"{case}: scores returned without with_scores")
    tie = (sp - thr).abs() <= SCORE_TOL * torch.clamp(thr.abs(), min=1.0)
    bad = (mk != mp) & ~tie
    check(not bool(bad.any()), f"{case}: {int(bad.sum())} mask entries differ off a tie")
    check(not bool(mk[n_valid:].any()), f"{case}: padding rows kept")
    if not compact:
        check(pk is None and ck is None, f"{case}: compaction outputs without compaction")
        return err
    if len(case) > 8:
        want = 0 if case[8] == "none" else n_valid
        check(bool((ck == want).all()), f"{case}: counts {ck.tolist()[:4]}, want {want}")
    check(torch.equal(ck, mk.sum(0, dtype=torch.int32)), f"{case}: counts != mask sums")
    sel = list(range(P)) if cols is None else list(cols)
    check(tuple(pk.shape) == (len(sel), N), f"{case}: packed shape {tuple(pk.shape)}")
    for ci, col in enumerate(sel):
        rows = torch.nonzero(mk[:, col]).flatten().to(torch.int32)
        n = rows.numel()
        check(torch.equal(pk[ci, :n], rows), f"{case}: packed column {col} rows differ")
        check(bool((pk[ci, n:] == -1).all()), f"{case}: packed column {col} tail not -1")
    return err


# ------------------------------------------------------------- phase 3
def tie_rows(plan, x: np.ndarray, rows: np.ndarray, tol: float) -> set:
    """Rows (of ``rows``) whose raw-params proxy score lies within
    tol*max(1,|thr|) of some stage threshold."""
    out = set()
    if len(rows) == 0:
        return out
    for st in plan.stages:
        if st.proxy is None:
            continue
        s = st.proxy.score(x[rows])
        near = np.abs(s - st.threshold) <= tol * max(1.0, abs(st.threshold))
        out |= set(rows[near].tolist())
    return out


def run_main_path(dev, n_stream: int):
    from repro_torch.core import (OptimizeOptions, build_plan, execute_plan, orig_plan,
                                  plan_accuracy)
    from repro_torch.data.synthetic import (make_dataset, make_drifting_stream, make_query,
                                            make_udfs)
    from repro_torch.kernels.proxy_score import cascade_score

    prof = TWITTER
    t0 = time.perf_counter()
    ds = make_dataset(name="twitter", n=prof["n"], n_features=prof["n_features"],
                      n_columns=prof["n_columns"], correlation=prof["correlation"],
                      feature_noise=prof["feature_noise"], label_noise=prof["label_noise"],
                      seed=0)
    udfs = make_udfs(ds, hidden=prof["udf_hidden"], depth=prof["udf_depth"],
                     train_rows=prof["udf_train_rows"], seed=0,
                     declared_cost_ms=prof["declared_cost_ms"],
                     cost_scale=prof["cost_scale"], device=dev)
    stream = make_drifting_stream(ds, n_stream, 0, seed=1).x
    k = int(prof["k_frac"] * prof["n"])
    x_opt = ds.x[:k]
    emit("main_path_setup", records=n_stream, k=k, features=prof["n_features"],
         udf_train_accuracy=[u.train_accuracy for u in udfs],
         setup_s=time.perf_counter() - t0)
    tile = 8192
    n_tiles = -(-n_stream // tile)
    plans, outcomes = [], {}
    cascade_score.launches = 0
    for name, cols, sel, A, kind, seed in QUERIES:
        q = make_query(ds, udfs, columns=cols, target_selectivity=sel, accuracy_target=A,
                       seed=seed)
        t0 = time.perf_counter()
        plan = build_plan(q, x_opt, OptimizeOptions(mode="core", kind=kind), device=dev)
        optimize_s = time.perf_counter() - t0
        before = cascade_score.launches
        sync(dev)
        t0 = time.perf_counter()
        res = execute_plan(plan, stream, batch_size=tile, use_kernel=True, fused=True,
                           device=dev)
        sync(dev)
        exec_s = time.perf_counter() - t0
        launches = cascade_score.launches - before
        plans.append((name, plan))
        proxied = [s for st, s in zip(plan.stages, res.stages) if st.proxy is not None]
        check(len(proxied) > 0, f"{name}: plan has no proxied stage")
        check(all(s.used_kernel for s in proxied), f"{name}: a proxied stage skipped the kernel")
        check(launches == n_tiles, f"{name}: {launches} kernel launches for {n_tiles} tiles")
        plain = execute_plan(plan, stream, batch_size=tile, use_kernel=False, device=dev)
        diff = np.asarray(sorted(set(res.passed.tolist()) ^ set(plain.passed.tolist())),
                          np.int64)
        unexplained = set(diff.tolist()) - tie_rows(plan, stream, diff, FOLD_TIE_TOL)
        check(not unexplained, f"{name}: {len(unexplained)} passed rows differ off a tie")
        orig = execute_plan(orig_plan(q), stream, batch_size=tile, device=dev)
        acc = plan_accuracy(res, orig)
        saving = 1.0 - res.model_cost_ms / orig.model_cost_ms
        check(acc >= A - 0.05, f"{name}: accuracy {acc:.4f} < {A - 0.05}")
        outcomes[name] = dict(passed=res.passed, accuracy=acc, orig=orig)
        emit("main_path", query=name, kind=kind, order=list(plan.order),
             families=[None if s.proxy is None else s.proxy.family for s in plan.stages],
             hidden=[None if s.proxy is None else int(s.proxy.packed().hidden)
                     for s in plan.stages],
             accuracy=acc, accuracy_floor=A - 0.05, cost_saving=saving,
             core_ms_per_record=res.cost_per_record(n_stream),
             orig_ms_per_record=orig.cost_per_record(n_stream),
             passed=int(len(res.passed)), passed_diff_vs_reference_path=int(len(diff)),
             launches=launches, tiles=n_tiles, optimize_s=optimize_s, execute_s=exec_s,
             rows_per_s=n_stream / exec_s, fused_score_s=res.fused_score_ms / 1e3,
             fused_score_ms_per_tile=res.fused_score_ms / n_tiles,
             proxy_gate_s=sum(s.proxy_ms for s in res.stages) / 1e3,
             udf_s=sum(s.udf_ms for s in res.stages) / 1e3,
             optimizer_stats=plan.meta["stats"])
    total = cascade_score.launches
    return plans, stream, total, outcomes


# ------------------------------------------------------------- phase 4
def cuda_ms(fn, dev, iters: int, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def device_profile(fn, dev, watch: str | None = None) -> dict:
    """Run ``fn`` once under ``torch.profiler``: host wall time, the summed
    device time of every kernel and copy it ran, the busiest names, and
    (with ``watch``) the time and count of the names that hold it."""
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            tot, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    busy_us = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    out = {"wall_us": wall_us, "device_busy_us": busy_us,
           "device_busy_share": busy_us / wall_us if wall_us else None,
           "device_events": sum(n for _, n in by_name.values()),
           "top": [{"name": k[:80], "us": t, "count": n} for k, (t, n) in top],
           "copies": {k: n for k, (_t, n) in by_name.items() if k.startswith("Memcpy")},
           "host_top": [{"name": e.key[:60], "self_us": e.self_cpu_time_total, "count": e.count}
                        for e in sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
                        [:8]]}
    if watch is not None:
        hits = [v for k, v in by_name.items() if watch in k]
        us = sum(t for t, _ in hits)
        out["watch"] = {"name": watch, "us": us, "count": sum(n for _, n in hits),
                        "share": us / busy_us if busy_us else None}
    return out


def bound(N, F, HP, P, C, wbytes, with_scores, quantized):
    """Least time for the function on these inputs: each input read once,
    each output written once, over HBM; fp32 FMAs over the fp32 peak."""
    nbytes = (4 * N * F + wbytes * (F * HP + HP * P) + 4 * HP + 4 * P * (2 + quantized)
              + N * P + (4 * N * P if with_scores else 0) + 4 * C * N + 4 * P)
    flops = 2 * N * HP * (F + P)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def time_main_shapes(plans, stream, dev, iters: int):
    from repro_torch.kernels.ops import CascadeScorer
    from repro_torch.kernels.proxy_score import cascade_score, cascade_score_plain

    rows = []
    x = torch.from_numpy(np.ascontiguousarray(stream[:8192], np.float32)).to(dev)
    N = x.shape[0]
    for qi, (name, plan) in enumerate(plans):
        sc = CascadeScorer.from_plan(plan, device=dev)
        cols = (next(c for c in sc.stage_cols if c is not None),)
        args = (x, sc.w1, sc.b1, sc.w2, sc.b2, sc.thr, N)
        kw = dict(out_scale=sc.out_scale, with_scores=False, compact_cols=cols)
        sk = cascade_score(*args, out_scale=sc.out_scale, with_compaction=False)[0]
        sp = cascade_score_plain(*args, out_scale=sc.out_scale, with_compaction=False)[0]
        err = float((sk - sp).abs().max())
        check(err <= SCORE_TOL * (1.0 + float(sp.abs().max())), f"{name}: score error {err}")
        # plain, kernel, kernel, plain: the two versions compared within one call
        plain_a = cuda_ms(lambda: cascade_score_plain(*args, **kw), dev, iters)
        kern_a = cuda_ms(lambda: cascade_score(*args, **kw), dev, iters)
        kern_b = cuda_ms(lambda: cascade_score(*args, **kw), dev, iters)
        plain_b = cuda_ms(lambda: cascade_score_plain(*args, **kw), dev, iters)
        calls = 50
        prof = device_profile(lambda: [cascade_score(*args, **kw) for _ in range(calls)], dev)
        kernel_us = {t["name"]: t["us"] / calls for t in prof["top"]
                     if "cascade_" in t["name"]}
        # host time to issue one call (no synchronise inside the loop)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            cascade_score(*args, **kw)
        host_us = (time.perf_counter() - t0) * 1e6 / iters
        sync(dev)
        # the scorer's whole route for one host tile: staging into pinned
        # memory, upload, the kernel, one fetch, one event wait
        tile = np.ascontiguousarray(stream[:N], np.float32)
        sc.score_compact(tile, compact_cols=cols)
        t0 = time.perf_counter()
        for _ in range(iters // 4):
            sc.score_compact(tile, compact_cols=cols)
        tile_ms = (time.perf_counter() - t0) * 1e3 / (iters // 4)
        tprof = device_profile(lambda: [sc.score_compact(tile, compact_cols=cols)
                                        for _ in range(10)], dev)
        # the same on tiles the host has not touched since phase 3 (as the
        # executor meets them), and the copy into pinned memory alone
        n_cold = min(32, len(stream) // N // (2 * len(plans)))
        cold = [stream[(2 * qi * n_cold + i) * N:(2 * qi * n_cold + i + 1) * N]
                for i in range(2 * n_cold)]
        t0 = time.perf_counter()
        for tl in cold[:n_cold]:
            sc.score_compact(tl, compact_cols=cols)
        cold_tile_ms = (time.perf_counter() - t0) * 1e3 / n_cold
        pinned = torch.empty(tile.shape, dtype=torch.float32, pin_memory=True)
        t0 = time.perf_counter()
        for tl in cold[n_cold:]:
            pinned.copy_(torch.from_numpy(tl))
        stage_ms = (time.perf_counter() - t0) * 1e3 / n_cold
        F, HP = sc.w1.shape
        P = sc.w2.shape[1]
        bound_ms, bound_by, nbytes, flops = bound(
            N, F, HP, P, len(cols), 1 if sc.dtype == "int8" else 4, False,
            sc.out_scale is not None)
        rows.append(dict(query=name, N=N, F=int(F), HP=int(HP), P=int(P), C=len(cols),
                         ms=min(kern_a, kern_b), ms_runs=[kern_a, kern_b],
                         plain_ms=min(plain_a, plain_b), plain_ms_runs=[plain_a, plain_b],
                         bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
                         max_abs_err=err, kernel_device_us_per_call=kernel_us,
                         kernel_device_us=sum(kernel_us.values()),
                         device_events_per_call=prof["device_events"] / calls,
                         device_us_per_call=prof["device_busy_us"] / calls,
                         host_us_per_call=host_us,
                         wall_us_per_call=prof["wall_us"] / calls,
                         scorer_tile_ms=tile_ms, scorer_cold_tile_ms=cold_tile_ms,
                         pinned_stage_cold_ms=stage_ms, host_threads=torch.get_num_threads(),
                         scorer_device_events_per_tile=tprof["device_events"] / 10,
                         scorer_copies_per_10_tiles=tprof["copies"]))
        emit("timing", **rows[-1])
    return rows


def profile_main_path(plans, stream, dev, tiles: int = 16):
    """Device busy share of ``execute_plan`` over the stream's first tiles."""
    from repro_torch.core import execute_plan

    x = stream[:tiles * 8192]
    for name, plan in plans:
        execute_plan(plan, x[:8192], use_kernel=True, device=dev)  # warm
        out = {}
        prof = device_profile(
            lambda: out.update(res=execute_plan(plan, x, use_kernel=True, device=dev)), dev)
        copies = prof["copies"]
        emit("main_path_profile", query=name, records=len(x), tiles=tiles,
             fused_score_ms_per_tile=out["res"].fused_score_ms / tiles,
             h2d_pinned=sum(n for k, n in copies.items() if "HtoD" in k and "Pinned" in k),
             h2d_pageable=sum(n for k, n in copies.items()
                              if "HtoD" in k and "Pageable" in k), **prof)


# ------------------------------------------------------------- phase 5
def make_flash_case(case, dev, seed):
    B, Sq, Sk, H, K, D, _causal, dtype = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    return [torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dt)
            for shape in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D))]


def flash_errors(out: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max abs difference, largest per-row difference over that row's
    largest |ref|, whether allclose at FLASH_TOL) of an attention output."""
    dtype = str(ref.dtype).removeprefix("torch.")
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    tol = FLASH_TOL[dtype]
    row = diff.amax(dim=-1) / ref.abs().amax(dim=-1).clamp_min(torch.finfo(torch.float32).tiny)
    return (float(diff.max()), float(row.max()),
            bool(torch.allclose(out, ref, rtol=tol, atol=tol)))


def check_flash_output(what: str, out, ref) -> tuple:
    """``out`` within FLASH_TOL (atol = rtol) and FLASH_ROW_TOL of ``ref``.
    Returns (max abs error, max row error)."""
    check(out.shape == ref.shape and out.dtype == ref.dtype, f"{what}: bad output")
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    dtype = str(ref.dtype).removeprefix("torch.")
    err, row_err, close = flash_errors(out, ref)
    check(close, f"{what}: kernel differs from its plain version by {err} "
          f"(tol {FLASH_TOL[dtype]})")
    check(row_err <= FLASH_ROW_TOL[dtype], f"{what}: a row differs from its plain version "
          f"by {row_err} of its largest value (tol {FLASH_ROW_TOL[dtype]})")
    return err, row_err


def route_taken(counter, before: dict) -> str:
    """The route whose launch count in ``counter.route_launches`` rose since
    ``before`` (a copy of it): "plain" when none did (a CPU run)."""
    rose = [r for r, n in counter.route_launches.items() if n > before[r]]
    check(len(rose) <= 1, f"one call launched on several routes: {rose}")
    return rose[0] if rose else "plain"


def check_split_bf16(dev) -> dict:
    """``split_bf16`` against its plain version, bit for bit, at the serving
    shape's K (uniform values over many binades) and at a ragged length."""
    from repro_torch.kernels.flash_attention import split_bf16, split_bf16_plain

    B, _Sq, Sk, _H, K, D = SERVING_SHAPE
    gen = torch.Generator(device=dev).manual_seed(5)
    cases = [torch.randn((B, Sk, K, D), generator=gen, device=dev)
             * torch.exp(4 * torch.randn((B, Sk, K, D), generator=gen, device=dev)),
             torch.randn(1_000_003, generator=gen, device=dev)]
    differ, err = 0, 0.0
    for t in cases:
        for a, b in zip(split_bf16(t), split_bf16_plain(t)):
            differ += int((a.view(torch.int16) != b.view(torch.int16)).sum())
            err = max(err, float((a.float() - b.float()).abs().max()))
    sync(dev)
    check(differ == 0, f"split_bf16 differs from its plain version in {differ} pieces")
    return dict(elements=sum(t.numel() for t in cases), pieces_differ=differ, max_abs_err=err)


def check_flash_case(case, dev, seed=0) -> tuple:
    """Kernel vs plain version on the card.  Returns (max abs error, max
    row error)."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    causal = case[6]
    q, k, v = make_flash_case(case, dev, seed)
    out = flash_attention(q, k, v, causal=causal)
    ref = flash_attention_plain(q, k, v, causal=causal)
    sync(dev)
    return check_flash_output(str(case), out, ref)


def planted_fault(dev, dtype: str = "bfloat16") -> dict:
    """The serving-shape check against kernel outputs with faults planted.
    Skipped tile: the kernel run with the values of FAULT_KEYS zeroed, which
    is what a kernel that skipped that tile's P.V product would return; the
    row check must reject it.  In f32 (the split route) also lost pieces:
    the kernel run on q, k and v rounded to bf16, so their mid and lo pieces
    are 0, which the f32 limits must reject.  Each held against the plain
    version on the true values."""
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_plain,
                                                     route)

    case = (*SERVING_SHAPE, True, dtype)
    q, k, v = make_flash_case(case, dev, seed=0)
    want = flash_attention_plain(q, k, v, causal=True)
    bad_v = v.clone()
    bad_v[:, FAULT_KEYS[0]:FAULT_KEYS[1]] = 0
    err, row_err, close = flash_errors(flash_attention(q, k, bad_v, causal=True), want)
    del bad_v
    caught = row_err > FLASH_ROW_TOL[dtype]
    check(caught, f"{dtype}: a skipped KV tile passes the row check ({row_err})")
    out = dict(dtype=dtype, route=route(q, k, v), keys=list(FAULT_KEYS), max_abs_err=err,
               max_row_err=row_err, caught_by_abs_tol=not close, caught_by_row_tol=caught)
    if dtype == "float32":
        hi = [t.to(torch.bfloat16).float() for t in (q, k, v)]
        err, row_err, close = flash_errors(flash_attention(*hi, causal=True), want)
        lost = not close or row_err > FLASH_ROW_TOL[dtype]
        check(lost, f"inputs without their mid and lo pieces pass the f32 check ({err}, "
              f"{row_err})")
        out["lost_pieces"] = dict(max_abs_err=err, max_row_err=row_err, caught=lost)
    return out


# ------------------------------------------------------------- phase 6
def run_dense_path(dev, layers: int, batch: int, prompt: int, new_tokens: int,
                   dtype: str = "bfloat16") -> dict:
    """Prefill ``batch`` requests of ``prompt`` tokens through the port's
    family API, decode ``new_tokens`` greedy tokens each, and hold every
    logit row against ``forward`` with the plain attention in the kernel's
    place.  ``dtype`` is the config's (the published bf16, or f32, whose
    attention takes the split route).  Returns the phase's numbers,
    ``launches`` among them: the kernel launches of the prefill-and-decode
    run alone, with their routes and, in f32, the ``split_bf16`` launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash_module
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.models import layers as model_layers
    from repro_torch.models.registry import get_family, make_batch

    cfg = get_config(DENSE["arch"]).replace(num_layers=layers, dtype=dtype)
    fam = get_family(cfg)
    t0 = time.perf_counter()
    model = fam.init(0, cfg, device=dev)
    tokens = make_batch(cfg, batch, prompt, seed=0, device=dev)["tokens"]
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())

    seen = []  # each layer's (q, k, v, kernel output) in the prefill

    def kept(q, k, v, *, causal=True):
        out = flash_attention(q, k, v, causal=causal)
        seen.append((q, k, v, out))
        return out

    flash_module.reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(model_layers, "flash_attention", kept):
        logits, cache = fam.prefill(model, cfg, {"tokens": tokens})
    sync(dev)
    prefill_s = time.perf_counter() - t0
    prefill_launches = flash_attention.launches
    pad = (0, 0, 0, 0, 0, new_tokens)
    cache = {"k": torch.nn.functional.pad(cache["k"], pad),
             "v": torch.nn.functional.pad(cache["v"], pad), "pos": cache["pos"]}
    steps = [logits]
    fed = []
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(new_tokens):
        fed.append(steps[-1].argmax(dim=-1))
        lg, cache = fam.decode_step(model, cfg, cache, fed[-1])
        steps.append(lg)
    sync(dev)
    decode_s = time.perf_counter() - t0
    launches = flash_attention.launches
    route_launches = dict(flash_attention.route_launches)
    split_launches = flash_module.split_bf16.launches
    check(prefill_launches == cfg.num_layers,
          f"prefill launched the kernel {prefill_launches} times for {cfg.num_layers} layers")
    check(launches == prefill_launches, f"decode launched the kernel {launches - prefill_launches}"
          " times; it takes the plain path")
    if dev.type == "cuda":
        path = flash_module.route_for(cfg.attention.head_dim, getattr(torch, dtype))
        check(route_launches[path] == launches, f"not every launch took {path}: {route_launches}")
        split = dtype == "float32" and path == "tensor_cores"
        check(split_launches == 2 * launches * split,
              f"{split_launches} split_bf16 launches for {launches} attention launches")
    # With random weights the attention adds little to the logits, so the
    # logits check below cannot see an attention fault: hold each layer's
    # kernel output against the plain version on the path's own inputs.
    attn_errs = [check_flash_output(f"layer {layer}, request {r}", o[r:r + 1],
                                    flash_attention_plain(q[r:r + 1], k[r:r + 1], v[r:r + 1],
                                                          causal=True))
                 for layer, (q, k, v, o) in enumerate(seen) for r in range(batch)]
    check(len(attn_errs) == cfg.num_layers * batch,
          f"{len(seen)} layers of the prefill reached the kernel's wrapper")
    attn_err = max((e for e, _ in attn_errs), default=0.0)
    attn_row_err = max((r for _, r in attn_errs), default=0.0)
    seen.clear()
    got = torch.stack(steps, dim=1)  # (B, new_tokens + 1, V): positions prompt-1 ...
    check(got.shape == (batch, new_tokens + 1, cfg.vocab_size), f"logits {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite serving logits")
    seq = torch.cat([tokens, torch.stack(fed, dim=1)], dim=1)  # (B, prompt + new_tokens)

    prefill_err = decode_err = 0.0
    t0 = time.perf_counter()
    with mock.patch.object(model_layers, "flash_attention", flash_attention_plain):
        for r in range(batch):  # one request at a time: the plain (S, S) scores fit
            ref = fam.forward(model, cfg, {"tokens": seq[r:r + 1]})[0, prompt - 1:]
            check(bool(torch.isfinite(ref).all()), f"request {r}: non-finite reference")
            ok_p = torch.allclose(got[r, 0], ref[0], rtol=PREFILL_TOL, atol=PREFILL_TOL)
            ok_d = torch.allclose(got[r, 1:], ref[1:], rtol=DECODE_TOL, atol=DECODE_TOL)
            prefill_err = max(prefill_err, float((got[r, 0] - ref[0]).abs().max()))
            decode_err = max(decode_err, float((got[r, 1:] - ref[1:]).abs().max()))
            check(ok_p, f"request {r}: prefill logits differ from forward by {prefill_err}")
            check(ok_d, f"request {r}: decode logits differ from forward by {decode_err}")
            del ref
    reference_s = time.perf_counter() - t0
    check(flash_attention.launches == launches, "the reference launched the kernel")
    out = dict(arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
               heads=cfg.attention.num_heads, kv_heads=cfg.attention.num_kv_heads,
               head_dim=cfg.attention.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
               dtype=cfg.dtype, params=n_params, requests=batch, prompt_tokens=prompt,
               new_tokens=new_tokens, cache_len=cache["k"].shape[2], launches=launches,
               route_launches=route_launches, split_bf16_launches=split_launches,
               prefill_launches=prefill_launches, init_s=init_s, prefill_s=prefill_s,
               prefill_tokens_per_s=batch * prompt / prefill_s, decode_s=decode_s,
               decode_ms_per_step=decode_s / new_tokens * 1e3,
               decode_tokens_per_s=batch * new_tokens / decode_s,
               attention_max_abs_err=attn_err, attention_max_row_err=attn_row_err,
               prefill_max_abs_err=prefill_err, prefill_tol=PREFILL_TOL,
               decode_max_abs_err=decode_err, decode_tol=DECODE_TOL,
               logits_max_abs=float(got.abs().max()), reference_s=reference_s,
               peak_memory_gib=torch.cuda.max_memory_allocated(dev) / 2**30
               if dev.type == "cuda" else None)
    emit("dense_path" if dtype == "bfloat16" else f"dense_path_{dtype}", **out)
    out["model"], out["cfg"], out["tokens"] = model, cfg, tokens
    return out


# ------------------------------------------------------------- phase 7
# The f32 tensor-core routes run each product as several bf16 products of
# pieces: flash six (three pieces each), ssd three (two pieces each).
SPLIT_PRODUCTS = {"flash_attention": 6, "ssd_chunk": 3}


def flash_bound(B, Sq, Sk, H, K, D, causal, dtype, route="cuda_cores"):
    """Least time for the function on these inputs: q, k, v read once and o
    written once over HBM; the two products' flops (the causal pairs only)
    over the peak for the type: bf16 tensor cores, or IEEE f32 CUDA cores.
    The f32 tensor-core route's own bound instead counts its six bf16
    products of pieces at the bf16 peak, plus the K and V pre-pass (read
    once, three bf16 pieces written) over HBM."""
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * (2 * B * Sq * H * D + 2 * B * Sk * K * D)
    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    flops = 4 * B * H * D * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    if dtype == "float32" and route == "tensor_cores":
        t_ops = SPLIT_PRODUCTS["flash_attention"] * flops / BF16_FLOPS
        t_pre = 2 * B * Sk * K * D * (4 + 3 * 2) / HBM_BYTES_PER_S
        return ((max(t_bytes, t_ops) + t_pre) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)
    t_ops = flops / (BF16_FLOPS if dtype == "bfloat16" else FP32_FLOPS)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def ptxas_entry(log: str, fragment: str) -> dict:
    """Registers and spills that the compiler's report (``-Xptxas -v``)
    gives for the entry function whose mangled name holds ``fragment``."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and fragment in line:
            block = "\n".join(lines[i + 1:i + 6])
            stack, stores, loads = (int(x) for x in re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                block).groups())
            return {"registers": int(re.search(r"Used (\d+) registers", block).group(1)),
                    "stack_bytes": stack, "spill_store_bytes": stores, "spill_load_bytes": loads}
    raise SmokeFailure(f"no entry function {fragment} in the compiler's report")


def time_flash(dev, dtype: str, iters: int) -> dict:
    """Kernel, plain version and ``scaled_dot_product_attention`` at the
    serving shape, in turns (plain, kernel, library, kernel, plain).  The
    library call gets K and V repeated to every query head beforehand (its
    GQA layout), outside the timed region.  The route taken, its bound and
    (f32) the CUDA-core bound beside it; registers and spills from the
    compiler's report and shared memory a block.  On the split route also
    ``split_bf16`` alone on K, beside its plain version and its bytes
    bound."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_plain,
                                                     resources, route, split_bf16,
                                                     split_bf16_plain)

    B, Sq, Sk, H, K, D = SERVING_SHAPE
    case = (*SERVING_SHAPE, True, dtype)
    q, k, v = make_flash_case(case, dev, seed=7)
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(H // K, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(H // K, dim=1)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    out = flash_attention(q, k, v, causal=True)
    lib_err = float((library().transpose(1, 2).float() - out.float()).abs().max())
    plain_a = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True), dev, 1, warmup=1)
    kern_a = cuda_ms(lambda: flash_attention(q, k, v, causal=True), dev, iters, warmup=1)
    lib_ms = cuda_ms(library, dev, 10 * iters, warmup=2)
    kern_b = cuda_ms(lambda: flash_attention(q, k, v, causal=True), dev, iters, warmup=0)
    plain_b = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True), dev, 1, warmup=0)
    path = route(q, k, v)
    bound_ms, bound_by, nbytes, flops = flash_bound(*case, route=path)
    ms = min(kern_a, kern_b)
    row = dict(shape=list(SERVING_SHAPE), causal=True, dtype=dtype, route=path, ms=ms,
               ms_runs=[kern_a, kern_b], plain_ms=min(plain_a, plain_b),
               plain_ms_runs=[plain_a, plain_b], library_ms=lib_ms,
               library="scaled_dot_product_attention (K, V repeated to H heads)",
               library_max_abs_diff=lib_err, bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, flops=flops, tflops_per_s=flops / (ms * 1e-3) / 1e12,
               share_of_bound=bound_ms / ms)
    if dtype == "float32":
        row["cuda_core_bound_ms"] = flash_bound(*case)[0]
        row["share_of_cuda_core_bound"] = row["cuda_core_bound_ms"] / ms
    split = path == "tensor_cores" and dtype == "float32"
    if path == "tensor_cores":
        entry, fragment = "flash_attention_wgmma", f"flash_attention_wgmmaILi{D}ELb{int(split)}E"
    else:
        entry, fragment = "flash_attention_kernel", f"flash_attention_kernelILi{D}E"
    log = _build.library_path("flash_attention").with_suffix(".log").read_text()
    row["ptxas"] = {"entry": f"{entry}<{D}{', true' if split else ''}>",
                    **ptxas_entry(log, fragment)}
    row.update(resources(D, q.dtype))
    if split:
        n = k.numel()
        pre_a = cuda_ms(lambda: split_bf16(k), dev, 10 * iters, warmup=2)
        pre_plain = cuda_ms(lambda: split_bf16_plain(k), dev, 10 * iters, warmup=2)
        pre_b = cuda_ms(lambda: split_bf16(k), dev, 10 * iters, warmup=0)
        pre_bound = n * (4 + 3 * 2) / HBM_BYTES_PER_S * 1e3
        row["split_bf16"] = dict(shape=list(k.shape), ms=min(pre_a, pre_b),
                                 ms_runs=[pre_a, pre_b], plain_ms=pre_plain,
                                 bound_ms=pre_bound, bound_by="bytes",
                                 share_of_bound=pre_bound / min(pre_a, pre_b),
                                 ptxas=ptxas_entry(log, "split_bf16_kernel"))
    emit("flash_timing", **row)
    return row


def profile_serving(dense: dict, dev) -> None:
    """Device time by kernel over one more prefill of the serving batch and
    over one decode step after it."""
    from repro_torch.models.registry import get_family

    cfg, model, tokens = dense["cfg"], dense["model"], dense["tokens"]
    fam = get_family(cfg)
    prof = device_profile(lambda: fam.prefill(model, cfg, {"tokens": tokens}), dev)
    emit("prefill_profile", **prof)
    logits, cache = fam.prefill(model, cfg, {"tokens": tokens})
    pad = (0, 0, 0, 0, 0, 1)
    cache = {"k": torch.nn.functional.pad(cache["k"], pad),
             "v": torch.nn.functional.pad(cache["v"], pad), "pos": cache["pos"]}
    prof = device_profile(lambda: fam.decode_step(model, cfg, cache, logits.argmax(-1)), dev)
    emit("decode_profile", **prof)


# ------------------------------------------------------------- phase 8
def published_dynamics(num_layers: int, heads: int, seed: int):
    """(A_log, dt_bias), each (num_layers, heads) float32 numpy, drawn from
    Mamba-2's published init ranges (arXiv:2405.21060; mamba_ssm's
    A_init_range (1, 16), dt_min 1e-3, dt_max 1e-1): A = U[1, 16], dt
    log-uniform in [1e-3, 1e-1], dt_bias = softplus^-1(dt).  The JAX
    package's init (A_log 0, dt_bias 0) gives a 256-step chunk a log-decay
    near -200, whose exp is exactly 0 in f32: no state crosses a chunk."""
    rng = np.random.RandomState(seed)
    A_log = np.log(rng.uniform(1.0, 16.0, (num_layers, heads)))
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (num_layers, heads)))
    dt_bias = dt + np.log(-np.expm1(-dt))
    return A_log.astype(np.float32), dt_bias.astype(np.float32)


def ssd_inputs(case, dev, seed):
    """x, dA, B, C of one ``SSD_CASES`` entry on ``dev``.  dA per head and
    step: "jax_test" -|N(0,1)| 0.1 (the JAX test's); "published" -A dt with
    (A, dt) per head from ``published_dynamics`` and dt moved per step as a
    projection moves it, softplus(N(0,1) + dt_bias); "near_zero"
    -|N(0,1)| 1e-4; "jax_init" -softplus(N(0,1)) (A_log 0, dt_bias 0)."""
    nc, Q, H, G, P, N, kind, dtype = case[:8]
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.float32

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=f32)

    x, B, C = randn(nc, Q, H, P), randn(nc, Q, G, N), randn(nc, Q, G, N)
    if case[8:] == ("sliced",):  # [x-wide filler, B, C] per token, as the conv output
        wide = torch.cat([randn(nc, Q, H * P), B.flatten(2), C.flatten(2)], dim=-1)
        wide = wide.to(getattr(torch, dtype))
        B = wide[..., H * P:H * P + G * N].unflatten(2, (G, N))
        C = wide[..., H * P + G * N:].unflatten(2, (G, N))
    z = randn(nc, Q, H)
    if kind == "jax_test":
        dA = -z.abs() * 0.1
    elif kind == "near_zero":
        dA = -z.abs() * 1e-4
    elif kind == "jax_init":
        dA = -torch.nn.functional.softplus(z)
    else:
        A_log, dt_bias = (torch.from_numpy(a[0]).to(dev) for a in published_dynamics(1, H, seed))
        dA = -torch.exp(A_log) * torch.nn.functional.softplus(z + dt_bias)
    dt = getattr(torch, dtype)
    return x.to(dt), dA.contiguous(), B.to(dt), C.to(dt)  # a slice keeps its strides


def ssd_errors(out, ref, dA) -> dict:
    """Kernel outputs against plain ones: y_diag's and states' largest
    absolute difference and that over the tensor's largest plain value;
    chunk_decay's largest relative difference, and whether every element
    lies within DECAY_TOL plus the cumsum bound (below f32's smallest normal
    absolutely)."""
    tiny = torch.finfo(torch.float32).tiny
    errs = {}
    for name, a, b in (("y_diag", out[0], ref[0]), ("states", out[1], ref[1])):
        diff = float((a - b).abs().max())
        errs[name] = diff
        errs[f"{name}_rel"] = diff / max(float(b.abs().max()), tiny)
    Q = dA.shape[1]
    depth = dA.abs().sum(dim=1)  # (nc, H): sum |dA| over each chunk
    limit = DECAY_TOL + 2 * (Q - 1) * 2.0 ** -24 * depth
    dk, dp = out[2], ref[2]
    diff = (dk - dp).abs()
    errs["chunk_decay_rel"] = float((diff / dp.abs().clamp_min(tiny)).max())
    errs["chunk_decay_limit_max"] = float(limit.max())
    errs["chunk_decay_ok"] = bool((diff <= limit * dp.abs() + tiny).all())
    errs["chunk_decay_min"] = float(dp.min())
    return errs


def check_ssd_output(what: str, out, ref, dA) -> dict:
    """``out`` within SSD_TOL (y_diag, states) and the chunk_decay limit of
    ``ref``; returns ``ssd_errors``."""
    for a, b in zip(out, ref):
        check(a.shape == b.shape and a.dtype == b.dtype == torch.float32, f"{what}: bad output")
        check(bool(torch.isfinite(a).all()), f"{what}: non-finite output")
    errs = ssd_errors(out, ref, dA)
    for name in ("y_diag", "states"):
        check(errs[f"{name}_rel"] <= SSD_TOL, f"{what}: {name} differs from its plain version by "
              f"{errs[f'{name}_rel']} of its largest value (tol {SSD_TOL})")
    check(errs["chunk_decay_ok"], f"{what}: chunk_decay differs from its plain version by "
          f"{errs['chunk_decay_rel']} relative (limit up to {errs['chunk_decay_limit_max']})")
    return errs


def check_ssd_case(case, dev, seed=0) -> dict:
    """Kernel vs plain version on the card; returns ``ssd_errors`` and the
    route the call took."""
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_plain

    x, dA, B, C = ssd_inputs(case, dev, seed)
    before = dict(ssd_chunk.route_launches)
    out = ssd_chunk(x, dA, B, C)
    taken = route_taken(ssd_chunk, before)
    ref = ssd_chunk_plain(x, dA, B, C)
    sync(dev)
    return dict(check_ssd_output(str(case), out, ref, dA), route=taken)


def ssd_one_term(x, dA, B, C):
    """y_diag of ``ssd_chunk_plain`` with M = (C B^T) * L rounded to bf16
    alone before its product with x: a tensor-core kernel that lost M's lo
    term."""
    f32 = torch.float32
    nc, Q, H, P = x.shape
    G = B.shape[2]
    cum = torch.cumsum(dA.transpose(1, 2), dim=-1)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]),
                    torch.zeros((), dtype=f32, device=x.device))
    scores = torch.einsum("cqgn,csgn->cgqs", C.to(f32), B.to(f32))
    mix = (scores[:, :, None] * L.view(nc, G, H // G, Q, Q)).to(torch.bfloat16).to(f32)
    xg = x.to(f32).reshape(nc, Q, G, H // G, P)
    return torch.einsum("cgrqs,csgrp->cqgrp", mix, xg).reshape(nc, Q, H, P)


def ssd_planted_fault(dev, dtype: str = "bfloat16") -> dict:
    """The serving-shape check against faults it must reject: kernel outputs
    with chunk_decay forced to 0 (what a kernel that never wrote it, or
    underflowed it, returns); in bf16, y_diag with M rounded to bf16 alone
    (``ssd_one_term``); in f32 (the split route), the kernel run on x, B and
    C rounded to bf16 (their lo pieces 0), held against the plain version on
    the true inputs."""
    from repro_torch.kernels.ssd_scan import route, ssd_chunk, ssd_chunk_plain

    x, dA, B, C = ssd_inputs((*SSD_SERVING, "published", dtype), dev, seed=0)
    y, st, dec = ssd_chunk(x, dA, B, C)
    ref = ssd_chunk_plain(x, dA, B, C)
    errs = ssd_errors((y, st, torch.zeros_like(dec)), ref, dA)
    check(not errs["chunk_decay_ok"], f"{dtype}: chunk_decay forced to 0 passes the check")
    out = dict(dtype=dtype, route=route(x, B, C), chunk_decay_rel=errs["chunk_decay_rel"],
               caught=not errs["chunk_decay_ok"])
    if dtype == "bfloat16":
        one = ssd_errors((ssd_one_term(x, dA, B, C), st, dec), ref, dA)
        check(one["y_diag_rel"] > SSD_TOL, f"y_diag with M rounded to bf16 alone passes the "
              f"check ({one['y_diag_rel']} of its largest value, tol {SSD_TOL})")
        out.update(one_term_y_diag_rel=one["y_diag_rel"], one_term_caught=True)
    else:
        lost = ssd_errors(ssd_chunk(x.to(torch.bfloat16).float(), dA, B.to(torch.bfloat16).float(),
                                    C.to(torch.bfloat16).float()), ref, dA)
        caught = lost["y_diag_rel"] > SSD_TOL or lost["states_rel"] > SSD_TOL
        check(caught, f"inputs without their lo pieces pass the check ({lost['y_diag_rel']}, "
              f"{lost['states_rel']}, tol {SSD_TOL})")
        out["lost_pieces"] = dict(y_diag_rel=lost["y_diag_rel"], states_rel=lost["states_rel"],
                                  caught=caught)
    return out


# ------------------------------------------------------------- phase 9
def set_published_dynamics(model, cfg, seed: int) -> None:
    A_log, dt_bias = published_dynamics(cfg.num_layers, cfg.ssm_heads, seed)
    with torch.no_grad():
        for i, lp in enumerate(model.layers):
            lp.A_log.copy_(torch.from_numpy(A_log[i]))
            lp.dt_bias.copy_(torch.from_numpy(dt_bias[i]))


def ssd_route_errors(got, ref) -> tuple:
    """(y's and the final state's largest difference over their largest
    plain value) of one ``ops.ssd`` call."""
    tiny = torch.finfo(torch.float32).tiny
    return tuple(float((a.float() - b.float()).abs().max()) / max(float(b.abs().max()), tiny)
                 for a, b in zip(got, ref))


def check_ssm_layers(model, cfg, tokens, fault_layer: int) -> dict:
    """One more prefill with a pass-through around ``ops.ssd``: each layer's
    kernel-route output and final state against the plain route on the
    layer's own inputs (SSM_Y_TOL, SSM_STATE_TOL), and, at
    ``fault_layer``, the kernel's outputs with chunk_decay forced to 0,
    which the same check must reject."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_plain
    from repro_torch.models import ssm as ssm_model

    errs, fault = [], {}
    ssd = ops.ssd

    def faulty(*args):
        y, st, dec = ssd_chunk(*args)
        return y, st, torch.zeros_like(dec)

    def checked(*args):
        got = ssd(*args)
        with mock.patch.object(ops, "ssd_chunk", ssd_chunk_plain):
            ref = ssd(*args)
        errs.append(ssd_route_errors(got, ref))
        if len(errs) - 1 == fault_layer:
            with mock.patch.object(ops, "ssd_chunk", faulty):
                fault["y_rel"], fault["state_rel"] = ssd_route_errors(ssd(*args), ref)
        return got

    with mock.patch.object(ssm_model.ops, "ssd", checked):
        ssm_model.prefill(model, cfg, {"tokens": tokens})
    check(len(errs) == cfg.num_layers, f"{len(errs)} layers of the prefill reached ops.ssd")
    for i, (y_rel, st_rel) in enumerate(errs):
        check(y_rel <= SSM_Y_TOL, f"layer {i}: ssd output differs from the plain route by "
              f"{y_rel} of its largest value (tol {SSM_Y_TOL})")
        check(st_rel <= SSM_STATE_TOL, f"layer {i}: final state differs from the plain route "
              f"by {st_rel} of its largest value (tol {SSM_STATE_TOL})")
    caught = fault["y_rel"] > SSM_Y_TOL or fault["state_rel"] > SSM_STATE_TOL
    check(caught, f"layer {fault_layer}: chunk_decay forced to 0 passes the layer check ({fault})")
    return dict(layer_max_y_rel=max(e[0] for e in errs),
                layer_max_state_rel=max(e[1] for e in errs),
                planted_fault=dict(layer=fault_layer, **fault, caught=caught))


def serve_greedy(fam, params, cfg, tokens, new_tokens: int) -> dict:
    """Prefill ``tokens`` and decode ``new_tokens`` greedy tokens through the
    family API.  Returns the logits (B, new_tokens + 1, V) for positions
    prompt-1 ..., the sequence with the decoded tokens, the final cache, and
    the kernel launches and host-clock seconds of each half."""
    from repro_torch.kernels.ssd_scan import ssd_chunk

    dev = tokens.device
    before = ssd_chunk.launches
    sync(dev)
    t0 = time.perf_counter()
    logits, cache = fam.prefill(params, cfg, {"tokens": tokens})
    sync(dev)
    prefill_s = time.perf_counter() - t0
    prefill_launches = ssd_chunk.launches - before
    steps, fed = [logits], []
    t0 = time.perf_counter()
    for _ in range(new_tokens):
        fed.append(steps[-1].argmax(dim=-1))
        lg, cache = fam.decode_step(params, cfg, cache, fed[-1])
        steps.append(lg)
    sync(dev)
    decode_s = time.perf_counter() - t0
    got = torch.stack(steps, dim=1)
    check(bool(torch.isfinite(got).all()), "non-finite serving logits")
    return dict(logits=got, seq=torch.cat([tokens, torch.stack(fed, dim=1)], dim=1),
                cache=cache, prefill_s=prefill_s, decode_s=decode_s,
                prefill_launches=prefill_launches,
                decode_launches=ssd_chunk.launches - before - prefill_launches)


def logits_vs_forward(fam, params, cfg, served: dict, prompt: int, gate: bool) -> dict:
    """The served logits against ``forward`` with the kernel's plain version
    in its place, one request at a time: the prefill row against forward
    over the prompt at the model's chunk, the decode rows against forward
    over prompt + new tokens at the largest chunk that divides that length
    (the SSD decomposition gives the same function for any chunk length;
    tests/test_torch_ssd.py).  With ``gate``, fails unless they are within
    PREFILL_TOL and DECODE_TOL (allclose)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_chunk_plain

    got, seq = served["logits"], served["seq"]
    short = math.gcd(seq.shape[1], cfg.ssm.chunk)
    ref_cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=short))
    prefill_err = decode_err = 0.0
    ok = True
    with mock.patch.object(ops, "ssd_chunk", ssd_chunk_plain):
        for r in range(got.shape[0]):
            ref_p = fam.forward(params, cfg, {"tokens": seq[r:r + 1, :prompt]})[0, -1]
            ref_d = fam.forward(params, ref_cfg, {"tokens": seq[r:r + 1]})[0, prompt:]
            check(bool(torch.isfinite(ref_p).all() and torch.isfinite(ref_d).all()),
                  f"request {r}: non-finite reference")
            prefill_err = max(prefill_err, float((got[r, 0] - ref_p).abs().max()))
            decode_err = max(decode_err, float((got[r, 1:] - ref_d).abs().max()))
            ok &= bool(torch.allclose(got[r, 0], ref_p, rtol=PREFILL_TOL, atol=PREFILL_TOL))
            ok &= bool(torch.allclose(got[r, 1:], ref_d, rtol=DECODE_TOL, atol=DECODE_TOL))
            if gate:
                check(ok, f"{cfg.num_layers} layers, {cfg.dtype}, request {r}: logits differ "
                      f"from forward by {prefill_err} (prefill) / {decode_err} (decode)")
    return dict(layers=len(params.layers), dtype=cfg.dtype, prefill_max_abs_err=prefill_err,
                decode_max_abs_err=decode_err, within_tol=ok, gated=gate,
                decode_reference_chunk=short)


def run_ssm_path(dev, layers: int, batch: int, prompt: int, new_tokens: int) -> dict:
    """Prefill ``batch`` requests of ``prompt`` tokens through the port's
    family API and decode ``new_tokens`` greedy tokens each (the counted
    run: ``launches``); then hold every layer's ``ops.ssd`` against its
    plain route (with a planted fault), and the logits against ``forward``
    with the plain version in the kernel's place (``logits_vs_forward``):
    at PREFILL_TOL / DECODE_TOL for the model run in f32 at full depth and
    for its first SSM_LOGIT_LAYERS layers in bf16, and reported for the
    bf16 run at full depth, where rounding alone moves the logits by more
    (PERF.md, section 6).  Returns the phase's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash_module
    from repro_torch.kernels import proxy_score, ssd_scan
    from repro_torch.kernels.ssd_scan import ssd_chunk
    from repro_torch.models.registry import get_family, make_batch

    cfg = get_config(SSM["arch"]).replace(num_layers=layers)
    fam = get_family(cfg)
    t0 = time.perf_counter()
    model = fam.init(0, cfg, device=dev)
    set_published_dynamics(model, cfg, seed=0)
    tokens = make_batch(cfg, batch, prompt, seed=0, device=dev)["tokens"]
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    counters = (ssd_chunk, flash_module.flash_attention, proxy_score.cascade_score)
    for fn in counters:
        fn.launches = 0
    ssd_scan.reset_launches()
    served = serve_greedy(fam, model, cfg, tokens, new_tokens)
    launches = ssd_chunk.launches
    route_launches = dict(ssd_chunk.route_launches)
    others = [fn.launches for fn in counters[1:]]
    check(served["prefill_launches"] == cfg.num_layers,
          f"prefill launched the kernel {served['prefill_launches']} times for "
          f"{cfg.num_layers} layers")
    check(served["decode_launches"] == 0,
          f"decode launched the kernel {served['decode_launches']} times; it takes the "
          "recurrent step")
    check(others == [0, 0], f"the SSM path launched other kernels: {others}")
    if dev.type == "cuda":
        check(route_launches["tensor_cores"] == launches,
              f"not every prefill launch took the tensor cores: {route_launches}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
    check(served.pop("cache")["pos"] == prompt + new_tokens, "cache position")
    got = served["logits"]
    check(got.shape == (batch, new_tokens + 1, cfg.vocab_size), f"logits {tuple(got.shape)}")

    layer_check = check_ssm_layers(model, cfg, tokens, fault_layer=layers // 2)
    t0 = time.perf_counter()
    full_bf16 = logits_vs_forward(fam, model, cfg, served, prompt, gate=False)
    n_short = min(SSM_LOGIT_LAYERS, layers)
    shallow = types.SimpleNamespace(embed=model.embed, layers=model.layers[:n_short],
                                    final_norm=model.final_norm)
    cfg_short = cfg.replace(num_layers=n_short)
    short_bf16 = logits_vs_forward(fam, shallow, cfg_short,
                                   serve_greedy(fam, shallow, cfg_short, tokens, new_tokens),
                                   prompt, gate=True)
    model32, cfg32 = copy.deepcopy(model).float(), cfg.replace(dtype="float32")
    ssd_scan.reset_launches()
    served32 = serve_greedy(fam, model32, cfg32, tokens, new_tokens)
    f32_launches = dict(ssd_chunk.route_launches)
    check(served32["prefill_launches"] == cfg.num_layers and served32["decode_launches"] == 0,
          f"the f32 run launched the kernel {served32['prefill_launches']} / "
          f"{served32['decode_launches']} times (prefill / decode) for {cfg.num_layers} layers")
    if dev.type == "cuda":
        check(f32_launches["tensor_cores"] == cfg.num_layers,
              f"not every f32 prefill launch took the tensor cores: {f32_launches}")
    full_f32 = logits_vs_forward(fam, model32, cfg32, served32, prompt, gate=True)
    del model32, served32
    reference_s = time.perf_counter() - t0
    s = cfg.ssm
    out = dict(arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
               d_inner=cfg.d_inner, heads=cfg.ssm_heads, head_dim=s.head_dim,
               d_state=s.d_state, ngroups=s.ngroups, chunk=s.chunk, vocab=cfg.vocab_size,
               dtype=cfg.dtype, params=n_params, requests=batch, prompt_tokens=prompt,
               new_tokens=new_tokens, launches=launches, route_launches=route_launches,
               f32_route_launches=f32_launches,
               prefill_launches=served["prefill_launches"], init_s=init_s,
               prefill_s=served["prefill_s"],
               prefill_tokens_per_s=batch * prompt / served["prefill_s"],
               decode_s=served["decode_s"],
               decode_ms_per_step=served["decode_s"] / new_tokens * 1e3,
               decode_tokens_per_s=batch * new_tokens / served["decode_s"], **layer_check,
               layer_y_tol=SSM_Y_TOL, layer_state_tol=SSM_STATE_TOL,
               prefill_tol=PREFILL_TOL, decode_tol=DECODE_TOL,
               logits_vs_forward=[full_bf16, short_bf16, full_f32],
               logits_max_abs=float(got.abs().max()), reference_s=reference_s,
               peak_memory_gib=peak)
    emit("ssm_path", **out)
    out["model"], out["cfg"], out["tokens"] = model, cfg, tokens
    return out


# ------------------------------------------------------------- phase 10
def ssd_bound(nc, Q, H, G, P, N, dtype, route="cuda_cores"):
    """Least time for the function on these inputs: x, B, C and dA read once
    and y_diag, states, chunk_decay written once over HBM; its multiply-adds
    over the peak for the input type (bf16 tensor cores, or IEEE f32 CUDA
    cores): C B^T over N once per chunk and group for the causal pairs, the
    scores times x over P per head, and the states over Q per head.  The f32
    tensor-core route's own bound counts its three bf16 products of pieces
    at the bf16 peak instead."""
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * (nc * Q * H * P + 2 * nc * Q * G * N) + 4 * (
        nc * Q * H + nc * Q * H * P + nc * H * P * N + nc * H)
    pairs = Q * (Q + 1) // 2
    flops = 2 * nc * (G * pairs * N + H * pairs * P + H * Q * P * N)
    t_bytes = nbytes / HBM_BYTES_PER_S
    if dtype == "float32" and route == "tensor_cores":
        t_ops = SPLIT_PRODUCTS["ssd_chunk"] * flops / BF16_FLOPS
    else:
        t_ops = flops / (BF16_FLOPS if dtype == "bfloat16" else FP32_FLOPS)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def time_ssd(dev, dtype: str, iters: int) -> dict:
    """Kernel and plain version at the serving shape, in turns (plain,
    kernel, kernel, plain), with the route the kernel took and its
    registers, spills (the compiler's report) and shared memory a block.
    No single PyTorch call computes the function, so there is no library
    time."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import resources, route, ssd_chunk, ssd_chunk_plain

    case = (*SSD_SERVING, "published", dtype)
    x, dA, B, C = ssd_inputs(case, dev, seed=7)
    errs = ssd_errors(ssd_chunk(x, dA, B, C), ssd_chunk_plain(x, dA, B, C), dA)
    path = route(x, B, C)
    _nc, Q, _H, _G, P, N = SSD_SERVING
    if path == "cuda_cores":
        entry, fragment = ("ssd_chunk_kernel", "ssd_chunk_kernelI"
                           + ("13__nv_bfloat16" if dtype == "bfloat16" else "f") + "E")
    else:
        entry = "ssd_chunk_wgmma" if dtype == "bfloat16" else "ssd_chunk_split"
        fragment = f"{entry}ILi{P}ELi{N}E"
    log = _build.library_path("ssd_chunk").with_suffix(".log").read_text()
    kernel = dict(route=path, entry=entry, **ptxas_entry(log, fragment),
                  **resources(path, Q, P, N, x.dtype))
    plain_a = cuda_ms(lambda: ssd_chunk_plain(x, dA, B, C), dev, 2, warmup=1)
    kern_a = cuda_ms(lambda: ssd_chunk(x, dA, B, C), dev, iters, warmup=2)
    kern_b = cuda_ms(lambda: ssd_chunk(x, dA, B, C), dev, iters, warmup=0)
    plain_b = cuda_ms(lambda: ssd_chunk_plain(x, dA, B, C), dev, 2, warmup=0)
    bound_ms, bound_by, nbytes, flops = ssd_bound(*SSD_SERVING, dtype, route=path)
    ms = min(kern_a, kern_b)
    row = dict(shape=list(SSD_SERVING), dtype=dtype, route=path, ms=ms, ms_runs=[kern_a, kern_b],
               plain_ms=min(plain_a, plain_b), plain_ms_runs=[plain_a, plain_b],
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               flops=flops, gbytes_per_s=nbytes / (ms * 1e-3) / 1e9,
               share_of_bound=bound_ms / ms, max_abs_err=max(errs["y_diag"], errs["states"]),
               kernel=kernel)
    if dtype == "float32":
        row["cuda_core_bound_ms"] = ssd_bound(*SSD_SERVING, dtype)[0]
    emit("ssd_timing", **row)
    return row


def profile_ssm(ssm: dict, dev) -> None:
    """Device time by kernel over one more SSM prefill of the serving batch
    and over one decode step after it."""
    from repro_torch.models.registry import get_family

    cfg, model, tokens = ssm["cfg"], ssm["model"], ssm["tokens"]
    fam = get_family(cfg)
    prof = device_profile(lambda: fam.prefill(model, cfg, {"tokens": tokens}), dev,
                          watch="ssd_chunk")
    emit("ssm_prefill_profile", **prof)
    logits, cache = fam.prefill(model, cfg, {"tokens": tokens})
    prof = device_profile(lambda: fam.decode_step(model, cfg, cache, logits.argmax(-1)), dev)
    emit("ssm_decode_profile", **prof)


# ------------------------------------------------------------- phase 11
SERVE_CHUNK = 4096  # records a ``run_stream`` submit takes (its default)


def serving_workload(dev, n: int):
    """Phase 11's dataset (``make_dataset`` at the serve CLI's settings, n
    records), its UDFs on ``dev``, and the optimization sample's size k (the
    CLI's 5%)."""
    from repro_torch.data.synthetic import make_dataset, make_udfs

    prof = SERVING
    ds = make_dataset(n=n, correlation=prof["correlation"], seed=0)
    udfs = make_udfs(ds, hidden=prof["udf_hidden"], depth=prof["udf_depth"],
                     train_rows=prof["udf_train_rows"], seed=0,
                     declared_cost_ms=prof["declared_cost_ms"], device=dev)
    return ds, udfs, max(1000, int(prof["k_frac"] * n))


def submit_tiles(n: int, max_tile: int) -> int:
    """Scorer tiles that ``run_stream(x, chunk=SERVE_CHUNK)`` submits for n
    records when each submit is cut into tiles of ``max_tile`` rows."""
    return sum(-(-min(SERVE_CHUNK, n - s) // max_tile) for s in range(0, n, SERVE_CHUNK))


def check_margins(scorer, plan, x: np.ndarray, dev) -> dict:
    """``scorer.score_margins`` on the tile ``x`` against the plain route on
    the card: masks equal except tie rows (``tie_rows`` at FOLD_TIE_TOL),
    margins min_p |s_p - thr_p| within SCORE_TOL * max(1, max |thr|)."""
    from repro_torch.kernels.proxy_score import cascade_score_plain

    masks, margins = scorer.score_margins(x)
    xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    s, m, _pk, _cnt = cascade_score_plain(xt, scorer.w1, scorer.b1, scorer.w2, scorer.b2,
                                          scorer.thr, len(x), out_scale=scorer.out_scale,
                                          with_compaction=False)
    want_margins = (s - scorer.thr).abs().min(dim=1).values.cpu().numpy()
    want_masks = m.cpu().numpy()
    check(masks.shape == want_masks.shape and margins.shape == (len(x),),
          f"score_margins shapes {masks.shape} {margins.shape}")
    diff = np.flatnonzero((masks != want_masks).any(axis=1))
    unexplained = set(diff.tolist()) - tie_rows(plan, x, diff, FOLD_TIE_TOL)
    check(not unexplained, f"score_margins: {len(unexplained)} mask rows differ off a tie")
    tol = SCORE_TOL * max(1.0, float(np.abs(scorer.thr_host).max()))
    err = float(np.abs(margins - want_margins).max())
    check(err <= tol, f"score_margins: margins differ by {err} (tol {tol})")
    return dict(rows=len(x), mask_rows_differ=int(len(diff)), margin_max_abs_err=err,
                margin_tol=tol)


def time_serving_shape(shape: str, scorer, x_host: np.ndarray, with_scores: bool, dev,
                       iters: int) -> dict:
    """CUDA-event times of ``cascade_score`` and its plain version at one
    serving launch shape (no compaction outputs, as ``score_margins`` and
    ``score_masks`` launch), with the serving scorer's own weights, beside
    the card's bound for that work; the kernel's device µs a call from a
    profile; and the scorer's whole route for the same host tile on the
    host clock."""
    from repro_torch.kernels.proxy_score import cascade_score, cascade_score_plain

    x = torch.from_numpy(np.ascontiguousarray(x_host, np.float32)).to(dev)
    N = x.shape[0]
    args = (x, scorer.w1, scorer.b1, scorer.w2, scorer.b2, scorer.thr, N)
    kw = dict(out_scale=scorer.out_scale, with_scores=with_scores, with_compaction=False)
    sk = cascade_score(*args, out_scale=scorer.out_scale, with_compaction=False)[0]
    sp = cascade_score_plain(*args, out_scale=scorer.out_scale, with_compaction=False)[0]
    err = float((sk - sp).abs().max())
    check(err <= SCORE_TOL * (1.0 + float(sp.abs().max())), f"{shape}: score error {err}")
    # plain, kernel, kernel, plain: the two versions compared within one call
    plain_a = cuda_ms(lambda: cascade_score_plain(*args, **kw), dev, iters)
    kern_a = cuda_ms(lambda: cascade_score(*args, **kw), dev, iters)
    kern_b = cuda_ms(lambda: cascade_score(*args, **kw), dev, iters)
    plain_b = cuda_ms(lambda: cascade_score_plain(*args, **kw), dev, iters)
    calls = 50
    prof = device_profile(lambda: [cascade_score(*args, **kw) for _ in range(calls)], dev)
    kernel_us = sum(t["us"] for t in prof["top"] if "cascade_" in t["name"]) / calls
    route = scorer.score_margins if with_scores else scorer.score_masks
    route(x_host)
    t0 = time.perf_counter()
    for _ in range(iters // 4):
        route(x_host)
    tile_ms = (time.perf_counter() - t0) * 1e3 / (iters // 4)
    F, HP = scorer.w1.shape
    P = scorer.w2.shape[1]
    bound_ms, bound_by, nbytes, flops = bound(
        N, F, HP, P, 0, 1 if scorer.dtype == "int8" else 4, with_scores,
        scorer.out_scale is not None)
    row = dict(shape=shape, N=N, F=int(F), HP=int(HP), P=int(P), with_scores=with_scores,
               ms=min(kern_a, kern_b), ms_runs=[kern_a, kern_b],
               plain_ms=min(plain_a, plain_b), plain_ms_runs=[plain_a, plain_b],
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
               max_abs_err=err, kernel_device_us=kernel_us,
               device_events_per_call=prof["device_events"] / calls, scorer_tile_ms=tile_ms)
    emit("serving_timing", **row)
    return row


def run_serving_path(dev, n: int) -> dict:
    """The serve CLI's ``--adaptive --drift`` flow through ``CoreSession``:
    optimize on a 5% sample, serve the drifting stream over the other 95%
    (boundary at a quarter) with the adaptive engine, and hold it to
    conservation, a swap after the boundary, served accuracy and one
    ``cascade_score`` launch a submitted tile; then ``score_margins`` on 4
    of the stream's tiles against the plain route.  Returns the phase's
    numbers and its workload for phase 12."""
    from repro_torch.core import (CoreSession, OptimizeOptions, ServeConfig, execute_plan,
                                  orig_plan)
    from repro_torch.data.synthetic import make_drifting_stream, make_query
    from repro_torch.kernels.proxy_score import cascade_score
    from repro_torch.serving.engine import CascadeServer

    prof = SERVING
    t_phase = t0 = time.perf_counter()
    ds, udfs, k = serving_workload(dev, n)
    n_stream = n - k
    stream = make_drifting_stream(
        ds, n_stream // 4, n_stream - n_stream // 4,
        shift_targets={c: (2.8 if c != 1 else -2.6) for c in range(prof["preds"])},
        corr_gain=2.5, seed=0)
    q = make_query(ds, udfs, columns=list(range(prof["preds"])), target_selectivity=0.5,
                   accuracy_target=prof["accuracy"], seed=1)
    setup_s = time.perf_counter() - t0
    session = CoreSession(options=OptimizeOptions(mode="core"), device=dev)
    session.register_query(q, ds.x[:k])
    t0 = time.perf_counter()
    srv = session.serve(config=ServeConfig(adaptive=True, tile=prof["tile"]))
    optimize_s = time.perf_counter() - t0
    check(isinstance(srv, CascadeServer), f"serve() built a {type(srv).__name__}")
    order_0 = list(srv.plan.order)
    cascade_score.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    stats = session.run_stream(stream.x, chunk=SERVE_CHUNK)
    sync(dev)
    serve_s = time.perf_counter() - t0
    launches = cascade_score.launches
    tiles = submit_tiles(stream.n, max(prof["tile"], 1024))
    orig = execute_plan(orig_plan(q), stream.x, device=dev)
    orig_set = set(orig.passed.tolist())
    served_acc = sum(1 for i in srv.emitted if i in orig_set) / max(len(orig_set), 1)
    events = [dict(signal=ev.signal, at_record=ev.at_record, observed=ev.observed,
                   expected=ev.expected, escalated=ev.escalated, nodes_visited=ev.nodes_visited,
                   reopt_ms=ev.reopt_ms, order_before=list(ev.order_before),
                   order_after=list(ev.order_after)) for ev in stats.drift_events]
    tile = prof["tile"]
    starts = (0, stream.boundary // tile * tile, stream.n // 2 // tile * tile,
              (stream.n - 1) // tile * tile)  # the last, ragged tile
    margins = [check_margins(srv._states[-1].cascade, srv.plan,
                             stream.x[s0:s0 + tile], dev) for s0 in starts]
    timing = time_serving_shape("score_margins", srv._states[-1].cascade,
                                stream.x[starts[1]:starts[1] + tile], True, dev, iters=200)
    out = dict(records=stream.n, boundary=stream.boundary, k=k, dataset_records=n,
               predicates=prof["preds"], accuracy_target=prof["accuracy"],
               order=order_0, final_order=list(srv.plan.order),
               families=[None if st.proxy is None else st.proxy.family for st in srv.plan.stages],
               emitted=stats.emitted, rejected=stats.rejected, in_flight=srv.in_flight(),
               served_accuracy=served_acc, accuracy_floor=prof["accuracy"] - 0.05,
               plan_swaps=stats.plan_swaps, drift_events=events,
               audit_records=stats.audit_records, launches=launches, tiles=tiles,
               setup_s=setup_s, optimize_s=optimize_s, serve_s=serve_s,
               records_per_s=stream.n / serve_s, fused_score_s=stats.fused_score_ms / 1e3,
               fused_score_ms_per_tile=stats.fused_score_ms / tiles,
               reopt_s=stats.reopt_ms / 1e3, model_cost_ms_per_record=stats.model_cost_ms
               / stream.n, orig_ms_per_record=orig.cost_per_record(stream.n),
               score_margins=margins, seconds=time.perf_counter() - t_phase)
    emit("serving_path", **out)
    out["timing"] = timing
    check(stats.emitted + stats.rejected == stream.n and srv.in_flight() == 0
          and len(set(srv.emitted)) == len(srv.emitted),
          f"conservation: {stats.emitted} + {stats.rejected} != {stream.n}")
    check(any(ev["at_record"] > stream.boundary for ev in events),
          f"no plan swap after the drift boundary ({stats.plan_swaps} swaps)")
    check(served_acc >= prof["accuracy"] - 0.05, f"served accuracy {served_acc:.4f}")
    check(launches == tiles, f"{launches} cascade_score launches for {tiles} submitted tiles")
    out["workload"] = (ds, udfs, k)
    return out


# ------------------------------------------------------------- phase 12
def share_stage(plan, donor, pred_idx: int):
    """``plan`` with its stage for ``pred_idx`` replaced by ``donor``'s stage
    for the same predicate (the same proxy and threshold): a tenant that
    reuses another's proxy on a predicate they share."""
    from repro_torch.core.query import PhysicalPlan

    given = next(st for st in donor.stages if st.pred_idx == pred_idx)
    stages = [given if st.pred_idx == pred_idx else st for st in plan.stages]
    return PhysicalPlan(plan.query, stages, plan.est_total_cost, dict(plan.meta))


def run_multiquery_path(dev, workload, n_records: int) -> dict:
    """Three queries in one ``CoreSession`` over ``n_records`` held-out rows
    of phase 11's dataset: phase 3's quickstart and mixed3, and a third on
    columns (0, 3) that takes the first's stage for their common predicate,
    so the stacked scorer dedupes that column.  Holds one stacked launch a
    chunk, conservation, each query's emissions against an isolated
    ``CascadeServer`` twin (except tie rows), and the stacked masks against
    the isolated scorers' (differing rows counted, and tie rows only)."""
    from repro_torch.core import CoreSession, OptimizeOptions, ServeConfig, build_plan
    from repro_torch.data.synthetic import make_query
    from repro_torch.kernels.proxy_score import cascade_score
    from repro_torch.serving.engine import CascadeServer
    from repro_torch.serving.multiquery import MultiQueryEngine

    ds, udfs, k = workload
    x = ds.x[k:k + n_records]
    specs = [(name, cols, sel, A, kind, seed) for name, cols, sel, A, kind, seed in QUERIES]
    specs.append(("shares_q0", [0, 3], 0.5, 0.9, "svm", 1))
    session = CoreSession(device=dev)
    t_phase = t0 = time.perf_counter()
    handles = []
    for name, cols, sel, A, kind, seed in specs:
        q = make_query(ds, udfs, columns=cols, target_selectivity=sel, accuracy_target=A,
                       seed=seed)
        h = session.register_query(q, ds.x[:k], options=OptimizeOptions(mode="core", kind=kind))
        h.optimize()
        handles.append(h)
    first, third = handles[0], handles[2]
    check(third.query.predicates[0].values == first.query.predicates[0].values,
          "the third query shares no predicate with the first")
    third.plan = share_stage(third.plan, first.plan, 0)
    optimize_s = time.perf_counter() - t0
    eng = session.serve(config=ServeConfig(tile=SERVING["tile"]))
    check(isinstance(eng, MultiQueryEngine), f"serve() built a {type(eng).__name__}")
    cascade_score.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    session.run_stream(x, chunk=SERVE_CHUNK)
    sync(dev)
    serve_s = time.perf_counter() - t0
    launches = cascade_score.launches
    chunks = -(-len(x) // SERVE_CHUNK)
    st = eng.session_stats()
    ok, why = eng.conserved()
    sc = eng.scorer
    full = sc.score_masks(x)
    per_query = []
    for h, (name, *_rest) in zip(handles, specs):
        twin = CascadeServer(h.plan, tile=SERVING["tile"], device=dev)
        twin.run_stream(x, chunk=SERVE_CHUNK)
        got, want = set(eng.servers[h.qid].emitted), set(twin.emitted)
        diff = np.asarray(sorted(got ^ want), np.int64)
        iso = twin._states[-1].cascade.score_masks(x)
        differ = np.flatnonzero((full[:, eng._gcols[h.qid]] != iso).any(axis=1))
        per_query.append(dict(
            query=name, order=list(h.plan.order), emitted=len(got), twin_emitted=len(want),
            emitted_diff=int(len(diff)),
            emitted_diff_off_tie=len(set(diff.tolist()) - tie_rows(h.plan, x, diff,
                                                                    FOLD_TIE_TOL)),
            stacked_cols=list(eng._gcols[h.qid]), stacked_mask_rows_differ=int(len(differ)),
            stacked_differ_off_tie=len(set(differ.tolist()) - tie_rows(h.plan, x, differ,
                                                                       FOLD_TIE_TOL)),
            served_cost_ms=eng.query_stats(h.qid)["served_cost_ms"],
            weight=eng.query_stats(h.qid)["weight"]))
    out = dict(records=len(x), queries=len(handles), F=int(sc.w1.shape[0]),
               HP=int(sc.w1.shape[1]), P=sc.n_proxies, shared_cols=st["shared_cols"],
               stacked_cols_saved=st["stacked_cols_saved"], launches=launches, chunks=chunks,
               conserved=ok, conservation=why, finalized_per_query=st["finalized_per_query"],
               udf_cache=st["dedupe"], optimize_s=optimize_s, serve_s=serve_s,
               records_per_s=len(x) / serve_s, shared_score_s=st["shared_score_ms"] / 1e3,
               per_query=per_query, seconds=time.perf_counter() - t_phase)
    emit("multiquery_path", **out)
    out["timing"] = time_serving_shape("stacked_score_masks", sc, x[:SERVE_CHUNK], False, dev,
                                       iters=200)
    check(ok and st["finalized_per_query"] == [len(x)] * len(handles),
          f"conservation: {why}, finalized {st['finalized_per_query']}")
    check(st["stacked_cols_saved"] >= 1, "the stacked scorer shares no column")
    check(launches == chunks, f"{launches} cascade_score launches for {chunks} chunks")
    check(st["dedupe"]["hits"] > 0, "no UDF evaluation was shared")
    for row in per_query:
        check(row["emitted_diff_off_tie"] == 0,
              f"{row['query']}: {row['emitted_diff_off_tie']} emissions differ from the "
              "isolated twin off a tie")
        check(row["stacked_differ_off_tie"] == 0,
              f"{row['query']}: {row['stacked_differ_off_tie']} stacked mask rows differ "
              "from the isolated scorer off a tie")
    return out


# ------------------------------------------------------------- phase 13
def run_frontend_path(dev, workload, n_records: int) -> dict:
    """CORE's SLO front end through ``CoreSession.serve(slo=...)``: phase
    3's mixed3 query (three stages, so a degrade ladder of three rungs with
    scorers prebuilt on the card) over ``n_records`` held-out rows of phase
    11's dataset, arriving as Poisson requests of ``FRONTEND["request_rows"]``
    rows at ``FRONTEND["load"]`` times the full plan's capacity, each with a
    deadline of ``FRONTEND["slo_factor"]`` times its full-plan cost (the
    cost-model clock).  Holds conservation, at least one degrade swap, and
    one ``cascade_score`` launch for each tile submitted: tiles are counted
    at each ``engine.submit`` with the scorer installed at that moment, so
    the count crosses every degrade and restore swap."""
    from repro_torch.core import CoreSession, OptimizeOptions, ServeConfig
    from repro_torch.data.synthetic import make_query
    from repro_torch.kernels.proxy_score import cascade_score
    from repro_torch.serving.frontend import ServingFrontEnd

    ds, udfs, k = workload
    x = ds.x[k:k + n_records]
    name, cols, sel, A, kind, seed = QUERIES[1]
    t_phase = time.perf_counter()
    q = make_query(ds, udfs, columns=cols, target_selectivity=sel, accuracy_target=A,
                   seed=seed)
    session = CoreSession(options=OptimizeOptions(mode="core", kind=kind), device=dev)
    h = session.register_query(q, ds.x[:k])
    h.optimize()
    rows_per = FRONTEND["request_rows"]
    req_ms = h.plan.est_total_cost * rows_per
    slo_ms = FRONTEND["slo_factor"] * req_ms
    fe = session.serve(slo=slo_ms, config=ServeConfig(tile=SERVING["tile"]))
    check(isinstance(fe, ServingFrontEnd), f"serve(slo=) built a {type(fe).__name__}")
    engine = fe.engine
    n_req = len(x) // rows_per
    rate = FRONTEND["load"] / (req_ms / 1e3)
    arrivals = np.cumsum(np.random.RandomState(0).exponential(1e3 / rate, n_req))
    for r in range(n_req):
        idx = np.arange(k + r * rows_per, k + (r + 1) * rows_per)
        fe.submit_request(idx, ds.x[idx], deadline_ms=slo_ms, arrival_ms=float(arrivals[r]))
    count = dict(tiles=0, behind=0, tiles_by_level={})

    def on_submit(idxs):
        # runs right before each engine.submit: every earlier tile's launch
        # has been counted by now, and the scorer installed now scores this one
        sc = engine._states[-1].cascade
        count["behind"] += int(cascade_score.launches != count["tiles"])
        n_tiles = 0 if sc is None else -(-len(idxs) // sc.max_tile)
        count["tiles"] += n_tiles
        lvl = str(fe.level)
        count["tiles_by_level"][lvl] = count["tiles_by_level"].get(lvl, 0) + n_tiles

    fe.add_submit_hook(on_submit)
    cascade_score.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    st = fe.run()
    sync(dev)
    serve_s = time.perf_counter() - t0
    launches = cascade_score.launches
    ok, why = fe.conserved()
    lat = [r.latency_ms for r in fe.requests.values() if r.done]
    out = dict(records=n_req * rows_per, requests=st.requests_total, request_rows=rows_per,
               query=name, stages=len(h.plan.stages), ladder_rungs=len(fe._ladder),
               slo_ms=slo_ms, arrivals_per_s=rate, load=FRONTEND["load"],
               admitted=st.requests_total - st.requests_rejected_admission,
               rejected_admission=st.requests_rejected_admission,
               requests_shed=st.requests_shed, records_shed=st.records_shed,
               degrades=st.degrades, restores=st.restores, final_level=st.final_level,
               plan_swaps=engine.stats.plan_swaps, records_submitted=st.records_submitted,
               records_emitted=st.records_emitted, records_rejected=st.records_rejected,
               conserved=ok, conservation=why, goodput_ratio=st.goodput_ratio,
               latency_p50_ms=float(np.percentile(lat, 50)) if lat else None,
               latency_p95_ms=float(np.percentile(lat, 95)) if lat else None,
               launches=launches, tiles=count["tiles"], tiles_by_level=count["tiles_by_level"],
               submits_with_launches_behind=count["behind"], batches=st.batches,
               serve_s=serve_s, records_per_s=st.records_submitted / serve_s,
               seconds=time.perf_counter() - t_phase)
    emit("frontend_path", **out)
    check(ok and st.records_emitted + st.records_rejected == st.records_submitted,
          f"conservation: {why}; {st.records_emitted} + {st.records_rejected} != "
          f"{st.records_submitted}")
    check(st.records_submitted > 0, "the front end admitted no record")
    check(st.degrades >= 1 and engine.stats.plan_swaps >= 1,
          f"no degrade swap ({st.degrades} degrades, {engine.stats.plan_swaps} swaps)")
    check(any(int(lvl) > 0 and n > 0 for lvl, n in count["tiles_by_level"].items()),
          f"no tile was scored after a degrade: {count['tiles_by_level']}")
    check(launches == count["tiles"] and count["behind"] == 0,
          f"{launches} cascade_score launches for {count['tiles']} submitted tiles "
          f"({count['behind']} submits found the count behind)")
    return out

# ------------------------------------------------------------- phase 14
def score_through(scorer, x: np.ndarray):
    """``scorer.score_compact(x)`` and the tiles it submits (one
    ``cascade_score`` launch each on a card)."""
    return scorer.score_compact(x), -(-len(x) // scorer.max_tile)


def same_compaction(a, b) -> tuple:
    """(rows whose masks differ, whether the survivor lists and counts are
    equal) of two ``score_compact`` results."""
    _sa, ma, pa, ca = a
    _sb, mb, pb, cb = b
    rows = int((ma != mb).any(axis=1).sum()) if ma.shape == mb.shape else len(ma)
    return rows, (np.array_equal(ca, cb) and len(pa) == len(pb)
                  and all(np.array_equal(u, v) for u, v in zip(pa, pb)))


def run_artifact_path(dev, plans, stream: np.ndarray, outcomes: dict) -> dict:
    """COREWIRE on the card: phase 3's plans and mixed3 at int8 and fp8
    weights, each serialized from its scorer, deserialized onto the card
    (``packed=``: the codes as they came) and serialized again (the bytes
    must be identical); the stream scored through the original and the
    deserialized scorer (masks, survivor lists and counts equal bit for bit,
    one ``cascade_score`` launch a tile); ``execute_plan`` on the
    deserialized fp32 plans against phase 3's passed rows and accuracy;
    frames of the three kinds; the two channels kept apart; three planted
    faults rejected; and the int8 and fp8 parity gates on the card."""
    from repro_torch.core import execute_plan, plan_accuracy
    from repro_torch.kernels import ops
    from repro_torch.kernels.proxy_score import cascade_score

    t_phase = time.perf_counter()
    named = list(plans)
    base = dict(plans)["mixed3"]
    for dt in ("int8", "fp8"):
        named.append((f"mixed3_{dt}", dataclasses.replace(
            base, meta={**base.meta, "quant_dtype": dt})))
    rows, blobs, tiles = [], {}, 0
    cascade_score.launches = 0
    for name, plan in named:
        sc = ops.CascadeScorer.from_plan(plan, device=dev)
        t0 = time.perf_counter()
        blob = ops.serialize_scorer(plan, sc)
        serialize_ms = (time.perf_counter() - t0) * 1e3
        sync(dev)
        t0 = time.perf_counter()
        plan2, sc2 = ops.deserialize_scorer(blob, plan.query, device=dev)
        sync(dev)
        deserialize_ms = (time.perf_counter() - t0) * 1e3
        identical = ops.serialize_scorer(plan2, sc2) == blob
        blobs[name] = (plan, blob)
        a, n_a = score_through(sc, stream)
        b, n_b = score_through(sc2, stream)
        tiles += n_a + n_b
        differ, lists_equal = same_compaction(a, b)
        row = dict(artifact=name, dtype=sc.dtype, minor=ops.unpack_le(blob, 10, 2),
                   bytes=len(blob), serialize_ms=serialize_ms, deserialize_ms=deserialize_ms,
                   reserialized_identical=identical, rows_differ=differ,
                   lists_and_counts_equal=lists_equal, tiles=n_a + n_b)
        if name in outcomes:
            res = execute_plan(plan2, stream, batch_size=8192, use_kernel=True, fused=True,
                               device=dev)
            tiles += -(-len(stream) // 8192)
            want = outcomes[name]
            row.update(passed=int(len(res.passed)),
                       passed_equal=bool(np.array_equal(res.passed, want["passed"])),
                       accuracy=plan_accuracy(res, want["orig"]), main_path_accuracy=want["accuracy"])
        rows.append(row)
    sync(dev)
    launches = cascade_score.launches
    # the card's time on a deserialized scorer: 16 tiles through its route
    plan2, sc2 = ops.deserialize_scorer(blobs["mixed3"][1], base.query, device=dev)
    x16 = stream[:16 * sc2.max_tile]
    sc2.score_compact(x16)
    prof = device_profile(lambda: sc2.score_compact(x16), dev, watch="cascade_")
    kernel_us = prof["watch"]["us"] / max(prof["watch"]["count"], 1)

    q_plan, q_blob = blobs["quickstart"]
    frames = {
        ops.FRAME_RESYNC: (q_blob, {"host": 3}),
        ops.FRAME_DELTA: (json.dumps({"epoch": 4, "votes": [0, 2]}).encode(), {"kind": "prepare"}),
        ops.FRAME_PLANCACHE: (q_blob, {"digest": "0" * 32, "stat_vec": [0.9, 0.5, 0.5]}),
    }
    frames_ok = {}
    for epoch, (kind, (payload, meta)) in enumerate(frames.items()):
        frame = ops.serialize_frame(kind, epoch, payload, meta=meta)
        back = ops.deserialize_frame(frame)
        frames_ok[kind] = (back == (kind, epoch, payload, meta)
                           and ops.serialize_frame(*back[:3], meta=back[3]) == frame)

    def refused(call) -> bool:
        try:
            call()
        except ops.WireFormatError:
            return True
        return False

    channels = {
        "frame_as_scorer": refused(lambda: ops.deserialize_scorer(
            ops.serialize_frame(ops.FRAME_RESYNC, 0, q_blob), q_plan.query, device=dev)),
        "scorer_as_frame": refused(lambda: ops.deserialize_frame(q_blob)),
    }
    rejected = {
        "minor_3": refused(lambda: ops.deserialize_scorer(
            q_blob[:10] + ops.pack_le(3, 2) + q_blob[12:], q_plan.query, device=dev)),
        "truncated_payload": refused(lambda: ops.deserialize_scorer(
            q_blob[:-7], q_plan.query, device=dev)),
        "wrong_n_predicates": refused(lambda: ops.deserialize_scorer(
            q_blob, base.query, device=dev)),
    }
    parity = {}
    x_par = stream[:131_072]
    for dt in ("int8", "fp8"):
        before = cascade_score.launches
        rep = ops.quant_parity_report(base, x_par, dtype=dt, device=dev)
        parity[dt] = dict(flips_within_tol=rep["flips_within_tol"], n_flips=rep["n_flips"],
                          n_eval=rep["n_eval"], tol=rep["tol"],
                          max_sel_delta=rep["max_sel_delta"],
                          launches=cascade_score.launches - before)
    out = dict(records=len(stream), artifacts=rows, launches=launches, tiles=tiles,
               deserialized_kernel_device_us_per_call=kernel_us,
               deserialized_profile_tiles=16, frames_round_trip=frames_ok,
               channels_kept_apart=channels, planted_faults_rejected=rejected,
               quant_parity=parity,
               seconds=time.perf_counter() - t_phase)
    emit("artifact_path", **out)
    for row in rows:
        name = row["artifact"]
        check(row["reserialized_identical"], f"{name}: the artifact re-serializes differently")
        check(row["rows_differ"] == 0 and row["lists_and_counts_equal"],
              f"{name}: deserialized scorer differs on {row['rows_differ']} rows")
        if "passed_equal" in row:
            check(row["passed_equal"] and row["accuracy"] == row["main_path_accuracy"],
                  f"{name}: deserialized plan passes other rows than phase 3")
    check(len(rows) == 4 and {r["minor"] for r in rows} == {0, 2}, "artifact minors")
    check(launches == tiles, f"{launches} cascade_score launches for {tiles} tiles")
    check(all(frames_ok.values()), f"frames: {frames_ok}")
    check(all(channels.values()), f"a frame and an artifact were confused: {channels}")
    check(all(rejected.values()), f"faults accepted: {rejected}")
    for dt, rep in parity.items():
        check(rep["flips_within_tol"], f"{dt}: a decision flipped outside the tolerance")
        check(rep["launches"] == 4 * -(-len(x_par) // 2 // 8192),
              f"{dt}: parity report launched {rep['launches']} times")
    return out


# ------------------------------------------------------------- phase 15
def run_plan_cache_path(dev, workload, n_records: int) -> dict:
    """The cross-query plan cache on the card, in the sequence of
    ``benchmarks/bench_plan_cache.py``, at phase 11's dataset (its UDFs on
    the card, its 5% sample) for a query on columns (0, 1, 2), fingerprinted
    with the sample's audited selectivities s: cold; an exact repeat (HIT:
    no proxy trained, the replayed scorer bit-identical to the cold plan's
    on ``n_records`` held-out rows through the kernel); the COREPLNC
    container byte-stable; a similar query at s shifted by the bench's
    (-0.05, 0, +0.05) along the cold plan's order, so that the order stays
    the optimum (WARM: fewer B&B visits, cost within 5%); a dissimilar one
    at A = 0.95 whose selectivities invert the cold plan's
    order (its first stage passing 95% of records, its last 5%: COLD by the
    regret guard, accuracy at least A - 0.05); and an adaptive
    ``CascadeServer`` over a drifting stream of ``n_records`` that writes
    its initial plan and every swap back.  (The bench's literal
    selectivities are set around its own query's statistics and plan; these
    are set the same way around this query's.)"""
    from repro_torch.core import OptimizeOptions, PlanCache, execute_plan, orig_plan, plan_accuracy
    from repro_torch.data.synthetic import make_drifting_stream, make_query
    from repro_torch.kernels.ops import CascadeScorer
    from repro_torch.kernels.proxy_score import cascade_score
    from repro_torch.serving.engine import CascadeServer

    ds, udfs, k = workload
    t_phase = time.perf_counter()
    x = ds.x[:k]
    held = ds.x[k:k + n_records]
    opts = OptimizeOptions(step=0.05, seed=0)
    q = make_query(ds, udfs, columns=[0, 1, 2], target_selectivity=0.5, accuracy_target=0.9,
                   seed=1)
    sels = {p: float(np.mean(pred.evaluate(pred.udf(x)))) for p, pred in enumerate(q.predicates)}
    cache = PlanCache()
    cold_plan, cold = cache.optimize_query(q, x, opts, selectivities=sels, device=dev)
    builds = cache.stats.misses + cache.stats.hits_warm
    hit_plan, hit = cache.optimize_query(q, x, opts, selectivities=sels, device=dev)
    # a hit replays the artifact: no builder runs, so no proxy is trained
    hit_builds = cache.stats.misses + cache.stats.hits_warm - builds
    cascade_score.launches = 0
    a, n_a = score_through(CascadeScorer.from_plan(cold_plan, device=dev), held)
    b, n_b = score_through(hit["scorer"], held)
    sync(dev)
    replay_launches, replay_tiles = cascade_score.launches, n_a + n_b
    replay_differ, replay_lists_equal = same_compaction(a, b)
    blob = cache.to_bytes()
    stable = PlanCache.from_bytes(blob).to_bytes() == blob
    similar = {p: min(max(sels[p] + d, 0.0), 1.0) for p, d in zip(cold_plan.order, (-0.05, 0, 0.05))}
    warm_plan, warm = cache.optimize_query(q, x, opts, selectivities=similar, device=dev)
    warm_delta = abs(warm_plan.est_total_cost - cold_plan.est_total_cost) / cold_plan.est_total_cost
    q_far = make_query(ds, udfs, columns=[0, 1, 2], target_selectivity=0.5,
                       accuracy_target=0.95, seed=1)
    inverted = dict(zip(cold_plan.order, (0.95, 0.5, 0.05)))
    far_plan, far = cache.optimize_query(q_far, x, opts, selectivities=inverted, device=dev)
    far_acc = plan_accuracy(execute_plan(far_plan, held, use_kernel=True, device=dev),
                            execute_plan(orig_plan(q_far), held, device=dev))
    # adaptive serving with write-backs, on a plan with live optimizer state
    serve_plan, serve_info = cache.optimize_query(q, x, opts.replace(keep_state=True),
                                                  selectivities=sels, accept_hit=False,
                                                  device=dev)
    stream = make_drifting_stream(ds, n_records // 4, n_records - n_records // 4,
                                  shift_targets={0: 2.8, 1: -2.6, 2: 2.8}, corr_gain=2.5, seed=0)
    writes_before = cache.stats.writes
    srv = CascadeServer(serve_plan, tile=SERVING["tile"], adaptive=True, plan_cache=cache,
                        device=dev)
    cascade_score.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    stats = srv.run_stream(stream.x, chunk=SERVE_CHUNK)
    sync(dev)
    serve_s = time.perf_counter() - t0
    serve_launches = cascade_score.launches
    serve_tiles = submit_tiles(stream.n, max(SERVING["tile"], 1024))
    launches = replay_launches + serve_launches
    out = dict(records=len(held), sample=k, predicates=3, order=list(cold_plan.order),
               sample_selectivities=sels, similar_selectivities=similar,
               inverted_selectivities=inverted, regrets=[cold["regret"], warm["regret"], far["regret"]],
               paths=[cold["path"], hit["path"], warm["path"], far["path"]],
               cold_nodes=cold["trace"]["nodes_visited"], warm_nodes=warm["trace"]["nodes_visited"],
               cold_build_ms=cold["build_ms"], hit_build_ms=hit["build_ms"],
               warm_build_ms=warm["build_ms"], far_build_ms=far["build_ms"],
               hit_build_ratio=hit["build_ms"] / cold["build_ms"], hit_builds=hit_builds,
               cold_trained=cold_plan.meta["stats"]["n_trained"],
               hit_same_order=list(hit_plan.order) == list(cold_plan.order),
               replay_rows_differ=replay_differ, replay_lists_and_counts_equal=replay_lists_equal,
               replay_launches=replay_launches, replay_tiles=replay_tiles,
               container_bytes=len(blob), container_stable=stable,
               warm_distance=warm["distance"], warm_cost_rel_delta=warm_delta,
               dissimilar_accuracy=far_acc, dissimilar_floor=q_far.accuracy_target - 0.05,
               serve_path=serve_info["path"], served=stream.n, boundary=stream.boundary,
               emitted=stats.emitted, rejected=stats.rejected, in_flight=srv.in_flight(),
               plan_swaps=stats.plan_swaps, plan_cache_writebacks=stats.plan_cache_writebacks,
               cache_writes=cache.stats.writes - writes_before, serve_launches=serve_launches,
               serve_tiles=serve_tiles, serve_s=serve_s, launches=launches,
               tiles=replay_tiles + serve_tiles, entries=len(cache),
               cache_stats=cache.stats.as_dict(), seconds=time.perf_counter() - t_phase)
    emit("plan_cache_path", **out)
    check(out["paths"] == ["cold", "hit", "warm", "cold"], f"paths {out['paths']}")
    check(hit_builds == 0 and out["hit_same_order"], "the exact repeat built or reordered")
    check(out["hit_build_ratio"] <= 0.2, f"hit / cold build {out['hit_build_ratio']:.3f} > 0.2")
    check(replay_differ == 0 and replay_lists_equal,
          f"the replayed scorer differs from the cold plan's on {replay_differ} rows")
    check(stable, "the COREPLNC container is not byte-stable")
    check(out["warm_nodes"] < out["cold_nodes"],
          f"warm visited {out['warm_nodes']} nodes, cold {out['cold_nodes']}")
    check(warm_delta <= 0.05, f"warm cost {warm_delta:.4f} off the cold plan's")
    check(far_acc >= q_far.accuracy_target - 0.05, f"dissimilar accuracy {far_acc:.4f}")
    check(stats.emitted + stats.rejected == stream.n and srv.in_flight() == 0,
          f"conservation: {stats.emitted} + {stats.rejected} != {stream.n}")
    check(stats.plan_cache_writebacks >= 1 + stats.plan_swaps,
          f"{stats.plan_cache_writebacks} write-backs for {stats.plan_swaps} swaps")
    check(launches == out["tiles"], f"{launches} cascade_score launches for {out['tiles']} tiles")
    return out


# ------------------------------------------------------------- phases 16-19
def fleet_streams(ds, per_host: int, seed: int = 0):
    """``bench_sharded.py``'s skewed drift over K hosts, each shard of
    ``per_host`` records with its boundary at a quarter."""
    from repro_torch.data.synthetic import make_sharded_drifting_streams

    return make_sharded_drifting_streams(
        ds, FLEET["hosts"], per_host // 4, per_host - per_host // 4,
        shift_targets=FLEET["shift_targets"], corr_gain=FLEET["corr_gain"],
        drift_skew=FLEET["drift_skew"], seed=seed)


def fleet_conservation(srv, stats) -> dict:
    """The fleet's conservation, exact: every host's emitted + rejected ==
    submitted with nothing in flight, no index emitted twice, the hosts'
    emitted sets disjoint, each emission served under the plan version
    current when it was submitted, and every host at the final epoch."""
    emitted = [list(h.engine.emitted) for h in srv.hosts]
    flat = [i for e in emitted for i in e]
    per_host = all(st.emitted + st.rejected == n
                   for st, n in zip(stats.per_host, stats.submitted_per_host))
    versions = all(h.submit_version[i] == v for h in srv.hosts
                   for i, v in zip(h.engine.emitted, h.engine.emitted_versions))
    return dict(per_host=per_host, in_flight=sum(h.engine.in_flight() for h in srv.hosts),
                twice=len(flat) - len(set(flat)) if all(len(e) == len(set(e)) for e in emitted)
                else -1, disjoint=len(flat) == len(set(flat)),
                versions=versions, epochs=sorted({h.epoch for h in srv.hosts}),
                final_epoch=stats.final_epoch,
                ok=(per_host and stats.submitted == stats.emitted + stats.rejected
                    and all(h.engine.in_flight() == 0 for h in srv.hosts)
                    and len(flat) == len(set(flat)) and versions
                    and {h.epoch for h in srv.hosts} == {stats.final_epoch}))


def swap_log(stats) -> list:
    return [dict(epoch=r.epoch, voters=list(r.voters), signals=list(r.signals), mode=r.mode,
                 merged_rows=r.merged_rows, committed=r.committed, aborted_by=r.aborted_by,
                 fenced=list(r.fenced), initiated_by=r.initiated_by, lag_records=r.lag_records,
                 reopt_ms=r.reopt_ms, consensus_ms=r.consensus_ms) for r in stats.swap_log]


def same_swaps(a: list, b: list) -> bool:
    """Two swap logs agree on every decision (the wall-clock ms aside)."""
    keys = ("epoch", "voters", "signals", "mode", "merged_rows", "committed", "aborted_by",
            "fenced", "initiated_by")
    return [{k: r[k] for k in keys} for r in a] == [{k: r[k] for k in keys} for r in b]


def run_fleet(plan, streams, dev, *, transport: str = "inline", worker_spec=None,
              **kw) -> dict:
    """Build a ``ShardedCascadeServer`` of ``plan`` with phase 16's
    settings and serve ``streams`` (``serve_fleet``), timing the build."""
    from repro_torch.distributed.serving import ShardedCascadeServer
    from repro_torch.serving.stats import AdaptivePolicy

    t0 = time.perf_counter()
    srv = ShardedCascadeServer(plan, FLEET["hosts"], tile=FLEET["tile"], seed=0,
                               policy=AdaptivePolicy(audit_rate=FLEET["audit_rate"]),
                               transport=transport, worker_spec=worker_spec, device=dev, **kw)
    return serve_fleet(srv, streams, dev, start_s=time.perf_counter() - t0)


def serve_fleet(srv, streams, dev, *, start_s: float = 0.0) -> dict:
    """One run of the fleet ``srv`` over ``streams`` (version tracking on),
    with ``cascade_score``'s count set to 0 just before and read just
    after; returns the server, its stats, the launches, the submitted tiles
    (one a chunk: ``FLEET["chunk"]`` is at most every scorer's tile), the
    seconds to build the fleet and to serve, and the checks' inputs."""
    from repro_torch.kernels.proxy_score import cascade_score

    try:
        for h in srv.hosts:
            h.track_versions = True
        cascade_score.launches = 0
        sync(dev)
        t0 = time.perf_counter()
        stats = srv.run_streams([s.x for s in streams], chunk=FLEET["chunk"])
        sync(dev)
        serve_s = time.perf_counter() - t0
        launches = cascade_score.launches
    finally:
        srv.close()
    tiles = [-(-len(s.x) // FLEET["chunk"]) for s in streams]
    return dict(srv=srv, stats=stats, launches=launches, tiles=tiles, start_s=start_s,
                serve_s=serve_s, conservation=fleet_conservation(srv, stats),
                swap_log=swap_log(stats), emitted=[list(h.engine.emitted) for h in srv.hosts])


def check_fleet_run(name: str, run: dict, dev, *, workers: bool = False) -> None:
    """Exact conservation, and one launch a submitted tile (on the CPU,
    where the plain route runs, none): summed over the hosts, or with
    ``workers`` each worker's own count against its own tiles."""
    cons = run["conservation"]
    check(cons["ok"], f"{name}: conservation {cons}")
    on_card = dev.type == "cuda"
    if workers:
        got = [h.engine.launches for h in run["srv"].hosts]
        want = run["tiles"] if on_card else [0] * len(got)
        check(got == want, f"{name}: worker launches {got} for tiles {run['tiles']}")
    else:
        want = sum(run["tiles"]) if on_card else 0
        check(run["launches"] == want,
              f"{name}: {run['launches']} cascade_score launches for {sum(run['tiles'])} tiles")


def fleet_summary(run: dict) -> dict:
    st = run["stats"]
    committed = [r for r in run["swap_log"] if r["committed"]]
    return dict(records=st.submitted, emitted=st.emitted, rejected=st.rejected,
                votes_cast=st.votes_cast, swaps_committed=st.swaps_committed,
                swaps_aborted=st.swaps_aborted, final_epoch=st.final_epoch,
                failovers=st.failovers, failover_resolution=st.failover_resolution,
                fences=st.fences, resyncs=st.resyncs, launches=run["launches"],
                tiles=sum(run["tiles"]), start_s=run["start_s"], serve_s=run["serve_s"],
                records_per_s=st.submitted / run["serve_s"],
                consensus_ms_per_swap=[r["consensus_ms"] for r in committed],
                reopt_ms_per_swap=[r["reopt_ms"] for r in committed],
                conservation=run["conservation"], swap_log=run["swap_log"])


def run_fleet_path(dev, workload, n_records: int) -> dict:
    """The fleet through ``CoreSession.serve(hosts=4)``: phase 11's
    workload and query, its plan optimized with ``keep_state=True``, four
    inline hosts on ``bench_sharded.py``'s skewed drift (n_records / 4 a
    host, boundary at a quarter), tile 1024, ``AdaptivePolicy(audit_rate=
    0.015)``: a committed quorum swap, every host at the final epoch, exact
    conservation, one launch a submitted tile, and served accuracy against
    ORIG over the union of the streams at least A - 0.05.  Returns the
    phase's numbers, the seed plan (a copy taken before the run: the
    coordinator's re-optimizations advance the plan's B&B state) and the
    streams, for phases 17-19."""
    from repro_torch.core import (CoreSession, OptimizeOptions, ServeConfig, execute_plan,
                                  orig_plan)
    from repro_torch.data.synthetic import make_query
    from repro_torch.distributed.serving import ShardedCascadeServer
    from repro_torch.serving.stats import AdaptivePolicy

    prof = SERVING
    t_phase = time.perf_counter()
    ds, udfs, k = workload
    q = make_query(ds, udfs, columns=list(range(prof["preds"])), target_selectivity=0.5,
                   accuracy_target=prof["accuracy"], seed=1)
    streams = fleet_streams(ds, n_records // FLEET["hosts"])
    session = CoreSession(options=OptimizeOptions(mode="core"), device=dev)
    handle = session.register_query(q, ds.x[:k])
    t0 = time.perf_counter()
    srv = session.serve(hosts=FLEET["hosts"], config=ServeConfig(tile=FLEET["tile"]),
                        policy=AdaptivePolicy(audit_rate=FLEET["audit_rate"]))
    optimize_s = time.perf_counter() - t0
    check(isinstance(srv, ShardedCascadeServer), f"serve(hosts=4) built a {type(srv).__name__}")
    check("bnb" in handle.plan.meta or "builder" in handle.plan.meta,
          "serve(hosts=4) optimized without keep_state")
    seed_plan = copy.deepcopy(handle.plan)
    run = serve_fleet(srv, streams, dev)
    stats = run["stats"]
    x_all = np.concatenate([s.x for s in streams])
    orig_set = set(execute_plan(orig_plan(q), x_all, device=dev).passed.tolist())
    served_acc = sum(1 for e in run["emitted"] for i in e if i in orig_set) / max(len(orig_set), 1)
    out = dict(fleet_summary(run), hosts=FLEET["hosts"], transport="inline",
               per_host_records=[len(s.x) for s in streams], boundary=streams[0].boundary,
               drift_scales=[s.meta["drift_scale"] for s in streams], optimize_s=optimize_s,
               served_accuracy=served_acc, accuracy_floor=prof["accuracy"] - 0.05,
               seconds=time.perf_counter() - t_phase)
    emit("fleet_path", **out)
    check(stats.swaps_committed >= 1, f"no committed quorum swap ({stats.votes_cast} votes)")
    check_fleet_run("fleet_path", run, dev)
    check(served_acc >= prof["accuracy"] - 0.05, f"fleet served accuracy {served_acc:.4f}")
    out["run"] = run
    out["fleet"] = (q, seed_plan, streams)
    return out


def run_fleet_thread(dev, fleet, inline: dict) -> dict:
    """Phase 16's streams with one thread a host: the swap log (epoch,
    voters, signals, mode, merged rows) and each host's emitted list equal
    the inline run's, and one launch a submitted tile."""
    q, seed_plan, streams = fleet
    t_phase = time.perf_counter()
    run = run_fleet(copy.deepcopy(seed_plan), streams, dev, transport="thread")
    same_log = same_swaps(run["swap_log"], inline["swap_log"])
    same_emitted = run["emitted"] == inline["emitted"]
    out = dict(fleet_summary(run), transport="thread", swap_log_equals_inline=same_log,
               emitted_equals_inline=same_emitted, seconds=time.perf_counter() - t_phase)
    emit("fleet_thread", **out)
    check_fleet_run("fleet_thread", run, dev)
    check(same_log, "fleet_thread: the swap log differs from the inline run's")
    check(same_emitted, "fleet_thread: a host's emitted list differs from the inline run's")
    return out


def udf_training_repeats(ds, dev) -> bool:
    """One UDF (column 0, the serve CLI's widths) trained twice on ``dev``
    from the same seed: bit for bit the same weights?"""
    from repro_torch.data.synthetic import _train_udf_model

    prof = SERVING
    idx = np.random.RandomState(0).choice(ds.n, min(prof["udf_train_rows"], ds.n), replace=False)
    runs = [_train_udf_model(ds.x[idx], ds.truth[idx, 0], ds.n_classes[0], prof["udf_hidden"],
                             prof["udf_depth"], 0, device=dev) for _ in range(2)]
    return all(torch.equal(a, b) for la, lb in zip(*runs) for a, b in zip(la, lb))


def run_fleet_process(dev, workload, fleet, n_records: int) -> dict:
    """Four worker processes (``python -m repro_torch.distributed.
    procworker``), each rebuilding phase 11's workload from its seeds on
    ``dev``, over a shorter run of the same generator (n_records / 4 a
    host): a committed swap, conservation, every worker's drain reply on
    ``dev`` with one launch a tile of its own, and the swap log and emitted
    sets equal to an inline run on the same streams; the worker start
    seconds, and whether one UDF trains bit for bit the same twice."""
    ds, _udfs, _k = workload
    q, seed_plan, _ = fleet
    prof = SERVING
    t_phase = time.perf_counter()
    streams = fleet_streams(ds, n_records // FLEET["hosts"])
    spec = {"dataset": dict(n=ds.n, correlation=prof["correlation"], seed=0),
            "udfs": dict(hidden=prof["udf_hidden"], depth=prof["udf_depth"],
                         train_rows=prof["udf_train_rows"], seed=0,
                         declared_cost_ms=prof["declared_cost_ms"]),
            "query": dict(columns=list(range(prof["preds"])), target_selectivity=0.5,
                          accuracy_target=prof["accuracy"], seed=1)}
    repeats = udf_training_repeats(ds, dev)
    inline = run_fleet(copy.deepcopy(seed_plan), streams, dev)
    run = run_fleet(copy.deepcopy(seed_plan), streams, dev, transport="process",
                    worker_spec=spec)
    workers = [dict(device=h.engine.device, launches=h.engine.launches, start_s=h.start_s)
               for h in run["srv"].hosts]
    same_log = same_swaps(run["swap_log"], inline["swap_log"])
    same_emitted = [set(e) for e in run["emitted"]] == [set(e) for e in inline["emitted"]]
    out = dict(fleet_summary(run), transport="process", per_host_records=[len(s.x) for s in streams],
               workers=workers, worker_start_s=run["start_s"],
               parent_launches=run["launches"], udf_training_bitwise_repeatable=repeats,
               swap_log_equals_inline=same_log, emitted_sets_equal_inline=same_emitted,
               inline_swap_log=inline["swap_log"], seconds=time.perf_counter() - t_phase)
    out["launches"] = sum(w["launches"] for w in workers)  # the workers' own counts
    emit("fleet_process", **out)
    check(run["stats"].swaps_committed >= 1, "fleet_process: no committed swap")
    check(all(w["device"] is not None and torch.device(w["device"]).type == dev.type
              for w in workers), f"fleet_process: worker devices {workers}")
    check_fleet_run("fleet_process", run, dev, workers=True)
    check(run["launches"] == 0, f"fleet_process: {run['launches']} launches in the parent")
    check(same_log, "fleet_process: the swap log differs from the inline run's")
    check(same_emitted, "fleet_process: the emitted sets differ from the inline run's")
    return out


FAULT_CASES = (  # (name, ShardedCascadeServer keywords)
    ("kill_prepare", dict(kill_coordinator_at="prepare")),
    ("kill_commit", dict(kill_coordinator_at="commit")),
    ("kill_mid_commit", dict(kill_coordinator_at="mid-commit")),
    ("straggler_fence", dict(straggler_host=0, straggler_policy="fence")),
    ("straggler_nack", dict(straggler_host=0, straggler_policy="nack")),
)


def fault_resolution_ok(name: str, st, log: list) -> bool:
    """The resolution the JAX package's tests expect of each injection."""
    if name == "kill_prepare":
        return st.failovers == 1 and st.failover_resolution == "aborted"
    if name in ("kill_commit", "kill_mid_commit"):
        return st.failovers == 1 and st.failover_resolution in ("completed", "resync")
    if name == "straggler_fence":
        fenced = [r for r in log if r["committed"] and r["fenced"]]
        return st.fences == 1 and st.resyncs == 1 and bool(fenced) and fenced[0]["fenced"] == [0]
    aborted = [r for r in log if not r["committed"]]
    return st.fences == 0 and bool(aborted) and aborted[0]["aborted_by"] == 0


def run_fleet_faults(dev, workload, fleet, n_records: int) -> dict:
    """Inline, four hosts, n_records / 4 a host of the same generator: the
    primary coordinator killed in ``prepare`` (the standby aborts), at
    ``commit`` and ``mid-commit`` (it completes or re-syncs), and host 0
    silent through the first prepare barrier under ``fence`` (one fence,
    one re-sync, ``fenced [0]`` on the swap) and ``nack`` (the swap
    aborts); each run conserves exactly with one launch a tile."""
    ds, _udfs, _k = workload
    _q, seed_plan, _ = fleet
    t_phase = time.perf_counter()
    streams = fleet_streams(ds, n_records // FLEET["hosts"])
    runs, launches = {}, 0
    for name, kw in FAULT_CASES:
        run = run_fleet(copy.deepcopy(seed_plan), streams, dev, **kw)
        launches += run["launches"]
        st = run["stats"]
        runs[name] = dict(fleet_summary(run),
                          resolution_ok=fault_resolution_ok(name, st, run["swap_log"]))
        runs[name]["run"] = run
    out = dict(hosts=FLEET["hosts"], per_host_records=[len(s.x) for s in streams],
               cases={n: {k: v for k, v in r.items() if k != "run"} for n, r in runs.items()},
               launches=launches, tiles=sum(sum(r["run"]["tiles"]) for r in runs.values()),
               seconds=time.perf_counter() - t_phase)
    emit("fleet_faults", **out)
    for name, r in runs.items():
        check(r["resolution_ok"], f"fleet_faults {name}: failovers {r['failovers']} "
              f"({r['failover_resolution']}), fences {r['fences']}, resyncs {r['resyncs']}, "
              f"swaps {r['swap_log']}")
        check_fleet_run(f"fleet_faults {name}", r["run"], dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="On-card smoke test of the PyTorch port.")
    ap.add_argument("--stream-records", type=int, default=1_048_576,
                    help="records in the executed stream (default 1,048,576 = 128 tiles)")
    ap.add_argument("--serving-records", type=int, default=SERVING["n"],
                    help="records in the serving path's dataset (default 1,048,576)")
    ap.add_argument("--multiquery-records", type=int, default=MULTIQUERY_RECORDS,
                    help="records the multi-query path serves (default 262,144)")
    ap.add_argument("--frontend-records", type=int, default=FRONTEND["records"],
                    help="records the SLO front-end path serves (default 65,536)")
    ap.add_argument("--plan-cache-records", type=int, default=PLAN_CACHE_RECORDS,
                    help="held-out and drifting records of the plan-cache path "
                         "(default 262,144)")
    ap.add_argument("--fleet-records", type=int, default=FLEET["records"],
                    help="records over all hosts of the fleet's inline and thread "
                         "paths (default 1,048,576); the process path takes 1/8 of "
                         "it, each fault injection 1/4")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention, proxy_score, ssd_scan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)

    t0 = time.perf_counter()
    libs = _build.build_all(["cascade_score", "flash_attention", "ssd_chunk"])
    proxy_score._lib()
    flash_attention._lib()
    ssd_scan._lib()
    for lib_path in libs.values():
        log = lib_path.with_suffix(".log").read_text().splitlines()
        emit("build", seconds=time.perf_counter() - t0, library=lib_path.name,
             ptxas=[ln.strip() for ln in log if "registers" in ln or "spill" in ln
                    or "smem" in ln])

    errs = []
    for i, case in enumerate(KERNEL_CASES):
        errs.append(check_kernel_case(case, dev, seed=i))
    emit("kernels", cases=len(KERNEL_CASES), max_abs_err=max(errs),
         shapes=[list(c[:5]) + [c[5]] for c in KERNEL_CASES])

    plans, stream, launches, outcomes = run_main_path(dev, args.stream_records)
    timings = time_main_shapes(plans, stream, dev, iters=200)
    profile_main_path(plans, stream, dev)
    main_row = max(timings, key=lambda r: r["flops"])
    artifacts = run_artifact_path(dev, plans, stream, outcomes)
    del plans, stream, outcomes

    flash_errs, flash_routes = [], []
    t0 = time.perf_counter()
    split_check = check_split_bf16(dev)
    for i, case in enumerate(FLASH_CASES):
        before = dict(flash_attention.flash_attention.route_launches)
        flash_errs.append(check_flash_case(case, dev, seed=i))
        flash_routes.append(route_taken(flash_attention.flash_attention, before))
        want = flash_attention.route_for(case[5], getattr(torch, case[7]))
        check(flash_routes[-1] == want, f"{case}: took the {flash_routes[-1]} route, not {want}")
    faults = [planted_fault(dev, dt) for dt in ("bfloat16", "float32")]
    emit("flash_kernels", cases=len(FLASH_CASES), seconds=time.perf_counter() - t0,
         max_abs_err={dt: max(e[0] for c, e in zip(FLASH_CASES, flash_errs) if c[7] == dt)
                      for dt in FLASH_TOL},
         max_row_err={dt: max(e[1] for c, e in zip(FLASH_CASES, flash_errs) if c[7] == dt)
                      for dt in FLASH_TOL},
         tol=FLASH_TOL, row_tol=FLASH_ROW_TOL, planted_fault=faults[0],
         planted_faults_f32=faults[1], split_bf16=split_check,
         cases_by_route={dt: {r: sum(c[7] == dt and t == r for c, t in zip(FLASH_CASES,
                                                                             flash_routes))
                              for r in flash_attention.ROUTES} for dt in FLASH_TOL},
         shapes=[list(c) + [t] for c, t in zip(FLASH_CASES, flash_routes)])
    torch.cuda.empty_cache()

    dense = run_dense_path(dev, DENSE["layers"], DENSE["batch"], DENSE["prompt"],
                           DENSE["new_tokens"])
    profile_serving(dense, dev)
    del dense["model"], dense["tokens"]
    torch.cuda.empty_cache()
    dense32 = run_dense_path(dev, DENSE["layers"], DENSE["batch"], DENSE["prompt"],
                             DENSE["new_tokens"], dtype="float32")
    del dense32["model"], dense32["tokens"]
    torch.cuda.empty_cache()
    flash_rows = {dt: time_flash(dev, dt, iters=3) for dt in ("bfloat16", "float32")}
    flash_row = flash_rows["bfloat16"]
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ssd_errs = [check_ssd_case(case, dev, seed=i) for i, case in enumerate(SSD_CASES)]
    ssd_faults = [ssd_planted_fault(dev, dt) for dt in ("bfloat16", "float32")]
    for c, e in zip(SSD_CASES, ssd_errs):
        want = "tensor_cores" if c[4] in ssd_scan.TC_P and c[5] in ssd_scan.TC_N else "cuda_cores"
        check(e["route"] == want, f"{c}: took the {e['route']} route, not {want}")
    emit("ssd_kernels", cases=len(SSD_CASES), seconds=time.perf_counter() - t0,
         max_y_diag_rel={dt: max(e["y_diag_rel"] for c, e in zip(SSD_CASES, ssd_errs)
                                 if c[7] == dt) for dt in ("float32", "bfloat16")},
         max_states_rel={dt: max(e["states_rel"] for c, e in zip(SSD_CASES, ssd_errs)
                                 if c[7] == dt) for dt in ("float32", "bfloat16")},
         max_chunk_decay_rel=max(e["chunk_decay_rel"] for e in ssd_errs), tol=SSD_TOL,
         decay_tol=DECAY_TOL, planted_fault=ssd_faults[0], planted_faults_f32=ssd_faults[1],
         cases_by_route={dt: {r: sum(c[7] == dt and e["route"] == r
                                     for c, e in zip(SSD_CASES, ssd_errs))
                              for r in ssd_scan.ROUTES} for dt in ("float32", "bfloat16")},
         cases_detail=[dict(case=list(c), **e) for c, e in zip(SSD_CASES, ssd_errs)])
    torch.cuda.empty_cache()

    ssm = run_ssm_path(dev, SSM["layers"], SSM["batch"], SSM["prompt"], SSM["new_tokens"])
    profile_ssm(ssm, dev)
    del ssm["model"], ssm["tokens"]
    torch.cuda.empty_cache()
    ssd_rows = {dt: time_ssd(dev, dt, iters=10) for dt in ("bfloat16", "float32")}
    ssd_row, ssd32_row = ssd_rows["bfloat16"], ssd_rows["float32"]
    flash32_row = flash_rows["float32"]
    torch.cuda.empty_cache()

    serving = run_serving_path(dev, args.serving_records)
    workload = serving.pop("workload")
    multiquery = run_multiquery_path(dev, workload, args.multiquery_records)
    frontend = run_frontend_path(dev, workload, args.frontend_records)
    plan_cache = run_plan_cache_path(dev, workload, args.plan_cache_records)
    fleet = run_fleet_path(dev, workload, args.fleet_records)
    fleet_thread = run_fleet_thread(dev, fleet["fleet"], fleet.pop("run"))
    fleet_process = run_fleet_process(dev, workload, fleet["fleet"], args.fleet_records // 8)
    fleet_faults = run_fleet_faults(dev, workload, fleet["fleet"], args.fleet_records // 4)
    del workload, fleet["fleet"]
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "cascade_score", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cascade_score.cu",
        "replaces": "src/repro/kernels/proxy_score.py:114",
        "launches": launches,
        "launches_by_path": {"main_path": launches, "serving_path": serving["launches"],
                             "multiquery_path": multiquery["launches"],
                             "frontend_path": frontend["launches"],
                             "artifact_path": artifacts["launches"],
                             "plan_cache_path": plan_cache["launches"],
                             "fleet_path": fleet["launches"],
                             "fleet_thread": fleet_thread["launches"],
                             "fleet_process": fleet_process["launches"],
                             "fleet_faults": fleet_faults["launches"]},
        "serving_shapes": [{k: r[k] for k in ("shape", "N", "F", "HP", "P", "ms", "plain_ms",
                                              "bound_ms", "bound_by", "max_abs_err")}
                           for r in (serving["timing"], multiquery["timing"])],
        "max_abs_err": max(errs + [main_row["max_abs_err"], serving["timing"]["max_abs_err"],
                                   multiquery["timing"]["max_abs_err"]]),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda", "kernel_route": "tensor_cores",
        "dtype": "bfloat16",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:62",
        "launches": dense["launches"],
        "max_abs_err": max([e for (e, _), c in zip(flash_errs, FLASH_CASES)
                            if c[7] == "bfloat16"] + [dense["attention_max_abs_err"]]),
        "ms": flash_row["ms"], "plain_ms": flash_row["plain_ms"],
        "bound_ms": flash_row["bound_ms"], "bound_by": flash_row["bound_by"],
        "library_ms": flash_row["library_ms"]}, {
        "name": "flash_attention[float32]", "route": "cuda", "kernel_route": "tensor_cores",
        "dtype": "float32", "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:62",
        "launches": dense32["launches"],
        "max_abs_err": max([e for (e, _), c in zip(flash_errs, FLASH_CASES)
                            if c[7] == "float32"] + [dense32["attention_max_abs_err"]]),
        "ms": flash32_row["ms"], "plain_ms": flash32_row["plain_ms"],
        "bound_ms": flash32_row["bound_ms"], "bound_by": flash32_row["bound_by"],
        "cuda_core_bound_ms": flash32_row["cuda_core_bound_ms"],
        "library_ms": flash32_row["library_ms"]}, {
        "name": "split_bf16", "route": "cuda", "kernel_route": "pre-pass of the f32 tensor cores",
        "dtype": "float32", "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:62",
        "launches": dense32["split_bf16_launches"],
        "max_abs_err": split_check["max_abs_err"],
        "ms": flash32_row["split_bf16"]["ms"], "plain_ms": flash32_row["split_bf16"]["plain_ms"],
        "bound_ms": flash32_row["split_bf16"]["bound_ms"], "bound_by": "bytes",
        "library_ms": None}, {
        "name": "ssd_chunk", "route": "cuda", "kernel_route": "tensor_cores",
        "dtype": "bfloat16", "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:44",
        "launches": ssm["launches"],
        "max_abs_err": max([max(e["y_diag"], e["states"]) for c, e in zip(SSD_CASES, ssd_errs)
                            if c[7] == "bfloat16"] + [ssd_row["max_abs_err"]]),
        "ms": ssd_row["ms"], "plain_ms": ssd_row["plain_ms"],
        "bound_ms": ssd_row["bound_ms"], "bound_by": ssd_row["bound_by"],
        "library_ms": None}, {
        "name": "ssd_chunk[float32]", "route": "cuda", "kernel_route": "tensor_cores",
        "dtype": "float32", "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:44",
        "launches": ssm["f32_route_launches"]["tensor_cores"],
        "max_abs_err": max([max(e["y_diag"], e["states"]) for c, e in zip(SSD_CASES, ssd_errs)
                            if c[7] == "float32"] + [ssd32_row["max_abs_err"]]),
        "ms": ssd32_row["ms"], "plain_ms": ssd32_row["plain_ms"],
        "bound_ms": ssd32_row["bound_ms"], "bound_by": ssd32_row["bound_by"],
        "cuda_core_bound_ms": ssd32_row["cuda_core_bound_ms"],
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
