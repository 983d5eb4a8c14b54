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
2a. threefry_kernels — the CUDA ``threefry`` (``jax.random``'s
              threefry2x32 draws: every model weight and batch drawn on the
              card) against its plain version, ``util/prng.py``'s numpy
              draw (equal to jax 0.9.0 on the CPU), bit for bit: each
              transform at odd shapes; a bf16 truncated normal of 2^32 + 8
              elements at sampled indices around 2^31 and 2^32, with a
              planted fault (the counter's high word dropped); every family
              of ``configs/archs.py`` at its reduced config from seeds 0 and
              1, and ``make_batch``, card against CPU leaf for leaf; the
              kernel's time at llama3-405b's embedding beside its bound,
              the plain version's and ``trunc_normal_``'s.  Every path's
              init then counts its launches (one a draw), and ``udf_path``
              holds its UDFs' initial trees at published widths to the
              plain version at sampled indices of every weight, with the
              init's seconds.
3. main_path — the port's optimize-and-execute path at the ``twitter``
              profile's full width (F=64, four UDFs of hidden 48 and depth
              2, a 5% optimization sample of 40,000 records) over a stream
              of 1,048,576 records, for two queries, each query's value
              sets printed.  The UDFs' and an ``mlp1`` proxy's initial
              weights drawn for the card must equal the CPU draw bit for
              bit; the UDFs trained on the card are reported against the
              same UDFs trained on the CPU (label agreement and the CPU
              UDFs' value sets, not checked); then a profile of 16
              tiles of each (device busy share, pinned and pageable
              uploads, the host's busiest calls).
4. timing   — CUDA-event times of the kernel and its plain version at the
              main path's shapes, beside the card's bound for that work;
              the kernel's device µs and device events a call, host µs a
              call, and the scorer's whole route on warm and cold tiles.
5. flash_kernels — the CUDA ``flash_attention`` (wgmma on the tensor cores:
              bf16, and f32 at every head dim as three bf16 pieces after the
              ``split_bf16`` pre-pass, two launches a call, counted; at
              D = 256 one consumer warpgroup a block)
              against its plain PyTorch version on the card, by absolute and
              per-row limits, each case on the tensor cores (counted
              per route): the JAX package's test shapes, GQA groups 1, 7 and
              8, D = 256, ragged lengths on either side of a 128-row tile,
              D = 16 and 32 over several KV tiles, and the serving shape
              (B 4, S 4096, H 64, K 8, D 128) in f32 and bf16; ``split_bf16``
              against its plain version bit for bit; and planted faults in
              both types (64 keys' P.V skipped, which the per-row limit must
              reject; in f32 also inputs without their mid and lo pieces),
              and the f32 ones again at paligemma's (4, 4096, 8, 1, 256),
              where two f32 calls must also be equal bit for bit.  Short bf16
              sequences take the packed route (``packed_fwd``: a KV group's
              heads and several records in one 128-row tile, masked block-
              diagonally): its cases (PACKED_SHAPES: the UDF shapes at a cut
              batch, G 1 / 7 / 16, Sq 1 / 5 / 8 / 64, D 16-256, causal and
              not) each on that route, two calls at llama3-405b's UDF shape
              bit for bit, and unit isolation (each record's V constant and
              its own: every output row its own unit's constant).
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
              the compiler's report and its shared memory a block, the time
              with the row lse written beside the time without it (serving's
              call), and in f32 ``split_bf16`` alone; and profiles of one
              prefill and one decode step.
8. ssd_kernels — the CUDA ``ssd_chunk`` (wgmma on the tensor cores where
              shape and layout allow, f32 as two bf16 pieces;
              otherwise the one-pass kernel, mma.sync in one launch, at
              chunks of at most 32 tokens, and the wgmma kernels on padded
              operands at longer ones)
              against its plain PyTorch version on the card, each output by
              a limit relative to its largest plain value (``chunk_decay``
              element by element): the JAX package's test shapes, G = 2 < H,
              the tensor-core route's edges (ragged Q, P 16 and 32, N 16 to
              64, B and C sliced from one wider tensor), Q = 256 with
              realistic, near-zero and JAX-init log-decays, the one-pass
              route's shapes (the reduced mamba2's, Q 32 with P 24 and N 40
              sliced), and the serving shape (mamba2-2.7b, 4 x 4,096 tokens)
              in f32 and bf16, each on the route ``ssd_scan.route`` must
              pick; planted faults the check must reject (``chunk_decay``
              forced to 0 in both types; M rounded to bf16 alone; in f32
              inputs without their lo pieces; on the one-pass kernel states
              without its decay weight and one head's y from its
              neighbour's M); two one-pass calls bit for bit.
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
              serving shape in bf16 and f32, and (since PR 31) at the
              reduced mamba2's (16, 16, 16, 1, 8, 16), off the tensor-core
              shapes (the one-pass route), beside the route's
              bound (and in f32 the CUDA-core bound), with the route taken,
              the kernel's registers, spills and shared memory a block and
              its device µs (from a profile in a fresh process, a number
              at the reduced shape); and profiles of one SSM
              prefill and one decode step.
10a. moe_path — the MoE family at qwen3-moe-30b-a3b's published widths
              (d_model 2048, 32 query and 4 KV heads of 128 with qk-norm,
              128 experts top-8 of ff 768, vocab 151936), depth cut to 8
              layers, bf16, seeded random weights: prefill of 4 requests of
              4,096 tokens (8 ``flash_attention`` launches, each layer's
              output held against the plain version), 32 greedy decode
              steps (none), the assignments dropped at capacity 1.25 a
              layer, the same prompts served again to identical tokens, a
              warm prefill and its device time split (flash, GEMMs, dispatch,
              elementwise); then at capacity factor 16 the logits against a
              plain-attention ``forward`` given the served expert choices,
              each of its own that differs a near tie
              (SERVED_ROUTER_TIE_TOL), and a planted fault (each k-th expert
              swapped for the next) that the tie bound must reject.
10b. mla_path — deepseek-v2-lite-16b (MLA, 64 experts top-6 and 2 shared, a
              dense first layer) at its widths, 4 layers: no
              ``flash_attention`` launch, each layer's absorbed decode
              against naive attention over the same latent cache, the
              logits as in 10a.
10c. vlm_path — paligemma-3b at its widths and all 18 layers, 256 patches
              and 3,840 tokens a request: 18 launches at (4, 4096, 8, 1,
              256), each layer's attention held; the logits held at 18
              layers in f32 (18 launches, all on the tensor cores, and 36
              ``split_bf16`` launches) and on the
              first 4 in bf16 (SSM_LOGIT_LAYERS), and reported at 18 in
              bf16 beside the witness (the same serving with the plain
              attention against the same ``forward``); then
              ``flash_timing`` at that shape in bf16 and in f32 (the split
              route's bound beside SDPA f32).
10d. flash_bwd_kernels — the CUDA ``flash_attention`` backward (a Di
              pre-pass reading the forward's lse, then dK/dV a KV tile a
              block over its query-head group, then dQ: bf16 at every head
              dim on the tensor cores, f32 there too on three bf16 pieces of
              every operand (the split route, after one ``split_bf16``
              launch over q, k, v and dO from the same C call; at D 256
              the pieces stream in 64-column chunks; since PR 31 D 16 and
              32 too, with the forward's narrower swizzle, where the CUDA
              cores ran them))
              against its plain PyTorch version, bf16 and f32, causal and
              full: the JAX package's test shapes, D 256, ragged lengths, a
              GQA group of 7, D 16 and the packed route's shapes (one pass,
              ``packed_bwd``), each gradient within 2^-6 (bf16) or
              1e-4 (f32) of its largest value, each on ``backward_route``'s
              kernels (launches counted by route), each forward's lse within
              LSE_TOL of the plain one; a planted fault (one KV tile's dk and
              dv rows zeroed) rejected in both types and at paligemma's
              shape in f32; two calls at (1, 4096, 64, 8, 128) equal bit for
              bit in both types, at paligemma's (4, 4096, 8, 1, 256) in f32
              and at the packed (2000, 8, 8, 128, 8, 128); then
              ``flash_bwd_timing`` at (1, 4096, 64, 8, 128) in bf16 and f32,
              at paligemma's (4, 4096, 8, 1, 256) in bf16 and f32 and at the
              restart check's reduced (2, 256, 256, 4, 2, 16) in both types
              (the tensor cores since PR 31): the kernel, its plain version and
              ``torch.autograd.grad`` through ``scaled_dot_product_attention``
              beside its bound (2.5 forwards' flops at the type's peak; on
              the split route six bf16 products of them and the pre-pass's
              bytes, the CUDA-core figure beside it), the route's kernels by
              name with their registers, spills, shared memory and device
              time.
10e. train_path — ``launch.train.run`` at deepseek-67b's published widths,
              depth cut to 3 layers, bf16 weights, accum 4, remat, AdamW
              with f32 accumulation and moments: 4 steps on one fixed batch
              of 4 x 4,096 tokens with the counts zeroed just before (6
              forward and 3 backward ``flash_attention`` launches a
              micro-batch), the loss falling; each layer's backward launch of
              the first micro-batch against the plain backward on its own
              q, k, v and dO; step ms, tokens/s, peak memory and a profile
              of one step; one f32 step at 1 layer of deepseek-67b (D 128)
              and one of paligemma-3b (D 256, one 4,096-token sequence
              after the stand-in patch prefix), each against the same step
              with the plain attention under autograd (loss 1e-5,
              gradients 1e-4 of their largest, updated parameters 1e-4
              where AdamW's update is well conditioned), its backward on
              ``backward_route``'s kernels (the split route, 1 launch and
              its ``split_bf16`` launches counted); a restart through
              ``ResilientRunner`` from a checkpoint at the reduced config,
              equal bit for bit to a run without one; and one step each of
              qwen3-moe, paligemma, seamless-m4t-medium (2 + 2 layers: 2
              flash backward launches on the tensor cores) and
              recurrentgemma-2b (3 layers: none) at their widths.
10f. ssd_bwd_kernels — the CUDA ``ssd_chunk`` backward (bf16 and f32 at the
              forward's tensor-core shapes: S = C B^T once per chunk and
              group, then (f32) v = B dst^T a kernel of its own, then dx
              and ddA per chunk and head on wgmma, then dB and the group
              sums of dS per chunk and 64-row band on wgmma, then dC; f32
              x, B and C in two bf16 pieces; since PR 31 the calls off those
              shapes on the one-pass kernel (mma.sync, one launch) at chunks
              of at most 32 tokens and on the wgmma kernels, padded, at
              longer ones; no atomics; each case on
              ``ssd_scan.route``'s kernels, counted by route) against its
              plain formulas: Q 64 / 128 /
              256, P 64, N 64 and 128, G 1 and 2, both types, B and C sliced
              from one projection, a ragged Q and P; 1e-4 (f32) or one bf16 step of
              each gradient's largest value, ddA 1e-4; planted faults (dx's
              state term dropped, one head left out of the group sums)
              rejected in both types on both routes; two calls at the
              training shape and at the reduced mamba2's (16, 16, 16, 1, 8,
              16) bit for bit in both types; then ``ssd_bwd_timing`` at (64,
              256, 80, 1, 64, 128) and at (16, 16, 16, 1, 8, 16) in bf16 and
              f32: the kernel and its plain formulas beside the bound, each
              kernel's registers, spills, shared memory and device time.
10g. ssm_train_path — ``launch.train.run`` at mamba2-2.7b's widths and all 64
              layers (bf16 weights, accum 1 and remat as ``configs/archs.py``
              sets them, AdamW with f32 moments): 4 steps on one fixed batch of
              4 x 4,096 tokens, 2 ``ssd_chunk`` forward launches (remat) and 1
              backward launch a layer a step, every backward launch on the
              tensor cores, the loss falling, each layer's
              backward of the first step against the plain formulas on its
              own inputs; warm step ms, tokens/s and peak memory; one f32
              step at 1 layer against ``ops.ssd`` on the plain route under
              autograd, its one backward launch on the tensor cores.
10h. encdec_path — seamless-m4t-medium at its widths and depth (12 + 12
              layers), 4 requests of 4,096 tokens and 1,024 stand-in frames,
              32 decode steps: 12 launches a prefill (the decoder's causal
              self-attention; the encoder's and the cross attention stay on
              the einsum path), 0 in decode, each layer's attention held, the
              logits as in 10c.
10i. hybrid_path — recurrentgemma-2b at its widths and all 26 layers, the
              same batch: 0 launches (local attention, window 2,048 < S), the
              logits as in 10c.
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
12a. autotune — ``calibrate_backend`` on phase 3's two scorers (the fitted
              rate and launch overhead, reported), the tuned ``block_m`` of
              phases 11 and 12's launch shapes (each path must have served
              at it), and ms a tile at the tuned block against 256 at each
              path's tile, a ragged eighth of it and 100 rows, 8 runs a
              block in turns, masks, survivor lists and counts identical
              across the two.
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
20. udf_path — CORE's query over transformer UDFs
              (``repro_torch.transformer_udf_serving``) at published widths:
              llama3-405b (d 16,384, 128 heads, 8 KV heads of 128, d_ff
              53,248) cut to 1 layer and qwen3-moe-30b-a3b cut to 2 as the
              two predicates' UDFs, each trained 100 AdamW steps on 2,000
              records of 8 tokens (``flash_attention`` forward and backward
              on the packed route), ``build_plan`` on the sample, the
              ``CascadeServer`` over the other 10,000 records
              (``cascade_score`` a tile), ORIG against CORE: launch counts
              against the backbone calls, the first step's attention and
              backward against the plain versions, losses falling, each
              predicate's selectivity, conservation, accuracy, and every
              label against the plain attention but at near ties; then
              ``udf_path_reduced``, the same at the reduced configs (D 16),
              and ``udf_timing``: both kernels at the training steps' three
              shapes beside SDPA and the times of the route before.
21. video_cascade_path — ``repro_torch.video_cascade`` (core-a, core-h,
              core) on the card: one launch a tile, accuracy >= A - 0.05.
22. resilient_path — ``repro_torch.resilient_training`` at the reduced
              dense and SSM configs: a preemption before step 15, one
              restart, bit for bit equal to a straight run, the kernels'
              launches and the straggler events.

Then the card's name and power limit as ``nvidia-smi`` gives them, the
``{"kernels": [...]}`` summary, and ``{"ok": true, "device": {...}}`` last.
Weights are random (seeded); nothing is read from disk but the sources.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import tempfile
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
# The packed route's shapes (bf16, short sequences; ``flash_attention.packed_plan``),
# (B, Sq, Sk, H, K, D): the UDF training shapes at a cut batch, the last
# tile part past B; G 1, 7 and 16; Sq 1, 5, 8 and 64 (a unit over 8 tiles);
# Sq < Sk; D 16, 32, 64, 128 and 256.
PACKED_SHAPES = (
    (250, 8, 8, 128, 8, 128), (251, 8, 8, 32, 4, 128), (333, 8, 8, 4, 2, 16),
    (13, 8, 8, 8, 8, 64), (9, 8, 8, 14, 2, 128), (5, 8, 8, 16, 1, 256),
    (40, 1, 8, 16, 2, 64), (7, 5, 5, 16, 2, 32), (2, 64, 64, 16, 1, 16),
    (3, 64, 64, 8, 8, 128), (6, 8, 16, 4, 2, 64))
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
        # batch x heads past 65,535 at a transformer UDF's 8 tokens
        ((600, 8, 8, 128, 8, 128), True),
        (SERVING_SHAPE, True))) + tuple(
    (*shape, causal, "bfloat16") for shape in PACKED_SHAPES for causal in (True, False))
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
# The reduced mamba2 of resilient_path: 8 x 32 tokens in chunks of 16,
# d_inner 128 in heads of 8, one group of state dim 16: P 8 is off the
# tensor-core shapes (the one-pass route, forward and backward).
SSD_REDUCED_SHAPE = (16, 16, 16, 1, 8, 16)
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
    # the JAX package's test shapes (tests/test_kernels.py:75); P = 8 takes
    # the one-pass route at Q 16 and the padded wgmma route at Q 80
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
    # the one-pass route: the reduced mamba2's shape, and Q 32 with P 24, N
    # 40 (the state dim padded to 48 inside the kernel), G 3, sliced
    (16, 16, 16, 1, 8, 16, "published", "bfloat16"), (16, 16, 16, 1, 8, 16, "published", "float32"),
    (3, 32, 6, 3, 24, 40, "jax_test", "bfloat16", "sliced"),
    (3, 32, 6, 3, 24, 40, "jax_test", "float32", "sliced"),
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
    """Print a phase's JSON line.  On the card it first collects the
    garbage in reference cycles and says how much of the card's memory only
    that freed (``gc_freed_gib``): a phase whose tensors outlive it in a
    cycle shows there, and leaves no later phase short of memory."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        before = torch.cuda.memory_allocated()
        gc.collect()
        fields["gc_freed_gib"] = (before - torch.cuda.memory_allocated()) / 2**30
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


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.detach().cpu(), b.detach().cpu()
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def initial_draws(ds, prof, dev) -> dict:
    """The paper loop's initial weights drawn for ``dev`` against the CPU
    draw, bit for bit: each UDF body (``_train_udf_model`` at 0 steps, at
    its column's hidden width and seed) and an ``mlp1`` proxy
    (``train_mlp`` at 0 steps)."""
    from repro_torch.data.synthetic import _train_udf_model
    from repro_torch.training.proxy_models import train_mlp

    x = ds.x[:prof["udf_train_rows"]]
    udf_equal = []
    for j in range(prof["n_columns"]):
        h = int(prof["udf_hidden"] * prof["cost_scale"].get(j, 1.0))
        y = ds.truth[:len(x), j]
        got, want = (_train_udf_model(x, y, ds.n_classes[j], h, prof["udf_depth"], j,
                                      steps=0, device=d) for d in (dev, "cpu"))
        udf_equal.append(all(same_bits(a, b) for lg, lw in zip(got, want)
                             for a, b in zip(lg, lw)))
    y = np.where(ds.truth[:len(x), 0] >= 2, 1.0, -1.0).astype(np.float32)
    got, want = (train_mlp(x, y, seed=3, steps=0, device=d) for d in (dev, "cpu"))
    mlp_equal = all(same_bits(getattr(got, n), getattr(want, n))
                    for n in ("w1", "b1", "w2", "b2"))
    check(all(udf_equal), f"UDF initial weights on {dev} differ from the CPU draw: {udf_equal}")
    check(mlp_equal, f"mlp1 initial weights on {dev} differ from the CPU draw")
    return dict(udf_initial_weights_equal=udf_equal, mlp1_initial_weights_equal=mlp_equal)


# ------------------------------------------------------- threefry_kernels
THREEFRY_SHAPES = ((1,), (7,), (33, 17), (5, 129, 3), (1_000_003,))  # odd shapes, bit for bit
THREEFRY_BIG = 2**32 + 8  # elements of a bf16 truncated normal past 2^32 (8.6 GB), sampled
THREEFRY_SAMPLES = 4096  # random flat indices a sampled check reads, besides the edges
THREEFRY_PLAIN_N = 2**20  # elements the plain version is timed at (numpy, about a second)
# INT32 rate of an H100 SXM: 64 INT32 lanes an SM a clock, 132 SMs at 1.98 GHz
# (the data sheet gives no INT32 rate).  A threefry2x32 block is 20 rounds of
# add, funnel shift and xor, five key injections of two adds, two adds in and
# one xor out: 73 INT32 operations an element.
INT32_OPS = 16.7e12
THREEFRY_BLOCK_OPS = 73


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype, shape and bytes (of any dtype)."""
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| over every element, in float64 (inf where the
    shapes differ, 0.0 where the values are equal)."""
    a, b = a.detach().cpu().double().reshape(-1), b.detach().cpu().double().reshape(-1)
    if a.shape != b.shape:
        return math.inf
    return float((a - b).abs().max()) if a.numel() else 0.0


def threefry_draws(key) -> tuple:
    """(name, draw(shape, device)) for each transform of the kernel, at the
    constants the model zoo, the batches and the paper loop use."""
    from repro_torch.util import prng

    bf16 = torch.bfloat16
    return (
        ("bits", lambda s, d: prng.bits(key, s, device=d)),
        ("uniform", lambda s, d: prng.uniform(key, s, 0.9, 0.999, device=d)),
        ("normal", lambda s, d: prng.normal(key, s, device=d)),
        ("normal_scaled", lambda s, d: prng.normal(key, s, scale=0.125, times=0.05, device=d)),
        ("truncated_normal", lambda s, d: prng.truncated_normal(key, s, std=0.0625, device=d)),
        ("truncated_normal_bf16", lambda s, d: prng.truncated_normal(
            key, s, std=0.0625, dtype=bf16, times=0.1, device=d)),
        ("randint", lambda s, d: prng.randint(key, s, 0, 128256, device=d)),
        ("randint_int64", lambda s, d: prng.randint(key, s, -5, 256, dtype=torch.int64,
                                                    device=d)),
        ("normal_bf16", lambda s, d: prng.normal(key, s, dtype=bf16, device=d)))


def sample_indices(n: int, rng: np.random.RandomState, around=()) -> np.ndarray:
    """THREEFRY_SAMPLES random flat indices below ``n``, its first and last,
    and every index within 4 of each of ``around`` that is below ``n``."""
    near = [i for c in around for i in range(c - 4, c + 5) if 0 <= i < n]
    idx = np.concatenate([rng.randint(0, n, THREEFRY_SAMPLES, dtype=np.int64),
                          np.array([0, n - 1] + near, np.int64)])
    return np.unique(idx)


def check_sampled(what: str, t: torch.Tensor, draw, idx: np.ndarray) -> float:
    """The drawn ``t`` at flat indices ``idx`` against ``draw.at(idx)``, bit
    for bit; returns the largest absolute difference (0.0 when it passes)."""
    got = t.reshape(-1)[torch.from_numpy(idx).to(t.device)]
    want = draw.at(idx.astype(np.uint64))
    err = abs_diff(got, want)
    check(bits_equal(got, want),
          f"{what}: the kernel's draw differs from the plain version at sampled indices "
          f"by up to {err}")
    return err


@contextlib.contextmanager
def counted_draws(dev, what: str, out: dict, keep: bool = False):
    """Count the threefry kernel's launches and the draws inside: on the
    card every draw is one launch and there is at least one.  Sets
    ``out["threefry_launches"]`` and, with ``keep``, ``out["draws"]``
    ((tensor, Draw) pairs)."""
    from repro_torch.kernels import threefry
    from repro_torch.util import prng

    threefry.reset_launches()
    with prng.recording() as drawn:
        yield
    out["threefry_launches"] = threefry.fill.launches
    if keep:
        out["draws"] = drawn
    if dev.type == "cuda":
        check(len(drawn) > 0 and threefry.fill.launches == len(drawn),
              f"{what}: {threefry.fill.launches} threefry launches for {len(drawn)} draws")


def family_on_card_vs_cpu(dev, arch: str, seed: int) -> dict:
    """The reduced ``arch``'s ``init`` and ``make_batch`` from ``seed`` on
    ``dev`` and on the CPU: every parameter and batch entry bit for bit."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.registry import get_family, make_batch

    cfg = reduced_config(arch)
    fam = get_family(cfg)
    counted = {}
    with counted_draws(dev, f"{arch} init", counted):
        got = fam.init(seed, cfg, device=dev)
        got_batch = make_batch(cfg, 2, 40, key=seed, device=dev)
    want = dict(fam.init(seed, cfg, device="cpu").named_parameters())
    want_batch = make_batch(cfg, 2, 40, key=seed, device="cpu")
    pairs = [(n, p, want[n]) for n, p in got.named_parameters()]
    pairs += [(n, t, want_batch[n]) for n, t in got_batch.items()]
    bad = [n for n, a, b in pairs if not bits_equal(a, b)]
    err = max(abs_diff(a, b) for _, a, b in pairs)
    check(not bad, f"{arch} seed {seed}: {bad} differ between {dev} and the CPU "
          f"by up to {err}")
    return dict(arch=arch, seed=seed, params=len(want), batch=sorted(want_batch),
                launches=counted["threefry_launches"], max_abs_err=err)


def run_threefry_kernels(dev) -> dict:
    """The threefry kernel against its plain version (``util/prng.py``'s
    numpy draw, equal to jax 0.9.0 on the CPU), as failing checks: every
    transform at THREEFRY_SHAPES bit for bit; a bf16 truncated normal of
    THREEFRY_BIG elements at sampled indices around 2^31 and 2^32 (the
    counter's high word), with a planted fault the check must reject (the
    plain values at the index less 2^32, what a kernel that dropped the
    high word would write); every family of ``configs/archs.py`` at its
    reduced config from seeds 0 and 1 and ``make_batch``, card against CPU
    leaf for leaf; then the kernel's time at the largest ``udf_path``
    weight (llama3-405b's embedding) beside its bound, the plain version's
    time at THREEFRY_PLAIN_N elements and ``torch.nn.init.trunc_normal_``'s
    at the same shape (no PyTorch call draws threefry2x32)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.archs import ALL
    from repro_torch.kernels import threefry
    from repro_torch.util import prng

    t_phase = time.perf_counter()
    key = prng.key(20261019)
    rng = np.random.RandomState(0)
    cases, errs = 0, []
    for shape in THREEFRY_SHAPES:
        for name, draw in threefry_draws(key):
            got, want = draw(shape, dev), draw(shape, "cpu")
            errs.append(abs_diff(got, want))
            check(bits_equal(got, want), f"threefry {name} at {shape}: the kernel differs "
                  f"from the plain version by up to {errs[-1]}")
            cases += 1

    big = (THREEFRY_BIG,)
    with prng.recording() as drawn:
        out = prng.truncated_normal(key, big, std=0.0625, dtype=torch.bfloat16, device=dev)
    sync(dev)
    (t, draw), = drawn
    idx = sample_indices(THREEFRY_BIG, rng, around=(2**31, 2**32))
    errs.append(check_sampled("bf16 truncated normal past 2^32", t, draw, idx))
    high = idx[idx >= 2**32]
    got = t.reshape(-1)[torch.from_numpy(high).to(dev)].cpu()
    dropped = draw.at((high - 2**32).astype(np.uint64))
    check(not bits_equal(got, dropped), "the planted fault (the counter's high word dropped) "
          "passed the sampled check")
    del out, t, drawn
    torch.cuda.empty_cache()

    families = [family_on_card_vs_cpu(dev, arch, seed) for arch in sorted(ALL)
                for seed in (0, 1)]
    errs += [f["max_abs_err"] for f in families]

    cfg = get_config("llama3-405b")
    shape = (cfg.vocab_size, cfg.d_model)
    n = shape[0] * shape[1]
    std = np.float32(1.0 / math.sqrt(cfg.d_model))
    buf = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    before = threefry.fill.launches
    ms = cuda_ms(lambda: prng.truncated_normal(key, shape, std=std, dtype=torch.bfloat16,
                                               device=dev, out=buf), dev, iters=5, warmup=2)
    check(threefry.fill.launches - before == 7, "one launch a timed draw")
    small = (THREEFRY_PLAIN_N,)
    small_buf = torch.empty(small, dtype=torch.bfloat16, device=dev)
    small_ms = cuda_ms(lambda: prng.truncated_normal(key, small, std=std, dtype=torch.bfloat16,
                                                     device=dev, out=small_buf), dev, iters=50)
    t0 = time.perf_counter()
    prng.truncated_normal(key, small, std=std, dtype=torch.bfloat16, device="cpu")
    plain_ms = (time.perf_counter() - t0) * 1e3
    try:
        trunc_ms = cuda_ms(lambda: torch.nn.init.trunc_normal_(buf, std=float(std),
                                                               a=-2 * float(std),
                                                               b=2 * float(std)),
                           dev, iters=3, warmup=1)
    except RuntimeError as e:  # reported beside the kernel, not a check
        trunc_ms = f"not measured: {e}"
    del buf, small_buf
    torch.cuda.empty_cache()
    bytes_ms = 2 * n / HBM_BYTES_PER_S * 1e3
    ops_ms = THREEFRY_BLOCK_OPS * n / INT32_OPS * 1e3
    out = dict(cases=cases, shapes=[list(s) for s in THREEFRY_SHAPES],
               transforms=[name for name, _ in threefry_draws(key)],
               big_elements=THREEFRY_BIG, big_sampled=int(len(idx)),
               big_past_2_32=int(len(high)), planted_fault_rejected=True,
               families=families, timing=dict(
                   draw="bf16 truncated normal * std (dense_init)", shape=list(shape),
                   elements=n, ms=ms, bound_ms=max(bytes_ms, ops_ms),
                   bound_by="operations" if ops_ms > bytes_ms else "bytes",
                   bytes_bound_ms=bytes_ms, int32_ops_bound_ms=ops_ms,
                   plain_shape=list(small), plain_ms=plain_ms, kernel_ms_at_plain_shape=small_ms,
                   library_ms=None, trunc_normal_ms=trunc_ms),
               max_abs_err=max(errs),
               max_err_is="over every case, sampled index and family leaf",
               seconds=time.perf_counter() - t_phase)
    emit("threefry_kernels", **out)
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
    setup_s = time.perf_counter() - t0
    draws = initial_draws(ds, prof, dev)
    # the same UDFs trained on the CPU: the initial weights are equal, the
    # trained ones differ by the devices' summation orders (reported only)
    cpu_udfs = make_udfs(ds, hidden=prof["udf_hidden"], depth=prof["udf_depth"],
                         train_rows=prof["udf_train_rows"], seed=0,
                         declared_cost_ms=prof["declared_cost_ms"],
                         cost_scale=prof["cost_scale"], device="cpu")
    agreement = [float(np.mean(u(ds.x) == c(ds.x))) for u, c in zip(udfs, cpu_udfs)]
    stream = make_drifting_stream(ds, n_stream, 0, seed=1).x
    k = int(prof["k_frac"] * prof["n"])
    x_opt = ds.x[:k]
    emit("main_path_setup", records=n_stream, k=k, features=prof["n_features"],
         udf_train_accuracy=[u.train_accuracy for u in udfs],
         cpu_udf_train_accuracy=[u.train_accuracy for u in cpu_udfs],
         label_agreement_vs_cpu=agreement, **draws, setup_s=setup_s)
    tile = 8192
    n_tiles = -(-n_stream // tile)
    plans, outcomes = [], {}
    cascade_score.launches = 0
    for name, cols, sel, A, kind, seed in QUERIES:
        q, cpu_q = (make_query(ds, u, columns=cols, target_selectivity=sel, accuracy_target=A,
                               seed=seed) for u in (udfs, cpu_udfs))
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
        emit("main_path", query=name, kind=kind,
             values=[sorted(p.values) for p in q.predicates],
             cpu_udf_values=[sorted(p.values) for p in cpu_q.predicates],
             order=list(plan.order),
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


def route_shape(case) -> tuple:
    """(B, Sq, Sk, H, K) of a (B, Sq, Sk, H, K, D, ...) case: what
    ``route_for`` and ``backward_route`` read besides D and the type."""
    return tuple(case[:5])


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


def planted_fault(dev, dtype: str = "bfloat16", shape=SERVING_SHAPE) -> dict:
    """The serving-shape check against kernel outputs with faults planted.
    Skipped tile: the kernel run with the values of FAULT_KEYS zeroed, which
    is what a kernel that skipped that tile's P.V product would return; the
    row check must reject it.  In f32 (the split route) also lost pieces:
    the kernel run on q, k and v rounded to bf16, so their mid and lo pieces
    are 0, which the f32 limits must reject.  Each held against the plain
    version on the true values."""
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_plain,
                                                     route)

    case = (*shape, True, dtype)
    q, k, v = make_flash_case(case, dev, seed=0)
    want = flash_attention_plain(q, k, v, causal=True)
    bad_v = v.clone()
    bad_v[:, FAULT_KEYS[0]:FAULT_KEYS[1]] = 0
    err, row_err, close = flash_errors(flash_attention(q, k, bad_v, causal=True), want)
    del bad_v
    caught = row_err > FLASH_ROW_TOL[dtype]
    check(caught, f"{dtype}: a skipped KV tile passes the row check ({row_err})")
    out = dict(dtype=dtype, shape=list(shape), route=route(q, k, v), keys=list(FAULT_KEYS),
               max_abs_err=err,
               max_row_err=row_err, caught_by_abs_tol=not close, caught_by_row_tol=caught)
    if dtype == "float32":
        hi = [t.to(torch.bfloat16).float() for t in (q, k, v)]
        err, row_err, close = flash_errors(flash_attention(*hi, causal=True), want)
        lost = not close or row_err > FLASH_ROW_TOL[dtype]
        check(lost, f"inputs without their mid and lo pieces pass the f32 check ({err}, "
              f"{row_err})")
        out["lost_pieces"] = dict(max_abs_err=err, max_row_err=row_err, caught=lost)
    return out


def flash_repeat(dev, shape=None, dtype: str = "float32") -> dict:
    """Two forward calls with the lse on the same inputs at ``shape``
    (default ``VLM_SHAPE``, paligemma's; in f32 the split route at D 256):
    output and lse equal bit for bit (no atomics)."""
    from repro_torch.kernels.flash_attention import flash_attention, route

    shape = shape or VLM_SHAPE
    q, k, v = make_flash_case((*shape, True, dtype), dev, seed=9)
    a, la = flash_attention(q, k, v, causal=True, return_lse=True)
    b, lb = flash_attention(q, k, v, causal=True, return_lse=True)
    sync(dev)
    equal = {"out": torch.equal(a, b), "lse": torch.equal(la, lb)}
    check(all(equal.values()), f"two flash_attention calls at {shape} {dtype} differ: {equal}")
    return dict(shape=list(shape), dtype=dtype, route=route(q, k, v), bitwise_equal=equal)


# The packed route's own checks: two calls at llama3-405b's UDF shape bit for
# bit (forward here, backward in ``run_flash_bwd_kernels``), and unit
# isolation at the UDF shapes (cut batch, the last tile part past B).
PACKED_REPEAT_SHAPE = (2000, 8, 8, 128, 8, 128)
ISOLATION_SHAPES = ((61, 8, 8, 32, 4, 128), (37, 8, 8, 4, 2, 16), (16, 8, 8, 128, 8, 128))


def packed_isolation(dev, shape) -> dict:
    """A leak across the units that share a packed tile shows.  Forward:
    each (record, KV head) gets a V constant over its keys and its own
    (integers 1..127, exact in bf16), so each output row must equal its
    own unit's constant within one bf16 step of it (p is rounded to bf16
    for P.V, l summed from the f32 p); a row that attends another unit's
    keys moves by a whole integer times that key's weight.  Backward (on
    the random V: over a constant one dS = P (dP - Di) vanishes and dq, dk
    with it): dO zero on every other record, whose dq, dk and dv must then
    be exactly 0 (dS = 0 on its rows; its keys see only its rows), the
    other records' gradients within BWD_TOL of the plain backward."""
    from repro_torch.kernels import flash_attention as fm

    B, Sq, Sk, H, K, D = shape
    case = (*shape, True, "bfloat16")
    q, k, v, dout = make_bwd_case(case, dev, seed=13)
    check(fm.route(q, k, v) == "packed", f"{shape}: not on the packed route")
    const = (1 + (torch.arange(B, device=dev)[:, None] * K
                  + torch.arange(K, device=dev)[None]) % 127).to(torch.bfloat16)  # (B, K)
    flat = const[:, None, :, None].expand(B, Sk, K, D).contiguous()
    out = fm.flash_attention(q, k, flat, causal=True)
    want = const.float().repeat_interleave(H // K, dim=1)[:, None, :, None]  # (B, 1, H, 1)
    step = torch.exp2(torch.floor(torch.log2(want)) - 7)
    fwd_err = float(((out.float() - want).abs() / step).max())
    check(fwd_err <= 1.0, f"{shape}: an output row is {fwd_err} bf16 steps from its unit's "
          f"constant")
    out, lse = fm.flash_attention(q, k, v, causal=True, return_lse=True)
    dout[1::2] = 0
    got = fm.flash_attention_backward(q, k, v, out, dout, lse, causal=True)
    ref = fm.flash_attention_backward_plain(q, k, v, out, dout, causal=True)
    sync(dev)
    zero = [int(t[1::2].count_nonzero()) for t in got]
    check(zero == [0, 0, 0], f"{shape}: records with dO = 0 got nonzero (dq, dk, dv) "
          f"elements {zero}")
    errs = check_bwd_output(f"{shape}, half of dO zero", got, ref)
    return dict(shape=list(shape), forward_max_steps=fwd_err, zero_records_nonzero=zero,
                backward_errors=errs)


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
    drawn = {}
    with counted_draws(dev, "dense_path init", drawn):
        model = fam.init(0, cfg, device=dev)
        tokens = make_batch(cfg, batch, prompt, key=0, device=dev)["tokens"]
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
               prefill_launches=prefill_launches, init_s=init_s,
               threefry_launches=drawn["threefry_launches"], prefill_s=prefill_s,
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


def time_flash(dev, dtype: str, iters: int, shape=SERVING_SHAPE) -> dict:
    """Kernel, plain version and ``scaled_dot_product_attention`` at ``shape``
    (default: the dense serving shape), in turns (plain, kernel, library, kernel, plain).  The
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

    B, Sq, Sk, H, K, D = shape
    case = (*shape, True, dtype)
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
    lse_a = cuda_ms(lambda: flash_attention(q, k, v, causal=True, return_lse=True), dev, iters,
                    warmup=1)
    lib_ms = cuda_ms(library, dev, 10 * iters, warmup=2)
    lse_b = cuda_ms(lambda: flash_attention(q, k, v, causal=True, return_lse=True), dev, iters,
                    warmup=0)
    kern_b = cuda_ms(lambda: flash_attention(q, k, v, causal=True), dev, iters, warmup=0)
    plain_b = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True), dev, 1, warmup=0)
    path = route(q, k, v)
    bound_ms, bound_by, nbytes, flops = flash_bound(*case, route=path)
    ms = min(kern_a, kern_b)
    row = dict(shape=list(shape), causal=True, dtype=dtype, route=path, ms=ms,
               ms_runs=[kern_a, kern_b], with_lse_ms=min(lse_a, lse_b),
               with_lse_ms_runs=[lse_a, lse_b], plain_ms=min(plain_a, plain_b),
               plain_ms_runs=[plain_a, plain_b], library_ms=lib_ms,
               library="scaled_dot_product_attention (K, V repeated to H heads)",
               library_max_abs_diff=lib_err, bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, flops=flops, tflops_per_s=flops / (ms * 1e-3) / 1e12,
               share_of_bound=bound_ms / ms)
    if dtype == "float32":
        row["cuda_core_bound_ms"] = flash_bound(*case)[0]
        row["share_of_cuda_core_bound"] = row["cuda_core_bound_ms"] / ms
    split = dtype == "float32"  # serving's instantiation (no lse) of the route's kernel
    log = _build.library_path("flash_attention").with_suffix(".log").read_text()
    res = resources(D, q.dtype, route_shape(shape))
    if path == "packed":
        N = res["kernel"].split(", ")[1]
        entry, fragment = res["kernel"], f"packed_fwdILi{D}ELi{N}ELb0E"
    else:
        entry = f"flash_attention_wgmma<{D}, {str(split).lower()}, false>"
        fragment = f"flash_attention_wgmmaILi{D}ELb{int(split)}ELb0E"
    row["ptxas"] = {"entry": entry, **ptxas_entry(log, fragment)}
    row.update(res)
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
                                 ptxas=ptxas_entry(log, "split_bf16_segments"))
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


def ssd_one_pass_faults(dev, dtype: str, shape=SSD_REDUCED_SHAPE) -> dict:
    """The check against faults of the one-pass kernel at ``shape`` (the
    reduced mamba2's), each made by the kernel itself and held against the
    plain version of the true inputs: states without its decay weight w (the
    kernel's states at dA = 0, where w = 1) and head 5's y_diag taken from
    its neighbour's M (the kernel run with head 5's dA replaced by head 6's:
    one group, so S is shared and only L moves).  The check must reject
    both."""
    from repro_torch.kernels.ssd_scan import route, ssd_chunk, ssd_chunk_plain

    x, dA, B, C = ssd_inputs((*shape, "published", dtype), dev, seed=5)
    check(route(x, B, C) == "one_pass", f"{shape} {dtype}: not on the one-pass route")
    y, st, dec = ssd_chunk(x, dA, B, C)
    ref = ssd_chunk_plain(x, dA, B, C)
    clean = check_ssd_output(f"{shape} {dtype}, before the faults", (y, st, dec), ref, dA)
    no_decay = ssd_errors((y, ssd_chunk(x, torch.zeros_like(dA), B, C)[1], dec), ref, dA)
    shifted = dA.clone()
    shifted[:, :, 5] = dA[:, :, 6]
    y_bad = y.clone()
    y_bad[:, :, 5] = ssd_chunk(x, shifted, B, C)[0][:, :, 5]
    neighbour = ssd_errors((y_bad, st, dec), ref, dA)
    caught = {"states_without_decay_weight": no_decay["states_rel"] > SSD_TOL,
              "y_from_neighbours_M": neighbour["y_diag_rel"] > SSD_TOL}
    check(all(caught.values()), f"{dtype} at {shape}: a planted one-pass fault passes the "
          f"check: {caught} ({no_decay}, {neighbour})")
    return dict(dtype=dtype, shape=list(shape), route="one_pass", clean=clean,
                states_without_decay_weight_rel=no_decay["states_rel"],
                y_from_neighbours_M_rel=neighbour["y_diag_rel"], caught=caught)


def ssd_repeat(dev, dtype: str, shape=SSD_REDUCED_SHAPE) -> dict:
    """Two forward calls on the same inputs at ``shape`` (the reduced
    mamba2's, on the one-pass route): equal bit for bit (fixed-order sums,
    no atomics)."""
    from repro_torch.kernels.ssd_scan import route, ssd_chunk

    x, dA, B, C = ssd_inputs((*shape, "published", dtype), dev, seed=11)
    a, b = ssd_chunk(x, dA, B, C), ssd_chunk(x, dA, B, C)
    sync(dev)
    equal = {n: torch.equal(u, v) for n, u, v in zip(("y_diag", "states", "chunk_decay"), a, b)}
    check(all(equal.values()), f"two ssd_chunk calls at {shape} in {dtype} differ: {equal}")
    return dict(shape=list(shape), dtype=dtype, route=route(x, B, C), bitwise_equal=equal)


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
    drawn = {}
    with counted_draws(dev, "ssm_path init", drawn):
        model = fam.init(0, cfg, device=dev)
        tokens = make_batch(cfg, batch, prompt, key=0, device=dev)["tokens"]
    set_published_dynamics(model, cfg, seed=0)
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
               threefry_launches=drawn["threefry_launches"],
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
    routes' own bound (``route`` "tensor_cores" or "one_pass": both split
    x, B and C) counts their three bf16 products of pieces at the bf16 peak
    instead; the default figure puts f32 work at the CUDA-core peak."""
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * (nc * Q * H * P + 2 * nc * Q * G * N) + 4 * (
        nc * Q * H + nc * Q * H * P + nc * H * P * N + nc * H)
    pairs = Q * (Q + 1) // 2
    flops = 2 * nc * (G * pairs * N + H * pairs * P + H * Q * P * N)
    t_bytes = nbytes / HBM_BYTES_PER_S
    if dtype == "float32" and route in ("tensor_cores", "one_pass"):
        t_ops = SPLIT_PRODUCTS["ssd_chunk"] * flops / BF16_FLOPS
    else:
        t_ops = flops / (BF16_FLOPS if dtype == "bfloat16" else FP32_FLOPS)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def ssd_entry(path: str, dtype: str, P: int, N: int) -> tuple:
    """(kernel, a fragment of its mangled name in the compiler's report) of
    the forward kernel a call on ``path`` runs, at the head and state dims
    ``ssd_scan.pad_operands`` gives the wgmma kernels."""
    from repro_torch.kernels import ssd_scan

    if path == "one_pass":
        return "fwd_chunk", "fwd_chunkI" + ("13__nv_bfloat16" if dtype == "bfloat16" else "f") + "E"
    P, N = ssd_scan._tc_width(P, ssd_scan.TC_P), ssd_scan._tc_width(N, ssd_scan.TC_N)
    entry = "ssd_chunk_wgmma" if dtype == "bfloat16" else "ssd_chunk_split"
    return entry, f"{entry}ILi{P}ELi{N}E"


def ssd_device_us(shape, dtypes, calls: int = 3) -> dict:
    """{dtype: device µs a call} of the forward's kernel at ``shape``, from a
    profile of ``calls`` calls in this process ("not measured" where the
    profiler recorded no event of it)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ssd_scan import route, ssd_chunk

    out = {}
    for dtype in dtypes:
        x, dA, B, C = ssd_inputs((*shape, "published", dtype), torch.device("cuda"), seed=7)
        entry = ssd_entry(route(x, B, C), dtype, shape[4], shape[5])[0]
        ssd_chunk(x, dA, B, C)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                ssd_chunk(x, dA, B, C)
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and entry + "<" in e.name]
        out[dtype] = sum(us) / len(us) if us else "not measured"
    return out


_SSD_DEVICE_US: dict = {}  # shape -> {dtype: device µs a call}, from fresh processes


def fresh_ssd_device_us(shape, dtype: str):
    """The forward kernel's device µs a call at ``shape`` in ``dtype``, from
    ``ssd_device_us`` in a fresh process (the kernels already built; one
    process a shape, both types): late in this script's process the
    profiler records no device event of these kernels (PERF.md §7)."""
    if shape not in _SSD_DEVICE_US:
        code = ("import json, chip_smoke; "
                f"print('DEVICE_US ' + json.dumps(chip_smoke.ssd_device_us({tuple(shape)}, "
                "('bfloat16', 'float32'))))")
        run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                             text=True, timeout=300)
        lines = [ln for ln in run.stdout.splitlines() if ln.startswith("DEVICE_US ")]
        check(run.returncode == 0 and len(lines) == 1, f"the fresh profile process failed "
              f"({run.returncode}): {run.stderr[-2000:]}")
        _SSD_DEVICE_US[shape] = json.loads(lines[0].removeprefix("DEVICE_US "))
    return _SSD_DEVICE_US[shape][dtype]


def time_ssd(dev, dtype: str, iters: int, shape=SSD_SERVING) -> dict:
    """Kernel and plain version at ``shape`` (the serving shape, or the
    reduced mamba2's, off the tensor-core shapes), in turns (plain, kernel,
    kernel, plain), with the route the kernel took and its registers,
    spills (the compiler's report) and shared memory a block, and its device
    µs a call from a profile of 3 calls in a fresh process
    (``fresh_ssd_device_us``).  No single PyTorch call computes the
    function, so there is no library time."""
    from repro_torch.kernels import _build, ssd_scan
    from repro_torch.kernels.ssd_scan import resources, route, ssd_chunk, ssd_chunk_plain

    case = (*shape, "published", dtype)
    x, dA, B, C = ssd_inputs(case, dev, seed=7)
    errs = ssd_errors(ssd_chunk(x, dA, B, C), ssd_chunk_plain(x, dA, B, C), dA)
    path = route(x, B, C)
    _nc, Q, _H, _G, P, N = shape
    entry, fragment = ssd_entry(path, dtype, P, N)
    if path == "tensor_cores":  # the dims the wgmma kernels see
        P, N = ssd_scan._tc_width(P, ssd_scan.TC_P), ssd_scan._tc_width(N, ssd_scan.TC_N)
    log = _build.library_path("ssd_chunk").with_suffix(".log").read_text()
    kernel = dict(route=path, entry=entry, **ptxas_entry(log, fragment),
                  **resources(path, Q, P, N, x.dtype),
                  device_us_a_call=fresh_ssd_device_us(tuple(shape), dtype))
    plain_a = cuda_ms(lambda: ssd_chunk_plain(x, dA, B, C), dev, 2, warmup=1)
    kern_a = cuda_ms(lambda: ssd_chunk(x, dA, B, C), dev, iters, warmup=2)
    kern_b = cuda_ms(lambda: ssd_chunk(x, dA, B, C), dev, iters, warmup=0)
    plain_b = cuda_ms(lambda: ssd_chunk_plain(x, dA, B, C), dev, 2, warmup=0)
    bound_ms, bound_by, nbytes, flops = ssd_bound(*shape, dtype, route=path)
    ms = min(kern_a, kern_b)
    row = dict(shape=list(shape), dtype=dtype, route=path, ms=ms, ms_runs=[kern_a, kern_b],
               plain_ms=min(plain_a, plain_b), plain_ms_runs=[plain_a, plain_b],
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               flops=flops, gbytes_per_s=nbytes / (ms * 1e-3) / 1e9,
               share_of_bound=bound_ms / ms, max_abs_err=max(errs["y_diag"], errs["states"]),
               kernel=kernel)
    if dtype == "float32":
        row["cuda_core_bound_ms"] = ssd_bound(*shape, dtype)[0]
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


# ------------------------------------------------------------- phase 10f
# The ssd_chunk backward against its plain formulas: (nc, Q, H, G, P, N,
# log-decays, dtype[, "sliced"]) as SSD_CASES; Q 64 / 128 / 256, P 64, N 64
# and 128, G 1 and 2, both types, B and C sliced from one wider projection
# as ops.ssd passes them; a ragged Q and P (48, 24: the kernel's padding)
# and the training shape itself.
SSD_BWD_CASES = tuple(
    (nc, Q, H, G, 64, N, kind, dtype, "sliced")
    for dtype in ("bfloat16", "float32")
    for nc, Q, H, G, N, kind in ((4, 64, 4, 1, 64, "jax_test"), (3, 128, 8, 2, 128, "published"),
                                 (2, 256, 8, 1, 128, "published"), (2, 256, 6, 2, 64, "jax_test"),
                                 (2, 256, 4, 1, 128, "jax_init"))
) + ((2, 48, 4, 2, 24, 40, "jax_test", "float32"), (2, 48, 4, 2, 24, 40, "near_zero", "bfloat16"),
     # the tensor-core route's edges: ragged Q (80, 208), G 3 < H, P 16 and
     # 32, N 16 to 64
     (3, 80, 6, 3, 16, 16, "jax_test", "bfloat16"), (2, 208, 4, 1, 32, 64, "published", "bfloat16"),
     (4, 64, 4, 2, 16, 32, "jax_test", "bfloat16"),
     # the one-pass route (chunks of at most 32 tokens off those shapes): the
     # reduced mamba2's shape in both types, and Q 32 with P 24, N 40 sliced
     (16, 16, 16, 1, 8, 16, "published", "bfloat16"),
     (16, 16, 16, 1, 8, 16, "published", "float32"),
     (3, 32, 6, 3, 24, 40, "jax_test", "bfloat16", "sliced"))
SSD_TRAIN_SHAPE = (64, 256, 80, 1, 64, 128)  # mamba2-2.7b, 4 x 4,096 tokens in chunks of 256
SSD_FAULT_SHAPE = (8, 256, 16, 1, 64, 128)  # the planted faults' shape on the wgmma route
# Each gradient's largest difference over its largest plain value.  Both
# sum f32 products of the same values in different orders (the kernel's
# cum in a warp scan, the card's torch.cumsum in another): against an f64
# evaluation the plain f32 formulas miss by at most 6.4e-6 at Q 256 with
# these log-decays (the largest of dx, ddA, dB, dC; ddA, a difference of
# G's row and column sums, is not worse than the others there), so 1e-4.
# In bf16 dx, dB and dC are rounded once on each side: one bf16 step at
# the largest value, at most 2^-7 of it (a step is 2^-8 to 2^-7 of the
# value it rounds); ddA stays f32 in both.
SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
SSD_BWD_DDA_TOL = 1e-4
SSD_BWD_NAMES = ("dx", "ddA", "dB", "dC")
SSD_BWD_SLICE = 8  # chunks a plain call takes on the card (its (nc, H, Q, Q) f32 temporaries)


def ssd_bwd_inputs(case, dev, seed):
    """``ssd_inputs`` plus output gradients dy (nc, Q, H, P), dstates (nc,
    H, P, N) and ddecay (nc, H): standard normals, f32."""
    nc, Q, H, _G, P, N = case[:6]
    x, dA, B, C = ssd_inputs(case, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 500)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    return x, dA, B, C, randn(nc, Q, H, P), randn(nc, H, P, N), randn(nc, H)


def ssd_bwd_plain_sliced(x, dA, B, C, dy, dst, ddec):
    """``ssd_chunk_backward_plain`` a SSD_BWD_SLICE chunks at a time (the
    chunks are independent), to bound its temporaries at training shapes."""
    from repro_torch.kernels.ssd_scan import ssd_chunk_backward_plain

    parts = [ssd_chunk_backward_plain(*(t[i:i + SSD_BWD_SLICE] for t in
                                        (x, dA, B, C, dy, dst, ddec)))
             for i in range(0, x.shape[0], SSD_BWD_SLICE)]
    return tuple(torch.cat(p) for p in zip(*parts))


def ssd_bwd_errors(got, want) -> dict:
    """{name: largest difference over the largest |plain| value}."""
    tiny = torch.finfo(torch.float32).tiny
    return {n: float((a.float() - b.float()).abs().max() / max(float(b.float().abs().max()), tiny))
            for n, a, b in zip(SSD_BWD_NAMES, got, want)}


def ssd_bwd_within(errs: dict, dtype: str) -> bool:
    return all(e <= (SSD_BWD_DDA_TOL if n == "ddA" else SSD_BWD_TOL[dtype])
               for n, e in errs.items())


def check_ssd_bwd_output(what: str, got, want, dtype: str) -> dict:
    """The kernel's (dx, ddA, dB, dC) within SSD_BWD_TOL (ddA:
    SSD_BWD_DDA_TOL) of the plain ones; returns the errors."""
    for n, a, b in zip(SSD_BWD_NAMES, got, want):
        check(a.shape == b.shape and a.dtype == b.dtype, f"{what}: bad {n}")
        check(bool(torch.isfinite(a).all()), f"{what}: non-finite {n}")
    errs = ssd_bwd_errors(got, want)
    check(ssd_bwd_within(errs, dtype), f"{what}: gradients differ from the plain version by "
          f"{errs} of their largest values (tol {SSD_BWD_TOL[dtype]}, ddA {SSD_BWD_DDA_TOL})")
    return errs


def check_ssd_bwd_case(case, dev, seed=0) -> dict:
    from repro_torch.kernels.ssd_scan import ssd_chunk_backward

    args = ssd_bwd_inputs(case, dev, seed)
    got = ssd_chunk_backward(*args)
    want = ssd_bwd_plain_sliced(*args)
    sync(dev)
    return check_ssd_bwd_output(str(case), got, want, case[7])


def ssd_bwd_planted_faults(dev, dtype: str, shape=SSD_FAULT_SHAPE) -> dict:
    """At ``shape`` (SSD_FAULT_SHAPE on the wgmma route, or the reduced
    mamba2's on the one-pass route) with the JAX test's log-decays: the
    kernel run with dstates zeroed (its dx without the state term w * B
    dst^T) and with one head's dy and dstates zeroed (its dB and dC without
    that head's share of the group sums), each held against the plain
    gradients of the true inputs: the check must reject both."""
    from repro_torch.kernels.ssd_scan import route, ssd_chunk_backward

    case = (*shape, "jax_test", dtype)
    x, dA, B, C, dy, dst, ddec = ssd_bwd_inputs(case, dev, seed=3)
    want = ssd_bwd_plain_sliced(x, dA, B, C, dy, dst, ddec)
    clean = check_ssd_bwd_output(f"{case}, before the faults", ssd_chunk_backward(
        x, dA, B, C, dy, dst, ddec), want, dtype)
    no_state = ssd_bwd_errors(ssd_chunk_backward(x, dA, B, C, dy, torch.zeros_like(dst), ddec),
                              want)
    dy1, dst1 = dy.clone(), dst.clone()
    dy1[:, :, 5] = 0
    dst1[:, 5] = 0
    no_head = ssd_bwd_errors(ssd_chunk_backward(x, dA, B, C, dy1, dst1, ddec), want)
    caught = {"dx_state_term_dropped": not ssd_bwd_within({"dx": no_state["dx"]}, dtype),
              "head_left_out_of_group_sum": not ssd_bwd_within(
                  {"dB": no_head["dB"], "dC": no_head["dC"]}, dtype)}
    check(all(caught.values()), f"{dtype} at {shape}: a planted backward fault passes the "
          f"check: {caught} ({no_state}, {no_head})")
    return dict(dtype=dtype, shape=list(case[:6]), route=route(x, B, C), clean=clean,
                dx_state_term_dropped=no_state, head_left_out_of_group_sum=no_head,
                caught=caught)


def ssd_bwd_repeat(dev, dtype: str = "bfloat16", shape=SSD_TRAIN_SHAPE) -> dict:
    """Two backward calls on the same inputs at ``shape`` (the training
    shape, or the reduced mamba2's): equal bit for bit (no atomics; a
    restart that replays a step relies on it)."""
    from repro_torch.kernels.ssd_scan import route, ssd_chunk_backward

    args = ssd_bwd_inputs((*shape, "published", dtype, "sliced"), dev, seed=11)
    a = ssd_chunk_backward(*args)
    b = ssd_chunk_backward(*args)
    sync(dev)
    equal = {n: torch.equal(u, v) for n, u, v in zip(SSD_BWD_NAMES, a, b)}
    check(all(equal.values()), f"two ssd_chunk backward calls at {shape} differ: {equal}")
    return dict(shape=list(shape), dtype=dtype, route=route(args[0], args[2], args[3]),
                bitwise_equal=equal)


def ssd_bwd_bound(nc, Q, H, G, P, N, dtype, route="cuda_cores") -> tuple:
    """(ms, bound_by, bytes, flops, CUDA-core ms): x, B, C, dA, dy, dstates
    and ddecay read once and dx, ddA, dB, dC written once over HBM; the
    multiply-adds on the causal pairs (dM = dy x^T and M^T dy over P, and
    the two state products v = B dst^T and (w x) dst over Q P N, per head;
    S = C B^T, dC and dB over N, per chunk and group) at the peak for the
    input type, and beside it at the f32 CUDA-core peak.  The tensor-core
    route's own bound counts its bf16 products of pieces at the bf16 peak
    instead: in bf16 per head two for dM (dy in two pieces), three for M^T
    dy, two for v (dst in two pieces), three for the state term; per chunk
    and group one for S, one for dC, two for dB's (sum dS)^T C; in f32 (x,
    B and C in two pieces too) three for each of dM, M^T dy, v and the
    state term, and three for S, one for dC, three for dB.  The one-pass
    route runs the same pieces but dC as products of (sum dS)'s two pieces
    too: one more in bf16 (two for dC), two more in f32 (three for dC), per
    chunk and group."""
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * (2 * nc * Q * H * P + 4 * nc * Q * G * N) + 4 * (
        2 * nc * Q * H + nc * Q * H * P + nc * H * P * N + nc * H)
    pairs = Q * (Q + 1) // 2
    flops = 2 * nc * (H * (2 * pairs * P + 2 * Q * P * N) + G * 3 * pairs * N)
    t_bytes = nbytes / HBM_BYTES_PER_S
    one_pass = route == "one_pass"  # dC as products of pieces too
    if route in ("tensor_cores", "one_pass") and dtype == "bfloat16":
        t_ops = 2 * nc * (H * 5 * (pairs * P + Q * P * N)
                          + G * (5 if one_pass else 4) * pairs * N) / BF16_FLOPS
    elif route in ("tensor_cores", "one_pass"):
        t_ops = 2 * nc * (H * 6 * (pairs * P + Q * P * N)
                          + G * (9 if one_pass else 7) * pairs * N) / BF16_FLOPS
    else:
        t_ops = flops / (BF16_FLOPS if dtype == "bfloat16" else FP32_FLOPS)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes,
            flops, max(t_bytes, flops / FP32_FLOPS) * 1e3)


def ssd_bwd_fragments(path: str, P: int, N: int, dtype: str) -> dict:
    """{kernel: a fragment of its mangled name in the compiler's report}
    of a backward route's kernels (``ssd_scan.backward_kernels``)."""
    from repro_torch.kernels.ssd_scan import backward_kernels

    tname = "13__nv_bfloat16" if dtype == "bfloat16" else "f"
    out = {}
    for k in backward_kernels(path, getattr(torch, dtype)):
        if k == "tc::bwd_v":  # f32 only: not templated on the type
            out[k] = f"bwd_vILi{P}ELi{N}E"
        elif k == "op::bwd_chunk":  # templated on the type alone
            out[k] = f"bwd_chunkI{tname}E"
        elif k.startswith("tc::"):
            out[k] = f"{k[4:]}I{tname}Li{P}ELi{N}E"
        else:
            out[k] = f"{k}I{tname}" + ("Li64E" if k == "bwd_head" else "E")
    return out


def time_ssd_bwd(dev, dtype: str, iters: int, shape=SSD_TRAIN_SHAPE) -> dict:
    """The backward kernel and its plain formulas at ``shape`` (the training
    shape, or the reduced mamba2's), in turns (plain, kernel, kernel,
    plain), beside the bound of the route it takes; each of the route's
    kernels' registers, spills (the compiler's report), shared memory and
    device time from a profile of 3 calls.  No single PyTorch call computes
    this gradient, so there is no library time."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import (backward_kernels, backward_resources, route,
                                              ssd_chunk_backward)

    case = (*shape, "published", dtype, "sliced")
    args = ssd_bwd_inputs(case, dev, seed=7)
    path = route(args[0], args[2], args[3])
    errs = check_ssd_bwd_output(f"{case}, timed", ssd_chunk_backward(*args),
                                ssd_bwd_plain_sliced(*args), dtype)
    plain_a = cuda_ms(lambda: ssd_bwd_plain_sliced(*args), dev, 1, warmup=1)
    kern_a = cuda_ms(lambda: ssd_chunk_backward(*args), dev, iters, warmup=2)
    kern_b = cuda_ms(lambda: ssd_chunk_backward(*args), dev, iters, warmup=0)
    plain_b = cuda_ms(lambda: ssd_bwd_plain_sliced(*args), dev, 1, warmup=0)
    bound_ms, bound_by, nbytes, flops, cc_ms = ssd_bwd_bound(*shape, dtype, route=path)
    _nc, Q, H, G, P, N = shape
    frag = ssd_bwd_fragments(path, P, N, dtype)
    log = _build.library_path("ssd_chunk_bwd").with_suffix(".log").read_text()
    res = backward_resources(P, args[0].dtype, path, N, Q=Q, rep=H // G)
    prof = device_profile(lambda: [ssd_chunk_backward(*args) for _ in range(3)], dev)
    kernel_us = {}
    names = backward_kernels(path, args[0].dtype)
    for k in names:
        hits = [t for t in prof["top"] if k + "<" in t["name"] or f"::{k}<" in t["name"]]
        n = sum(t["count"] for t in hits)
        kernel_us[k] = sum(t["us"] for t in hits) / n if n else "not measured"
    ms = min(kern_a, kern_b)
    row = dict(shape=list(shape), dtype=dtype, route=path, ms=ms,
               ms_runs=[kern_a, kern_b], plain_ms=min(plain_a, plain_b),
               plain_ms_runs=[plain_a, plain_b], plain="ssd_chunk_backward_plain, "
               f"{SSD_BWD_SLICE} chunks a call", library_ms=None, bound_ms=bound_ms,
               bound_by=bound_by, cuda_core_bound_ms=cc_ms, bytes=nbytes, flops=flops,
               tflops_per_s=flops / (ms * 1e-3) / 1e12, share_of_bound=bound_ms / ms,
               share_of_cuda_core_bound=cc_ms / ms, max_err=errs,
               kernels={k: dict(ptxas=ptxas_entry(log, frag[k]), **res[k],
                                device_us_a_call=kernel_us[k]) for k in names},
               profile=prof)
    emit("ssd_bwd_timing", **row)
    return row


def ssd_route_rule(case) -> str:
    """The route a SSD_CASES or SSD_BWD_CASES case must take, forward and
    backward alike: the wgmma kernels at their head and state dims (and,
    padded, off them at chunks longer than ONE_PASS_MAX_Q), the one-pass
    kernel off them at shorter chunks (the cases' layouts are aligned where
    their dims are on)."""
    from repro_torch.kernels import ssd_scan

    Q, P, N = case[1], case[4], case[5]
    if (P in ssd_scan.TC_P and N in ssd_scan.TC_N) or Q > ssd_scan.ONE_PASS_MAX_Q:
        return "tensor_cores"
    return "one_pass"


def run_ssd_bwd_kernels(dev) -> dict:
    """Phase 10f: every SSD_BWD_CASES case against the plain formulas, each
    on its route, the planted faults in both types on both routes, two calls
    bit for bit at the training shape and at the reduced mamba2's (the
    one-pass route), then ``ssd_bwd_timing`` at both in bf16 and in f32."""
    from repro_torch.kernels import ssd_scan

    t0 = time.perf_counter()
    ssd_scan.reset_launches()
    errs, routes = [], []
    for i, case in enumerate(SSD_BWD_CASES):
        before = dict(ssd_scan.ssd_chunk_backward.route_launches)
        errs.append(check_ssd_bwd_case(case, dev, seed=i))
        routes.append(route_taken(ssd_scan.ssd_chunk_backward, before))
        want = ssd_route_rule(case)
        check(routes[-1] in (want, "plain"), f"{case}: took the {routes[-1]} route, not {want}")
    launches = ssd_scan.ssd_chunk_backward.launches
    check(launches == len(SSD_BWD_CASES) or dev.type == "cpu",
          f"{launches} backward launches for {len(SSD_BWD_CASES)} cases")
    faults = [ssd_bwd_planted_faults(dev, dt, shape) for shape in (SSD_FAULT_SHAPE,
                                                                   SSD_REDUCED_SHAPE)
              for dt in ("bfloat16", "float32")]
    repeat = ssd_bwd_repeat(dev)
    torch.cuda.empty_cache()
    repeat32 = ssd_bwd_repeat(dev, "float32")
    repeat_reduced = [ssd_bwd_repeat(dev, dt, SSD_REDUCED_SHAPE) for dt in ("bfloat16", "float32")]
    emit("ssd_bwd_kernels", cases=len(SSD_BWD_CASES), seconds=time.perf_counter() - t0,
         max_err={dt: {n: max(e[n] for c, e in zip(SSD_BWD_CASES, errs) if c[7] == dt)
                       for n in SSD_BWD_NAMES} for dt in SSD_BWD_TOL},
         tol=SSD_BWD_TOL, ddA_tol=SSD_BWD_DDA_TOL, launches=launches,
         launches_by_route=dict(ssd_scan.ssd_chunk_backward.route_launches),
         cases_by_route={dt: {r: sum(c[7] == dt and t == r for c, t in zip(SSD_BWD_CASES, routes))
                              for r in ssd_scan.ROUTES} for dt in SSD_BWD_TOL},
         planted_faults=faults, repeat=repeat, repeat_float32=repeat32,
         repeat_reduced=repeat_reduced,
         shapes=[list(c) + [t, e] for c, t, e in zip(SSD_BWD_CASES, routes, errs)])
    torch.cuda.empty_cache()
    row = time_ssd_bwd(dev, "bfloat16", iters=5)
    torch.cuda.empty_cache()
    row32 = time_ssd_bwd(dev, "float32", iters=3)  # the f32 step's route (tensor cores)
    torch.cuda.empty_cache()
    reduced = {dt: time_ssd_bwd(dev, dt, iters=100, shape=SSD_REDUCED_SHAPE)
               for dt in ("bfloat16", "float32")}
    return {"max_err": max(max(e.values()) for e in errs), "row": row, "row_float32": row32,
            "rows_reduced": reduced,
            "max_err_float32": max(max(e.values()) for c, e in zip(SSD_BWD_CASES, errs)
                                   if c[7] == "float32"),
            "max_err_one_pass": max([max(e.values()) for c, e in zip(SSD_BWD_CASES, errs)
                                     if ssd_route_rule(c) == "one_pass"]
                                    + [max(r["max_err"].values()) for r in reduced.values()])}


# ------------------------------------------------------------- phase 12a
def scorer_tile_ms(scorer, x: np.ndarray, iters: int) -> float:
    """Host-clock ms of one ``score_masks`` call on the tile ``x`` (the
    serving engine's route: a pinned upload, one launch, one fetch, each
    call ending in the fetch's synchronize), after one warm-up call."""
    scorer.score_masks(x)
    sync(scorer.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        scorer.score_masks(x)
    sync(scorer.device)
    return (time.perf_counter() - t0) * 1e3 / iters


AUTOTUNE_TURNS = 4  # (256, tuned, tuned, 256) pairs a tile: 8 runs a block


def run_autotune(dev, plans, cases: dict, serving: dict, smi: str) -> dict:
    """``autotune.calibrate_backend`` on the card for phase 3's two scorers
    (not registered: the "cuda" pick does not depend on the constants, so
    the fitted rate and launch overhead are reported, not tuned with); the
    tuned ``block_m`` of the serving and multi-query paths' launch shapes
    (``cases``: path -> (its scorer, one of its tiles)), at which each path
    must have served; then, at each path's own tile, a ragged eighth of it
    and a 100-row tile, ms a tile of ``score_masks`` at the tuned block
    against ``block_m`` = 256 in AUTOTUNE_TURNS turns of (256, tuned,
    tuned, 256), and masks, survivor lists and counts from
    ``score_compact`` identical across the two blocks."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.ops import CascadeScorer

    t_phase = time.perf_counter()
    fitted = {}
    for name, plan in plans:
        sc = CascadeScorer.from_plan(plan, device=dev)
        bc = autotune.calibrate_backend(sc, register=False, repeats=5)
        fitted[name] = dict(bc._asdict(), block_m=sc.block_m, F=sc.n_features,
                            HP=int(sc.w1.shape[1]), P=sc.n_proxies)
    shapes = []
    for path, (scorer, x_tile) in cases.items():
        F, HP, P = scorer.n_features, int(scorer.w1.shape[1]), scorer.n_proxies
        tuned = autotune.choose_block_m(F, HP, P, scorer.dtype, max_tile=scorer.max_tile,
                                        backend="cuda").block_m
        check(scorer.block_m == tuned,
              f"{path}: served at block_m {scorer.block_m}, the tuner picks {tuned}")
        fixed = CascadeScorer([None] * P, scorer.thr_host, packed=scorer.packed, block_m=256,
                              max_tile=scorer.max_tile, device=dev)
        tiles = []
        for n in (len(x_tile), len(x_tile) // 8 + 1, 100):
            x = np.ascontiguousarray(x_tile[:n])
            _, m_a, pk_a, c_a = scorer.score_compact(x)
            _, m_b, pk_b, c_b = fixed.score_compact(x)
            same = (np.array_equal(m_a, m_b) and np.array_equal(c_a, c_b)
                    and all(np.array_equal(a, b) for a, b in zip(pk_a, pk_b)))
            check(same, f"{path}: {n}-row tile scored differently at block_m "
                  f"{scorer.block_m} and 256")
            runs = {"tuned": [], "256": []}
            for _ in range(AUTOTUNE_TURNS):
                for key, sc in (("256", fixed), ("tuned", scorer), ("tuned", scorer),
                                ("256", fixed)):
                    runs[key].append(scorer_tile_ms(sc, x, 200))
            tiles.append(dict(rows=n, tuned_bucket=scorer._bucket(n), fixed_bucket=fixed._bucket(n),
                              tuned_ms=float(np.median(runs["tuned"])),
                              tuned_ms_min=min(runs["tuned"]), tuned_ms_runs=runs["tuned"],
                              block_256_ms=float(np.median(runs["256"])),
                              block_256_ms_min=min(runs["256"]), block_256_ms_runs=runs["256"],
                              identical=same))
        shapes.append(dict(path=path, N=len(x_tile), F=F, HP=HP, P=P, max_tile=scorer.max_tile,
                           tuned_block_m=tuned, buckets=list(scorer.buckets), tiles=tiles))
    out = dict(nvidia_smi=smi, calibrated=fitted, shapes=shapes,
               serving_records_per_s=serving["records_per_s"],
               seconds=time.perf_counter() - t_phase)
    emit("autotune", **out)
    return out


# ------------------------------------------------------------- phases 10a-10c
# The MoE, MLA and VLM serving paths: published widths, bf16, seeded random
# weights, 4 requests of 4,096 processed positions, 32 greedy decode steps;
# depth cut to what one card's time limit allows (qwen3-moe 48 -> 8 layers,
# deepseek-v2-lite 27 -> 4: the dense layer 0 and three MoE layers;
# paligemma keeps all 18).
MOE = dict(arch="qwen3-moe-30b-a3b", layers=8, batch=4, prompt=4096, new_tokens=32)
MLA = dict(arch="deepseek-v2-lite-16b", layers=4, batch=4, prompt=4096, new_tokens=32)
VLM = dict(arch="paligemma-3b", layers=18, batch=4, prompt=4096, new_tokens=32)
ENCDEC = dict(arch="seamless-m4t-medium", layers=12, batch=4, prompt=4096, new_tokens=32)
HYBRID = dict(arch="recurrentgemma-2b", layers=26, batch=4, prompt=4096, new_tokens=32)
# The logits check serves a second time at capacity factor 16: a batched
# forward over prompt + decoded tokens has another token count, so another
# capacity, than the prefill, and would drop other assignments; with no
# drops both compute the same function (tests/test_models_consistency.py:52-56
# lifts the JAX package's own check the same way).
LIFTED_CAPACITY = 16.0
# In bf16 the served run and ``forward`` compute each hidden state in another
# order, and a router's top-k flips wherever two experts' probabilities
# nearly tie (at 128 experts, top-8, many do).  So ``forward`` is given the
# served run's expert choices, position by position, and every choice its
# own router would have made otherwise must be such a near tie: the
# probability of the served expert within a bound (relative) of its own
# k-th.  ROUTER_TIE_TOL, 2^-5, is the bound tests/test_torch_moe.py holds
# the port to the JAX package by at the reduced configs' 4 layers, and
# ``udf_labels_vs_plain`` holds the UDFs' backbones by.  The gap grows with
# depth: on an H100 the widest of qwen3-moe's 6,600-7,200 flips at 8 layers
# is 0.0266-0.0327 over eight weight draws (scripts/moe_router_ties.py).
# So the model paths hold SERVED_ROUTER_TIE_TOL, 2^-4, and every run shows
# that it still catches a router that is wrong: ``forward`` of one request
# with each position's k-th expert swapped for its (k+1)-th
# (``rank_swapped``) must read a wider gap (0.36-0.48 there).
ROUTER_TIE_TOL = 2.0 ** -5
SERVED_ROUTER_TIE_TOL = 2.0 ** -4
VLM_SHAPE = (4, 4096, 4096, 8, 1, 256)  # (B, Sq, Sk, H, K, D) of paligemma's prefill


def pad_cache(cache: dict, new: int) -> dict:
    """Every (L, B, T, ...) cache entry padded by ``new`` slots along T."""
    return {k: v if k == "pos" else torch.nn.functional.pad(v, (0, 0) * (v.dim() - 3)
                                                            + (0, new))
            for k, v in cache.items()}


def pad_family_cache(cfg, cache: dict, new: int) -> dict:
    """A prefill's cache made room for ``new`` decode steps: the self K/V
    (an encoder-decoder's cross K/V stay the memory's length); a hybrid's
    window caches up to min(window, pos + new) slots (a prefill shorter
    than the window holds positions 0..pos-1 in slots 0..pos-1, as the
    ring buffer places them; a full window is already the ring)."""
    if cfg.family == "encdec":
        return {**cache, **pad_cache({k: cache[k] for k in ("k", "v", "pos")}, new)}
    if cfg.family == "hybrid":
        want = min(cfg.attention.window, cache["pos"] + new)

        def grown(c):
            if "k" not in c or c["k"].shape[1] >= want:
                return c
            grow = (0, 0, 0, 0, 0, want - c["k"].shape[1])
            return {k: torch.nn.functional.pad(v, grow) for k, v in c.items()}

        return {"blocks": tuple(grown(c) for c in cache["blocks"]), "pos": cache["pos"]}
    return pad_cache(cache, new)


def serve_batch(fam, model, cfg, batch: dict, new_tokens: int) -> dict:
    """Prefill ``batch`` and decode ``new_tokens`` greedy tokens through the
    family API (the cache padded to hold them).  Returns the logits (B,
    new_tokens + 1, V) for positions prompt-1 ..., the decoded tokens, the
    host-clock seconds and the ``flash_attention`` launches of each half."""
    from repro_torch.kernels.flash_attention import flash_attention

    dev = batch["tokens"].device
    before = flash_attention.launches
    sync(dev)
    t0 = time.perf_counter()
    logits, cache = fam.prefill(model, cfg, batch)
    sync(dev)
    prefill_s = time.perf_counter() - t0
    prefill_launches = flash_attention.launches - before
    cache = pad_family_cache(cfg, cache, new_tokens)
    steps, fed = [logits], []
    t0 = time.perf_counter()
    for _ in range(new_tokens):
        fed.append(steps[-1].argmax(dim=-1))
        lg, cache = fam.decode_step(model, cfg, cache, fed[-1])
        steps.append(lg)
    sync(dev)
    decode_s = time.perf_counter() - t0
    got = torch.stack(steps, dim=1)
    check(bool(torch.isfinite(got).all()), f"{cfg.name}: non-finite serving logits")
    return dict(logits=got, fed=torch.stack(fed, dim=1), prefill_s=prefill_s,
                decode_s=decode_s, prefill_launches=prefill_launches,
                decode_launches=flash_attention.launches - before - prefill_launches)


def pinned_route(real, wanted, counts, tie_tol=None):
    """``moe.route`` that hands each call the next experts of ``wanted``
    (an iterator of (tokens, top_k) index tensors, or a function of the
    call's own (probs, top-k)) in place of its own, weighted by its own
    probabilities.  Adds to ``counts.flips`` the positions whose own top-k
    set differs and keeps in ``counts.max_gap`` the largest relative
    probability gap among them, which must be at most ``tie_tol`` where it
    is given."""
    def pinned(p, cfg, xt):
        probs, _, own = real(p, cfg, xt)
        want = wanted(probs, own) if callable(wanted) else next(wanted)
        differ = (own.sort(1).values != want.sort(1).values).any(1)
        if bool(differ.any()):
            kth = probs.gather(1, own)[differ, -1]
            worst = probs.gather(1, want)[differ].min(1).values
            gap = float(((kth - worst) / kth).max())
            check(tie_tol is None or gap <= tie_tol,
                  f"an expert choice differs by {gap}: not a tie")
            counts.max_gap = max(counts.max_gap, gap)
            counts.flips += int(differ.sum())
        top_p = probs.gather(1, want)
        return probs, top_p / top_p.sum(dim=-1, keepdim=True), want
    return pinned


def rank_swapped(probs, own):
    """The planted routing fault: each position's k-th expert swapped for
    its (k+1)-th, the least a top-k can get wrong."""
    k = own.shape[1]
    ranked = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    return torch.cat([ranked[:, :k - 1], ranked[:, k:k + 1]], dim=1)


class RouteLog:
    """Records the experts ``moe.route`` picks, call by call (``record``),
    then pins ``forward`` to a served run's picks for one request (``pin``)
    or every later call to the recorded calls' picks in order (``replay``),
    through ``pinned_route``."""

    def __init__(self):
        from repro_torch.models import moe as moe_module

        self.moe, self.real = moe_module, moe_module.route
        self.calls, self.flips, self.max_gap = [], 0, 0.0

    def record(self):
        def recorded(p, cfg, xt):
            out = self.real(p, cfg, xt)
            self.calls.append(out[2])
            return out
        return mock.patch.object(self.moe, "route", recorded)

    def pin(self, r: int, batch: int, n_layers: int):
        """The served picks of request ``r``: call i of ``forward`` (MoE
        layer i) gets the prefill's rows of r, then each decode step's."""
        calls = self.calls

        def wanted():
            for layer in range(n_layers):
                steps = calls[n_layers + layer::n_layers]
                first = calls[layer]
                yield torch.cat([first.view(batch, -1, first.shape[-1])[r]]
                                + [s[r:r + 1] for s in steps])
        return mock.patch.object(self.moe, "route", pinned_route(self.real, wanted(), self))

    def replay(self):
        """Each call gets the recorded calls' experts in order; every own
        choice that differs must be a near tie (ROUTER_TIE_TOL)."""
        return mock.patch.object(self.moe, "route", pinned_route(
            self.real, iter(self.calls), self, ROUTER_TIE_TOL))


def served_vs_forward(fam, model, cfg, batch: dict, served: dict, routes=None,
                      gate: bool = True) -> dict:
    """The served logits against ``forward`` with the kernel's plain version
    in its place, one request at a time over prompt + decoded tokens: the
    prefill row within PREFILL_TOL, the decode rows within DECODE_TOL
    (allclose), or (with ``gate``) the run fails.  With ``routes`` (a
    ``RouteLog`` of the served run) ``forward`` takes the served expert
    choices, and each of its own that differs must be a near tie
    (SERVED_ROUTER_TIE_TOL), and a planted routing fault must not be."""
    from contextlib import nullcontext

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.models import layers as model_layers

    got, fed = served["logits"], served["fed"]
    n_text = batch["tokens"].shape[1]
    before = flash_attention.launches
    prefill_err = decode_err = 0.0
    ok = True
    n_moe = len(getattr(model, "layers", ())) if routes is not None else 0
    with mock.patch.object(model_layers, "flash_attention", flash_attention_plain):
        for r in range(got.shape[0]):
            one = {k: v[r:r + 1] for k, v in batch.items()}
            one["tokens"] = torch.cat([one["tokens"], fed[r:r + 1]], dim=1)
            with routes.pin(r, got.shape[0], n_moe) if routes is not None else nullcontext():
                ref = fam.forward(model, cfg, one)[0, n_text - 1:]
            check(bool(torch.isfinite(ref).all()), f"request {r}: non-finite reference")
            prefill_err = max(prefill_err, float((got[r, 0] - ref[0]).abs().max()))
            decode_err = max(decode_err, float((got[r, 1:] - ref[1:]).abs().max()))
            ok &= bool(torch.allclose(got[r, 0], ref[0], rtol=PREFILL_TOL, atol=PREFILL_TOL)
                       and torch.allclose(got[r, 1:], ref[1:], rtol=DECODE_TOL,
                                          atol=DECODE_TOL))
            check(ok or not gate, f"{cfg.name}, {cfg.num_layers} layers, request {r}: logits "
                  f"differ from forward by {prefill_err} (prefill) / {decode_err} (decode)")
            del ref
    check(flash_attention.launches == before, "the reference launched the kernel")
    out = dict(layers=cfg.num_layers, prefill_max_abs_err=prefill_err,
               prefill_tol=PREFILL_TOL, decode_max_abs_err=decode_err, decode_tol=DECODE_TOL,
               within_tol=ok, gated=gate)
    if routes is not None:
        check(routes.max_gap <= SERVED_ROUTER_TIE_TOL, f"{cfg.name}: forward's own top-k "
              f"differs from the served one by {routes.max_gap} of a probability: not a tie")
        planted = types.SimpleNamespace(flips=0, max_gap=0.0)
        one = {k: v[:1] for k, v in batch.items()}
        one["tokens"] = torch.cat([one["tokens"], fed[:1]], dim=1)
        with mock.patch.object(model_layers, "flash_attention", flash_attention_plain), \
                mock.patch.object(routes.moe, "route",
                                  pinned_route(routes.real, rank_swapped, planted)):
            fam.forward(model, cfg, one)
        check(planted.max_gap > SERVED_ROUTER_TIE_TOL, f"{cfg.name}: the planted routing "
              f"fault (each k-th expert swapped for the next) reads {planted.max_gap}, within "
              f"the tie bound")
        out.update(forward_routing_flips=routes.flips, forward_flip_max_gap=routes.max_gap,
                   router_tie_tol=SERVED_ROUTER_TIE_TOL,
                   planted_rank_swap_flips=planted.flips,
                   planted_rank_swap_max_gap=planted.max_gap)
    return out


def attention_errors(seen: list, batch: int) -> tuple:
    """Each recorded prefill call's kernel output against the plain version
    on the same inputs, one request at a time (FLASH_TOL, FLASH_ROW_TOL).
    Returns (max abs error, max row error)."""
    from repro_torch.kernels.flash_attention import flash_attention_plain

    errs = [check_flash_output(f"layer {layer}, request {r}", o[r:r + 1],
                               flash_attention_plain(q[r:r + 1], k[r:r + 1], v[r:r + 1],
                                                     causal=True))
            for layer, (q, k, v, o) in enumerate(seen) for r in range(batch)]
    return max(e for e, _ in errs), max(r for _, r in errs)


def profile_split(fn, dev) -> dict:
    """``device_profile`` of ``fn`` with its device time split by kernel
    name into the flash kernel, its backward kernels, the ``ssd_chunk``
    kernels and its backward's, GEMMs, dispatch (sort, search, index,
    gather, scatter) and elementwise or reduction kernels; the expert
    GEMMs are the device time of ``aten::bmm`` (only the experts use it)."""
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    split = dict(flash=0.0, flash_bwd=0.0, ssd=0.0, ssd_bwd=0.0, gemm=0.0, dispatch=0.0,
                 elementwise=0.0, other=0.0)
    others: dict = {}
    dispatch_words = ("sort", "Sort", "search", "index", "gather", "scatter", "bincount")
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name, us = e.name, e.time_range.elapsed_us()
        if "flash_attention" in name:
            split["flash"] += us
        elif any(w in name for w in ("bwd_prep", "bwd_dkdv", "bwd_dq", "dkdv_wgmma", "dq_wgmma",
                                     "dkdv_split", "dq_split")):
            split["flash_bwd"] += us
        elif "ssd_chunk" in name:
            split["ssd"] += us
        elif any(w in name for w in ("bwd_scores", "bwd_head", "bwd_dssum", "bwd_dc<",
                                     "bwd_db<", "bwd_dx<", "bwd_group<")):
            split["ssd_bwd"] += us
        elif any(w in name for w in ("gemm", "Gemm", "nvjet", "cutlass", "xmma", "sm90_")):
            split["gemm"] += us
        elif any(w in name for w in dispatch_words):
            split["dispatch"] += us
        elif any(w in name for w in ("elementwise", "vectorized", "reduce", "Reduce", "softmax",
                                     "unrolled", "CatArray", "fill")):
            split["elementwise"] += us
        else:
            split["other"] += us
            others[name] = others.get(name, 0.0) + us
    bmm = [e for e in prof.key_averages() if e.key == "aten::bmm"]
    expert_us = sum(getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0.0) for e in bmm)
    busy = sum(split.values())
    return dict(wall_us=wall_us, device_busy_us=busy,
                device_busy_share=busy / wall_us if wall_us else None,
                split_us=split, expert_gemm_us=expert_us,
                other_top={k[:60]: v for k, v in sorted(others.items(), key=lambda kv: -kv[1])[:5]},
                split_share={k: v / busy for k, v in split.items()} if busy else None)


@contextlib.contextmanager
def first_layers(model, cfg, n: int):
    """``model`` cut to its first ``n`` layers (an encoder-decoder's
    encoder too; a hybrid's first n blocks, whose kinds are the cut
    config's) for the ``with`` body, which gets the cut config."""
    from repro_torch.launch.train import with_depth

    stacks = [name for name in ("layers", "enc_layers", "dec_layers", "blocks")
              if hasattr(model, name)]
    full = {name: getattr(model, name) for name in stacks}
    try:
        for name in stacks:
            setattr(model, name, torch.nn.ModuleList(full[name][:n]))
        yield with_depth(cfg, n)
    finally:
        for name in stacks:
            setattr(model, name, full[name])


def run_model_path(dev, spec: dict, phase: str) -> dict:
    """One family's serving path at ``spec`` (module constants MOE, MLA,
    VLM, ENCDEC, HYBRID).  The counted run: ``flash_attention`` launches
    zeroed, a prefill of ``batch`` requests (an encoder-decoder's with its
    frames) and ``new_tokens`` greedy decode steps; the prefill must launch
    the kernel once a ``flash_layers`` layer through ``layers.mha`` (GQA:
    qwen3, paligemma; seamless's decoder self-attention) and never
    otherwise (MLA; the hybrid's local attention), decode never.  Then: each layer's kernel
    output against the plain version on the prefill's own inputs; MoE: the
    assignments dropped at capacity in each layer, the same prompts served
    again to identical decoded tokens, and a profile of one prefill; MLA:
    the absorbed decode of every layer's first step against naive
    attention over the same latent cache; the logits against ``forward``
    with the plain attention (MoE families at capacity factor 16 with the
    served expert choices; deeper than SSM_LOGIT_LAYERS, the other
    families' are held at full depth in f32 and on their first
    SSM_LOGIT_LAYERS in bf16 (``first_layers``), and
    reported at full depth in bf16 beside a witness: the same serving with
    the kernel's plain version in its place)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash_module
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import layers as model_layers
    from repro_torch.models import mla as mla_module
    from repro_torch.models import moe as moe_module
    from repro_torch.models.registry import get_family, make_batch

    t_phase = time.perf_counter()
    cfg = get_config(spec["arch"]).replace(num_layers=spec["layers"])
    fam = get_family(cfg)
    is_moe, is_mla = cfg.moe is not None, cfg.attention.kind == "mla"
    t0 = time.perf_counter()
    drawn = {}
    with counted_draws(dev, f"{phase} init", drawn):
        model = fam.init(0, cfg, device=dev)
        batch = make_batch(cfg, spec["batch"], spec["prompt"], key=0, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)  # from the weights and the batch on
    n_params = sum(p.numel() for p in model.parameters())
    B, new_tokens = spec["batch"], spec["new_tokens"]
    # layers.mha sends full causal attention to the kernel on the card (none
    # on the CPU)
    want_launches = flash_layers(cfg) if dev.type == "cuda" else 0

    seen, drops, absorbed = [], [], []

    def kept(q, k, v, *, causal=True):
        out = flash_attention(q, k, v, causal=causal)
        seen.append((q, k, v, out))
        return out

    real_dispatch, real_decode = moe_module.dispatch, mla_module.mla_decode

    def counted(top_e, cfg_, n_tokens):
        C, sort_idx, dest = real_dispatch(top_e, cfg_, n_tokens)
        drops.append((dest == cfg_.moe.num_experts * C).sum())
        return C, sort_idx, dest

    def recorded(p, cfg_, x, ckv, krope, pos):
        out = real_decode(p, cfg_, x, ckv, krope, pos)
        if len(absorbed) < cfg.num_layers:  # the first decode step's layers
            absorbed.append((p, x, ckv, krope, pos, out[0]))
        return out

    flash_module.reset_launches()
    with mock.patch.object(model_layers, "flash_attention", kept), \
            mock.patch.object(moe_module, "dispatch", counted), \
            mock.patch.object(mla_module, "mla_decode", recorded):
        served = serve_batch(fam, model, cfg, batch, new_tokens)
    launches = flash_attention.launches
    route_launches = dict(flash_attention.route_launches)
    check(served["prefill_launches"] == want_launches,
          f"{phase}: prefill launched flash_attention {served['prefill_launches']} times, "
          f"not {want_launches}")
    check(served["decode_launches"] == 0,
          f"{phase}: decode launched flash_attention {served['decode_launches']} times")
    if dev.type == "cuda" and launches:
        check(route_launches["tensor_cores"] == launches, f"not every launch took the "
              f"tensor cores: {route_launches}")
    out = dict(arch=cfg.name, source=cfg.source, layers=cfg.num_layers,
               published_layers=get_config(spec["arch"]).num_layers, d_model=cfg.d_model,
               heads=cfg.attention.num_heads, kv_heads=cfg.attention.num_kv_heads,
               head_dim=cfg.attention.head_dim, vocab=cfg.vocab_size, dtype=cfg.dtype,
               params=n_params, requests=B, positions=spec["prompt"],
               prompt_tokens=batch["tokens"].shape[1], new_tokens=new_tokens,
               launches=launches, prefill_launches=served["prefill_launches"],
               route_launches=route_launches, init_s=init_s,
               threefry_launches=drawn["threefry_launches"], prefill_s=served["prefill_s"],
               prefill_tokens_per_s=B * spec["prompt"] / served["prefill_s"],
               decode_s=served["decode_s"],
               decode_ms_per_step=served["decode_s"] / new_tokens * 1e3,
               decode_tokens_per_s=B * new_tokens / served["decode_s"])
    sync(dev)
    t0 = time.perf_counter()
    fam.prefill(model, cfg, batch)  # a warm prefill: the counted one paid first-use costs
    sync(dev)
    out["warm_prefill_tokens_per_s"] = B * spec["prompt"] / (time.perf_counter() - t0)
    if seen:
        check(len(seen) == want_launches, f"{len(seen)} prefill calls reached the wrapper")
        out["attention_max_abs_err"], out["attention_max_row_err"] = attention_errors(seen, B)
        seen.clear()
    if is_moe:
        m = cfg.moe
        out.update(experts=m.num_experts, top_k=m.top_k, expert_ff=m.expert_ff,
                   capacity_factor=m.capacity_factor,
                   prefill_capacity=moe_module.moe_capacity(cfg, B * spec["prompt"]),
                   dropped_by_layer=[int(d) for d in drops[:len(model.layers)]],
                   assignments_per_layer=B * spec["prompt"] * m.top_k)
        check(all(int(d) == 0 for d in drops[len(model.layers):]), "decode dropped assignments")
    drops.clear()
    if absorbed:
        errs = []
        for p, x, ckv, krope, pos, got in absorbed:
            naive = mla_naive_decode(p, cfg, x, ckv[:, :pos + 1], krope[:, :pos + 1], pos)
            errs.append(float((got - naive).abs().max()))
            check(torch.allclose(got, naive, rtol=DECODE_TOL, atol=DECODE_TOL),
                  f"{phase}: absorbed decode differs from naive attention by {errs[-1]}")
        out["absorbed_vs_naive_max_abs_err"], out["absorbed_tol"] = max(errs), DECODE_TOL
        absorbed.clear()
    if is_moe and not is_mla:
        again = serve_batch(fam, model, cfg, batch, new_tokens)
        check(torch.equal(again["fed"], served["fed"]),
              f"{phase}: the same prompts decoded other tokens")
        out["repeat_identical_tokens"] = True
        out["warm_decode_ms_per_step"] = again["decode_s"] / new_tokens * 1e3
        out["repeat_identical_logits"] = bool(torch.equal(again["logits"], served["logits"]))
        del again
        if dev.type == "cuda":
            out["prefill_profile"] = profile_split(lambda: fam.prefill(model, cfg, batch), dev)
    routes = None
    if is_moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=LIFTED_CAPACITY))
        routes = RouteLog()
        with routes.record():
            served = serve_batch(fam, model, cfg, batch, new_tokens)
        out["logits_capacity_factor"] = LIFTED_CAPACITY
    deep = cfg.num_layers > SSM_LOGIT_LAYERS and not is_moe
    out["logits"] = served_vs_forward(fam, model, cfg, batch, served, routes, gate=not deep)
    if deep:
        # the witness at full depth: the same serving with the kernel's plain
        # version in its place, against the same forward.  Every layer's
        # kernel output is inside the flash limits (above); what the kernel's
        # run adds to this gap is its rounding compounded over the layers
        from repro_torch.kernels.flash_attention import flash_attention_plain

        with mock.patch.object(model_layers, "flash_attention", flash_attention_plain):
            plain = serve_batch(fam, model, cfg, batch, new_tokens)
        check(plain["prefill_launches"] == 0, "the plain serving launched the kernel")
        out["logits_plain_attention"] = served_vs_forward(fam, model, cfg, batch, plain,
                                                          gate=False)
        out["logits_kernel_vs_plain_serving"] = dict(
            prefill_max_abs_err=float((served["logits"][:, 0] - plain["logits"][:, 0])
                                      .abs().max()),
            decode_max_abs_err=float((served["logits"][:, 1:] - plain["logits"][:, 1:])
                                     .abs().max()),
            same_tokens=bool(torch.equal(served["fed"], plain["fed"])))
        del plain
        # held at full depth in f32, as ssm_path holds its 64 layers: the
        # prefill launches the kernel once a layer on its f32 route
        model32, cfg32 = copy.deepcopy(model).float(), cfg.replace(dtype="float32")
        route32 = flash_module.route_for(cfg.attention.head_dim, torch.float32)
        flash_module.reset_launches()
        served32 = serve_batch(fam, model32, cfg32, batch, new_tokens)
        check(served32["prefill_launches"] == want_launches and served32["decode_launches"] == 0,
              f"{phase}: the f32 run launched the kernel {served32['prefill_launches']} / "
              f"{served32['decode_launches']} times (prefill / decode)")
        check(route32 == "tensor_cores"
              and flash_attention.route_launches[route32] == want_launches,
              f"{phase}: the f32 prefill's routes {dict(flash_attention.route_launches)}")
        check(flash_module.split_bf16.launches == 2 * want_launches,
              f"{phase}: {flash_module.split_bf16.launches} split_bf16 launches in the f32 "
              f"prefill, not {2 * want_launches} (K and V a layer)")
        out["float32_route_launches"] = dict(flash_attention.route_launches)
        out["float32_split_bf16_launches"] = flash_module.split_bf16.launches
        out["logits_float32"] = served_vs_forward(fam, model32, cfg32, batch, served32)
        del model32, served32
        # gated at the depth the JAX package's bf16 bounds are set for, on
        # the model's first layers (reported above at full depth)
        with first_layers(model, cfg, SSM_LOGIT_LAYERS) as shallow:
            out["logits_gated"] = served_vs_forward(
                fam, model, shallow, batch, serve_batch(fam, model, shallow, batch, new_tokens))
    out["logits_max_abs"] = float(served["logits"].abs().max())
    out["peak_memory_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                              if dev.type == "cuda" else None)
    out["seconds"] = time.perf_counter() - t_phase
    emit(phase, **out)
    return out


def mla_naive_decode(p, cfg, x, ckv, krope, pos: int):
    """Naive MLA attention of the one token ``x`` at ``pos`` over the latent
    cache ``ckv`` / ``krope`` (positions 0 .. pos): per-head K and V
    materialized from the latent, then ``layers.mha``."""
    from repro_torch.models import layers as model_layers
    from repro_torch.models import mla as mla_module

    a = cfg.attention
    B, T = ckv.shape[:2]
    H, nope, vh = a.num_heads, a.qk_nope_head_dim, a.v_head_dim
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, _, _ = mla_module._project_common(p, cfg, x, positions)
    kv = (ckv @ p.wkv_b).reshape(B, T, H, nope + vh)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([kv[..., :nope], krope[:, :, None, :].expand(B, T, H, a.qk_rope_head_dim)],
                  dim=-1)
    kv_pos = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(B, T)
    out = model_layers.mha(q, k, kv[..., nope:], causal=True, q_positions=positions,
                           kv_positions=kv_pos)
    return out.reshape(B, 1, H * vh) @ p.wo


# ------------------------------------------------------------- phase 10d
# The backward kernel against its plain version: within 2^-6 (bf16) and 1e-4
# (f32) of each gradient's largest value.  Both sum in f32 in different
# orders; in bf16 each gradient then rounds once to bf16 (an ulp is 2^-8 of
# the value), and the rows of a KV tile that a faulty kernel skipped differ
# by their whole size.
BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
# The forward's row log-sum-exp (which the backward reads) against the plain
# version's: both are f32 sums of the same scores in different orders, of
# values near log(Sk) (4 to 9 here), where an f32 step is 5e-7.
LSE_TOL = 1e-5
BWD_CASES = tuple(  # (B, Sq, Sk, H, K, D, causal, dtype): the JAX package's test shapes,
    (*shape, causal, dtype)  # D 256, ragged lengths, a GQA group of 7 and D 16
    for dtype in ("bfloat16", "float32") for causal in (True, False)
    for shape in ((1, 128, 128, 4, 4, 32), (2, 256, 256, 8, 2, 64), (1, 128, 384, 4, 1, 128),
                  (2, 64, 64, 2, 1, 256), (1, 100, 100, 14, 2, 64), (1, 77, 131, 8, 1, 16))
) + ((16400, 8, 8, 4, 2, 16, True, "float32"),) + tuple(  # batch x heads past 65,535
    # on the tensor cores (in bf16 that shape takes the packed route); then the
    # packed route (Sq 1 full only: a causal row over one key has dq = dk = 0
    # exactly, and the relative limit would hold rounding noise)
    (*shape, causal, "bfloat16") for shape in PACKED_SHAPES for causal in (True, False)
    if shape[1] > 1 or not causal)
BWD_SERVING_SHAPE = (1, 4096, 4096, 64, 8, 128)  # deepseek-67b's micro-batch, one per launch
BWD_REDUCED_SHAPE = (2, 256, 256, 4, 2, 16)  # the restart check's micro-batch (RESTART below)
BWD_FAULT_KEYS = (2048, 2112)  # a KV tile in the middle of the serving shape
BWD_FLOPS_FACTOR = 2.5  # FlashAttention-2's count: the backward is 2.5 forwards
BWD_PROFILE_CALLS = 5  # calls under the profiler for each kernel's device time


def fragment_name(kernel: str) -> str:
    """A kernel's name as the profiler prints it, without namespace and
    template arguments: ``tc::dkdv_wgmma<128>`` -> ``dkdv_wgmma<``."""
    return kernel.split("::")[-1].split("<")[0] + "<"


def bwd_errors(got, want) -> list:
    """Each of (dq, dk, dv): the largest difference over the largest
    |plain| value."""
    return [float((a.float() - b.float()).abs().max()
                  / b.float().abs().max().clamp_min(torch.finfo(torch.float32).tiny))
            for a, b in zip(got, want)]


def check_bwd_output(what: str, got, want) -> list:
    """(dq, dk, dv) of the kernel within BWD_TOL of the plain version's;
    returns their errors."""
    dtype = str(want[0].dtype).removeprefix("torch.")
    for a, b in zip(got, want):
        check(a.shape == b.shape and a.dtype == b.dtype, f"{what}: bad gradient")
        check(bool(torch.isfinite(a).all()), f"{what}: non-finite gradient")
    errs = bwd_errors(got, want)
    check(max(errs) <= BWD_TOL[dtype], f"{what}: (dq, dk, dv) differ from the plain version by "
          f"{errs} of their largest values (tol {BWD_TOL[dtype]})")
    return errs


def make_bwd_case(case, dev, seed):
    """q, k, v of ``make_flash_case`` and an output gradient dO, standard
    normals in the case's type."""
    B, Sq, _Sk, H, _K, D, _causal, dtype = case
    q, k, v = make_flash_case(case, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1000)
    dout = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(getattr(torch, dtype))
    return q, k, v, dout


def check_lse(what: str, lse, ref) -> float:
    """A forward's row log-sum-exp within LSE_TOL of the plain version's;
    returns the largest difference."""
    check(lse.shape == ref.shape and lse.dtype == torch.float32, f"{what}: bad lse")
    check(bool(torch.isfinite(lse).all()), f"{what}: non-finite lse")
    err = float((lse - ref).abs().max())
    check(err <= LSE_TOL, f"{what}: the forward's lse differs from the plain one by {err} "
          f"(tol {LSE_TOL})")
    return err


def check_bwd_case(case, dev, seed=0) -> dict:
    """The backward kernel against its plain version on the card, on the
    forward kernel's output and lse: the gradients' errors, the route the
    backward took (it must be ``backward_route``'s), and the forward's lse
    against the plain one (its output must not change when it writes the
    lse)."""
    from repro_torch.kernels import flash_attention as fm

    causal, dtype = case[6], getattr(torch, case[7])
    q, k, v, dout = make_bwd_case(case, dev, seed)
    out, lse = fm.flash_attention(q, k, v, causal=causal, return_lse=True)
    check(torch.equal(out, fm.flash_attention(q, k, v, causal=causal)),
          f"{case}: the forward's output changes when it writes the lse")
    _, ref_lse = fm.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    before = dict(fm.flash_attention.backward_route_launches)
    got = fm.flash_attention_backward(q, k, v, out, dout, lse, causal=causal)
    want = fm.flash_attention_backward_plain(q, k, v, out, dout, causal=causal)
    sync(dev)
    path = [r for r, n in fm.flash_attention.backward_route_launches.items() if n > before[r]]
    want_path = fm.backward_route(case[5], dtype, route_shape(case))
    check(path == [want_path] or dev.type == "cpu",
          f"{case}: the backward launched on {path}, not {want_path}")
    return dict(errs=check_bwd_output(str(case), got, want), route=want_path,
                lse_err=check_lse(str(case), lse, ref_lse))


def bwd_planted_fault(dev, dtype: str, shape=BWD_SERVING_SHAPE) -> dict:
    """The check at ``shape`` (the serving shape, or paligemma's) against
    the kernel's gradients with one KV tile's rows of dk and dv zeroed,
    which is what a dK/dV kernel that skipped that tile's block would
    return (and a dQ kernel that skipped the tile misses the same terms in
    dq): the check must reject it."""
    from repro_torch.kernels.flash_attention import (backward_route, flash_attention,
                                                     flash_attention_backward,
                                                     flash_attention_backward_plain)

    case = (*shape, True, dtype)
    q, k, v, dout = make_bwd_case(case, dev, seed=3)
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    dq, dk, dv = flash_attention_backward(q, k, v, out, dout, lse, causal=True)
    want = flash_attention_backward_plain(q, k, v, out, dout, causal=True)
    errs = check_bwd_output(f"{case}, before the fault", (dq, dk, dv), want)
    dk[:, BWD_FAULT_KEYS[0]:BWD_FAULT_KEYS[1]] = 0
    dv[:, BWD_FAULT_KEYS[0]:BWD_FAULT_KEYS[1]] = 0
    bad = bwd_errors((dq, dk, dv), want)
    caught = max(bad) > BWD_TOL[dtype]
    check(caught, f"{dtype} at {shape}: a skipped KV tile passes the backward check ({bad})")
    return dict(dtype=dtype, shape=list(shape),
                route=backward_route(shape[5], q.dtype, route_shape(shape)),
                keys=list(BWD_FAULT_KEYS), clean_errors=errs, faulty_errors=bad, caught=caught)


def bwd_repeat(dev, shape=BWD_SERVING_SHAPE, dtype: str = "bfloat16") -> dict:
    """Two backward calls on the same inputs at ``shape`` (causal): dq, dk
    and dv must be equal bit for bit (no atomics; a restart that replays a
    step depends on it)."""
    from repro_torch.kernels.flash_attention import (backward_route, flash_attention,
                                                     flash_attention_backward)

    q, k, v, dout = make_bwd_case((*shape, True, dtype), dev, seed=11)
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    a = flash_attention_backward(q, k, v, out, dout, lse, causal=True)
    b = flash_attention_backward(q, k, v, out, dout, lse, causal=True)
    sync(dev)
    equal = [torch.equal(x, y) for x, y in zip(a, b)]
    check(all(equal), f"two backward calls at {shape} differ in (dq, dk, dv): {equal}")
    return dict(shape=list(shape), dtype=dtype,
                route=backward_route(shape[5], q.dtype, route_shape(shape)), bitwise_equal=equal)


def bwd_bound(B, Sq, Sk, H, K, D, causal, dtype="bfloat16", route="cuda_cores") -> tuple:
    """(ms, bound_by, bytes, flops): the larger of two times.  Bytes: each
    input (q, k, v, o, dO and the f32 row lse) read once and each gradient
    (dq, dk, dv) written once over HBM.  Operations: BWD_FLOPS_FACTOR
    forwards' products (the causal pairs only) at the peak for the type
    (bf16 tensor cores; f32 CUDA cores, no TF32).  The f32 tensor-core
    (split) route's own bound counts its six bf16 products of pieces at the
    bf16 peak, plus the pre-pass over q, k, v and dO (f32 read once, three
    bf16 pieces written) over HBM."""
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * 4 * (B * Sq * H * D + B * Sk * K * D) + 4 * B * H * Sq
    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    flops = BWD_FLOPS_FACTOR * 4 * B * H * D * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_pre = 0.0
    if dtype == "float32" and route == "tensor_cores":
        t_ops = SPLIT_PRODUCTS["flash_attention"] * flops / BF16_FLOPS
        t_pre = 2 * (B * Sq * H * D + B * Sk * K * D) * (4 + 3 * 2) / HBM_BYTES_PER_S
    else:
        t_ops = flops / (BF16_FLOPS if dtype == "bfloat16" else FP32_FLOPS)
    return ((max(t_bytes, t_ops) + t_pre) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def time_flash_bwd(dev, dtype: str, shape, iters: int) -> dict:
    """The backward kernel, its plain version and ``torch.autograd.grad``
    through ``scaled_dot_product_attention`` (K and V repeated to every
    query head inside the graph, so its gradient sums over the group as the
    kernel's does) at ``shape``, causal, in turns (plain, kernel, library,
    kernel, plain), beside the bound; the route and its three kernels'
    registers, spills and shared memory, and each kernel's device time from
    a profile of BWD_PROFILE_CALLS more calls (on the split route also the
    ``split_bf16`` pre-pass's, and the CUDA-core bound beside the route's)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fm
    from repro_torch.kernels.flash_attention import (backward_kernels, backward_resources,
                                                     backward_route, flash_attention,
                                                     flash_attention_backward,
                                                     flash_attention_backward_plain)

    B, Sq, Sk, H, K, D = shape
    case = (*shape, True, dtype)
    q, k, v, dout = make_bwd_case(case, dev, seed=7)
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        ql.transpose(1, 2), kl.transpose(1, 2).repeat_interleave(H // K, dim=1),
        vl.transpose(1, 2).repeat_interleave(H // K, dim=1), is_causal=True).transpose(1, 2)

    def library():
        return torch.autograd.grad(lib_out, (ql, kl, vl), dout, retain_graph=True)

    def kernel():
        return flash_attention_backward(q, k, v, out, dout, lse, causal=True)

    def plain():
        return flash_attention_backward_plain(q, k, v, out, dout, causal=True)

    lib_err = max(bwd_errors(library(), kernel()))
    err = max(check_bwd_output(f"{case}, timed", kernel(), plain()))
    plain_a = cuda_ms(plain, dev, 1, warmup=1)
    kern_a = cuda_ms(kernel, dev, iters, warmup=1)
    lib_ms = cuda_ms(library, dev, 2 * iters, warmup=2)
    kern_b = cuda_ms(kernel, dev, iters, warmup=0)
    plain_b = cuda_ms(plain, dev, 1, warmup=0)
    del lib_out
    path = backward_route(D, q.dtype, route_shape(shape))
    bound_ms, bound_by, nbytes, flops = bwd_bound(*case, route=path)
    ms = min(kern_a, kern_b)
    log = _build.library_path("flash_attention_bwd").with_suffix(".log").read_text()
    kernels = backward_kernels(D, q.dtype, route_shape(shape))
    split_before = fm.split_bf16.launches
    prof = device_profile(lambda: [kernel() for _ in range(BWD_PROFILE_CALLS)], dev)
    per_kernel = {}  # us a launch over the launches the profiler kept (it may drop some)
    names = {role: fragment_name(name) for role, (name, _) in kernels.items()}
    if fm.split_bf16.launches > split_before:  # the split route's pre-pass
        names["split_bf16"] = "split_bf16_segments"
    for role, frag in names.items():
        hits = [t for t in prof["top"] if frag in t["name"]]
        n = sum(t["count"] for t in hits)
        per_kernel[role] = sum(t["us"] for t in hits) / n if n else "not measured"
    row = dict(shape=list(shape), causal=True, dtype=dtype, route=path, max_err=err, ms=ms,
               ms_runs=[kern_a, kern_b],
               plain_ms=min(plain_a, plain_b), plain_ms_runs=[plain_a, plain_b],
               library_ms=lib_ms,
               library="torch.autograd.grad through scaled_dot_product_attention "
                       "(K, V repeated to H heads in the graph)",
               library_max_rel_diff=lib_err, bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, flops=flops, tflops_per_s=flops / (ms * 1e-3) / 1e12,
               share_of_bound=bound_ms / ms,
               ptxas={role: dict(kernel=name, **ptxas_entry(log, fragment))
                      for role, (name, fragment) in kernels.items()},
               resources=backward_resources(D, q.dtype, route_shape(shape)),
               kernel_us=per_kernel,
               split_bf16_launches_a_call=(fm.split_bf16.launches - split_before)
               // BWD_PROFILE_CALLS,
               profile=prof)
    if dtype == "float32":
        row["cuda_core_bound_ms"] = bwd_bound(*case)[0]
        row["share_of_cuda_core_bound"] = row["cuda_core_bound_ms"] / ms
    emit("flash_bwd_timing", **row)
    return row


def run_flash_bwd_kernels(dev) -> dict:
    """Phase 10d: every BWD_CASES case (each on its ``backward_route``, the
    forward's lse held too), the planted faults (and one at paligemma's
    shape in f32: the split route at D 256), two calls bit for bit at the
    serving shape in both types and at paligemma's in f32, and the
    kernel's time at deepseek-67b's and paligemma's training shapes in bf16
    (and both in f32), and at the restart check's reduced shape in both
    types."""
    from repro_torch.kernels import flash_attention as fm

    t0 = time.perf_counter()
    fm.reset_launches()
    res = [check_bwd_case(case, dev, seed=i) for i, case in enumerate(BWD_CASES)]
    routes = dict(fm.flash_attention.backward_route_launches)
    errs = [r["errs"] for r in res]
    faults = [bwd_planted_fault(dev, dt) for dt in ("bfloat16", "float32")]
    torch.cuda.empty_cache()
    faults.append(bwd_planted_fault(dev, "float32", VLM_SHAPE))  # the split route at D 256
    torch.cuda.empty_cache()
    repeat = [bwd_repeat(dev, dtype=dt) for dt in ("bfloat16", "float32")]
    repeat.append(bwd_repeat(dev, shape=VLM_SHAPE, dtype="float32"))
    repeat.append(bwd_repeat(dev, shape=PACKED_REPEAT_SHAPE))
    emit("flash_bwd_kernels", cases=len(BWD_CASES), seconds=time.perf_counter() - t0,
         max_err={dt: max(max(e) for c, e in zip(BWD_CASES, errs) if c[7] == dt)
                  for dt in BWD_TOL}, tol=BWD_TOL,
         max_lse_err=max(r["lse_err"] for r in res), lse_tol=LSE_TOL,
         launches_by_route=routes,
         cases_by_route={dt: {rt: sum(c[7] == dt and r["route"] == rt
                                      for c, r in zip(BWD_CASES, res)) for rt in fm.ROUTES}
                         for dt in BWD_TOL},
         planted_faults=faults, repeat=repeat,
         shapes=[list(c) + [r["route"], r["errs"], r["lse_err"]]
                 for c, r in zip(BWD_CASES, res)])
    torch.cuda.empty_cache()
    rows = {"bfloat16": time_flash_bwd(dev, "bfloat16", BWD_SERVING_SHAPE, iters=3),
            "float32": time_flash_bwd(dev, "float32", BWD_SERVING_SHAPE, iters=3)}
    torch.cuda.empty_cache()
    rows["D256"] = time_flash_bwd(dev, "bfloat16", VLM_SHAPE, iters=3)
    torch.cuda.empty_cache()
    rows["float32_D256"] = time_flash_bwd(dev, "float32", VLM_SHAPE, iters=2)
    torch.cuda.empty_cache()
    for dt in ("bfloat16", "float32"):
        rows[f"reduced_{dt}"] = time_flash_bwd(dev, dt, BWD_REDUCED_SHAPE, iters=20)
    return {"max_err": max(max(e) for e in errs), "rows": rows,
            "max_err_float32_D256": [max(e) for c, e in zip(BWD_CASES, errs)
                                     if c[7] == "float32" and c[5] == 256]}


# ------------------------------------------------------------- phase 10e
# deepseek-67b at its published widths; depth 95 -> 3.  At 16 bytes a
# parameter (bf16 weights and micro-batch gradient, f32 accumulator and two
# f32 moments), 2 layers and the untied embedding and head (3.06 G
# parameters) are 49 GB before activations, 3 layers 60 GB, 4 layers 71 GB.
# On an H100 80GB HBM3 2 layers peaked at 53.4 GiB (25.8 GiB free), so the
# phase takes 3; 4 would leave no room for activations.
TRAIN = dict(arch="deepseek-67b", layers=3, batch=4, seq=4096, steps=4, lr=1e-4)
# one step each at published widths, the depth cut (an encoder-decoder's
# encoder too) to {arch: layers}: recurrentgemma's 3 are one (rec, rec,
# attn) group
TRAIN_SIDE = dict(archs={"qwen3-moe-30b-a3b": 2, "paligemma-3b": 2, "seamless-m4t-medium": 2,
                         "recurrentgemma-2b": 3}, batch=1, seq=4096)
# The restart check runs the launcher at the reduced config (d_model 64, 4
# query and 2 KV heads of 16, on the same kernels): a full-width checkpoint
# of the 2-layer state is 30 GB.
RESTART = dict(arch="deepseek-67b", steps=6, batch=4, seq=256, ckpt_every=2, fail_at=5)
# AdamW's first update is g / (|g| + eps) a parameter: where |g| is within a
# few hundred eps (1e-8) its direction turns on the gradient's last bits, and
# a gradient equal to f32 rounding moves it anywhere in [-lr, lr].  Updated
# parameters are held to 1e-4 of their largest value where the reference
# gradient is at least ADAM_COND * eps, and to 2 * lr elsewhere.
ADAM_EPS = 1e-8
ADAM_COND = 100
TRAIN_F32_TOL = 1e-4


class BackwardLog:
    """Records the first ``n`` ``flash_attention_backward`` calls of a run
    (operands, output gradient and the kernel's gradients), passing every
    call through unchanged."""

    def __init__(self, n: int):
        from repro_torch.kernels import flash_attention as flash_module

        self.n, self.module, self.seen = n, flash_module, []
        self.real = flash_module.flash_attention_backward

    def __call__(self, q, k, v, out, dout, lse=None, **kw):
        grads = self.real(q, k, v, out, dout, lse, **kw)
        if len(self.seen) < self.n:
            self.seen.append((tuple(t.detach() for t in (q, k, v, out, dout)), kw, grads))
        return grads

    def __enter__(self):
        self.patch = mock.patch.object(self.module, "flash_attention_backward", self)
        self.patch.start()
        return self

    def __exit__(self, *exc):
        self.patch.stop()
        del self.patch  # it holds self: no cycle keeps the recorded tensors


def plain_attention():
    """A context in which ``flash_attention``'s autograd Function runs the
    plain forward and the plain backward formulas on the card (the kernels'
    reference under autograd: ``flash_attention_plain`` itself works in
    place and cannot be differentiated)."""
    from contextlib import ExitStack

    from repro_torch.kernels import flash_attention as fm

    stack = ExitStack()
    stack.enter_context(mock.patch.object(
        fm, "_attend", lambda q, k, v, causal, scale, want_lse=False: fm.flash_attention_plain(
            q, k, v, causal=causal, scale=scale, return_lse=want_lse)))
    stack.enter_context(mock.patch.object(
        fm, "flash_attention_backward", lambda q, k, v, out, dout, lse=None, **kw:
        fm.flash_attention_backward_plain(q, k, v, out, dout, **kw)))
    return stack


def adam_param_errors(new: dict, ref: dict, ref_mu: dict, lr: float) -> dict:
    """Updated parameters ``new`` against ``ref`` after one AdamW step from
    the same start: the largest difference over each parameter's largest
    |ref| where the reference gradient (mu / (1 - b1)) is well conditioned,
    and the largest absolute difference elsewhere."""
    cond = ill = 0.0
    for n, r in ref.items():
        d = (new[n].float() - r.float()).abs()
        good = (ref_mu[n] / 0.1).abs() >= ADAM_COND * ADAM_EPS
        if bool(good.any()):
            cond = max(cond, float(d[good].max() / r.float().abs().max()))
        if bool((~good).any()):
            ill = max(ill, float(d[~good].max()))
    return {"conditioned_rel": cond, "ill_conditioned_abs": ill, "lr": lr}


def host_copy(named: dict) -> dict:
    return {n: t.detach().to("cpu", copy=True) for n, t in named.items()}


F32_STEPS = ("deepseek-67b", "paligemma-3b")  # the archs of train_f32_check, in order


def f32_step_check(dev, arch: str) -> dict:
    """One f32 AdamW step of ``arch`` at its widths and one layer,
    one 4,096-token sequence (a VLM's stand-in patch prefix from
    ``launch.train.make_batch`` before it), with the kernels, against the
    same step from the same start with ``plain_attention``: the loss
    within 1e-5, each first moment (0.1 times the gradient) within
    TRAIN_F32_TOL of its largest value, each updated parameter by
    ``adam_param_errors``; two forward launches a layer (remat) and one
    backward launch a layer, all on ``backward_route``'s kernels (f32 at D
    64, 128 and 256: the split route), with the split route's
    ``split_bf16`` launches counted (two a forward launch, one a
    backward: q, k, v and dO in one launch since PR 31)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fm
    from repro_torch.launch.train import make_batch, make_data, with_depth
    from repro_torch.training.train_loop import init_train_state, make_train_step

    cfg = with_depth(get_config(arch), 1).replace(dtype="float32", accum_steps=1)
    seqs = make_data(cfg, TRAIN["seq"], rows=1, seed=1)
    runs = {}
    for name in ("kernel", "plain"):
        params, opt = init_train_state(cfg, 0, dev)
        batch = make_batch(cfg, seqs, 0, dev)
        fm.reset_launches()
        if name == "plain":
            with plain_attention():
                _, opt, m = make_train_step(cfg, lr=TRAIN["lr"])(params, opt, batch)
        else:
            _, opt, m = make_train_step(cfg, lr=TRAIN["lr"])(params, opt, batch)
        sync(dev)
        runs[name] = dict(loss=float(m["loss"]), launches=fm.flash_attention.launches,
                          split_bf16_launches=fm.split_bf16.launches,
                          backward_launches=fm.flash_attention.backward_launches,
                          backward_route_launches=dict(fm.flash_attention.backward_route_launches),
                          params=host_copy(dict(params.named_parameters())),
                          mu=host_copy(opt.mu))
        del params, opt, batch, m
        torch.cuda.empty_cache()
    k, p = runs["kernel"], runs["plain"]
    attn = flash_layers(cfg)
    fwd_want = (2 if cfg.remat else 1) * attn
    check(k["launches"] == fwd_want and k["backward_launches"] == attn,
          f"{arch} f32 step: {k['launches']} forward and {k['backward_launches']} backward "
          f"launches, not {fwd_want} and {attn}")
    check(p["launches"] == 0 and p["backward_launches"] == 0, "the plain step launched a kernel")
    want_route = fm.backward_route(cfg.attention.head_dim, torch.float32)
    check(k["backward_route_launches"][want_route] == attn,
          f"{arch} f32 step: backward launches by route {k['backward_route_launches']}, not on "
          f"{want_route}")
    split_want = 2 * k["launches"] + k["backward_launches"]  # K and V; the backward's q, k, v, dO
    check(want_route != "tensor_cores" or k["split_bf16_launches"] == split_want,
          f"{arch} f32 step: {k['split_bf16_launches']} split_bf16 launches, not {split_want}")
    loss_err = abs(k["loss"] - p["loss"])
    mu_err = max(float((k["mu"][n] - p["mu"][n]).abs().max()
                       / p["mu"][n].abs().max().clamp_min(1e-30)) for n in p["mu"])
    perr = adam_param_errors(k["params"], p["params"], p["mu"], TRAIN["lr"])
    check(loss_err <= 1e-5, f"{arch} f32 step: loss {k['loss']} against {p['loss']} with the "
          "plain attention")
    check(mu_err <= TRAIN_F32_TOL, f"{arch} f32 step: gradients differ by {mu_err} of their "
          "largest")
    check(perr["conditioned_rel"] <= TRAIN_F32_TOL and perr["ill_conditioned_abs"]
          <= 2 * TRAIN["lr"], f"{arch} f32 step: updated parameters differ: {perr}")
    return dict(arch=arch, layers=cfg.num_layers, head_dim=cfg.attention.head_dim, loss=k["loss"],
                plain_loss=p["loss"], loss_err=loss_err, grad_rel_err=mu_err, params=perr,
                launches=k["launches"], backward_launches=k["backward_launches"],
                backward_route=want_route, backward_route_launches=k["backward_route_launches"],
                split_bf16_launches=k["split_bf16_launches"])


def train_f32_check(dev) -> dict:
    """{arch: ``f32_step_check``} for each of F32_STEPS in turn (each frees
    its memory before the next): deepseek-67b at D 128, then paligemma-3b
    at D 256."""
    return {arch: f32_step_check(dev, arch) for arch in F32_STEPS}


def restart_check(dev, tmp: Path) -> dict:
    """``launch.train.run`` at the reduced deepseek-67b config on the card
    (accum 2, remat): RESTART["steps"] steps straight, then the same with a
    simulated preemption before step ``fail_at``, which ``ResilientRunner``
    answers by restoring the last checkpoint (step ``fail_at`` - 1 rounded
    down to ``ckpt_every``) and the data cursor: the two runs' parameters
    and moments must be equal bit for bit.  The straight run's backward
    launches are counted by route, all on the tensor cores (D 16: since PR
    31, the CUDA cores before)."""
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import flash_attention as fm
    from repro_torch.launch.train import run

    cfg = reduced_config(RESTART["arch"]).replace(accum_steps=2, remat=True)
    kw = dict(steps=RESTART["steps"], batch=RESTART["batch"], seq=RESTART["seq"], lr=1e-3,
              device=dev, ckpt_every=RESTART["ckpt_every"], log=lambda _msg: None)
    fm.reset_launches()
    straight = run(cfg, ckpt_dir=tmp / "straight", **kw)
    sync(dev)
    bwd_routes = dict(fm.flash_attention.backward_route_launches)
    check(dev.type == "cpu" or {r for r, n in bwd_routes.items() if n} == {"tensor_cores"},
          f"restart check: backward launches by route {bwd_routes}, not all on the tensor cores")
    again = run(cfg, ckpt_dir=tmp / "restarted", fail_at=RESTART["fail_at"], **kw)
    check(again["report"].restarts == 1, f"{again['report'].restarts} restarts, not 1")
    same = [torch.equal(a, b) for a, b in zip(straight["params"].parameters(),
                                              again["params"].parameters())]
    same += [torch.equal(straight["opt"].mu[n], again["opt"].mu[n])
             and torch.equal(straight["opt"].nu[n], again["opt"].nu[n])
             for n in straight["opt"].mu]
    check(all(same), f"{same.count(False)} of {len(same)} tensors differ after the restart")
    check(again["losses"] == straight["losses"], "the losses differ after the restart")
    steps = sorted(p.name for p in (tmp / "restarted" / cfg.name).glob("step_*"))
    return dict(config=cfg.name, steps=RESTART["steps"], fail_at=RESTART["fail_at"],
                restarts=again["report"].restarts, checkpoints=steps,
                tensors_equal=len(same), losses=straight["losses"],
                backward_route_launches=bwd_routes)


def flash_layers(cfg) -> int:
    """Layers whose attention ``layers.mha`` sends to ``flash_attention``
    on the card: every GQA layer of the dense, MoE and VLM families, an
    encoder-decoder's decoder self-attention (its encoder and cross
    attention are not causal), none of the hybrid's (local attention) or
    of MLA."""
    if cfg.family == "hybrid" or cfg.attention.kind in ("mla", "none"):
        return 0
    return cfg.num_layers


def side_step(dev, arch: str) -> dict:
    """One launcher step of ``arch`` at its widths, depth cut to
    TRAIN_SIDE["archs"][arch] (``launch.train.with_depth``), one sequence:
    a finite loss and moments, and the counted launches (2 forward and 1
    backward a ``flash_layers`` layer a micro-batch, the backward on the
    route ``backward_route`` picks)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fm
    from repro_torch.launch.train import run, with_depth

    cfg = with_depth(get_config(arch), TRAIN_SIDE["archs"][arch])
    torch.cuda.reset_peak_memory_stats(dev)
    fm.reset_launches()
    res = run(cfg, steps=1, batch=TRAIN_SIDE["batch"], seq=TRAIN_SIDE["seq"], lr=TRAIN["lr"],
              device=dev, ckpt_every=0, log=lambda _msg: None)
    sync(dev)
    fwd, bwd = fm.flash_attention.launches, fm.flash_attention.backward_launches
    bwd_routes = dict(fm.flash_attention.backward_route_launches)
    micro = max(1, cfg.accum_steps)
    layers = cfg.num_layers
    attn = flash_layers(cfg)
    check(fwd == 2 * attn * micro and bwd == attn * micro,
          f"{arch}: {fwd} forward and {bwd} backward launches, not {2 * attn * micro} and "
          f"{attn * micro}")
    if attn:
        want = fm.backward_route(cfg.attention.head_dim, getattr(torch, cfg.dtype))
        check(bwd_routes[want] == bwd, f"{arch}: backward launches by route {bwd_routes}, not "
              f"all on {want}")
    finite = all(bool(torch.isfinite(m).all()) for m in res["opt"].mu.values())
    check(finite and math.isfinite(res["losses"][0]), f"{arch}: non-finite loss or gradients")
    out = dict(arch=arch, layers=layers,
               encoder_layers=cfg.encoder.num_layers if cfg.encoder is not None else 0,
               accum_steps=micro, loss=res["losses"][0],
               launches=fwd, backward_launches=bwd, backward_route_launches=bwd_routes,
               gradients_finite=finite,
               step_s=res["step_s"][0], peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    del res
    torch.cuda.empty_cache()
    return out


def run_train_path(dev, tmp: Path) -> dict:
    """Phase 10e: the training path at deepseek-67b's widths through
    ``launch.train.run`` (bf16 weights, accum 4, remat, AdamW with f32
    accumulation and moments): TRAIN["steps"] steps on one fixed batch of 4
    x 4,096 tokens (a stream of that one batch) with the launch counts
    zeroed just before, the loss falling; each layer's backward launch of
    the first micro-batch against the plain backward on its own q, k, v and
    dO; a profile of one more step; then ``train_f32_check``,
    ``restart_check`` and ``side_step`` for each TRAIN_SIDE architecture."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fm
    from repro_torch.kernels.flash_attention import flash_attention_backward_plain
    from repro_torch.launch.train import make_batch, make_data, run
    from repro_torch.training.train_loop import make_train_step

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN["arch"]).replace(num_layers=TRAIN["layers"])
    micro = cfg.accum_steps
    data = make_data(cfg, TRAIN["seq"], rows=TRAIN["batch"], seed=1)  # one global batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    fm.reset_launches()
    with BackwardLog(cfg.num_layers) as seen:
        res = run(cfg, steps=TRAIN["steps"], batch=TRAIN["batch"], seq=TRAIN["seq"],
                  lr=TRAIN["lr"], device=dev, ckpt_every=0, data=data, log=lambda _msg: None)
        sync(dev)
    fwd, bwd = fm.flash_attention.launches, fm.flash_attention.backward_launches
    bwd_routes = dict(fm.flash_attention.backward_route_launches)
    peak = torch.cuda.max_memory_allocated(dev)
    steps = TRAIN["steps"]
    check(fwd == steps * 2 * cfg.num_layers * micro,
          f"{fwd} forward launches in {steps} steps, not {steps * 2 * cfg.num_layers * micro}")
    check(bwd == steps * cfg.num_layers * micro,
          f"{bwd} backward launches in {steps} steps, not {steps * cfg.num_layers * micro}")
    want_route = fm.backward_route(cfg.attention.head_dim, getattr(torch, cfg.dtype))
    check(bwd_routes[want_route] == bwd, f"backward launches by route {bwd_routes}: not all on "
          f"{want_route}")
    losses = [res["losses"][s] for s in range(steps)]
    check(all(math.isfinite(x) for x in losses), f"non-finite losses {losses}")
    check(losses[-1] < losses[0], f"the loss on a fixed batch did not fall: {losses}")
    params, opt, step_s = res["params"], res["opt"], res["step_s"]
    step_fn = make_train_step(cfg, lr=TRAIN["lr"])
    batch = make_batch(cfg, data, 0, dev)
    prof = profile_split(lambda: step_fn(params, opt, batch), dev)
    del res, params, opt, batch, step_fn
    torch.cuda.empty_cache()
    layer_errs = []
    with torch.no_grad():
        for i, (args, kw, got) in enumerate(seen.seen):
            layer_errs.append(check_bwd_output(f"train layer {cfg.num_layers - 1 - i} backward",
                                               got, flash_attention_backward_plain(*args, **kw)))
    del seen
    torch.cuda.empty_cache()
    warm_s = sorted(step_s[1:])[(len(step_s) - 1) // 2]  # the median after the first step
    f32 = train_f32_check(dev)
    restart = restart_check(dev, tmp)
    side = {arch: side_step(dev, arch) for arch in TRAIN_SIDE["archs"]}
    out = dict(arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
               vocab=cfg.vocab_size, batch=TRAIN["batch"], seq=TRAIN["seq"], accum_steps=micro,
               remat=cfg.remat, dtype=cfg.dtype, lr=TRAIN["lr"], step_ms=[s * 1e3 for s in step_s],
               warm_step_ms=warm_s * 1e3,
               tokens_per_s=TRAIN["batch"] * TRAIN["seq"] / warm_s, launches=fwd,
               backward_launches=bwd, backward_route_launches=bwd_routes, losses=losses,
               layer_bwd_errors=layer_errs,
               peak_gib=peak / 2**30, peak_free_gib=(torch.cuda.get_device_properties(
                   dev).total_memory - peak) / 2**30, step_profile=prof, float32=f32,
               restart=restart, side_steps=side, seconds=time.perf_counter() - t_phase)
    emit("train_path", **out)
    return out


# ------------------------------------------------------------- phase 10g
# mamba2-2.7b at its published widths and full depth.  At 16 bytes a
# parameter (bf16 weights and gradient, two f32 moments, the f32 update's
# temporaries) its 2.7 G parameters are about 43 GB, plus 64 remat
# boundaries (5.4 GB), the f32 logits and their gradient (about 10 GB) and
# one layer's recomputed activations.
SSM_TRAIN = dict(arch="mamba2-2.7b", layers=64, batch=4, seq=4096, steps=4, lr=1e-4)


class SSDBackwardCheck:
    """Holds the first ``n`` ``ssd_chunk_backward`` calls of a run against
    the plain formulas on the call's own inputs (``ssd_bwd_plain_sliced``),
    keeping only the errors, and passes every call through unchanged.
    After the n-th check the peak memory statistics restart, so that the
    run's peak is the training's own."""

    def __init__(self, n: int, dev):
        from repro_torch.kernels import ssd_scan

        self.n, self.dev, self.module, self.errors = n, dev, ssd_scan, []
        self.real = ssd_scan.ssd_chunk_backward

    @property
    def launches(self) -> int:  # the wrapper counts on the real function
        return self.real.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.real.launches = n

    @property
    def route_launches(self) -> dict:
        return self.real.route_launches

    def __call__(self, x, dA, B, C, dy, dstates, ddecay):
        grads = self.real(x, dA, B, C, dy, dstates, ddecay)
        if len(self.errors) < self.n:
            with torch.no_grad():
                want = ssd_bwd_plain_sliced(x, dA, B, C, dy, dstates, ddecay)
                dtype = str(x.dtype).removeprefix("torch.")
                self.errors.append(check_ssd_bwd_output(
                    f"train layer {self.n - 1 - len(self.errors)} backward", grads, want, dtype))
            del want
            if len(self.errors) == self.n and self.dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(self.dev)
        return grads

    def __enter__(self):
        self.patch = mock.patch.object(self.module, "ssd_chunk_backward", self)
        self.patch.start()
        return self

    def __exit__(self, *exc):
        self.patch.stop()
        del self.patch  # it holds self: no cycle keeps the recorded tensors


def plain_ssd():
    """A context in which ``ops.ssd`` differentiates ``ssd_chunk_plain``
    with autograd (no kernel, no Function): the reference of the SSM's f32
    step."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_chunk_plain

    return mock.patch.object(ops, "ssd_chunk", ssd_chunk_plain)


def ssm_train_f32_check(dev) -> dict:
    """One f32 AdamW step of mamba2-2.7b at 1 layer, one 4,096-token
    sequence, through the kernels (``ssd_chunk``'s f32 route forward, twice
    under remat, and the backward kernel) against the same step from the
    same start with ``plain_ssd``: the loss within 1e-5, each first moment
    (0.1 times the gradient) within TRAIN_F32_TOL of its largest value,
    each updated parameter by ``adam_param_errors``; its one backward
    launch on the tensor cores (f32 x, B and C in pieces)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch.train import make_batch, make_data
    from repro_torch.training.train_loop import init_train_state, make_train_step

    cfg = get_config(SSM_TRAIN["arch"]).replace(num_layers=1, dtype="float32", accum_steps=1)
    seqs = make_data(cfg, SSM_TRAIN["seq"], rows=1, seed=1)
    runs = {}
    for name in ("kernel", "plain"):
        params, opt = init_train_state(cfg, 0, dev)
        batch = make_batch(cfg, seqs, 0, dev)
        ssd_scan.reset_launches()
        if name == "plain":
            with plain_ssd():
                _, opt, m = make_train_step(cfg, lr=SSM_TRAIN["lr"])(params, opt, batch)
        else:
            _, opt, m = make_train_step(cfg, lr=SSM_TRAIN["lr"])(params, opt, batch)
        sync(dev)
        runs[name] = dict(loss=float(m["loss"]), launches=ssd_scan.ssd_chunk.launches,
                          route_launches=dict(ssd_scan.ssd_chunk.route_launches),
                          backward_launches=ssd_scan.ssd_chunk_backward.launches,
                          backward_route_launches=dict(
                              ssd_scan.ssd_chunk_backward.route_launches),
                          params=host_copy(dict(params.named_parameters())),
                          mu=host_copy(opt.mu))
        del params, opt, batch, m
        torch.cuda.empty_cache()
    k, p = runs["kernel"], runs["plain"]
    on_card = dev.type == "cuda"
    check(not on_card or (k["launches"], k["backward_launches"]) == (2, 1),
          f"SSM f32 step: {k['launches']} forward and {k['backward_launches']} backward "
          "launches, not 2 and 1 (one layer, remat)")
    check(p["launches"] == 0 and p["backward_launches"] == 0, "the plain step launched a kernel")
    check(not on_card or k["backward_route_launches"]["tensor_cores"] == 1,
          f"SSM f32 step: backward launches by route {k['backward_route_launches']}, not on "
          "the tensor cores")
    loss_err = abs(k["loss"] - p["loss"])
    mu_err = max(float((k["mu"][n] - p["mu"][n]).abs().max()
                       / p["mu"][n].abs().max().clamp_min(1e-30)) for n in p["mu"])
    perr = adam_param_errors(k["params"], p["params"], p["mu"], SSM_TRAIN["lr"])
    check(loss_err <= 1e-5, f"SSM f32 step: loss {k['loss']} against {p['loss']} on the plain "
          "route")
    check(mu_err <= TRAIN_F32_TOL, f"SSM f32 step: gradients differ by {mu_err} of their "
          "largest")
    check(perr["conditioned_rel"] <= TRAIN_F32_TOL and perr["ill_conditioned_abs"]
          <= 2 * SSM_TRAIN["lr"], f"SSM f32 step: updated parameters differ: {perr}")
    return dict(loss=k["loss"], plain_loss=p["loss"], loss_err=loss_err, grad_rel_err=mu_err,
                params=perr, launches=k["launches"], route_launches=k["route_launches"],
                backward_launches=k["backward_launches"],
                backward_route_launches=k["backward_route_launches"])


def run_ssm_train_path(dev, layers: int = SSM_TRAIN["layers"]) -> dict:
    """Phase 10g: the SSM family's training at mamba2-2.7b's widths
    through ``launch.train.run`` (bf16 weights, accum and remat as
    ``configs/archs.py`` sets them, AdamW with f32 moments): SSM_TRAIN
    steps on one fixed batch of 4 x 4,096 tokens with the counts zeroed
    just before: one ``ssd_chunk`` forward launch a layer a forward pass
    (two a micro-batch under remat) and one backward launch a layer a
    micro-batch; the loss falling; each layer's backward launch of the
    first step held against the plain formulas on its own inputs; warm step
    ms, tokens/s and peak memory (after those checks); a profile of one
    more step (``profile_split``); then ``ssm_train_f32_check``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch.train import make_batch, make_data, run
    from repro_torch.training.train_loop import make_train_step

    t_phase = time.perf_counter()
    cfg = get_config(SSM_TRAIN["arch"]).replace(num_layers=layers)
    micro, steps = max(1, cfg.accum_steps), SSM_TRAIN["steps"]
    passes = 2 if cfg.remat else 1
    data = make_data(cfg, SSM_TRAIN["seq"], rows=SSM_TRAIN["batch"], seed=1)
    torch.cuda.empty_cache()
    ssd_scan.reset_launches()
    with SSDBackwardCheck(cfg.num_layers, dev) as seen:
        res = run(cfg, steps=steps, batch=SSM_TRAIN["batch"], seq=SSM_TRAIN["seq"],
                  lr=SSM_TRAIN["lr"], device=dev, ckpt_every=0, data=data,
                  log=lambda _msg: None)
        sync(dev)
    fwd, bwd = ssd_scan.ssd_chunk.launches, ssd_scan.ssd_chunk_backward.launches
    routes = dict(ssd_scan.ssd_chunk.route_launches)
    bwd_routes = dict(ssd_scan.ssd_chunk_backward.route_launches)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    on_card = dev.type == "cuda"
    want_fwd, want_bwd = steps * passes * cfg.num_layers * micro, steps * cfg.num_layers * micro
    check(not on_card or fwd == want_fwd,
          f"{fwd} ssd_chunk forward launches in {steps} steps, not {want_fwd}")
    check(not on_card or bwd == want_bwd,
          f"{bwd} ssd_chunk backward launches in {steps} steps, not {want_bwd}")
    check(not on_card or bwd_routes["tensor_cores"] == want_bwd,
          f"the backward's launches by route {bwd_routes}: not all {want_bwd} on the tensor cores")
    check(len(seen.errors) == cfg.num_layers, f"{len(seen.errors)} backward calls checked")
    losses = [res["losses"][s] for s in range(steps)]
    check(all(math.isfinite(x) for x in losses), f"non-finite losses {losses}")
    check(losses[-1] < losses[0], f"the SSM loss on a fixed batch did not fall: {losses}")
    step_s = res["step_s"]
    warm_s = sorted(step_s[1:])[(len(step_s) - 1) // 2]  # the median after the first step
    n_params = sum(p.numel() for p in res["params"].parameters())
    step_fn = make_train_step(cfg, lr=SSM_TRAIN["lr"])
    batch = make_batch(cfg, data, 0, dev)
    prof = (profile_split(lambda: step_fn(res["params"], res["opt"], batch), dev) if on_card
            else None)
    del res, batch, step_fn
    torch.cuda.empty_cache()
    f32 = ssm_train_f32_check(dev)
    out = dict(arch=cfg.name, source=cfg.source, layers=cfg.num_layers,
               published_layers=get_config(SSM_TRAIN["arch"]).num_layers, d_model=cfg.d_model,
               heads=cfg.ssm_heads, d_state=cfg.ssm.d_state, vocab=cfg.vocab_size,
               params=n_params, batch=SSM_TRAIN["batch"], seq=SSM_TRAIN["seq"],
               accum_steps=micro, remat=cfg.remat, dtype=cfg.dtype, lr=SSM_TRAIN["lr"],
               step_ms=[s * 1e3 for s in step_s], warm_step_ms=warm_s * 1e3,
               tokens_per_s=SSM_TRAIN["batch"] * SSM_TRAIN["seq"] / warm_s, launches=fwd,
               route_launches=routes, backward_launches=bwd,
               backward_route_launches=bwd_routes, losses=losses,
               layer_bwd_errors=seen.errors,
               layer_bwd_max_err={n: max(e[n] for e in seen.errors) for n in SSD_BWD_NAMES},
               peak_gib=peak / 2**30,
               peak_free_gib=(torch.cuda.get_device_properties(dev).total_memory - peak) / 2**30
               if on_card else None, step_profile=prof, float32=f32,
               seconds=time.perf_counter() - t_phase)
    emit("ssm_train_path", **out)
    return out


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


def submit_tiles(n: int, max_tile: int, chunk: int = SERVE_CHUNK) -> int:
    """Scorer tiles that ``run_stream(x, chunk=chunk)`` submits for n
    records when each submit is cut into tiles of ``max_tile`` rows."""
    return sum(-(-min(chunk, n - s) // max_tile) for s in range(0, n, chunk))


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
    out["autotune_case"] = (srv._states[-1].cascade, stream.x[starts[1]:starts[1] + tile])
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
    out["autotune_case"] = (sc, x[:SERVE_CHUNK])
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


# ------------------------------------------------------------- phase 20
# CORE's queries over transformer UDFs (``repro_torch.transformer_udf_serving``):
# llama3-405b (one layer of 126) and qwen3-moe-30b-a3b (two of 48) at their
# published widths as the two predicates' UDFs, the example's dataset,
# query, sample, tile and steps; then the same at the reduced configs (D 16),
# as the JAX package's example runs it.
UDF = dict(n=12_000, steps=100, tile=512, chunk=2048, accuracy=0.9)
UDF_TIE_TOL = 2.0 ** -5  # top two pooled logits within this of the larger's size: a near tie
UDF_SHAPES = ((2000, 8, 8, 128, 8, 128), (2000, 8, 8, 32, 4, 128),  # the training steps'
              (2000, 8, 8, 4, 2, 16))  # (the reduced configs' last)
# ms of the forward and backward at UDF_SHAPES on the routes they took before
# the packed one (128-row tensor-core tiles; the D 16 backward on the CUDA
# cores), as this script's udf_timing measured them on an NVIDIA H100 80GB
# HBM3 at 700.00 W (D 16's forward: scripts/flash_ab.py --udf on that tree).
UDF_BEFORE = {"H128": (10.12, 12.03), "H32": (2.561, 3.190), "D16": (0.1470, 0.4813)}


def udf_labels_vs_plain(udf, x: np.ndarray) -> dict:
    """The UDF's pooled logits on ``x`` in the batches ``fn`` takes (2048
    records, padded as ``fn`` pads), with the kernel and with the plain
    attention in its place (a MoE's expert choices pinned to the kernel
    run's): every label that differs must sit at a near tie of the top two
    pooled logits (UDF_TIE_TOL of the larger's size, at least 1)."""
    pin = RouteLog()
    with pin.record():
        got = torch.cat([udf.logits(x[s:s + 2048]) for s in range(0, len(x), 2048)])
    with pin.replay(), plain_attention():
        want = torch.cat([udf.logits(x[s:s + 2048]) for s in range(0, len(x), 2048)])
    differ = got.argmax(-1) != want.argmax(-1)
    top2 = want.topk(2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) <= UDF_TIE_TOL * top2[:, 0].abs().clamp_min(1.0)
    off_tie = int((differ & ~tie).sum())
    check(off_tie == 0, f"{udf.name}: {off_tie} labels differ between the kernel and the "
          f"plain attention off a near tie")
    return dict(records=len(x), labels_differ=int(differ.sum()), near_ties=int(tie.sum()),
                max_abs_logit_diff=float((got - want).abs().max()),
                router_flips=pin.flips, router_max_gap=pin.max_gap)


def run_udf_path(dev, full: bool, phase: str) -> dict:
    """Phase 20: ``transformer_udf_serving.run`` on the card, with every
    kernel count zeroed just before.  Each UDF's first training step is
    recorded: each layer's attention against ``flash_attention_plain`` and
    each backward launch against the plain backward on its own q, k, v and
    dO.  Checks: forward launches == layers x backbone calls (training
    steps, accuracy and cost probes, every ``fn`` call), backward launches
    == layers x steps, all on the packed route (8 tokens); finite, falling
    losses; no predicate of selectivity 0 or 1 on the sample; one
    ``cascade_score`` launch a served tile and emitted + rejected == served;
    CORE's accuracy against ORIG >= A - 0.05; then each UDF's labels
    against the plain attention (``udf_labels_vs_plain``)."""
    from repro_torch import transformer_udf_serving as T
    from repro_torch.kernels import flash_attention as fm
    from repro_torch.kernels.flash_attention import (flash_attention_backward_plain,
                                                     flash_attention_plain)
    from repro_torch.kernels.proxy_score import cascade_score
    from repro_torch.models import layers as model_layers

    t_phase = time.perf_counter()
    seen, budget, first_step = [], [0], []
    real_flash, real_train = model_layers.flash_attention, T.train_udf

    def kept(q, k, v, *, causal=True):
        out = real_flash(q, k, v, causal=causal)
        if budget[0] > 0:
            budget[0] -= 1
            seen.append(tuple(t.detach() for t in (q, k, v, out)))
        return out

    def train_udf(params, cfg, x, y, *, steps):
        """The first step's attention and backward launches recorded, then
        held to the plain versions (each layer, its own inputs)."""
        seen.clear()
        budget[0] = cfg.num_layers
        with BackwardLog(cfg.num_layers) as bwd:
            losses = real_train(params, cfg, x, y, steps=steps)
        att = [check_flash_output(f"{cfg.name} layer {i} attention",
                                  o, flash_attention_plain(q, k, v, causal=True))
               for i, (q, k, v, o) in enumerate(seen)]
        grads = [check_bwd_output(f"{cfg.name} backward {i}", got,
                                  flash_attention_backward_plain(*args, **kw))
                 for i, (args, kw, got) in enumerate(bwd.seen)]
        check(len(att) == len(grads) == cfg.num_layers or dev.type == "cpu",
              f"{cfg.name}: {len(att)} attention and {len(grads)} backward calls recorded in "
              f"the first step, not {cfg.num_layers}")
        first_step.append(dict(udf=cfg.name, attention=att, backward=grads))
        seen.clear()
        del bwd
        return losses

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    fm.reset_launches()
    cascade_score.launches = 0
    served = {}
    real_run_stream = T.CascadeServer.run_stream

    def counted_run_stream(self, x, *, chunk=4096):
        before = cascade_score.launches
        stats = real_run_stream(self, x, chunk=chunk)
        served.update(launches=cascade_score.launches - before, records=len(x),
                      tiles=submit_tiles(len(x), max(self.tile, 1024), chunk))
        return stats

    inits, real_init = [], T.init_udf_params

    def init_udf_params(cfg, n_features, n_classes, seed, device="cuda"):
        """The UDF's initial tree (the JAX example's, from its key), timed;
        every drawn weight held to the plain version at sampled indices,
        and every other parameter a constant fill (norms, biases)."""
        sync(dev)
        t0 = time.perf_counter()
        drawn = {}
        with counted_draws(dev, f"{cfg.name} UDF init", drawn, keep=True):
            params = real_init(cfg, n_features, n_classes, seed, device=device)
        sync(dev)
        init_s = time.perf_counter() - t0
        rng = np.random.RandomState(seed)
        picks = [(t, d, sample_indices(t.numel(), rng)) for t, d in drawn["draws"]]
        err = max(check_sampled(f"{cfg.name} UDF init", t, d, idx) for t, d, idx in picks)
        sampled = sum(len(idx) for _, _, idx in picks)
        ptrs = {t.data_ptr() for t, _ in drawn["draws"]}
        tree = [*params["backbone"].parameters(), params["proj"], params["head"]]
        undrawn = [p for p in tree if p.data_ptr() not in ptrs]
        check(all(bool(((p == 0) | (p == 1)).all()) for p in undrawn),
              f"{cfg.name}: a parameter of the UDF's tree is neither drawn nor a constant fill")
        inits.append(dict(udf=cfg.name, init_s=init_s, draws=len(drawn["draws"]),
                          threefry_launches=drawn["threefry_launches"], sampled=sampled,
                          max_abs_err=err,
                          constant_fills=len(undrawn), params=sum(p.numel() for p in tree)))
        return params

    with mock.patch.object(model_layers, "flash_attention", kept), \
            mock.patch.object(T, "train_udf", train_udf), \
            mock.patch.object(T, "init_udf_params", init_udf_params), \
            mock.patch.object(T.CascadeServer, "run_stream", counted_run_stream):
        res = T.run(UDF["n"], steps=UDF["steps"], full=full, device=dev, log=lambda _m: None)
    sync(dev)
    fwd, bwd = fm.flash_attention.launches, fm.flash_attention.backward_launches
    routes = dict(fm.flash_attention.route_launches)
    bwd_routes = dict(fm.flash_attention.backward_route_launches)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    udfs, stats, plan = res["udfs"], res["stats"], res["plan"]
    want_fwd = sum(u.cfg.num_layers * u.calls for u in udfs) if on_card else 0
    want_bwd = sum(u.cfg.num_layers * len(u.losses) for u in udfs) if on_card else 0
    check(fwd == want_fwd, f"{phase}: {fwd} forward launches, not {want_fwd} (layers x "
          f"backbone calls {[u.calls for u in udfs]})")
    check(bwd == want_bwd, f"{phase}: {bwd} backward launches, not {want_bwd}")
    # every call is 8 tokens of at most 2,048 records in bf16: the packed route
    check(routes["packed"] == fwd, f"{phase}: forward launches by route {routes}")
    check(bwd_routes["packed"] == bwd, f"{phase}: backward launches by route {bwd_routes}, "
          f"not all on packed")
    for u in udfs:
        check(all(math.isfinite(v) for v in u.losses) and u.losses[-1] < u.losses[0],
              f"{u.name}: losses {u.losses[0]} -> {u.losses[-1]} are not finite and falling")
    check(served["launches"] == served["tiles"] or not on_card, f"{phase}: {served['launches']} "
          f"cascade_score launches for {served['tiles']} served tiles")
    check(stats.emitted + stats.rejected == served["records"]
          and res["server"].in_flight() == 0, f"{phase}: emitted {stats.emitted} + rejected "
          f"{stats.rejected} != served {served['records']}")
    check(res["accuracy"] >= UDF["accuracy"] - 0.05,
          f"{phase}: CORE's accuracy against ORIG {res['accuracy']:.4f}")
    sample = res["ds"].x[:T.TRAIN_ROWS]
    selectivity = [float(np.isin(p.udf(sample), list(p.values)).mean())
                   for p in res["query"].predicates]
    check(all(0.0 < s < 1.0 for s in selectivity), f"{phase}: predicate selectivities "
          f"{selectivity} on the sample")
    labels = [udf_labels_vs_plain(u, res["rest"]) for u in udfs]
    out = dict(full=full, records=UDF["n"], served_records=served["records"],
               sample=T.TRAIN_ROWS, steps=UDF["steps"], lr=T.LR,
               udfs=[dict(name=u.name, config=u.cfg.name, source=u.cfg.source,
                          layers=u.cfg.num_layers,
                          published_layers=get_published_layers(u.cfg), d_model=u.cfg.d_model,
                          heads=u.cfg.attention.num_heads, kv_heads=u.cfg.attention.num_kv_heads,
                          head_dim=u.cfg.attention.head_dim, d_ff=u.cfg.d_ff,
                          params=sum(p.numel() for p in u.params["backbone"].parameters()),
                          loss_first=u.losses[0], loss=u.losses[-1],
                          train_accuracy=u.train_accuracy, ms_per_record=u.cost,
                          backbone_calls=u.calls, train_s=s)
                     for u, s in zip(udfs, res["train_s"])],
               first_step=first_step, selectivity=selectivity,
               optimize_s=res["optimize_s"], order=list(plan.order),
               serve_s=res["serve_s"], records_per_s=served["records"] / res["serve_s"],
               execute_s=res["execute_s"], emitted=stats.emitted, rejected=stats.rejected,
               stage_udf_batches=stats.stage_udf_batches, stage_in=stats.stage_in,
               orig_ms_per_record=res["orig"].cost_per_record(served["records"]),
               core_ms_per_record=res["res"].cost_per_record(served["records"]),
               cost_saving=res["saving"], accuracy=res["accuracy"],
               accuracy_floor=UDF["accuracy"] - 0.05, launches=fwd, route_launches=routes,
               backward_launches=bwd, backward_route_launches=bwd_routes,
               cascade_score_launches=served["launches"], served_tiles=served["tiles"],
               labels_vs_plain=labels, peak_gib=peak / 2**30, init=inits,
               init_s=sum(i["init_s"] for i in inits),
               threefry_launches=sum(i["threefry_launches"] for i in inits),
               seconds=time.perf_counter() - t_phase)
    emit(phase, **out)
    del res, udfs
    torch.cuda.empty_cache()
    return out


def get_published_layers(cfg) -> int:
    from repro_torch.configs import get_config

    return get_config(cfg.name.removesuffix("-smoke")).num_layers


def run_udf_timing(dev) -> dict:
    """The forward and backward kernels at the UDF training steps' shapes
    (UDF_SHAPES: 2,000 records of 8 tokens, llama3-405b's and
    qwen3-moe-30b-a3b's heads, and the reduced configs' D 16) beside SDPA
    and its backward in the same run, and the earlier times of the routes
    these shapes took before the packed one (UDF_BEFORE; same card model
    and power limit).  One ``udf_timing`` line with each shape's route, ms, the
    bound and its share, SDPA's, registers, spills and shared memory."""
    rows = {}
    for shape in UDF_SHAPES:
        key = f"H{shape[3]}" if shape[5] == 128 else f"D{shape[5]}"
        rows[key] = dict(forward=time_flash(dev, "bfloat16", iters=20, shape=shape),
                         backward=time_flash_bwd(dev, "bfloat16", shape, iters=10))
        torch.cuda.empty_cache()
    summary = {}
    for key, r in rows.items():
        f, b = r["forward"], r["backward"]
        summary[key] = dict(
            shape=f["shape"],
            forward=dict(route=f["route"], ms=f["ms"], with_lse_ms=f["with_lse_ms"],
                         bound_ms=f["bound_ms"], share_of_bound=f["share_of_bound"],
                         sdpa_ms=f["library_ms"], registers=f["ptxas"]["registers"],
                         spill_store_bytes=f["ptxas"]["spill_store_bytes"],
                         smem_bytes=f["smem_bytes"], before_ms=UDF_BEFORE[key][0]),
            backward=dict(route=b["route"], ms=b["ms"], bound_ms=b["bound_ms"],
                          share_of_bound=b["share_of_bound"], sdpa_ms=b["library_ms"],
                          kernel_us=b["kernel_us"], resources=b["resources"],
                          spill_store_bytes={k: e["spill_store_bytes"]
                                             for k, e in b["ptxas"].items()},
                          before_ms=UDF_BEFORE[key][1]))
    emit("udf_timing", card=nvidia_smi_line(), shapes=summary)
    return rows


# ------------------------------------------------------------- phase 21
VIDEO = dict(n=10_000, accuracy=0.9)


def run_video_cascade_path(dev) -> dict:
    """Phase 21: ``video_cascade.run`` on the card (its UDFs trained there):
    each mode's plan executed on ``cascade_score`` (one launch a tile of
    8,192 records for a plan with a proxied stage), accuracy against ORIG
    >= A - 0.05 for each."""
    from repro_torch import video_cascade
    from repro_torch.kernels.proxy_score import cascade_score

    t0 = time.perf_counter()
    cascade_score.launches = 0
    res = video_cascade.run(VIDEO["n"], dev, log=lambda _m: None)
    sync(dev)
    launches = cascade_score.launches
    n = res["records"]
    tiles = sum(-(-n // 8192) for m in res["modes"].values()
                if any(st.proxy is not None for st in m["plan"].stages))
    check(launches == tiles or dev.type == "cpu",
          f"video_cascade_path: {launches} launches for {tiles} tiles")
    for mode, m in res["modes"].items():
        check(m["accuracy"] >= VIDEO["accuracy"] - 0.05,
              f"video_cascade_path {mode}: accuracy {m['accuracy']:.4f}")
    out = dict(records=n, launches=launches, tiles=tiles,
               orig_ms_per_record=res["orig"].cost_per_record(n),
               modes={mode: dict(order=list(m["plan"].order), accuracy=m["accuracy"],
                                 exec_ms_per_record=m["exec_ms_per_record"],
                                 labeling_ms=m["stats"]["labeling_ms"],
                                 training_ms=m["stats"]["training_ms"],
                                 search_ms=m["stats"]["search_ms"],
                                 bnb_nodes_visited=(m["trace"] or {}).get("nodes_visited"),
                                 bnb_nodes_total=(m["trace"] or {}).get("nodes_total"))
                      for mode, m in res["modes"].items()},
               seconds=time.perf_counter() - t0)
    emit("video_cascade_path", **out)
    return out


# ------------------------------------------------------------- phase 22
RESILIENT = dict(archs=("deepseek-67b", "mamba2-2.7b"), steps=30)


def run_resilient_path(dev) -> dict:
    """Phase 22: ``resilient_training.run`` on the card at the reduced
    dense and SSM configs, the example's 30 steps: a straight run, then one
    preempted before step 15 (restored from step 10), which must end equal
    bit for bit to it (parameters, moments, every step's loss); the kernel
    launches of the preempted run (flash forward and backward a layer a
    step run, or ``ssd_chunk`` and its backward), all on one route (packed;
    the SSM's forward and backward on the one-pass kernels) and its
    straggler events."""
    from repro_torch import resilient_training
    from repro_torch.kernels import flash_attention as fm
    from repro_torch.kernels import ssd_scan

    t0 = time.perf_counter()
    out = {}
    for arch in RESILIENT["archs"]:
        quiet = dict(device=dev, log=lambda _m: None)
        straight = resilient_training.run(arch, RESILIENT["steps"], preempt=False, **quiet)
        fm.reset_launches()
        ssd_scan.reset_launches()
        again = resilient_training.run(arch, RESILIENT["steps"], **quiet)
        sync(dev)
        cfg = again["cfg"]
        ran = len(again["losses"])
        if cfg.family == "ssm":
            launches = {"ssd_chunk": ssd_scan.ssd_chunk.launches,
                        "ssd_chunk_backward": ssd_scan.ssd_chunk_backward.launches}
            routes = dict(ssd_scan.ssd_chunk_backward.route_launches)
            fwd_routes = dict(ssd_scan.ssd_chunk.route_launches)
            want = "one_pass"  # P 8: off the wgmma shapes, chunks of 16
        else:
            launches = {"flash_attention": fm.flash_attention.launches,
                        "flash_attention_backward": fm.flash_attention.backward_launches}
            routes = dict(fm.flash_attention.backward_route_launches)
            fwd_routes = dict(fm.flash_attention.route_launches)
            want = "packed"  # a 32-token sequence at D 16
        check(dev.type == "cpu" or {r for r, n in routes.items() if n} == {want},
              f"resilient_path {arch}: backward launches by route {routes}, not all {want}")
        check(dev.type == "cpu" or {r for r, n in fwd_routes.items() if n} == {want},
              f"resilient_path {arch}: forward launches by route {fwd_routes}, not all {want}")
        check(all(n == cfg.num_layers * ran for n in launches.values()) or dev.type == "cpu",
              f"resilient_path {arch}: launches {launches}, not {cfg.num_layers} a layer for "
              f"each of {ran} steps")
        check(again["report"].restarts == 1 and again["restored_from"] == [10],
              f"resilient_path {arch}: {again['report'].restarts} restarts from "
              f"{again['restored_from']}")
        same = [torch.equal(a, b) for a, b in zip(straight["params"].parameters(),
                                                  again["params"].parameters())]
        same += [torch.equal(straight["opt"].mu[n], again["opt"].mu[n])
                 and torch.equal(straight["opt"].nu[n], again["opt"].nu[n])
                 for n in straight["opt"].mu]
        check(all(same), f"resilient_path {arch}: {same.count(False)} of {len(same)} tensors "
              f"differ from the straight run")
        check(dict(again["losses"]) == dict(straight["losses"]),
              f"resilient_path {arch}: losses differ from the straight run")
        out[arch] = dict(config=cfg.name, steps=RESILIENT["steps"], steps_run=ran,
                         restarts=again["report"].restarts, restored_from=again["restored_from"],
                         tensors_equal=len(same), loss_first=again["losses"][0][1],
                         loss_last=again["losses"][-1][1], dtype=cfg.dtype, launches=launches,
                         forward_route_launches=fwd_routes, backward_route_launches=routes,
                         straggler_events=again["report"].straggler_events,
                         straggler_steps=again["straggler_steps"],
                         step_ewma_ms=again["report"].final_step_time_ewma * 1e3,
                         seconds=again["seconds"])
    emit("resilient_path", seconds=time.perf_counter() - t0, **out)
    return out


# ---------------------------------------------------------- distribution
# mesh_path: the sharded step on a (1, 1) ("data", "model") mesh of an NCCL
# world of one, at train_path's cell; dryrun_cells: the port's dry run of
# two production cells and of mesh_path's own; cascade_dryrun: the fused
# scorer's dry run on the card.
MESH_TRAIN_STEPS = 2
DRYRUN_CELLS = (  # (arch, shape, variant, mesh, layers, batch, extrapolate)
    ("llama3-405b", "train_4k", "baseline", (16, 16), None, None, None),
    ("qwen3-moe-30b-a3b", "prefill_32k", "opt", (16, 16), None, None, None),
    # mesh_path's own cell, traced in full and then extrapolated
    (TRAIN["arch"], "train_4k", "baseline", (1, 1), TRAIN["layers"], TRAIN["batch"], False),
    (TRAIN["arch"], "train_4k", "baseline", (1, 1), TRAIN["layers"], TRAIN["batch"], True),
)
# the dry run's cells in one process of their own (its fake worlds its
# own; a process start costs 10-20 s on the card's host)
DRYRUN_SCRIPT = """
import json, sys
from repro_torch.launch import dryrun
for arch, shape, variant, mesh, layers, batch, extrapolate in json.loads(sys.argv[1]):
    rec = dryrun.run_cell(arch, shape, variant=variant, mesh_shape=tuple(mesh), layers=layers,
                          batch=batch, force=True, results_dir=sys.argv[2],
                          extrapolate=extrapolate)
    print("RECORD " + json.dumps(rec), flush=True)
"""


def nccl_world(dev) -> None:
    """A default process group of one rank on ``dev`` (NCCL), its
    rendezvous on a free localhost port."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, device_id=dev)


def leaf_errors(got: dict, want_host: dict) -> dict:
    """Per leaf of the JAX layout: bit-equal, and the largest difference
    over the leaf's largest value."""
    from torch.distributed.tensor import DTensor

    equal, worst, where = True, 0.0, None
    for k, want in want_host.items():
        g = got[k].to_local() if isinstance(got[k], DTensor) else got[k]
        w = want.to(g.device)
        equal &= bool(torch.equal(g.detach(), w))
        rel = float((g.detach().float() - w.float()).abs().max()
                    / w.float().abs().max().clamp_min(1e-30))
        if rel > worst:
            worst, where = rel, "/".join(map(str, k))
        del w
    return {"bit_equal": equal, "max_rel": worst, "worst_leaf": where}


def run_mesh_path(dev, train: dict) -> dict:
    """Phase mesh_path: ``train_path``'s cell (deepseek-67b, 3 layers, 4 x
    4,096 tokens, accum 4, remat, AdamW) through ``build_cell``'s layouts
    on a (1, 1) mesh of an NCCL world of one: the params, optimizer state
    and batch DTensors, MESH_TRAIN_STEPS steps of ``make_sharded_train_step``
    under ``ctx.use_mesh`` held to the same steps of the unsharded
    ``make_train_step`` from the same seed (bit for bit, or else within the
    bf16 train limits), with ``flash_attention``'s launches by route equal
    to ``train_path``'s a step; a qwen3-moe prefill at moe_path's depth
    with ``ep`` on (``moe_apply_ep`` at tp 1 against ``moe_apply``); and a
    dense decode step over a cache laid out by ``cache_sharding``."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import (batch_sharding, cache_sharding, distribute,
                                                  local_bytes, opt_shardings, params_shardings,
                                                  serve_mode_for)
    from repro_torch.kernels import flash_attention as fm
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.train import make_batch, make_data
    from repro_torch.models import moe, transformer
    from repro_torch.training.train_loop import (apply_with_leaves, init_leaf_opt_state,
                                                 init_train_state, leaf_params,
                                                 make_sharded_train_step, make_train_step)

    t_phase = time.perf_counter()
    # This phase's steps need the card's memory whole: collect whatever the
    # phase before left in reference cycles after its line (``emit``).
    gc.collect()
    torch.cuda.empty_cache()
    allocated_at_start = torch.cuda.memory_allocated(dev)
    nccl_world(dev)
    try:
        mesh = make_dev_mesh(1, 1, device_type="cuda")
        cfg = get_config(TRAIN["arch"]).replace(num_layers=TRAIN["layers"])
        data = make_data(cfg, TRAIN["seq"], rows=TRAIN["batch"], seed=1)
        # int32 tokens: the dry run's input specs (the values are train_path's)
        batch = {k: v.to(torch.int32) for k, v in make_batch(cfg, data, 0, dev).items()}

        # the unsharded steps from seed 0
        params, opt = init_train_state(cfg, 0, dev)
        start = {k: v.cpu() for k, v in leaf_params(params).items()}
        step = make_train_step(cfg, lr=TRAIN["lr"])
        fm.reset_launches()
        ref_losses = []
        for _ in range(MESH_TRAIN_STEPS):
            _, opt, m = step(params, opt, batch)
            ref_losses.append(float(m["loss"]))
        ref_launch = (fm.flash_attention.launches, fm.flash_attention.backward_launches)
        final = {k: v.cpu() for k, v in leaf_params(params).items()}
        del params, opt, step, m
        torch.cuda.empty_cache()

        # the same steps on the mesh
        plain = {k: v.to(dev) for k, v in start.items()}
        sparams = distribute(plain, params_shardings(plain, mesh, "train"), requires_grad=True)
        opt_plain = init_leaf_opt_state(cfg, plain)
        sopt = distribute(opt_plain, opt_shardings(opt_plain, mesh))
        sbatch = distribute(batch, batch_sharding(batch, mesh))
        del plain, opt_plain
        arg_bytes = local_bytes([sparams, sopt, sbatch])
        sstep = make_sharded_train_step(cfg, lr=TRAIN["lr"])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        fm.reset_launches()
        losses, step_ms = [], []
        with ctx.use_mesh(mesh):
            for _ in range(MESH_TRAIN_STEPS):
                sync(dev)
                t0 = time.perf_counter()
                _, sopt, m = sstep(sparams, sopt, sbatch)
                sync(dev)
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(m["loss"].full_tensor()))
        peak = torch.cuda.max_memory_allocated(dev)
        fwd, bwd = fm.flash_attention.launches, fm.flash_attention.backward_launches
        fwd_routes = dict(fm.flash_attention.route_launches)
        bwd_routes = dict(fm.flash_attention.backward_route_launches)
        per_step = (train["launches"] // TRAIN["steps"], train["backward_launches"] // TRAIN["steps"])
        check((fwd, bwd) == ref_launch == (MESH_TRAIN_STEPS * per_step[0],
                                           MESH_TRAIN_STEPS * per_step[1]),
              f"mesh_path: {fwd} / {bwd} flash launches, unsharded {ref_launch}, train_path "
              f"{per_step} a step")
        check(fwd_routes["tensor_cores"] == fwd and bwd_routes["tensor_cores"] == bwd,
              f"mesh_path: flash launches off the tensor cores: {fwd_routes} {bwd_routes}")
        params_err = leaf_errors(sparams, final)
        loss_err = max(abs(a - b) for a, b in zip(losses, ref_losses))
        check(all(math.isfinite(x) for x in losses), f"mesh_path: losses {losses}")
        check(params_err["bit_equal"] and loss_err == 0.0
              or (params_err["max_rel"] <= PREFILL_TOL and loss_err <= PREFILL_TOL),
              f"mesh_path: the sharded steps differ from the unsharded: loss {loss_err}, "
              f"params {params_err}")
        check(isinstance(sparams[("layers", "attn", "wq")], torch.distributed.tensor.DTensor),
              "mesh_path: the params are not DTensors")
        del sparams, sopt, sbatch, sstep, m, final, start
        torch.cuda.empty_cache()

        # a qwen3-moe prefill with expert parallelism on
        mcfg = get_config(MOE["arch"]).replace(num_layers=MOE["layers"])
        model = moe.init(0, mcfg, dev)
        tokens = torch.from_numpy(np.random.RandomState(7).randint(
            0, mcfg.vocab_size, (MOE["batch"], MOE["prompt"])).astype(np.int32)).to(dev)
        fm.reset_launches()
        ref_logits, _ = moe.prefill(model, mcfg, {"tokens": tokens})
        moe_ref_launches = fm.flash_attention.launches
        leaves = leaf_params(model)
        del model
        mode = serve_mode_for(mcfg, mesh)
        mp = distribute(leaves, params_shardings(leaves, mesh, mode))
        mb = distribute({"tokens": tokens}, batch_sharding({"tokens": tokens}, mesh))
        fm.reset_launches()
        ep_calls, real_ep = [0], moe._routed_ep

        def counted_ep(*args, **kw):  # a counter: a mock would keep every call's tensors
            ep_calls[0] += 1
            return real_ep(*args, **kw)

        with ctx.use_mesh(mesh, ep=True), mock.patch.object(moe, "_routed_ep", counted_ep):
            sync(dev)
            t0 = time.perf_counter()
            logits, _ = apply_with_leaves(mcfg, "prefill", mp, mb)
            sync(dev)
            moe_ms = (time.perf_counter() - t0) * 1e3
        moe_launches = fm.flash_attention.launches
        logits = logits.full_tensor()
        moe_err = float((logits - ref_logits).abs().max())
        check(ep_calls[0] == mcfg.num_layers,
              f"mesh_path: moe_apply_ep ran {ep_calls[0]} times in "
              f"{mcfg.num_layers} layers")
        check(moe_launches == moe_ref_launches == mcfg.num_layers,
              f"mesh_path: {moe_launches} flash launches in the sharded prefill, "
              f"{moe_ref_launches} unsharded")
        check(moe_err <= PREFILL_TOL, f"mesh_path: the ep prefill's logits differ by {moe_err}")
        del mp, mb, leaves, logits, ref_logits
        torch.cuda.empty_cache()

        # a dense decode step over a cache laid out by cache_sharding
        model = transformer.init(0, cfg, dev)
        prompt = batch["tokens"]
        _, cache = transformer.prefill(model, cfg, {"tokens": prompt})
        cache = pad_cache(cache, 1)
        nxt = prompt[:, -1]
        ref_cache = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in cache.items()}
        ref_dec, _ = transformer.decode_step(model, cfg, ref_cache, nxt)
        leaves = leaf_params(model)
        del model, ref_cache
        dp = distribute(leaves, params_shardings(leaves, mesh, serve_mode_for(cfg, mesh)))
        dc = distribute(cache, cache_sharding(cache, mesh))
        dt = distribute({"tokens": nxt}, batch_sharding({"tokens": nxt}, mesh))["tokens"]
        with ctx.use_mesh(mesh):
            sync(dev)
            t0 = time.perf_counter()
            dec, dc = apply_with_leaves(cfg, "decode_step", dp, dc, dt)
            sync(dev)
            dec_ms = (time.perf_counter() - t0) * 1e3
        dec_err = float((dec.full_tensor() - ref_dec).abs().max())
        check(dec_err <= DECODE_TOL, f"mesh_path: the sharded decode's logits differ by {dec_err}")
        check(dc["pos"] == TRAIN["seq"] + 1, f"mesh_path: decode position {dc['pos']}")
        del dp, dc, dt, dec, cache, leaves
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    out = dict(mesh=[1, 1], arch=cfg.name, layers=cfg.num_layers, batch=TRAIN["batch"],
               seq=TRAIN["seq"], accum_steps=cfg.accum_steps, steps=MESH_TRAIN_STEPS,
               losses=losses, unsharded_losses=ref_losses, loss_max_abs_diff=loss_err,
               params=params_err, step_ms=step_ms, train_path_warm_step_ms=train["warm_step_ms"],
               peak_bytes=peak, peak_gib=peak / 2**30, argument_bytes=arg_bytes,
               allocated_gib_at_start=allocated_at_start / 2**30,
               launches=fwd, backward_launches=bwd, route_launches=fwd_routes,
               backward_route_launches=bwd_routes, train_path_launches_a_step=list(per_step),
               moe=dict(arch=mcfg.name, layers=mcfg.num_layers, ep_calls=ep_calls[0],
                        logits_max_abs_diff=moe_err, ms=moe_ms, launches=moe_launches),
               decode=dict(logits_max_abs_diff=dec_err, ms=dec_ms),
               seconds=time.perf_counter() - t_phase)
    emit("mesh_path", **out)
    return out


def run_dryrun_cells(mesh: dict) -> dict:
    """Phase dryrun_cells: the port's dry run (``launch.dryrun.run_cell``, as
    ``python -m repro_torch.launch.dryrun`` runs it) in a subprocess, its
    fake worlds its own: the two production cells of DRYRUN_CELLS on (16,
    16), then mesh_path's own cell on (1, 1), traced in full and
    extrapolated from shorter traces: its argument bytes equal to
    mesh_path's params, optimizer state and batch, and its peak estimate
    beside mesh_path's measured peak."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        proc = subprocess.run([sys.executable, "-c", DRYRUN_SCRIPT, json.dumps(DRYRUN_CELLS),
                               tmp], capture_output=True, text=True, cwd=ROOT, timeout=600,
                              env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src"),
                                   "CUDA_VISIBLE_DEVICES": ""})
    check(proc.returncode == 0, f"dryrun_cells: the dry run failed: {proc.stderr[-2000:]}")
    recs = [json.loads(ln[7:]) for ln in proc.stdout.splitlines() if ln.startswith("RECORD ")]
    check(len(recs) == len(DRYRUN_CELLS),
          f"dryrun_cells: {len(recs)} records for {len(DRYRUN_CELLS)} cells")
    rows = []
    for rec in recs:
        check(rec["status"] == "ok", f"dryrun_cells: {rec['arch']} x {rec['shape']}: "
              f"{rec.get('error')} {rec.get('trace', '')[-800:]}")
        m, c, r = rec["memory"], rec["costs"], rec["roofline"]
        check(c["flops_per_device"] > 0 and 0 < r["useful_flops_ratio"] <= 1.5,
              f"dryrun_cells: {rec['arch']} x {rec['shape']}: {r}")
        rows.append(dict(arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
                         traced=rec["traced"], argument_bytes=m["argument_bytes_per_device"],
                         high_water_bytes=m["high_water_bytes_per_device"],
                         peak_estimate_bytes=m["peak_estimate_bytes_per_device"],
                         flops=c["flops_per_device"], hbm_bytes=c["hbm_bytes_per_device"],
                         collective_bytes=c["collective_bytes_per_device"],
                         kernel_calls=c["kernel_calls"],
                         t_compute_s=r["t_compute_s"], t_memory_s=r["t_memory_s"],
                         t_collective_s=r["t_collective_s"], dominant=r["dominant"],
                         useful_flops_ratio=r["useful_flops_ratio"],
                         roofline_fraction=r["roofline_fraction"], seconds=rec["seconds"]))
    full, extra = rows[-2], rows[-1]
    check(full["argument_bytes"] == mesh["argument_bytes"],
          f"dryrun_cells: the (1, 1) cell's argument bytes {full['argument_bytes']} are not "
          f"mesh_path's {mesh['argument_bytes']}")
    check(full["kernel_calls"].get("flash_attention") == mesh["launches"] // MESH_TRAIN_STEPS,
          f"dryrun_cells: the (1, 1) cell calls flash {full['kernel_calls']}, mesh_path "
          f"launches {mesh['launches'] // MESH_TRAIN_STEPS} a step")
    out = dict(cells=rows[:-2], own_cell=full, own_cell_extrapolated=extra,
               extrapolation_rel_err={k: abs(extra[k] - full[k]) / max(full[k], 1.0)
                                      for k in ("flops", "hbm_bytes", "high_water_bytes")},
               peak_estimate_over_measured=full["peak_estimate_bytes"] / mesh["peak_bytes"],
               measured_peak_bytes=mesh["peak_bytes"], seconds=time.perf_counter() - t_phase)
    emit("dryrun_cells", **out)
    return out


def run_cascade_dryrun(dev) -> dict:
    """Phase cascade_dryrun: ``dryrun --proxy-kind mixed`` on the card: every
    stage on ``cascade_score``, at most 3 disagreements with the reference
    executor, and its launches counted."""
    from repro_torch.kernels import proxy_score
    from repro_torch.launch.dryrun import cascade_report

    t_phase = time.perf_counter()
    proxy_score.cascade_score.launches = 0
    with contextlib.redirect_stdout(__import__("io").StringIO()):
        rep = cascade_report("mixed", device=dev)
    sync(dev)
    launches = proxy_score.cascade_score.launches
    check(rep["ok"], f"cascade_dryrun: {rep}")
    check(launches > 0, "cascade_dryrun: no cascade_score launch")
    out = dict(rep, launches=launches, seconds=time.perf_counter() - t_phase)
    emit("cascade_dryrun", **out)
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
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention, proxy_score, ssd_scan, threefry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)

    t0 = time.perf_counter()
    libs = _build.build_all(["cascade_score", "flash_attention", "flash_attention_bwd",
                             "ssd_chunk", "ssd_chunk_bwd", "threefry"])
    threefry._lib()
    proxy_score._lib()
    flash_attention._lib()
    flash_attention._bwd_lib()
    ssd_scan._lib()
    ssd_scan._bwd_lib()
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
    threefry_run = run_threefry_kernels(dev)

    plans, stream, launches, outcomes = run_main_path(dev, args.stream_records)
    timings = time_main_shapes(plans, stream, dev, iters=200)
    profile_main_path(plans, stream, dev)
    main_row = max(timings, key=lambda r: r["flops"])
    artifacts = run_artifact_path(dev, plans, stream, outcomes)
    del stream, outcomes

    flash_errs, flash_routes = [], []
    t0 = time.perf_counter()
    split_check = check_split_bf16(dev)
    splits = 0
    for i, case in enumerate(FLASH_CASES):
        before = dict(flash_attention.flash_attention.route_launches)
        before_split = flash_attention.split_bf16.launches
        flash_errs.append(check_flash_case(case, dev, seed=i))
        flash_routes.append(route_taken(flash_attention.flash_attention, before))
        want = flash_attention.route_for(case[5], getattr(torch, case[7]), route_shape(case))
        check(flash_routes[-1] == want, f"{case}: took the {flash_routes[-1]} route, not {want}")
        n_split = flash_attention.split_bf16.launches - before_split
        check(n_split == 2 * (case[7] == "float32"),
              f"{case}: {n_split} split_bf16 launches (K and V: 2 an f32 call)")
        splits += n_split
    faults = [planted_fault(dev, dt) for dt in ("bfloat16", "float32")]
    faults.append(planted_fault(dev, "float32", shape=VLM_SHAPE))
    repeat = flash_repeat(dev)
    packed_repeat = flash_repeat(dev, PACKED_REPEAT_SHAPE, "bfloat16")
    isolation = [packed_isolation(dev, shape) for shape in ISOLATION_SHAPES]
    torch.cuda.empty_cache()
    emit("flash_kernels", cases=len(FLASH_CASES), seconds=time.perf_counter() - t0,
         max_abs_err={dt: max(e[0] for c, e in zip(FLASH_CASES, flash_errs) if c[7] == dt)
                      for dt in FLASH_TOL},
         max_row_err={dt: max(e[1] for c, e in zip(FLASH_CASES, flash_errs) if c[7] == dt)
                      for dt in FLASH_TOL},
         tol=FLASH_TOL, row_tol=FLASH_ROW_TOL, planted_fault=faults[0],
         planted_faults_f32=faults[1], planted_faults_f32_d256=faults[2],
         repeat_f32_d256=repeat, repeat_packed=packed_repeat, packed_isolation=isolation,
         split_bf16=split_check, split_bf16_launches=splits,
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
    one_pass_faults = [ssd_one_pass_faults(dev, dt) for dt in ("bfloat16", "float32")]
    ssd_repeats = [ssd_repeat(dev, dt) for dt in ("bfloat16", "float32")]
    for c, e in zip(SSD_CASES, ssd_errs):
        want = ssd_route_rule(c)
        check(e["route"] == want, f"{c}: took the {e['route']} route, not {want}")
    emit("ssd_kernels", cases=len(SSD_CASES), seconds=time.perf_counter() - t0,
         max_y_diag_rel={dt: max(e["y_diag_rel"] for c, e in zip(SSD_CASES, ssd_errs)
                                 if c[7] == dt) for dt in ("float32", "bfloat16")},
         max_states_rel={dt: max(e["states_rel"] for c, e in zip(SSD_CASES, ssd_errs)
                                 if c[7] == dt) for dt in ("float32", "bfloat16")},
         max_chunk_decay_rel=max(e["chunk_decay_rel"] for e in ssd_errs), tol=SSD_TOL,
         decay_tol=DECAY_TOL, planted_fault=ssd_faults[0], planted_faults_f32=ssd_faults[1],
         one_pass_faults=one_pass_faults, repeat_reduced=ssd_repeats,
         cases_by_route={dt: {r: sum(c[7] == dt and e["route"] == r
                                     for c, e in zip(SSD_CASES, ssd_errs))
                              for r in ssd_scan.ROUTES} for dt in ("float32", "bfloat16")},
         padded_cases=sum(e["route"] == "tensor_cores" and (c[4] not in ssd_scan.TC_P
                                                            or c[5] not in ssd_scan.TC_N)
                          for c, e in zip(SSD_CASES, ssd_errs)),
         cases_detail=[dict(case=list(c), **e) for c, e in zip(SSD_CASES, ssd_errs)])
    torch.cuda.empty_cache()

    ssm = run_ssm_path(dev, SSM["layers"], SSM["batch"], SSM["prompt"], SSM["new_tokens"])
    profile_ssm(ssm, dev)
    del ssm["model"], ssm["tokens"]
    torch.cuda.empty_cache()
    ssd_rows = {dt: time_ssd(dev, dt, iters=10) for dt in ("bfloat16", "float32")}
    ssd_rows_reduced = {dt: time_ssd(dev, dt, iters=100, shape=SSD_REDUCED_SHAPE)
                        for dt in ("bfloat16", "float32")}
    check(all(isinstance(r["kernel"]["device_us_a_call"], float)
              for r in ssd_rows_reduced.values()),
          "the reduced ssd_timing rows' device µs were not measured")
    ssd_row, ssd32_row = ssd_rows["bfloat16"], ssd_rows["float32"]
    flash32_row = flash_rows["float32"]
    torch.cuda.empty_cache()
    ssd_bwd = run_ssd_bwd_kernels(dev)

    moe = run_model_path(dev, MOE, "moe_path")
    torch.cuda.empty_cache()
    mla = run_model_path(dev, MLA, "mla_path")
    torch.cuda.empty_cache()
    vlm = run_model_path(dev, VLM, "vlm_path")
    torch.cuda.empty_cache()
    vlm_row = time_flash(dev, "bfloat16", iters=3, shape=VLM_SHAPE)
    vlm32_row = time_flash(dev, "float32", iters=2, shape=VLM_SHAPE)
    torch.cuda.empty_cache()
    bwd = run_flash_bwd_kernels(dev)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        train = run_train_path(dev, Path(tmp))
    torch.cuda.empty_cache()
    ssm_train = run_ssm_train_path(dev)
    torch.cuda.empty_cache()
    encdec = run_model_path(dev, ENCDEC, "encdec_path")
    torch.cuda.empty_cache()
    hybrid = run_model_path(dev, HYBRID, "hybrid_path")
    torch.cuda.empty_cache()

    serving = run_serving_path(dev, args.serving_records)
    workload = serving.pop("workload")
    multiquery = run_multiquery_path(dev, workload, args.multiquery_records)
    tuned = run_autotune(dev, plans, {"serving_path": serving.pop("autotune_case"),
                                      "multiquery_path": multiquery.pop("autotune_case")},
                         serving, smi)
    del plans
    frontend = run_frontend_path(dev, workload, args.frontend_records)
    plan_cache = run_plan_cache_path(dev, workload, args.plan_cache_records)
    fleet = run_fleet_path(dev, workload, args.fleet_records)
    fleet_thread = run_fleet_thread(dev, fleet["fleet"], fleet.pop("run"))
    fleet_process = run_fleet_process(dev, workload, fleet["fleet"], args.fleet_records // 8)
    fleet_faults = run_fleet_faults(dev, workload, fleet["fleet"], args.fleet_records // 4)
    del workload, fleet["fleet"]
    torch.cuda.empty_cache()
    udf = run_udf_path(dev, True, "udf_path")
    udf_reduced = run_udf_path(dev, False, "udf_path_reduced")
    udf_rows = run_udf_timing(dev)
    video = run_video_cascade_path(dev)
    resilient = run_resilient_path(dev)
    torch.cuda.empty_cache()
    mesh = run_mesh_path(dev, train)
    torch.cuda.empty_cache()
    dryrun_cells = run_dryrun_cells(mesh)
    cascade_dry = run_cascade_dryrun(dev)
    emit("script", seconds=time.perf_counter() - t_script)
    udf_fwd, udf_bwd = udf_rows["H128"]["forward"], udf_rows["H128"]["backward"]
    res_ssm = resilient["mamba2-2.7b"]
    ssd_bwd_runs = {  # path: (backward launches, by route, the type they ran in)
        "ssm_train_path": (ssm_train["backward_launches"], ssm_train["backward_route_launches"],
                           "bfloat16"),
        "ssm_train_f32_check": (ssm_train["float32"]["backward_launches"],
                                ssm_train["float32"]["backward_route_launches"], "float32"),
        "resilient_path": (res_ssm["launches"]["ssd_chunk_backward"],
                           res_ssm["backward_route_launches"], res_ssm["dtype"])}

    def ssd_bwd_launches(dtype, route):
        """The ssd_chunk backward's launches in ``dtype`` on ``route``, by
        path, and its launches in ``dtype`` by route."""
        runs = {p: r for p, (_n, r, t) in ssd_bwd_runs.items() if t == dtype}
        return {"launches": sum(r[route] for r in runs.values()),
                "launches_by_route": {k: sum(r[k] for r in runs.values())
                                      for k in ssd_scan.ROUTES},
                "launches_by_path": {p: r[route] for p, r in runs.items() if r[route]}}

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
                             "fleet_faults": fleet_faults["launches"],
                             "udf_path": udf["cascade_score_launches"],
                             "udf_path_reduced": udf_reduced["cascade_score_launches"],
                             "video_cascade_path": video["launches"],
                             "cascade_dryrun": cascade_dry["launches"]},
        "tuned_block_m": {r["path"]: r["tuned_block_m"] for r in tuned["shapes"]},
        "serving_shapes": [{k: r[k] for k in ("shape", "N", "F", "HP", "P", "ms", "plain_ms",
                                              "bound_ms", "bound_by", "max_abs_err")}
                           for r in (serving["timing"], multiquery["timing"])],
        "max_abs_err": max(errs + [main_row["max_abs_err"], serving["timing"]["max_abs_err"],
                                   multiquery["timing"]["max_abs_err"]]),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None}, {
        "name": "threefry", "route": "cuda", "kernel_route": "cuda_cores",
        "dtype": "bfloat16", "shape": threefry_run["timing"]["shape"],
        "source": "src/repro_torch/kernels/csrc/threefry.cu",
        "replaces": "none: port-only (jax.random's threefry2x32 is an XLA primitive, "
                    "not a Pallas kernel)",
        "note": "every model weight and batch draw on the card; launches: udf_path's two "
                "initial UDF trees at published widths",
        "launches": udf["threefry_launches"],
        "launches_by_path": {"udf_path": udf["threefry_launches"],
                             "udf_path_reduced": udf_reduced["threefry_launches"],
                             "dense_path": dense["threefry_launches"],
                             "dense_path_float32": dense32["threefry_launches"],
                             "ssm_path": ssm["threefry_launches"], "moe_path": moe["threefry_launches"],
                             "mla_path": mla["threefry_launches"],
                             "vlm_path": vlm["threefry_launches"],
                             "encdec_path": encdec["threefry_launches"],
                             "hybrid_path": hybrid["threefry_launches"],
                             "threefry_kernels[families]": sum(
                                 f["launches"] for f in threefry_run["families"])},
        "max_abs_err": threefry_run["max_abs_err"], "max_err_is": threefry_run["max_err_is"],
        **{k: threefry_run["timing"][k] for k in ("ms", "plain_ms", "plain_shape",
                                                  "kernel_ms_at_plain_shape", "bound_ms",
                                                  "bound_by", "bytes_bound_ms",
                                                  "int32_ops_bound_ms", "library_ms",
                                                  "trunc_normal_ms")}}, {
        "name": "flash_attention", "route": "cuda", "kernel_route": "tensor_cores",
        "dtype": "bfloat16",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:62",
        "launches": dense["launches"],
        "launches_by_path": {"dense_path": dense["launches"], "moe_path": moe["launches"],
                             "mla_path": mla["launches"], "vlm_path": vlm["launches"],
                             "train_path": train["launches"],
                             "mesh_path": mesh["launches"],
                             "mesh_path_moe": mesh["moe"]["launches"],
                             "encdec_path": encdec["launches"],
                             "hybrid_path": hybrid["launches"], "udf_path": udf["launches"],
                             "udf_path_reduced": udf_reduced["launches"],
                             "resilient_path": resilient["deepseek-67b"]["launches"][
                                 "flash_attention"]},
        "max_abs_err": max([e for (e, _), c in zip(flash_errs, FLASH_CASES)
                            if c[7] == "bfloat16"] + [dense["attention_max_abs_err"],
                                                      moe["attention_max_abs_err"]]),
        "ms": flash_row["ms"], "plain_ms": flash_row["plain_ms"],
        "bound_ms": flash_row["bound_ms"], "bound_by": flash_row["bound_by"],
        "library_ms": flash_row["library_ms"]}, {
        "name": "flash_attention[packed]", "route": "cuda", "kernel_route": udf_fwd["route"],
        "kernel": udf_fwd["kernel"], "dtype": "bfloat16", "shape": list(UDF_SHAPES[0]),
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:62",
        "note": "short sequences: udf_path's 2,000 records of 8 tokens at llama3-405b's heads",
        "launches": udf["route_launches"]["packed"],
        "launches_by_path": {"udf_path": udf["route_launches"]["packed"],
                             "udf_path_reduced": udf_reduced["route_launches"]["packed"],
                             "resilient_path": resilient["deepseek-67b"]["launches"][
                                 "flash_attention"]},
        "max_abs_err": max([e for st in udf["first_step"] for e, _ in st["attention"]]
                           + [e for (e, _), c in zip(flash_errs, FLASH_CASES)
                              if c[:6] in PACKED_SHAPES]),
        "ms": udf_fwd["ms"], "plain_ms": udf_fwd["plain_ms"],
        "bound_ms": udf_fwd["bound_ms"], "bound_by": udf_fwd["bound_by"],
        "library_ms": udf_fwd["library_ms"],
        **{name: {k: udf_rows[key]["forward"][k]
                  for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
           for name, key in (("qwen3_moe_shape", "H32"), ("reduced_shape", "D16"))}}, {
        "name": "flash_attention[D256]", "route": "cuda", "kernel_route": "tensor_cores",
        "dtype": "bfloat16", "shape": list(VLM_SHAPE),
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:62",
        "launches": vlm["launches"],
        "max_abs_err": vlm["attention_max_abs_err"],
        "ms": vlm_row["ms"], "plain_ms": vlm_row["plain_ms"],
        "bound_ms": vlm_row["bound_ms"], "bound_by": vlm_row["bound_by"],
        "library_ms": vlm_row["library_ms"]}, {
        "name": "flash_attention[float32,D256]", "route": "cuda",
        "kernel_route": vlm32_row["route"], "dtype": "float32", "shape": list(VLM_SHAPE),
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:62",
        "launches": vlm["float32_route_launches"][vlm32_row["route"]],
        "max_abs_err": max(e for (e, _), c in zip(flash_errs, FLASH_CASES)
                           if c[7] == "float32" and c[5] == 256),
        "ms": vlm32_row["ms"], "plain_ms": vlm32_row["plain_ms"],
        "bound_ms": vlm32_row["bound_ms"], "bound_by": vlm32_row["bound_by"],
        "library_ms": vlm32_row["library_ms"]}, {
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
        "launches_by_path": {"ssm_path": ssm["launches"],
                             "ssm_train_path": ssm_train["launches"]},
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
        "library_ms": None}, {
        "name": "ssd_chunk[one_pass]", "route": "cuda",
        "kernel_route": ssd_rows_reduced["bfloat16"]["route"],
        "kernel": ssd_rows_reduced["bfloat16"]["kernel"]["entry"],
        "dtype": "bfloat16", "shape": list(SSD_REDUCED_SHAPE),
        "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:44",
        "note": "the forward at chunks of at most 32 tokens off the wgmma shapes, one "
                "mma.sync launch: the reduced mamba2's (resilient_path)",
        "launches": res_ssm["forward_route_launches"]["one_pass"],
        "launches_by_path": {"resilient_path": res_ssm["forward_route_launches"]["one_pass"]},
        "max_abs_err": max([max(e["y_diag"], e["states"]) for e in ssd_errs
                            if e["route"] == "one_pass"]
                           + [r["max_abs_err"] for r in ssd_rows_reduced.values()]),
        **{k: ssd_rows_reduced["bfloat16"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "device_us_a_call": ssd_rows_reduced["bfloat16"]["kernel"]["device_us_a_call"],
        "float32": {k: ssd_rows_reduced["float32"][k] for k in ("route", "ms", "plain_ms",
                                                                "bound_ms", "bound_by")},
        "library_ms": None}, {
        "name": "ssd_chunk_backward[one_pass]", "route": "cuda",
        "kernel_route": ssd_bwd["rows_reduced"]["bfloat16"]["route"],
        "kernels": list(ssd_bwd["rows_reduced"]["bfloat16"]["kernels"]),
        "dtype": "bfloat16", "shape": list(SSD_REDUCED_SHAPE),
        "source": "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:44",
        "note": "the gradient of that kernel at chunks of at most 32 tokens off the wgmma "
                "shapes, one launch: the reduced mamba2's (resilient_path)",
        **ssd_bwd_launches("bfloat16", "one_pass"),
        "max_abs_err": ssd_bwd["max_err_one_pass"],
        "max_err_is": "of each gradient's largest value",
        **{k: ssd_bwd["rows_reduced"]["bfloat16"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "cuda_core_bound_ms")},
        "float32": {k: ssd_bwd["rows_reduced"]["float32"][k]
                    for k in ("route", "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None}, {
        "name": "ssd_chunk_backward", "route": "cuda", "kernel_route": ssd_bwd["row"]["route"],
        "dtype": "bfloat16", "shape": list(SSD_TRAIN_SHAPE),
        "source": "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:44",
        "note": "the gradient of that kernel; the JAX package has no backward kernel",
        **ssd_bwd_launches("bfloat16", "tensor_cores"),
        "max_abs_err": max([ssd_bwd["max_err"]] + [max(e.values())
                                                   for e in ssm_train["layer_bwd_errors"]]),
        "max_err_is": "of each gradient's largest value",
        "ms": ssd_bwd["row"]["ms"], "plain_ms": ssd_bwd["row"]["plain_ms"],
        "bound_ms": ssd_bwd["row"]["bound_ms"], "bound_by": ssd_bwd["row"]["bound_by"],
        "cuda_core_bound_ms": ssd_bwd["row"]["cuda_core_bound_ms"],
        "library_ms": None}, {
        "name": "ssd_chunk_backward[float32]", "route": "cuda",
        "kernel_route": ssd_bwd["row_float32"]["route"],
        "kernels": list(ssd_bwd["row_float32"]["kernels"]),
        "dtype": "float32", "shape": list(SSD_TRAIN_SHAPE),
        "source": "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:44",
        "note": "the gradient of that kernel in f32",
        **ssd_bwd_launches("float32", "tensor_cores"),
        "max_abs_err": max(max(ssd_bwd["row_float32"]["max_err"].values()),
                           ssd_bwd["max_err_float32"], ssm_train["float32"]["grad_rel_err"]),
        "max_err_is": "of each gradient's largest value",
        "ms": ssd_bwd["row_float32"]["ms"], "plain_ms": ssd_bwd["row_float32"]["plain_ms"],
        "bound_ms": ssd_bwd["row_float32"]["bound_ms"],
        "bound_by": ssd_bwd["row_float32"]["bound_by"],
        "cuda_core_bound_ms": ssd_bwd["row_float32"]["cuda_core_bound_ms"],
        "library_ms": None}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "kernel_route": bwd["rows"]["bfloat16"]["route"],
        "dtype": "bfloat16", "shape": list(BWD_SERVING_SHAPE),
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:62",
        "note": "the gradient of that kernel; the JAX package has no backward kernel",
        "launches": train["backward_launches"],
        "launches_by_route": {r: train["backward_route_launches"][r]
                              + sum(s["backward_route_launches"][r]
                                    for s in train["side_steps"].values())
                              for r in train["backward_route_launches"]},
        "launches_by_path": {"train_path": train["backward_launches"],
                             "mesh_path": mesh["backward_launches"],
                             **{a: s["backward_launches"]
                                for a, s in train["side_steps"].items()}},
        "max_abs_err": max([bwd["max_err"]] + [max(e) for e in train["layer_bwd_errors"]]),
        "max_err_is": "of each gradient's largest value",
        "ms": bwd["rows"]["bfloat16"]["ms"], "plain_ms": bwd["rows"]["bfloat16"]["plain_ms"],
        "bound_ms": bwd["rows"]["bfloat16"]["bound_ms"], "bound_by": bwd["rows"]["bfloat16"]["bound_by"],
        "library_ms": bwd["rows"]["bfloat16"]["library_ms"]}, {
        "name": "flash_attention_bwd[D256]", "route": "cuda",
        "kernel_route": bwd["rows"]["D256"]["route"],
        "dtype": "bfloat16", "shape": list(VLM_SHAPE),
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:62",
        "note": "the gradient of that kernel at paligemma's shape",
        "launches": train["side_steps"]["paligemma-3b"]["backward_launches"],
        "max_abs_err": bwd["rows"]["D256"]["max_err"],
        "max_err_is": "of each gradient's largest value",
        "ms": bwd["rows"]["D256"]["ms"], "plain_ms": bwd["rows"]["D256"]["plain_ms"],
        "bound_ms": bwd["rows"]["D256"]["bound_ms"], "bound_by": bwd["rows"]["D256"]["bound_by"],
        "library_ms": bwd["rows"]["D256"]["library_ms"]}, {
        "name": "flash_attention_bwd[packed]", "route": "cuda",
        "kernel_route": udf_bwd["route"], "kernel": udf_bwd["resources"]["packed"]["kernel"],
        "dtype": "bfloat16", "shape": list(UDF_SHAPES[0]),
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:62",
        "note": "one pass for short sequences: udf_path's training steps, 2,000 records of "
                "8 tokens at llama3-405b's heads",
        "launches": udf["backward_route_launches"]["packed"],
        "launches_by_path": {
            "udf_path": udf["backward_route_launches"]["packed"],
            "udf_path_reduced": udf_reduced["backward_route_launches"]["packed"],
            "resilient_path": resilient["deepseek-67b"]["launches"]["flash_attention_backward"]},
        "max_abs_err": max([max(e) for st in udf["first_step"] for e in st["backward"]]
                           + [max(r["backward_errors"]) for r in isolation]),
        "max_err_is": "of each gradient's largest value",
        "ms": udf_bwd["ms"], "plain_ms": udf_bwd["plain_ms"],
        "bound_ms": udf_bwd["bound_ms"], "bound_by": udf_bwd["bound_by"],
        "library_ms": udf_bwd["library_ms"],
        **{name: {k: udf_rows[key]["backward"][k]
                  for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
           for name, key in (("qwen3_moe_shape", "H32"), ("reduced_shape", "D16"))}}, {
        "name": "flash_attention_bwd[float32]", "route": "cuda",
        "kernel_route": bwd["rows"]["float32"]["route"],
        "dtype": "float32", "shape": list(BWD_SERVING_SHAPE),
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:62",
        "note": "the gradient of that kernel in f32",
        "launches": train["float32"]["deepseek-67b"]["backward_launches"],
        "launches_by_route": train["float32"]["deepseek-67b"]["backward_route_launches"],
        "split_bf16_launches": train["float32"]["deepseek-67b"]["split_bf16_launches"],
        "max_abs_err": bwd["rows"]["float32"]["max_err"],
        "max_err_is": "of each gradient's largest value",
        "ms": bwd["rows"]["float32"]["ms"], "plain_ms": bwd["rows"]["float32"]["plain_ms"],
        "bound_ms": bwd["rows"]["float32"]["bound_ms"], "bound_by": bwd["rows"]["float32"]["bound_by"],
        "cuda_core_bound_ms": bwd["rows"]["float32"]["cuda_core_bound_ms"],
        "library_ms": bwd["rows"]["float32"]["library_ms"]}, {
        "name": "flash_attention_bwd[float32_D256]", "route": "cuda",
        "kernel_route": bwd["rows"]["float32_D256"]["route"],
        "kernels": [v["kernel"] for v in bwd["rows"]["float32_D256"]["ptxas"].values()],
        "dtype": "float32", "shape": list(VLM_SHAPE),
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:62",
        "note": "the gradient of that kernel in f32 at paligemma's head dim 256",
        "launches": train["float32"]["paligemma-3b"]["backward_launches"],
        "launches_by_route": train["float32"]["paligemma-3b"]["backward_route_launches"],
        "launches_by_path": {
            "train_f32_check[paligemma-3b]": train["float32"]["paligemma-3b"]["backward_launches"]},
        "split_bf16_launches": train["float32"]["paligemma-3b"]["split_bf16_launches"],
        "max_abs_err": max([bwd["rows"]["float32_D256"]["max_err"],
                            train["float32"]["paligemma-3b"]["grad_rel_err"]]
                           + bwd["max_err_float32_D256"]),
        "max_err_is": "of each gradient's largest value",
        "ms": bwd["rows"]["float32_D256"]["ms"], "plain_ms": bwd["rows"]["float32_D256"]["plain_ms"],
        "bound_ms": bwd["rows"]["float32_D256"]["bound_ms"],
        "bound_by": bwd["rows"]["float32_D256"]["bound_by"],
        "cuda_core_bound_ms": bwd["rows"]["float32_D256"]["cuda_core_bound_ms"],
        "library_ms": bwd["rows"]["float32_D256"]["library_ms"]}, {
        "name": "flash_attention_bwd[D16]", "route": "cuda",
        "kernel_route": bwd["rows"]["reduced_bfloat16"]["route"],
        "dtype": "bfloat16", "shape": list(BWD_REDUCED_SHAPE),
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:62",
        "note": "the gradient of that kernel at the restart check's reduced config (D 16 on "
                "the tensor cores since PR 31)",
        "kernels": [v["kernel"] for v in bwd["rows"]["reduced_bfloat16"]["ptxas"].values()],
        "launches": train["restart"]["backward_route_launches"]["tensor_cores"],
        "launches_by_route": train["restart"]["backward_route_launches"],
        "launches_by_path": {
            "train_path_restart": train["restart"]["backward_route_launches"]["tensor_cores"]},
        "max_abs_err": max(bwd["rows"]["reduced_bfloat16"]["max_err"],
                           bwd["rows"]["reduced_float32"]["max_err"]),
        "max_err_is": "of each gradient's largest value",
        **{k: bwd["rows"]["reduced_bfloat16"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "float32": {k: bwd["rows"]["reduced_float32"][k]
                    for k in ("route", "ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")}}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
