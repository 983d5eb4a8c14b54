#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py [--stream-records N]

Needs one CUDA card; exits non-zero without one, and when any phase fails.
Each phase prints one JSON line:

1. device   — torch / CUDA versions, card name, power limit; kernel build.
2. kernels  — the CUDA ``cascade_score`` against its plain PyTorch version
              on the card over ragged shapes, both weight types and every
              output option.
3. main_path — the port's optimize-and-execute path at the ``twitter``
              profile's full width (F=64, four UDFs of hidden 48 and depth
              2, a 5% optimization sample of 40,000 records) over a stream
              of 1,048,576 records, for two queries.
4. timing   — CUDA-event times of the kernel and its plain version at the
              main path's shapes, beside the card's bound for that work.

Then the card's name and power limit as ``nvidia-smi`` gives them, the
``{"kernels": [...]}`` summary, and ``{"ok": true, "device": {...}}`` last.
Weights are random (seeded); nothing is read from disk but the sources.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and fp32 on CUDA cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# kernel vs plain version: both IEEE fp32, summed in different orders
SCORE_TOL = 1e-5
# kernel path vs the raw-params reference path: the packed form folds the
# standardizer into the weights, a float32 reassociation
FOLD_TIE_TOL = 1e-4

TWITTER = dict(n=40_000, n_features=64, n_columns=4, correlation=0.9,
               feature_noise=1.1, label_noise=0.25, udf_hidden=48, udf_depth=2,
               udf_train_rows=3000, cost_scale={0: 1.0, 1: 3.0, 2: 0.3, 3: 1.5},
               declared_cost_ms=20.0, k_frac=0.05)
QUERIES = (  # (name, columns, selectivity, A, proxy kind, make_query seed)
    ("quickstart", [0, 1], 0.5, 0.9, "svm", 1),
    ("mixed3", [0, 1, 2], 0.5, 0.9, "mixed", 2),
)
# (N, n_valid, F, H, P, weights, with_scores, compact_cols)
KERNEL_CASES = (
    (1, 1, 64, 2, 1, "float32", True, None),
    (127, 127, 64, 32, 3, "float32", False, (0, 1, 2)),
    (8191, 8191, 128, 128, 3, "int8", True, (1,)),
    (8192, 5000, 64, 32, 3, "int8", False, None),
    (8192, 8192, 128, 2, 130, "float32", True, None),
    (8192, 8192, 64, 2, 2, "float32", False, (0,)),
    (8192, 8000, 64, 32, 1, "float32", True, (0,)),
    (4096, 4096, 128, 128, 130, "int8", True, (0, 64, 129)),
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

    N, n_valid, F, H, P, weights, _scores, _cols = case
    rng = np.random.RandomState(seed)
    packed = PackedCascade(
        w1=(rng.randn(F, H, P) / np.sqrt(F)).astype(np.float32),
        b1=(0.1 * rng.randn(H, P)).astype(np.float32),
        w2=(rng.randn(H, P) / np.sqrt(H)).astype(np.float32),
        b2=(0.1 * rng.randn(P)).astype(np.float32),
        hidden=(H,) * P, families=("mlp1",) * P)
    if weights == "int8":
        packed = quantize_cascade(packed, "int8")
    ops = [torch.from_numpy(a).to(dev) for a in cascade_kernel_operands(packed)]
    out_scale = (None if packed.out_scale is None
                 else torch.from_numpy(packed.out_scale).to(dev))
    x = torch.from_numpy(rng.randn(N, F).astype(np.float32)).to(dev)
    s, _m, _p, _c = cascade_score_plain(x, *ops, torch.zeros(P, device=dev), N,
                                        out_scale=out_scale, with_compaction=False)
    thr = s.median(dim=0).values.contiguous()
    return x, ops, thr, out_scale


def check_kernel_case(case, dev, seed=0) -> float:
    """Kernel vs plain version on the card.  Returns the max abs score
    error (0 when the case does not ask for scores).  Scores within
    rtol=atol=1e-5; masks equal except rows whose plain score lies within
    1e-5*max(1,|thr|) of the threshold; packed lists and counts exactly
    what the kernel's own mask implies."""
    from repro_torch.kernels.proxy_score import cascade_score, cascade_score_plain

    N, n_valid, F, H, P, weights, with_scores, cols = case
    x, (w1, b1, w2, b2), thr, out_scale = make_kernel_case(case, dev, seed)
    sk, mk, pk, ck = cascade_score(x, w1, b1, w2, b2, thr, n_valid, out_scale=out_scale,
                                   with_scores=with_scores, compact_cols=cols)
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
    plans = []
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
             proxy_gate_s=sum(s.proxy_ms for s in res.stages) / 1e3,
             udf_s=sum(s.udf_ms for s in res.stages) / 1e3,
             optimizer_stats=plan.meta["stats"])
    total = cascade_score.launches
    return plans, stream, total


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


def device_profile(fn, dev) -> dict:
    """Run ``fn`` once under ``torch.profiler``: host wall time, the summed
    device time of every kernel and copy it ran, and the busiest names."""
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
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "device_busy_share": busy_us / wall_us if wall_us else None,
            "device_events": sum(n for _, n in by_name.values()),
            "top": [{"name": k[:80], "us": t, "count": n} for k, (t, n) in top]}


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
    for name, plan in plans:
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
                         device_us_per_call=prof["device_busy_us"] / calls,
                         wall_us_per_call=prof["wall_us"] / calls))
        emit("timing", **rows[-1])
    return rows


def profile_main_path(plans, stream, dev, tiles: int = 16):
    """Device busy share of ``execute_plan`` over the stream's first tiles."""
    from repro_torch.core import execute_plan

    x = stream[:tiles * 8192]
    for name, plan in plans:
        execute_plan(plan, x[:8192], use_kernel=True, device=dev)  # warm
        prof = device_profile(lambda: execute_plan(plan, x, use_kernel=True, device=dev), dev)
        emit("main_path_profile", query=name, records=len(x), **prof)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="On-card smoke test of the PyTorch port.")
    ap.add_argument("--stream-records", type=int, default=1_048_576,
                    help="records in the executed stream (default 1,048,576 = 128 tiles)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import proxy_score

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)

    t0 = time.perf_counter()
    lib_path = _build.build("cascade_score")
    proxy_score._lib()
    log = lib_path.with_suffix(".log").read_text().splitlines()
    emit("build", seconds=time.perf_counter() - t0, library=lib_path.name,
         ptxas=[ln.strip() for ln in log if "registers" in ln or "spill" in ln])

    errs = []
    for i, case in enumerate(KERNEL_CASES):
        errs.append(check_kernel_case(case, dev, seed=i))
    emit("kernels", cases=len(KERNEL_CASES), max_abs_err=max(errs),
         shapes=[list(c[:5]) + [c[5]] for c in KERNEL_CASES])

    plans, stream, launches = run_main_path(dev, args.stream_records)
    timings = time_main_shapes(plans, stream, dev, iters=200)
    profile_main_path(plans, stream, dev)
    main_row = max(timings, key=lambda r: r["flops"])
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "cascade_score", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cascade_score.cu",
        "replaces": "src/repro/kernels/proxy_score.py:114",
        "launches": launches, "max_abs_err": max(errs + [main_row["max_abs_err"]]),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
