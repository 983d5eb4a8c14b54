"""Batched cascade executor.

Executes a PhysicalPlan over a record stream in fixed-size microbatches:
proxy scores gate each expensive UDF; survivors are compacted so the UDF
always processes dense batches.  Cost is accounted both as measured wall
time and via the per-record cost model (ms/record), which is what the
paper's figures report.

Proxy scoring paths, fastest first:

  * fused   — one ``CascadeScorer`` pass per microbatch scores EVERY
              proxied stage at once through the ``cascade_score`` kernel
              (on-device survivor compaction); later stages index the
              precomputed masks.
  * kernel  — one ``cascade_score`` call per stage (``proxy_score_batch``),
              kept for parity runs via ``fused=False``.
  * reference — the family's raw-params scorer (``use_kernel=False``, the
              parity/ablation oracle).

``StageStats.used_kernel`` records that the ``cascade_score`` wrapper
gated the stage.  On a CUDA device that wrapper launches the kernel; on
the CPU it runs the kernel's plain PyTorch version.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List

import numpy as np

from repro_torch.core.query import PhysicalPlan
from repro_torch.util import advisory_wall_ms, resolve_device



@dataclass
class StageStats:
    pred_idx: int
    n_in: int = 0
    n_proxy_kept: int = 0
    n_udf: int = 0
    n_pass: int = 0
    proxy_ms: float = 0.0
    udf_ms: float = 0.0
    used_kernel: bool = False  # True iff the cascade_score wrapper produced the gate

    @property
    def empirical_reduction(self) -> float:
        return 1.0 - self.n_proxy_kept / max(self.n_in, 1)


@dataclass
class ExecResult:
    passed: np.ndarray  # indices of records returned by the plan
    stages: List[StageStats]
    wall_ms: float
    model_cost_ms: float  # per-record cost model total (paper's metric)
    fused_score_ms: float = 0.0  # wall time in the fused whole-cascade pass

    def cost_per_record(self, n: int) -> float:
        return self.model_cost_ms / max(n, 1)

    @property
    def proxy_total_ms(self) -> float:
        """Total proxy-scoring wall time (fused pass + per-stage work)."""
        return self.fused_score_ms + sum(s.proxy_ms for s in self.stages)


def execute_plan(
    plan: PhysicalPlan,
    x: np.ndarray,
    *,
    batch_size: int = 8192,
    use_kernel: bool = False,
    fused: bool = True,
    device="cuda",
) -> ExecResult:
    """Run the cascade over ``x`` (N, F).  Returns passing record indices.

    ``use_kernel=True, fused=True`` takes the fused whole-cascade scorer
    on ``device``; ``fused=False`` keeps the one-call-per-stage path for
    parity and ablation runs.  ``device`` defaults to CUDA and raises
    without a card.
    """
    dev = resolve_device(device)
    n = x.shape[0]
    stages = [StageStats(pred_idx=s.pred_idx) for s in plan.stages]
    t_start = advisory_wall_ms()
    model_cost = 0.0
    fused_ms = 0.0
    passed: List[np.ndarray] = []

    scorer = None
    cascade = None
    compact_cols = None
    if use_kernel:
        from repro_torch.kernels import ops as kops

        scorer = functools.partial(kops.proxy_score_batch, device=dev)
        if fused:
            cascade = kops.CascadeScorer.from_plan(plan, max_tile=batch_size,
                                                   device=dev)
        if cascade is not None:
            # only the FIRST gated stage ever sees a full tile, so only its
            # packed survivor list is consumed — assemble just that column
            # instead of computing every stage's list and discarding most
            compact_cols = tuple(
                col for col in (
                    cascade.stage_cols[si]
                    for si, st_ in enumerate(plan.stages) if st_.proxy is not None
                ) if col is not None
            )[:1]

    for start in range(0, n, batch_size):
        stop = min(start + batch_size, n)
        idx = np.arange(start, stop)
        masks = packed = None
        if cascade is not None:
            t0 = advisory_wall_ms()
            # the tile as a view: the scorer copies it once, into its
            # (pinned) staging buffer
            _, masks, packed, _counts = cascade.score_compact(
                x[start:stop], compact_cols=compact_cols)
            fused_ms += advisory_wall_ms() - t0
        loc = np.arange(len(idx))  # tile-local survivor positions
        for si, stage in enumerate(plan.stages):
            st = stages[si]
            st.n_in += len(loc)
            if len(loc) == 0:
                continue
            if stage.proxy is not None:
                n_enter = len(loc)
                t0 = advisory_wall_ms()
                col = cascade.stage_cols[si] if cascade is not None else None
                if masks is not None and col is not None:
                    if len(loc) == len(idx) and packed[col] is not None:
                        # full tile: use the on-device-compacted index list
                        # (score_compact already truncated it to counts[col])
                        loc = packed[col]
                    else:
                        loc = loc[masks[loc, col]]
                    st.used_kernel = True
                elif scorer is not None:
                    keep = scorer(stage.proxy.params, x[idx[loc]], stage.threshold)
                    loc = loc[np.asarray(keep)]
                    st.used_kernel = True
                else:
                    keep = stage.proxy.score(x[idx[loc]]) >= stage.threshold
                    loc = loc[keep]
                st.proxy_ms += advisory_wall_ms() - t0
                model_cost += n_enter * stage.proxy.cost
            st.n_proxy_kept += len(loc)
            if len(loc) == 0:
                continue
            pred = plan.query.predicates[stage.pred_idx]
            alive = idx[loc]
            t0 = advisory_wall_ms()
            labels = pred.udf(x[alive])
            st.udf_ms += advisory_wall_ms() - t0
            model_cost += len(alive) * pred.udf.cost
            st.n_udf += len(alive)
            loc = loc[pred.evaluate(labels)]
            st.n_pass += len(loc)
        passed.append(idx[loc])

    return ExecResult(
        passed=np.concatenate(passed) if passed else np.empty(0, np.int64),
        stages=stages,
        wall_ms=advisory_wall_ms() - t_start,
        model_cost_ms=model_cost,
        fused_score_ms=fused_ms,
    )


def plan_accuracy(result: ExecResult, orig: ExecResult) -> float:
    """Fraction of the original query's output kept by the optimized plan
    (the paper's definition of A)."""
    orig_set = set(orig.passed.tolist())
    if not orig_set:
        return 1.0
    kept = sum(1 for i in result.passed.tolist() if i in orig_set)
    return kept / len(orig_set)
