"""Synthetic correlated record streams (Twitter / COCO / UCF101 stand-ins).

The experimental variable — predicate correlation — is planted explicitly:

* latent ``z ~ N(0, I_k)`` per record;
* features ``x = tanh(W z + eps)`` (the "unstructured content");
* each predicate column's ground truth is a quantized linear readout of z:
  ``y_j = digitize(w_j . z + eta)``.  Correlation between predicates i and j
  is controlled by the angle between w_i and w_j (shared latent directions).

Streams come from numpy ``RandomState``s and reproduce the JAX package's
bit for bit.  The expensive ML UDFs are small PyTorch MLPs trained on the
given device to predict y_j from x — the UDF output defines the predicate
truth at query time, as in the paper.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.query import MLUDF, Predicate, Query
from repro_torch.util import resolve_device


@dataclass
class Dataset:
    name: str
    x: np.ndarray  # (N, F) features
    truth: np.ndarray  # (N, K) ground-truth label columns (latent readouts)
    directions: np.ndarray  # (K, k) latent readout directions
    n_classes: Sequence[int]
    # generative parameters, kept so drifted continuations of the SAME
    # process can be sampled later (make_drifting_stream)
    w_feat: Optional[np.ndarray] = None  # (k, F) latent -> feature map
    quantiles: Optional[List[np.ndarray]] = None  # per-column class bounds
    feature_noise: float = 0.8
    label_noise: float = 0.1

    @property
    def n(self) -> int:
        return self.x.shape[0]


def make_dataset(
    name: str = "twitter",
    n: int = 50_000,
    n_features: int = 64,
    n_latent: int = 16,
    n_columns: int = 4,
    n_classes: int = 4,
    correlation: float = 0.8,
    label_noise: float = 0.1,
    feature_noise: float = 0.8,
    seed: int = 0,
) -> Dataset:
    """``correlation`` in [0,1]: cosine overlap between consecutive predicate
    readout directions (1.0 -> nearly identical latent factors).
    ``feature_noise`` controls how hard the proxy task is: the paper's linear
    SVMs on text features are imperfect classifiers, which is what makes the
    accuracy->reduction trade-off (Fig. 4) non-degenerate."""
    rng = np.random.RandomState(seed)
    z = rng.randn(n, n_latent).astype(np.float32)
    W = rng.randn(n_latent, n_features).astype(np.float32) / np.sqrt(n_latent)
    x = np.tanh(z @ W + feature_noise * rng.randn(n, n_features).astype(np.float32))

    dirs = np.empty((n_columns, n_latent), np.float32)
    base = rng.randn(n_latent)
    base /= np.linalg.norm(base)
    for j in range(n_columns):
        fresh = rng.randn(n_latent)
        fresh /= np.linalg.norm(fresh)
        # orthogonalize fresh against base, then mix
        fresh = fresh - (fresh @ base) * base
        fresh /= np.linalg.norm(fresh) + 1e-9
        d = correlation * base + np.sqrt(max(1 - correlation**2, 0.0)) * fresh
        dirs[j] = d / np.linalg.norm(d)

    truth = np.empty((n, n_columns), np.int64)
    classes = []
    quantiles = []
    for j in range(n_columns):
        score = z @ dirs[j] + label_noise * rng.randn(n).astype(np.float32)
        qs = np.quantile(score, np.linspace(0, 1, n_classes + 1)[1:-1])
        truth[:, j] = np.digitize(score, qs)
        classes.append(n_classes)
        quantiles.append(qs)
    return Dataset(name=name, x=x, truth=truth, directions=dirs, n_classes=classes,
                   w_feat=W, quantiles=quantiles, feature_noise=feature_noise,
                   label_noise=label_noise)


# ------------------------------------------------------------- drift streams
@dataclass
class DriftingStream:
    """A record stream whose generative distribution shifts mid-run.

    ``x[:boundary]`` comes from the SAME process as the source dataset
    (so a plan optimized on ``ds`` samples is initially well-calibrated);
    ``x[boundary:]`` is drawn after a latent distribution shift.  The
    UDFs trained on ``ds`` still apply unchanged — the drift lives in the
    data, so what shifts at query time is the distribution of UDF
    *outputs*: per-predicate selectivities and predicate-event
    correlations, exactly the statistics a frozen plan goes stale on.
    """

    x: np.ndarray  # (n_before + n_after, F)
    boundary: int  # first row of the drifted segment
    truth: np.ndarray  # (N, K) latent-readout ground truth (reference only)
    meta: dict = field(default_factory=dict)

    @property
    def n(self) -> int:
        return self.x.shape[0]


def make_drifting_stream(
    ds: Dataset,
    n_before: int,
    n_after: int,
    *,
    shift: float = 1.5,
    shift_dirs: Sequence[int] = (0,),
    shift_weights: Optional[Sequence[float]] = None,
    shift_targets: Optional[Dict[int, float]] = None,
    corr_gain: float = 1.0,
    seed: int = 0,
) -> DriftingStream:
    """Sample a two-segment stream from ``ds``'s generative process.

    Drift knobs (applied to the second segment's latent ``z``):

    * ``shift`` — the latent mean moves ``shift`` units along the
      (normalized) weighted sum of the readout directions named by
      ``shift_dirs`` (weights default to 1; negative weights push a
      predicate's readout DOWN): those predicates' class masses slide
      across the (frozen) quantile boundaries, i.e. **selectivity
      drift**.  Opposite-signed weights move correlated predicates in
      opposite directions — the plan-order-inverting case.
    * ``shift_targets`` — {column: desired readout-mean shift}.  Solves
      ``D mu = t`` by pseudo-inverse, so each named predicate's latent
      readout moves by EXACTLY the requested amount even when the
      directions are strongly correlated (a normalized direction sum
      cannot move correlated predicates independently — the common
      component dominates).  Overrides ``shift`` / ``shift_dirs``.
    * ``corr_gain`` — latent variance along the bisector of the first two
      readout directions is scaled by ``corr_gain``; since the covariance
      between readouts i and j under anisotropic z is d_i^T Sigma d_j,
      this changes their co-occurrence structure, i.e. **correlation
      drift** (a pure rotation would not — isotropic Gaussians are
      rotation-invariant).
    """
    if ds.w_feat is None or ds.quantiles is None:
        raise ValueError("dataset lacks generative parameters; rebuild with "
                         "make_dataset from this revision")
    rng = np.random.RandomState(seed + 7919)
    k = ds.directions.shape[1]
    n_features = ds.w_feat.shape[1]

    def sample(n: int, drifted: bool):
        z = rng.randn(n, k).astype(np.float32)
        if drifted:
            if corr_gain != 1.0 and ds.directions.shape[0] >= 2:
                u = ds.directions[0] + ds.directions[1]
                u = u / (np.linalg.norm(u) + 1e-9)
                z = z + (corr_gain - 1.0) * (z @ u)[:, None] * u[None, :]
            if shift_targets:
                cols = sorted(shift_targets)
                D = ds.directions[cols]  # (m, k)
                t = np.asarray([shift_targets[c] for c in cols], np.float64)
                mu, *_ = np.linalg.lstsq(D, t, rcond=None)
                z = z + mu.astype(np.float32)[None, :]
            else:
                weights = ([1.0] * len(shift_dirs) if shift_weights is None
                           else list(shift_weights))
                mu = np.zeros(k, np.float32)
                for d, wgt in zip(shift_dirs, weights):
                    mu += np.float32(wgt) * ds.directions[d]
                nrm = np.linalg.norm(mu)
                if nrm > 0:
                    z = z + shift * (mu / nrm)[None, :]
        x = np.tanh(z @ ds.w_feat
                    + ds.feature_noise * rng.randn(n, n_features).astype(np.float32))
        truth = np.empty((n, ds.directions.shape[0]), np.int64)
        for j in range(ds.directions.shape[0]):
            score = z @ ds.directions[j] + ds.label_noise * rng.randn(n).astype(np.float32)
            truth[:, j] = np.digitize(score, ds.quantiles[j])
        return x.astype(np.float32), truth

    x1, t1 = sample(n_before, False)
    x2, t2 = sample(n_after, True)
    return DriftingStream(
        x=np.concatenate([x1, x2]), boundary=n_before,
        truth=np.concatenate([t1, t2]),
        meta={"shift": shift, "shift_dirs": tuple(shift_dirs),
              "shift_weights": None if shift_weights is None else tuple(shift_weights),
              "shift_targets": dict(shift_targets) if shift_targets else None,
              "corr_gain": corr_gain, "seed": seed},
    )


def make_sharded_drifting_streams(
    ds: Dataset,
    n_hosts: int,
    n_before: int,
    n_after: int,
    *,
    shift_targets: Dict[int, float],
    corr_gain: float = 1.0,
    drift_skew: float = 0.3,
    boundary_jitter: float = 0.0,
    shift: float = 1.5,
    skew_corr: bool = False,
    seed: int = 0,
) -> List[DriftingStream]:
    """Per-host drifting shards of the SAME underlying population drift —
    the multi-host serving workload (DESIGN.md §6).

    Every shard drifts in the same direction, but the magnitude each host
    observes is skewed: host k's shift targets are scaled by
    ``1 + drift_skew * g_k`` with ``g_k`` spread symmetrically in
    [-1, 1] (and each shard gets its own sampling seed).  That is exactly
    why a per-host swap decision is statistically noisy — the lightly-hit
    shards' detectors fire late or not at all — and what the quorum vote
    averages over.  ``boundary_jitter`` additionally staggers each
    shard's drift onset by up to that fraction of ``n_before``
    (de-synchronized detection, the harder consensus case).

    ``n_before`` / ``n_after`` are PER-SHARD lengths; shards are disjoint
    samples (per-shard seeds), as if a load balancer hash-partitioned one
    stream.

    A **correlation-only** fleet drift (the cross-host kappa² pooling
    workload, DESIGN.md §6) is ``shift_targets={}`` with ``shift=0.0``
    and ``corr_gain > 1``: no predicate's marginal selectivity moves, so
    per-host detectors have nothing loud to fire on, while the label
    co-occurrence structure shifts everywhere.  ``skew_corr=True``
    additionally spreads the correlation magnitude across shards with
    the same ``drift_skew`` scaling used for selectivity targets.
    """
    if n_hosts < 1:
        raise ValueError("n_hosts must be >= 1")
    rng = np.random.RandomState(seed + 104729)
    gains = (np.linspace(-1.0, 1.0, n_hosts) if n_hosts > 1
             else np.zeros(1))
    streams = []
    for k in range(n_hosts):
        scale = 1.0 + drift_skew * float(gains[k])
        targets_k = {c: t * scale for c, t in shift_targets.items()}
        gain_k = (1.0 + (corr_gain - 1.0) * scale if skew_corr
                  else corr_gain)
        jitter = int(boundary_jitter * n_before * (rng.random_sample() - 0.5) * 2)
        nb = max(1, n_before + jitter)
        stream = make_drifting_stream(
            ds, nb, n_after + (n_before - nb),
            shift_targets=targets_k, corr_gain=gain_k,
            shift=shift * scale, seed=seed + 7 * k + 1,
        )
        stream.meta["host"] = k
        stream.meta["drift_scale"] = scale
        stream.meta["corr_gain"] = gain_k
        streams.append(stream)
    return streams


# --------------------------------------------------------------------- UDFs
def _udf_logits(layers, x: torch.Tensor) -> torch.Tensor:
    h = x
    for w, b in layers[:-1]:
        h = torch.relu(h @ w + b)
    w, b = layers[-1]
    return h @ w + b


def _train_udf_model(x, y, n_classes: int, hidden: int, depth: int, seed: int,
                     steps: int = 400, *, device="cuda"):
    """Train a small-but-real MLP classifier (the expensive UDF body):
    full-batch softmax cross-entropy, momentum 0.9, lr 0.05.  The initial
    weights are ``randn / sqrt(fan_in)`` from a ``torch.Generator`` on
    ``device`` seeded with ``seed``, zero biases.  Returns the trained
    ``[(W, b), ...]`` layer list."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    F = x.shape[1]
    dims = [F] + [hidden] * depth + [n_classes]
    params = []
    for i in range(len(dims) - 1):
        params.append(torch.randn(dims[i], dims[i + 1], generator=gen, device=dev)
                      / float(np.sqrt(dims[i])))
        params.append(torch.zeros(dims[i + 1], device=dev))
    xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    yt = torch.as_tensor(np.asarray(y, np.int64), device=dev)
    mom = [torch.zeros_like(p) for p in params]
    for _ in range(steps):
        for p in params:
            p.requires_grad_(True)
        lg = _udf_logits(list(zip(params[::2], params[1::2])), xt)
        loss = (torch.logsumexp(lg, dim=-1) - lg.gather(1, yt[:, None])[:, 0]).mean()
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            mom = [0.9 * m + g for m, g in zip(mom, grads)]
            params = [p.detach() - 0.05 * m for p, m in zip(params, mom)]
    return list(zip(params[::2], params[1::2]))


def make_udfs(
    ds: Dataset,
    *,
    hidden: int = 256,
    depth: int = 4,
    train_rows: int = 8_000,
    seed: int = 0,
    cost_scale: Dict[int, float] = None,
    declared_cost_ms: Optional[float] = None,
    weights: Optional[Sequence[Sequence]] = None,
    device="cuda",
) -> List[MLUDF]:
    """Train one UDF per label column on ``device`` and set its per-record
    cost.

    ``cost_scale``: optional per-column multiplier emulating heavier models
    by widening the body.  ``declared_cost_ms``: the per-record cost the
    COST MODEL uses (times the column's scale); when None the cost is
    profiled on the device instead.  ``weights``: per column, trained
    ``[(W, b), ...]`` layers (numpy or tensors) to use instead of training
    — how the JAX package's UDFs are carried across.
    """
    dev = resolve_device(device)
    udfs = []
    rng = np.random.RandomState(seed)
    idx = rng.choice(ds.n, min(train_rows, ds.n), replace=False)
    for j in range(ds.truth.shape[1]):
        scale = 1.0 if not cost_scale else cost_scale.get(j, 1.0)
        if weights is None:
            h = int(hidden * scale)
            layers = _train_udf_model(ds.x[idx], ds.truth[idx, j], ds.n_classes[j], h,
                                      depth, seed + j, device=dev)
        else:
            layers = [(torch.tensor(np.asarray(w, np.float32), device=dev),
                       torch.tensor(np.asarray(b, np.float32), device=dev))
                      for w, b in weights[j]]

        def predict(xt, _layers=layers):
            return torch.argmax(_udf_logits(_layers, xt), dim=-1)

        def fn(xx, _predict=predict):
            xt = torch.as_tensor(np.asarray(xx, np.float32), device=dev)
            return _predict(xt).cpu().numpy()

        if declared_cost_ms is None:
            # profile per-record cost (ms) on a device-resident batch; the
            # card runs asynchronously, so synchronize before each clock read
            probe = torch.as_tensor(np.asarray(ds.x[:2048], np.float32), device=dev)
            predict(probe)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(3):
                predict(probe)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            cost = (time.perf_counter() - t0) / 3 / probe.shape[0] * 1e3
        else:
            cost = declared_cost_ms * scale
        acc = float(np.mean(fn(ds.x[idx]) == ds.truth[idx, j]))
        udfs.append(
            MLUDF(name=f"{ds.name}.udf{j}", fn=fn, cost=cost,
                  n_classes=ds.n_classes[j])
        )
        udfs[-1].train_accuracy = acc
    return udfs


def make_query(
    ds: Dataset,
    udfs: Sequence[MLUDF],
    *,
    columns: Sequence[int],
    target_selectivity: float = 0.4,
    accuracy_target: float = 0.9,
    align_positive: bool = True,
    seed: int = 0,
) -> Query:
    """Build a conjunctive query over ``columns`` whose per-predicate
    selectivity is ~``target_selectivity``.

    ``align_positive``: choose later predicates' value sets to be POSITIVELY
    associated with the conjunction of the earlier ones (the paper's
    "state='CA' AND sentiment=positive" scenario — correlated columns alone
    do not imply correlated predicate *events*; the lift ordering does)."""
    rng = np.random.RandomState(seed)
    sample = ds.x[: min(ds.n, 20_000)]
    preds = []
    prefix_mask = np.ones(sample.shape[0], bool)
    for j in columns:
        labels = udfs[j](sample)
        vals, counts = np.unique(labels, return_counts=True)
        fracs = counts / counts.sum()
        if align_positive and preds and prefix_mask.any():
            cond = np.asarray(
                [np.mean(labels[prefix_mask] == v) for v in vals]
            )
            lift = cond / np.maximum(fracs, 1e-9)
            order = np.argsort(-lift)  # most positively-associated first
        else:
            order = rng.permutation(len(vals))
        chosen, tot = [], 0.0
        for i in order:
            if tot >= target_selectivity:
                break
            chosen.append(int(vals[i]))
            tot += fracs[i]
        pred = Predicate(udf=udfs[j], values=frozenset(chosen))
        preds.append(pred)
        prefix_mask &= pred.evaluate(labels)
    return Query(predicates=preds, accuracy_target=accuracy_target)
