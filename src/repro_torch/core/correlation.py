"""CORDS chi-squared correlation score (paper section 2.2).

kappa^2 = 1 / (n (min(d1,d2)-1)) * sum_ij (n_ij - n_i. n_.j / n)^2 / (n_i. n_.j / n)

i.e. Cramer's-V-squared measured on a sample (CORDS uses 10K rows).

``StreamingKappa2`` is the incremental form used by the adaptive serving
loop (DESIGN.md §4): it folds label chunks into a sparse contingency table
so the statistic is available mid-stream without re-scanning history, and
is chunking-invariant — feeding the same rows in any split yields exactly
the batch ``correlation_score`` value (property-tested).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _kappa2_from_counts(counts: np.ndarray, n: int) -> float:
    """The CORDS statistic from a dense (d1, d2) contingency table."""
    d1, d2 = counts.shape
    if min(d1, d2) < 2 or n == 0:
        return 0.0
    row = counts.sum(axis=1, keepdims=True)
    col = counts.sum(axis=0, keepdims=True)
    expected = row * col / n
    with np.errstate(divide="ignore", invalid="ignore"):
        chi2 = np.where(expected > 0, (counts - expected) ** 2 / expected, 0.0).sum()
    return float(chi2 / (n * (min(d1, d2) - 1)))


class StreamingKappa2:
    """Incremental pairwise kappa^2 over two categorical label streams.

    ``update(col1, col2)`` folds a chunk of co-observed labels into a sparse
    (value, value) -> count table; ``value()`` densifies and applies the
    CORDS formula.  Because the statistic depends only on the accumulated
    table, any chunking of the same rows produces the identical value as
    ``correlation_score`` with sampling disabled.

    ``weights`` (optional, per-row) accumulate a WEIGHTED contingency
    table: the adaptive server's audit labels arrive importance-sampled
    toward proxy thresholds, and folding each row at its inverse audit
    propensity makes the table a Horvitz-Thompson estimate of the
    population contingency — so a shift in the score distribution alone
    (which changes the audited subset's composition, not the true label
    correlation) does not masquerade as a kappa^2 drift.
    """

    def __init__(self):
        self.counts: Dict[Tuple[int, int], float] = {}
        self.n = 0.0  # weighted mass (HT population estimate)
        self.n_rows = 0  # actual label rows folded — the statistical
        # information really available; with IPW weights ~1/audit_rate,
        # ``n`` overstates it by that factor

    def update(self, col1: np.ndarray, col2: np.ndarray,
               weights: np.ndarray = None) -> None:
        col1 = np.asarray(col1).ravel()
        col2 = np.asarray(col2).ravel()
        if len(col1) != len(col2):
            raise ValueError("label chunks must be co-observed (equal length)")
        if len(col1) == 0:
            return
        pairs = np.stack([col1.astype(np.int64), col2.astype(np.int64)], axis=1)
        uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
        if weights is None:
            sums = np.bincount(inv, minlength=len(uniq))
            total = float(len(col1))
        else:
            w = np.asarray(weights, np.float64).ravel()
            if len(w) != len(col1):
                raise ValueError("weights must be per-row")
            sums = np.bincount(inv, weights=w, minlength=len(uniq))
            total = float(w.sum())
        for (a, b), c in zip(uniq, sums):
            key = (int(a), int(b))
            self.counts[key] = self.counts.get(key, 0.0) + float(c)
        self.n += total
        self.n_rows += len(col1)

    def export(self) -> Tuple[Dict[Tuple[int, int], float], float, int]:
        """Snapshot of the weighted contingency table
        ``(counts, n, n_rows)`` — the unit of cross-host pooling: tables
        from shards of one population sum into the population's table
        (``merge_counts``).  ``n_rows`` rides along so poolers can gate
        decisions on actual label counts, not IPW-inflated mass."""
        return dict(self.counts), self.n, self.n_rows

    def merge_counts(self, counts: Dict[Tuple[int, int], float],
                     n: float, n_rows: int = 0) -> None:
        """Fold another table's exported ``(counts, n, n_rows)`` into this
        one.  Because the statistic depends only on the accumulated table,
        merging K shards' exports yields exactly the value of one tracker
        fed the union of their rows — the fleet-pooling property."""
        for key, c in counts.items():
            k = (int(key[0]), int(key[1]))
            self.counts[k] = self.counts.get(k, 0.0) + float(c)
        self.n += float(n)
        self.n_rows += int(n_rows)

    def value(self) -> float:
        if not self.counts:
            return 0.0
        v1 = sorted({a for a, _ in self.counts})
        v2 = sorted({b for _, b in self.counts})
        i1 = {v: i for i, v in enumerate(v1)}
        i2 = {v: i for i, v in enumerate(v2)}
        dense = np.zeros((len(v1), len(v2)))
        for (a, b), c in self.counts.items():
            dense[i1[a], i2[b]] = c
        return _kappa2_from_counts(dense, self.n)


def correlation_score(col1: np.ndarray, col2: np.ndarray, sample: int = 10_000,
                      seed: int = 0) -> float:
    n_total = len(col1)
    if n_total > sample:
        idx = np.random.RandomState(seed).choice(n_total, sample, replace=False)
        col1, col2 = col1[idx], col2[idx]
    n = len(col1)
    v1, inv1 = np.unique(col1, return_inverse=True)
    v2, inv2 = np.unique(col2, return_inverse=True)
    counts = np.zeros((len(v1), len(v2)))
    np.add.at(counts, (inv1, inv2), 1)
    return _kappa2_from_counts(counts, n)


def query_correlation(label_columns: np.ndarray) -> float:
    """Max pairwise kappa^2 over a query's predicate columns (n, k)."""
    k = label_columns.shape[1]
    best = 0.0
    for i in range(k):
        for j in range(i + 1, k):
            best = max(best, correlation_score(label_columns[:, i], label_columns[:, j]))
    return best
