"""Proxy models (Definition 1): sigma-hat = {d, sigma, M, L, R}.

``d`` — the input relation (which prefix predicates conditioned the sample),
``sigma`` — the target predicate, ``M`` — the trained scorer,
``L`` — the labeled sample it was trained on,
``R`` — the accuracy -> reduction mapping measured on a validation split.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.proxy_family import ProxyFamily, get_family
from repro_torch.training import proxy_models as pm

TRAIN_FRAC, TEST_FRAC = 0.6, 0.2  # 6:2:2 split as in the paper (rest = val)


@dataclass
class RCurve:
    """Accuracy->reduction mapping (Figure 4), measured on a validation set.

    ``alphas`` descending thresholds: for target accuracy a we keep the
    ceil(a * P) highest-scoring positives; the threshold is that positive's
    score; reduction = fraction of validation records scored below it.
    """

    alphas: np.ndarray  # (K,) grid
    thresholds: np.ndarray  # (K,)
    reductions: np.ndarray  # (K,)

    def threshold_for(self, alpha: float) -> float:
        i = int(np.clip(np.searchsorted(-self.alphas, -alpha), 0, len(self.alphas) - 1))
        return float(self.thresholds[i])

    def reduction_for(self, alpha: float) -> float:
        i = int(np.clip(np.searchsorted(-self.alphas, -alpha), 0, len(self.alphas) - 1))
        return float(self.reductions[i])


def build_r_curve(
    scores: np.ndarray,
    labels: np.ndarray,
    grid: Optional[np.ndarray] = None,
    conf_z: float = 1.0,
) -> RCurve:
    """scores: (N,) proxy scores on validation rows; labels: (N,) bool (sigma).

    ``conf_z``: binomial confidence margin — thresholds are chosen for
    alpha' = alpha + z*sqrt(alpha(1-alpha)/P) so the *held-out* accuracy
    meets alpha despite the finite validation sample (the validation split
    of the k% optimization sample is small; without the margin the plan's
    empirical accuracy undershoots the target)."""
    if grid is None:
        grid = np.round(np.linspace(1.0, 0.5, 51), 4)
    pos_scores = np.sort(scores[labels])[::-1]  # descending
    P = len(pos_scores)
    thresholds = np.empty(len(grid))
    reductions = np.empty(len(grid))
    sorted_all = np.sort(scores)
    for i, a in enumerate(grid):
        if P == 0:
            thr = np.inf
        else:
            a_eff = min(1.0, a + conf_z * np.sqrt(a * (1 - a) / max(P, 1)))
            keep = max(1, int(np.ceil(a_eff * P)))
            thr = pos_scores[min(keep, P) - 1]
        thresholds[i] = thr
        reductions[i] = np.searchsorted(sorted_all, thr, side="left") / max(len(scores), 1)
    return RCurve(alphas=np.asarray(grid, float), thresholds=thresholds, reductions=reductions)


@dataclass
class ProxyModel:
    """A trained proxy for predicate ``pred_idx`` conditioned on prefix ``d``.

    ``family`` is the canonical ProxyFamily name ("linear", "mlp1", ...);
    all scoring dispatch goes through the family registry — there is no
    per-kind branching anywhere downstream.
    """

    pred_idx: int
    d: Tuple[int, ...]  # prefix predicate indices (the input relation)
    family: str  # canonical ProxyFamily name
    params: object
    r_curve: RCurve
    cost: float  # per-record scoring cost (ms/record)
    train_f1: float = 0.0
    n_train: int = 0

    @property
    def family_obj(self) -> ProxyFamily:
        return get_family(self.family)

    @property
    def kind(self) -> str:
        """Legacy alias ("svm" | "mlp") kept for external callers; internal
        code dispatches on ``family``."""
        return {"linear": "svm", "mlp1": "mlp"}.get(self.family, self.family)

    def score(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(self.family_obj.score(self.params, x))

    def packed(self) -> pm.PackedProxy:
        """Folded packed form (the fused kernel's device format)."""
        return self.family_obj.pack(self.params)

    def mask(self, x: np.ndarray, alpha: float) -> np.ndarray:
        """True = keep (score >= threshold(alpha))."""
        thr = self.r_curve.threshold_for(alpha)
        return self.score(x) >= thr


def train_proxy(
    x: np.ndarray,
    sigma_labels: np.ndarray,
    pred_idx: int,
    d: Tuple[int, ...],
    kind: str = "svm",
    seed: int = 0,
    cost: Optional[float] = None,
    device="cuda",
) -> ProxyModel:
    """Train M on the labeled sample L (x + boolean sigma labels) on
    ``device`` and measure R on the validation split.  ``kind`` may be a
    canonical family name or a legacy alias ("svm", "mlp") — training and
    scoring dispatch through the ProxyFamily registry."""
    fam = get_family(kind)
    n = x.shape[0]
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    n_tr = max(8, int(TRAIN_FRAC * n))
    n_te = int(TEST_FRAC * n)
    idx_tr = perm[:n_tr]
    idx_val = perm[n_tr + n_te :]
    if len(idx_val) < 8:  # tiny samples: validate on train
        idx_val = idx_tr
    y = np.where(sigma_labels, 1.0, -1.0).astype(np.float32)
    xf = x.astype(np.float32)
    params = fam.train(xf[idx_tr], y[idx_tr], seed, device)
    scores_val = np.asarray(fam.score(params, xf[idx_val]))
    scores_tr = np.asarray(fam.score(params, xf[idx_tr]))
    curve = build_r_curve(scores_val, sigma_labels[idx_val])
    f1 = pm.f1_score(scores_tr, y[idx_tr])
    if cost is None:
        # analytic: O(F x hidden) per record; hidden folds into the packed
        # form's width so the cost model sees the family difference
        hidden = fam.pack(params).hidden
        cost = 1e-4 * x.shape[1] / 64.0 * max(1.0, hidden / 2.0)
    return ProxyModel(
        pred_idx=pred_idx, d=tuple(d), family=fam.name, params=params,
        r_curve=curve, cost=float(cost), train_f1=f1, n_train=len(idx_tr),
    )
