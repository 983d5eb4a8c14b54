"""ProxyBuilder: the shared construction state for online proxy building.

Implements the two reuse mechanisms that make CORE's online optimization
cheap:

* **Sample reuse** (§4.3, Theorem 1): materialized samples ``L'`` are keyed
  by the *set* of prefix sigmas (commutativity makes order irrelevant), and
  UDF labeling is lazy + memoized per (predicate, row) — each expensive UDF
  runs at most once per sample row, across the entire search.
* **Classifier reuse** (§4.4, Eq. 4.7): trained classifiers are cached per
  (predicate, prefix-set) and reused when epsilon-approximate on the new
  labeled sample (F1 as the scoring function phi).

All labeling / training / search time is accounted in ``self.stats`` so the
Table-4/5 benchmarks can decompose optimization cost.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.proxy import ProxyModel, train_proxy
from repro_torch.core.proxy_family import get_family
from repro_torch.core.query import Query
from repro_torch.training.proxy_models import f1_score
from repro_torch.util import advisory_wall_ms, resolve_device



@dataclass
class BuilderStats:
    labeling_ms: float = 0.0
    training_ms: float = 0.0
    search_ms: float = 0.0
    udf_calls: Dict[int, int] = field(default_factory=dict)
    n_trained: int = 0
    n_reused: int = 0

    @property
    def qo_ms(self) -> float:
        return self.labeling_ms + self.training_ms + self.search_ms

    def as_dict(self):
        return {
            "labeling_ms": self.labeling_ms,
            "training_ms": self.training_ms,
            "search_ms": self.search_ms,
            "qo_ms": self.qo_ms,
            "udf_calls": dict(self.udf_calls),
            "n_trained": self.n_trained,
            "n_reused": self.n_reused,
        }


class ProxyBuilder:
    def __init__(self, query: Query, x_sample: np.ndarray, *, kind: str = "svm",
                 eps: float = 0.1, seed: int = 0, reuse_samples: bool = True,
                 reuse_classifiers: bool = True, device="cuda"):
        """``reuse_samples=False`` / ``reuse_classifiers=False`` disable the
        paper's two reuse mechanisms (§4.3 / §4.4) — used by the ablation
        benchmark to quantify what each saves.

        ``kind`` selects the proxy family per predicate: a family name or
        alias ("svm"/"linear", "mlp"/"mlp1") applies to every predicate;
        "mixed" alternates linear / mlp1 by predicate index (the CLI's
        mixed-cascade exercise path); a ``{pred_idx: family}`` dict pins
        families explicitly (how ``reoptimize`` preserves an incumbent
        plan's exact per-predicate assignment).

        ``device`` is where proxies train and score; it defaults to CUDA
        and raises without a card (pass ``"cpu"`` to run on the CPU)."""
        self.device = resolve_device(device)
        self.query = query
        self.x = np.asarray(x_sample, np.float32)
        self.n = self.x.shape[0]
        self.kind = kind
        self.eps = eps
        self.seed = seed
        self.reuse_samples = reuse_samples
        self.reuse_classifiers = reuse_classifiers
        self.stats = BuilderStats()
        # lazy UDF labels on the optimization sample
        self._labeled: Dict[int, np.ndarray] = {}  # pred -> bool "has label" per row
        self._labels: Dict[int, np.ndarray] = {}  # pred -> sigma bool per row
        # materialized sigma-filtered samples, keyed by frozenset of preds
        self._sigma_rows: Dict[FrozenSet[int], np.ndarray] = {frozenset(): np.arange(self.n)}
        # classifier cache: (pred, frozenset(prefix), family) ->
        # (ProxyModel, phi_star).  phi_star is the scorer's F1 on the
        # sample it was trained against, recorded at insert time, so the
        # Eq.-4.7 eps-approx test does not reference row indices of any
        # particular sample — the cache stays valid when transplanted onto
        # a fresh sample via ``rebase``.  Keying on the FAMILY (not just
        # the predicate) means a builder whose kind changed, or a mixed
        # cascade, never reuses a classifier across families.
        self._proxies: Dict[Tuple[int, FrozenSet[int], str], Tuple[ProxyModel, float]] = {}

    def family_for(self, pred_idx: int) -> str:
        """Canonical family name training predicate ``pred_idx``'s proxy."""
        if isinstance(self.kind, dict):
            return get_family(self.kind.get(pred_idx, "svm")).name
        if self.kind == "mixed":
            return "linear" if pred_idx % 2 == 0 else "mlp1"
        return get_family(self.kind).name

    # ------------------------------------------------------------- labeling
    def sigma_mask(self, pred_idx: int, rows: np.ndarray) -> np.ndarray:
        """Boolean sigma outcome for ``rows``, labeling lazily via the UDF."""
        if pred_idx not in self._labeled:
            self._labeled[pred_idx] = np.zeros(self.n, bool)
            self._labels[pred_idx] = np.zeros(self.n, bool)
        if not self.reuse_samples:
            # ablation: no materialization — every request re-runs the UDF
            pred = self.query.predicates[pred_idx]
            t0 = advisory_wall_ms()
            labels = pred.udf(self.x[rows])
            self.stats.labeling_ms += advisory_wall_ms() - t0
            self.stats.udf_calls[pred_idx] = self.stats.udf_calls.get(pred_idx, 0) + len(rows)
            return pred.evaluate(labels)
        need = rows[~self._labeled[pred_idx][rows]]
        if len(need):
            pred = self.query.predicates[pred_idx]
            t0 = advisory_wall_ms()
            labels = pred.udf(self.x[need])
            self.stats.labeling_ms += advisory_wall_ms() - t0
            self.stats.udf_calls[pred_idx] = self.stats.udf_calls.get(pred_idx, 0) + len(need)
            self._labels[pred_idx][need] = pred.evaluate(labels)
            self._labeled[pred_idx][need] = True
        return self._labels[pred_idx][rows]

    def rows_after_sigmas(self, prefix: Sequence[int]) -> np.ndarray:
        """Materialized L': sample rows passing the given sigma set.

        Theorem-1 commutativity lets us key by set; construction is greedy
        from the largest materialized subset."""
        if not self.reuse_samples:
            rows = np.arange(self.n)
            for p in prefix:
                rows = rows[self.sigma_mask(p, rows)]
            return rows
        key = frozenset(prefix)
        if key in self._sigma_rows:
            return self._sigma_rows[key]
        # find best materialized subset to extend
        best = frozenset()
        for k in self._sigma_rows:
            if k <= key and len(k) > len(best):
                best = k
        rows = self._sigma_rows[best]
        for p in key - best:
            rows = rows[self.sigma_mask(p, rows)]
            best = best | {p}
            self._sigma_rows[best] = rows
        return self._sigma_rows[key]

    # ------------------------------------------------------- proxy training
    def get_proxy(
        self,
        pred_idx: int,
        prefix: Sequence[int],
        prefix_proxies: Sequence[Tuple[ProxyModel, float]] = (),
    ) -> Tuple[ProxyModel, np.ndarray]:
        """Proxy for ``pred_idx`` with input relation d = (prefix sigma-hats
        + sigmas).  ``prefix_proxies``: [(proxy, alpha)] applied to refine L.
        Returns (proxy, rows of L used)."""
        rows = self.rows_after_sigmas(prefix)
        for proxy, alpha in prefix_proxies:
            if len(rows) == 0:
                break
            rows = rows[proxy.mask(self.x[rows], alpha)]
        family = self.family_for(pred_idx)
        key = (pred_idx, frozenset(prefix), family)
        labels = self.sigma_mask(pred_idx, rows)
        if key in self._proxies and self.reuse_classifiers:
            cached, phi_star = self._proxies[key]
            # epsilon-approx test (Eq. 4.7) with phi = F1 of the cached scorer
            y_new = np.where(labels, 1.0, -1.0)
            phi_new = f1_score(cached.score(self.x[rows]), y_new) if len(rows) else phi_star
            if abs(phi_new - phi_star) <= self.eps * max(phi_star, 1e-9):
                self.stats.n_reused += 1
                return cached, rows
        t0 = advisory_wall_ms()
        proxy = train_proxy(
            self.x[rows], labels, pred_idx, tuple(prefix), kind=family,
            seed=self.seed + pred_idx, device=self.device,
        )
        self.stats.training_ms += advisory_wall_ms() - t0
        self.stats.n_trained += 1
        y_here = np.where(labels, 1.0, -1.0)
        phi_star = f1_score(proxy.score(self.x[rows]), y_here) if len(rows) else 0.0
        self._proxies[key] = (proxy, phi_star)
        return proxy, rows

    # ----------------------------------------------------------- adaptivity
    def rebase(
        self,
        x_new: np.ndarray,
        *,
        known_sigma: Optional[Dict[int, Tuple[np.ndarray, np.ndarray]]] = None,
    ) -> "ProxyBuilder":
        """Fresh builder over a new optimization sample (e.g. the serving
        reservoir), carrying the trained-classifier cache forward so the
        §4.4 eps-approx reuse test can skip retraining proxies that still
        fit the drifted data.

        ``known_sigma``: pred_idx -> (known_mask (M,), sigma (M,)) boolean
        arrays pre-seeding the lazy label cache — rows the serving loop
        already ran the UDF on (audit records) are never re-labeled.
        """
        nb = ProxyBuilder(
            self.query, x_new, kind=self.kind, eps=self.eps, seed=self.seed,
            reuse_samples=self.reuse_samples,
            reuse_classifiers=self.reuse_classifiers, device=self.device,
        )
        nb._proxies = dict(self._proxies)
        if known_sigma:
            nb.seed_labels(known_sigma)
        return nb

    def seed_labels(
        self, known_sigma: Dict[int, Tuple[np.ndarray, np.ndarray]]
    ) -> None:
        """Pre-populate the lazy UDF-label cache with sigma outcomes already
        observed elsewhere (e.g. serving audit records): pred_idx ->
        (known_mask (n,), sigma (n,)) over THIS builder's sample rows."""
        for p, (known, sigma) in known_sigma.items():
            known = np.asarray(known, bool)
            if known.shape[0] != self.n:
                raise ValueError(
                    f"known_sigma[{p}] has {known.shape[0]} rows, sample has {self.n}")
            self._labeled[p] = known.copy()
            self._labels[p] = np.asarray(sigma, bool) & known

    # ---------------------------------------------------------- measurement
    def selectivity(self, pred_idx: int, rows: np.ndarray) -> float:
        if len(rows) == 0:
            return 1.0
        return float(np.mean(self.sigma_mask(pred_idx, rows)))

    def conditional_rows(
        self, order: Sequence[int], alphas: Sequence[float],
        proxies: Sequence[ProxyModel], upto: int,
    ) -> np.ndarray:
        """Rows passing (sigma-hat_j AND sigma_j) for j < upto."""
        rows = np.arange(self.n)
        for j in range(upto):
            if len(rows) == 0:
                return rows
            rows = rows[proxies[j].mask(self.x[rows], alphas[j])]
            rows = rows[self.sigma_mask(order[j], rows)]
        return rows
