"""Query / UDF / predicate descriptors and plan representations.

An ML inference query is::

    SELECT F_1(t) AS c_1, ..., F_n(t) AS c_n FROM stream t
    WHERE c_1 IN v_1 AND ... AND c_n IN v_n      [TARGET ACCURACY A]

Each ``MLUDF`` is a row processor (one output label per input record) that
wraps an expensive model; each ``Predicate`` tests the UDF's output column.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, FrozenSet, List, Optional, Tuple

import numpy as np


@dataclass
class MLUDF:
    """An expensive ML user-defined function: features (N, F) -> labels (N,)."""

    name: str
    fn: Callable[[np.ndarray], np.ndarray]
    cost: float  # per-record execution cost (ms/record), profiled
    n_classes: int = 2

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(self.fn(x))


@dataclass
class Predicate:
    """``column φ value`` over the output of ``udf``."""

    udf: MLUDF
    values: FrozenSet[int]  # equality / IN-set semantics (paper's c φ v)
    name: str = ""

    def __post_init__(self):
        self.values = frozenset(self.values)
        if not self.name:
            self.name = f"{self.udf.name} IN {sorted(self.values)}"

    def evaluate(self, labels: np.ndarray) -> np.ndarray:
        mask = np.zeros(labels.shape[0], bool)
        for v in self.values:
            mask |= labels == v
        return mask


@dataclass
class Query:
    """Conjunction of predicates + query-level target accuracy A."""

    predicates: List[Predicate]
    accuracy_target: float = 0.9

    @property
    def n(self) -> int:
        return len(self.predicates)

    def names(self) -> List[str]:
        return [p.name for p in self.predicates]


@dataclass
class PlanStage:
    """One (proxy, UDF, predicate) cascade stage of a physical plan."""

    pred_idx: int  # index into the query's predicate list
    proxy: Optional[object]  # ProxyModel or None (ORIG)
    alpha: float = 1.0
    threshold: float = -np.inf  # proxy score threshold for this alpha
    # bookkeeping filled by the optimizer:
    est_reduction: float = 0.0
    est_selectivity: float = 1.0
    est_cost: float = 0.0


@dataclass
class PhysicalPlan:
    """Ordered cascade; ``stages[i]`` runs proxy_i -> UDF_i -> sigma_i."""

    query: Query
    stages: List[PlanStage]
    est_total_cost: float = 0.0
    meta: dict = field(default_factory=dict)

    @property
    def order(self) -> Tuple[int, ...]:
        return tuple(s.pred_idx for s in self.stages)

    def describe(self) -> str:
        lines = [f"plan order={self.order} est_cost={self.est_total_cost:.4f}"]
        for s in self.stages:
            p = self.query.predicates[s.pred_idx]
            proxy = "none" if s.proxy is None else f"alpha={s.alpha:.3f} r={s.est_reduction:.3f}"
            lines.append(f"  [{s.pred_idx}] {p.name}: proxy={proxy} C={s.est_cost:.4f}")
        return "\n".join(lines)


def all_orders(n: int) -> List[Tuple[int, ...]]:
    import itertools

    return list(itertools.permutations(range(n)))
