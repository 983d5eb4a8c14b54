"""Cost model: Eq. 3.1 execution cost and Lemma-4 bounds.

C(sigma_hat_i, alpha_i) = (prod_{j<i} s_j alpha_j) * (c_hat_i + (1-r_i) c_i)

All costs are per-raw-input-record (the prefix product converts stage-local
per-record cost into raw-input units).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


def stage_cost(prefix_frac: float, proxy_cost: float, udf_cost: float,
               reduction: float) -> float:
    return prefix_frac * (proxy_cost + (1.0 - reduction) * udf_cost)


def plan_cost(alphas: Sequence[float], reductions: Sequence[float],
              selectivities: Sequence[float], proxy_costs: Sequence[float],
              udf_costs: Sequence[float]) -> float:
    total, prefix = 0.0, 1.0
    for a, r, s, ch, c in zip(alphas, reductions, selectivities, proxy_costs, udf_costs):
        total += stage_cost(prefix, ch, c, r)
        prefix *= s * a
    return total


@dataclass
class Bounds:
    lower: float
    upper: float

    def overlaps(self, other: "Bounds") -> bool:
        return self.lower <= other.upper and other.lower <= self.upper

    @property
    def mean(self) -> float:
        return 0.5 * (self.lower + self.upper)

