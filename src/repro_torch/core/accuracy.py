"""Algorithm 1: accuracy allocation for a fixed order pi.

Searches the discretized accuracy space {alpha : prod alpha_i = A} for the
allocation minimizing sum_i C(sigma-hat_i, alpha_i).  The objective is
non-convex (Lemma 1), so the default is exhaustive enumeration of the tight
frontier of the grid; ``framework="hill"`` swaps in hill-climbing (the
paper's §6.4 configuration).

Sample reuse and classifier reuse live in ``ProxyBuilder``; this module is
the search driver.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.builder import ProxyBuilder
from repro_torch.core.proxy import ProxyModel
from repro_torch.util import advisory_wall_ms



def alpha_frontier(n: int, A: float, step: float = 0.02) -> np.ndarray:
    """Enumerate near-tight allocations on the grid: prod in [A, A/(1-step)).

    Cost is non-decreasing in each alpha (reduction falls as accuracy rises,
    and downstream volume grows), so the optimum of {prod = A} lies on this
    shell of the discretized space.
    """
    grid = np.arange(A, 1.0 + 1e-9, step)
    if grid[-1] < 1.0 - 1e-9:
        grid = np.append(grid, 1.0)
    out: List[Tuple[float, ...]] = []
    hi = A / (1.0 - step)

    def rec(prefix: Tuple[float, ...], prod: float):
        if len(prefix) == n:
            if A - 1e-12 <= prod < hi:
                out.append(prefix)
            return
        remaining = n - len(prefix) - 1
        for a in grid:
            p = prod * a
            # prune: even all-1.0 suffix cannot reach A
            if p < A - 1e-12:
                continue
            # prune: even all-A suffix stays >= hi -> every completion too loose
            if p * (grid[0] ** remaining) >= hi:
                continue
            rec(prefix + (float(a),), p)

    rec((), 1.0)
    if not out:
        out = [tuple([float(grid[0])] * n)]
    return np.asarray(out)


@dataclass
class Allocation:
    order: Tuple[int, ...]
    alphas: Tuple[float, ...]
    proxies: List[ProxyModel]
    reductions: List[float]
    selectivities: List[float]
    stage_costs: List[float]
    total_cost: float


def _evaluate_allocation(
    builder: ProxyBuilder, order: Sequence[int], alphas: Sequence[float]
) -> Allocation:
    """Build/fetch proxies for this (order, alphas) and cost it (Eq. 3.1)."""
    proxies: List[ProxyModel] = []
    reductions, sels, costs = [], [], []
    total, prefix_frac = 0.0, 1.0
    prefix_pp: List[Tuple[ProxyModel, float]] = []
    for i, p in enumerate(order):
        proxy, rows = builder.get_proxy(p, order[:i], prefix_pp)
        r = proxy.r_curve.reduction_for(alphas[i])
        s = builder.selectivity(p, rows) if len(rows) else 1.0
        c_udf = builder.query.predicates[p].udf.cost
        stage = prefix_frac * (proxy.cost + (1.0 - r) * c_udf)
        total += stage
        prefix_frac *= s * alphas[i]
        proxies.append(proxy)
        reductions.append(r)
        sels.append(s)
        costs.append(stage)
        prefix_pp = prefix_pp + [(proxy, alphas[i])]
    return Allocation(tuple(order), tuple(float(a) for a in alphas), proxies,
                      reductions, sels, costs, total)


def accuracy_allocation(
    builder: ProxyBuilder,
    order: Sequence[int],
    A: float,
    *,
    step: float = 0.02,
    framework: str = "exhaustive",  # | "hill"
) -> Allocation:
    t0 = advisory_wall_ms()
    lt0 = builder.stats.labeling_ms + builder.stats.training_ms
    n = len(order)
    cands = alpha_frontier(n, A, step)
    best: Optional[Allocation] = None
    if framework == "exhaustive" or len(cands) <= 8:
        for alphas in cands:
            alloc = _evaluate_allocation(builder, order, alphas)
            if best is None or alloc.total_cost < best.total_cost:
                best = alloc
    else:
        # hill climbing from the balanced allocation
        balanced = np.full(n, A ** (1.0 / n))
        start = cands[np.argmin(np.abs(cands - balanced).sum(axis=1))]
        best = _evaluate_allocation(builder, order, start)
        improved = True
        visited = {tuple(start)}
        while improved:
            improved = False
            dists = np.abs(cands - np.asarray(best.alphas)).sum(axis=1)
            for alphas in cands[np.argsort(dists)[:2 * n + 1]]:
                key = tuple(alphas)
                if key in visited:
                    continue
                visited.add(key)
                alloc = _evaluate_allocation(builder, order, alphas)
                if alloc.total_cost < best.total_cost - 1e-12:
                    best = alloc
                    improved = True
                    break
    # search time excludes labeling/training accrued inside get_proxy
    elapsed = advisory_wall_ms() - t0
    lt_delta = builder.stats.labeling_ms + builder.stats.training_ms - lt0
    builder.stats.search_ms += max(elapsed - lt_delta, 0.0)
    return best
