"""Algorithm 2: branch-and-bound order search (+ §5.3 fine-grained tree).

The search tree merges common prefixes of the n! candidate orders.  Each
node (a prefix ending at predicate pi_i) passes through states:

    UNVISITED --(L-phase: label, measure s*)--> LABELED
              --(M-phase: run Algorithm 1, train)--> BUILT

Bounds (Lemma 4 + §5.3 L-node rules) tighten as states advance; plans whose
[sum C^l, sum C^u] interval is dominated by a non-overlapping cheaper plan
are pruned.  With ``fine_grained=False`` the L and M phases run together
(the coarse tree of §5.2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple


from repro_torch.core.accuracy import Allocation, accuracy_allocation
from repro_torch.core.builder import ProxyBuilder
from repro_torch.core.cost import Bounds
from repro_torch.util import advisory_wall_ms



@dataclass
class NodeInfo:
    state: str = "unvisited"  # unvisited | labeled | built
    s_star: float = 1.0  # selectivity measured at the L-node
    alloc: Optional[Allocation] = None  # allocation for the prefix (M-node)
    epoch: int = 0  # search epoch the state was measured in (resume support)


@dataclass
class SearchTrace:
    nodes_total: int = 0
    nodes_visited: int = 0
    plans_pruned: int = 0
    iterations: int = 0

    @property
    def nodes_pruned_frac(self) -> float:
        return 1.0 - self.nodes_visited / max(self.nodes_total, 1)


class BranchAndBound:
    def __init__(self, builder: ProxyBuilder, A: float, *, step: float = 0.02,
                 fine_grained: bool = True, framework: str = "exhaustive",
                 stale_slack: float = 0.4):
        self.builder = builder
        self.A = A
        self.step = step
        self.fine_grained = fine_grained
        self.framework = framework
        self.n = builder.query.n
        # ``stale_slack`` widens bound intervals derived from a previous
        # epoch's measurements during a warm-started ``resume`` — stale
        # L/M-node values still guide the search but cannot hard-prune a
        # plan unless they dominate it even after the widening.  Too small
        # and the resume trusts stale certainty (returns the old plan
        # without re-measuring); large values converge to a cold search.
        self.stale_slack = stale_slack
        self.epoch = 0
        import itertools

        self.orders: List[Tuple[int, ...]] = list(itertools.permutations(range(self.n)))
        self.nodes: Dict[Tuple[int, ...], NodeInfo] = {}
        for order in self.orders:
            for i in range(1, self.n + 1):
                self.nodes.setdefault(tuple(order[:i]), NodeInfo())
        self.trace = SearchTrace(nodes_total=len(self.nodes))
        # surviving candidate orders; persisted across run/resume so a
        # warm resume on unchanged stats does no re-search work
        self._Q: Optional[List[Tuple[int, ...]]] = None

    def _built(self, info: NodeInfo) -> bool:
        """Built *in the current epoch* — stale BUILT nodes only feed bounds."""
        return info.state == "built" and info.epoch == self.epoch

    # ------------------------------------------------------------- bounds
    def _plan_bounds(self, order: Tuple[int, ...]) -> Bounds:
        """Walk the plan; exact cost for BUILT prefix nodes, Lemma-4/§5.3
        bounds beyond.  Measurements from a previous epoch (after a warm
        ``resume`` under drifted stats) still contribute, but the final
        interval is widened by ``stale_slack`` so stale certainty cannot
        prune what fresh stats might prefer."""
        A = self.A
        lo_prefix = hi_prefix = 1.0
        lo_total = hi_total = 0.0
        stale = False
        # find deepest BUILT prefix with an allocation
        built_alloc: Optional[Allocation] = None
        built_depth = 0
        for i in range(self.n, 0, -1):
            info = self.nodes[tuple(order[:i])]
            if info.state == "built" and info.alloc is not None:
                built_alloc, built_depth = info.alloc, i
                stale |= info.epoch != self.epoch
                break
        for i in range(self.n):
            prefix_key = tuple(order[: i + 1])
            info = self.nodes[prefix_key]
            pred = self.builder.query.predicates[order[i]]
            c_udf = pred.udf.cost
            c_hat = 1e-4  # nominal proxy cost before built (refined after)
            if i < built_depth:
                a = built_alloc.alphas[i]
                r = built_alloc.reductions[i]
                s = built_alloc.selectivities[i]
                c_hat = built_alloc.proxies[i].cost
                c = lo_prefix * (c_hat + (1 - r) * c_udf)
                lo_total += c
                hi_total += c
                lo_prefix *= s * a
                hi_prefix = lo_prefix
            elif info.state == "labeled":
                s_star = info.s_star
                stale |= info.epoch != self.epoch
                k = 1  # unavailable prefix proxies at this node (bounded by 1 step)
                s_l = max((s_star - (1 - A) ** k) / (A**k), 0.0)
                s_u = s_star
                lo_total += lo_prefix * c_hat  # r^u = 1 discards all
                hi_total += hi_prefix * (c_hat + c_udf)  # r^l = 0
                lo_prefix *= s_l * A
                hi_prefix *= s_u * 1.0
            else:
                lo_total += lo_prefix * c_hat
                hi_total += hi_prefix * (c_hat + c_udf)
                lo_prefix *= 0.0 * A  # s^l = 0
                hi_prefix *= 1.0
        if stale:
            lo_total *= 1.0 - self.stale_slack
            hi_total *= 1.0 + self.stale_slack
        return Bounds(lo_total, hi_total)

    # -------------------------------------------------------------- phases
    def _visit(self, prefix: Tuple[int, ...]):
        info = self.nodes[prefix]
        if info.state == "unvisited" or info.epoch != self.epoch:
            # L-phase: materialize L*, measure selectivity (cheap; no
            # training).  A stale node (previous epoch) re-enters the
            # normal L->M pipeline here: its old allocation fed bounds
            # only while the node stayed UNVISITED this epoch — once the
            # fresh L-measurement lands, the wide labeled-state bounds
            # take over until the M-phase rebuilds the allocation.
            rows = self.builder.rows_after_sigmas(prefix[:-1])
            info.s_star = self.builder.selectivity(prefix[-1], rows)
            info.state = "labeled"
            info.epoch = self.epoch
            if self.fine_grained:
                self.trace.nodes_visited += 1
                return  # bounds updated; M-phase deferred (prunable before training)
        if info.state == "labeled":
            # M-phase: Algorithm 1 on the sub-order
            info.alloc = accuracy_allocation(
                self.builder, prefix, self.A, step=self.step, framework=self.framework
            )
            info.state = "built"
            info.epoch = self.epoch
            self.trace.nodes_visited += 1 if not self.fine_grained else 0

    # --------------------------------------------------------------- search
    def run(self) -> Tuple[Allocation, SearchTrace]:
        """Cold search over all orders (Algorithm 2)."""
        self._Q = list(self.orders)
        self.trace = SearchTrace(nodes_total=len(self.nodes))
        return self._search()

    def resume(self, builder: Optional[ProxyBuilder] = None
               ) -> Tuple[Allocation, SearchTrace]:
        """Warm-started re-search for the adaptive serving loop.

        With ``builder=None`` (stats unchanged) the persisted candidate set
        and node states are final — the search terminates immediately with
        the identical plan and zero new L/M visits.  With a fresh builder
        (drifted stats, e.g. rebased onto the serving reservoir) the epoch
        advances: every node becomes *stale* — its old s*/allocation keeps
        guiding bounds (widened by ``stale_slack``) while the candidate set
        re-opens, so re-search only spends L/M phases on the prefixes the
        new bounds cannot prune, instead of cold-starting the whole tree.
        The trace reports only the visits this resume performed.
        """
        if builder is not None:
            self.builder = builder
            self.epoch += 1
            self._Q = list(self.orders)
        elif self._Q is None:
            self._Q = list(self.orders)
        self.trace = SearchTrace(nodes_total=len(self.nodes))
        return self._search()

    def _search(self) -> Tuple[Allocation, SearchTrace]:
        t0 = advisory_wall_ms()
        lt0 = self.builder.stats.labeling_ms + self.builder.stats.training_ms
        search0 = self.builder.stats.search_ms
        Q = self._Q
        while True:
            self.trace.iterations += 1
            bounds = {o: self._plan_bounds(o) for o in Q}
            Q.sort(key=lambda o: bounds[o].mean)
            # prune: non-overlapping intervals dominated by the best
            keep = [Q[0]]
            for o in Q[1:]:
                if any(
                    not bounds[o].overlaps(bounds[k]) and bounds[o].lower > bounds[k].upper
                    for k in keep
                ):
                    self.trace.plans_pruned += 1
                else:
                    keep.append(o)
            Q = keep
            # pick first un-built node of the head plan
            head = Q[0]
            target = None
            for i in range(1, self.n + 1):
                if not self._built(self.nodes[tuple(head[:i])]):
                    target = tuple(head[:i])
                    break
            if target is None:
                if len(Q) == 1:
                    break
                # head fully built; try other plans
                for o in Q[1:]:
                    for i in range(1, self.n + 1):
                        if not self._built(self.nodes[tuple(o[:i])]):
                            target = tuple(o[:i])
                            break
                    if target:
                        break
                if target is None:
                    break  # everything built
            if target is not None:
                self._visit(target)
        self._Q = Q
        best = Q[0]
        info = self.nodes[tuple(best)]
        alloc = info.alloc if self._built(info) else None
        if alloc is None or len(alloc.order) < self.n:
            alloc = accuracy_allocation(
                self.builder, best, self.A, step=self.step, framework=self.framework
            )
            info.alloc, info.state, info.epoch = alloc, "built", self.epoch
        elapsed = advisory_wall_ms() - t0
        lt_delta = self.builder.stats.labeling_ms + self.builder.stats.training_ms - lt0
        # add only the B&B loop overhead not already accounted by Algorithm 1
        alloc_search_delta = self.builder.stats.search_ms - search0
        self.builder.stats.search_ms += max(elapsed - lt_delta - alloc_search_delta, 0.0)
        return alloc, self.trace
