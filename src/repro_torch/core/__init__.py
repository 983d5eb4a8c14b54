from repro_torch.core.query import MLUDF, PhysicalPlan, PlanStage, Predicate, Query
from repro_torch.core.proxy import ProxyModel, RCurve, build_r_curve, train_proxy
from repro_torch.core.builder import ProxyBuilder
from repro_torch.core.accuracy import accuracy_allocation, alpha_frontier
from repro_torch.core.bnb import BranchAndBound
from repro_torch.core.api import OptimizeOptions, build_plan, rebuild_plan
from repro_torch.core.baselines import ns_plan, orig_plan, pp_plan
from repro_torch.core.executor import ExecResult, execute_plan, plan_accuracy
from repro_torch.core.correlation import correlation_score, query_correlation

__all__ = [
    "MLUDF", "PhysicalPlan", "PlanStage", "Predicate", "Query",
    "ProxyModel", "RCurve", "build_r_curve", "train_proxy",
    "ProxyBuilder", "accuracy_allocation", "alpha_frontier",
    "BranchAndBound",
    "OptimizeOptions", "build_plan", "rebuild_plan",
    "ns_plan", "orig_plan", "pp_plan",
    "ExecResult", "execute_plan", "plan_accuracy",
    "correlation_score", "query_correlation",
]
