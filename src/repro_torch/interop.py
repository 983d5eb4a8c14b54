"""Carry the JAX package's weights and plans across into this package.

Every function reads fields by name from objects whose arrays
``np.asarray`` can take (the JAX package's NamedTuples of jax arrays, or
plain numpy), and builds this package's counterpart on ``device``.
Nothing here imports the JAX package.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.proxy import ProxyModel, RCurve
from repro_torch.core.query import PhysicalPlan, PlanStage, Query
from repro_torch.training.proxy_models import LinearParams, MLPParams, PackedProxy
from repro_torch.util import resolve_device


def _t(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(np.asarray(a), np.float32), device=dev)


def linear_params(ref, device="cuda") -> LinearParams:
    dev = resolve_device(device)
    return LinearParams(w=_t(ref.w, dev), b=_t(ref.b, dev),
                        mean=_t(ref.mean, dev), scale=_t(ref.scale, dev))


def mlp_params(ref, device="cuda") -> MLPParams:
    dev = resolve_device(device)
    return MLPParams(w1=_t(ref.w1, dev), b1=_t(ref.b1, dev), w2=_t(ref.w2, dev),
                     b2=_t(ref.b2, dev), mean=_t(ref.mean, dev), scale=_t(ref.scale, dev))


def packed_proxy(ref) -> PackedProxy:
    """A folded proxy stays a host numpy ``PackedProxy``."""
    return PackedProxy(w1=np.asarray(ref.w1, np.float32), b1=np.asarray(ref.b1, np.float32),
                       w2=np.asarray(ref.w2, np.float32), b2=np.float32(ref.b2),
                       hidden=int(ref.hidden))


def proxy_params(ref, device="cuda"):
    """Dispatch on the fields present: ``hidden`` -> PackedProxy, ``w1``
    with a standardizer -> MLPParams, ``w`` -> LinearParams."""
    if hasattr(ref, "hidden"):
        return packed_proxy(ref)
    if hasattr(ref, "w1"):
        return mlp_params(ref, device)
    if hasattr(ref, "w"):
        return linear_params(ref, device)
    raise TypeError(f"no proxy parameter layout matches {type(ref).__name__}")


def udf_layers(ref_layers: Sequence) -> list:
    """A UDF's ``[(W, b), ...]`` layer list as numpy arrays, the form
    ``data.synthetic.make_udfs(weights=...)`` takes per column."""
    return [(np.asarray(w, np.float32), np.asarray(b, np.float32)) for w, b in ref_layers]


def proxy_model(ref, device="cuda") -> ProxyModel:
    curve = ref.r_curve
    return ProxyModel(
        pred_idx=int(ref.pred_idx), d=tuple(int(i) for i in ref.d), family=str(ref.family),
        params=proxy_params(ref.params, device),
        r_curve=RCurve(alphas=np.asarray(curve.alphas, float),
                       thresholds=np.asarray(curve.thresholds, float),
                       reductions=np.asarray(curve.reductions, float)),
        cost=float(ref.cost), train_f1=float(ref.train_f1), n_train=int(ref.n_train))


def physical_plan(ref_plan, query: Query, device="cuda") -> PhysicalPlan:
    """The JAX package's ``PhysicalPlan`` over this package's ``query``
    (whose predicates are in the same order): stage order, thresholds,
    per-stage params and families.  Live optimizer state in the plan's
    meta (builder, search tree) does not travel."""
    stages = [
        PlanStage(pred_idx=int(s.pred_idx),
                  proxy=None if s.proxy is None else proxy_model(s.proxy, device),
                  alpha=float(s.alpha), threshold=float(s.threshold),
                  est_reduction=float(s.est_reduction),
                  est_selectivity=float(s.est_selectivity), est_cost=float(s.est_cost))
        for s in ref_plan.stages
    ]
    meta = {k: v for k, v in ref_plan.meta.items() if k not in ("builder", "bnb")}
    return PhysicalPlan(query=query, stages=stages,
                        est_total_cost=float(ref_plan.est_total_cost), meta=meta)
