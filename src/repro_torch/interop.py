"""Carry the JAX package's weights and plans across into this package.

Every function reads fields by name from objects whose arrays
``np.asarray`` can take (the JAX package's NamedTuples of jax arrays, or
plain numpy), and builds this package's counterpart on ``device``.
Nothing here imports the JAX package.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from repro_torch.core.proxy import ProxyModel, RCurve
from repro_torch.core.query import PhysicalPlan, PlanStage, Query
from repro_torch.training.proxy_models import LinearParams, MLPParams, PackedProxy
from repro_torch.util import resolve_device

if TYPE_CHECKING:
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.moe import MoETransformer
    from repro_torch.models.rglru import Griffin
    from repro_torch.models.ssm import Mamba2
    from repro_torch.models.transformer import Transformer


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


def physical_plan(ref_plan, query: Query, device="cuda", keep_state: bool = False
                  ) -> PhysicalPlan:
    """The JAX package's ``PhysicalPlan`` over this package's ``query``
    (whose predicates are in the same order): stage order, thresholds,
    per-stage params and families.  The live optimizer state in the plan's
    meta (builder, search tree) travels only with ``keep_state=True``: then
    ``meta["builder"]`` is this package's ``ProxyBuilder`` over the same
    sample with the reference's trained classifiers adopted, and
    ``meta["bnb"]`` a ``BranchAndBound`` seeded with the reference's
    measured nodes and surviving orders, as ``build_plan(keep_state=True)``
    leaves them."""
    stages = [
        PlanStage(pred_idx=int(s.pred_idx),
                  proxy=None if s.proxy is None else proxy_model(s.proxy, device),
                  alpha=float(s.alpha), threshold=float(s.threshold),
                  est_reduction=float(s.est_reduction),
                  est_selectivity=float(s.est_selectivity), est_cost=float(s.est_cost))
        for s in ref_plan.stages
    ]
    meta = {k: v for k, v in ref_plan.meta.items() if k not in ("builder", "bnb")}
    if keep_state:
        meta.update(optimizer_state(ref_plan.meta, query, device))
    return PhysicalPlan(query=query, stages=stages,
                        est_total_cost=float(ref_plan.est_total_cost), meta=meta)


def optimizer_state(ref_meta: dict, query: Query, device="cuda") -> dict:
    """{"builder", "bnb"} of this package rebuilt from a reference plan's
    meta (each only where the reference has one)."""
    from repro_torch.core.bnb import BranchAndBound
    from repro_torch.core.builder import ProxyBuilder

    dev = resolve_device(device)
    ref_bnb = ref_meta.get("bnb")
    ref_builder = ref_meta.get("builder")
    if ref_builder is None and ref_bnb is not None:
        ref_builder = ref_bnb.builder
    out = {}
    if ref_builder is None:
        return out
    builder = ProxyBuilder(query, np.asarray(ref_builder.x), kind=ref_builder.kind,
                           eps=ref_builder.eps, seed=ref_builder.seed,
                           reuse_samples=ref_builder.reuse_samples,
                           reuse_classifiers=ref_builder.reuse_classifiers, device=dev)
    builder.adopt_classifiers({key: (proxy_model(proxy, dev), float(phi))
                               for key, (proxy, phi) in ref_builder.export_classifiers().items()})
    out["builder"] = builder
    if ref_bnb is not None:
        bb = BranchAndBound(builder, ref_bnb.A, step=ref_bnb.step,
                            fine_grained=ref_bnb.fine_grained, framework=ref_bnb.framework,
                            stale_slack=ref_bnb.stale_slack)
        s_stars, orders = ref_bnb.export_state()
        bb.seed_from(s_stars, orders=orders)
        out["bnb"] = bb
    return out


def _tensor_as_is(a, dev: torch.device) -> torch.Tensor:
    """``a`` on ``dev`` in its own type.  A bfloat16 numpy array (the
    ``ml_dtypes`` type, named "bfloat16") travels as its raw 16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def _load_jax_params(model: torch.nn.Module, ref_params, dev: torch.device):
    """Copy the JAX package's nested params into ``model`` by parameter
    name, through ``models.leaves.leaf_of``: a layer of a stack
    (``<stack>.<i>.<path>``) reads ``ref_params[<stack>][<path>][i]``, an
    entry of the hybrid family's block tuple (``blocks.<i>.<path>``)
    ``ref_params["blocks"][i][<path>]``, any other name its last part at
    the top level.  Every array keeps its own type."""
    from repro_torch.models.leaves import leaf_of

    with torch.no_grad():
        for name, param in model.named_parameters():
            path, layer = leaf_of(name)
            src = _ref_leaf(ref_params, path)
            t = _tensor_as_is(src if layer is None else src[layer], dev)
            if t.shape != param.shape or t.dtype != param.dtype:
                raise ValueError(f"{name}: reference {tuple(t.shape)} {t.dtype}, "
                                 f"model {tuple(param.shape)} {param.dtype}")
            param.copy_(t)
    return model


def transformer_params(ref_params, cfg, device="cuda") -> Transformer:
    """The JAX package's dense-transformer params as this package's
    ``Transformer`` on ``device``."""
    from repro_torch.models.transformer import Transformer

    dev = resolve_device(device)
    return _load_jax_params(Transformer(cfg, device=dev), ref_params, dev)


def ssm_params(ref_params, cfg, device="cuda") -> Mamba2:
    """The JAX package's Mamba-2 params as this package's ``Mamba2`` on
    ``device``."""
    from repro_torch.models.ssm import Mamba2

    dev = resolve_device(device)
    return _load_jax_params(Mamba2(cfg, device=dev), ref_params, dev)


def moe_params(ref_params, cfg, device="cuda") -> MoETransformer:
    """The JAX package's MoE params (GQA or MLA attention, a leading dense
    stack where the config has one) as this package's ``MoETransformer``."""
    from repro_torch.models.moe import MoETransformer

    dev = resolve_device(device)
    return _load_jax_params(MoETransformer(cfg, device=dev), ref_params, dev)


# the VLM family's weights are the dense family's
vlm_params = transformer_params


def backbone_udf_params(ref_params, cfg, device="cuda") -> dict:
    """A backbone UDF's parameter tree ``{"backbone", "proj", "head"}`` (the
    JAX package's ``examples/transformer_udf_serving.py`` draws it) as
    ``transformer_udf_serving``'s: the backbone through ``moe_params`` or
    ``transformer_params`` by ``cfg.family``, ``proj`` and ``head`` as
    tensors of their own type on ``device``."""
    dev = resolve_device(device)
    load = moe_params if cfg.family == "moe" else transformer_params
    return {"backbone": load(ref_params["backbone"], cfg, dev),
            "proj": _tensor_as_is(ref_params["proj"], dev),
            "head": _tensor_as_is(ref_params["head"], dev)}


def encdec_params(ref_params, cfg, device="cuda") -> EncDec:
    """The JAX package's encoder-decoder params (``enc_layers`` and
    ``dec_layers`` stacked) as this package's ``EncDec`` on ``device``."""
    from repro_torch.models.encdec import EncDec

    dev = resolve_device(device)
    return _load_jax_params(EncDec(cfg, device=dev), ref_params, dev)


def rglru_params(ref_params, cfg, device="cuda") -> Griffin:
    """The JAX package's hybrid params (``blocks`` a tuple of unstacked
    block dicts) as this package's ``Griffin`` on ``device``."""
    from repro_torch.models.rglru import Griffin

    dev = resolve_device(device)
    return _load_jax_params(Griffin(cfg, device=dev), ref_params, dev)


def _ref_leaf(ref_tree, path) -> np.ndarray:
    for key in path:
        ref_tree = ref_tree[key]
    return np.asarray(ref_tree)


def adamw_state(ref_state, params: torch.nn.Module, device="cuda"):
    """The JAX package's ``AdamWState`` (step, and mu / nu as pytrees like
    its params: layer stacks on a leading dim) as this package's
    ``optim.AdamWState`` for ``params``: one f32 moment a parameter."""
    from repro_torch.models.leaves import leaf_of
    from repro_torch.training.optim import AdamWState

    dev = resolve_device(device)

    def per_param(ref_tree):
        out = {}
        for name, _ in params.named_parameters():
            path, layer = leaf_of(name)
            arr = _ref_leaf(ref_tree, path)
            out[name] = _t(arr if layer is None else arr[layer], dev)
        return out

    return AdamWState(step=int(np.asarray(ref_state.step)), mu=per_param(ref_state.mu),
                      nu=per_param(ref_state.nu))


def adafactor_state(ref_state, params: torch.nn.Module, device="cuda"):
    """The JAX package's ``AdafactorState`` as this package's: row and
    column factors a JAX leaf (layer stacks whole), keyed by leaf path."""
    from repro_torch.models.leaves import groups
    from repro_torch.training.optim import AdafactorState

    dev = resolve_device(device)
    paths = list(groups(n for n, _ in params.named_parameters()))
    return AdafactorState(step=int(np.asarray(ref_state.step)),
                          vr={p: _t(_ref_leaf(ref_state.vr, p), dev) for p in paths},
                          vc={p: _t(_ref_leaf(ref_state.vc, p), dev) for p in paths})


def cursor(ref_cursor):
    """The JAX package's data ``Cursor`` (or its ``as_dict()``) as this
    package's."""
    from repro_torch.data.pipeline import Cursor

    d = ref_cursor if isinstance(ref_cursor, dict) else ref_cursor.as_dict()
    return Cursor.from_dict({k: int(np.asarray(v)) for k, v in d.items()})
