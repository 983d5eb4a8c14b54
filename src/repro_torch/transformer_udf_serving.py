"""CORE's queries over transformer UDFs: two classifier UDFs whose bodies are
transformer backbones (llama3-405b's dense family, qwen3-moe-30b-a3b's MoE
family), trained with AdamW, then gated by CORE's proxies and served by the
``CascadeServer``.

    PYTHONPATH=src python -m repro_torch.transformer_udf_serving [--device cuda] [--full]

The flow of the JAX package's ``examples/transformer_udf_serving.py``:

1. each UDF projects a record's features to ``SEQ`` = 8 token embeddings
   (``x @ proj``, cast to bf16), runs the family's ``backbone`` over them,
   pools the tokens in f32 and applies ``head``; it is trained with AdamW
   (lr 3e-3, no weight decay) on the stream's first 2,000 records, and its
   per-record cost is measured on a 512-record probe;
2. CORE builds proxies on the first 2,000 records (``build_plan``,
   mode "core");
3. the ``CascadeServer`` serves the rest in tiles of 512 records, and ORIG
   and CORE execute over it for the cost saving and the accuracy.

On the card every attention layer of the backbones runs ``flash_attention``
(forward and backward: causal, S == T) and every proxied stage is scored
by ``cascade_score``.  ``--full`` builds the backbones at their published
widths, depth cut to ``FULL_LAYERS``.

AdamW updates only the leaves the loss reaches: the family's embedding and
LM head are not on the UDF's path, and with no weight decay AdamW leaves a
leaf whose gradient is zero exactly as it is, so this equals updating the
whole tree (the reference's) without their moments.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import (MLUDF, OptimizeOptions, Predicate, Query, build_plan,
                              execute_plan, orig_plan, plan_accuracy)
from repro_torch.data.synthetic import make_dataset
from repro_torch.launch.train import with_depth
from repro_torch.models.registry import get_family
from repro_torch.serving.engine import CascadeServer
from repro_torch.training import optim
from repro_torch.util import prng, resolve_device

SEQ = 8  # token embeddings a record is projected to
TRAIN_ROWS = 2000  # the UDFs' training rows and CORE's optimization sample
PROBE_ROWS = 512  # the cost probe
MIN_BUCKET = 256  # the smallest padded batch
LR = 3e-3
# (arch, label column, seed) of each predicate's UDF
UDFS = (("llama3-405b", 0, 1), ("qwen3-moe-30b-a3b", 1, 2))
# published widths: the depth each backbone is cut to on one card
FULL_LAYERS = {"llama3-405b": 1, "qwen3-moe-30b-a3b": 2}


def udf_config(arch: str, full: bool = False):
    """The backbone's config without remat: the reduced config, or with
    ``full`` the published one cut to ``FULL_LAYERS[arch]`` layers."""
    cfg = with_depth(get_config(arch), FULL_LAYERS[arch]) if full else reduced_config(arch)
    return cfg.replace(remat=False)


def bucket(n: int) -> int:
    """The padded batch of ``n`` records: a power of two, at least 256."""
    b = MIN_BUCKET
    while b < n:
        b *= 2
    return b


def init_udf_params(cfg, n_features: int, n_classes: int, seed: int, device="cuda") -> dict:
    """``{"backbone", "proj", "head"}``, the JAX example's initial tree:
    ``k1, k2, k3 = split(PRNGKey(seed), 3)``, the family's weights from k1
    and two f32 matrices of standard normals times 0.05 (an eager product)
    from k2 and k3 (``util/prng.py``; on the card each one launch of the
    threefry kernel)."""
    dev = resolve_device(device)
    k1, k2, k3 = prng.split(prng.key(seed), 3)
    return {"backbone": get_family(cfg).init(k1, cfg, dev),
            "proj": prng.normal(k2, (n_features, SEQ * cfg.d_model), times=0.05, device=dev),
            "head": prng.normal(k3, (cfg.d_model, n_classes), times=0.05, device=dev)}


def udf_logits(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """Pooled logits (B, classes) f32 of records ``x`` (B, F) f32."""
    B = x.shape[0]
    h = (x @ params["proj"]).reshape(B, SEQ, cfg.d_model).to(torch.bfloat16)
    positions = torch.arange(SEQ, dtype=torch.int32, device=x.device)[None].expand(B, SEQ)
    h = get_family(cfg).backbone(params["backbone"], cfg, h, positions)
    if cfg.family == "moe":
        h = h[0]  # (h, router aux loss): the classifier's loss leaves the aux out
    return h.to(torch.float32).mean(dim=1) @ params["head"]


def udf_loss(params: dict, cfg, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    lg = udf_logits(params, cfg, x)
    return (torch.logsumexp(lg, dim=1) - lg.gather(1, y[:, None])[:, 0]).mean()


def udf_leaves(params: dict) -> dict:
    """Every tensor of the tree by name (``proj``, ``head``,
    ``backbone.<parameter>``)."""
    out = {"proj": params["proj"], "head": params["head"]}
    out.update({f"backbone.{n}": p for n, p in params["backbone"].named_parameters()})
    return out


def train_udf(params: dict, cfg, x: torch.Tensor, y: torch.Tensor, *, steps: int) -> list:
    """``steps`` full-batch AdamW steps of ``udf_loss`` on (x, y), updating
    ``params`` in place.  The first step finds the leaves the loss reaches;
    only those get gradients and moments.  Returns the losses, each before
    its step's update."""
    live = udf_leaves(params)
    for p in live.values():
        p.requires_grad_(True)
    opt, losses = None, []
    try:
        for _ in range(steps):
            loss = udf_loss(params, cfg, x, y)
            grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
            if opt is None:
                reached = [g is not None for g in grads]
                for p, r in zip(live.values(), reached):
                    p.requires_grad_(r)
                live = {n: p for (n, p), r in zip(live.items(), reached) if r}
                grads = [g for g in grads if g is not None]
                opt = optim.adamw_init(live)
            opt = optim.adamw_update(live, dict(zip(live, grads)), opt, lr=LR)
            losses.append(loss.detach())
            del loss, grads
    finally:
        for p in udf_leaves(params).values():
            p.requires_grad_(False)
    return [float(v) for v in losses]


@dataclass(eq=False)
class BackboneUDF(MLUDF):
    """A transformer-backbone classifier as an ``MLUDF``: a call pads each
    batch with zero records to ``bucket(n)`` rows (a MoE router sees the
    padding, and its capacity counts the padded tokens) and returns the
    argmax labels.  ``calls`` counts backbone calls (training steps, the
    probes and every call).  ``fn`` stays None: a bound method stored on
    the instance would hold it in a reference cycle, and its backbone's
    weights on the card until the cycle collector ran."""

    cfg: Any = None
    params: Optional[dict] = None
    losses: list = field(default_factory=list)
    train_accuracy: float = float("nan")
    calls: int = 0

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return self.labels(x)

    @property
    def device(self) -> torch.device:
        return self.params["proj"].device

    def raw_logits(self, xt: torch.Tensor) -> torch.Tensor:
        """``udf_logits`` of device rows ``xt`` as given (no padding)."""
        self.calls += 1
        return udf_logits(self.params, self.cfg, xt)

    @torch.no_grad()
    def logits(self, x: np.ndarray) -> torch.Tensor:
        """Pooled logits (n, classes) of records ``x`` (n, F), padded as
        ``fn`` pads them."""
        n = x.shape[0]
        xp = np.zeros((bucket(n), x.shape[1]), np.float32)
        xp[:n] = x
        return self.raw_logits(torch.from_numpy(xp).to(self.device))[:n]

    def labels(self, x: np.ndarray) -> np.ndarray:
        return self.logits(x).argmax(dim=-1).cpu().numpy()


def make_backbone_udf(arch: str, ds, column: int, *, steps: int = 150, seed: int = 0,
                      cfg=None, params: Optional[dict] = None, cost_ms: Optional[float] = None,
                      device="cuda") -> BackboneUDF:
    """Train ``cfg``'s backbone (``udf_config(arch)`` by default) as a
    classifier of ``ds.truth[:, column]`` on the first ``TRAIN_ROWS``
    records.  ``params`` replaces the seeded initial tree (how the JAX
    package's is carried across, ``interop.backbone_udf_params``);
    ``cost_ms`` replaces the measured per-record cost."""
    dev = resolve_device(device)
    cfg = cfg if cfg is not None else udf_config(arch)
    n_classes = int(ds.truth[:, column].max()) + 1
    if params is None:
        params = init_udf_params(cfg, ds.x.shape[1], n_classes, seed, dev)
    udf = BackboneUDF(name=f"{arch}:col{column}", fn=None, cost=float("nan"),
                      n_classes=n_classes, cfg=cfg, params=params)
    xtr = torch.from_numpy(np.asarray(ds.x[:TRAIN_ROWS], np.float32)).to(dev)
    ytr = torch.from_numpy(np.asarray(ds.truth[:TRAIN_ROWS, column], np.int64)).to(dev)

    udf.losses = train_udf(params, cfg, xtr, ytr, steps=steps)
    udf.calls += len(udf.losses)  # a backbone call a training step
    with torch.no_grad():
        udf.train_accuracy = float((udf.raw_logits(xtr).argmax(-1) == ytr).float().mean())
        if cost_ms is None:
            probe = torch.from_numpy(np.asarray(ds.x[:PROBE_ROWS], np.float32)).to(dev)
            udf.raw_logits(probe).argmax(-1)
            _sync(dev)
            t0 = time.perf_counter()
            udf.raw_logits(probe).argmax(-1)
            _sync(dev)
            cost_ms = (time.perf_counter() - t0) / PROBE_ROWS * 1e3
    udf.cost = cost_ms
    return udf


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(n: int = 12_000, *, steps: int = 100, full: bool = False, device="cuda",
        udf_params=None, udf_costs=None, log=print) -> dict:
    """The whole flow on ``device``.  ``udf_params`` / ``udf_costs``: per
    UDF, a parameter tree and a per-record cost to use instead of the
    seeded initial tree and the measured cost.  Returns the UDFs, the query,
    the plan, the server's stats and emissions, ORIG's and CORE's results,
    the saving, the accuracy and the seconds of each part."""
    dev = resolve_device(device)
    ds = make_dataset(name="stream", n=n, correlation=0.92, n_classes=3, feature_noise=1.0,
                      seed=4)
    udfs, train_s = [], []
    for i, (arch, column, seed) in enumerate(UDFS):
        t0 = time.perf_counter()
        udf = make_backbone_udf(arch, ds, column, steps=steps, seed=seed,
                                cfg=udf_config(arch, full),
                                params=None if udf_params is None else udf_params[i],
                                cost_ms=None if udf_costs is None else udf_costs[i],
                                device=dev)
        _sync(dev)
        train_s.append(time.perf_counter() - t0)
        loss = udf.losses[-1] if udf.losses else float("nan")
        log(f"  UDF[{udf.cfg.name}] col{column}: train loss {loss:.3f}, "
            f"acc {udf.train_accuracy:.3f}, {udf.cost:.4f} ms/record")
        udfs.append(udf)
    query = Query(predicates=[Predicate(udf=udfs[0], values=frozenset({0, 1})),
                              Predicate(udf=udfs[1], values=frozenset({0}))],
                  accuracy_target=0.9)
    log("query: " + " AND ".join(query.names()))

    k = TRAIN_ROWS
    t0 = time.perf_counter()
    plan = build_plan(query, ds.x[:k], OptimizeOptions(mode="core"), device=dev)
    optimize_s = time.perf_counter() - t0
    log(plan.describe())

    rest = ds.x[k:]
    server = CascadeServer(plan, tile=512, device=dev)
    t0 = time.perf_counter()
    stats = server.run_stream(rest, chunk=2048)
    _sync(dev)
    serve_s = time.perf_counter() - t0
    log(f"emitted {stats.emitted} / {len(rest)} records in {serve_s * 1e3:.0f} ms; "
        f"UDF batches per stage {stats.stage_udf_batches}, stage inputs {stats.stage_in}")

    t0 = time.perf_counter()
    orig = execute_plan(orig_plan(query), rest, device=dev)
    res = execute_plan(plan, rest, use_kernel=True, fused=True, device=dev)
    _sync(dev)
    execute_s = time.perf_counter() - t0
    saving = 1 - res.model_cost_ms / orig.model_cost_ms
    accuracy = plan_accuracy(res, orig)
    log(f"cost model: ORIG {orig.model_cost_ms:.0f} ms -> CORE {res.model_cost_ms:.0f} ms "
        f"({saving:.1%} saved); accuracy {accuracy:.3f}")
    return dict(ds=ds, udfs=udfs, query=query, plan=plan, server=server, stats=stats,
                orig=orig, res=res, saving=saving, accuracy=accuracy, train_s=train_s,
                optimize_s=optimize_s, serve_s=serve_s, execute_s=execute_s, rest=rest)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=12_000, help="records in the stream")
    ap.add_argument("--steps", type=int, default=100, help="AdamW steps a UDF")
    ap.add_argument("--full", action="store_true",
                    help="the published widths, depth cut to FULL_LAYERS")
    args = ap.parse_args(argv)
    return run(args.n, steps=args.steps, full=args.full, device=args.device)


if __name__ == "__main__":
    main()
