"""Multi-node dry run (the JAX package's ``launch/dryrun.py``): one step of
every (architecture x input shape) on the production meshes, traced on
"meta" under a fake process group of the mesh's size, with per-device
memory, flops, traffic and collective bytes from ``cost_analysis`` and
roofline terms for an NVIDIA H100 80GB HBM3.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-moe-30b-a3b \\
        --shape prefill_32k --variant opt --force
    PYTHONPATH=src python -m repro_torch.launch.dryrun --proxy-kind mixed [--device cpu]

The JAX package lowers and compiles each cell for 256 or 512 forced host
devices; here each cell runs once on rank 0 of a fake world
(``torch.testing._internal.distributed.fake_pg``, whose collectives move
nothing) with its parameters, optimizer state and batch as meta DTensors
laid out by ``distributed/sharding.py``: nothing is allocated, every
shape is the real run's.  A sweep sets its fake world up before any mesh
is made, and a cell whose mesh has another size replaces it.  A record's
numbers are per-device estimates for the production mesh, not timings.

Results are cached as JSON under results/dryrun_torch/<mesh>/<arch>__<shape>.json
(one file a cell; --force recomputes).
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.configs import SHAPES, get_config, reduced_config, supports_shape
from repro_torch.configs.registry import ARCHS
from repro_torch.util import atomic_write_text

# NVIDIA H100 80GB HBM3 (the SXM part), NVIDIA's H100 data sheet: dense
# bf16 tensor-core peak without sparsity, and HBM3 bandwidth
PEAK_FLOPS = 989.4e12
HBM_BW = 3.35e12
# NVLink 4: 900 GB/s per GPU in both directions together, 450 GB/s each
# way (the same data sheet).  A 256-card mesh spans nodes whose network is
# slower, so the collective term is a lower bound.
LINK_BW = 450e9
CARD = "NVIDIA H100 80GB HBM3"

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def fake_world(size: int) -> None:
    """Make the default process group a fake one of ``size`` ranks (this
    process rank 0), replacing one of another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
        _forget_meshes()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def _forget_meshes() -> None:
    """Drop DTensor's caches of sharding decisions and redistribution
    plans: they hold the meshes of the world just destroyed (a mesh of
    the same shape compares equal but names groups that are gone)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute

    DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache_clear()
    _redistribute.clear_redistribute_planner_cache()


def make_mesh(shape):
    """A cell's ("pod",) "data", "model" mesh of ``shape`` on "cpu" in a
    fake world of its size (meta tensors on it allocate nothing)."""
    from repro_torch.launch.mesh import _device_mesh

    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    fake_world(math.prod(shape))
    return _device_mesh(tuple(shape), names, "cpu")


class Cell(NamedTuple):
    cfg: object
    fn: object
    args: tuple
    ctx_kw: dict


def cell_config(arch: str, shape_name: str, *, reduced: bool = False, layers=None, batch=None,
                accum=None):
    """(config, shape) of a cell: the architecture's published config (or
    its reduced one), cut to ``layers`` layers (an encoder-decoder's
    encoder too) and a global batch of ``batch``, and with ``accum``
    micro-batches a train step, where they are given."""
    import dataclasses

    from repro_torch.launch.train import with_depth

    cfg = (reduced_config if reduced else get_config)(arch)
    shape = SHAPES[shape_name]
    if layers:
        cfg = with_depth(cfg, layers)
    if batch:
        shape = dataclasses.replace(shape, global_batch=batch)
    if accum:
        cfg = cfg.replace(accum_steps=accum)
    return cfg, shape


def build_cell(arch: str, shape_name: str, mesh, variant: str = "baseline", *,
               reduced: bool = False, layers=None, batch=None, accum=None, micro=None) -> Cell:
    """The cell's step and its meta DTensor arguments on ``mesh``
    (``cell_config``'s cuts; ``micro``: a train step of that many of the
    config's micro-batches).

    variant="opt" applies the JAX package's optimizations on top of the
    baseline: expert-parallel MoE and sequence-sharded attention scores,
    and for training Adafactor over 100 B parameters and bf16 gradient
    accumulation; for decode under 2-D serving, weight-stationary d_model
    sharding of the residual."""
    from repro_torch.distributed.sharding import (batch_sharding, cache_sharding, distribute,
                                                  opt_shardings, params_shardings,
                                                  serve_mode_for)
    from repro_torch.models import leaves
    from repro_torch.models.registry import input_specs, params_spec
    from repro_torch.training.train_loop import (apply_with_leaves, init_leaf_opt_state,
                                                 make_sharded_train_step)

    import dataclasses

    cfg, shape = cell_config(arch, shape_name, reduced=reduced, layers=layers, batch=batch,
                             accum=accum)
    if micro and shape.kind == "train":
        per = shape.global_batch // max(1, cfg.accum_steps)
        cfg = cfg.replace(accum_steps=micro)
        shape = dataclasses.replace(shape, global_batch=micro * per)
    ctx_kw = {"token_spec": ("batch", None, None), "mid_anchors": False,
              "ep": variant == "opt", "attn_seq": variant == "opt"}
    if variant == "opt" and shape.kind == "train":
        kw = {"grad_accum_dtype": "bfloat16"}
        if cfg.n_params() > 100e9:
            kw["optimizer"] = "adafactor"
        cfg = cfg.replace(**kw)
    specs = input_specs(cfg, shape)
    params = leaves.flat(params_spec(cfg))
    if shape.kind == "train":
        opt = init_leaf_opt_state(cfg, params)
        args = (distribute(params, params_shardings(params, mesh, "train"), requires_grad=True),
                distribute(opt, opt_shardings(opt, mesh, "train")),
                distribute(specs, batch_sharding(specs, mesh)))
        return Cell(cfg, make_sharded_train_step(cfg), args, ctx_kw)
    mode = serve_mode_for(cfg, mesh)
    p = distribute(params, params_shardings(params, mesh, mode))
    if shape.kind == "prefill":
        def prefill(p, b):
            return apply_with_leaves(cfg, "prefill", p, b)

        return Cell(cfg, prefill, (p, distribute(specs, batch_sharding(specs, mesh))), ctx_kw)

    def decode(p, c, t):
        return apply_with_leaves(cfg, "decode_step", p, c, t)

    if variant == "opt" and mode == "serve_2d":
        ctx_kw["token_spec"] = ("pod", None, "data")
    cache = distribute(specs["cache"], cache_sharding(specs["cache"], mesh))
    tokens = distribute({"tokens": specs["tokens"]}, batch_sharding(
        {"tokens": specs["tokens"]}, mesh))["tokens"]
    return Cell(cfg, decode, (p, cache, tokens), ctx_kw)


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS for the whole step (global)."""
    if shape.kind == "train":
        return cfg.flops_per_token(shape.seq_len, training=True) * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return cfg.flops_per_token(shape.seq_len, training=False) * tokens
    return cfg.flops_per_token(shape.seq_len, training=False) * shape.global_batch


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_flatten

    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _local_bytes(tensors) -> int:
    from repro_torch.distributed.sharding import local_bytes

    return local_bytes(list(tensors))


def mesh_tag(mesh_shape, variant: str) -> str:
    tag = "pod" + "x".join(map(str, mesh_shape))
    return tag + ("" if variant == "baseline" else f"_{variant}")


def trace_cell(cell: Cell, mesh):
    """Run ``cell``'s step once under ``mesh`` inside ``CostMode``:
    (costs, argument bytes, output bytes, aliased bytes), per device."""
    from repro_torch.distributed import ctx
    from repro_torch.launch.cost_analysis import CostMode

    args = _tensors(cell.args)
    with ctx.use_mesh(mesh, **cell.ctx_kw), CostMode() as mode:
        out = cell.fn(*cell.args)
    outs = _tensors(out)
    return (mode.costs, _local_bytes(args), _local_bytes(outs),
            _local_bytes(t for t in outs if any(t is a for a in args)))


TRACE_LIMIT = 12  # layers x micro-batches a train cell traces in full
HOMOGENEOUS = ("dense", "moe", "ssm", "vlm")  # families whose layers repeat the same ops


def _measure(arch, shape_name, mesh, variant, reduced, layers, batch, accum,
             micro=None) -> dict:
    """One trace's per-device numbers, flattened to scalars."""
    cell = build_cell(arch, shape_name, mesh, variant, reduced=reduced, layers=layers,
                      batch=batch, accum=accum, micro=micro)
    costs, arg_b, out_b, alias_b = trace_cell(cell, mesh)
    out = {"flops": costs.flops, "hbm_bytes": costs.hbm_bytes, "ops": costs.ops,
           "high_water_bytes": costs.high_water_bytes, "argument_bytes": arg_b,
           "output_bytes": out_b, "alias_bytes": alias_b}
    out.update({f"collective_bytes/{k}": v for k, v in costs.collective_bytes.items()})
    out.update({f"collective_count/{k}": v for k, v in costs.collective_count.items()})
    out.update({f"kernel_flops/{k}": v for k, v in costs.kernel_flops.items()})
    out.update({f"kernel_calls/{k}": v for k, v in costs.kernel_calls.items()})
    return {"numbers": out, "top_collectives": costs.top_collectives[:12],
            "top_hbm": costs.top_hbm[:12], "top_flops": costs.top_flops[:12]}


def _bilinear(points: dict, l0: int, m0: int, L: int, M: int) -> dict:
    """A step's numbers at L layers and M micro-batches from traces at
    (l0, m0), (l0 + 1, m0) and, when M > 1, (l0, m0 + 1) and (l0 + 1, m0 + 1):
    each is a + b.L + c.M + d.L.M, as the layer stack and the micro-batch
    loop repeat the same ops (the JAX package's analyzer multiplies a while
    body by its trip count the same way).  m0 is 2 for an accumulating
    step (one micro-batch takes another path), else 1.  The high-water
    mark, a maximum, is taken linear in the layers at m0 micro-batches."""
    keys = set().union(*(p.keys() for p in points.values()))
    out = {}
    for k in keys:
        t11, t21 = points[(l0, m0)].get(k, 0.0), points[(l0 + 1, m0)].get(k, 0.0)
        dl, dm = L - l0, M - m0
        out[k] = t11 + dl * (t21 - t11)
        if dm and k != "high_water_bytes":
            t12, t22 = points[(l0, m0 + 1)].get(k, 0.0), points[(l0 + 1, m0 + 1)].get(k, 0.0)
            out[k] += dm * (t12 - t11) + dl * dm * (t22 - t21 - t12 + t11)
    return out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False, force: bool = False,
             variant: str = "baseline", mesh_shape=None, reduced: bool = False, layers=None,
             batch=None, accum=None, results_dir: Path = RESULTS_DIR,
             extrapolate=None) -> dict:
    """One cell's record (cached as JSON unless ``force``).  The mesh is
    the production one, (16, 16) or (2, 16, 16) with ``multi_pod``, unless
    ``mesh_shape`` names another; ``reduced`` takes the architecture's
    reduced config, ``layers``, ``batch`` and ``accum`` change it
    (``cell_config``).

    A train step of more than TRACE_LIMIT layers x micro-batches is traced
    at two depths and one and two micro-batches and its numbers
    extrapolated (``_bilinear``); ``extrapolate`` forces either way.  Its
    argument bytes are always the full cell's (laid out, not traced)."""
    mesh_shape = tuple(mesh_shape or ((2, 16, 16) if multi_pod else (16, 16)))
    tag = mesh_tag(mesh_shape, variant)
    out_dir = Path(results_dir) / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    name = arch + ("-reduced" if reduced else "") + (f"-L{layers}" if layers else "") + (
        f"-B{batch}" if batch else "") + (f"-A{accum}" if accum else "")
    out_file = out_dir / f"{name}__{shape_name}.json"
    if out_file.exists() and not force:
        return json.loads(out_file.read_text())
    cfg, shape = cell_config(arch, shape_name, reduced=reduced, layers=layers, batch=batch,
                             accum=accum)
    rec = {"arch": name, "shape": shape_name, "mesh": tag, "status": "skipped"}
    if not supports_shape(cfg, shape):
        rec["reason"] = "long_500k requires sub-quadratic attention (see DESIGN.md)"
        atomic_write_text(out_file, json.dumps(rec, indent=1))
        return rec
    chips = math.prod(mesh_shape)
    t0 = time.perf_counter()
    try:
        mesh = make_mesh(mesh_shape)
        accum = max(1, cfg.accum_steps) if shape.kind == "train" else 1
        if extrapolate is None:
            extrapolate = (shape.kind == "train" and cfg.num_layers * accum > TRACE_LIMIT
                           and cfg.family in HOMOGENEOUS)
        if extrapolate:
            l0 = (cfg.moe.first_dense if cfg.moe is not None else 0) + 1
            m0 = 2 if accum > 1 else 1
            micros = (m0, m0 + 1) if accum > m0 else (m0,)
            traces = {(lay, m): _measure(arch, shape_name, mesh, variant, reduced, lay, batch,
                                         accum, micro=m)
                      for lay in (l0, l0 + 1) for m in micros}
            nums = _bilinear({k: t["numbers"] for k, t in traces.items()}, l0, m0,
                             cfg.num_layers, accum)
            top = traces[(l0 + 1, m0)]
            full = build_cell(arch, shape_name, mesh, variant, reduced=reduced, layers=layers,
                              batch=batch, accum=accum)
            nums["argument_bytes"] = _local_bytes(_tensors(full.args))
            rec["traced"] = {"layers": [l0, l0 + 1], "micro_batches": list(micros),
                             "extrapolated_to": {"layers": cfg.num_layers,
                                                 "micro_batches": accum}}
        else:
            top = _measure(arch, shape_name, mesh, variant, reduced, layers, batch, accum)
            nums = top["numbers"]
            rec["traced"] = {"layers": [cfg.num_layers], "micro_batches": [accum]}
        t_trace = time.perf_counter() - t0
        rec.update(_record(nums, cfg, shape, chips, variant))
        rec.update(status="ok", trace_s=t_trace, top_collectives=top["top_collectives"],
                   top_hbm=top["top_hbm"], top_flops=top["top_flops"])
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    rec["seconds"] = time.perf_counter() - t0
    atomic_write_text(out_file, json.dumps(rec, indent=1))
    return rec


def _record(n: dict, cfg, shape, chips: int, variant: str) -> dict:
    def group(prefix):
        return {k.split("/", 1)[1]: v for k, v in n.items() if k.startswith(prefix + "/")}

    coll = group("collective_bytes")
    mf = model_flops(cfg, shape)
    t_comp = n["flops"] / PEAK_FLOPS
    t_mem = n["hbm_bytes"] / HBM_BW
    t_coll = sum(coll.values()) / LINK_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    t_bound = max(terms.values())
    t_model = mf / (chips * PEAK_FLOPS)
    mem_floor = n["argument_bytes"] + n["output_bytes"] - n["alias_bytes"]
    return dict(
        chips=chips, variant=variant, card=CARD, layers=cfg.num_layers,
        global_batch=shape.global_batch, seq_len=shape.seq_len,
        memory={
            "argument_bytes_per_device": int(n["argument_bytes"]),
            "output_bytes_per_device": n["output_bytes"],
            "alias_bytes_per_device": n["alias_bytes"],
            "high_water_bytes_per_device": n["high_water_bytes"],
            "peak_estimate_bytes_per_device": n["argument_bytes"] + n["high_water_bytes"],
        },
        costs={
            "flops_per_device": n["flops"],
            "hbm_bytes_per_device": n["hbm_bytes"],
            "collective_bytes_per_device": coll,
            "collective_count": group("collective_count"),
            "kernel_flops_per_device": group("kernel_flops"),
            "kernel_calls": group("kernel_calls"),
            "ops": n["ops"],
            "note": ("hbm bytes count each op's operands and outputs: PyTorch fuses nothing "
                     "here, so they overstate XLA's fusion-aware count"),
        },
        roofline={
            "peak_flops": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW, "link_bytes_per_s": LINK_BW,
            "t_compute_s": t_comp, "t_memory_s": t_mem, "t_collective_s": t_coll,
            "dominant": max(terms, key=terms.get),
            "model_flops": mf, "model_flops_time_s": t_model,
            "useful_flops_ratio": mf / max(n["flops"] * chips, 1.0),
            "roofline_fraction": t_model / max(t_bound, 1e-30),
            "memory_floor_bytes": mem_floor,
            "memory_efficiency": mem_floor / max(n["hbm_bytes"], 1.0),
        })


def cascade_dryrun(proxy_kind: str, *, n: int = 6000, preds: int = 3, seed: int = 0,
                   device="cuda") -> bool:
    """Build-and-verify dry run of the fused cascade scorer for one proxy
    family mix: a small synthetic query, a plan with ``proxy_kind``
    proxies, packed through the ProxyFamily format, and the fused path
    (``cascade_score`` on a card; raises without one unless ``device`` is
    "cpu") checked end to end against the reference executor: the same
    survivors up to 3 boundary ties, and every stage on the scorer."""
    return cascade_report(proxy_kind, n=n, preds=preds, seed=seed, device=device)["ok"]


def cascade_report(proxy_kind: str, *, n: int = 6000, preds: int = 3, seed: int = 0,
                   device="cuda") -> dict:
    """``cascade_dryrun``'s checks and what they saw."""
    from repro_torch.core import OptimizeOptions, build_plan, execute_plan
    from repro_torch.data.synthetic import make_dataset, make_query, make_udfs
    from repro_torch.kernels.ops import cascade_scorer_for_plan
    from repro_torch.util import resolve_device

    dev = resolve_device(device)
    ds = make_dataset(n=n, correlation=0.9, seed=seed)
    udfs = make_udfs(ds, hidden=16, depth=1, train_rows=1000, seed=seed,
                     declared_cost_ms=10.0, device=dev)
    q = make_query(ds, udfs, columns=list(range(preds)), target_selectivity=0.5,
                   accuracy_target=0.9, seed=seed + 1)
    k = max(800, n // 10)
    plan = build_plan(q, ds.x[:k], OptimizeOptions(mode="core-a", step=0.05, kind=proxy_kind),
                      device=dev)
    print(plan.describe())
    scorer, _hit = cascade_scorer_for_plan(plan, device=dev)
    packed = scorer.packed
    print(f"packed cascade: families={packed.families} hidden={packed.hidden} "
          f"(F, H, P)=({packed.n_features}, {packed.H}, {packed.n_stages}) "
          f"block_m={scorer.block_m}")
    x = ds.x[k:]
    ref = execute_plan(plan, x, use_kernel=False, device=dev)
    fus = execute_plan(plan, x, use_kernel=True, fused=True, device=dev)
    # boundary ties allowed: folding the MLP standardizer agrees with the
    # reference to ~1e-4, so records at a threshold may flip
    n_diff = len(set(ref.passed.tolist()) ^ set(fus.passed.tolist()))
    used = [s.used_kernel for s in fus.stages]
    print(f"fused vs reference: disagreements={n_diff} used_kernel={used} "
          f"fused_score_ms={fus.fused_score_ms:.1f}")
    ok = n_diff <= 3 and all(used)
    print("cascade dry-run:", "OK" if ok else "MISMATCH")
    return {"ok": ok, "disagreements": n_diff, "used_kernel": used,
            "families": list(packed.families), "stages": packed.n_stages,
            "passed": int(len(fus.passed)), "records": int(x.shape[0]),
            "fused_score_ms": fus.fused_score_ms}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=["baseline", "opt"])
    ap.add_argument("--mesh", default=None,
                    help="another mesh than the production one, e.g. 1x1 or 2x4")
    ap.add_argument("--reduced", action="store_true", help="the reduced configs")
    ap.add_argument("--results-dir", default=str(RESULTS_DIR))
    ap.add_argument("--proxy-kind", default=None, choices=["svm", "mlp", "mixed"],
                    help="run a fused-cascade dry run for this proxy family mix instead of "
                         "the architecture sweep")
    ap.add_argument("--device", default="cuda",
                    help="--proxy-kind's device (CUDA by default: raises without a card)")
    args = ap.parse_args(argv)

    if args.proxy_kind is not None:
        raise SystemExit(0 if cascade_dryrun(args.proxy_kind, device=args.device) else 1)

    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    cells = [(a, s) for a in archs for s in shapes]
    if args.mesh:
        meshes = [tuple(int(d) for d in args.mesh.split("x"))]
    else:
        meshes = [(16, 16), (2, 16, 16)] if args.both_meshes else (
            [(2, 16, 16)] if args.multi_pod else [(16, 16)])
    fake_world(math.prod(meshes[0]))  # before any mesh is made
    for mesh_shape in meshes:
        for a, s in cells:
            rec = run_cell(a, s, mesh_shape=mesh_shape, force=args.force, variant=args.variant,
                           reduced=args.reduced, results_dir=Path(args.results_dir))
            extra = ""
            if rec["status"] == "ok":
                r, m, c = rec["roofline"], rec["memory"], rec["costs"]
                extra = (f" dom={r['dominant']} frac={r['roofline_fraction']:.3f}"
                         f" arg={m['argument_bytes_per_device']}"
                         f" high_water={m['high_water_bytes_per_device']:.0f}"
                         f" flops={c['flops_per_device']:.4e}"
                         f" coll={sum(c['collective_bytes_per_device'].values()):.4e}")
            elif rec["status"] == "error":
                extra = " " + rec["error"][:200]
            print(f"[{rec['mesh']}] {a} x {s}: {rec['status']}{extra} "
                  f"({rec.get('seconds', 0.0):.1f}s)", flush=True)
            print("RECORD " + json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
