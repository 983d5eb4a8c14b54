"""The port stands alone: it imports with ``jax``, ``ml_dtypes`` and the JAX
package blocked, no module names them even in an import inside a function,
its artifact path (COREWIRE and the plan cache) and its fleet (inline, and
worker processes blocked the same way) run with them blocked, and its
CUDA-default entry points raise on a host without a card instead of
carrying on on the CPU."""
import ast
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "ml_dtypes", "repro")

_BLOCK = textwrap.dedent("""
    import importlib, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
""")

_BLOCKED_IMPORT = _BLOCK + textwrap.dedent("""
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ml_dtypes", "repro"))
    assert not leaked, leaked
    print(" ".join(names))
    print(len(names))
""")

# the artifact path end to end on the CPU: a cold build through the plan
# cache, an exact hit, the COREPLNC container, frames and the quant gate
_BLOCKED_ARTIFACTS = _BLOCK + textwrap.dedent("""
    import dataclasses
    from repro_torch.core import OptimizeOptions, PlanCache
    from repro_torch.data.synthetic import make_dataset, make_query, make_udfs
    from repro_torch.kernels import ops

    ds = make_dataset(n=3000, n_columns=2, seed=3)
    udfs = make_udfs(ds, hidden=8, depth=1, train_rows=600, seed=3, declared_cost_ms=5.0,
                     device="cpu")
    q = make_query(ds, udfs, columns=[0, 1], seed=4)
    x, opts = ds.x[:1000], OptimizeOptions(step=0.05)
    cache = PlanCache()
    plan, info = cache.optimize_query(q, x, opts, device="cpu")
    assert info["path"] == "cold", info
    restored = PlanCache.from_bytes(cache.to_bytes())
    assert restored.to_bytes() == cache.to_bytes()
    plan2, info = restored.optimize_query(q, x, opts, device="cpu")
    assert info["path"] == "hit", info
    blob = ops.serialize_scorer(dataclasses.replace(plan, meta={"quant_dtype": "int8"}))
    frame = ops.serialize_frame(ops.FRAME_RESYNC, 1, blob)
    plan3, scorer = ops.deserialize_scorer(ops.deserialize_frame(frame)[2], q, device="cpu")
    assert ops.serialize_scorer(plan3, scorer) == blob
    rep = ops.quant_parity_report(plan, ds.x[1000:2000], dtype="fp8", device="cpu")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ml_dtypes", "repro"))
    assert not leaked, leaked
    print("artifacts ok", rep["flips_within_tol"])
""")


# the fleet end to end on the CPU: two inline hosts, then two worker
# processes (each importing the port afresh) on the same plan and streams
_BLOCKED_FLEET = _BLOCK + textwrap.dedent("""
    import torch
    from repro_torch.core import OptimizeOptions, build_plan
    from repro_torch.data.synthetic import (make_dataset, make_query,
                                            make_sharded_drifting_streams, make_udfs)
    from repro_torch.distributed.serving import ShardedCascadeServer
    from repro_torch.serving.stats import AdaptivePolicy

    torch.set_num_threads(1)  # many small products; the workers take this count too
    spec = {"dataset": dict(n=3000, n_columns=2, seed=3),
            "udfs": dict(hidden=8, depth=1, train_rows=600, seed=3, declared_cost_ms=5.0),
            "query": dict(columns=[0, 1], seed=4)}
    ds = make_dataset(**spec["dataset"])
    q = make_query(ds, make_udfs(ds, **spec["udfs"], device="cpu"), **spec["query"])
    opts = OptimizeOptions(step=0.05, keep_state=True)
    xs = [s.x for s in make_sharded_drifting_streams(ds, 2, 300, 900,
                                                      shift_targets={0: 2.8, 1: -2.6},
                                                      corr_gain=2.5, seed=3)]
    policy = AdaptivePolicy(audit_rate=0.03, threshold=50.0, min_reservoir=128,
                            cooldown_records=512, reservoir_capacity=512)
    for kw in ({}, dict(transport="process", worker_spec=spec, init_timeout_s=120.0)):
        srv = ShardedCascadeServer(build_plan(q, ds.x[:1000], opts, device="cpu"), 2,
                                   tile=256, policy=policy, seed=3, device="cpu", **kw)
        st = srv.run_streams(xs, chunk=300)
        assert st.submitted == st.emitted + st.rejected == 2400, st
        assert {h.epoch for h in srv.hosts} == {st.final_epoch}
        print("fleet ok", kw.get("transport", "inline"), st.votes_cast, st.swaps_committed)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ml_dtypes", "repro"))
    assert not leaked, leaked
""")


def _run_blocked(code: str, pythonpath=None) -> subprocess.CompletedProcess:
    path = [str(p) for p in (pythonpath or [])] + [str(ROOT / "src")]
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, env={"PYTHONPATH": os.pathsep.join(path),
                                         "PATH": "/usr/bin:/bin"}, timeout=240)


def _imported_names(tree: ast.AST):
    """Every module an import statement names, at top level or inside a
    function (absolute imports; the port's own relative ones name no
    outside package)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_names_jax_or_repro_even_inside_a_function():
    """A lazy import inside a function (the JAX package's ``plan_cache.py``
    and ``kernels/ops.py`` import that way) escapes the import test above;
    the port's modules and ``chip_smoke.py`` name neither package anywhere."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    rel = {str(f.relative_to(ROOT)) for f in files}
    assert {"src/repro_torch/core/plan_cache.py", "src/repro_torch/kernels/ops.py"} <= rel
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imported_names(ast.parse(f.read_text()))
           if name.split(".")[0] in BLOCKED]
    assert not bad, bad


def test_artifact_path_runs_without_jax_or_repro():
    proc = _run_blocked(_BLOCKED_ARTIFACTS)
    assert proc.returncode == 0, proc.stderr
    assert "artifacts ok True" in proc.stdout


def test_fleet_runs_without_jax_or_repro(tmp_path):
    """A two-host inline fleet and a two-worker process fleet on the CPU
    with the blocker in the parent; each worker gets it too, from a
    ``sitecustomize.py`` first on its ``PYTHONPATH`` that also leaves a
    mark per process, so the test sees it ran in both workers."""
    (tmp_path / "sitecustomize.py").write_text(_BLOCK + textwrap.dedent(f"""
        import os
        open(os.path.join({str(tmp_path)!r}, f"blocked.{{os.getpid()}}"), "w").close()
    """))
    proc = _run_blocked(_BLOCKED_FLEET, pythonpath=[tmp_path])
    assert proc.returncode == 0, proc.stderr
    assert "fleet ok inline" in proc.stdout and "fleet ok process" in proc.stdout
    assert len(list(tmp_path.glob("blocked.*"))) == 3  # the parent and both workers


def test_port_imports_without_jax_or_repro():
    proc = _run_blocked(_BLOCKED_IMPORT)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 30  # every module of the package
    for name in ("repro_torch.models.transformer", "repro_torch.kernels.flash_attention",
                 "repro_torch.configs.registry", "repro_torch.models.ssm",
                 "repro_torch.kernels.ssd_scan", "repro_torch.serving.stats",
                 "repro_torch.serving.engine", "repro_torch.serving.frontend",
                 "repro_torch.serving.multiquery", "repro_torch.launch.serve",
                 "repro_torch.core.plan_cache", "repro_torch.kernels.ops",
                 "repro_torch.distributed.serving", "repro_torch.distributed.consensus",
                 "repro_torch.distributed.procworker",
                 "repro_torch.distributed.fault_tolerance"):
        assert name in proc.stdout


def test_cuda_default_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    from repro_torch.core import Query, build_plan, execute_plan, orig_plan
    from repro_torch.core.builder import ProxyBuilder
    from repro_torch.core.proxy import train_proxy
    from repro_torch.data.synthetic import make_dataset, make_query, make_udfs
    from repro_torch.kernels.ops import CascadeScorer
    from repro_torch.configs import reduced_config
    from repro_torch.interop import ssm_params, transformer_params
    from repro_torch.kernels.flash_attention import _lib as flash_attention_lib
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import _lib as ssd_chunk_lib
    from repro_torch.kernels.ssd_scan import ssd_chunk
    from repro_torch.models import ssm, transformer
    from repro_torch.models.registry import make_batch
    from repro_torch.training.proxy_models import train_linear_svm
    from repro_torch.core import CoreSession, PlanCache
    from repro_torch.kernels.ops import deserialize_scorer, quant_parity_report, serialize_scorer
    from repro_torch.launch import serve
    from repro_torch.serving.engine import CascadeServer
    from repro_torch.serving.multiquery import MultiQueryEngine
    from repro_torch.distributed.serving import ShardedCascadeServer

    ds = make_dataset(n=400, n_columns=1, seed=0)
    udfs = make_udfs(ds, hidden=8, depth=1, train_rows=200, seed=0, declared_cost_ms=1.0,
                     device="cpu")
    query = make_query(ds, udfs, columns=[0])
    x = ds.x[:200].astype(np.float32)
    labels = udfs[0](x) == 0
    proxy = train_proxy(x, labels, 0, (), device="cpu")
    plan = build_plan(query, x, device="cpu")
    blob = serialize_scorer(plan)
    hit_cache = PlanCache()
    hit_cache.optimize_query(query, x, device="cpu")
    cfg = reduced_config("deepseek-67b")
    ssm_cfg = reduced_config("mamba2-2.7b")
    calls = {
        "transformer.init": lambda: transformer.init(0, cfg),
        "transformer.init_cache": lambda: transformer.init_cache(cfg, 1, 8),
        "make_batch": lambda: make_batch(cfg, 1, 8),
        "transformer_params": lambda: transformer_params({}, cfg),
        "ssm.init": lambda: ssm.init(0, ssm_cfg),
        "ssm.init_cache": lambda: ssm.init_cache(ssm_cfg, 1, 16),
        "ssm_params": lambda: ssm_params({}, ssm_cfg),
        "make_udfs": lambda: make_udfs(ds, hidden=8, depth=1, train_rows=200),
        "build_plan": lambda: build_plan(query, x),
        "ProxyBuilder": lambda: ProxyBuilder(query, x),
        "train_proxy": lambda: train_proxy(x, labels, 0, ()),
        "train_linear_svm": lambda: train_linear_svm(x, np.where(labels, 1.0, -1.0)),
        "CascadeScorer": lambda: CascadeScorer([proxy.params], [0.0]),
        "execute_plan": lambda: execute_plan(orig_plan(query), x),
        "CascadeServer": lambda: CascadeServer(orig_plan(query)),
        "CoreSession": lambda: CoreSession(),
        "MultiQueryEngine": lambda: MultiQueryEngine([]),
        "ShardedCascadeServer": lambda: ShardedCascadeServer(plan),
        "serve.main": lambda: serve.main(["--n", "2000"]),
        "deserialize_scorer": lambda: deserialize_scorer(blob, query),
        "quant_parity_report": lambda: quant_parity_report(plan, x),
        "PlanCache.optimize_query": lambda: PlanCache().optimize_query(query, x),
        "PlanCache.optimize_query (hit)": lambda: hit_cache.optimize_query(query, x),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the kernel's route never lands on the plain version for a non-CPU tensor,
    # and without the toolkit its build raises
    q = torch.zeros(1, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        flash_attention(q, q, q)
    x = torch.zeros(1, 16, 2, 8, device="meta")
    dA = torch.zeros(1, 16, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ssd_chunk(x, dA, x, x)
    if shutil.which("nvcc") is None and not Path("/usr/local/cuda/bin/nvcc").exists():
        for lib in (flash_attention_lib, ssd_chunk_lib):
            with pytest.raises(RuntimeError, match="nvcc not found"):
                lib()
    assert isinstance(query, Query)
