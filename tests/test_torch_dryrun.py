"""The port's dry run (``repro_torch.launch.dryrun``, ``cost_analysis``)
against the JAX package's.

* ``cost_analysis`` on the JAX fixture's step (``tests/test_distribution.py``):
  10 iterations of an all-gather of a (32, 64) f32 shard to (32, 128), then
  a product with a (128, 64) slice: exactly 10 * 2 * 32 * 64 * 128 flops and
  10 * 32 * 128 * 4 all-gather bytes.
* ``run_cell`` for reduced dense and MoE configs, baseline and opt, on
  fake (2, 4) and (16, 16) worlds: per device, the argument bytes equal the
  sum of the local shard bytes that JAX's ``NamedSharding``s give on an
  ``AbstractMesh`` of the same shape; flops > 0 and the useful-flops ratio
  in (0, 1.5], as the JAX package's dry-run records are held.
* ``cascade_dryrun(..., device="cpu")`` passes.

The fake worlds live in one subprocess, so that no process group is left
in the test process.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
from _one_thread import one_thread  # noqa: F401
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import SHAPES as J_SHAPES
from repro.configs import reduced_config as jax_reduced_config
from repro.distributed import sharding as jsh
from repro.models import registry as jreg
from repro.training.train_loop import init_opt_state as j_init_opt_state

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(arch, shape, variant, mesh)
         for mesh in ((2, 4), (16, 16))
         for arch, shape in (("llama3-405b", "train_4k"), ("qwen3-moe-30b-a3b", "prefill_32k"))
         for variant in ("baseline", "opt")]

SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch import cost_analysis, dryrun

    # the JAX fixture's step on a model axis of 2
    dryrun.fake_world(2)
    from repro_torch.launch.mesh import _device_mesh
    mesh = _device_mesh((2,), ("model",), "cpu")
    x = distribute_tensor(torch.empty((32, 128), device="meta"), mesh, [Shard(1)])
    w = torch.empty((10, 128, 64), device="meta")

    def step(x, w):
        out = None
        for i in range(10):
            out = x.redistribute(mesh, [Replicate()]).to_local() @ w[i]
        return out

    _, c = cost_analysis.analyze(step, x, w)
    print("FIXTURE " + json.dumps({"flops": c.flops, "coll": c.collective_bytes,
                                   "count": c.collective_count}))
    for arch, shape, variant, mesh in json.loads(sys.argv[1]):
        rec = dryrun.run_cell(arch, shape, variant=variant, mesh_shape=tuple(mesh),
                              reduced=True, force=True, results_dir=sys.argv[2])
        print("RECORD " + json.dumps(rec))
    for extrapolate in (False, True):
        rec = dryrun.run_cell("llama3-405b", "train_4k", mesh_shape=(2, 4), reduced=True,
                              layers=3, accum=4, force=True, results_dir=sys.argv[2],
                              extrapolate=extrapolate)
        print("EXTRA " + json.dumps(rec))
""")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    r = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(CELLS), str(out)],
                       capture_output=True, text=True, cwd=ROOT, timeout=600,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    fixture = json.loads(next(l for l in lines if l.startswith("FIXTURE "))[8:])
    recs = [json.loads(l[7:]) for l in lines if l.startswith("RECORD ")]
    extra = [json.loads(l[6:]) for l in lines if l.startswith("EXTRA ")]
    return fixture, {(c[0], c[1], c[2], tuple(c[3])): rec for c, rec in zip(CELLS, recs)}, extra


def test_cost_analysis_fixture(records):
    fixture = records[0]
    assert fixture["flops"] == 10 * 2 * 32 * 64 * 128
    assert fixture["coll"] == {"all-gather": 10 * 32 * 128 * 4}
    assert fixture["count"] == {"all-gather": 10}


def _jax_shard_bytes(tree, shardings) -> int:
    """Per-device bytes of ``tree``'s leaves under ``shardings``; 0-d leaves
    (the optimizer's step counter: a device scalar in JAX, a host int in
    the port) left out."""
    leaves = jax.tree_util.tree_leaves(tree)
    shs = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shs)
    return sum(int(np.prod(sh.shard_shape(l.shape))) * np.dtype(l.dtype).itemsize
               for l, sh in zip(leaves, shs) if l.shape)


def _jax_argument_bytes(arch, shape_name, variant, mesh_shape) -> int:
    names = ("data", "model") if len(mesh_shape) == 2 else ("pod", "data", "model")
    mesh = AbstractMesh(tuple(mesh_shape), names)
    cfg = jax_reduced_config(arch)
    shape = J_SHAPES[shape_name]
    if variant == "opt" and shape.kind == "train":
        kw = {"grad_accum_dtype": "bfloat16"}
        if cfg.n_params() > 100e9:
            kw["optimizer"] = "adafactor"
        cfg = cfg.replace(**kw)
    params = jreg.params_spec(cfg)
    specs = jreg.input_specs(cfg, shape)
    if shape.kind == "train":
        opt = jax.eval_shape(lambda: j_init_opt_state(cfg, params))
        return (_jax_shard_bytes(params, jsh.params_shardings(params, mesh, "train"))
                + _jax_shard_bytes(opt, jsh.opt_shardings(opt, mesh, "train"))
                + _jax_shard_bytes(specs, jsh.batch_sharding(specs, mesh)))
    mode = jsh.serve_mode_for(cfg, mesh)
    return (_jax_shard_bytes(params, jsh.params_shardings(params, mesh, mode))
            + _jax_shard_bytes(specs, jsh.batch_sharding(specs, mesh)))


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3][0]}x{c[3][1]}")
def test_run_cell_matches_jax_shard_bytes(records, cell):
    arch, shape, variant, mesh = cell
    rec = records[1][(arch, shape, variant, tuple(mesh))]
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["chips"] == int(np.prod(mesh))
    assert rec["memory"]["argument_bytes_per_device"] == _jax_argument_bytes(*cell)
    assert rec["costs"]["flops_per_device"] > 0
    r = rec["roofline"]
    assert r["t_compute_s"] > 0
    assert 0 < r["useful_flops_ratio"] <= 1.5, r
    if shape == "train_4k":  # FSDP gathers weights and reduces gradients
        assert rec["costs"]["collective_bytes_per_device"]["all-gather"] > 0
        assert rec["memory"]["alias_bytes_per_device"] > 0
    if variant == "opt" and arch.startswith("qwen3"):  # experts run where they lie
        assert rec["costs"]["collective_count"].get("all-reduce", 0) > 0


def test_cascade_dryrun_on_cpu():
    from repro_torch.launch.dryrun import cascade_dryrun

    assert cascade_dryrun("mixed", device="cpu")


def test_extrapolated_train_step_equals_the_full_trace(records):
    """A train step traced at 1 and 2 layers and 1 and 2 micro-batches and
    extrapolated to 3 layers x 4 micro-batches gives the full trace's
    flops exactly and its bytes within 1e-4."""
    full, extra = records[2]
    assert full["status"] == extra["status"] == "ok"
    assert full["traced"]["layers"] == [3] and extra["traced"]["layers"] == [1, 2]
    assert extra["costs"]["flops_per_device"] == full["costs"]["flops_per_device"]
    assert extra["memory"]["argument_bytes_per_device"] == full["memory"]["argument_bytes_per_device"]
    for key in ("hbm_bytes_per_device",):
        assert abs(extra["costs"][key] / full["costs"][key] - 1) <= 1e-4
    for kind, b in full["costs"]["collective_bytes_per_device"].items():
        assert abs(extra["costs"]["collective_bytes_per_device"][kind] / b - 1) <= 1e-4, kind
