"""The port stands alone: it imports with ``jax``, ``ml_dtypes`` and the JAX
package blocked, and its CUDA-default entry points raise on a host without
a card instead of carrying on on the CPU."""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_BLOCKED_IMPORT = textwrap.dedent("""
    import importlib, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ml_dtypes", "repro"))
    assert not leaked, leaked
    print(len(names))
""")


def test_port_imports_without_jax_or_repro():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], capture_output=True,
                          text=True, cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                                    "PATH": "/usr/bin:/bin"}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20  # every module of the package


def test_cuda_default_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    from repro_torch.core import Query, build_plan, execute_plan, orig_plan
    from repro_torch.core.builder import ProxyBuilder
    from repro_torch.core.proxy import train_proxy
    from repro_torch.data.synthetic import make_dataset, make_query, make_udfs
    from repro_torch.kernels.ops import CascadeScorer
    from repro_torch.training.proxy_models import train_linear_svm

    ds = make_dataset(n=400, n_columns=1, seed=0)
    udfs = make_udfs(ds, hidden=8, depth=1, train_rows=200, seed=0, declared_cost_ms=1.0,
                     device="cpu")
    query = make_query(ds, udfs, columns=[0])
    x = ds.x[:200].astype(np.float32)
    labels = udfs[0](x) == 0
    proxy = train_proxy(x, labels, 0, (), device="cpu")
    calls = {
        "make_udfs": lambda: make_udfs(ds, hidden=8, depth=1, train_rows=200),
        "build_plan": lambda: build_plan(query, x),
        "ProxyBuilder": lambda: ProxyBuilder(query, x),
        "train_proxy": lambda: train_proxy(x, labels, 0, ()),
        "train_linear_svm": lambda: train_linear_svm(x, np.where(labels, 1.0, -1.0)),
        "CascadeScorer": lambda: CascadeScorer([proxy.params], [0.0]),
        "execute_plan": lambda: execute_plan(orig_plan(query), x),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert isinstance(query, Query)
