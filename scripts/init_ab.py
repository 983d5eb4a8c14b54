"""Time one tree's full-width model inits on the card, for A/B runs.

    python3 scripts/init_ab.py [--root TREE] [--turns 2]

Imports ``repro_torch`` from ``TREE/src`` (default: this checkout) and
times, on the host clock around work that ends in a ``synchronize``, the
inits of ``chip_smoke.py``'s three full-width paths: ``dense_path``
(deepseek-67b cut to 4 layers, bf16: the family's ``init`` from seed 0 and
the 4 x 4,096-token batch), ``ssm_path`` (mamba2-2.7b, all 64 layers, the
same batch) and ``udf_path`` (``transformer_udf_serving.init_udf_params``
of both UDFs at published widths: llama3-405b at 1 layer, qwen3-moe-30b-a3b
at 2).  The first turn includes the kernels' build and first launches; the
least of ``--turns`` is the one to compare.  Where the tree has the
threefry kernel (``kernels/threefry.py``), its launches a turn are counted.

Prints one line ``AB {...}`` with the tree, the card (name and power limit
from ``nvidia-smi``) and each init's seconds, every turn listed.  To
compare two trees, unpack the parent into a directory git ignores (``git
archive HEAD | tar -x -C build/parent``) and run parent, change, change,
parent in one card call.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

PATHS = ("dense_path", "ssm_path", "udf_path")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("init_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from repro_torch import transformer_udf_serving as T
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_family, make_batch

    try:
        from repro_torch.kernels import threefry
    except ImportError:
        threefry = None
    dev = torch.device("cuda", 0)

    def dense_path():
        cfg = get_config("deepseek-67b").replace(num_layers=4)
        return get_family(cfg).init(0, cfg, device=dev), make_batch(cfg, 4, 4096, 0, device=dev)

    def ssm_path():
        cfg = get_config("mamba2-2.7b")
        return get_family(cfg).init(0, cfg, device=dev), make_batch(cfg, 4, 4096, 0, device=dev)

    def udf_path():
        return [T.init_udf_params(T.udf_config(arch, full=True), 64, 4, seed, device=dev)
                for arch, _column, seed in T.UDFS]

    seconds = {p: [] for p in PATHS}
    launches = {p: [] for p in PATHS}
    for _ in range(args.turns):
        for name, fn in zip(PATHS, (dense_path, ssm_path, udf_path)):
            if threefry is not None:
                threefry.reset_launches()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            made = fn()
            torch.cuda.synchronize(dev)
            seconds[name].append(time.perf_counter() - t0)
            launches[name].append(threefry.fill.launches if threefry is not None else None)
            del made
            gc.collect()
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print("AB " + json.dumps({"root": args.root, "card": smi,
                              "init_s": {p: min(v) for p, v in seconds.items()},
                              "turns_s": seconds, "threefry_launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
