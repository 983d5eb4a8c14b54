"""Serving throughput of one tree of this repository on a CUDA card: its
``chip_smoke.py``'s ``serving_path``, ``multiquery_path`` and
``frontend_path`` phases, run ``--repeats`` times, and one line

    AB {"root": ..., "repeat": i, "serving_path": records/s, ...,
        "block_m": {block_m: scorers built at it}}

a repeat.  The ``block_m`` counts say which bucket ladders the paths served
on.  To compare two trees, unpack one beside the other and run them in
turns on one card, in one sitting (A, B, B, A):

    python3 scripts/scorer_ladder_ab.py --root build/parent
    python3 scripts/scorer_ladder_ab.py

``--root`` is the tree whose ``chip_smoke.py`` and ``src/`` are imported
(default: the tree holding this script).
"""
import argparse
import collections
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--repeats", type=int, default=1)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    if not torch.cuda.is_available():
        print("scorer_ladder_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import ops, proxy_score

    if Path(chip_smoke.__file__).resolve().parent != root:
        raise RuntimeError(f"imported {chip_smoke.__file__}, not {root}'s chip_smoke.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    proxy_score._lib()
    blocks = collections.Counter()
    real_init = ops.CascadeScorer.__init__

    def counted(self, *a, **kw):
        real_init(self, *a, **kw)
        blocks[int(self.block_m)] += 1

    ops.CascadeScorer.__init__ = counted
    for rep in range(args.repeats):
        blocks.clear()
        serving = chip_smoke.run_serving_path(dev, chip_smoke.SERVING["n"])
        workload = serving["workload"]
        multiquery = chip_smoke.run_multiquery_path(dev, workload, chip_smoke.MULTIQUERY_RECORDS)
        frontend = chip_smoke.run_frontend_path(dev, workload, chip_smoke.FRONTEND["records"])
        print("AB " + json.dumps({
            "root": str(root), "repeat": rep,
            "serving_path": serving["records_per_s"],
            "multiquery_path": multiquery["records_per_s"],
            "frontend_path": frontend["records_per_s"],
            "block_m": {str(k): v for k, v in sorted(blocks.items())},
            "nvidia_smi": chip_smoke.nvidia_smi_line()}), flush=True)
        del serving, workload, multiquery, frontend
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
