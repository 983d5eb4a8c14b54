"""The widest router flip of ``chip_smoke.py``'s ``moe_path`` at several init
seeds, for one tree, beside the planted fault that bound must reject.

    python3 scripts/moe_router_ties.py [--root TREE] [--seeds 0,1,2,3]

Imports ``chip_smoke`` and ``repro_torch`` from ``TREE`` (default: this
checkout), builds the kernels the path launches and runs ``moe_path``
(qwen3-moe-30b-a3b at published widths, 8 layers, bf16, 4 x 4,096 prompt
tokens, 32 decode steps) once a seed, the family's ``init`` given that
seed.  The served run's expert choices are pinned into ``forward`` (plain
attention); the run reports how many of ``forward``'s own choices differ
and the widest relative probability gap among them, which ``moe_path``
holds to ``SERVED_ROUTER_TIE_TOL``, and (where the tree has it) the widest
gap of the planted fault, each k-th expert swapped for the next.  A seed whose
run fails keeps the failure's message.  Prints one line ``TIES {...}``
with the tree, the card (name and power limit from ``nvidia-smi``), the
bound and {seed: {flips, max_gap, planted_max_gap} or {failed}}.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from unittest import mock

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seeds", default="0,1,2,3")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("moe_router_ties: needs a CUDA card", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.models import moe

    _build.build_all([p.stem for p in (root / "src/repro_torch/kernels/csrc").glob("*.cu")])
    dev = torch.device("cuda", 0)
    real_init = moe.init
    out = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        try:
            with mock.patch.object(moe, "init", lambda _k, cfg, device="cuda", s=seed:
                                   real_init(s, cfg, device)):
                logits = cs.run_model_path(dev, cs.MOE, f"moe_path_seed{seed}")["logits"]
            out[seed] = dict(flips=logits["forward_routing_flips"],
                             max_gap=logits["forward_flip_max_gap"],
                             planted_max_gap=logits.get("planted_rank_swap_max_gap"))
        except cs.SmokeFailure as e:
            out[seed] = dict(failed=str(e))
        torch.cuda.empty_cache()
    bound = getattr(cs, "SERVED_ROUTER_TIE_TOL", cs.ROUTER_TIE_TOL)
    print("TIES " + json.dumps({"root": str(root), "card": cs.nvidia_smi_line(),
                                "router_tie_tol": bound, "seeds": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
