"""Profile of one dry-run cell (the JAX package's ``launch/inspect_cell.py``):
traces the cell once on "meta" (``dryrun.build_cell``) and prints its
per-device totals and its top collectives and top byte-movers from
``cost_analysis``, each labelled with the line of the port's code that ran
it — the profile a sharding change iterates on without a cluster.

    PYTHONPATH=src python -m repro_torch.launch.inspect_cell --arch X --shape Y [--multi-pod]
"""
from __future__ import annotations

import argparse

from repro_torch.launch import dryrun


def inspect(arch: str, shape: str, multi_pod: bool = False, top: int = 18,
            variant: str = "baseline", reduced: bool = False):
    mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    mesh = dryrun.make_mesh(mesh_shape)
    cell = dryrun.build_cell(arch, shape, mesh, variant, reduced=reduced)
    costs, arg_b, _out_b, _alias_b = dryrun.trace_cell(cell, mesh)
    print(f"== {arch} x {shape} on {'x'.join(map(str, mesh_shape))} ({variant}) ==")
    print(f"flops/dev {costs.flops:.3e}  hbm/dev {costs.hbm_bytes / 1e9:.1f} GB  "
          f"coll/dev {costs.total_collective_bytes / 1e9:.1f} GB  "
          f"args {arg_b / 1e9:.1f} GB  high-water {costs.high_water_bytes / 1e9:.1f} GB")
    print("-- top collectives (bytes summed by kind and line) --")
    for b, kind, label in costs.top_collectives[:top]:
        print(f"  {b / 1e9:10.2f} GB  {kind:15s} {label[:90]}")
    print("-- top flops (by op and line) --")
    for f, kind, label in costs.top_flops[:top]:
        print(f"  {f:10.3e} flop {kind:15s} {label[:90]}")
    print("-- top byte-movers (operand + output bytes by op and line) --")
    for b, kind, label in costs.top_hbm[:top]:
        print(f"  {b / 1e9:10.2f} GB  {kind:15s} {label[:90]}")
    return costs


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=18)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--reduced", action="store_true")
    a = ap.parse_args()
    inspect(a.arch, a.shape, a.multi_pod, a.top, a.variant, a.reduced)
