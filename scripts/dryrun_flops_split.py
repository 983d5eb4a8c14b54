"""Where a dry-run train cell's per-device flops and collective bytes come
from: one step of a cell cut to a few layers and micro-batches, traced on
"meta" on the production (16, 16) mesh (``launch/dryrun.py``), its flops
and collectives split by op and by the line of the port's code that ran
them (``launch/cost_analysis.py``), beside the model's own flops a device.

    PYTHONPATH=src python scripts/dryrun_flops_split.py --arch llama3-405b \\
        --layers 2 --micro 2

A published-width cell allocates nothing on meta, but its trace takes the
host's CPU for seconds a layer: run it where that is free.
"""
import argparse
import dataclasses

from repro_torch.launch import dryrun


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-405b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--micro", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    a = ap.parse_args(argv)
    mesh = dryrun.make_mesh((16, 16))
    cell = dryrun.build_cell(a.arch, a.shape, mesh, a.variant, layers=a.layers, micro=a.micro)
    costs, _args, _out, _alias = dryrun.trace_cell(cell, mesh)
    per_micro = dryrun.SHAPES[a.shape].global_batch // max(1, dryrun.get_config(a.arch).accum_steps)
    shape = dataclasses.replace(dryrun.SHAPES[a.shape], global_batch=a.micro * per_micro)
    model = dryrun.model_flops(cell.cfg, shape) / 256
    print(f"{a.arch} x {a.shape} ({a.variant}), {a.layers} layers, {a.micro} micro-batches: "
          f"flops a device {costs.flops:.4e}, the model's {model:.4e}")
    for f, kind, label in costs.top_flops[:a.top]:
        print(f"  flops {f:.4e}  {kind:26s} {label}")
    for b, kind, label in costs.top_collectives[:a.top]:
        print(f"  bytes {b:.4e}  {kind:26s} {label}")


if __name__ == "__main__":
    main()
