"""Time one tree's ``ssd_chunk`` backward kernel on the card, for A/B runs.

    python3 scripts/ssd_bwd_ab.py [--root TREE] [--iters 5] [--turns 3] [--reduced]

Imports ``repro_torch`` from ``TREE/src`` (default: this checkout), builds
its kernels, and times ``ssd_chunk_backward`` with CUDA events at the SSM
training shape (mamba2-2.7b, 4 x 4,096 tokens in chunks of 256: nc 64, Q
256, H 80, G 1, P 64, N 128) in bf16 and f32, B and C sliced from one
projection as ``ops.ssd`` passes them, on one seeded input each; each
result is held against the plain formulas (``ssd_chunk_backward_plain``,
8 chunks a call) and its largest error over each gradient's largest value
reported, with the route each type takes in that tree.  A profile of 3
calls gives each of the backward's kernels its device µs a call.  With
``--reduced`` the shape is instead the reduced mamba2's in the resilient
training example (8 x 32 tokens in chunks of 16, d_inner 128 in heads of
8: nc 16, Q 16, H 16, G 1, P 8, N 16), off the tensor-core kernels' head
dims, and each type is timed over 20 times as many calls; ``--padded``
also times there the wgmma kernels on zero-padded operands (the route the
one-pass kernel replaced at such chunks).  Every timing runs before any
profile: a profile in the process slows the host's later launches.

Prints one line ``AB {...}`` with the tree, the card (name and power limit
from ``nvidia-smi``) and each time in ms (the least of ``--turns`` runs of
``--iters`` calls, every run listed).  To compare two trees, unpack the
parent into a directory git ignores (``git archive HEAD | tar -x -C
build/parent``) and run parent, change, change, parent in one card call.
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
from pathlib import Path

import torch

SHAPE = (64, 256, 80, 1, 64, 128)  # (nc, Q, H, G, P, N)
REDUCED = (16, 16, 16, 1, 8, 16)
SLICE = 8  # chunks a plain call takes


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def inputs(dtype, seed: int, shape=SHAPE):
    """x, dA, B, C (B and C slices of one (nc, Q, H*P + 2*G*N) tensor) and
    the output gradients, drawn on the card from ``seed``; dA from
    Mamba-2's published ranges (A in [1, 16], dt log-uniform in [1e-3,
    1e-1])."""
    nc, Q, H, G, P, N = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    wide = randn(nc, Q, H * P + 2 * G * N).to(dtype)
    x = randn(nc, Q, H, P).to(dtype)
    B = wide[..., H * P:H * P + G * N].unflatten(2, (G, N))
    C = wide[..., H * P + G * N:].unflatten(2, (G, N))
    A = torch.rand(H, generator=gen, device="cuda") * 15 + 1
    dt = torch.exp(torch.rand(nc, Q, H, generator=gen, device="cuda") * 4.605 - 6.908)
    dA = (-A * dt).contiguous()
    return x, dA, B, C, randn(nc, Q, H, P), randn(nc, H, P, N), randn(nc, H)


def _backward(ssd_scan, ins, forced):
    """One backward call on ``ins``; ``forced`` a route to take instead of
    ``route``'s (to time the padded wgmma route where the one-pass kernel
    would run; a tree whose backward has a rule of its own,
    ``backward_route``, reads ``route`` first)."""
    if forced is None:
        return ssd_scan.ssd_chunk_backward(*ins)
    rule = ssd_scan.route
    ssd_scan.route = lambda *_: forced
    try:
        return ssd_scan.ssd_chunk_backward(*ins)
    finally:
        ssd_scan.route = rule


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--reduced", action="store_true",
                    help="time the reduced mamba2's shape (REDUCED) instead")
    ap.add_argument("--padded", action="store_true",
                    help="also time the wgmma kernels on padded operands (tag _padded)")
    args = ap.parse_args()
    shape, iters = (REDUCED, 20 * args.iters) if args.reduced else (SHAPE, args.iters)
    if not torch.cuda.is_available():
        print("ssd_bwd_ab: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve() / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ssd_scan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = {"root": str(args.root), "card": smi, "shape": list(shape), "iters": iters}
    routes = {"": None}
    if args.padded and hasattr(ssd_scan, "pad_to_tensor_cores"):
        routes["_padded"] = "tensor_cores"  # the wgmma kernels on padded operands
    calls = {}
    for dtype in (torch.bfloat16, torch.float32):
        ins = inputs(dtype, seed=7, shape=shape)
        want = [torch.cat(p) for p in zip(*(
            ssd_scan.ssd_chunk_backward_plain(*(t[i:i + SLICE] for t in ins))
            for i in range(0, shape[0], SLICE)))]
        for tag, forced in routes.items():
            key = str(dtype).removeprefix("torch.") + tag
            calls[key] = call = functools.partial(_backward, ssd_scan, ins, forced)
            got = call()
            errs = {n: float((a.float() - b.float()).abs().max() / b.float().abs().max())
                    for n, a, b in zip(("dx", "ddA", "dB", "dC"), got, want)}
            out[key] = {"route": forced or ssd_scan.route(ins[0], ins[2], ins[3]),
                        "max_err": errs}
    for _ in range(args.turns):  # in turns: the card warms over a run
        for key, call in calls.items():
            out[key].setdefault("runs", []).append(cuda_ms(call, iters))
    for key, call in calls.items():  # profiles last: a profile slows later host calls
        out[key]["ms"] = min(out[key]["runs"])
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        per_kernel = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
                name = name.split("(")[0]
                per_kernel[name] = per_kernel.get(name, 0.0) + e.time_range.elapsed_us() / 3
        out[key]["kernel_us"] = per_kernel
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
