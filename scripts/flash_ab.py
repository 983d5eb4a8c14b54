"""Time one tree's ``flash_attention`` kernels on the card, for A/B runs.

    python3 scripts/flash_ab.py [--root TREE] [--iters 10]

Imports ``repro_torch`` from ``TREE/src`` (default: this checkout), builds
its kernels, and times with CUDA events, causal, on one seeded input each:

* the forward at the dense serving shape (4, 4096, 4096, 64, 8, 128)
  without the row lse (the serving path), and with it where the tree's
  ``flash_attention`` takes ``return_lse``;
* the backward at deepseek-67b's (1, 4096, 4096, 64, 8, 128) and
  paligemma's (4, 4096, 4096, 8, 1, 256) training shapes (with the
  forward's lse where the tree's backward reads it), and in f32 at
  paligemma's shape on whichever route the tree takes there, with that
  route.

With ``--reduced-bwd`` it times instead only the backward at the reduced
configs' restart-check micro-batch (2, 256, 256, 4, 2, 16), in bf16 and
f32, on the route the tree takes there (the CUDA cores until D 16 moved to
the tensor cores), with that route and each of its kernels' device µs a
call from a profile of 5 calls, taken after every timing (a profile in the
process slows the host's later launches).

With ``--udf`` it times instead the forward (with and without the lse) and
the backward at a transformer UDF's training shapes (2,000 records of 8
tokens: llama3-405b's heads, qwen3-moe's, and the reduced configs' D 16),
with the route each takes in that tree.

Prints one line ``AB {...}`` with the tree, the card (name and power limit
from ``nvidia-smi``) and each time in ms (the least of ``--turns`` runs of
``--iters`` calls, every run listed).  To compare two trees, unpack the
parent into a directory git ignores (``git archive HEAD | tar -x -C
build/parent``) and run parent, change, change, parent in one card call.
"""
from __future__ import annotations

import argparse
import functools
import inspect
import json
import subprocess
import sys
from pathlib import Path

import torch

FWD_SHAPE = (4, 4096, 4096, 64, 8, 128)  # (B, Sq, Sk, H, K, D)
BWD_SHAPES = ((1, 4096, 4096, 64, 8, 128), (4, 4096, 4096, 8, 1, 256))
REDUCED_BWD = (((2, 256, 256, 4, 2, 16), torch.bfloat16),
               ((2, 256, 256, 4, 2, 16), torch.float32))
F32_BWD_SHAPE = (4, 4096, 4096, 8, 1, 256)  # the f32 backward, on the route the tree takes
UDF_SHAPES = ((2000, 8, 8, 128, 8, 128), (2000, 8, 8, 32, 4, 128), (2000, 8, 8, 4, 2, 16))


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


def inputs(shape, seed: int, dtype=torch.bfloat16):
    B, Sq, Sk, H, K, D = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=gen, device="cuda").to(dtype)
            for s in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D), (B, Sq, H, D))]


def kernel_us(fn, calls: int) -> dict:
    """{kernel: device µs a call} from a profile of ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("(")[0]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / calls
    return out


def timed(fn, iters: int, turns: int) -> dict:
    runs = [cuda_ms(fn, iters) for _ in range(turns)]
    return {"ms": min(runs), "runs": runs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--reduced-bwd", action="store_true",
                    help="time only the backward at the reduced shape (REDUCED_BWD)")
    ap.add_argument("--udf", action="store_true",
                    help="time only the UDF training shapes (UDF_SHAPES)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.kernels import flash_attention as fm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    with_lse = "return_lse" in inspect.signature(fm.flash_attention).parameters
    out = {"root": str(args.root), "card": smi, "iters": args.iters}
    if args.reduced_bwd:
        calls = {}
        for shape, dtype in REDUCED_BWD:
            q, k, v, dout = inputs(shape, seed=8, dtype=dtype)
            o, lse = fm.flash_attention(q, k, v, causal=True, return_lse=True)
            tag = f"{'x'.join(map(str, shape))}_{str(dtype)[6:]}"
            calls[tag] = functools.partial(fm.flash_attention_backward, q, k, v, o, dout, lse,
                                           causal=True)
            out[f"route_{tag}"] = fm.backward_route(shape[5], dtype, shape[:5])
        for _ in range(args.turns):  # in turns, and every timing before any profile
            for tag, call in calls.items():
                out.setdefault(f"backward_{tag}", {"runs": []})["runs"].append(
                    cuda_ms(call, 20 * args.iters))
        for tag, call in calls.items():
            out[f"backward_{tag}"]["ms"] = min(out[f"backward_{tag}"]["runs"])
            out[f"kernel_us_{tag}"] = kernel_us(call, 5)
        print("AB " + json.dumps(out), flush=True)
        return 0

    if args.udf:
        for shape in UDF_SHAPES:
            q, k, v, dout = inputs(shape, seed=8)
            o, lse = fm.flash_attention(q, k, v, causal=True, return_lse=True)
            tag = "x".join(map(str, shape))
            out[f"route_{tag}"] = fm.route(q, k, v)
            calls = {"forward": lambda: fm.flash_attention(q, k, v, causal=True),
                     "forward_with_lse": lambda: fm.flash_attention(q, k, v, causal=True,
                                                                     return_lse=True),
                     "backward": lambda: fm.flash_attention_backward(q, k, v, o, dout, lse,
                                                                     causal=True)}
            for name, fn in calls.items():
                out[f"{name}_{tag}"] = timed(fn, args.iters, args.turns)
            del q, k, v, dout, o, lse
            torch.cuda.empty_cache()
        print("AB " + json.dumps(out), flush=True)
        return 0

    q, k, v, _ = inputs(FWD_SHAPE, seed=7)
    calls = {"forward": lambda: fm.flash_attention(q, k, v, causal=True)}
    if with_lse:
        calls["forward_with_lse"] = lambda: fm.flash_attention(q, k, v, causal=True,
                                                                return_lse=True)
    runs = {name: [] for name in calls}
    for _ in range(args.turns):  # in turns: the card warms over a run
        for name, fn in calls.items():
            runs[name].append(cuda_ms(fn, args.iters))
    out.update({name: {"ms": min(r), "runs": r} for name, r in runs.items()})
    del q, k, v
    for shape, dtype in (*((s, torch.bfloat16) for s in BWD_SHAPES),
                         (F32_BWD_SHAPE, torch.float32)):
        q, k, v, dout = inputs(shape, seed=8, dtype=dtype)
        if with_lse:
            o, lse = fm.flash_attention(q, k, v, causal=True, return_lse=True)
            extra = (lse,)
        else:
            o, extra = fm.flash_attention(q, k, v, causal=True), ()
        tag = "x".join(map(str, shape))
        if dtype == torch.float32:
            tag += "_float32"
            out[f"route_{tag}"] = fm.backward_route(shape[5], dtype)
        out[f"backward_{tag}"] = timed(
            lambda: fm.flash_attention_backward(q, k, v, o, dout, *extra, causal=True),
            max(1, args.iters // 2), args.turns)
        del q, k, v, dout, o, extra
        torch.cuda.empty_cache()
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
