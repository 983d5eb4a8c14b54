"""Time one tree's ``ssd_chunk`` forward on the card, for A/B runs.

    python3 scripts/ssd_fwd_ab.py [--root TREE] [--shapes reduced,padded,serving]
                                  [--iters 100] [--turns 3] [--host-split]
    python3 scripts/ssd_fwd_ab.py [--root TREE] --train-peak [--steps 2]

Imports ``repro_torch`` from ``TREE/src`` (default: this checkout), builds
its kernels, and times ``ssd_chunk`` (under ``no_grad``, as serving calls
it) with CUDA events in bf16 and f32 at each shape named: ``reduced`` the
reduced mamba2's in the resilient training example (8 x 32 tokens in
chunks of 16, d_inner 128 in heads of 8: nc 16, Q 16, H 16, G 1, P 8, N
16), ``padded`` the JAX package's test shape (5, 80, 6, 3, 8, 16), off the
tensor-core head dims at a chunk longer than 32 tokens, and ``serving``
mamba2-2.7b's prefill (64, 256, 80, 1, 64, 128), where ``--iters`` is cut
to a tenth.  dA is drawn from Mamba-2's published ranges (A in [1, 16], dt
log-uniform in [1e-3, 1e-1]) on the card from one seed; each result is held
against ``ssd_chunk_plain`` and its largest error over the largest plain
value reported, with the route each call takes in that tree.  Every timing
runs first, in turns over the shapes and types (a profile in the process
slows the host's later launches); then a profile of 3 calls gives each
kernel's device µs a call, in this fresh process.

``--host-split`` adds, at the reduced shape in bf16, the host time of a call
and of its parts on the host clock (the median of 9 runs of 200 calls
each): the operand checks, the token strides (where the tree checks them
apart), the route, the outputs' allocation, the launch context, the C
launch call alone, and what is left of the whole call; and, of the C
launch, the ctypes call alone (``c_call_refused``: one the C entry
refuses at once).

``--train-peak`` instead trains mamba2-2.7b at its published widths and
all 64 layers (bf16 weights, remat and accum as its config sets them,
AdamW) for ``--steps`` steps on one batch of 4 x 4,096 tokens, as
``chip_smoke.py``'s ``ssm_train_path`` does, and reports the card's peak
allocated memory (``torch.cuda.max_memory_allocated`` from the process's
start), the step times, the losses and the forward's launches by route.

Prints one line ``AB {...}`` with the tree, the card (name and power limit
from ``nvidia-smi``) and each time in ms (the least of ``--turns`` runs of
``--iters`` calls, every run listed).  To compare two trees, unpack the
parent into a directory git ignores (``git archive HEAD | tar -x -C
build/parent``) and run parent, change, change, parent in one card call.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

SHAPES = {"reduced": (16, 16, 16, 1, 8, 16), "padded": (5, 80, 6, 3, 8, 16),
          "serving": (64, 256, 80, 1, 64, 128)}


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


def inputs(dtype, seed: int, shape):
    """x, dA, B, C (B and C slices of one (nc, Q, H*P + 2*G*N) tensor, as
    ``ops.ssd`` passes them), drawn on the card from ``seed``."""
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
    return x, (-A * dt).contiguous(), B, C


def host_us(fn, calls: int = 200, runs: int = 9) -> float:
    """Median over ``runs`` of the host-clock µs a call of ``fn`` takes over
    ``calls`` calls (the device synchronised between runs)."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def host_split(ssd_scan, _build, ins) -> dict:
    """Host µs of a bf16 call at the reduced shape and of its parts, in
    this tree."""
    x, dA, B, C = ins
    nc, Q, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    f32 = torch.float32
    lib = ssd_scan._lib()
    checked = ssd_scan._check_operands(x, dA, B, C)
    parts = {"checks": lambda: ssd_scan._check_operands(x, dA, B, C)}
    if len(checked) == 6:  # the tree reads the token strides apart from the checks
        parts["strides"] = lambda: [ssd_scan._token_stride(t, n)
                                    for t, n in ((x, "x"), (B, "B"), (C, "C"))]
    strides = [t.stride(1) for t in (x, B, C)]
    parts["route"] = lambda: ssd_scan.route(x, B, C)
    shared = hasattr(ssd_scan, "_outputs")  # y_diag and states views of one allocation
    if shared:
        parts["allocations"] = lambda: ssd_scan._outputs(nc, Q, H, P, N, x.device)
    else:
        parts["allocations"] = lambda: (torch.empty((nc, Q, H, P), dtype=f32, device=x.device),
                                        torch.empty((nc, H, P, N), dtype=f32, device=x.device),
                                        torch.empty((nc, H), dtype=f32, device=x.device))

    def context():
        with _build.on_device(x.device):
            pass

    parts["launch_context"] = context
    outs = parts["allocations"]()
    if shared:
        outs = outs[0]
    ptrs = (x.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(),
            *(t.data_ptr() for t in outs))
    stream = torch._C._cuda_getCurrentRawStream(x.device.index or 0)
    if hasattr(lib, "ssd_chunk_op_launch"):
        def c_call(n):
            return lib.ssd_chunk_op_launch(*ptrs, n, Q, H, G, P, N, *strides, 1, stream)
    else:  # the parent's CUDA-core route: tensor_cores 0
        def c_call(n):
            return lib.ssd_chunk_launch(*ptrs, n, Q, H, G, P, N, *strides, 1, 0, stream)
    parts["c_launch"] = lambda: c_call(nc)
    with torch.no_grad():
        out = {"call": host_us(lambda: ssd_scan.ssd_chunk(x, dA, B, C))}
    for name, fn in parts.items():
        out[name] = host_us(fn)
    out["rest"] = out["call"] - sum(v for k, v in out.items() if k != "call")
    # of the C launch: the ctypes call alone (nc 0, refused at once by the entry)
    out["c_call_refused"] = host_us(lambda: c_call(0))
    return out


def train_peak(steps: int) -> dict:
    """Peak allocated GiB of ``steps`` training steps of mamba2-2.7b, all 64
    layers, 4 x 4,096 tokens (``ssm_train_path``'s run), in this tree."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch.train import make_data, run

    cfg = get_config("mamba2-2.7b")
    data = make_data(cfg, 4096, rows=4, seed=1)
    ssd_scan.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = run(cfg, steps=steps, batch=4, seq=4096, lr=1e-4, device="cuda", ckpt_every=0,
              data=data, log=lambda _msg: None)
    torch.cuda.synchronize()
    return {"arch": cfg.name, "layers": cfg.num_layers, "remat": cfg.remat,
            "accum_steps": cfg.accum_steps, "steps": steps,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "step_ms": [t * 1e3 for t in res["step_s"]],
            "losses": [res["losses"][k] for k in sorted(res["losses"])],
            "forward_route_launches": dict(ssd_scan.ssd_chunk.route_launches)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--shapes", default="reduced",
                    help=f"comma-separated names of {sorted(SHAPES)} (default reduced)")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--host-split", action="store_true",
                    help="also split a reduced-shape bf16 call's host time")
    ap.add_argument("--train-peak", action="store_true",
                    help="instead: the peak memory of mamba2-2.7b's training steps")
    ap.add_argument("--steps", type=int, default=2, help="training steps of --train-peak")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_fwd_ab: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve() / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build, ssd_scan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = {"root": str(args.root), "card": smi}
    if args.train_peak:
        out["train_peak"] = train_peak(args.steps)
        print("AB " + json.dumps(out), flush=True)
        return 0
    calls = {}
    for name in args.shapes.split(","):
        shape = SHAPES[name]
        iters = args.iters if name != "serving" else max(1, args.iters // 10)
        for dtype in (torch.bfloat16, torch.float32):
            ins = inputs(dtype, seed=7, shape=shape)
            key = f"{name}_{str(dtype).removeprefix('torch.')}"

            def call(ins=ins):
                with torch.no_grad():
                    return ssd_scan.ssd_chunk(*ins)

            got, want = call(), ssd_scan.ssd_chunk_plain(*ins)
            errs = {n: float((a - b).abs().max() / b.abs().max())
                    for n, a, b in zip(("y_diag", "states", "chunk_decay"), got, want)}
            calls[key] = (call, iters)
            out[key] = {"shape": list(shape), "iters": iters,
                        "route": ssd_scan.route(ins[0], ins[2], ins[3]), "max_err": errs}
    for _ in range(args.turns):  # in turns: the card warms over a run
        for key, (call, iters) in calls.items():
            out[key].setdefault("runs", []).append(cuda_ms(call, iters))
    if args.host_split:
        out["host_split_us"] = host_split(ssd_scan, _build,
                                          inputs(torch.bfloat16, 7, SHAPES["reduced"]))
    for key, (call, _iters) in calls.items():  # profiles last: a profile slows later host calls
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
    lib = ssd_scan._lib()
    if hasattr(lib, "ssd_chunk_op_launch"):  # the one-pass kernel's resources, this tree
        out["one_pass_resources"] = {
            str(dt).removeprefix("torch."): ssd_scan.resources("one_pass", 16, 8, 16, dt)
            for dt in (torch.bfloat16, torch.float32)}
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
