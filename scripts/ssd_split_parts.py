#!/usr/bin/env python3
"""Where the time goes inside the f32 ``ssd_chunk`` (``ssd_chunk_split``):
the kernel timed whole and with one part removed at a time.

    python3 scripts/ssd_split_parts.py [--iters 10]

Needs a CUDA card and ``nvcc``.  Builds copies of
``src/repro_torch/kernels/csrc/ssd_chunk.cu`` into ``build/ssd_split_parts/``
(one ``nvcc`` each, all started together), each with one part of the split
kernel cut out, and times each at ``chip_smoke.py``'s serving shape (nc 64,
Q 256, H 80, G 1, P 64, N 128, published dynamics) with CUDA events, in two
rounds.  A part's cost is about the whole kernel's time less the variant's;
the parts overlap, so the costs do not add up.  A variant computes wrong
values: only its time means anything.  Prints one JSON line per variant.

Variants: ``whole``; ``no_states`` (warpgroup 2 skips the states);
``no_y`` (no y_diag tile); ``no_x_split`` (x split for the first head only);
``no_score_reads`` (the y tiles use made-up scores instead of reading the
kept S); ``no_score_phase`` (S is not computed; the y tiles read whatever
the scratch holds).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

KERNEL = "__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_split("
# (text in the split kernel, its replacement); each occurs once after KERNEL
VARIANTS = {
    "whole": (),
    "no_states": (("    if (wg == 2) {\n      float st[N / 2];",
                   "    if (wg == 99) {\n      float st[N / 2];"),),
    "no_y": (("      if (tile_owner(i, nt) != wg) continue;\n      const int i0",
              "      if (true) continue;\n      const int i0"),),
    "no_x_split": (("    split_rows<P, SWX>(xg, xg + x_bytes,",
                    "    if (k == 0) split_rows<P, SWX>(xg, xg + x_bytes,"),),
    "no_score_reads": (("          const float4 v = src[e * 128];",
                        "          const float4 v = make_float4(e, 0.f, 1.f, 0.f);"),),
    "no_score_phase": (("    if (tile_owner(i, nt) != wg) continue;\n    const int r0",
                        "    if (true) continue;\n    const int r0"),),
}


def variant_source(src: str, reps) -> str:
    at = src.index(KERNEL)
    for old, new in reps:
        i = src.index(old, at)
        src = src[:i] + new + src[i + len(old):]
    return src


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssd_split_parts: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build

    out = ROOT / "build" / "ssd_split_parts"
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(_build.CSRC / "hopper.cuh", out / "hopper.cuh")
    src = (_build.CSRC / "ssd_chunk.cu").read_text()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name, reps in VARIANTS.items():
        (out / f"{name}.cu").write_text(variant_source(src, reps))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *flags, "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    dev = torch.device("cuda", 0)
    x, dA, B, C = cs.ssd_inputs((*cs.SSD_SERVING, "published", "float32"), dev, seed=7)
    nc, Q, H, G, P, N = cs.SSD_SERVING
    strides = [t.stride(1) for t in (x, B, C)]
    vp, i32, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    runs: dict = {}
    for _round in range(2):
        for name in VARIANTS:
            lib = ctypes.CDLL(str(out / f"{name}.so"))
            lib.ssd_chunk_split_launch.argtypes = [vp] * 8 + [ll] + [i32] * 6 + [ll] * 3 + [vp]
            lib.ssd_chunk_split_scratch.argtypes = [i32] * 4 + [ctypes.POINTER(ll)]
            n = ll(0)
            check = lib.ssd_chunk_split_scratch(nc, Q, H, G, ctypes.byref(n))
            if check != 0:
                raise RuntimeError(f"{name}: scratch size failed ({check})")
            scratch = torch.empty(n.value, device=dev)
            y = torch.empty((nc, Q, H, P), device=dev)
            st = torch.empty((nc, H, P, N), device=dev)
            dec = torch.empty((nc, H), device=dev)

            def launch():
                rc = lib.ssd_chunk_split_launch(
                    x.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
                    st.data_ptr(), dec.data_ptr(), scratch.data_ptr(), n.value, nc, Q, H, G, P,
                    N, *strides, torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: launch failed ({rc})")

            runs.setdefault(name, []).append(cs.cuda_ms(launch, dev, args.iters, warmup=2))
    whole = min(runs["whole"])
    for name, ms in runs.items():
        print(json.dumps({"variant": name, "ms": min(ms), "ms_runs": ms,
                          "saved_ms": whole - min(ms), "shape": list(cs.SSD_SERVING),
                          "device": torch.cuda.get_device_name(0)}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
