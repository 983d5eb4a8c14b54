#!/usr/bin/env python3
"""The f32 ``flash_attention`` routes against float64 on a model's own
activations.

    python3 scripts/flash_f32_accuracy.py [--layers 4] [--request 2]

Needs a CUDA card.  Runs ``chip_smoke.py``'s dense model (deepseek-67b at
its full width, ``--layers`` layers, seeded random weights) in f32 over its
4 x 4,096-token prefill, keeps one request's q, k and v at every layer, and
holds three f32 attentions of them against the same attention in float64
on the card: the split tensor-core route (what ``flash_attention`` runs),
the CUDA-core kernel (the C entry called directly) and the plain version.
Prints one JSON line per layer: the inputs' largest magnitudes, each
route's largest difference from float64, that difference over the f32
limit (2e-5 + 2e-5 |ref|, so 1 is the limit), and each kernel against the
plain version as ``chip_smoke.flash_errors`` reads it.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def attention_f64(q, k, v):
    """Causal GQA attention of one request in float64."""
    _b, S, H, D = q.shape
    K = k.shape[2]
    qd = q[0].double().reshape(S, K, H // K, D) / math.sqrt(D)
    s = torch.einsum("qkgd,skd->kgqs", qd, k[0].double())
    s.masked_fill_(~torch.tril(torch.ones(S, S, dtype=torch.bool, device=q.device)), -math.inf)
    return torch.einsum("kgqs,skd->qkgd", torch.softmax(s, -1),
                        v[0].double()).reshape(1, S, H, D)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--request", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_f32_accuracy: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as model_layers
    from repro_torch.models.registry import get_family, make_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_config(cs.DENSE["arch"]).replace(num_layers=args.layers, dtype="float32")
    fam = get_family(cfg)
    model = fam.init(0, cfg, device=dev)
    tokens = make_batch(cfg, cs.DENSE["batch"], cs.DENSE["prompt"], key=0,
                        device=dev)["tokens"]
    r = args.request
    seen = []

    def kept(q, k, v, *, causal=True):
        out = fa.flash_attention(q, k, v, causal=causal)
        seen.append(tuple(t[r:r + 1].clone() for t in (q, k, v, out)))
        return out

    with mock.patch.object(model_layers, "flash_attention", kept):
        fam.prefill(model, cfg, {"tokens": tokens})
    del model
    torch.cuda.empty_cache()
    lib = fa._lib()
    for layer, (q, k, v, split) in enumerate(seen):
        _b, S, H, D = q.shape
        cuda_cores = torch.empty_like(q)
        rc = lib.flash_attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        cuda_cores.data_ptr(), 1, S, S, H, k.shape[2], D, 1, 0,
                                        1 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"CUDA-core launch failed ({rc})")
        plain = fa.flash_attention_plain(q, k, v, causal=True)
        ref = attention_f64(q, k, v)

        def vs_f64(x):
            d = (x.double() - ref).abs()
            return {"max_abs": float(d.max()),
                    "over_limit": float((d / (2e-5 + 2e-5 * ref.abs())).max())}

        print(json.dumps({
            "layer": layer, "request": r, "max_q": float(q.abs().max()),
            "max_k": float(k.abs().max()), "max_v": float(v.abs().max()),
            "max_out": float(ref.abs().max()),
            "split_vs_f64": vs_f64(split), "cuda_cores_vs_f64": vs_f64(cuda_cores),
            "plain_vs_f64": vs_f64(plain),
            "split_vs_plain": cs.flash_errors(split, plain),
            "cuda_cores_vs_plain": cs.flash_errors(cuda_cores, plain),
            "device": torch.cuda.get_device_name(0)}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
