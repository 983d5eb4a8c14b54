"""Family registry and concrete batches: every family of
``configs/archs.py`` (dense, MoE, SSM, hybrid, encdec, VLM)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import encdec, moe, rglru, ssm, transformer, vlm
from repro_torch.util import resolve_device

FAMILIES = {"dense": transformer, "moe": moe, "ssm": ssm, "hybrid": rglru, "encdec": encdec,
            "vlm": vlm}


def get_family(cfg):
    """The module implementing ``cfg.family``'s API."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"no family {cfg.family!r}: the port has {sorted(FAMILIES)}")
    return FAMILIES[cfg.family]


def _token_len(cfg, seq_len: int) -> int:
    """Text tokens such that the processed sequence is ``seq_len`` long (a
    VLM's patch prefix counts)."""
    if cfg.family == "vlm":
        return max(1, seq_len - cfg.encoder.num_prefix)
    return seq_len


def stub_embeddings(cfg, batch: int, seq_len: int, rng: np.random.RandomState) -> dict:
    """The stub frontends' inputs, standard normals drawn by ``rng`` in bf16
    on the CPU: a VLM's ``patches`` (batch, num_prefix, d_model), an
    encoder-decoder's ``frames`` (batch, enc_len_for(seq_len), d_model);
    {} for the other families."""
    if cfg.family == "vlm":
        shape = (batch, cfg.encoder.num_prefix, cfg.d_model)
    elif cfg.family == "encdec":
        shape = (batch, encdec.enc_len_for(cfg, seq_len), cfg.d_model)
    else:
        return {}
    name = "patches" if cfg.family == "vlm" else "frames"
    return {name: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        torch.bfloat16)}


def make_batch(cfg, batch: int, seq_len: int, seed: int = 0, device="cuda"):
    """{"tokens": (batch, S) int64} drawn uniformly from the vocabulary by
    ``np.random.RandomState(seed)``, so a test can hand the same inputs to
    the JAX package; S is ``seq_len`` less a VLM's patch prefix.  A VLM
    batch also carries ``patches`` and an encoder-decoder batch ``frames``
    (``stub_embeddings``), drawn next from the same generator."""
    get_family(cfg)
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, (batch, _token_len(cfg, seq_len)))
    out = {"tokens": torch.from_numpy(tokens.astype(np.int64)).to(dev)}
    out.update({k: v.to(dev) for k, v in stub_embeddings(cfg, batch, seq_len, rng).items()})
    return out


def input_specs(cfg, shape):
    """Meta-device stand-ins for a workload shape's inputs, with the JAX
    package's shapes and dtypes (its ``ShapeDtypeStruct``s): nothing is
    allocated.  Train and prefill: ``tokens`` (and for train ``labels``)
    (B, S) int32, an encoder-decoder's ``frames`` and a VLM's ``patches``
    in bf16; decode: ``tokens`` (B,) int32 and the family's ``init_cache``
    on meta."""
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    if shape.kind in ("train", "prefill"):
        St = _token_len(cfg, S)
        specs = {"tokens": torch.empty((B, St), dtype=torch.int32, device=meta)}
        if shape.kind == "train":
            specs["labels"] = torch.empty((B, St), dtype=torch.int32, device=meta)
        if cfg.family == "encdec":
            specs["frames"] = torch.empty((B, encdec.enc_len_for(cfg, S), cfg.d_model),
                                          dtype=torch.bfloat16, device=meta)
        if cfg.family == "vlm":
            specs["patches"] = torch.empty((B, cfg.encoder.num_prefix, cfg.d_model),
                                           dtype=torch.bfloat16, device=meta)
        return specs
    # decode: one new token against a seq_len-sized cache
    cache = get_family(cfg).init_cache(cfg, B, S, device=meta)
    return {"tokens": torch.empty((B,), dtype=torch.int32, device=meta), "cache": cache}


def params_spec(cfg):
    """The family's parameters on meta, in the JAX package's layout: a
    nested dict whose layer stacks carry a leading layer dim
    (``models/leaves.py``), each leaf of the JAX leaf's shape and dtype."""
    from repro_torch.models import leaves

    model = get_family(cfg).init(0, cfg, "meta")
    return leaves.nest(leaves.stacked(dict(model.named_parameters())))
