"""Family registry and concrete batches: every family of
``configs/archs.py`` (dense, MoE, SSM, hybrid, encdec, VLM)."""
from __future__ import annotations

import torch

from repro_torch.models import encdec, moe, rglru, ssm, transformer, vlm
from repro_torch.util import prng, resolve_device

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


def make_batch(cfg, batch: int, seq_len: int, key=None, device="cuda") -> dict:
    """The JAX package's ``make_batch``: ``k1, k2, k3 = split(key, 3)``,
    ``tokens`` and ``labels`` (batch, S) int32 ``randint`` draws over the
    vocabulary from k1 and k2 (S is ``seq_len`` less a VLM's patch prefix),
    held as int64 (the port's index type); an encoder-decoder's ``frames``
    (batch, enc_len_for(seq_len), d_model) or a VLM's ``patches`` (batch,
    num_prefix, d_model) a bf16 ``normal`` from k3.  ``key`` is an int (read
    as ``PRNGKey(key)``), a (2,) uint32 key or None (``PRNGKey(0)``).  On the
    card every draw is one launch of the threefry kernel."""
    get_family(cfg)
    dev = resolve_device(device)
    k1, k2, k3 = prng.split(prng.as_key(0 if key is None else key), 3)
    shape = (batch, _token_len(cfg, seq_len))
    out = {name: prng.randint(k, shape, 0, cfg.vocab_size, dtype=torch.int64, device=dev)
           for name, k in (("tokens", k1), ("labels", k2))}
    if cfg.family == "encdec":
        out["frames"] = prng.normal(k3, (batch, encdec.enc_len_for(cfg, seq_len), cfg.d_model),
                                    dtype=torch.bfloat16, device=dev)
    if cfg.family == "vlm":
        out["patches"] = prng.normal(k3, (batch, cfg.encoder.num_prefix, cfg.d_model),
                                     dtype=torch.bfloat16, device=dev)
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
