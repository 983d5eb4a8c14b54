"""Family registry and concrete batches.

The port has the dense, MoE, SSM and VLM families; the others raise and
name the ``ROADMAP.md`` item that ports them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import moe, ssm, transformer, vlm
from repro_torch.util import resolve_device

FAMILIES = {"dense": transformer, "moe": moe, "ssm": ssm, "vlm": vlm}
_TO_PORT = {  # family -> where ROADMAP.md queues its port
    "encdec": "Queue 1 item 3.3 (models/encdec.py)",
    "hybrid": "Queue 1 item 3.4 (models/rglru.py)",
}


def get_family(cfg):
    """The module implementing ``cfg.family``'s API."""
    if cfg.family in FAMILIES:
        return FAMILIES[cfg.family]
    where = _TO_PORT.get(cfg.family, "no ROADMAP.md item")
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet: ROADMAP.md {where}")


def _token_len(cfg, seq_len: int) -> int:
    """Text tokens such that the processed sequence is ``seq_len`` long (a
    VLM's patch prefix counts)."""
    if cfg.family == "vlm":
        return max(1, seq_len - cfg.encoder.num_prefix)
    return seq_len


def make_batch(cfg, batch: int, seq_len: int, seed: int = 0, device="cuda"):
    """{"tokens": (batch, S) int64} drawn uniformly from the vocabulary by
    ``np.random.RandomState(seed)``, so a test can hand the same inputs to
    the JAX package; S is ``seq_len`` less a VLM's patch prefix, and a VLM
    batch also carries ``patches`` (batch, num_prefix, d_model) bf16,
    standard normals drawn next from the same generator."""
    get_family(cfg)
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, (batch, _token_len(cfg, seq_len)))
    out = {"tokens": torch.from_numpy(tokens.astype(np.int64)).to(dev)}
    if cfg.family == "vlm":
        patches = rng.standard_normal((batch, cfg.encoder.num_prefix, cfg.d_model))
        out["patches"] = torch.from_numpy(patches.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return out
