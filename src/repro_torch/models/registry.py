"""Family registry and concrete batches.

The port has the dense and SSM families so far; every other family raises
and names the ``ROADMAP.md`` item that ports it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import ssm, transformer
from repro_torch.util import resolve_device

FAMILIES = {"dense": transformer, "ssm": ssm}
_TO_PORT = {  # family -> where ROADMAP.md queues its port
    "moe": "Queue 1 item 2, slice D item 13 (models/moe.py, models/mla.py)",
    "hybrid": "Queue 1 item 2, slice D item 13 (models/rglru.py)",
    "encdec": "Queue 1 item 2, slice D item 13 (models/encdec.py)",
    "vlm": "Queue 1 item 2, slice D item 13 (models/vlm.py)",
}


def get_family(cfg):
    """The module implementing ``cfg.family``'s API."""
    if cfg.family in FAMILIES:
        return FAMILIES[cfg.family]
    where = _TO_PORT.get(cfg.family, "no ROADMAP.md item")
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet: ROADMAP.md {where}")


def make_batch(cfg, batch: int, seq_len: int, seed: int = 0, device="cuda"):
    """{"tokens": (batch, seq_len) int64} drawn uniformly from the
    vocabulary by ``np.random.RandomState(seed)``, so a test can hand the
    same tokens to the JAX package."""
    get_family(cfg)
    dev = resolve_device(device)
    tokens = np.random.RandomState(seed).randint(0, cfg.vocab_size, (batch, seq_len))
    return {"tokens": torch.from_numpy(tokens.astype(np.int64)).to(dev)}
