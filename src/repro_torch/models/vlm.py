"""VLM family (paligemma-3b), as the JAX package's ``models/vlm.py``: the
dense (gemma) backbone with a vision-patch prefix.  The vision tower is a
stub: a batch carries precomputed patch embeddings ``patches`` (B, P,
d_model), prepended to the token embeddings.  ``forward`` returns logits at
the text positions only; ``prefill`` runs over [patches ; prompt] and its
cache covers the whole prefix; ``loss`` is the cross-entropy on the text
positions only.  The weights, the cache and decode are the dense family's.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T

init = T.init  # the dense family's weights
init_cache = T.init_cache
decode_step = T.decode_step


def _prefixed_embeddings(params: T.Transformer, cfg, batch):
    tokens = batch["tokens"]
    patches = batch["patches"].to(L.param_dtype(cfg))
    B, S = tokens.shape
    P = patches.shape[1]
    x = torch.cat([patches, L.embed_tokens(params.embed, cfg, tokens)], dim=1)
    positions = torch.arange(P + S, dtype=torch.int32, device=tokens.device)[None].expand(
        B, P + S)
    return x, positions, P


def _logits(params: T.Transformer, cfg, batch):
    """Logits for the TEXT positions only: (B, S, V) f32."""
    x, positions, P = _prefixed_embeddings(params, cfg, batch)
    x = T.backbone(params, cfg, x, positions)
    return L.lm_logits(params.embed, cfg, x[:, P:, :])


forward = torch.no_grad()(_logits)


def loss(params: T.Transformer, cfg, batch):
    logits = _logits(params, cfg, batch)
    return L.cross_entropy(logits, batch["labels"], batch.get("loss_mask")), {}


@torch.no_grad()
def prefill(params: T.Transformer, cfg, batch):
    """Prefill over [patches ; prompt tokens]: logits at the last position
    and a cache sized to the whole prefix (``pos`` = P + S)."""
    x, positions, _ = _prefixed_embeddings(params, cfg, batch)
    return T.prefill_embedded(params, cfg, x, positions)
