"""Architecture registry: ``--arch <id>`` -> ModelConfig, plus reduced
smoke-test configs of the same family."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import archs
from repro_torch.configs.base import (
    AttentionConfig,
    EncoderConfig,
    ModelConfig,
    SHAPES,
    WorkloadShape,
    supports_shape,
)

ARCHS = dict(archs.ALL)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def list_archs():
    return sorted(ARCHS)


def reduced_config(arch: str) -> ModelConfig:
    """A tiny config of the same family, used by smoke tests and CPU examples.

    Keeps the structural features (GQA ratio, MLA, MoE routing, hybrid
    pattern, enc-dec, frontends) while shrinking width/depth/vocab."""
    cfg = get_config(arch)
    a = cfg.attention
    kw = {}
    if a.kind == "mla":
        kw["attention"] = dataclasses.replace(
            a,
            num_heads=4,
            num_kv_heads=4,
            kv_lora_rank=32,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
            head_dim=16,
        )
    elif a.kind == "none":
        kw["attention"] = a
    else:
        n_kv = max(1, min(a.num_kv_heads, 2))
        kw["attention"] = dataclasses.replace(
            a, num_heads=4, num_kv_heads=n_kv, head_dim=16, window=min(a.window, 32) or a.window
        )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=2, expert_ff=32, dense_ff=64 if cfg.moe.dense_ff else 0
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=8, chunk=16)
    if cfg.hybrid is not None:
        kw["hybrid"] = dataclasses.replace(cfg.hybrid, lru_width=64)
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(
            cfg.encoder,
            num_layers=min(cfg.encoder.num_layers, 2),
            num_prefix=min(cfg.encoder.num_prefix, 8) or cfg.encoder.num_prefix,
        )
    n_layers = 4 if cfg.family != "hybrid" else 6  # hybrid: two full (rec,rec,attn) groups
    return cfg.replace(
        name=cfg.name + "-smoke",
        num_layers=n_layers,
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        accum_steps=1,
        remat=False,
        **kw,
    )


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells.  40 nominal; long_500k is skipped for
    pure full-attention archs per the assignment."""
    out = []
    for arch in sorted(ARCHS):
        cfg = ARCHS[arch]
        for shape in SHAPES.values():
            if supports_shape(cfg, shape) or include_skipped:
                out.append((arch, shape.name))
    return out
