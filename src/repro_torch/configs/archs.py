"""The ten assigned architectures, exact published configs.

Each is importable as ``repro_torch.configs.archs.<ID>`` and registered in
``repro_torch.configs.registry``.  Sources are carried in ``ModelConfig.source``.
"""
from __future__ import annotations

from repro_torch.configs.base import (
    AttentionConfig,
    EncoderConfig,
    HybridConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)

# --------------------------------------------------------------------------
# [audio] seamless-m4t-medium — enc-dec, 12L enc + 12L dec, d_model=1024,
# 16H (GQA kv=16), d_ff=4096, vocab=256206.  Audio frontend is a STUB:
# input_specs() supplies precomputed frame embeddings (encoder_len = seq/4).
SEAMLESS_M4T_MEDIUM = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,
    d_model=1024,
    d_ff=4096,
    vocab_size=256256,  # published 256206, padded to a multiple of 256 for TP shardability
    attention=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=64),
    encoder=EncoderConfig(num_layers=12, frontend="audio_frames", frame_ratio=4),
    act="silu",
    accum_steps=1,
    source="[arXiv:2308.11596; hf]",
)

# --------------------------------------------------------------------------
# [dense] llama3-405b — 126L d=16384 128H (GQA kv=8) d_ff=53248 vocab=128256
LLAMA3_405B = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    d_ff=53248,
    vocab_size=128256,
    attention=AttentionConfig(
        num_heads=128, num_kv_heads=8, head_dim=128, rope_theta=500000.0
    ),
    accum_steps=8,
    source="[arXiv:2407.21783; unverified]",
)

# --------------------------------------------------------------------------
# [dense] qwen1.5-110b — 80L d=8192 64H (GQA kv=8) d_ff=49152 vocab=152064,
# QKV bias.
QWEN15_110B = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    d_ff=49152,
    vocab_size=152064,
    attention=AttentionConfig(num_heads=64, num_kv_heads=8, head_dim=128, qkv_bias=True),
    accum_steps=4,
    source="[hf:Qwen/Qwen1.5-0.5B; hf]",
)

# --------------------------------------------------------------------------
# [dense] deepseek-67b — 95L d=8192 64H (GQA kv=8) d_ff=22016 vocab=102400
DEEPSEEK_67B = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    d_ff=22016,
    vocab_size=102400,
    attention=AttentionConfig(num_heads=64, num_kv_heads=8, head_dim=128),
    accum_steps=4,
    source="[arXiv:2401.02954; hf]",
)

# --------------------------------------------------------------------------
# [dense] deepseek-coder-33b — 62L d=7168 56H (GQA kv=8) d_ff=19200 vocab=32256
DEEPSEEK_CODER_33B = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    d_ff=19200,
    vocab_size=32256,
    attention=AttentionConfig(num_heads=56, num_kv_heads=8, head_dim=128),
    accum_steps=2,
    source="[arXiv:2401.14196; hf]",
)

# --------------------------------------------------------------------------
# [moe] deepseek-v2-lite-16b — 27L d=2048 16H, MLA kv_lora=512,
# MoE: 2 shared + 64 routed top-6 (assignment text also mentions "160 routed",
# which is full V2; V2-LITE per HF config is 64 routed — see DESIGN.md).
# First layer dense (d_ff=10944), expert d_ff=1408.
DEEPSEEK_V2_LITE_16B = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    d_ff=1408,
    vocab_size=102400,
    attention=AttentionConfig(
        kind="mla",
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        q_lora_rank=0,  # V2-Lite has no q compression
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        expert_ff=1408,
        num_shared=2,
        first_dense=1,
        dense_ff=10944,
    ),
    accum_steps=1,
    source="[arXiv:2405.04434; hf]",
)

# --------------------------------------------------------------------------
# [moe] qwen3-moe-30b-a3b — 48L d=2048 32H (GQA kv=4) expert d_ff=768,
# 128 experts top-8, vocab=151936, q/k norm.
QWEN3_MOE_30B_A3B = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    d_ff=768,
    vocab_size=151936,
    attention=AttentionConfig(
        num_heads=32, num_kv_heads=4, head_dim=128, qk_norm=True, rope_theta=1000000.0
    ),
    moe=MoEConfig(num_experts=128, top_k=8, expert_ff=768, num_shared=0),
    accum_steps=1,
    source="[hf:Qwen/Qwen3-30B-A3B; hf]",
)

# --------------------------------------------------------------------------
# [vlm] paligemma-3b — gemma backbone 18L d=2048 8H (MQA kv=1) d_ff=16384
# vocab=257216.  SigLIP vision tower is a STUB supplying 256 patch embeddings.
PALIGEMMA_3B = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    d_ff=16384,
    vocab_size=257216,
    attention=AttentionConfig(num_heads=8, num_kv_heads=1, head_dim=256),
    encoder=EncoderConfig(frontend="vision_patches", num_prefix=256),
    act="gelu",
    gemma_scaling=True,
    tie_embeddings=True,
    accum_steps=1,
    source="[arXiv:2407.07726; hf]",
)

# --------------------------------------------------------------------------
# [hybrid] recurrentgemma-2b — 26L d=2560 10H (MQA kv=1) d_ff=7680
# vocab=256000, RG-LRU + local attention 1:2 pattern (rec,rec,attn),
# window=2048, lru_width=2560.
RECURRENTGEMMA_2B = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    d_ff=7680,
    vocab_size=256000,
    attention=AttentionConfig(
        kind="local", num_heads=10, num_kv_heads=1, head_dim=256, window=2048
    ),
    hybrid=HybridConfig(pattern=("rec", "rec", "attn"), lru_width=2560, conv_width=4),
    act="gelu",
    gemma_scaling=True,
    tie_embeddings=True,
    accum_steps=1,
    source="[arXiv:2402.19427; hf]",
)

# --------------------------------------------------------------------------
# [ssm] mamba2-2.7b — 64L d=2560, attn-free, vocab=50280 (padded to 50288 for
# 16-divisibility), ssm_state=128, head_dim=64, expand=2 (d_inner=5120).
MAMBA2_27B = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    d_ff=0,
    vocab_size=50288,
    attention=AttentionConfig(kind="none", num_heads=0, num_kv_heads=0, head_dim=0),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256, ngroups=1),
    tie_embeddings=True,
    accum_steps=1,
    source="[arXiv:2405.21060; unverified]",
)

ALL = {
    "seamless-m4t-medium": SEAMLESS_M4T_MEDIUM,
    "llama3-405b": LLAMA3_405B,
    "qwen1.5-110b": QWEN15_110B,
    "deepseek-67b": DEEPSEEK_67B,
    "deepseek-coder-33b": DEEPSEEK_CODER_33B,
    "deepseek-v2-lite-16b": DEEPSEEK_V2_LITE_16B,
    "qwen3-moe-30b-a3b": QWEN3_MOE_30B_A3B,
    "paligemma-3b": PALIGEMMA_3B,
    "recurrentgemma-2b": RECURRENTGEMMA_2B,
    "mamba2-2.7b": MAMBA2_27B,
}
