"""Config dataclasses for model architectures and workload shapes.

Every assigned architecture gets a ``ModelConfig`` in its own module under
``repro_torch.configs``; the registry maps ``--arch`` ids to them.  Configs are
frozen dataclasses so they can be hashed into jit static args.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttentionConfig:
    kind: str = "gqa"  # "gqa" | "mla" | "local" | "none"
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 128
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: int = 0  # sliding window size for kind=="local"
    # MLA (DeepSeek-V2) parameters
    q_lora_rank: int = 0  # 0 = dense q projection
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    @property
    def q_dim(self) -> int:
        if self.kind == "mla":
            return self.num_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
        return self.num_heads * self.head_dim


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int
    num_shared: int = 0
    first_dense: int = 0  # number of leading dense layers
    dense_ff: int = 0  # d_ff used by those dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-3


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    ngroups: int = 1


@dataclass(frozen=True)
class HybridConfig:
    # repeating block pattern, e.g. ("rec", "rec", "attn")
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    lru_width: int = 2560
    conv_width: int = 4


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder / modality-frontend description for enc-dec, VLM and audio archs.

    Modality frontends are STUBS per the assignment: ``input_specs()`` supplies
    precomputed frame/patch embeddings.
    """

    num_layers: int = 0
    frontend: str = "none"  # "audio_frames" | "vision_patches" | "none"
    num_prefix: int = 0  # vision: number of patch embeddings prepended
    frame_ratio: int = 4  # audio: encoder_len = seq_len // frame_ratio


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "dense" | "moe" | "ssm" | "hybrid" | "encdec" | "vlm"
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encoder: Optional[EncoderConfig] = None
    act: str = "silu"  # "silu" | "gelu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    gemma_scaling: bool = False  # embed*sqrt(d), (1+w) RMSNorm
    dtype: str = "bfloat16"
    accum_steps: int = 1  # gradient-accumulation microbatches in train_step
    remat: bool = True
    optimizer: str = "adamw"  # "adamw" | "adafactor" (100B+ memory budget)
    grad_accum_dtype: str = "float32"  # "bfloat16" halves grad-AR volume
    source: str = ""  # provenance note "[arXiv:... ; tier]"

    # ---------------------------------------------------------------- helpers
    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        assert self.ssm is not None
        return self.d_inner // self.ssm.head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind for hybrid archs (else uniform)."""
        if self.family == "hybrid":
            assert self.hybrid is not None
            pat = self.hybrid.pattern
            return tuple(pat[i % len(pat)] for i in range(self.num_layers))
        return tuple(["block"] * self.num_layers)

    # -------------------------------------------------------- analytic counts
    def attn_params_per_layer(self) -> int:
        a = self.attention
        d = self.d_model
        if a.kind == "mla":
            q = d * a.q_lora_rank + a.q_lora_rank * a.q_dim if a.q_lora_rank else d * a.q_dim
            kv = d * (a.kv_lora_rank + a.qk_rope_head_dim)
            kv += a.kv_lora_rank * a.num_heads * (a.qk_nope_head_dim + a.v_head_dim)
            o = a.num_heads * a.v_head_dim * d
            return q + kv + o
        if a.kind == "none":
            return 0
        qd = a.num_heads * a.head_dim
        kvd = a.num_kv_heads * a.head_dim
        return d * (qd + 2 * kvd) + qd * d

    def mlp_params(self, ff: int) -> int:
        return 3 * self.d_model * ff  # gated MLPs (SwiGLU / GeGLU) everywhere

    def n_params(self) -> int:
        """Total parameter count (analytic)."""
        d, v = self.d_model, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        if self.family == "ssm":
            s = self.ssm
            di = self.d_inner
            conv_dim = di + 2 * s.ngroups * s.d_state
            per = (
                d * (2 * di + 2 * s.ngroups * s.d_state + self.ssm_heads)  # in_proj
                + conv_dim * s.d_conv
                + self.ssm_heads  # A_log
                + self.ssm_heads  # D
                + di  # norm gate
                + di * d  # out_proj
                + d  # layer norm
            )
            return total + per * self.num_layers + d
        kinds = self.layer_kinds()
        for i, kind in enumerate(kinds):
            total += d  # pre-norm
            if self.family == "hybrid" and kind == "rec":
                w = self.hybrid.lru_width
                total += 2 * d * w + w * d  # linear x, gate branch, out
                total += w * self.hybrid.conv_width  # conv1d
                total += 3 * w  # lru gates a, input gate params approx
            else:
                total += self.attn_params_per_layer()
            total += d  # post-attn norm
            if self.moe is not None and i >= self.moe.first_dense:
                m = self.moe
                total += d * m.num_experts  # router
                total += (m.num_experts + m.num_shared) * 3 * d * m.expert_ff
            elif self.moe is not None:
                total += self.mlp_params(self.moe.dense_ff)
            else:
                total += self.mlp_params(self.d_ff)
        total += d  # final norm
        if self.family == "encdec":
            e = self.encoder
            enc_per = self.attn_params_per_layer() + self.mlp_params(self.d_ff) + 2 * d
            dec_cross = self.attn_params_per_layer() + d
            total += e.num_layers * enc_per + self.num_layers * dec_cross + d
        return total

    def n_active_params(self) -> int:
        """Active (per-token) params for MoE archs; == n_params for dense."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        full = self.n_params()
        inactive_experts = m.num_experts - m.top_k
        moe_layers = self.num_layers - m.first_dense
        return full - moe_layers * inactive_experts * 3 * self.d_model * m.expert_ff

    def encoder_params(self) -> int:
        """Params of the encoder stack (enc-dec archs only)."""
        if self.family != "encdec" or self.encoder is None:
            return 0
        d = self.d_model
        per = self.attn_params_per_layer() + self.mlp_params(self.d_ff) + 2 * d
        return self.encoder.num_layers * per

    def flops_per_token(self, seq_len: int, training: bool = False) -> float:
        """Approximate MODEL_FLOPS per token: 6*N_active for train, 2*N_active
        for inference, plus attention O(S) term.  For enc-dec archs the
        encoder runs seq/frame_ratio positions, so its params contribute at
        1/frame_ratio of the decoder-token rate."""
        n = self.n_active_params()
        if self.family == "encdec" and self.encoder is not None:
            enc = self.encoder_params()
            n = (n - enc) + enc / self.encoder.frame_ratio
        base = (6.0 if training else 2.0) * n
        # attention score/values FLOPs: 2*2*H*hd*S per token (causal halves it)
        a = self.attention
        if a.kind != "none":
            hd = a.head_dim if a.kind != "mla" else (a.qk_nope_head_dim + a.qk_rope_head_dim)
            eff_s = min(seq_len, a.window) if a.kind == "local" else seq_len
            attn = 2 * 2 * a.num_heads * hd * eff_s * 0.5
            n_attn_layers = sum(1 for k in self.layer_kinds() if k in ("block", "attn"))
            base += (3.0 if training else 1.0) * attn * n_attn_layers
        return base


@dataclass(frozen=True)
class WorkloadShape:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": WorkloadShape("train_4k", "train", 4096, 256),
    "prefill_32k": WorkloadShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": WorkloadShape("decode_32k", "decode", 32768, 128),
    "long_500k": WorkloadShape("long_500k", "decode", 524288, 1),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def supports_shape(cfg: ModelConfig, shape: WorkloadShape) -> bool:
    """long_500k only runs on sub-quadratic archs (per assignment)."""
    if shape.name == "long_500k":
        return cfg.family in SUBQUADRATIC_FAMILIES
    return True
