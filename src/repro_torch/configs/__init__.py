from repro_torch.configs.base import (
    AttentionConfig, EncoderConfig, HybridConfig, ModelConfig, MoEConfig,
    SSMConfig, SHAPES, WorkloadShape, supports_shape,
)
from repro_torch.configs.registry import ARCHS, cells, get_config, list_archs, reduced_config

__all__ = [
    "AttentionConfig", "EncoderConfig", "HybridConfig", "ModelConfig",
    "MoEConfig", "SSMConfig", "SHAPES", "WorkloadShape", "supports_shape",
    "ARCHS", "cells", "get_config", "list_archs", "reduced_config",
]
