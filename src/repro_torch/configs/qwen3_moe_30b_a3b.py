"""Config module for --arch: re-exports the canonical config from archs.py."""
from repro_torch.configs.archs import QWEN3_MOE_30B_A3B as CONFIG

__all__ = ["CONFIG"]
