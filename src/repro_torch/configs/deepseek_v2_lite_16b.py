"""Config module for --arch: re-exports the canonical config from archs.py."""
from repro_torch.configs.archs import DEEPSEEK_V2_LITE_16B as CONFIG

__all__ = ["CONFIG"]
