"""Config module for --arch: re-exports the canonical config from archs.py."""
from repro_torch.configs.archs import DEEPSEEK_CODER_33B as CONFIG

__all__ = ["CONFIG"]
