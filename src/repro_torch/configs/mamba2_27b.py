"""Config module for --arch: re-exports the canonical config from archs.py."""
from repro_torch.configs.archs import MAMBA2_27B as CONFIG

__all__ = ["CONFIG"]
