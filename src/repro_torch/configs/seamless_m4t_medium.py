"""Config module for --arch: re-exports the canonical config from archs.py."""
from repro_torch.configs.archs import SEAMLESS_M4T_MEDIUM as CONFIG

__all__ = ["CONFIG"]
