from repro_torch.configs.base import CluSDConfig

__all__ = ["CluSDConfig"]
