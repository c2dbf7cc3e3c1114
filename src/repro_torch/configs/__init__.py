from .base import (ArchEntry, MLAConfig, ModelConfig, MoEConfig,
                   RecurrentConfig, get_arch, list_archs, register)

__all__ = ["ArchEntry", "MLAConfig", "ModelConfig", "MoEConfig",
           "RecurrentConfig", "get_arch", "list_archs", "register"]
