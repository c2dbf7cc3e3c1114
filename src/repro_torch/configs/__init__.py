from .base import (LONG_CONTEXT_FAMILIES, SHAPES, ArchEntry, InputShape,
                   MLAConfig, ModelConfig, MoEConfig, RecurrentConfig,
                   get_arch, list_archs, register, shapes_for)

__all__ = ["LONG_CONTEXT_FAMILIES", "SHAPES", "ArchEntry", "InputShape",
           "MLAConfig", "ModelConfig", "MoEConfig", "RecurrentConfig",
           "get_arch", "list_archs", "register", "shapes_for"]
