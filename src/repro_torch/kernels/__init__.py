"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  Kernels are built at first use (``build.py``), never on import.

``LAUNCHES`` counts the launches of each CUDA kernel, incremented by its
wrapper where it launches the kernel and nowhere else, so a run can show
that its main path went through the kernels.
"""
from typing import Dict

LAUNCHES: Dict[str, int] = {"multi_seed_rows": 0, "rmsnorm": 0,
                            "flash_attention": 0, "wkv6": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    SEED_COUNTS.clear()


from .distance import (SEED_COUNTS, multi_seed_rows,  # noqa: E402
                       multi_seed_rows_ref)
from .flash_attention import (flash_attention,  # noqa: E402
                              flash_attention_ref)
from .rmsnorm import rmsnorm, rmsnorm_ref  # noqa: E402
from .wkv6 import wkv6, wkv6_ref  # noqa: E402

__all__ = ["LAUNCHES", "reset_launches", "multi_seed_rows",
           "multi_seed_rows_ref", "rmsnorm", "rmsnorm_ref",
           "flash_attention", "flash_attention_ref", "wkv6", "wkv6_ref"]
