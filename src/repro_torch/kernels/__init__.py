"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  Kernels are built at first use (``build.py``), never on import."""
from .distance import (LAUNCHES, multi_seed_rows, multi_seed_rows_ref,
                       reset_launches)

__all__ = ["LAUNCHES", "multi_seed_rows", "multi_seed_rows_ref",
           "reset_launches"]
