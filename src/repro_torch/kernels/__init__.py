"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  Kernels are built at first use (``build.py``), never on import.

``LAUNCHES`` counts the launches of each CUDA kernel, incremented by its
wrapper where it launches the kernel and nowhere else, so a run can show
that its main path went through the kernels.

:func:`counting_costs` counts the work of the wrapper calls made inside
it (``core/hlo.py::cost_of`` opens one): each wrapper decorated with
:func:`counted` adds its kernel's analytic FLOPs and bytes, the counts
``chip_smoke.py``'s bounds use, and runs outside the active PyTorch
dispatch modes.  The aten-level counters of ``cost_of`` cannot see a
ctypes launch on the card, and on the CPU they must not count the plain
version as well, so a count is the same on both devices.  Inside one, a
loop whose trip count is data runs its body once (:func:`loop_trips`).
"""
import contextlib
import functools
from typing import Callable, Dict, Iterator, List, Tuple

LAUNCHES: Dict[str, int] = {"multi_seed_rows": 0, "rmsnorm": 0,
                            "flash_attention": 0, "wkv6": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    SEED_COUNTS.clear()


# The [flops, bytes] of each active counting_costs() block.
_COSTS: List[List[float]] = []


@contextlib.contextmanager
def counting_costs() -> Iterator[List[float]]:
    """Count ``[flops, bytes]`` of the counted wrapper calls made inside
    the block (nested blocks each count their own calls)."""
    counts = [0.0, 0.0]
    _COSTS.append(counts)
    try:
        yield counts
    finally:
        _COSTS.remove(counts)


def loop_trips(n: int) -> int:
    """Iterations to run of a loop whose trip count is data (``n``): all
    of them, but one inside a cost count, where the body is counted once
    as the reference's compiled cost analysis counts the body of a
    ``fori_loop`` with a traced trip count."""
    return 1 if _COSTS else n


def counted(work: Callable[..., Tuple[float, float]]):
    """Decorate a kernel wrapper: while a cost count is active, a call adds
    ``work(*args, **kw)`` (its FLOPs and bytes) to every active count and
    runs with PyTorch's dispatch modes (the aten-level counters) off."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if not _COSTS:
                return fn(*args, **kw)
            from torch.utils._python_dispatch import _disable_current_modes
            with _disable_current_modes():
                flops, nbytes = work(*args, **kw)
                for counts in _COSTS:
                    counts[0] += flops
                    counts[1] += nbytes
                return fn(*args, **kw)
        return call
    return wrap


from .distance import (SEED_COUNTS, multi_seed_rows,  # noqa: E402
                       multi_seed_rows_ref)
from .flash_attention import (FlashAttentionFunction,  # noqa: E402
                              flash_attention, flash_attention_backward,
                              flash_attention_ref)
from .rmsnorm import (RmsnormFunction, rmsnorm,  # noqa: E402
                      rmsnorm_backward, rmsnorm_ref)
from .wkv6 import (Wkv6Function, wkv6, wkv6_backward,  # noqa: E402
                   wkv6_ref)

__all__ = ["LAUNCHES", "reset_launches", "counting_costs", "counted",
           "loop_trips",
           "multi_seed_rows", "multi_seed_rows_ref", "rmsnorm", "rmsnorm_ref",
           "rmsnorm_backward", "RmsnormFunction", "flash_attention",
           "flash_attention_ref", "flash_attention_backward",
           "FlashAttentionFunction", "wkv6", "wkv6_ref", "wkv6_backward",
           "Wkv6Function"]
