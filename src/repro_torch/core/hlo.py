"""Static costs of a region: FLOPs and bytes of one call, and the roofline
they give on the card.

The PyTorch port of the parts of the reference's ``repro/core/hlo.py`` that
a single-card collector needs.  The reference reads both numbers from
XLA's ``compiled.cost_analysis()``; there is no compiled module here, so
:func:`cost_of` counts them while the region runs once in eager mode.
The reference's ``parse_collectives`` parses HLO text and has no torch
counterpart: a region on one card records ``COMM_BYTES = 0``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode


@dataclasses.dataclass
class HardwareSpec:
    """Per-card capability, with the reference's field names so a spec
    converts field for field.  The defaults are NVIDIA's data sheet for
    one H100 SXM at its full 700 W power limit (dense rates, no
    sparsity); a card set below 700 W runs slower under load.

    * ``peak_flops`` — bf16 tensor-core FLOP/s;
    * ``hbm_bandwidth`` — HBM3 bytes/s;
    * ``ici_bandwidth`` — NVLink bytes/s in one direction (900 GB/s both
      ways over 18 links);
    * ``hbm_bytes`` — device memory;
    * ``vmem_bytes`` — shared memory per SM, the on-chip store the port's
      ``vmem_pressure`` metric reads as (``core/metrics.py``).
    """

    name: str = "h100-sxm"
    peak_flops: float = 989e12
    hbm_bandwidth: float = 3.35e12
    ici_bandwidth: float = 450e9
    hbm_bytes: float = 80e9
    vmem_bytes: float = 228 * 2**10


H100_SXM = HardwareSpec()


@dataclasses.dataclass
class RooflineTerms:
    """The three roofline terms, in seconds."""

    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    chips: int
    model_flops: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute_term / max(all terms): 1.0 = perfectly compute-bound."""
        b = self.bound_s
        return self.compute_s / b if b > 0 else 0.0


def roofline_terms(
    hlo_flops: float,
    hlo_bytes: float,
    collective_bytes: float,
    chips: int,
    hw: HardwareSpec = H100_SXM,
    model_flops: float = 0.0,
    flops_already_per_chip: bool = True,
) -> RooflineTerms:
    """The three-term roofline, with the reference's arithmetic: by
    default the counts are per card already and are not divided by
    ``chips`` again."""
    div = 1.0 if flops_already_per_chip else float(chips)
    return RooflineTerms(
        compute_s=hlo_flops / div / hw.peak_flops,
        memory_s=hlo_bytes / div / hw.hbm_bandwidth,
        collective_s=collective_bytes / div / hw.ici_bandwidth,
        hlo_flops=hlo_flops,
        hlo_bytes=hlo_bytes,
        collective_bytes=collective_bytes,
        chips=chips,
        model_flops=model_flops,
    )


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every tensor each aten op reads and writes.  View
    ops (``t``, ``view``, ``expand`` ...) move no data and are skipped."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in (*tree_flatten((args, kwargs))[0],
                      *tree_flatten(out)[0]):
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


def cost_of(fn: Callable[..., Any], *args) -> Tuple[float, float]:
    """``(flops, bytes)`` of one call ``fn(*args)``, which runs once.

    FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s: matrix
    products and convolutions only, so an elementwise ``tanh`` counts 0
    where XLA's ``cost_analysis`` counts it.  Bytes sum each aten op's
    tensor inputs and outputs, which counts *unfused* traffic — every
    intermediate written and read again — where XLA's ``bytes accessed``
    counts the fused module's.  A loop in ``fn`` is counted once per
    iteration it runs (XLA counts a ``fori_loop`` body once).  The host
    pays several times a plain call's cost for the counting, so a caller
    counts once, outside any timed call."""
    with FlopCounterMode(display=False) as flops, _ByteCounter() as nbytes:
        fn(*args)
    return float(flops.get_total_flops()), float(nbytes.bytes)
