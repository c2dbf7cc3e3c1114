"""Static costs of a region: FLOPs, bytes and collective traffic of one
call, and the roofline they give on the card.

The PyTorch port of the reference's ``repro/core/hlo.py``.  The reference
reads FLOPs and bytes from XLA's ``compiled.cost_analysis()`` and parses
the collectives out of the partitioned module's HLO text
(``parse_collectives``).  The port compiles no module and makes no HLO,
so ``parse_collectives`` has no twin: its counterpart is
:func:`collectives_of`, which counts each collective while the call runs
once in eager mode, from the functional collectives DTensor issues and the
``torch.distributed`` calls, under the reference's op names and into the
reference's :class:`CollectiveStats`.  :func:`cost_of` counts FLOPs and
bytes the same way; on DTensors every count is one rank's, from the local
shards.  A region that issues no collective (one card, no process group)
records ``COMM_BYTES = 0``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# Words of a collective's aten name (``_c10d_functional.all_gather_into_
# tensor``, ``c10d.allreduce_`` ...) -> the reference's op name.
_COLLECTIVE_WORDS = (
    ("reduce_scatter", "reduce-scatter"), ("all_gather", "all-gather"),
    ("allgather", "all-gather"), ("all_reduce", "all-reduce"),
    ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
    ("alltoall", "all-to-all"), ("permute", "collective-permute"),
    ("send", "collective-permute"), ("recv", "collective-permute"),
)


@dataclasses.dataclass
class CollectiveStats:
    """Result bytes and counts of collectives, by the reference's op
    names (``COLLECTIVE_OPS``)."""

    bytes_by_op: Dict[str, int]
    count_by_op: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())

    def summary(self) -> str:
        parts = [f"{op}: n={self.count_by_op[op]} "
                 f"bytes={self.bytes_by_op[op]:,}"
                 for op in sorted(self.bytes_by_op)]
        return "; ".join(parts) if parts else "none"


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


def collective_op(func) -> str:
    """The reference's name of the collective ``func`` is, or ""."""
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d_functional", "c10d"):
        return ""
    name = func._schema.name.split("::")[-1]
    for word, op in _COLLECTIVE_WORDS:
        if word in name:
            return op
    return ""


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _in_fake_mode() -> bool:
    """Inside a ``FakeTensorMode``: DTensor's sharding propagation runs an
    op on global-shape fakes the first time it meets its shapes, to learn
    the output's metadata; that is not the computation."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def is_dtensor_type(t: type) -> bool:
    """Is ``t`` DTensor (or a subclass)?"""
    return t.__module__.startswith("torch.distributed.tensor")


# In-place writes of indexed slices of a buffer (a decode cache's new
# slots: ``models/layers.py::_write_cache``).
_INDEXED_WRITES = (torch.ops.aten.index_copy_.default,)

# Pointwise ops XLA's cost analysis counts as transcendentals, not FLOPs
# (``HloCostAnalysis::HandleElementwiseOp``: exp, log, logistic, power,
# sqrt, rsqrt, tanh, the trigonometric functions, erf).
_TRANSCENDENTAL = frozenset(
    getattr(torch.ops.aten, name) for name in (
        "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sigmoid",
        "pow", "sqrt", "rsqrt", "tanh", "sin", "cos", "tan", "atan2",
        "erf"))


def _numel(tree) -> int:
    return sum(t.numel() for t in _tensors(tree))


# Pointwise ops XLA expands into several (its CPU backend's counts for
# jax.nn's twins: logistic as 1 / (1 + exp(-x)), silu as x · logistic,
# the tanh GELU, softplus), and the softmaxes (a max and a sum reduced, a
# subtraction and a division an element): FLOPs an element.
_EXPANDED = {
    torch.ops.aten.sigmoid: 3, torch.ops.aten.silu: 4,
    torch.ops.aten.gelu: 8, torch.ops.aten.softplus: 6,
    torch.ops.aten._softmax: 4, torch.ops.aten._log_softmax: 4,
}
# Ops XLA does not repeat in each reader of their output
# (``InstructionFusion::IsExpensive``): the transcendentals, the ops it
# expands into them, division and powers.
_EXPENSIVE = _TRANSCENDENTAL | frozenset(_EXPANDED) | frozenset(
    (torch.ops.aten.div, torch.ops.aten.reciprocal))
# Writes through a boolean mask (``t[mask] = v``: DTensor's masked
# embedding rows), a select over every element in XLA.
_MASKED_WRITES = (torch.ops.aten.index_put_.default,
                  torch.ops.aten.index_put.default)
# Collectives that sum: XLA counts one FLOP per result element
# (``HloCostAnalysis::HandleAllReduce``).
_SUMMING_COLLECTIVES = ("all-reduce", "reduce-scatter")


def elementwise_flops(func, args, kwargs, out) -> int:
    """FLOPs of an aten op outside ``flop_registry`` as XLA's cost analysis
    counts its HLO: one per output element of a pointwise op (none for a
    transcendental, which XLA counts apart; several for the ops XLA
    expands, ``_EXPANDED``, and an integer power), a reduction's input
    elements less its output elements (one application of the reducer
    each), one
    per element of a masked write (a select) and one per result element
    of a summing collective.  Other data movement (copies, gathers,
    concatenations, fills) counts none."""
    packet = func._overloadpacket
    if packet in _EXPANDED:
        return _EXPANDED[packet] * _numel(out)
    if packet is torch.ops.aten.pow and isinstance(args[1], (int, float)) \
            and float(args[1]).is_integer() and args[1] >= 2:
        # an integer power: the multiplications XLA lowers it to
        return (int(args[1]) - 1) * _numel(out)
    if torch.Tag.pointwise in func.tags:
        return 0 if packet in _TRANSCENDENTAL else _numel(out)
    if torch.Tag.reduction in func.tags:
        return max(_numel(args[:1]) - _numel(out), 0)
    if func in _MASKED_WRITES and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in args[1]):
        return _numel(args[:1])
    if collective_op(func) in _SUMMING_COLLECTIVES:
        return _numel(out)
    return 0


class _CostMode(TorchDispatchMode):
    """Counts what each aten op on plain tensors does: its FLOPs (the
    formulas of ``torch.utils.flop_counter`` for matrix products and
    convolutions; with ``xla``, :func:`elementwise_flops` for the rest),
    the bytes of every tensor it reads and writes (view ops, which move
    no data, skipped; an indexed write in place, its index and values
    read and written; with ``fused``, see :func:`costs_of`) and, for a
    collective, its result's bytes under the reference's op name.  An op
    on DTensors is handed on (``NotImplemented``): DTensor runs it as ops on the local
    shards and collectives, which come back here, so every count is one
    rank's.  Ops that decompose are counted as their parts, as
    ``FlopCounterMode`` counts them."""

    def __init__(self, device_type: Optional[str] = None,
                 fused: bool = False, xla: bool = False):
        super().__init__()
        self.device_type = device_type
        self.fused = fused
        self.xla = xla
        self.flops = 0
        self.bytes = 0
        self.collectives = CollectiveStats({}, {})
        # fused mode: each output of a fused op -> [bytes, readers, fused
        # readers, expensive] (its views share the record)
        self._fusible = WeakIdKeyDictionary()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(is_dtensor_type(t) for t in types):
            return NotImplemented
        if func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if _in_fake_mode():
            return out
        tensors = _tensors((args, kwargs, out))
        if self.device_type is not None and not any(
                t.device.type == self.device_type for t in tensors):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif self.xla:
            self.flops += elementwise_flops(func, args, kwargs, out)
        op = collective_op(func)
        if op:
            c = self.collectives
            c.bytes_by_op[op] = c.bytes_by_op.get(op, 0) + sum(
                t.numel() * t.element_size() for t in _tensors(out))
            c.count_by_op[op] = c.count_by_op.get(op, 0) + 1
        root = bool(op) or packet in flop_registry \
            or torch.Tag.reduction in func.tags
        if self.fused:
            self._fuse(func, args, kwargs, out, root)
        if self.fused and not root:
            pass    # inside a fusion: no traffic of its own
        elif func in _INDEXED_WRITES:
            # self, dim, index, values: the index and the values read, as
            # many bytes written; the rest of the buffer is not touched
            # (XLA counts its in-place dynamic-update-slice so)
            index, values = args[2], args[3]
            self.bytes += index.numel() * index.element_size() \
                + 2 * values.numel() * values.element_size()
        elif not func.is_view:
            self.bytes += sum(t.numel() * t.element_size() for t in tensors)
        return out

    def _fuse(self, func, args, kwargs, out, root: bool) -> None:
        """Fused mode: an op outside a fusion's roots (products,
        reductions, collectives) fuses into its readers and moves nothing
        of its own.  Where two or more ops read its output (or views of
        it), XLA repeats a cheap chain in each reader, but materialises
        one that holds an expensive op (a transcendental, a division, a
        power: ``InstructionFusion::IsExpensive``): written once and read
        by each fused reader (a root's reads are its own)."""
        if func.is_view:
            base = next((self._fusible[t] for t in _tensors(args)
                         if t in self._fusible), None)
            if base is not None:
                for t in _tensors(out):
                    self._fusible[t] = base
            return
        read = {id(r): r for r in (self._fusible.get(t)
                                   for t in _tensors((args, kwargs)))
                if r is not None}
        for rec in read.values():
            rec[1] += 1
            rec[2] += not root
            if not rec[3]:
                continue
            if rec[1] == 2:
                self.bytes += rec[0] * (1 + rec[2])
            elif rec[1] > 2 and not root:
                self.bytes += rec[0]
        if not root and func.namespace != "_c10d_functional":
            for t in _tensors(out):
                nbytes = t.numel() * t.element_size()
                # a broadcast operand (a scalar) is its own fusion
                expensive = func._overloadpacket in _EXPENSIVE or any(
                    r[3] and r[0] >= nbytes for r in read.values())
                self._fusible[t] = [nbytes, 0, 0, expensive]


def _local_bytes(tree) -> int:
    """Bytes of the tensors of ``tree``, a DTensor's local shard."""
    return sum(t.to_local().nbytes if is_dtensor_type(type(t)) else t.nbytes
               for t in _tensors(tree))


def costs_of(fn: Callable[..., Any], *args,
             device_type: Optional[str] = None, xla: bool = False,
             fused: bool = False, unfused: bool = False
             ) -> Tuple[float, float, CollectiveStats]:
    """``(flops, bytes, collectives)`` of one call ``fn(*args)``, which
    runs once; see :func:`cost_of` and :func:`collectives_of`.  With
    ``device_type`` only the ops that touch a tensor of that type count:
    the dry-run's model lives on ``meta``, and DTensor's own index
    bookkeeping, which it runs on host tensors the first time it meets a
    layout and then caches, is not the model's work.  ``xla`` counts the
    elementwise FLOPs too, as XLA's cost analysis does
    (:func:`elementwise_flops`): the convention of the reference's
    compiled-module counts, which the dry-run, its roofline and the
    static analyzer share.  ``fused`` counts
    the bytes as XLA counts a fused module's: the call's arguments read
    and its result written once, the operands and results of the
    products, of the reductions (XLA's reduce fusions read their input
    once, its elementwise producers fused in), of the collectives and of
    the kernels; every other op is taken as fused into its neighbours and
    moves nothing of its own.  With ``unfused`` a kernel whose function
    has an unfused form (attention) counts that
    (:func:`repro_torch.kernels.counting_costs`)."""
    from repro_torch.kernels import counting_costs
    with counting_costs(unfused) as kernels, \
            _CostMode(device_type, fused, xla) as mode:
        out = fn(*args)
    nbytes = float(mode.bytes) + kernels[1]
    if fused:
        nbytes += _local_bytes((args, out))
    return float(mode.flops) + kernels[0], nbytes, mode.collectives


def collectives_of(fn: Callable[..., Any], *args) -> CollectiveStats:
    """The collectives one call ``fn(*args)`` issues on this rank, which
    runs once: each one's result bytes and count under the reference's op
    names (the twin of ``parse_collectives`` on the call's partitioned
    module).  It sees the functional collectives DTensor's redistributions
    issue and the ``torch.distributed`` calls; a call with no process
    group issues none."""
    return costs_of(fn, *args)[2]


def cost_of(fn: Callable[..., Any], *args) -> Tuple[float, float]:
    """``(flops, bytes)`` of one call ``fn(*args)``, which runs once.

    FLOPs are ``torch.utils.flop_counter``'s formulas: matrix products and
    convolutions only, so an elementwise ``tanh`` counts 0 where XLA's
    ``cost_analysis`` counts it (``costs_of(xla=True)`` counts those, as
    the dry-run does).  Bytes sum each aten op's
    tensor inputs and outputs, which counts *unfused* traffic — every
    intermediate written and read again — where XLA's ``bytes accessed``
    counts the fused module's (``costs_of(fused=True)`` counts that).  On
    DTensors both are one rank's, counted on the local shards
    (:class:`_CostMode`), as the reference's costs of a partitioned
    module are per chip.  A loop whose trip count is data
    (``scenarios.faults.iterated_work``, the trainer's expert probes) runs
    its body once under the count (``kernels.loop_trips``), as XLA counts
    the body of a ``fori_loop`` with a traced trip count once, so a
    region's count is the same for every shard.  The port's
    kernels (RMSNorm, attention, WKV-6, seed rows) are ctypes launches
    that no aten-level counter sees: each wrapper call adds its kernel's
    analytic FLOPs and bytes instead (:func:`repro_torch.kernels.
    counting_costs`), on the card and, in place of its plain version's
    aten ops, on the CPU and on ``meta``.  The host pays several times a
    plain call's cost for the counting, so a caller counts once, outside
    any timed call."""
    return costs_of(fn, *args)[:2]
