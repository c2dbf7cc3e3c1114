"""Roofline terms of a dry-run cell: the twin of the reference's
``repro/launch/roofline.py``.

    compute term    = FLOPs / peak FLOP/s          (per rank)
    memory term     = bytes / HBM bandwidth         (per rank)
    collective term = collective bytes / link rate  (per rank)

The reference reads the counts off the compiled, SPMD-partitioned module;
the port counts them while the cell runs once on ``meta`` DTensors
(``core.hlo.costs_of``: each rank's local shards).  The hardware is one
H100 SXM (``core.hlo.H100_SXM``): the link rate is NVLink's 450 GB/s one
way, which a mesh of 256 or 512 GPUs exceeds (it spans nodes, whose
links are slower), so there the collective term is a lower bound.

:func:`memory_analysis_dict` reports what the port can count per rank:
``argument_size_in_bytes`` (the local shards of the parameters, the
optimizer state and the batch), ``output_size_in_bytes`` (those of the
outputs) and, for a training step, ``temp_size_in_bytes`` (the bytes of
the storages the forward made that are still alive when the loss is
returned: what the backward keeps, under the config's ``remat_policy``).
XLA's generated-code and alias sizes have no counterpart and are left
out.
"""
from __future__ import annotations

import dataclasses
import gc
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core.hlo import (H100_SXM, HardwareSpec, is_dtensor_type,
                                  roofline_terms)


def local_bytes(tree: Any) -> int:
    """Bytes of one rank's share of every tensor in ``tree`` (a DTensor's
    local shard)."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            if hasattr(t, "to_local"):
                t = t.to_local()
            total += t.numel() * t.element_size()
    return total


class LiveStorages(TorchDispatchMode):
    """Weak references to the storage of every local op's output (DTensor
    ops are handed on to their local ops): :meth:`live_bytes` sums the
    storages still alive.  A ``saved_tensors_hooks`` count would not do:
    inside a block that ``remat`` checkpoints, the checkpoint's own hooks
    take over from an outer one."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(is_dtensor_type(t) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.refs.append(weakref.ref(t.untyped_storage()))
        return out

    def live_bytes(self) -> int:
        gc.collect()
        alive = {}
        for ref in self.refs:
            st = ref()
            if st is not None:
                alive[st._cdata] = st.nbytes()
        return sum(alive.values())


def kept_bytes(forward: Callable[[], Any]) -> Tuple[Any, int]:
    """``(forward(), bytes)``: the bytes of the storages ``forward`` made
    that its result keeps alive (a loss keeps what its backward needs)."""
    mode = LiveStorages()
    with mode:
        out = forward()
    return out, mode.live_bytes()


def memory_analysis_dict(arguments: Any, outputs: Any,
                         temp: Optional[int] = None) -> Dict[str, float]:
    """The per-rank bytes the port can count: the local shards of the
    cell's arguments and outputs, and ``temp`` (a training step's kept
    bytes) where given."""
    out = {"argument_size_in_bytes": float(local_bytes(arguments)),
           "output_size_in_bytes": float(local_bytes(outputs))}
    if temp is not None:
        out["temp_size_in_bytes"] = float(temp)
    return out


@dataclasses.dataclass
class CellReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float
    bytes_accessed: float
    collective_bytes: float
    collectives: Dict[str, int]
    collective_counts: Dict[str, int]
    terms: Dict[str, float]
    dominant: str
    model_flops: float
    useful_ratio: float
    roofline_fraction: float
    memory: Dict[str, float]
    count_s: float
    notes: str = ""

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def analyze_cell(arch: str, shape_name: str, mesh, cost: Dict[str, Any],
                 memory: Dict[str, float], model_flops: float,
                 hw: HardwareSpec = H100_SXM, notes: str = "",
                 count_s: float = 0.0) -> CellReport:
    """A cell's report from its per-rank ``cost`` (the dry-run's
    ``{"flops", "bytes", "collective_bytes", "coll_by_op",
    "coll_counts"}``)."""
    chips = int(mesh.size())
    terms = roofline_terms(cost["flops"], cost["bytes"],
                           cost["collective_bytes"], chips, hw,
                           model_flops=model_flops / chips)
    return CellReport(
        arch=arch, shape=shape_name,
        mesh="x".join(str(s) for s in mesh.shape), chips=chips,
        flops=cost["flops"], bytes_accessed=cost["bytes"],
        collective_bytes=float(cost["collective_bytes"]),
        collectives={k: int(v) for k, v in cost["coll_by_op"].items()},
        collective_counts={k: int(v)
                           for k, v in cost["coll_counts"].items()},
        terms={"compute_s": terms.compute_s, "memory_s": terms.memory_s,
               "collective_s": terms.collective_s},
        dominant=terms.dominant, model_flops=model_flops,
        useful_ratio=terms.useful_flops_ratio,
        roofline_fraction=terms.roofline_fraction, memory=memory,
        count_s=count_s, notes=notes)


def model_flops_for(cfg, shape, n_params: int, n_active: int) -> float:
    """MODEL_FLOPS: 6·N·D (train) with D = tokens; prefill 2·N·D; decode
    steps process one token per sequence (2·N_active·B forward-only)."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch


def format_table(reports) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'mesh':10s} "
           f"{'compute_s':>10s} {'memory_s':>10s} {'coll_s':>10s} "
           f"{'bound':>10s} {'useful':>7s} {'roofl%':>7s}")
    lines = [hdr, "-" * len(hdr)]
    for r in reports:
        t = r.terms
        lines.append(
            f"{r.arch:24s} {r.shape:12s} {r.mesh:10s} "
            f"{t['compute_s']:10.3e} {t['memory_s']:10.3e} "
            f"{t['collective_s']:10.3e} {r.dominant:>10s} "
            f"{r.useful_ratio:7.3f} {100*r.roofline_fraction:6.1f}%")
    return "\n".join(lines)
