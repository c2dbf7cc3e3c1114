"""Gradient compression for slow inter-pod links: the twin of the
reference's ``repro/optim/compression.py``.

Int8 symmetric quantization with per-leaf float32 scales.
:func:`compressed_psum_fn` reduces each gradient leaf across a process
group with int8 codes: the group agrees on one scale per leaf (an
``all_reduce(MAX)`` of the leaves' amax), each rank quantizes its leaf
with it, the codes are summed in **int32** (``all_reduce(SUM)``), and the
sum is rescaled and divided by the group's size.  As in the reference,
the sum runs on int32 codes, so 4 bytes an element cross the link — the
reference's docstring says "~1/4 of the bytes"; its code
(``compression.py:75``) sums int32, and the port does the same, which
``core.hlo.collectives_of`` shows.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

Tree = Dict[str, torch.Tensor]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(codes int8, scale float32)``: scale = max(amax, 1e-30) / 127,
    codes = clip(round(x / scale), -127, 127), rounding half to even as
    ``jnp.round`` does."""
    amax = x.abs().max().to(torch.float32)
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127
                    ).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def quantize_tree(tree: Tree) -> Tuple[Tree, Tree]:
    """``({name: codes}, {name: scale})`` of every leaf."""
    qs = {k: quantize_int8(v) for k, v in tree.items()}
    return {k: q for k, (q, _) in qs.items()}, \
        {k: s for k, (_, s) in qs.items()}


def compressed_psum_fn(grads: Tree, group=None) -> Tree:
    """The mean of each leaf over ``group`` (None: the default group),
    moved as int8 codes summed in int32 with a scale shared by the group.
    Every rank passes its own leaves (no stacking dim) and receives the
    same mean, in each leaf's dtype."""
    n = dist.get_world_size(group)

    def one(g: torch.Tensor) -> torch.Tensor:
        # the scale must be SHARED before quantizing: summing codes
        # quantized at different scales is meaningless
        amax = g.abs().max().to(torch.float32).reshape(1)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp(amax[0], min=1e-30) / 127.0
        q = torch.clamp(torch.round(g.to(torch.float32) / scale), -127, 127
                        ).to(torch.int8)
        tot = q.to(torch.int32)
        dist.all_reduce(tot, op=dist.ReduceOp.SUM, group=group)
        return (tot.to(torch.float32) * scale / n).to(g.dtype)

    return {k: one(g) for k, g in grads.items()}


def pod_compressed_allreduce(mesh, grads_stacked: Tree,
                             axis: str = "pod") -> Tree:
    """Mean-reduce per-pod gradients across ``axis`` of ``mesh`` with int8
    payloads, the reference's contract: each leaf carries a leading
    per-pod dim (size = the pod count) and this rank contributes the row
    of its own pod along ``axis``; the replicated mean comes back without
    that dim.  A mesh with no such axis returns ``g[0]`` of each leaf."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        return {k: g[0] for k, g in grads_stacked.items()}
    i = names.index(axis)
    pod = mesh.get_local_rank(axis)
    return compressed_psum_fn({k: g[pod] for k, g in grads_stacked.items()},
                              group=mesh.get_group(i))
