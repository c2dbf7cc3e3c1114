"""The kernels at the DTensor boundary.

A kernel reads ``data_ptr()``, which a DTensor does not have.  Each
function here takes DTensor arguments, makes sure the dims the kernel
needs whole are whole on every rank, calls ``local`` (the plain-tensor
path: the kernel's wrapper or its autograd Function) on the local shards,
and wraps the result back as a DTensor with the placements it kept.
Nothing is gathered but what the kernel needs whole:

* RMSNorm needs whole rows: a shard of x's last dim (none under the
  reference's activation rules, where ``act_embed`` is unsharded) is
  redistributed first; the scale w is replicated (an all-gather, as
  FSDP's), its gradient a partial sum over the mesh dims x is sharded on.
* Attention keeps q's batch and head shards (``batch`` -> data,
  ``act_heads`` -> model); k and v take the same batch shards and shard
  their kv heads as q's heads are, which keeps each local query head on
  its kv head where the kv head count divides by those mesh dims.  Where
  it does not (an MQA cache on a 16-way model axis), q's heads are
  replicated first.  A sequence shard is gathered: the kernel takes all
  keys.
* WKV-6 keeps r's batch and head shards, and shards u and the state the
  same way.

A Partial placement (a sum still pending) is reduced before a call.
"""
from __future__ import annotations

import math
from typing import Callable, List, Sequence

import torch


def is_dtensor(t) -> bool:
    return type(t).__module__.startswith("torch.distributed.tensor")


def _placements(t, keep: Sequence[int]) -> List:
    """``t``'s placements with every Shard of a dim outside ``keep`` (and
    every Partial) replaced by Replicate."""
    from torch.distributed.tensor import Replicate, Shard
    return [p if isinstance(p, Shard) and p.dim in keep else Replicate()
            for p in t.placements]


def to_placements(t, placements):
    """``t`` (a DTensor) redistributed to ``placements`` (unchanged when it
    has them)."""
    if list(t.placements) == list(placements):
        return t
    return t.redistribute(t.device_mesh, list(placements))


def shard_count(t, dim: int) -> int:
    """Into how many shards a DTensor's ``dim`` is cut."""
    from torch.distributed.tensor import Shard
    return math.prod(t.device_mesh.size(i)
                     for i, p in enumerate(t.placements) if p == Shard(dim))


def keep_shards(t, dims: Sequence[int]):
    """A DTensor ``t`` with only its shards of ``dims`` kept: every other
    shard gathered, every pending sum reduced."""
    return to_placements(t, _placements(t, dims))


def _shift_dims(placements, after: int, by: int):
    from torch.distributed.tensor import Shard
    return [Shard(p.dim + by) if isinstance(p, Shard) and p.dim > after
            else p for p in placements]


def merge_dims(t, dim: int):
    """``t`` with dims ``dim`` and ``dim + 1`` merged into one, reshaped
    on each rank's shard: a shard of ``dim`` stays a shard of the merged
    dim (whole rows of ``dim + 1``), a shard of ``dim + 1`` is gathered
    first.  Autograd takes the gradient back through the same local
    reshape, so it never needs DTensor to unflatten a shard."""
    t = keep_shards(t, [d for d in range(t.dim()) if d != dim + 1])
    loc = t.to_local()
    loc = loc.reshape(*loc.shape[:dim], -1, *loc.shape[dim + 2:])
    return wrap(loc, t.device_mesh, _shift_dims(t.placements, dim, -1))


def split_dim(t, dim: int, size: int):
    """``t`` with dim ``dim`` split into (``t.shape[dim] // size``,
    ``size``), on each rank's shard: a shard of ``dim`` that is not whole
    rows of ``size`` is gathered first."""
    if (t.shape[dim] // size) % shard_count(t, dim):
        t = keep_shards(t, [d for d in range(t.dim()) if d != dim])
    loc = t.to_local()
    loc = loc.reshape(*loc.shape[:dim], -1, size, *loc.shape[dim + 1:])
    return wrap(loc, t.device_mesh, _shift_dims(t.placements, dim, 1))


def _replicated_local(t, like):
    """``t`` whole on every rank, as a plain tensor.  Its gradient is a
    partial sum over the mesh dims ``like`` is sharded on (each rank's
    local call saw only its own shard of ``like``), replicated on the
    others."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Partial, Replicate, Shard
    full = to_placements(t, [Replicate()] * t.device_mesh.ndim)
    grads = [Partial() if isinstance(p, Shard) else Replicate()
             for p in like.placements]
    return full.to_local(grad_placements=grads)


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def wrap(local: torch.Tensor, mesh, placements):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, list(placements), run_check=False)


def placed_as(t, like):
    """``t`` (a DTensor, or a plain tensor whole on every rank) as a
    DTensor placed as the DTensor ``like``."""
    from torch.distributed.tensor import Replicate
    if not is_dtensor(t):
        mesh = like.device_mesh
        t = wrap(t, mesh, [Replicate()] * mesh.ndim)
    return to_placements(t, like.placements)


def rmsnorm(x, w, eps: float, local: Callable):
    """RMSNorm of a DTensor's rows: ``local(x_local, w_full, eps)``."""
    x = to_placements(x, _placements(x, range(x.dim() - 1)))
    y = local(x.to_local(), _replicated_local(w, x), eps)
    return wrap(y, x.device_mesh, x.placements)


def attention(q, k, v, q_pos, k_pos, local: Callable):
    """Attention of DTensors q (B, Q, H, dh) and k, v (B, K, KV, dh):
    ``local(q, k, v, q_pos, k_pos)`` on each rank's batch and heads."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    pq = _placements(q, (0, 2))
    if k.shape[2] % shard_count(q, 2):
        pq = [Replicate() if p == Shard(2) else p for p in pq]
    q = to_placements(q, pq)
    k, v = (to_placements(t, pq) if is_dtensor(t) else
            wrap(t, mesh, [Replicate()] * mesh.ndim).redistribute(
                mesh, pq) for t in (k, v))
    out = local(q.to_local(), k.to_local(), v.to_local(),
                _local(to_placements(q_pos, [Replicate()] * mesh.ndim)
                       if is_dtensor(q_pos) else q_pos),
                _local(to_placements(k_pos, [Replicate()] * mesh.ndim)
                       if is_dtensor(k_pos) else k_pos))
    return wrap(out, mesh, pq)


def wkv6(r, k, v, w, u, S, local: Callable):
    """The WKV-6 recurrence of DTensors r, k, v, w (B, T, H, dh) from the
    state S (B, H, dh, dh; a DTensor, or one full tensor on every rank):
    ``local(r, k, v, w, u, S)`` on each rank's batch and heads, u (H, dh)
    and S sharded as r's heads and batch.  Returns what ``local`` returns
    (out, or (out, S)), as DTensors."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = r.device_mesh
    pr = _placements(r, (0, 2))
    r, k, v, w = (to_placements(t, pr) for t in (r, k, v, w))
    pu = [Shard(0) if p == Shard(2) else Replicate() for p in pr]
    ps = [Shard(1) if p == Shard(2) else p for p in pr]
    if is_dtensor(u):
        from torch.distributed.tensor import Partial
        grads = [Partial() if p == Shard(0) else p for p in pr]
        u = to_placements(u, pu).to_local(grad_placements=[
            g if q == Replicate() else q for g, q in zip(grads, pu)])
    else:
        u = wrap(u, mesh, [Replicate()] * mesh.ndim).redistribute(
            mesh, pu).to_local()
    S = to_placements(S, ps) if is_dtensor(S) else wrap(
        S, mesh, [Replicate()] * mesh.ndim).redistribute(mesh, ps)
    out = local(r.to_local(), k.to_local(), v.to_local(), w.to_local(), u,
                S.to_local())
    if isinstance(out, tuple):
        return wrap(out[0], mesh, pr), wrap(out[1], mesh, ps)
    return wrap(out, mesh, pr)


def replicated(fn: Callable, *args):
    """``fn`` on the whole of each DTensor argument (redistributed to
    Replicate first), its result replicated: for a kernel whose indices
    are global (the seed rows)."""
    from torch.distributed.tensor import Replicate
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    rep = [Replicate()] * mesh.ndim
    out = fn(*(to_placements(a, rep).to_local() if is_dtensor(a) else a
               for a in args))
    return wrap(out, mesh, rep)
