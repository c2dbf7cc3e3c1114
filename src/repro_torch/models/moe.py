"""Routed mixture-of-experts with capacity-bounded sort-based dispatch: the
twin of the reference's ``repro.models.moe``.

* top-k routing over softmax probabilities, the k gates renormalised to
  sum 1, optional shared experts;
* dispatch by a stable sort of the (token, choice) pairs by expert id into
  an (E, C, D) buffer per group of rows, the experts as batched matrix
  products over that buffer, and the combine back to the tokens;
* per-expert token counts (before the capacity drop), the per-"process"
  load vectors of the paper's ST load-imbalance scenario;
* the Switch-style auxiliary load-balancing loss.

Every shape here follows from (B, S, k, E) and the capacity alone, and no
step reads a value back to the host: counts come from ``scatter_add``
into zeros, never ``bincount`` or a boolean mask.  The dispatch's
``scatter_add`` has one non-zero contribution per kept slot (a dropped
pair adds 0 to slot 0 of its expert), so it is exact in any order; the
combine sums each token's k contributions in a fixed order (un-permuted
by the inverse of the sort, then summed over k), so a served token does
not depend on the order of atomics.  Top-k takes the first k of a stable
descending sort, so ties go to the lower expert id as ``lax.top_k``'s do.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import local
from repro_torch.sharding import constrain, gather_seq

from .layers import _act

# The logical axes of the expert buffers (Bg, E, C, D), as the reference
# constrains them.
BUF_AXES = ("batch", "expert", "capacity", "act_embed")


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """The reference's ``init_moe`` layouts: router (d, E); wi, wg
    (E, d, ff); wo (E, ff, d); the shared experts concatenated to
    ff·n_shared."""
    mo = cfg.moe
    d, ff, E = cfg.d_model, mo.d_ff, mo.n_experts
    shapes = {"router": (d, E), "wi": (E, d, ff), "wg": (E, d, ff),
              "wo": (E, ff, d)}
    if mo.n_shared:
        fs = ff * mo.n_shared
        shapes.update(shared_wi=(d, fs), shared_wg=(d, fs),
                      shared_wo=(fs, d))
    return shapes


class MoE(nn.Module):
    """The parameters of one layer's MoE, keyed as the reference's tree
    (``moe.router``, ``moe.wi``, ...); calling it runs :func:`moe_block`.
    ``p["wi"]`` reads a parameter, as on the reference's dict."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, nn.Parameter]):
        super().__init__()
        self.cfg = cfg
        for name, p in params.items():
            self.register_parameter(name, p)

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return moe_block(self, self.cfg, x)


def route(p, cfg: ModelConfig, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (..., d) -> (probs (..., E) float32, renormalised gates (..., k),
    expert ids (..., k) int64): the router's softmax and its top k.  On a
    DTensor x the gates and ids are those of this rank's rows of x."""
    probs = torch.softmax((x @ p["router"]).float(), dim=-1)
    return (probs, *_top_k(_rows_local(probs, x), cfg.moe.top_k))


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(renormalised gates, ids) of the k largest of each row."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = vals[..., :k], ids[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, ids


def capacity_of(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for a group of ``tokens`` tokens, at least 1."""
    mo = cfg.moe
    return max(int(math.ceil(tokens * mo.top_k / mo.n_experts
                             * mo.capacity_factor)), 1)


def groups(B: int, S: int) -> int:
    """Rows grouped before dispatch: ``gcd(B, 8)`` of them for short (decode)
    rows, so a decode token does not pay a capacity of 1 per expert per
    row alone; 1 from S = 64 up."""
    return math.gcd(B, 8) if S < 64 else 1


def _dispatch(x: torch.Tensor, gates: torch.Tensor, ids: torch.Tensor,
              E: int, capacity: int):
    """Dispatch each group's Sg tokens.  x (Bg, Sg, D); gates, ids (Bg, Sg,
    k).  Returns (buf (Bg, E, C, D), slot, gate, keep: each (Bg, Sg·k) in
    (token, choice) order, counts (Bg, E) int32)."""
    Bg, Sg, D = x.shape
    k = ids.shape[-1]
    n = Sg * k
    flat_e = ids.reshape(Bg, n)
    flat_t = torch.arange(Sg, device=x.device).repeat_interleave(k)
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    se = torch.gather(flat_e, 1, order)
    counts = torch.zeros((Bg, E), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts
    pos_sorted = (torch.arange(n, device=x.device)
                  - torch.gather(starts, 1, se))
    # back to (token, choice) order through the inverse of the sort
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=x.device).expand(Bg, n))
    pos = torch.gather(pos_sorted, 1, inv)
    keep = pos < capacity
    slot = flat_e * capacity + torch.where(keep, pos, 0)
    contrib = torch.where(keep[..., None], x[:, flat_t], 0.0).to(x.dtype)
    buf = torch.zeros((Bg, E * capacity, D), dtype=x.dtype,
                      device=x.device).scatter_add(
        1, slot[..., None].expand(Bg, n, D), contrib)
    return (buf.view(Bg, E, capacity, D), slot, gates.reshape(Bg, n), keep,
            counts.to(torch.int32))


def _whole_groups(x: torch.Tensor, G: int) -> torch.Tensor:
    """x itself; on a DTensor, x with only its batch shards kept, gathered
    whole when a rank's rows would split a group of ``G`` rows."""
    if not local.is_dtensor(x):
        return x
    x = local.keep_shards(x, (0,))
    if (x.shape[0] // local.shard_count(x, 0)) % G:
        x = local.keep_shards(x, ())
    return x


def _rows_local(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """t itself; on a DTensor ``like``, this rank's shard of t placed as
    ``like``.  Routing, dispatch and combine index tokens within a group
    of rows, so they run on these local rows."""
    if not local.is_dtensor(like):
        return t
    return local.to_placements(t, like.placements).to_local()


def _rows_wrap(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_rows_local`: local rows back to a DTensor
    placed as ``like``."""
    if not local.is_dtensor(like):
        return t
    return local.wrap(t, like.device_mesh, like.placements)


def _experts(p, cfg: ModelConfig, buf: torch.Tensor) -> torch.Tensor:
    """The experts' gated MLP on buf (Bg, E, C, D), batched over groups and
    experts.  On a DTensor buf whose experts are cut over ``model`` each
    rank runs its own experts on its own buffers with their weights whole
    (the EP layout: expert-sharded weights only gathered off the expert
    dim).  For TP experts (the expert dim of the weights whole, their
    width cut) it does so only where the weights gathered whole move
    fewer bytes than the buffers gathered over the experts; otherwise,
    and wherever the buffers' experts are not cut, the buffers are
    gathered once and the products keep the width's shards (a pending sum
    then, reduced by the caller's constraint)."""
    ws = (p["wg"], p["wi"], p["wo"])

    def experts(b, wg, wi, wo):
        return (_act(b @ wg, cfg.activation) * (b @ wi)) @ wo

    if not local.is_dtensor(buf):
        return experts(buf, *ws)
    from torch.distributed.tensor import Partial, Replicate, Shard
    E, n = buf.shape[1], local.shard_count(buf, 1)
    ep = n > 1 and all((q == Shard(1)) == (w == Shard(0))
                       for q, w in zip(buf.placements, ws[0].placements))
    whole = sum(w.numel() for w in ws) * buf.element_size()
    gathered = buf.to_local().numel() * n * buf.element_size()
    if not ep and (n == 1 or whole > gathered):
        return experts(local.keep_shards(buf, (0, 2, 3)), *ws)
    first = local.shard_index(buf, 1) * (E // n)

    def mine(w):
        if ep:  # the expert shards kept, every other gathered
            w = local.keep_shards(w, (0,))
            return w.to_local(grad_placements=[
                g if g == Shard(0) else Partial() if isinstance(q, Shard)
                else Replicate() for g, q in zip(w.placements,
                                                 buf.placements)])
        return local.replicated_local(w, buf)[first:first + E // n]

    return local.wrap(experts(buf.to_local(), *(mine(w) for w in ws)),
                      buf.device_mesh, buf.placements)


def _global_counts(counts: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """counts itself; on a DTensor ``like``, this rank's counts summed over
    the ranks that hold other rows and replicated."""
    if not local.is_dtensor(like):
        return counts
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = like.device_mesh
    summed = local.wrap(counts, mesh, [
        Partial() if isinstance(q, Shard) else Replicate()
        for q in like.placements])
    return summed.redistribute(mesh, [Replicate()] * mesh.ndim)


def moe_block(p, cfg: ModelConfig, x: torch.Tensor,
              capacity: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux loss (float32 scalar), expert
    counts (E,) int32 summed over groups): the reference's ``moe_block``.
    On a DTensor x the router, the experts and the shared experts are
    DTensor products, the expert buffers constrained to ``BUF_AXES`` as in
    the reference; routing, dispatch and combine run on each rank's rows
    (the rows of a group stay on one rank, else the batch is gathered
    first; under sequence parallelism the sequence is gathered before
    all); the aux loss and the counts are over the global batch."""
    mo = cfg.moe
    x = gather_seq(x)
    B, S, D = x.shape
    E, k = mo.n_experts, mo.top_k
    G = groups(B, S)
    x = _whole_groups(x, G)
    probs, gates, ids = route(p, cfg, x)

    # Switch aux loss: E · Σ_e (mean router prob) · (fraction of top-1)
    me = probs.mean(dim=(0, 1))
    top1 = torch.argmax(probs, dim=-1)
    ce = (top1[..., None] == torch.arange(E, device=x.device)
          ).float().mean(dim=(0, 1))
    aux = mo.aux_loss_weight * E * torch.sum(me * ce)

    Bl = gates.shape[0]
    Bg, Sg = Bl // G, G * S
    capacity = capacity_of(cfg, Sg) if capacity is None \
        else max(int(capacity), 1)
    buf, slot, gate, keep, counts = _dispatch(
        _rows_local(x, x).reshape(Bg, Sg, D), gates.reshape(Bg, Sg, k),
        ids.reshape(Bg, Sg, k), E, capacity)

    # the experts, batched over groups and experts
    buf = constrain(_rows_wrap(buf, x), BUF_AXES)
    y_buf = _rows_local(constrain(_experts(p, cfg, buf), BUF_AXES), x
                        ).view(Bg, E * capacity, D)

    # combine: gates cast to the activation dtype before they multiply;
    # each token's k contributions summed in choice order
    g = (gate * keep).to(y_buf.dtype)
    gathered = torch.gather(
        y_buf, 1, slot[..., None].expand(Bg, Sg * k, D)) * g[..., None]
    out = _rows_wrap(gathered.view(Bg, Sg, k, D).sum(dim=2).view(Bl, S, D),
                     x)
    if mo.n_shared:
        h = _act(x @ p["shared_wg"], cfg.activation) * (x @ p["shared_wi"])
        out = out + h @ p["shared_wo"]
    return out, aux, _global_counts(counts.sum(dim=0, dtype=torch.int32), x)
