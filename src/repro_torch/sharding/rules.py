"""Logical-axis sharding rules (MaxText-style) on DTensor: the twin of the
reference's ``repro/sharding/rules.py``.

Parameters carry *logical* axis names (``models/axes.py::param_axes``);
the rules map logical names to mesh axes.  :func:`spec_for` runs the
reference's algorithm and returns the same spec, a tuple per dim of None,
one mesh axis name or a tuple of names, trailing Nones trimmed: a mesh
axis that does not divide the dim is dropped (seamless' vocab 256206 on a
16-way model axis), and a mesh axis is used once per tensor.
:func:`placements_for` turns a spec into DTensor placements on a
``DeviceMesh``: ``Shard(dim)`` on each mesh dim the spec names for
``dim``, ``Replicate()`` on the others.  A dim over two mesh axes (the
``("pod", "data")`` batch, the decode rules' ``("data", "model")``) gets
two ``Shard(dim)`` placements; DTensor splits it over the mesh dims in
mesh order, which is jax's row-major order for a tuple listed in mesh
order, so rank r holds the slice ``NamedSharding`` gives device r
(``tests/test_torch_sharding.py`` holds them equal).

Parallelism encoding, as in the reference:
  * FSDP/ZeRO-3: 'embed' -> 'data';
  * TP: 'vocab'/'heads'/'mlp' -> 'model';
  * EP: 'expert' -> 'model' (deepseek) or None + TP inside experts
    (mixtral);
  * DP: activation 'batch' -> ('pod', 'data');
  * SP: activation 'seq' -> 'data' for the long-context cells;
    sequence parallelism ('seq' -> 'model', ``rules_for(sp=True)``, the
    training cells): the residual stream lives sequence-sharded over
    'model' between blocks.  DTensor cannot hand a product an activation
    cut over (pod, data) on batch and over model on sequence without
    planning strided shards, so the port's blocks put SP's two
    collectives in explicitly, where the reference's partitioner puts
    them: :func:`gather_seq` after a block's norm, before its first
    product, and :func:`scatter_seq` at the residual add.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

Rules = Dict[str, Union[None, str, Tuple[str, ...]]]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# -- parameter rules --------------------------------------------------------
PARAM_RULES: Rules = {
    "vocab": "model",
    "embed": "data",          # FSDP / ZeRO-3
    "heads": "model",
    "kv_heads": None,         # kv head counts (1..16) rarely divide 16
    "head_dim": None,
    "mlp": "model",
    "mlp2": None,
    "expert": "model",        # EP (overridden to None for 'tp' MoE sharding)
    "expert_r": None,
    "kv_lora": None,
    "lora": None,
    "conv": None,
    "heads_x_dim": "model",   # rwkv fused (d, d) projections
    "layers": None,           # scan dim
}

# -- activation rules --------------------------------------------------------
ACT_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,
    "act_embed": None,
    "act_heads": "model",
    "act_kv": "model",        # KV-cache head dim (decode memory fit)
    "act_mlp": "model",
    "expert": "model",
    "capacity": "data",
    "vocab_out": "model",
}

# Decode (weight-stationary) parameter rules: weights fully sharded over
# data x model and kept sharded, so a decode step never all-gathers them.
DECODE_PARAM_RULES: Rules = {
    "vocab": ("data", "model"),
    "embed": None,
    "heads": "model",
    "kv_heads": None,
    "head_dim": "data",
    "mlp": ("data", "model"),
    "mlp2": None,
    "expert": "model",
    "expert_r": None,
    "kv_lora": "data",
    "lora": None,
    "conv": None,
    "heads_x_dim": ("data", "model"),
    "layers": None,
}


def rules_for(cfg, *, param: bool = True, seq_sharded: bool = False,
              sp: bool = False, decode: bool = False) -> Rules:
    """The reference's ``rules_for``.  ``seq_sharded``: long-context cells
    shard seq over 'data' (batch=1).  ``sp``: sequence parallelism,
    residual-stream activations seq-sharded over the *model* axis."""
    if param and decode:
        rules = dict(DECODE_PARAM_RULES)
    else:
        rules = dict(PARAM_RULES if param else ACT_RULES)
    if param and getattr(cfg, "moe", None) is not None:
        if cfg.moe.sharding == "tp":
            rules["expert"] = None
    if not param and seq_sharded:
        rules["seq"] = "data"
        rules["batch"] = None
    elif not param and sp:
        rules["seq"] = "model"
    return rules


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of any object with the
    reference's ``axis_names`` and ``devices``)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             rules: Rules, mesh) -> Spec:
    """The reference's spec: drop mesh axes that don't divide the dim."""
    mesh_sizes = mesh_axes(mesh)
    parts = []
    used: set = set()
    for dim, name in zip(shape, axes):
        target = rules.get(name) if name else None
        if target is None:
            parts.append(None)
            continue
        cand = (target,) if isinstance(target, str) else tuple(target)
        cand = tuple(a for a in cand if a in mesh_sizes and a not in used)
        size = math.prod(mesh_sizes[a] for a in cand)
        while cand and dim % size != 0:
            cand = cand[:-1]
            size = math.prod(mesh_sizes[a] for a in cand)
        if not cand:
            parts.append(None)
        else:
            used.update(cand)
            parts.append(cand if len(cand) > 1 else cand[0])
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements_for(spec: Spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on every
    mesh dim the spec names for ``dim``, ``Replicate()`` elsewhere.  A dim
    over several mesh axes must list them in mesh order (DTensor splits a
    dim over its mesh dims in that order, as jax splits it over the
    tuple's axes)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        group = (part,) if isinstance(part, str) else tuple(part)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {group} of dim {dim} are "
                             f"not in the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def sharding_for(shape, axes, rules: Rules, mesh) -> Tuple[Any, Tuple]:
    """``(mesh, placements)`` of one tensor, the twin of the reference's
    ``NamedSharding``."""
    return mesh, placements_for(spec_for(shape, axes, rules, mesh), mesh)


def tree_shardings(shapes: Dict[str, Any], axes: Dict[str, Any],
                   rules: Rules, mesh) -> Dict[str, Tuple[Any, Tuple]]:
    """``{name: (mesh, placements)}`` for matching dicts of tensors (or
    anything with ``.shape``) and tuples of logical names (None:
    replicated)."""
    return {name: (mesh, placements_for((), mesh)) if axes[name] is None
            else sharding_for(leaf.shape, axes[name], rules, mesh)
            for name, leaf in shapes.items()}


def distribute(t: torch.Tensor, sharding: Tuple[Any, Tuple]):
    """``t`` (the same full tensor on every rank) as a DTensor under
    ``sharding``, each rank keeping its own shard (no communication)."""
    from torch.distributed.tensor import distribute_tensor
    mesh, placements = sharding
    return distribute_tensor(t, mesh, list(placements), src_data_rank=None)


def distribute_tree(tree: Dict[str, torch.Tensor],
                    shardings: Dict[str, Tuple[Any, Tuple]]
                    ) -> Dict[str, Any]:
    """:func:`distribute` of each tensor of a dict under its sharding."""
    return {k: distribute(t, shardings[k]) for k, t in tree.items()}


# -- activation-constraint context ------------------------------------------
class _Ctx(threading.local):
    mesh = None
    rules: Optional[Rules] = None


_CTX = _Ctx()


@contextlib.contextmanager
def activation_sharding(mesh, rules: Rules):
    """While active, :func:`constrain` redistributes activations, and a
    plain tensor meeting a DTensor in an op (positions, masks, a fresh
    state) counts as replicated on the mesh (DTensor's
    ``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        with implicit_replication():
            yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def sequence_parallel() -> bool:
    """Inside :func:`activation_sharding` under SP rules (the residual
    stream's ``seq`` on ``model``: ``rules_for(..., sp=True)``)?"""
    return _CTX.mesh is not None and _CTX.rules is not None \
        and _CTX.rules.get("seq") == "model"


def gather_seq(x):
    """SP's gather: ``x`` (B, S, ...) with its sequence shards all-gathered
    and its other placements kept, so that the products after it take
    plain ``Shard``/``Replicate`` placements.  Its backward
    reduce-scatters the gradient back to the sequence shards.  Outside SP
    (or on a plain tensor) ``x`` itself."""
    if not sequence_parallel() or not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    placements = tuple(Replicate() if p == Shard(1) else p
                       for p in x.placements)
    if placements == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def weights_cheaper(x, *weights) -> bool:
    """Under SP, with ``x``'s sequence cut: would a product of ``x`` with
    ``weights`` move fewer bytes with the weights gathered whole and x
    kept on its shard than with x's sequence gathered (and the product's
    output reduce-scattered back)?  XLA's partitioner picks between the
    two by the same count; the sequence wins at production widths, the
    weights at a smoke model's."""
    from torch.distributed.tensor import Shard
    if not sequence_parallel() or not _is_dtensor(x) \
            or Shard(1) not in x.placements:
        return False
    cut = math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements)
                    if p == Shard(1))
    seq = 2 * x.to_local().numel() * (cut - 1) * x.element_size()
    whole = sum((w.numel() - w.to_local().numel()) * w.element_size()
                for w in weights)
    return whole < seq


def scatter_seq(h):
    """SP's scatter: a block's output ``h`` redistributed to the residual
    stream's sequence shards before the residual add (a pending sum
    reduce-scattered, a whole sequence sliced), so that the add and the
    norm after it run on each rank's shard.  Its backward all-gathers the
    gradient.  Outside SP ``h`` itself."""
    if not sequence_parallel():
        return h
    return constrain(h, ("batch", "seq", "act_embed"))


def _is_dtensor(t) -> bool:
    return type(t).__module__.startswith("torch.distributed.tensor")


def constrain(x, axes: Sequence[Optional[str]]):
    """The twin of ``with_sharding_constraint``: outside a context ``x``
    itself; inside, ``x`` redistributed to the context rules' placements
    (a plain tensor becomes a DTensor replicated on the mesh first)."""
    if _CTX.mesh is None or _CTX.rules is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    mesh = _CTX.mesh
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    placements = placements_for(spec_for(x.shape, axes, _CTX.rules, mesh),
                                mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)
