"""AdamW with decoupled weight decay, global-norm clipping and float32
moments.

The PyTorch port of the reference's ``repro/optim/adamw.py``: pure
functions on dicts of tensors that return new tensors and update nothing
in place (a traced training step calls the optimizer leaf more than once
on the same state and keeps only the last output), in the reference's
order of operations.  ``torch.optim`` is not used for that reason.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    schedule: str = "cosine"       # cosine | linear | constant
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step: Union[int, torch.Tensor]) -> torch.Tensor:
    """The learning rate at ``step``, a float32 0-d tensor (on ``step``'s
    device when it is a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * (1.0 - frac)
    else:
        decay = torch.ones_like(step)
    return cfg.lr * warm * decay


def init_opt_state(params: Tree) -> Dict[str, object]:
    """Zero float32 moments shaped like ``params`` and an int32 step."""
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    device = next(iter(params.values())).device
    return {"m": zeros, "v": {k: torch.zeros_like(z)
                              for k, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor scalar with its pending sums reduced (replicated on the
    mesh); a plain tensor itself."""
    if type(t).__module__.startswith("torch.distributed.tensor"):
        from torch.distributed.tensor import Replicate
        mesh = t.device_mesh
        return t.redistribute(mesh, [Replicate()] * mesh.ndim)
    return t


def global_norm(tree: Tree) -> torch.Tensor:
    """The norm of every leaf together.  On DTensors each leaf's sum of
    squares is reduced over the mesh on its own, as the reference's
    partitioned module all-reduces one partial sum a leaf."""
    sq = sum(_whole(torch.sum(torch.square(x.float())))
             for x in tree.values())
    return torch.sqrt(sq)


def apply_updates(cfg: AdamWConfig, params: Tree, grads: Tree,
                  state: Dict[str, object]
                  ) -> Tuple[Tree, Dict[str, object], Dict[str, torch.Tensor]]:
    """One AdamW step: ``(new_params, new_state, {"grad_norm", "lr"})``.
    Clipping scales the gradients before the moments, in float32 (the
    reference's ``g * scale`` promotes a bf16 gradient to float32); the
    grad norm reported is the one before clipping."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        gf = grads[k].float()
        if scale is not None:
            gf = gf * scale
        m = b1 * state["m"][k] + (1 - b1) * gf
        v = b2 * state["v"][k] + (1 - b2) * gf * gf
        mh = m / bc1
        vh = v / bc2
        pf = p.float()
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
        new_p[k] = (pf - lr * delta).to(p.dtype)
        new_m[k], new_v[k] = m, v
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics
