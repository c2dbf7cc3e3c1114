"""Abstract input specs for the dry-run: the twin of the reference's
``repro/launch/specs.py``.

The reference's ``ShapeDtypeStruct`` stand-ins are ``meta`` tensors here:
the model is built on the ``meta`` device (:func:`abstract_model_state`),
so nothing is allocated, and AdamW's moments come from the same build.
Shardings are ``(mesh, placements)`` pairs (``sharding.sharding_for``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch.utils._pytree import tree_map

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import family_module
from repro_torch.models.convert import param_axes
from repro_torch.optim import init_opt_state
from repro_torch.sharding import (ACT_RULES, rules_for, sharding_for,
                                  tree_shardings)

META = torch.device("meta")


def abstract_model_state(cfg: ModelConfig
                         ) -> Tuple[Dict[str, torch.Tensor],
                                    Dict[str, Tuple[str, ...]],
                                    Dict[str, Any], Dict[str, Any]]:
    """(param_shapes, param_axes, opt_shapes, opt_axes) on ``meta``."""
    model = family_module(cfg).init(cfg, None, META)
    params = {k: p.detach() for k, p in model.named_parameters()}
    axes = param_axes(cfg)
    return params, axes, init_opt_state(params), \
        {"m": axes, "v": axes, "step": None}


def param_count(param_shapes: Dict[str, torch.Tensor]) -> int:
    return sum(math.prod(t.shape) for t in param_shapes.values())


def non_embed_param_count(param_shapes: Dict[str, torch.Tensor]) -> int:
    emb = math.prod(param_shapes["embed"].shape)
    if param_shapes.get("head") is not None:
        emb += math.prod(param_shapes["head"].shape)
    return param_count(param_shapes) - emb


def train_batch_specs(cfg: ModelConfig, shape: InputShape
                      ) -> Dict[str, torch.Tensor]:
    """tokens and labels (B, S) int64 (the port's index type; the
    reference's are int32), and a vlm's or encdec's frontend ``embeds``
    (B, P, d) in the activation dtype (a vlm's text cut to S - P)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "vlm" and cfg.frontend:
        S = max(S - cfg.frontend_tokens, 2)
    specs = {k: torch.empty((B, S), dtype=torch.int64, device=META)
             for k in ("tokens", "labels")}
    if cfg.family in ("vlm", "encdec", "audio") and cfg.frontend:
        specs["embeds"] = torch.empty(
            (B, cfg.frontend_tokens, cfg.d_model),
            dtype=cfg.activation_dtype(), device=META)
    return specs


def decode_state_specs(cfg: ModelConfig, shape: InputShape) -> Any:
    """The decode state of ``shape.global_batch`` sequences of up to
    ``shape.seq_len`` tokens, on ``meta``."""
    kw = {}
    if cfg.family == "encdec":
        kw["enc_len"] = cfg.frontend_tokens
    return family_module(cfg).init_decode_state(
        cfg, shape.global_batch, shape.seq_len, META, **kw)


def decode_input_specs(cfg: ModelConfig, shape: InputShape
                       ) -> Dict[str, torch.Tensor]:
    return {"tokens": torch.empty((shape.global_batch, 1),
                                  dtype=torch.int64, device=META),
            "pos": torch.empty((), dtype=torch.int32, device=META)}


# -- shardings ---------------------------------------------------------------
def batch_shardings(specs: Dict[str, torch.Tensor], mesh
                    ) -> Dict[str, Tuple[Any, Tuple]]:
    """Each input's dim 0 over the activation rules' ``batch``."""
    return {k: sharding_for(s.shape, ("batch",) + (None,) * (s.dim() - 1)
                            if s.dim() else (), ACT_RULES, mesh)
            for k, s in specs.items()}


def state_shardings(state_specs: Any, mesh, global_batch: int,
                    n_kv_heads: int = 0) -> Any:
    """Decode caches, as the reference shards them: the batch dim — the
    first dim of size ``global_batch`` (the reference searches after its
    stacked layer dim; the port keeps a list of per-layer states, so it
    searches from dim 0) — over (pod, data), and the kv-head dim (size
    ``n_kv_heads``, two dims after the batch, past the seq dim) over model
    where it divides; the rest replicated, a cache's 0-d ``idx``
    included.  Non-tensor leaves stay as they are."""
    def one(s):
        if not isinstance(s, torch.Tensor):
            return s
        axes = [None] * s.dim()
        b_at = None
        if global_batch > 1:
            for i in range(s.dim()):
                if s.shape[i] == global_batch:
                    axes[i] = "batch"
                    b_at = i
                    break
        if n_kv_heads > 1 and b_at is not None:
            for i in range(b_at + 2, s.dim()):
                if s.shape[i] == n_kv_heads:
                    axes[i] = "act_kv"
                    break
        return sharding_for(s.shape, tuple(axes), ACT_RULES, mesh)

    return tree_map(one, state_specs)


def model_shardings(cfg: ModelConfig, param_shapes, param_axes_, opt_shapes,
                    opt_axes, mesh, decode: bool = False):
    """(param shardings, AdamW-state shardings): each parameter and its
    moments by ``rules_for(cfg, decode=decode)``, the step replicated."""
    rules = rules_for(cfg, param=True, decode=decode)
    p_sh = tree_shardings(param_shapes, param_axes_, rules, mesh)
    o_sh = {"m": tree_shardings(opt_shapes["m"], opt_axes["m"], rules, mesh),
            "v": tree_shardings(opt_shapes["v"], opt_axes["v"], rules, mesh),
            "step": sharding_for((), (), rules, mesh)}
    return p_sh, o_sh
