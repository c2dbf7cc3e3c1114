"""Model registry: the twin of the reference's ``repro.models``, family ->
module (:mod:`.encdec` for the encdec family, :mod:`.transformer` for the
others)."""
from __future__ import annotations

import dataclasses
from types import ModuleType
from typing import Callable, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

from . import encdec, transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    """The reference's ``ModelApi`` on modules: ``init(seed)`` returns a
    :class:`transformer.Transformer` (or :class:`encdec.EncDec`) with
    seeded weights on the device; ``forward``/``decode_step`` take that
    module first where the reference takes its parameter tree,
    ``init_decode_state(batch, max_len, **kw)`` passes its keywords on
    (encdec: ``model``, ``enc_out``, ``enc_len``), and ``loss_fn(model,
    params, batch)`` takes the module beside a dict of parameter tensors
    to differentiate (None: the module's own)."""

    device: torch.device
    init: Callable
    forward: Callable
    init_decode_state: Callable
    decode_step: Callable
    loss_fn: Callable


def family_module(cfg: ModelConfig) -> ModuleType:
    """The module that builds ``cfg``'s family; raises ``ValueError`` for a
    family the reference does not know."""
    transformer.check_family(cfg)
    return encdec if cfg.family == "encdec" else transformer


def build(cfg: ModelConfig,
          device: Union[None, str, torch.device] = None) -> ModelApi:
    """The model API on ``device``: None means the card, and raises
    without one; pass ``"cpu"`` for the plain versions of the kernels."""
    mod = family_module(cfg)
    device = resolve_device(device)
    return ModelApi(
        device=device,
        init=lambda seed: mod.init(cfg, seed, device),
        forward=lambda model, tokens, **kw: model(tokens, **kw),
        init_decode_state=lambda batch, max_len, **kw: mod.init_decode_state(
            cfg, batch, max_len, device, **kw),
        decode_step=lambda model, state, tokens, pos: model.decode_step(
            state, tokens, pos),
        loss_fn=lambda model, params, batch: mod.loss_fn(
            model, params, batch),
    )


__all__ = ["ModelApi", "build", "encdec", "family_module", "transformer"]
