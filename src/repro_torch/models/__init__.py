"""Model registry: the twin of the reference's ``repro.models`` for the
dense and ssm families (the others wait for ROADMAP.md queue 1, item 5)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

from . import transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    """The reference's ``ModelApi`` on modules: ``init(seed)`` returns a
    :class:`transformer.Transformer` with seeded weights on the device;
    ``forward``/``decode_step`` take that module first where the
    reference takes its parameter tree."""

    device: torch.device
    init: Callable
    forward: Callable
    init_decode_state: Callable
    decode_step: Callable


def build(cfg: ModelConfig,
          device: Union[None, str, torch.device] = None) -> ModelApi:
    """The model API on ``device``: None means the card, and raises
    without one; pass ``"cpu"`` for the plain versions of the kernels."""
    transformer.check_family(cfg)
    device = resolve_device(device)
    return ModelApi(
        device=device,
        init=lambda seed: transformer.init(cfg, seed, device),
        forward=lambda model, tokens: model(tokens),
        init_decode_state=lambda batch, max_len: transformer.init_decode_state(
            cfg, batch, max_len, device),
        decode_step=lambda model, state, tokens, pos: model.decode_step(
            state, tokens, pos),
    )


__all__ = ["ModelApi", "build", "transformer"]
