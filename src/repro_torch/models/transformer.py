"""Decoder-only LM, dense and ssm families: the twin of the reference's
``repro.models.transformer`` for ``family == "dense"`` (attention blocks)
and ``family == "ssm"`` (RWKV-6 blocks, :mod:`.rwkv`).

The reference stacks its layers (leading L dimension) and drives them with
``lax.scan``; here the blocks are an ``nn.ModuleList`` walked in Python.
The other families raise ``NotImplementedError`` naming the ROADMAP.md
queue that brings them.

Decode state is a list of per-layer states that :meth:`decode_step`
updates in place (the reference returns a new state instead): ring-buffer
KV caches (:func:`layers.init_attention_cache`) for the dense family, the
WKV state and the two token-shift carries for the ssm family.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig

from . import rwkv
from .layers import (attention, embed, init_attention_cache, logits_from,
                     mlp, rms_norm, rope_angles, rope_dim)


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "ssm") or cfg.moe is not None \
            or cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (moe={cfg.moe is not None}, "
            f"mla={cfg.mla is not None}) is not ported yet; only the dense "
            f"and ssm families are (ROADMAP.md queue 1, item 5)")


def _param(shape, dtype, device, generator: Optional[torch.Generator],
           scale: Optional[float] = None) -> nn.Parameter:
    """The reference's ``layers.dense_init``: a standard normal times
    ``scale``, by default 1/sqrt(shape[0]) for a matrix (so ``wo`` of shape
    (H, dh, d) scales by 1/sqrt(H)); drawn in float32, then cast."""
    if generator is None:
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                            requires_grad=False)
    fan_in = shape[0] if len(shape) > 1 else 1
    s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return nn.Parameter(w.mul_(s).to(dtype), requires_grad=False)


def _zeros(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class DenseBlock(nn.Module):
    """Pre-norm attention + gated MLP, residual around each."""

    def __init__(self, cfg: ModelConfig, dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        d, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        dh, ff = cfg.resolved_head_dim, cfg.d_ff
        self.cfg = cfg
        self.ln1 = _zeros((d,), dtype, device)
        self.ln2 = _zeros((d,), dtype, device)
        self.attn = nn.ParameterDict({
            "wq": _param((d, H, dh), dtype, device, generator),
            "wk": _param((d, KV, dh), dtype, device, generator),
            "wv": _param((d, KV, dh), dtype, device, generator),
            "wo": _param((H, dh, d), dtype, device, generator),
        })
        self.mlp = nn.ParameterDict({
            "wi": _param((d, ff), dtype, device, generator),
            "wg": _param((d, ff), dtype, device, generator),
            "wo": _param((ff, d), dtype, device, generator),
        })

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                angles: Tuple[torch.Tensor, torch.Tensor],
                cache: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        cfg = self.cfg
        h = attention(self.attn, cfg, rms_norm(x, self.ln1, cfg.norm_eps),
                      positions, angles, cache)
        x = x + h
        h = mlp(self.mlp, rms_norm(x, self.ln2, cfg.norm_eps), cfg.activation)
        return x + h


class RWKVBlock(nn.Module):
    """Pre-norm RWKV-6 time-mix + channel-mix, residual around each (the
    reference's ``_rwkv_block``).  Both mixes see the normed input, which
    is also what their token-shift carries store."""

    def __init__(self, cfg: ModelConfig, dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.ln1 = _zeros((d,), dtype, device)
        self.ln2 = _zeros((d,), dtype, device)
        # init_rwkv_block: the mixes, w0 and ln_x at zero, u at scale 1,
        # every matrix at 1/sqrt(fan_in).
        self.block = nn.ParameterDict({
            name: _zeros(shape, dtype, device) if name in rwkv.ZERO_INIT
            else _param(shape, dtype, device, generator)
            for name, shape in rwkv.param_shapes(cfg).items()})

    def forward(self, x: torch.Tensor,
                state: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """x (B, T, d); ``state`` (decode) is updated in place."""
        cfg = self.cfg
        h, tm = rwkv.rwkv_time_mix(self.block, cfg,
                                   rms_norm(x, self.ln1, cfg.norm_eps), state)
        x = x + h
        h, cm = rwkv.rwkv_channel_mix(self.block, cfg,
                                      rms_norm(x, self.ln2, cfg.norm_eps),
                                      state)
        if state is not None:
            state.update(tm, **cm)
        return x + h


class Transformer(nn.Module):
    """The decoder-only LM of the dense or ssm family.  With ``seed`` None
    the weights are left uninitialised (for loading a state dict);
    otherwise they are drawn from a ``torch.Generator`` on ``device``
    seeded with it."""

    def __init__(self, cfg: ModelConfig, device: Union[str, torch.device],
                 seed: Optional[int] = 0):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        dtype = cfg.parameter_dtype()
        gen = None
        if seed is not None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        self.embed = _param((cfg.vocab, cfg.d_model), dtype, self.device, gen,
                            scale=1.0)
        self.recurrent = cfg.family == "ssm"
        block = RWKVBlock if self.recurrent else DenseBlock
        self.blocks = nn.ModuleList(
            block(cfg, dtype, self.device, gen) for _ in range(cfg.n_layers))
        self.final_norm = _zeros((cfg.d_model,), dtype, self.device)
        self.register_parameter(
            "head", None if cfg.tie_embeddings else
            _param((cfg.d_model, cfg.vocab), dtype, self.device, gen))

    def _angles(self, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The rope angles of ``positions``, once for every layer."""
        cfg = self.cfg
        return rope_angles(positions, rope_dim(cfg, cfg.resolved_head_dim),
                           cfg.rope_theta)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return logits_from(self.embed, self.head, self.cfg, x)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens (B, S) -> (logits (B, S, V) float32, info)."""
        x = embed(self.embed, self.cfg, tokens)
        if self.recurrent:  # every layer from a zero state
            for block in self.blocks:
                x = block(x)
        else:
            positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                     device=x.device)
            angles = self._angles(positions)
            for block in self.blocks:
                x = block(x, positions, angles)
        info = {"aux": torch.zeros((), dtype=torch.float32, device=x.device)}
        return self._head(x), info

    def init_decode_state(self, batch: int,
                          max_len: int) -> Dict[str, List[Dict[str, Any]]]:
        return init_decode_state(self.cfg, batch, max_len, self.device)

    @torch.no_grad()
    def decode_step(self, state: Dict[str, List[Dict[str, Any]]],
                    tokens: torch.Tensor, pos: Union[int, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, List[Dict[str, Any]]]]:
        """tokens (B, S); ``pos`` the position of a single token (an int or
        a 0-d tensor) or the (S,) positions of a chunk (unused by the ssm
        family, as in the reference).  Returns (logits (B, S, V) float32,
        state), the state updated in place."""
        x = embed(self.embed, self.cfg, tokens)
        if self.recurrent:
            for block, st in zip(self.blocks, state["layers"]):
                x = block(x, st)
            return self._head(x), state
        if isinstance(pos, torch.Tensor):
            positions = pos.to(device=x.device, dtype=torch.int32)
            if positions.dim() == 0:
                positions = positions[None]
        else:  # filled on the device: no copy from the host
            positions = torch.full((1,), int(pos), dtype=torch.int32,
                                   device=x.device)
        angles = self._angles(positions)
        for block, cache in zip(self.blocks, state["layers"]):
            x = block(x, positions, angles, cache)
        return self._head(x), state


def init(cfg: ModelConfig, seed: int,
         device: Union[str, torch.device]) -> Transformer:
    return Transformer(cfg, device, seed)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device: Union[str, torch.device]
                      ) -> Dict[str, List[Dict[str, Any]]]:
    check_family(cfg)
    dtype, device = cfg.activation_dtype(), torch.device(device)
    if cfg.family == "ssm":
        H, dh = rwkv.heads(cfg)
        return {"layers": [{
            "S": torch.zeros((batch, H, dh, dh), dtype=torch.float32,
                             device=device),
            "last_tm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                   device=device),
            "last_cm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                   device=device),
        } for _ in range(cfg.n_layers)]}
    return {"layers": [init_attention_cache(cfg, batch, max_len, dtype,
                                            device)
                       for _ in range(cfg.n_layers)]}
