"""Encoder-decoder backbone (seamless-m4t-medium): the twin of the
reference's ``repro.models.encdec``.

The speech frontend is a stub: the encoder takes precomputed frame
embeddings (B, T_enc, d) and runs non-causal self-attention blocks with
no window (the reference's ``_enc_cfg``).  A decoder block is causal
self-attention, cross-attention over the encoder's output (q and k not
roped, non-causal, no window: ``layers.attention``'s ``kv_override``)
and the MLP.  Decode keeps a self-attention KV cache a layer and the
cross K/V, computed once from the encoder's output; the teacher-forced
forward projects them inside each decoder layer, as the reference's
``_decoder_block`` does.  Every encoder and decoder layer runs through
``transformer.remat`` (the reference's ``_maybe_remat``).

Parameters are keyed as the reference's tree: ``enc_layers.{i}`` (``ln1``,
``ln2``, ``attn``, ``mlp``), ``dec_layers.{i}`` (``ln1``–``ln3``,
``self_attn``, ``cross_attn``, ``mlp``), ``enc_norm``, ``final_norm``,
the embedding and an untied ``head``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig

from .layers import (_project, attention, cross_entropy, embed,
                     init_attention_cache, logits_from, mlp, rms_norm,
                     rope_angles, rope_dim)
from .transformer import (_param, _params, _zeros, attention_shapes,
                          chunked_ce_from_hidden, decode_positions,
                          functional_call, mlp_shapes, remat)

Params = Dict[str, torch.Tensor]


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    return cfg.with_(causal=False, window=None)


def cross_positions(kv: torch.Tensor) -> torch.Tensor:
    """The cross keys' positions, 0..T_enc - 1 (unused by the mask of a
    non-causal call without a window)."""
    return torch.arange(kv.shape[1], dtype=torch.int32, device=kv.device)


class EncoderLayer(nn.Module):
    """Pre-norm non-causal self-attention + gated MLP."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        self.cfg, self.ecfg = cfg, _enc_cfg(cfg)
        self.ln1 = _zeros((cfg.d_model,), dtype, device)
        self.ln2 = _zeros((cfg.d_model,), dtype, device)
        self.attn = _params(attention_shapes(cfg), dtype, device, generator)
        self.mlp = _params(mlp_shapes(cfg), dtype, device, generator)

    def forward(self, x, positions, angles) -> torch.Tensor:
        cfg = self.cfg
        x = x + attention(self.attn, self.ecfg,
                          rms_norm(x, self.ln1, cfg.norm_eps), positions,
                          angles)
        return x + mlp(self.mlp, rms_norm(x, self.ln2, cfg.norm_eps),
                       cfg.activation)


class DecoderLayer(nn.Module):
    """Pre-norm causal self-attention, cross-attention over the encoder's
    K/V and gated MLP: the reference's ``_decoder_block``."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        self.cfg = cfg
        for i in (1, 2, 3):
            setattr(self, f"ln{i}", _zeros((cfg.d_model,), dtype, device))
        self.self_attn = _params(attention_shapes(cfg), dtype, device,
                                 generator)
        self.cross_attn = _params(attention_shapes(cfg), dtype, device,
                                  generator)
        self.mlp = _params(mlp_shapes(cfg), dtype, device, generator)

    def cross_kv(self, enc_out: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``_cross_kv``: k and v (B, T_enc, KV, dh) of the
        encoder's output, not roped."""
        return (_project(enc_out, self.cross_attn["wk"]),
                _project(enc_out, self.cross_attn["wv"]))

    def forward(self, x, positions, angles,
                cross: Union[torch.Tensor, Tuple[torch.Tensor, ...]],
                cache: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """``cross`` the encoder's output (projected here) or (k, v, their
        positions); ``cache`` (decode) is updated in place."""
        cfg = self.cfg
        if isinstance(cross, torch.Tensor):
            k, v = self.cross_kv(cross)
            cross = (k, v, cross_positions(cross))
        x = x + attention(self.self_attn, cfg,
                          rms_norm(x, self.ln1, cfg.norm_eps), positions,
                          angles, cache)
        x = x + attention(self.cross_attn, cfg,
                          rms_norm(x, self.ln2, cfg.norm_eps), positions,
                          None, kv_override=cross)
        return x + mlp(self.mlp, rms_norm(x, self.ln3, cfg.norm_eps),
                       cfg.activation)


class EncDec(nn.Module):
    """The encoder-decoder.  With ``seed`` None the weights are left
    uninitialised (for loading a state dict); otherwise they are drawn from
    a ``torch.Generator`` on ``device`` seeded with it."""

    def __init__(self, cfg: ModelConfig, device: Union[str, torch.device],
                 seed: Optional[int] = 0):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not "
                             f"encdec")
        self.cfg = cfg
        self.device = torch.device(device)
        dtype = cfg.parameter_dtype()
        gen = None
        if seed is not None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        self.embed = _param((cfg.vocab, cfg.d_model), dtype, self.device, gen,
                            scale=1.0)
        self.enc_layers = nn.ModuleList(
            EncoderLayer(cfg, dtype, self.device, gen)
            for _ in range(cfg.n_encoder_layers))
        self.dec_layers = nn.ModuleList(
            DecoderLayer(cfg, dtype, self.device, gen)
            for _ in range(cfg.n_layers))
        self.enc_norm = _zeros((cfg.d_model,), dtype, self.device)
        self.final_norm = _zeros((cfg.d_model,), dtype, self.device)
        self.register_parameter(
            "head", None if cfg.tie_embeddings else
            _param((cfg.d_model, cfg.vocab), dtype, self.device, gen))

    def _angles(self, positions: torch.Tensor):
        cfg = self.cfg
        return rope_angles(positions, rope_dim(cfg, cfg.resolved_head_dim),
                           cfg.rope_theta)

    def encode(self, embeds: torch.Tensor) -> torch.Tensor:
        """embeds (B, T_enc, d) from the frontend stub -> the encoder's
        output (B, T_enc, d), final-normed."""
        x = embeds.to(self.cfg.activation_dtype())
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        angles = self._angles(positions)
        for layer in self.enc_layers:
            x = remat(self.cfg, layer, x, positions, angles)
        return rms_norm(x, self.enc_norm, self.cfg.norm_eps)

    def forward(self, tokens: torch.Tensor,
                embeds: Optional[torch.Tensor] = None,
                return_hidden: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The teacher-forced decoder over ``encode(embeds)``: tokens (B,
        S) -> (logits (B, S, V) float32, {"aux": 0}); ``return_hidden``
        returns the final-normed hidden states instead."""
        enc_out = self.encode(embeds)
        x = embed(self.embed, self.cfg, tokens)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        angles = self._angles(positions)
        for layer in self.dec_layers:
            x = remat(self.cfg, layer, x, positions, angles, enc_out)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        info = {"aux": torch.zeros((), dtype=torch.float32, device=x.device)}
        if return_hidden:
            return x, info
        return logits_from(self.embed, self.head, self.cfg, x), info

    @torch.no_grad()
    def init_decode_state(self, batch: int, max_len: int,
                          enc_out: Optional[torch.Tensor] = None,
                          enc_len: Optional[int] = None) -> Dict[str, Any]:
        return init_decode_state(self.cfg, batch, max_len, self.device,
                                 model=self, enc_out=enc_out,
                                 enc_len=enc_len)

    @torch.no_grad()
    def decode_step(self, state: Dict[str, Any], tokens: torch.Tensor,
                    pos: Union[int, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """tokens (B, S) at ``pos`` (as :meth:`Transformer.decode_step`)
        against the state's cross K/V.  Returns (logits (B, S, V) float32,
        state), the self-attention caches updated in place."""
        x = embed(self.embed, self.cfg, tokens)
        positions = decode_positions(pos, x.device)
        angles = self._angles(positions)
        kpos = cross_positions(state["cross_k"][0])
        for layer, cache, k, v in zip(self.dec_layers, state["layers"],
                                      state["cross_k"], state["cross_v"]):
            x = layer(x, positions, angles, (k, v, kpos), cache)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return logits_from(self.embed, self.head, self.cfg, x), state


def init(cfg: ModelConfig, seed: Optional[int],
         device: Union[str, torch.device]) -> EncDec:
    """The model on ``device``, its weights drawn from ``seed`` (None:
    left uninitialised, for a state dict or a ``meta`` skeleton)."""
    return EncDec(cfg, device, seed)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device: Union[str, torch.device],
                      model: Optional[EncDec] = None,
                      enc_out: Optional[torch.Tensor] = None,
                      enc_len: Optional[int] = None) -> Dict[str, Any]:
    """Self-attention caches and the cross K/V a decoder layer
    (``cross_k``/``cross_v``: lists of (batch, T_enc, KV, dh)).  With
    ``model`` and ``enc_out`` the cross K/V are computed from the encoder's
    output; otherwise they are zeros of ``enc_len`` (default
    ``frontend_tokens``) frames."""
    dtype, device = cfg.activation_dtype(), torch.device(device)
    L = cfg.n_layers
    caches: List[Dict[str, Any]] = [
        init_attention_cache(cfg, batch, max_len, dtype, device)
        for _ in range(L)]
    if model is not None and enc_out is not None:
        with torch.no_grad():
            kv = [layer.cross_kv(enc_out) for layer in model.dec_layers]
        cross_k, cross_v = [k for k, _ in kv], [v for _, v in kv]
    else:
        shape = (batch, enc_len or cfg.frontend_tokens, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        cross_k = [torch.zeros(shape, dtype=dtype, device=device)
                   for _ in range(L)]
        cross_v = [torch.zeros(shape, dtype=dtype, device=device)
                   for _ in range(L)]
    return {"layers": caches, "cross_k": cross_k, "cross_v": cross_v}


def loss_fn(model: EncDec, params: Optional[Params],
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's encdec ``loss_fn``: next-token cross-entropy of the
    decoder over ``encode(batch["embeds"])``, with no mask (the batch's
    mask is not read, as in the reference); chunked from the hidden states
    above ``S·vocab = 2**26``.  Returns ``(loss, {"loss", "aux"})``."""
    cfg = model.cfg
    tokens, labels = batch["tokens"], batch["labels"]
    if tokens.shape[1] * cfg.vocab > 2 ** 26:
        x, info = functional_call(model, params, tokens, batch["embeds"],
                                  return_hidden=True)
        head = dict(model.named_parameters()) if params is None else params
        loss = chunked_ce_from_hidden(head, cfg, x[:, :-1], labels[:, 1:])
    else:
        logits, info = functional_call(model, params, tokens,
                                       batch["embeds"])
        loss = cross_entropy(logits[:, :-1], labels[:, 1:])
    return loss, {"loss": loss, **info}
