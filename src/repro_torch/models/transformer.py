"""Decoder-only LM, dense, moe and ssm families: the twin of the
reference's ``repro.models.transformer`` for ``family == "dense"``
(attention blocks), ``family == "moe"`` (attention or MLA, and a routed
mixture of experts in place of the MLP: :mod:`.moe`) and ``family ==
"ssm"`` (RWKV-6 blocks, :mod:`.rwkv`).  An MLA config
(``cfg.mla``) takes MLA in place of attention in either attention family.

The reference stacks its layers (leading L dimension) and drives them with
``lax.scan``; here the blocks are an ``nn.ModuleList`` walked in Python.
The other families raise ``NotImplementedError`` naming the ROADMAP.md
queue that brings them.

Training differentiates with respect to a dict of leaf tensors keyed as
the module's state dict: :func:`functional_call` runs the module on them
(``torch.func.functional_call``), and :func:`loss_fn` /
:func:`chunked_ce_from_hidden` are the reference's loss paths.

Decode state is a list of per-layer states that :meth:`decode_step`
updates in place (the reference returns a new state instead): ring-buffer
KV caches (:func:`layers.init_attention_cache`) for attention, latent
caches (:func:`layers.init_mla_cache`) for MLA, the WKV state and the two
token-shift carries for the ssm family.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig

from . import moe as moe_mod
from . import rwkv
from .layers import (attention, cross_entropy, embed, init_attention_cache,
                     init_mla_cache, logits_from, mla_angles, mla_attention,
                     mla_rope_cfg, mlp, rms_norm, rope_angles, rope_dim)

FAMILIES = ("dense", "moe", "ssm")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; only the "
            f"dense, moe and ssm families are (ROADMAP.md queue 1, item 5)")


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


def attention_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """The reference's ``init_attention`` layouts, or ``init_mla``'s for an
    MLA config."""
    d, H = cfg.d_model, cfg.n_heads
    if cfg.mla is not None:
        m = cfg.mla
        return {"wq": (d, H, m.nope_head_dim + m.rope_head_dim),
                "wkv_a": (d, m.kv_lora_rank + m.rope_head_dim),
                "wkv_b": (m.kv_lora_rank, H,
                          m.nope_head_dim + m.v_head_dim),
                "wo": (H, m.v_head_dim, d)}
    KV, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    return {"wq": (d, H, dh), "wk": (d, KV, dh), "wv": (d, KV, dh),
            "wo": (H, dh, d)}


class DenseBlock(nn.Module):
    """Pre-norm attention (or MLA) + gated MLP (or MoE), residual around
    each: the reference's ``_dense_block``."""

    def __init__(self, cfg: ModelConfig, dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.cfg = cfg
        self.rope_cfg = mla_rope_cfg(cfg) if cfg.mla is not None else None
        self.ln1 = _zeros((d,), dtype, device)
        self.ln2 = _zeros((d,), dtype, device)
        self.attn = nn.ParameterDict({
            name: _param(shape, dtype, device, generator)
            for name, shape in attention_shapes(cfg).items()})
        if cfg.moe is not None:
            self.moe = moe_mod.MoE(cfg, {
                name: _param(shape, dtype, device, generator)
                for name, shape in moe_mod.param_shapes(cfg).items()})
        else:
            self.mlp = nn.ParameterDict({
                "wi": _param((d, ff), dtype, device, generator),
                "wg": _param((d, ff), dtype, device, generator),
                "wo": _param((ff, d), dtype, device, generator),
            })

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                angles: Tuple[torch.Tensor, torch.Tensor],
                cache: Optional[Dict[str, Any]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (x, the MoE's aux loss, its expert counts (E,)); without
        an MoE 0 and (1,) zeros, as the reference's scan carries them."""
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        if cfg.mla is not None:
            h = mla_attention(self.attn, cfg, h, positions, angles,
                              self.rope_cfg, cache)
        else:
            h = attention(self.attn, cfg, h, positions, angles, cache)
        x = x + h
        h = rms_norm(x, self.ln2, cfg.norm_eps)
        if cfg.moe is not None:
            h, aux, counts = self.moe(h)
        else:
            h = mlp(self.mlp, h, cfg.activation)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            counts = torch.zeros((1,), dtype=torch.int32, device=x.device)
        return x + h, aux, counts


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
    """The decoder-only LM of the dense, moe or ssm family.  With ``seed`` None
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
        """The rope angles of ``positions``, once for every layer (MLA's
        over its rope dims)."""
        cfg = self.cfg
        if cfg.mla is not None:
            return mla_angles(cfg, positions)
        return rope_angles(positions, rope_dim(cfg, cfg.resolved_head_dim),
                           cfg.rope_theta)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return logits_from(self.embed, self.head, self.cfg, x)

    def forward(self, tokens: torch.Tensor, return_hidden: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens (B, S) -> (logits (B, S, V) float32, info);
        ``return_hidden`` skips the head and returns the final-normed
        hidden states (B, S, d) (the chunked-CE path).  Records a graph
        only where a parameter needs a gradient (:func:`loss_fn` calls it
        with a dict of leaf tensors).  ``info`` holds the summed MoE aux
        loss ``aux`` and, for the attention families, ``expert_counts``
        (L, E) (L, 1 of zeros without an MoE), as the reference's."""
        x = embed(self.embed, self.cfg, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        info = {}
        if self.recurrent:  # every layer from a zero state
            for block in self.blocks:
                x = block(x)
        else:
            positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                     device=x.device)
            angles = self._angles(positions)
            counts = []
            for block in self.blocks:
                x, a, c = block(x, positions, angles)
                aux = aux + a
                counts.append(c)
            info["expert_counts"] = torch.stack(counts)
        info = {"aux": aux, **info}
        if return_hidden:
            return rms_norm(x, self.final_norm, self.cfg.norm_eps), info
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
            x = block(x, positions, angles, cache)[0]
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
    init_cache = init_mla_cache if cfg.mla is not None \
        else init_attention_cache
    return {"layers": [init_cache(cfg, batch, max_len, dtype, device)
                       for _ in range(cfg.n_layers)]}


# --------------------------------------------------------------------------
# loss (training)
# --------------------------------------------------------------------------
Params = Dict[str, torch.Tensor]


def functional_call(model: Transformer, params: Optional[Params],
                    tokens: torch.Tensor, return_hidden: bool = False
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``model(tokens)`` with its parameters replaced by ``params`` (a dict
    keyed as ``model.state_dict()``; None: the module's own)."""
    if params is None:
        return model(tokens, return_hidden=return_hidden)
    return torch.func.functional_call(
        model, params, (tokens,), {"return_hidden": return_hidden},
        strict=True)


def chunked_ce_from_hidden(params: Params, cfg: ModelConfig,
                           x: torch.Tensor, labels: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           chunk: int = 512) -> torch.Tensor:
    """Cross-entropy computed seq-chunk by seq-chunk from the hidden
    states ``x`` (B, S, d), with the head of ``params`` (``embed``, and
    ``head`` when the embeddings are not tied): each chunk's float32
    logits are formed, reduced and dropped in turn (autograd keeps what
    the backward needs of each)."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    denom = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in range(0, S, chunk):
        logits = logits_from(params["embed"], params.get("head"), cfg,
                             x[:, a:a + chunk])
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1,
                          labels[:, a:a + chunk, None].long())[..., 0]
        mc = mask[:, a:a + chunk]
        tot = tot + ((lse - ll) * mc).sum()
        denom = denom + mc.sum()
    return tot / torch.clamp(denom, min=1.0)


def loss_fn(model: Transformer, params: Optional[Params],
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``loss_fn`` for the dense, moe and ssm families:
    next-token cross-entropy of ``batch`` (``tokens``, ``labels``,
    optional ``mask``) under ``params`` (None: the module's own).  Above
    ``S·vocab = 2**26`` the loss comes chunked from the hidden states, as
    in the reference.  The total adds the MoE aux loss.  Returns
    ``(total, {"loss", "aux", "expert_counts"?})``."""
    cfg = model.cfg
    labels, mask = batch["labels"], batch.get("mask")
    tokens = batch["tokens"]
    if tokens.shape[1] * cfg.vocab > 2 ** 26:
        x, info = functional_call(model, params, tokens, return_hidden=True)
        head = dict(model.named_parameters()) if params is None else params
        loss = chunked_ce_from_hidden(
            head, cfg, x[:, :-1], labels[:, 1:],
            mask[:, 1:] if mask is not None else None)
    else:
        logits, info = functional_call(model, params, tokens)
        loss = cross_entropy(logits[:, :-1], labels[:, 1:],
                             mask[:, 1:] if mask is not None else None)
    return loss + info["aux"], {"loss": loss, **info}
