"""Decoder-only LM: the twin of the reference's
``repro.models.transformer`` for the families it holds.  ``family ==
"dense"`` (attention blocks), ``"moe"`` (attention or MLA, and a routed
mixture of experts in place of the MLP: :mod:`.moe`), ``"vlm"`` and
``"audio"`` (the dense blocks; a vlm prepends the stub frontend's patch
embeddings through ``vis_proj``), ``"ssm"`` (RWKV-6 blocks, :mod:`.rwkv`)
and ``"hybrid"`` (blocks of the (rec, rec, attn) pattern: RG-LRU
sublayers, :mod:`.rglru`, and local attention, then a tail of the
pattern's first sublayers).  An MLA config (``cfg.mla``) takes MLA in
place of attention in either attention family.  The encdec family is
:mod:`.encdec`.

The reference stacks its layers (leading L dimension) and drives them with
``lax.scan``; here the blocks are an ``nn.ModuleList`` walked in Python.
Each block (a hybrid's whole pattern group, not its tail) runs through
:func:`remat`, the twin of the reference's ``_maybe_remat``: a call that
autograd records keeps what ``cfg.remat_policy`` says and recomputes the
rest of the block in the backward.

Training differentiates with respect to a dict of leaf tensors keyed as
the module's state dict: :func:`functional_call` runs the module on them
(``torch.func.functional_call``), and :func:`loss_fn` /
:func:`chunked_ce_from_hidden` are the reference's loss paths.

Decode state is a list of per-layer states that :meth:`decode_step`
updates in place (the reference returns a new state instead): ring-buffer
KV caches (:func:`layers.init_attention_cache`) for attention, latent
caches (:func:`layers.init_mla_cache`) for MLA, the WKV state and the two
token-shift carries for the ssm family, and for the hybrid family one
dict a block of each sublayer's state (a KV cache, or the RG-LRU's conv
carry and float32 ``h``).  A decode call writes every state tensor in
place, where it lies, and rebinds no entry; it reads no host value (a
cache's ``idx`` is a tensor on the device) and copies nothing to the
host.  So a CUDA graph captured over one call replays the next one
(``serve/runtime.py``), given its tokens and positions in tensors.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import constrain

from . import moe as moe_mod
from . import rglru, rwkv
from .layers import (attention, cross_entropy, embed, init_attention_cache,
                     init_mla_cache, label_logits, logits_from, mla_angles,
                     mla_attention, mla_rope_cfg, mlp, rms_norm, rope_angles,
                     rope_dim)

# Every family the reference knows; this module builds all but encdec.
FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid", "encdec")
# The families whose layers are the dense blocks.
DENSE_FAMILIES = ("dense", "moe", "vlm", "audio")

# The logical axes the reference constrains the residual stream and the
# logits to (``sharding.constrain``: a no-op outside a sharding context).
ACT_AXES = ("batch", "seq", "act_embed")
LOGIT_AXES = ("batch", "seq", "vocab_out")


def check_family(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family the reference does not know, as
    the reference's ``init`` does."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown model family "
                         f"{cfg.family!r}; the families are {FAMILIES}")


# The products "dots" keeps: those without batch dims (the projections),
# as jax.checkpoint_policies.dots_with_no_batch_dims_saveable.
_NO_BATCH_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _NO_BATCH_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(cfg: ModelConfig, block: nn.Module, *args):
    """``block(*args)`` under the reference's ``_maybe_remat``.  Where
    autograd records the call (grad enabled, and an input or a parameter
    that requires it): ``remat_policy == "full"`` keeps every activation
    (the reference's name for no recompute); ``"dots"`` keeps the outputs
    of the products without batch dims and recomputes the rest in the
    backward; any other value, ``"nothing"`` (the default) included,
    keeps only the block's inputs and recomputes the whole block.  Other
    calls (serving, decode) run the block once.

    The recompute runs the block with the parameters it holds then: a
    caller that swaps tensors in (``functional_call``) keeps them swapped
    through the backward, as ``train.loop.value_and_grad`` does."""
    if cfg.remat_policy == "full" or not torch.is_grad_enabled():
        return block(*args)
    if not any(t.requires_grad for t in (*block.parameters(), *args)
               if isinstance(t, torch.Tensor)):
        return block(*args)
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_products)
    return checkpoint(block, *args, use_reentrant=False, **kw)


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


def mlp_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """The reference's ``init_mlp`` layouts."""
    d, ff = cfg.d_model, cfg.d_ff
    return {"wi": (d, ff), "wg": (d, ff), "wo": (ff, d)}


def _params(shapes: Dict[str, Tuple[int, ...]], dtype, device,
            generator: Optional[torch.Generator]) -> nn.ParameterDict:
    """``_param`` draws in the order of ``shapes``."""
    return nn.ParameterDict({name: _param(shape, dtype, device, generator)
                             for name, shape in shapes.items()})


class DenseBlock(nn.Module):
    """Pre-norm attention (or MLA) + gated MLP (or MoE), residual around
    each: the reference's ``_dense_block``."""

    def __init__(self, cfg: ModelConfig, dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.rope_cfg = mla_rope_cfg(cfg) if cfg.mla is not None else None
        self.ln1 = _zeros((d,), dtype, device)
        self.ln2 = _zeros((d,), dtype, device)
        self.attn = _params(attention_shapes(cfg), dtype, device, generator)
        if cfg.moe is not None:
            self.moe = moe_mod.MoE(cfg, {
                name: _param(shape, dtype, device, generator)
                for name, shape in moe_mod.param_shapes(cfg).items()})
        else:
            self.mlp = _params(mlp_shapes(cfg), dtype, device, generator)

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
        x = constrain(x + h, ACT_AXES)
        h = rms_norm(x, self.ln2, cfg.norm_eps)
        if cfg.moe is not None:
            h, aux, counts = self.moe(h)
        else:
            h = mlp(self.mlp, h, cfg.activation)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            counts = torch.zeros((1,), dtype=torch.int32, device=x.device)
        return constrain(x + h, ACT_AXES), aux, counts


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
        """x (B, T, d); ``state`` (decode) is updated in place, each
        tensor at its address."""
        cfg = self.cfg
        h, tm = rwkv.rwkv_time_mix(self.block, cfg,
                                   rms_norm(x, self.ln1, cfg.norm_eps), state)
        x = constrain(x + h, ACT_AXES)
        h, cm = rwkv.rwkv_channel_mix(self.block, cfg,
                                      rms_norm(x, self.ln2, cfg.norm_eps),
                                      state)
        if state is not None:
            for key, value in (*tm.items(), *cm.items()):
                if value is not state[key]:     # S is updated in place
                    state[key].copy_(value)
        return constrain(x + h, ACT_AXES)


def _uniform(shape, dtype, device, generator: Optional[torch.Generator],
             low: float, high: float) -> nn.Parameter:
    """The reference's ``layers.uniform_param``: uniform in [low, high),
    drawn in float32, then cast."""
    if generator is None:
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                            requires_grad=False)
    w = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    return nn.Parameter(w.mul_(high - low).add_(low).to(dtype),
                        requires_grad=False)


def hybrid_pattern(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...]]:
    """(blocks of the whole pattern, the tail's sublayer kinds)."""
    pat = cfg.recurrent.block_pattern
    n_blocks = cfg.n_layers // len(pat)
    return n_blocks, pat[:cfg.n_layers - n_blocks * len(pat)]


class HybridSublayer(nn.Module):
    """Pre-norm mixer (an RG-LRU block for ``kind == "rec"``, attention
    otherwise) + gated MLP, residual around each: the reference's
    ``_hybrid_sublayer``."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        d = cfg.d_model
        self.cfg, self.kind = cfg, kind
        self.ln1 = _zeros((d,), dtype, device)
        self.ln2 = _zeros((d,), dtype, device)
        if kind == "rec":
            self.mix = nn.ParameterDict({
                name: _uniform(shape, dtype, device, generator, 3.0, 6.0)
                if name == "lam" else
                _param(shape, dtype, device, generator)
                for name, shape in rglru.param_shapes(cfg).items()})
        else:
            self.mix = _params(attention_shapes(cfg), dtype, device,
                               generator)
        self.mlp = _params(mlp_shapes(cfg), dtype, device, generator)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                angles: Tuple[torch.Tensor, torch.Tensor],
                state: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """``state`` (decode: a KV cache or {"conv", "h"}) is updated in
        place."""
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        if self.kind == "rec":
            h = rglru.rglru_block(self.mix, cfg, h, state)
        else:
            h = attention(self.mix, cfg, h, positions, angles, state)
        x = constrain(x + h, ACT_AXES)
        return constrain(x + mlp(self.mlp, rms_norm(x, self.ln2,
                                                    cfg.norm_eps),
                                 cfg.activation), ACT_AXES)


class HybridGroup(nn.ModuleDict):
    """One block of the pattern (or the tail): ``sub{i}`` of kind
    ``kinds[i]``, run in order."""

    def __init__(self, cfg: ModelConfig, kinds, dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__({
            f"sub{i}": HybridSublayer(cfg, kind, dtype, device, generator)
            for i, kind in enumerate(kinds)})

    def forward(self, x: torch.Tensor, positions, angles,
                state: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        for name, sub in self.items():
            x = sub(x, positions, angles,
                    None if state is None else state[name])
        return x


class Transformer(nn.Module):
    """The decoder-only LM of every family but encdec.  With ``seed`` None
    the weights are left uninitialised (for loading a state dict);
    otherwise they are drawn from a ``torch.Generator`` on ``device``
    seeded with it."""

    def __init__(self, cfg: ModelConfig, device: Union[str, torch.device],
                 seed: Optional[int] = 0):
        super().__init__()
        check_family(cfg)
        if cfg.family == "encdec":
            raise ValueError(f"{cfg.name}: the encdec family is "
                             f"models.encdec.EncDec")
        self.cfg = cfg
        self.device = torch.device(device)
        dtype = cfg.parameter_dtype()
        gen = None
        if seed is not None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        self.embed = _param((cfg.vocab, cfg.d_model), dtype, self.device, gen,
                            scale=1.0)
        self.recurrent = cfg.family == "ssm"
        self.tail = None
        if cfg.family == "hybrid":
            n_blocks, tail = hybrid_pattern(cfg)
            pat = cfg.recurrent.block_pattern
            self.blocks = nn.ModuleList(
                HybridGroup(cfg, pat, dtype, self.device, gen)
                for _ in range(n_blocks))
            if tail:
                self.tail = HybridGroup(cfg, tail, dtype, self.device, gen)
        else:
            block = RWKVBlock if self.recurrent else DenseBlock
            self.blocks = nn.ModuleList(
                block(cfg, dtype, self.device, gen)
                for _ in range(cfg.n_layers))
        self.final_norm = _zeros((cfg.d_model,), dtype, self.device)
        self.register_parameter(
            "head", None if cfg.tie_embeddings else
            _param((cfg.d_model, cfg.vocab), dtype, self.device, gen))
        # the vlm's stub frontend projection: precomputed patch embeddings
        # to d_model
        self.register_parameter(
            "vis_proj", None if cfg.family != "vlm" else
            _param((cfg.d_model, cfg.d_model), dtype, self.device, gen))

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
        return constrain(logits_from(self.embed, self.head, self.cfg, x),
                         LOGIT_AXES)

    def forward(self, tokens: torch.Tensor,
                embeds: Optional[torch.Tensor] = None,
                return_hidden: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens (B, S) -> (logits (B, P + S, V) float32, info); ``embeds``
        (B, P, d) the vlm's patch embeddings, projected through
        ``vis_proj`` and put before the text (ignored by the other
        families, as in the reference).  ``return_hidden`` skips the head
        and returns the final-normed hidden states (the chunked-CE path).
        Records a graph only where a parameter needs a gradient
        (:func:`loss_fn` calls it with a dict of leaf tensors).  ``info``
        holds the summed MoE aux loss ``aux`` and, for the dense-block
        families, ``expert_counts`` (L, E) (L, 1 of zeros without an MoE),
        as the reference's."""
        cfg = self.cfg
        x = embed(self.embed, cfg, tokens)
        if cfg.family == "vlm" and embeds is not None:
            x = torch.cat([embeds.to(x.dtype) @ self.vis_proj, x], dim=1)
        x = constrain(x, ACT_AXES)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        info = {}
        if self.recurrent:  # every layer from a zero state
            for block in self.blocks:
                x = remat(cfg, block, x)
        else:
            positions = torch.arange(x.shape[1], dtype=torch.int32,
                                     device=x.device)
            angles = self._angles(positions)
            if cfg.family == "hybrid":
                for block in self.blocks:
                    x = remat(cfg, block, x, positions, angles)
                if self.tail is not None:   # not remat'd, as the reference
                    x = self.tail(x, positions, angles)
            else:
                counts = []
                for block in self.blocks:
                    x, a, c = remat(cfg, block, x, positions, angles)
                    aux = aux + a
                    counts.append(c)
                info["expert_counts"] = torch.stack(counts)
        info = {"aux": aux, **info}
        if return_hidden:
            return rms_norm(x, self.final_norm, cfg.norm_eps), info
        return self._head(x), info

    def init_decode_state(self, batch: int, max_len: int) -> Dict[str, Any]:
        return init_decode_state(self.cfg, batch, max_len, self.device)

    @torch.no_grad()
    def decode_step(self, state: Dict[str, Any], tokens: torch.Tensor,
                    pos: Union[int, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """tokens (B, S); ``pos`` the position of a single token (an int or
        a 0-d or (1,) tensor) or the (S,) positions of a chunk (unused by
        the ssm family, as in the reference).  Returns (logits (B, S, V)
        float32, state), the state updated in place.  With ``pos`` a
        tensor the call reads no host value: a graph captured over it
        replays with new tokens and positions written into the same
        tensors."""
        x = constrain(embed(self.embed, self.cfg, tokens), ACT_AXES)
        if self.recurrent:
            for block, st in zip(self.blocks, state["layers"]):
                x = block(x, st)
            return self._head(x), state
        positions = decode_positions(pos, x.device)
        angles = self._angles(positions)
        if self.cfg.family == "hybrid":
            for block, st in zip(self.blocks, state["blocks"]):
                x = block(x, positions, angles, st)
            if self.tail is not None:
                x = self.tail(x, positions, angles, state["tail"])
            return self._head(x), state
        for block, cache in zip(self.blocks, state["layers"]):
            x = block(x, positions, angles, cache)[0]
        return self._head(x), state


def decode_positions(pos: Union[int, torch.Tensor],
                     device: torch.device) -> torch.Tensor:
    """A decode call's positions (S,) int32 on ``device``: ``pos`` an int
    or a 0-d tensor (one token) or the (S,) positions of a chunk.  An int
    is filled on the device (no copy from the host), as a value the call
    holds: a graph captured over it would replay that position, so a
    graphed caller passes a tensor, which is used as it is (a view of
    it, when it is 0-d)."""
    if isinstance(pos, torch.Tensor):
        positions = pos.to(device=device, dtype=torch.int32)
        return positions[None] if positions.dim() == 0 else positions
    return torch.full((1,), int(pos), dtype=torch.int32, device=device)


def init(cfg: ModelConfig, seed: Optional[int],
         device: Union[str, torch.device]) -> Transformer:
    """The model on ``device``, its weights drawn from ``seed`` (None:
    left uninitialised, for a state dict or a ``meta`` skeleton)."""
    return Transformer(cfg, device, seed)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device: Union[str, torch.device]) -> Dict[str, Any]:
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
    if cfg.family == "hybrid":
        w, cw = rglru.width(cfg), cfg.recurrent.conv_width

        def sub_state(kind):
            if kind == "rec":
                return {"conv": torch.zeros((batch, cw - 1, w), dtype=dtype,
                                            device=device),
                        # the scan's state stays float32 in a bf16 model
                        "h": torch.zeros((batch, w), dtype=torch.float32,
                                         device=device)}
            return init_attention_cache(cfg, batch, max_len, dtype, device)

        n_blocks, tail = hybrid_pattern(cfg)
        pat = cfg.recurrent.block_pattern
        state = {"blocks": [{f"sub{i}": sub_state(k)
                             for i, k in enumerate(pat)}
                            for _ in range(n_blocks)]}
        if tail:
            state["tail"] = {f"sub{i}": sub_state(k)
                             for i, k in enumerate(tail)}
        return state
    if cfg.family not in DENSE_FAMILIES:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} has its own "
                         f"decode state (models.encdec)")
    init_cache = init_mla_cache if cfg.mla is not None \
        else init_attention_cache
    return {"layers": [init_cache(cfg, batch, max_len, dtype, device)
                       for _ in range(cfg.n_layers)]}


# --------------------------------------------------------------------------
# loss (training)
# --------------------------------------------------------------------------
Params = Dict[str, torch.Tensor]


def functional_call(model: nn.Module, params: Optional[Params],
                    tokens: torch.Tensor,
                    embeds: Optional[torch.Tensor] = None,
                    return_hidden: bool = False
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``model(tokens, embeds)`` with its parameters replaced by ``params``
    (a dict keyed as ``model.state_dict()``; None: the module's own)."""
    kw = {"embeds": embeds, "return_hidden": return_hidden}
    if params is None:
        return model(tokens, **kw)
    return torch.func.functional_call(model, params, (tokens,), kw,
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
        logits = constrain(logits_from(params["embed"], params.get("head"),
                                       cfg, x[:, a:a + chunk]), LOGIT_AXES)
        lse = torch.logsumexp(logits, dim=-1)
        ll = label_logits(logits, labels[:, a:a + chunk])
        mc = mask[:, a:a + chunk]
        tot = tot + ((lse - ll) * mc).sum()
        denom = denom + mc.sum()
    return tot / torch.clamp(denom, min=1.0)


def loss_fn(model: Transformer, params: Optional[Params],
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``loss_fn``: next-token cross-entropy of ``batch``
    (``tokens``, ``labels``, optional ``mask`` and, for the vlm,
    ``embeds``) under ``params`` (None: the module's own).  Above
    ``S·vocab = 2**26`` (S the text's length) the loss comes chunked from
    the hidden states, as in the reference.  A vlm's loss drops the P
    positions of its patch prefix on both paths.  The total adds the MoE
    aux loss.  Returns ``(total, {"loss", "aux", "expert_counts"?})``."""
    cfg = model.cfg
    labels, mask = batch["labels"], batch.get("mask")
    tokens, embeds = batch["tokens"], batch.get("embeds")
    prefix = embeds.shape[1] if cfg.family == "vlm" and embeds is not None \
        else 0
    if tokens.shape[1] * cfg.vocab > 2 ** 26:
        x, info = functional_call(model, params, tokens, embeds,
                                  return_hidden=True)
        head = dict(model.named_parameters()) if params is None else params
        loss = chunked_ce_from_hidden(
            head, cfg, x[:, prefix:][:, :-1], labels[:, 1:],
            mask[:, 1:] if mask is not None else None)
    else:
        logits, info = functional_call(model, params, tokens, embeds)
        loss = cross_entropy(logits[:, prefix:][:, :-1], labels[:, 1:],
                             mask[:, 1:] if mask is not None else None)
    return loss + info["aux"], {"loss": loss, **info}
