"""Shared model layers, as plain functions on tensors.

The twin of the reference's ``repro.models.layers`` (its norms, rope,
attention, MLA, MLP, embedding and loss).  The norm and the attention call
the port's kernels (:mod:`repro_torch.kernels`): on CUDA tensors those
launch the hand-written CUDA kernels, on CPU tensors they run their plain
PyTorch versions.  The reference's ``naive_attention`` and
``chunked_attention`` both become the one attention kernel, for MLA too.

Parameters are the attributes of the modules in ``transformer.py``, in the
reference's layouts: ``wq`` (d, H, dh), ``wk``/``wv`` (d, KV, dh), ``wo``
(H, dh, d), ``wi``/``wg`` (d, ff), MLP ``wo`` (ff, d), the embedding
(vocab, d); MLA's ``wq`` (d, H, nope + rope), ``wkv_a`` (d, r + rope),
``wkv_b`` (r, H, nope + v) and ``wo`` (H, v, d).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import (FlashAttentionFunction, RmsnormFunction,
                                 flash_attention, local, rmsnorm)
from repro_torch.sharding import constrain, gather_seq, weights_cheaper

# Position of a KV-cache slot that was never written: masked by the causal
# test of every real query.
UNWRITTEN = 2 ** 30


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x (..., d): the rows of x through the RMSNorm kernel (a DTensor's
    local rows: :func:`repro_torch.kernels.local.rmsnorm`)."""
    if local.is_dtensor(x):
        return local.rmsnorm(x, w, eps, rms_norm)
    d = x.shape[-1]
    rows = x.reshape(-1, d).contiguous()
    if _differentiable(x, w):
        return RmsnormFunction.apply(rows, w, eps).reshape(x.shape)
    return rmsnorm(rows, w, eps).reshape(x.shape)


def _differentiable(*ts: torch.Tensor) -> bool:
    """Does autograd need a graph through this call?"""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------
def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin (..., S, dim/2)."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def rope_dim(cfg: ModelConfig, dh: int) -> int:
    """How many of a head's dh dims rotate."""
    frac = cfg.rope_fraction if cfg.rope_style == "partial" else 1.0
    rot = int(dh * frac)
    return rot - rot % 2


def apply_rope(x: torch.Tensor, angles: Tuple[torch.Tensor, torch.Tensor],
               cfg: ModelConfig) -> torch.Tensor:
    """x: (..., S, H, dh); ``angles`` the cos/sin of
    ``rope_angles(positions, rope_dim(cfg, dh), cfg.rope_theta)``, which
    the model computes once per call for all layers.  Styles:
    'half'        — llama rotate-half over the full head dim;
    'partial'     — chatglm 2d rope: only rope_fraction of dims, interleaved
                    pairs, remainder passed through;
    'interleaved' — gpt-neox interleaved pairs over the full dim.
    """
    rot = rope_dim(cfg, x.shape[-1])
    xr, xp = x[..., :rot], x[..., rot:]
    cos, sin = angles
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    if cfg.rope_style == "half":
        x1, x2 = torch.chunk(xr, 2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    else:  # interleaved pairs (also the chatglm partial style)
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(xr.shape)
    out = out.to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < x.shape[-1] else out


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int,
                         dtype: torch.dtype,
                         device: torch.device) -> Dict[str, torch.Tensor]:
    """A ring-buffer KV cache: ``min(max_len, window)`` slots with their
    positions (unwritten slots hold ``UNWRITTEN``), and ``idx``, the count
    of tokens written so far, an int32 scalar on the cache's device (the
    reference's), so that a call reads no host value."""
    KV, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    if cfg.window is not None:
        max_len = min(max_len, cfg.window)
    return {
        "k": torch.zeros((batch, max_len, KV, dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, KV, dh), dtype=dtype,
                         device=device),
        "pos": torch.full((max_len,), UNWRITTEN, dtype=torch.int32,
                          device=device),
        "idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def cache_write_slot(idx, S: int, max_len: int, ring: bool = True):
    """First slot an S-token write lands in.  The reference writes at
    ``idx % max_len`` for one token (``ring``; MLA's cache has no ring)
    and at ``idx`` for a chunk, through ``lax.dynamic_update_slice_in_dim``,
    which clamps the start into ``[0, max_len - S]``: a chunk written past
    the end of a window-sized cache overwrites the last ``S`` slots
    (layers.py:286-305).  ``idx`` a host int gives an int; a 0-d tensor
    gives a 0-d tensor on its device, computed there.  The shapes are
    checked on the host."""
    if S > max_len:
        raise ValueError(f"a {S}-token write does not fit a {max_len}-slot "
                         f"cache")
    write = idx % max_len if S == 1 and ring else idx
    if isinstance(write, torch.Tensor):
        return write.clamp(0, max_len - S)
    return min(max(write, 0), max_len - S)


def _write_cache(cache: Dict[str, torch.Tensor], S: int, ring: bool,
                 writes) -> None:
    """Write ``S`` tokens into ``cache`` in place, at the slots
    :func:`cache_write_slot` gives for its ``idx``, and advance ``idx`` by
    ``S``: ``writes`` holds (name, dim, values) of each buffer written,
    the slots along ``dim``.  Slots, writes and the count stay on the
    device (``index_copy_``), so the call reads no host value and keeps
    every buffer at its address.  On DTensors (the dry-run) each rank
    writes its own shards: the slot dim is never sharded, and the values
    are redistributed to the buffer's placements first."""
    idx = cache["idx"]
    name, dim, _ = writes[0]
    start = cache_write_slot(idx.to_local() if local.is_dtensor(idx) else idx,
                             S, cache[name].shape[dim], ring)
    slots = start + torch.arange(S, device=start.device)     # int64
    for name, dim, values in writes:
        buf = cache[name]
        values = values.to(buf.dtype)
        if local.is_dtensor(buf):
            buf, values = buf.to_local(), \
                local.placed_as(values, buf).to_local()
        buf.index_copy_(dim, slots, values)
    idx.add_(S)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) x (d, heads, dh) -> (B, S, heads, dh), one matrix
    product (the reference's einsum "bsd,dhk->bshk")."""
    d, heads, dh = w.shape
    if local.is_dtensor(w) and local.shard_count(w, 1) == 1:
        # heads whole (kv heads): each rank's rows times the whole weight,
        # so the heads stay whole for the attention kernel
        return local.rows(lambda x, w: (x @ w.reshape(d, heads * dh)).view(
            *x.shape[:-1], heads, dh), x, w)
    if local.is_dtensor(w):     # reshaped shard by shard
        return local.split_dim(x @ local.merge_dims(w, 1), x.dim() - 1, dh)
    return (x @ w.reshape(d, heads * dh)).view(*x.shape[:-1], heads, dh)


def attention(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor,
              angles: Optional[Tuple[torch.Tensor, torch.Tensor]],
              cache: Optional[Dict[str, torch.Tensor]] = None,
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]] = None
              ) -> torch.Tensor:
    """Attention sub-layer: projections, rope, the attention kernel and,
    with ``cache``, the ring-buffer KV cache.

    x (B, S, d); positions (S,) int32; ``angles`` as in
    :func:`apply_rope`.  The cache's buffers and ``idx`` are updated in
    place (the reference returns a new cache).  ``kv_override`` (k, v,
    k_positions) is cross-attention: k and v come from it as they are, q
    is not roped either (``angles`` is unused), and the call is
    non-causal with no window whatever ``cfg`` says, as in the reference.
    Under sequence parallelism x's sequence is gathered first
    (:func:`~repro_torch.sharding.gather_seq`).  Returns (B, S, d).
    """
    x = gather_seq(x)
    q = _project(x, p["wq"])
    if kv_override is not None:
        k, v, k_pos = kv_override
        out = _attend(q, k, v, positions, k_pos, causal=False, window=None,
                      softcap=cfg.attn_logit_softcap)
        return _out_project(out, p["wo"])
    q = apply_rope(q, angles, cfg)
    k = v = None
    if cache is None and local.is_dtensor(p["wk"]):
        k, v = (local.kv_project(x, p[w], p["wq"]) for w in ("wk", "wv"))
    if k is None:
        k, v = _project(x, p["wk"]), _project(x, p["wv"])
    k = apply_rope(k, angles, cfg)
    k_pos = positions
    if cache is not None:
        _write_cache(cache, x.shape[1], True,
                     (("k", 1, k), ("v", 1, v), ("pos", 0, positions)))
        # the cache pinned to its (batch x kv-head) sharding, as the
        # reference's
        k = constrain(cache["k"], ("batch", "seq", "act_kv", None))
        v = constrain(cache["v"], ("batch", "seq", "act_kv", None))
        k_pos = cache["pos"]
    out = _attend(q, k, v, positions, k_pos, causal=cfg.causal,
                  window=cfg.window, softcap=cfg.attn_logit_softcap)
    return _out_project(out, p["wo"])


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
            window: Optional[int], softcap: Optional[float]) -> torch.Tensor:
    """The attention kernel (its autograd Function where a gradient is
    needed) on contiguous q, k, v and int32 positions (on DTensors, each
    rank's batch and heads: :func:`repro_torch.kernels.local.attention`)."""
    if local.is_dtensor(q):
        return local.attention(q, k, v, q_pos, k_pos, lambda *a: _attend(
            *a, causal=causal, window=window, softcap=softcap))
    args = (q.contiguous(), k.contiguous(), v.contiguous(),
            q_pos.to(torch.int32).contiguous(),
            k_pos.to(torch.int32).contiguous())
    if _differentiable(*args[:3]):
        return FlashAttentionFunction.apply(*args, causal, window, softcap)
    return flash_attention(*args, causal=causal, window=window,
                           softcap=softcap)


def _out_project(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, S, H, dh) x (H, dh, d) -> (B, S, d), one matrix product."""
    H, dh, d = wo.shape
    if local.is_dtensor(wo):    # reshaped shard by shard
        return local.merge_dims(out, 2) @ local.merge_dims(wo, 0)
    return out.reshape(*out.shape[:2], H * dh) @ wo.reshape(H * dh, d)


# --------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# --------------------------------------------------------------------------
def mla_rope_cfg(cfg: ModelConfig) -> ModelConfig:
    """MLA rotates its rope dims in the 'half' style over all of them,
    whatever ``cfg.rope_style`` says."""
    return cfg.with_(rope_style="half", rope_fraction=1.0)


def mla_angles(cfg: ModelConfig, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rope angles of MLA's ``rope_head_dim`` dims at ``positions``."""
    return rope_angles(positions, cfg.mla.rope_head_dim, cfg.rope_theta)


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    """The latent cache: ``c_kv`` (B, max_len, r) and ``k_rope`` (B,
    max_len, rope), written at ``idx`` (no ring, no window; an int32
    scalar on the device, as in :func:`init_attention_cache`); slot i's
    key sits at position i (``pos``)."""
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, m.rope_head_dim),
                              dtype=dtype, device=device),
        "pos": torch.arange(max_len, dtype=torch.int32, device=device),
        "idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def mla_attention(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                  x: torch.Tensor, positions: torch.Tensor,
                  angles: Tuple[torch.Tensor, torch.Tensor],
                  rope_cfg: ModelConfig,
                  cache: Optional[Dict[str, torch.Tensor]] = None
                  ) -> torch.Tensor:
    """MLA: keys and values compressed to a per-token latent of rank r plus
    one rope key shared by the heads; the cache stores only those.

    x (B, S, d); positions (S,) int32; ``angles`` from :func:`mla_angles`,
    ``rope_cfg`` :func:`mla_rope_cfg` (both once per model call).  Every
    call decompresses the whole latent (every cache slot) through
    ``wkv_b``, as the reference does.  q and k are nope + rope wide; v is
    zero-padded to that width for the attention kernel and sliced back.
    The cache is updated in place.  Returns (B, S, d)."""
    m = cfg.mla
    nope, r = m.nope_head_dim, m.kv_lora_rank
    x = gather_seq(x)
    q = _project(x, p["wq"])
    q_rope = apply_rope(q[..., nope:], angles, rope_cfg)
    kv_a = x @ p["wkv_a"]
    c_kv, k_rope = kv_a[..., :r], kv_a[..., r:]
    k_rope = apply_rope(k_rope[:, :, None, :], angles, rope_cfg)[:, :, 0]
    k_pos = positions
    if cache is not None:
        # lax.dynamic_update_slice_in_dim clamps the start into the cache
        _write_cache(cache, x.shape[1], False,
                     (("c_kv", 1, c_kv), ("k_rope", 1, k_rope)))
        c_kv, k_rope, k_pos = cache["c_kv"], cache["k_rope"], cache["pos"]
    kv = _project(c_kv, p["wkv_b"])
    k_nope, v = kv[..., :nope], kv[..., nope:]
    H = k_nope.shape[2]
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:2], H, m.rope_head_dim)], dim=-1)
    q_full = torch.cat([q[..., :nope], q_rope], dim=-1)
    v_p = F.pad(v, (0, q_full.shape[-1] - v.shape[-1]))
    out = _attend(q_full, k_full, v_p, positions, k_pos, causal=cfg.causal,
                  window=cfg.window, softcap=cfg.attn_logit_softcap)
    return _out_project(out[..., :m.v_head_dim], p["wo"])


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation; torch's does not.
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor,
        activation: str) -> torch.Tensor:
    """The gated MLP.  Under sequence parallelism it gathers x's sequence,
    or, where that moves more bytes than its weights
    (:func:`~repro_torch.sharding.weights_cheaper`), runs on each rank's
    sequence shard with the weights gathered whole."""
    ws = (p["wg"], p["wi"], p["wo"])
    if weights_cheaper(x, *ws):
        return local.rows(lambda x, *ws: _mlp(x, *ws, activation), x, *ws)
    return _mlp(gather_seq(x), *ws, activation)


def _mlp(x: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
         wo: torch.Tensor, activation: str) -> torch.Tensor:
    h = _act(x @ wg, activation) * (x @ wi)
    return h @ wo


# --------------------------------------------------------------------------
# embedding / head
# --------------------------------------------------------------------------
def embed(table: torch.Tensor, cfg: ModelConfig,
          tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` (vocab, d) at ``tokens``.  A DTensor table is
    looked up row-wise: its vocab shards kept and its d gathered, each
    rank masking the tokens outside its vocab rows, and the partial rows
    summed at once (DTensor's row-wise embedding)."""
    if local.is_dtensor(table):
        x = local.keep_shards(F.embedding(
            tokens, local.keep_shards(table, (0,))), range(tokens.dim()))
    else:
        x = F.embedding(tokens, table)
    if cfg.scale_embed:
        # sqrt(d) is rounded to the table's dtype before it multiplies, as
        # in the reference: 55.43 becomes 55.5 in bfloat16 at d = 3072.
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x.to(cfg.activation_dtype())


def logits_from(table: torch.Tensor, head: Optional[torch.Tensor],
                cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return (x @ table.T).float()
    return (x @ head).float()


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------
def label_logits(logits: torch.Tensor, labels: torch.Tensor,
                 by_mask: bool = False) -> torch.Tensor:
    """``logits[..., labels]``: (..., V) and (...) -> (...).  On a DTensor
    whose vocab dim may be sharded, or with ``by_mask``, the label's logit
    is picked by a mask and a sum over the vocab (exact: every other term
    is 0), which DTensor shards; its gather is not supported there."""
    if by_mask or local.is_dtensor(logits):
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        return torch.where(vocab == labels[..., None], logits,
                           0.0).sum(dim=-1)
    return torch.gather(logits, -1, labels[..., None].long())[..., 0]


def logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over the last (vocab) dim.  On a DTensor it is the
    vocabulary-parallel form: each rank takes the max and the sum of
    exponentials of its own vocab rows, and only (...)-shaped partial
    results cross the mesh (an all-reduce of the max, then of the sum),
    so the (..., V) logits are never gathered.  Elsewhere
    ``torch.logsumexp``."""
    if not local.is_dtensor(logits):
        return torch.logsumexp(logits, dim=-1)
    return _VocabLogSumExp.apply(logits)


class _VocabLogSumExp(torch.autograd.Function):
    """:func:`logsumexp` of DTensor logits, forward and backward on their
    vocab shards; the backward is ``torch.logsumexp``'s formula, the
    gradient times ``exp(logits - lse)``."""

    @staticmethod
    def forward(ctx, logits):
        m = logits.amax(dim=-1, keepdim=True)
        lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
        ctx.save_for_backward(logits, lse)
        return lse

    @staticmethod
    def backward(ctx, grad):
        logits, lse = ctx.saved_tensors
        return grad[..., None] * torch.exp(logits - lse[..., None])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token negative log-likelihood, masked where ``mask`` is
    given (the reference's ``cross_entropy``).  DTensor logits are
    gathered along their vocab: this path serves sequences short enough
    for whole logits (``transformer.loss_fn``), and the sharded step's
    gradients then round as the unsharded step's, which its updated
    parameters are held to; the chunked path computes on the vocab
    shards (:func:`logsumexp`)."""
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - label_logits(logits, labels)
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
