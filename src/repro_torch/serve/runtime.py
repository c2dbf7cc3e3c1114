"""TorchBackend: the serving engine's real-model execution backend.

The twin of the reference's ``repro.serve.runtime.JitBackend``.  It runs
the shared :class:`~repro_torch.serve.engine.ServeScheduler` schedule
through the port's model on its device: per-lane batch-1 decode states
(the KV cache's ring index is shared across a batch, so lanes at
different positions cannot share one batched state) and true chunked
prefill on the families whose attention cache accepts S > 1 writes
(``supports_chunk``: the dense-block families), one token per call on
the others (ssm, hybrid, encdec).  An encdec request is encoded once, when
it arrives, from the frames ``embeds_fn(request)`` gives, outside any
timed region, as the reference does; the other families take no frames
(the reference's serving gives a vlm no images).  On the card every model
call goes through the hand-written kernels: RMSNorm, and attention (every
family but ssm, MLA included) or WKV-6 (ssm).

Measurement follows the reference: perf_counter walls around each call,
ended by ``torch.cuda.synchronize`` on the card (the reference's
``block_until_ready``), and the calibrated CPU clock of
``repro_torch.core.collector`` (``cpu_tick``/``cpu_clock``/``derived``
ride in the header meta so ``RegionTrace.reduce`` replays the
quantization snap offline).  FLOPs and bytes per call shape come from an
analytic count of the model (:func:`call_costs`) in place of the
reference's HLO cost analysis: a FLOP counter cannot see a kernel called
through ctypes.  :meth:`TorchBackend.warmup` makes one untimed call per
steady-state shape, ``(1, chunk)`` and ``(1, 1)`` (the train corpus
``warmup=1`` convention); for encdec on a state encoded from zero frames
(the reference skips the warmup there only because it compiles a decode
call per encoded state).

``kv_append`` records quantities rather than time: the KV write happens
inside the model call, so the region carries the appended bytes
(slots x 2 x n_layers x n_kv_heads x head_dim x dtype) and the lane's
cache occupancy as VMEM_PRESSURE, with zero wall — the signals the
reference's KV archetypes condition on.  ``sample`` is a separately timed
argmax.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import (BYTES, CPU_TIME, FLOPS, RAW_METRICS,
                              VMEM_PRESSURE, WALL_TIME)
from repro_torch.core.collector import _pick_cpu_clock
from repro_torch.core.trace import RegionTrace
from repro_torch.models import ModelApi, moe, rglru, rwkv
from repro_torch.models.transformer import hybrid_pattern
from repro_torch.scenarios.traffic import prompt_tokens

from .engine import DECODE, KV_APPEND, PREFILL, SAMPLE, LaneEvent, \
    serve_region_tree

CHUNK_FAMILIES = ("dense", "moe", "vlm", "audio")


def supports_chunk(cfg) -> bool:
    """True when the family's attention cache accepts multi-token
    (S > 1) writes, i.e. true chunked prefill works."""
    return cfg.family in CHUNK_FAMILIES


def call_costs(cfg, tokens: int, cache_slots: int, weight_bytes: int,
               enc_len: int = 0) -> Tuple[float, float]:
    """Analytic (flops, bytes) of one batch-1 model call on ``tokens``
    tokens against a ``cache_slots``-slot KV cache, with ``weight_bytes``
    the bytes of the model's parameters (each read once per call).

    With S = tokens, K = cache_slots, L layers, width d, H query and KV key
    heads of size dh, MLP width ff, vocabulary V and activation itemsize a,
    the dense family:

        flops = 2·S·L·(d·H·dh + 2·d·KV·dh + H·dh·d + 3·d·ff)   projections, MLP
              + 4·S·K·H·dh·L                                     scores and P·V
              + 2·S·d·V                                          logits
        bytes = weight_bytes                   every weight read once
              + 2·L·K·KV·dh·a                  the KV cache read
              + 2·L·S·KV·dh·a                  the new KV slots written
              + 4·S·V                          float32 logits written

    The attention term counts every cache slot, masked or not, because the
    kernel scores them all.  The moe family replaces each layer's MLP term
    2·S·3·d·ff by its router, its experts as the port computes them (every
    expert over its C = max(ceil(S·k/E·capacity_factor), 1) slots, filled
    or not: one group of S tokens at batch 1) and its shared experts, with
    E experts of width f (``moe.d_ff``), top k, n_s shared:

        2·S·d·E  +  3·2·E·C·d·f  +  3·2·S·d·f·n_s

    An MLA config (latent rank r, rope dims ρ, nope dims n, v dims w; qd
    = n + ρ) replaces each layer's attention projections and scores by

        2·S·(d·H·qd + d·(r + ρ) + H·w·d)      wq, wkv_a, wo
      + 2·K·r·H·(n + w)                       every cache slot decompressed
      + 4·S·K·H·qd                            scores and P·V (v padded to qd)

    and the KV cache's bytes by the latent's, L·K·(r + ρ)·a read and
    L·S·(r + ρ)·a written.  The ssm family (RWKV-6, H heads of dh, the
    decay lora of rank 64; K is not used):

        flops = 2·S·L·(6·d² + 2·64·d + 2·d·ff)   r, k, v, g, o, cr; lora; ck, cv
              + 7·S·L·H·dh²                      the WKV recurrence
              + 2·S·d·V                          logits
        bytes = weight_bytes + 2·L·H·dh²·4       the float32 state read, written
              + 4·S·V

    The recurrence is counted as the kernel computes it, 7·dh² per (token,
    head); the function needs 5·dh² (chip_smoke.py's bound counts that).
    The hybrid family (L_r RG-LRU sublayers of width w and conv width c,
    L_a attention sublayers, an MLP in each of the L):

        flops = 2·S·L_r·(2·d·w + 2·w²)            w_in, w_out; w_a, w_x
              + 2·S·L_r·c·w + 2·S·L_r·w           the conv; the recurrence
              + L_a·(the attention term above) + 2·S·L·3·d·ff + 2·S·d·V
        bytes = weight_bytes + the L_a layers' KV cache read and written
              + 2·L_r·((c − 1)·w·a + 4·w)         conv carry, float32 h
              + 4·S·V

    The encdec family's decoder call (its L layers each a causal
    self-attention over K slots and a cross-attention over T_enc =
    ``enc_len`` frames whose K/V were computed at the request's encode):

        flops = L·(the attention term above                 self-attention
                   + 2·S·(d·H·dh + H·dh·d) + 4·S·T_enc·H·dh  wq, wo; cross
                   + 2·S·3·d·ff) + 2·S·d·V
        bytes = weight_bytes + the self-attention cache read and written
              + 2·L·T_enc·KV·dh·a                 the cross K/V read
              + 4·S·V

    with ``weight_bytes`` the decoder's weights and the embedding only
    (:func:`decode_weight_bytes`).
    Norms, rope, the dispatch and elementwise work are left out.  These
    are not expected to equal the reference's numbers, which come from
    XLA's cost analysis of the compiled program.
    """
    S, K, L = tokens, cache_slots, cfg.n_layers
    d, V = cfg.d_model, cfg.vocab
    if cfg.family == "ssm":
        H, dh = rwkv.heads(cfg)
        flops = (2 * S * L * (6 * d * d + 2 * rwkv.LORA * d
                              + 2 * d * cfg.d_ff)
                 + 7 * S * L * H * dh * dh + 2 * S * d * V)
        nbytes = weight_bytes + 2 * L * H * dh * dh * 4 + 4 * S * V
        return float(flops), float(nbytes)
    H, KV = cfg.n_heads, cfg.n_kv_heads
    dh, ff = cfg.resolved_head_dim, cfg.d_ff
    a = torch.empty((), dtype=cfg.activation_dtype()).element_size()
    if cfg.mla is not None:
        m = cfg.mla
        r, qd = m.kv_lora_rank + m.rope_head_dim, \
            m.nope_head_dim + m.rope_head_dim
        attn = (2 * S * (d * H * qd + d * r + H * m.v_head_dim * d)
                + 2 * K * m.kv_lora_rank * H * (m.nope_head_dim
                                                + m.v_head_dim)
                + 4 * S * K * H * qd)
        cache = L * K * r * a + L * S * r * a
    else:
        attn = (2 * S * (d * H * dh + 2 * d * KV * dh + H * dh * d)
                + 4 * S * K * H * dh)
        cache = L * (2 * K * KV * dh * a + 2 * S * KV * dh * a)
    mlp = 2 * S * 3 * d * ff
    if cfg.family == "hybrid":
        n_blocks, tail = hybrid_pattern(cfg)
        kinds = list(cfg.recurrent.block_pattern) * n_blocks + list(tail)
        n_rec = kinds.count("rec")
        n_att = L - n_rec
        w, c = rglru.width(cfg), cfg.recurrent.conv_width
        rec = 2 * S * (2 * d * w + 2 * w * w) + 2 * S * c * w + 2 * S * w
        flops = n_rec * rec + n_att * attn + L * mlp + 2 * S * d * V
        nbytes = (weight_bytes + cache // L * n_att   # attention layers only
                  + 2 * n_rec * ((c - 1) * w * a + 4 * w) + 4 * S * V)
        return float(flops), float(nbytes)
    if cfg.family == "encdec":
        cross = 2 * S * (d * H * dh + H * dh * d) + 4 * S * enc_len * H * dh
        flops = L * (attn + cross + mlp) + 2 * S * d * V
        nbytes = (weight_bytes + cache + 2 * L * enc_len * KV * dh * a
                  + 4 * S * V)
        return float(flops), float(nbytes)
    if cfg.moe is not None:
        mo = cfg.moe
        f, E = mo.d_ff, mo.n_experts
        ffn = (2 * S * d * E + 3 * 2 * E * moe.capacity_of(cfg, S) * d * f
               + 3 * 2 * S * d * f * mo.n_shared)
    else:
        ffn = mlp
    flops = L * (attn + ffn) + 2 * S * d * V
    nbytes = weight_bytes + cache + 4 * S * V
    return float(flops), float(nbytes)


def decode_weight_bytes(cfg, model: torch.nn.Module) -> int:
    """Bytes of the parameters one decode call reads: all of them but the
    vlm's ``vis_proj`` (serving takes no images) and, for the encdec
    family, the encoder's and the cross-attention's ``wk`` and ``wv``
    (read once a request, at its encode).  Counted from the model:
    ``cfg.param_count()`` under-counts the ssm and hybrid families and
    leaves out ``vis_proj``, as the reference's does."""
    def read(name: str) -> bool:
        return name != "vis_proj" and (cfg.family != "encdec" or not (
            name.startswith("enc_") or ".cross_attn.wk" in name
            or ".cross_attn.wv" in name))
    return sum(p.numel() * p.element_size()
               for name, p in model.named_parameters() if read(name))


def sample_costs(cfg) -> Tuple[float, float]:
    """Analytic (flops, bytes) of the argmax over one row of float32
    logits: V comparisons, 4·V bytes read and the token written."""
    return float(cfg.vocab), float(4 * cfg.vocab + 4)


class TorchBackend:
    """Execute lane events against the port's model, measured."""

    _cpu_clock: Optional[Tuple[Callable[[], float], Optional[float], str]] \
        = None

    def __init__(self, cfg, api: ModelApi, model: torch.nn.Module,
                 lanes: int, max_len: int, prefill_chunk: int,
                 seed: int = 0,
                 embeds_fn: Optional[Callable[[Any], torch.Tensor]] = None):
        if prefill_chunk > 1 and not supports_chunk(cfg):
            raise ValueError(
                f"family {cfg.family!r} has a per-token decode cache; "
                f"use prefill_chunk=1")
        if cfg.family == "encdec" and embeds_fn is None:
            raise ValueError("the encdec family encodes each request's "
                             "frames: pass embeds_fn")
        self.cfg = cfg
        self.api = api
        self.model = model
        self.device = api.device
        self.lanes = lanes
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.seed = seed
        self.embeds_fn = embeds_fn
        self.tree = serve_region_tree()
        self.region_ids = [r.region_id for r in self.tree.regions()]
        root = self.tree.root.name
        self._rid = {p: self.tree.by_path(f"{root}/{p}").region_id
                     for p in (PREFILL, DECODE, KV_APPEND, SAMPLE)}
        # Per-lane decode state.
        self._state: List[Any] = [None] * lanes
        self._pending_logits: List[Optional[torch.Tensor]] = [None] * lanes
        self._prompt: List[Optional[np.ndarray]] = [None] * lanes
        self.outputs: Dict[int, List[int]] = {}
        self.model_calls = 0       # decode_step calls, warmup included
        self.encode_calls = 0      # encdec encodes, warmup included
        self.weight_bytes = decode_weight_bytes(cfg, model)
        self.enc_len = cfg.frontend_tokens if cfg.family == "encdec" else 0
        # A window caps the cache's slots (layers.init_attention_cache).
        self.cache_slots = max_len if cfg.window is None \
            else min(max_len, cfg.window)
        # The reference's formula, for every attention family: it
        # over-counts an MLA cache (which holds r + rope values a token and
        # layer) and a hybrid's (whose recurrent layers hold no cache), but
        # the served trace carries the reference's numbers.
        self.kv_bytes_per_token = (
            2 * cfg.n_layers * cfg.n_kv_heads * cfg.resolved_head_dim
            * torch.empty((), dtype=cfg.activation_dtype()).element_size())
        if TorchBackend._cpu_clock is None:
            TorchBackend._cpu_clock = _pick_cpu_clock()
        self._clock, self._tick, self._clock_name = TorchBackend._cpu_clock

    # -- model calls -------------------------------------------------------
    def _decode(self, state, tokens: torch.Tensor, pos):
        self.model_calls += 1
        return self.api.decode_step(self.model, state, tokens, pos)

    def fresh_state(self, embeds: Optional[torch.Tensor] = None):
        """A new lane's decode state; for encdec encoded from ``embeds``
        (1, T_enc, d) (None: zero frames), its cross K/V computed once."""
        if self.cfg.family != "encdec":
            return self.api.init_decode_state(1, self.max_len)
        if embeds is None:
            embeds = torch.zeros((1, self.enc_len, self.cfg.d_model),
                                 device=self.device)
        self.encode_calls += 1
        with torch.no_grad():
            enc_out = self.model.encode(embeds.to(self.device))
        return self.api.init_decode_state(1, self.max_len, model=self.model,
                                          enc_out=enc_out)

    @staticmethod
    def _sample(logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)

    def _positions(self, start: int, k: int):
        if k == 1:
            return start
        return torch.arange(start, start + k, dtype=torch.int32,
                            device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        """One untimed call per steady-state shape, on a throwaway state,
        and one sample — excluded from every reported timing."""
        shapes = {1}
        if self.prefill_chunk > 1:
            shapes.add(self.prefill_chunk)
        logits = None
        for k in sorted(shapes):
            state = self.fresh_state()
            toks = torch.zeros((1, k), dtype=torch.int32, device=self.device)
            logits, _ = self._decode(state, toks, self._positions(0, k))
        self._sample(logits)
        self._sync()

    # -- execution ---------------------------------------------------------
    def _timed(self, fn, *args):
        t0w = time.perf_counter()
        t0c = self._clock()
        out = fn(*args)
        self._sync()
        return out, time.perf_counter() - t0w, self._clock() - t0c

    def execute(self, s: int, events: Sequence[LaneEvent]) -> RegionTrace:
        tr = RegionTrace.for_tree(
            self.tree, self.region_ids, self.lanes, n_steps=1,
            metrics=RAW_METRICS,
            meta={"collector": "serve", "cpu_tick": self._tick,
                  "cpu_clock": self._clock_name, "derived": True})
        for ev in events:
            if ev.request is None:
                continue
            lane, req = ev.lane, ev.request
            if ev.new_request:
                self._state[lane] = self.fresh_state(
                    self.embeds_fn(req) if self.cfg.family == "encdec"
                    else None)
                self._pending_logits[lane] = None
                self._prompt[lane] = prompt_tokens(req, self.cfg.vocab,
                                                   self.seed)
                self.outputs.setdefault(req.rid, [])
            if ev.prefill_tokens:
                a, k = ev.prefill_start, ev.prefill_tokens
                toks = torch.as_tensor(self._prompt[lane][:, a:a + k],
                                       device=self.device)
                fl, by = call_costs(self.cfg, k, self.cache_slots,
                                    self.weight_bytes, self.enc_len)
                (logits, _), dw, dc = self._timed(
                    self._decode, self._state[lane], toks,
                    self._positions(a, k))
                if a + k == req.prompt_len:
                    self._pending_logits[lane] = logits
                self._write(tr, PREFILL, lane, dw, dc, fl, by)
            if ev.decode_tokens:
                # Sample the pending logits (its own timed region), then
                # feed the sampled token to produce the next logits.
                tok, dw, dc = self._timed(self._sample,
                                          self._pending_logits[lane])
                self._write(tr, SAMPLE, lane, dw, dc, *sample_costs(self.cfg))
                self.outputs[req.rid].append(int(tok[0, 0]))
                fl, by = call_costs(self.cfg, 1, self.cache_slots,
                                    self.weight_bytes, self.enc_len)
                (logits, _), dw, dc = self._timed(
                    self._decode, self._state[lane], tok, ev.decode_pos)
                self._pending_logits[lane] = logits
                self._write(tr, DECODE, lane, dw, dc, fl, by)
            if ev.kv_tokens:
                # The KV write happens inside the model call, so this
                # region carries quantities, not time: appended bytes and
                # cache occupancy.
                j = tr.col(self._rid[KV_APPEND])
                tr.metric(BYTES)[0, 0, lane, j] = \
                    ev.kv_tokens * self.kv_bytes_per_token
                tr.metric(VMEM_PRESSURE)[0, 0, lane, j] = ev.occupancy
            if ev.finished:
                self._state[lane] = None
                self._pending_logits[lane] = None
                self._prompt[lane] = None
        return tr

    def _write(self, tr: RegionTrace, phase: str, lane: int,
               wall: float, cpu: float, fl: float, by: float) -> None:
        j = tr.col(self._rid[phase])
        tr.metric(WALL_TIME)[0, 0, lane, j] += wall
        tr.metric(CPU_TIME)[0, 0, lane, j] += cpu
        tr.metric(FLOPS)[0, 0, lane, j] += fl
        tr.metric(BYTES)[0, 0, lane, j] += by
