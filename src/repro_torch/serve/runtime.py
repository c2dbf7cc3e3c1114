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

The compiled decode call.  The reference jits ``decode_step`` and its
warmup compiles each steady-state shape once.  Here each lane owns one
decode state for the backend's life, allocated once (a new request
resets it in place), and each (lane, call shape) a :class:`DecodeCall`:
static token and position tensors, and on the card a CUDA graph captured
over one call on the lane's state.  A call writes its tokens and
positions into those tensors and replays the graph.  The graphs of the
steady-state shapes, ``(1, chunk)`` and ``(1, 1)``, are captured at
:meth:`TorchBackend.warmup`; another shape (a shorter last prefill
chunk) on its first use, before its timed window opens.  A graph reads
the addresses it was captured with, so a model's decode path must write
every state tensor in place and rebind none, take its positions from
the tensor it is given, read no host value and copy nothing to the host
(a sync inside a capture is an error).  A capture or replay that fails
raises with the lane, the shape and CUDA's error: nothing falls back to
eager calls.  On the CPU there are no graphs: the same lane states and
static inputs are used, and the model is called on them, so the CPU tests
hold the in-place, fixed-address discipline.

Measurement follows the reference: perf_counter walls around each call,
ended by ``torch.cuda.synchronize`` on the card (the reference's
``block_until_ready``), and the calibrated CPU clock of
``repro_torch.core.collector`` (``cpu_tick``/``cpu_clock``/``derived``
ride in the header meta so ``RegionTrace.reduce`` replays the
quantization snap offline).  FLOPs and bytes per call shape come from an
analytic count of the model (:func:`call_costs`) in place of the
reference's HLO cost analysis: a FLOP counter cannot see a kernel called
through ctypes.  The timed window of a call holds the writes of its
inputs, the replay and the sync.

``kv_append`` records quantities rather than time: the KV write happens
inside the model call, so the region carries the appended bytes
(slots x 2 x n_layers x n_kv_heads x head_dim x dtype) and the lane's
cache occupancy as VMEM_PRESSURE, with zero wall — the signals the
reference's KV archetypes condition on.  ``sample`` is a separately timed
argmax.
"""
from __future__ import annotations

import dataclasses
import time
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

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


def state_tensors(state) -> Iterator[torch.Tensor]:
    """The tensors of a decode state (nested dicts and lists), in order."""
    if isinstance(state, dict):
        state = state.values()
    if isinstance(state, torch.Tensor):
        yield state
        return
    for item in state:
        yield from state_tensors(item)


@dataclasses.dataclass
class DecodeCall:
    """One lane's model call of one shape (1, k): its static inputs, the
    tokens (1, k) and positions (k,) int32 that each call fills, and on the
    card the CUDA graph captured over the call with its static logits (1,
    k, V) (in the graph's own memory pool, which no other graph's replay
    writes) and the kernel launches a replay makes."""

    lane: int
    k: int
    tokens: torch.Tensor
    positions: torch.Tensor
    graph: Optional[torch.cuda.CUDAGraph] = None
    logits: Optional[torch.Tensor] = None
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)


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
        self.outputs: Dict[int, List[int]] = {}
        self.model_calls = 0       # model calls (replays), warmup included
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
        # Per-lane decode state, allocated once and owned for the
        # backend's life: a new request resets its lane's tensors in place
        # to the initial values kept in ``_initial``.
        self._graphed = self.device.type == "cuda"
        self._initial = self._new_state()
        self._state: List[Any] = [self._new_state() for _ in range(lanes)]
        self._calls: Dict[Tuple[int, int], DecodeCall] = {}
        self._warm: set = set()    # shapes called eagerly before a capture
        self._pending_logits: List[Optional[torch.Tensor]] = [None] * lanes
        self._prompt: List[Optional[np.ndarray]] = [None] * lanes

    # -- state ---------------------------------------------------------------
    def _new_state(self):
        """A new batch-1 decode state (an encdec's cross K/V zeros of
        ``enc_len`` frames)."""
        kw = {"enc_len": self.enc_len} if self.cfg.family == "encdec" else {}
        return self.api.init_decode_state(1, self.max_len, **kw)

    def _encode(self, embeds: Optional[torch.Tensor]) -> torch.Tensor:
        """The encoder's output of ``embeds`` (1, T_enc, d) (None: zero
        frames): one encode."""
        if embeds is None:
            embeds = torch.zeros((1, self.enc_len, self.cfg.d_model),
                                 device=self.device)
        self.encode_calls += 1
        with torch.no_grad():
            return self.model.encode(embeds.to(self.device))

    def _set_cross(self, state, enc_out: torch.Tensor) -> None:
        """Copy the cross K/V of ``enc_out`` into ``state``'s buffers."""
        with torch.no_grad():
            for layer, k, v in zip(self.model.dec_layers, state["cross_k"],
                                   state["cross_v"]):
                ck, cv = layer.cross_kv(enc_out)
                k.copy_(ck)
                v.copy_(cv)

    def fresh_state(self, embeds: Optional[torch.Tensor] = None,
                    lane: Optional[int] = None):
        """Lane ``lane``'s decode state reset in place to the values
        ``init_decode_state`` gives, every tensor at its address, and
        returned; for encdec its cross K/V those of ``embeds`` (1, T_enc,
        d) (None: zero frames), encoded once here.  Without ``lane``, a new
        state of the same values that no lane owns."""
        if lane is None:
            state = self._new_state()
        else:
            state = self._state[lane]
            for t, t0 in zip(state_tensors(state),
                             state_tensors(self._initial)):
                t.copy_(t0)
        if self.cfg.family == "encdec":
            self._set_cross(state, self._encode(embeds))
        return state

    # -- model calls -------------------------------------------------------
    def _decode(self, state, tokens: torch.Tensor, pos):
        self.model_calls += 1
        return self.api.decode_step(self.model, state, tokens, pos)

    def _warm_up(self, k: int) -> torch.Tensor:
        """One eager call of shape (1, k) on a scratch state, counted as a
        model call; on the card on a side stream, as PyTorch asks before a
        capture (kernel libraries load and cuBLAS sets up its workspace
        outside it).  Returns its logits."""
        state = self._new_state()
        toks = torch.zeros((1, k), dtype=torch.int32, device=self.device)
        pos = torch.arange(k, dtype=torch.int32, device=self.device)
        self._warm.add(k)
        if not self._graphed:
            return self._decode(state, toks, pos)[0]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            logits = self._decode(state, toks, pos)[0]
        torch.cuda.current_stream(self.device).wait_stream(side)
        return logits

    def _capture(self, call: DecodeCall) -> None:
        """Capture ``call``'s graph over its lane's state and static
        inputs, in a memory pool of its own.  The wrappers count their
        launches in Python as the capture runs them, but a capture launches
        nothing: the count is taken off the launch counter and kept, and
        each replay adds it back.  A failed capture raises, naming the lane
        and the shape; nothing falls back to eager calls."""
        from repro_torch import kernels as K
        before = dict(K.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                logits, _ = self.api.decode_step(
                    self.model, self._state[call.lane], call.tokens,
                    call.positions)
        except RuntimeError as err:
            raise RuntimeError(
                f"capturing lane {call.lane}'s decode call of shape (1, "
                f"{call.k}) failed: {err}") from err
        finally:
            launched = {n: K.LAUNCHES[n] - before[n] for n in before}
            K.LAUNCHES.update(before)
        call.graph, call.logits = graph, logits
        call.launches = {n: c for n, c in launched.items() if c}

    def prepare(self, lane: int, k: int) -> DecodeCall:
        """Lane ``lane``'s call of shape (1, k), made ready on its first
        use: its static inputs and, on the card, its graph, captured after
        one eager call of the shape (:meth:`_warm_up`, once a shape).  The
        serving loop calls this before a call's timed window opens."""
        call = self._calls.get((lane, k))
        if call is None:
            call = DecodeCall(
                lane, k,
                torch.zeros((1, k), dtype=torch.int32, device=self.device),
                torch.zeros((k,), dtype=torch.int32, device=self.device))
            if self._graphed:
                if k not in self._warm:
                    self._warm_up(k)
                self._capture(call)
            self._calls[(lane, k)] = call
        return call

    def _run(self, call: DecodeCall, tokens, start: int) -> torch.Tensor:
        """One model call: ``tokens`` (1, k) (a host array or a device
        tensor) and the positions start..start + k - 1 written into the
        call's static inputs, then its graph replayed (on the CPU: the
        model called on them).  Returns the logits (1, k, V), on the card
        the graph's static output, valid until this lane's next call of
        this shape."""
        from repro_torch import kernels as K
        call.tokens.copy_(torch.as_tensor(tokens))
        torch.arange(start, start + call.k, out=call.positions)
        self.model_calls += 1
        if call.graph is None:
            call.logits, _ = self.api.decode_step(
                self.model, self._state[call.lane], call.tokens,
                call.positions)
            return call.logits
        try:
            call.graph.replay()
        except RuntimeError as err:
            raise RuntimeError(
                f"replaying lane {call.lane}'s decode graph of shape (1, "
                f"{call.k}) failed: {err}") from err
        for name, n in call.launches.items():
            K.LAUNCHES[name] += n
        return call.logits

    def model_call(self, lane: int, tokens, start: int) -> torch.Tensor:
        """One untimed model call on lane ``lane``'s state (see
        :meth:`_run`), its shape made ready first."""
        return self._run(self.prepare(lane, tokens.shape[1]), tokens, start)

    @staticmethod
    def _sample(logits: torch.Tensor) -> torch.Tensor:
        """The greedy token (1, 1) int32 of the last position: one eager
        argmax, as the reference jits its sampler apart from the decode
        call; a graph of one kernel would save nothing."""
        return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        """Make the steady-state shapes ready outside every timed region,
        (1, 1) and, with chunked prefill, (1, chunk) (the reference
        compiles these two): one eager call of each shape on a scratch
        state, then each lane's call of it (:meth:`prepare`: on the card
        its graph captured), then one sample.  An encdec backend encodes
        zero frames once, and their cross K/V become every lane's first
        state."""
        if self.cfg.family == "encdec":
            enc_out = self._encode(None)
            for state in self._state:
                self._set_cross(state, enc_out)
        shapes = {1}
        if self.prefill_chunk > 1:
            shapes.add(self.prefill_chunk)
        logits = None
        for k in sorted(shapes):
            logits = self._warm_up(k)
            for lane in range(self.lanes):
                self.prepare(lane, k)
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
                self.fresh_state(self.embeds_fn(req)
                                 if self.cfg.family == "encdec" else None,
                                 lane=lane)
                self._pending_logits[lane] = None
                self._prompt[lane] = prompt_tokens(req, self.cfg.vocab,
                                                   self.seed)
                self.outputs.setdefault(req.rid, [])
            if ev.prefill_tokens:
                a, k = ev.prefill_start, ev.prefill_tokens
                call = self.prepare(lane, k)    # a new shape: captured
                fl, by = call_costs(self.cfg, k, self.cache_slots,
                                    self.weight_bytes, self.enc_len)
                logits, dw, dc = self._timed(
                    self._run, call, self._prompt[lane][:, a:a + k], a)
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
                call = self.prepare(lane, 1)
                fl, by = call_costs(self.cfg, 1, self.cache_slots,
                                    self.weight_bytes, self.enc_len)
                logits, dw, dc = self._timed(self._run, call, tok,
                                             ev.decode_pos)
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
            if ev.finished:     # the lane keeps its state's tensors
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
