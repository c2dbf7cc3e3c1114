"""Deterministic, seedable serving traffic (docs/serving.md): a copy of
the reference's ``repro.scenarios.traffic``, framework-free, held to give
the same requests and prompts by tests/test_torch_serve.py.

The serving engine (``repro_torch.serve``) consumes a list of :class:`Request`
objects; this module generates them.  Two generators:

* :func:`generate_traffic` — the open-world generator: a skewed arrival
  process (exponential inter-arrivals with an optional bursty mode that
  piles requests onto the same engine step), a prompt-length *mixture*
  over length buckets with **bucketing-by-length** (a drawn raw length is
  padded up to its bucket, the t2t data_reader idiom — the engine then
  sees a handful of fixed prefill shapes instead of one compile per
  prompt), hot-prompt repetition (a fraction of requests replay one
  literal prompt), and optional sticky sessions (session id -> lane
  affinity in the engine).

* :func:`saturated_sessions` — the corpus generator: one back-to-back
  request stream per lane, rng-free, so every lane is busy on every
  engine step and per-window work is exactly balanced across lanes.
  The reference's serving corpus entries (its scenarios/corpus.py,
  backend "serving", not ported yet) are built on it: a clean baseline must be *flat* for the 0.9
  precision floor, and saturation + uniform request shapes deliver that
  by construction, the same role the balanced behaviours play for the
  synthetic backend.

Determinism: every draw comes from one ``np.random.default_rng`` seeded
from the caller's seed, consumed in a fixed per-request order — the same
(config, seed) pair always yields the same traffic, and
:func:`prompt_tokens` derives each request's literal tokens from its
``prompt_id`` alone (hot requests share one id, so repetition is literal).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

# Salt keeps traffic draws decoupled from the engine's measurement-noise
# stream at the same seed.
_TRAFFIC_SALT = 0x7AFF1C


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request, fully scheduled by construction.

    ``prompt_len`` is the *bucketed* length the engine prefills (raw_len
    padded up); ``session`` pins the request to lane ``session % lanes``
    (sticky sessions), ``None`` lets any free lane take it.  ``hot``
    marks a hot-prompt repeat: all hot requests share ``prompt_id`` and
    therefore literal tokens (and, on MoE configs, a routing profile
    concentrated on the hot expert — see the reference's serve/cost.py)."""

    rid: int
    arrival_step: int
    prompt_len: int
    gen_len: int
    raw_len: int = 0
    session: Optional[int] = None
    hot: bool = False
    prompt_id: int = -1

    def __post_init__(self) -> None:
        if self.prompt_len < 1 or self.gen_len < 1:
            raise ValueError(f"request {self.rid}: prompt_len and gen_len "
                             f"must be >= 1")


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Knobs of the open-world generator (docs/serving.md)."""

    n_requests: int = 32
    # -- arrival process --------------------------------------------------
    arrival_rate: float = 2.0     # mean new requests per engine step
    burstiness: float = 0.0       # P(request lands on the previous one's step)
    # -- prompt-length mixture + bucketing-by-length ----------------------
    length_buckets: Tuple[int, ...] = (8, 16, 32, 64)
    length_mix: Tuple[float, ...] = (0.45, 0.35, 0.15, 0.05)
    gen_len: int = 8
    gen_jitter: int = 0           # gen_len drawn from [gen_len-j, gen_len+j]
    # -- hot-prompt repetition --------------------------------------------
    hot_fraction: float = 0.0
    hot_bucket: int = 0           # bucket index the hot prompt lives in
    # -- sticky sessions ---------------------------------------------------
    sessions: int = 0             # 0 = none; else request i -> session i % n
    vocab: int = 256

    def __post_init__(self) -> None:
        if len(self.length_buckets) != len(self.length_mix):
            raise ValueError("length_mix must weight every length bucket")
        if list(self.length_buckets) != sorted(set(self.length_buckets)):
            raise ValueError("length_buckets must be strictly increasing")
        if not 0 <= self.hot_bucket < len(self.length_buckets):
            raise ValueError(f"hot_bucket {self.hot_bucket} out of range")


def generate_traffic(cfg: TrafficConfig, seed: int = 0) -> List[Request]:
    """Generate ``cfg.n_requests`` requests, sorted by (arrival, rid)."""
    rng = np.random.default_rng(seed + _TRAFFIC_SALT)
    buckets = cfg.length_buckets
    mix = np.asarray(cfg.length_mix, dtype=np.float64)
    mix = mix / mix.sum()
    out: List[Request] = []
    t = 0.0
    step = 0
    for rid in range(cfg.n_requests):
        # Fixed per-request draw order keeps the stream deterministic no
        # matter which knobs are active: arrival, hot, bucket, raw, gen.
        gap = rng.exponential(1.0 / max(cfg.arrival_rate, 1e-9))
        burst = rng.random() < cfg.burstiness
        hot = rng.random() < cfg.hot_fraction
        b = int(rng.choice(len(buckets), p=mix))
        lo = 1 if b == 0 else buckets[b - 1] + 1
        raw = int(rng.integers(lo, buckets[b] + 1))
        gj = (int(rng.integers(-cfg.gen_jitter, cfg.gen_jitter + 1))
              if cfg.gen_jitter else 0)
        if rid > 0 and not burst:
            t += gap
            step = int(t)
        if hot:
            b = cfg.hot_bucket
            raw = buckets[b]
        out.append(Request(
            rid=rid, arrival_step=step,
            prompt_len=buckets[b],           # bucketing-by-length: pad up
            raw_len=raw,
            gen_len=max(1, cfg.gen_len + gj),
            session=(rid % cfg.sessions) if cfg.sessions else None,
            hot=hot,
            prompt_id=(-1 if hot else rid)))
    return sorted(out, key=lambda r: (r.arrival_step, r.rid))


def saturated_sessions(lanes: int, requests_per_lane: int,
                       prompt_len: int = 16, gen_len: int = 6,
                       tail_lane: Optional[int] = None,
                       tail_prompt_len: int = 64, tail_gen_len: int = 24,
                       stagger: int = 0, hot: bool = False) -> List[Request]:
    """Rng-free corpus traffic: one sticky session per lane, every lane
    fed back-to-back identical requests (arrival 0 — the per-session
    queue keeps the lane saturated).

    ``tail_lane`` turns that lane's session into a long-tail stream
    (``tail_prompt_len``/``tail_gen_len``) — pick the tail shape so the
    per-window decode/KV/sample token rates still match the other lanes
    and only the prefill *cost* differs (the long-tail corpus entry
    does).  ``stagger`` delays session ``i``'s availability to step
    ``i * stagger``, de-synchronizing lane phases so prefill and decode
    genuinely interleave across lanes.  ``hot=True`` marks every request
    a hot-prompt repeat (the skewed-mix MoE entries)."""
    out: List[Request] = []
    rid = 0
    for lane in range(lanes):
        tail = tail_lane is not None and lane == tail_lane
        for k in range(requests_per_lane):
            out.append(Request(
                rid=rid, arrival_step=lane * stagger,
                prompt_len=tail_prompt_len if tail else prompt_len,
                raw_len=tail_prompt_len if tail else prompt_len,
                gen_len=tail_gen_len if tail else gen_len,
                session=lane, hot=hot,
                prompt_id=(-1 if hot else rid)))
            rid += 1
    return sorted(out, key=lambda r: (r.arrival_step, r.rid))


def prompt_tokens(req: Request, vocab: int, seed: int = 0) -> np.ndarray:
    """The request's literal prompt, ``(1, prompt_len)`` int32.

    Derived from ``prompt_id`` alone (plus the run seed), so hot requests
    replay one identical prompt — repetition the KV/prefix layers of a
    real server would exploit, and the routing skew the MoE cost model
    keys on."""
    rng = np.random.default_rng(seed + _TRAFFIC_SALT + 7919 * (req.prompt_id + 2))
    return rng.integers(0, vocab, size=(1, req.prompt_len), dtype=np.int32)
