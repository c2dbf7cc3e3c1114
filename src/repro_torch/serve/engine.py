"""ServeEngine: batched prefill + interleaved decode under a region tree.

A copy of the reference's ``repro.serve.engine`` (framework-free), the
serving counterpart of its ``train.loop`` (docs/serving.md).  A
deterministic, timing-independent :class:`ServeScheduler` turns a
traffic list (``repro_torch.scenarios.traffic``) into per-step lane events
— which lane prefills which chunk, which lane decodes — and an execution
backend turns
each step's events into one 1-step :class:`RegionTrace` over the serving
region tree::

    serve
    ├── prefill        prompt chunks through the model (S = chunk)
    ├── decode         one generated token per busy lane per step
    ├── kv_append      KV-cache slot writes (VMEM_PRESSURE = occupancy)
    ├── sample         logits -> token selection
    └── moe            (MoE configs) router + expert_0..E-1 children

"Per-batch-lane leaves" are realized on the trace's *process axis*: lane
``i`` is process ``i``, exactly the SPMD mapping the analyzer's
across-process similarity analysis expects — a straggling lane is a
dissimilar process, an overloaded region a disparity, with zero analyzer
changes.  Per-step samples flow through the
``RegionTrace -> TraceSpool -> OnlineAnalyzer / FleetIngest`` stack
unchanged (``repro_torch.stream``, ``repro_torch.fleet``), so live tailing
(``python -m repro_torch.cli.watch_trace``), onset detection, verdict
fingerprints and fleet dedup all work on serving traffic.

Backends (same ``tree`` / ``region_ids`` / ``warmup()`` /
``execute(step, events)`` protocol):

* ``repro_torch.serve.runtime.TorchBackend`` — the real model on the card
  with measured walls / CPU time and analytic flops and bytes; what
  ``repro_torch.launch.serve`` runs.
* The reference's deterministic ``CostModelBackend`` (serve/cost.py) is
  not ported yet (ROADMAP.md queue 1, item 3).

Spooling and finalization mirror the reference exactly: identical meta key
order on the in-memory and spooled paths, so a finalized spool is
byte-identical to the monolithic artifact, and an artifact saved here has
the reference's header.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

from repro_torch.core import WALL_TIME, RegionTree
from repro_torch.core.trace import RegionTrace

PREFILL = "prefill"
DECODE = "decode"
KV_APPEND = "kv_append"
SAMPLE = "sample"
MOE = "moe"


def serve_region_tree(moe_experts: int = 0, name: str = "serve") -> RegionTree:
    """The serving region tree.  With ``moe_experts`` > 0 an inclusive
    ``moe`` parent (router + experts) gets one child per expert, the
    same layout the train-side expert probe uses, so hot-expert verdicts
    localize to ``serve/moe/expert_e``."""
    tree = RegionTree(name)
    tree.add(PREFILL)
    tree.add(DECODE)
    tree.add(KV_APPEND)
    tree.add(SAMPLE)
    if moe_experts:
        moe = tree.add(MOE)
        for e in range(moe_experts):
            tree.add(f"expert_{e}", parent=moe)
    return tree


@dataclasses.dataclass
class LaneEvent:
    """What one lane does on one engine step (the scheduler's output and
    the execution backends' input).  ``request`` is ``None`` for an idle
    lane; ``new_request`` tells a stateful backend to (re)initialize the
    lane's decode state."""

    lane: int
    request: Any = None          # a traffic Request (duck-typed)
    new_request: bool = False
    prefill_tokens: int = 0
    prefill_start: int = 0       # first prompt position prefilled this step
    decode_tokens: int = 0
    decode_pos: int = 0          # feed position of the decoded token
    kv_tokens: int = 0           # KV slots appended this step
    sample_tokens: int = 0
    occupancy: float = 0.0       # KV slots used / max_len, after this step
    finished: bool = False


@dataclasses.dataclass
class RequestRecord:
    """Per-request lifecycle, in engine steps."""

    rid: int
    session: Optional[int]
    hot: bool
    prompt_len: int
    gen_len: int
    arrival_step: int
    start_step: Optional[int] = None
    prefill_done_step: Optional[int] = None
    finish_step: Optional[int] = None
    lane: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _LaneState:
    request: Any
    pos: int = 0        # prompt tokens prefilled so far
    decoded: int = 0    # tokens generated so far


class ServeScheduler:
    """Deterministic logical-step scheduler — pure bookkeeping, no model
    and no clock, so every backend (and the reference's) replays the
    *same* schedule for the same traffic.

    Per step: admit arrivals, hand free lanes their next request
    (session-sticky requests to lane ``session % lanes``, sessionless
    requests shared-FIFO to the lowest free lane), then each busy lane
    either prefills the next ``min(chunk, remaining)`` prompt tokens or
    decodes one token.  A lane that finishes a request frees at the end
    of the step and picks up new work the *next* step, so one request
    occupies its lane for exactly ``ceil(P/chunk) + G`` steps."""

    def __init__(self, traffic: Sequence[Any], lanes: int,
                 prefill_chunk: int, max_len: int):
        if lanes < 1 or prefill_chunk < 1:
            raise ValueError("lanes and prefill_chunk must be >= 1")
        for r in traffic:
            if r.prompt_len + r.gen_len > max_len:
                raise ValueError(
                    f"request {r.rid}: prompt_len + gen_len "
                    f"({r.prompt_len}+{r.gen_len}) exceeds max_len {max_len}")
        self.lanes = lanes
        self.prefill_chunk = prefill_chunk
        self.max_len = max_len
        self._pending: Deque[Any] = deque(
            sorted(traffic, key=lambda r: (r.arrival_step, r.rid)))
        self._lane_q: List[Deque[Any]] = [deque() for _ in range(lanes)]
        self._shared: Deque[Any] = deque()
        self._active: List[Optional[_LaneState]] = [None] * lanes
        self.records: Dict[int, RequestRecord] = {}
        self.completed = 0

    @property
    def done(self) -> bool:
        return (not self._pending and not self._shared
                and not any(self._lane_q)
                and not any(st is not None for st in self._active))

    def _admit(self, s: int) -> None:
        while self._pending and self._pending[0].arrival_step <= s:
            r = self._pending.popleft()
            self.records[r.rid] = RequestRecord(
                rid=r.rid, session=r.session, hot=r.hot,
                prompt_len=r.prompt_len, gen_len=r.gen_len,
                arrival_step=r.arrival_step)
            if r.session is None:
                self._shared.append(r)
            else:
                self._lane_q[r.session % self.lanes].append(r)

    def step(self, s: int) -> List[LaneEvent]:
        self._admit(s)
        events: List[LaneEvent] = []
        for lane in range(self.lanes):
            if self._active[lane] is None:
                nxt = None
                if self._lane_q[lane]:
                    nxt = self._lane_q[lane].popleft()
                elif self._shared:
                    nxt = self._shared.popleft()
                if nxt is not None:
                    self._active[lane] = _LaneState(nxt)
                    rec = self.records[nxt.rid]
                    rec.start_step = s
                    rec.lane = lane
        for lane in range(self.lanes):
            st = self._active[lane]
            if st is None:
                events.append(LaneEvent(lane=lane))
                continue
            r = st.request
            ev = LaneEvent(lane=lane, request=r,
                           new_request=(st.pos == 0 and st.decoded == 0))
            if st.pos < r.prompt_len:
                k = min(self.prefill_chunk, r.prompt_len - st.pos)
                ev.prefill_tokens = k
                ev.prefill_start = st.pos
                ev.kv_tokens = k
                st.pos += k
                if st.pos == r.prompt_len:
                    self.records[r.rid].prefill_done_step = s
            else:
                ev.decode_tokens = 1
                ev.decode_pos = st.pos + st.decoded
                ev.kv_tokens = 1
                ev.sample_tokens = 1
                st.decoded += 1
            ev.occupancy = (st.pos + st.decoded) / self.max_len
            if st.decoded == r.gen_len:
                ev.finished = True
                self.records[r.rid].finish_step = s
                self._active[lane] = None
                self.completed += 1
            events.append(ev)
        return events


@dataclasses.dataclass
class ServeConfig:
    """Engine knobs (docs/serving.md)."""

    lanes: int = 4
    max_len: int = 32
    prefill_chunk: int = 8
    # None = run until the traffic drains; else a hard step cap.
    max_steps: Optional[int] = None
    # -- trace plumbing (mirrors TrainerConfig) ---------------------------
    trace_path: Optional[str] = None
    trace_spool_dir: Optional[str] = None
    trace_chunk_steps: int = 8
    trace_meta: Optional[Dict[str, Any]] = None

    def __post_init__(self) -> None:
        if self.lanes < 1:
            raise ValueError("lanes must be >= 1")
        if self.max_steps is not None and self.max_steps < 1:
            raise ValueError("max_steps must be >= 1")


class ServeEngine:
    """Drive traffic through an execution backend, one region trace row
    per engine step.

    ``step_hook(engine, step, step_trace)`` runs on each step trace
    before it is spooled/accumulated — the per-step injection seam the
    reference's serving corpus uses, mirroring its trainer's fault hooks:
    whatever the hook mutates is what a live tail of the spool sees,
    while the run is still in flight."""

    def __init__(self, scfg: ServeConfig, traffic: Sequence[Any],
                 backend: Any,
                 step_hook: Optional[Callable[["ServeEngine", int,
                                               RegionTrace], None]] = None):
        self.scfg = scfg
        self.backend = backend
        self.tree: RegionTree = backend.tree
        self.region_ids: List[int] = list(backend.region_ids)
        self.step_hook = step_hook
        self.sched = ServeScheduler(traffic, scfg.lanes, scfg.prefill_chunk,
                                    scfg.max_len)
        self.step_idx = 0
        self.wall_s = 0.0
        self.tokens_prefill = 0
        self.tokens_decode = 0
        root = self.tree.root.name
        self._wall_cols = {
            phase: self.tree.by_path(f"{root}/{phase}").region_id
            for phase in (PREFILL, DECODE, SAMPLE)}
        self._phase_wall = {phase: 0.0 for phase in self._wall_cols}
        self.trace: Optional[RegionTrace] = None
        self._step_traces: List[RegionTrace] = []
        self._last_step_trace: Optional[RegionTrace] = None
        self.spool = None
        if scfg.trace_spool_dir:
            # Lazy import: repro_torch.stream sits above the core trace
            # layer.  trace_meta rides along provisionally so a live tail
            # resolves run-level configuration (analyzer_kw) before the run
            # ends; close() replaces it with the definitive final meta.
            from repro_torch.stream import TraceSpool
            self.spool = TraceSpool(scfg.trace_spool_dir,
                                    chunk_steps=scfg.trace_chunk_steps,
                                    meta=scfg.trace_meta)

    @property
    def records(self) -> Dict[int, RequestRecord]:
        return self.sched.records

    @property
    def completed(self) -> int:
        return self.sched.completed

    def step(self) -> bool:
        """Run one engine step; False once the traffic is drained (or the
        ``max_steps`` cap is hit)."""
        if self.sched.done:
            return False
        if self.scfg.max_steps is not None \
                and self.step_idx >= self.scfg.max_steps:
            return False
        events = self.sched.step(self.step_idx)
        step_trace = self.backend.execute(self.step_idx, events)
        if self.step_hook is not None:
            self.step_hook(self, self.step_idx, step_trace)
        wall = step_trace.metric(WALL_TIME)
        for phase, rid in self._wall_cols.items():
            self._phase_wall[phase] += float(
                wall[:, :, :, step_trace.col(rid)].sum())
        for ev in events:
            self.tokens_prefill += ev.prefill_tokens
            self.tokens_decode += ev.decode_tokens
        if self.spool is not None:
            self.spool.append(step_trace)
        else:
            self._step_traces.append(step_trace)
        self._last_step_trace = step_trace
        self.step_idx += 1
        return True

    def run(self, finalize: bool = True) -> Optional[RegionTrace]:
        """Warm the backend up (excluded from all reported timing — the
        train corpus ``warmup=1`` convention), drain the traffic, then
        finalize the trace artifact."""
        self.backend.warmup()
        t0 = time.perf_counter()
        while self.step():
            pass
        self.wall_s = time.perf_counter() - t0
        if finalize:
            self.finalize_trace()
        return self.trace

    # -- artifact finalization (mirrors the reference's Trainer) -----------
    def _final_meta(self, base: Dict[str, Any]) -> Dict[str, Any]:
        """The merged artifact's header meta, built the same way (and in
        the same key order) for the in-memory and spooled paths — key
        order matters because spool finalization must reproduce the
        monolithic save byte-for-byte."""
        meta = dict(base)
        meta["collector"] = "serve"
        meta.update(self.scfg.trace_meta or {})
        meta["requests_completed"] = self.sched.completed
        meta["tokens_prefill"] = self.tokens_prefill
        meta["tokens_decode"] = self.tokens_decode
        return meta

    def finalize_trace(self) -> Optional[RegionTrace]:
        if self.spool is not None:
            if self.spool.n_steps == 0:
                return None
            if not self.spool.closed:
                self.spool.close(meta=self._final_meta(self.spool.head_meta))
            from repro_torch.stream import SpooledTrace
            self.trace = SpooledTrace(self.spool.directory).to_trace()
        else:
            if not self._step_traces:
                return None
            self.trace = RegionTrace.merge(self._step_traces)
            self.trace.meta = self._final_meta(self.trace.meta)
        if self.scfg.trace_path:
            self.trace.save(self.scfg.trace_path)
        return self.trace

    def throughput(self) -> Dict[str, float]:
        """Warmup-excluded serving throughput, prefill and decode split
        out (each phase's tokens over that phase's own region wall)."""
        pre_w = self._phase_wall[PREFILL]
        dec_w = self._phase_wall[DECODE] + self._phase_wall[SAMPLE]
        total = self.tokens_prefill + self.tokens_decode
        return {
            "wall_s": self.wall_s,
            "requests_completed": float(self.sched.completed),
            "tokens_prefill": float(self.tokens_prefill),
            "tokens_decode": float(self.tokens_decode),
            "prefill_tok_per_s": self.tokens_prefill / pre_w if pre_w else 0.0,
            "decode_tok_per_s": self.tokens_decode / dec_w if dec_w else 0.0,
            "tok_per_s": total / self.wall_s if self.wall_s else 0.0,
        }
