"""Deterministic infrastructure chaos: fault archetypes for the pipeline
*itself*.

The PyTorch port of the reference's ``repro/scenarios/chaos.py``: the
spool, checkpoint and fleet archetypes, their collectors,
:class:`ChaosTruth` and :class:`ChaosOutcome`.

``faults.py`` injects performance faults into the programs we analyze;
this module injects **infrastructure** faults into the analysis pipeline
— the spool writer, the checkpoint writer, the live consumer, the
fleet's tenants — and the
chaos corpus backends (``scenarios/corpus.py``, backends ``chaos`` and
``fleet``) score whether the robustness machinery holds its contract:

* the pipeline *survives* (no uncaught exception),
* intact data is salvaged and corruption is *quarantined* — moved aside
  and logged, never silently dropped,
* post-recovery window verdicts are **bit-identical** to a clean run of
  the same scenario on every window the fault did not touch.

Every archetype is deterministic and seedable: crashes land on named
:mod:`repro_torch.core.faultpoints` seams (not timers), and byte-level
corruption draws offsets from ``np.random.default_rng(seed)`` — the CI
chaos gate replays seeds {0, 1, 7} and must get the same recovery every
time.  Every analyzer here is the port's, on the lane ``analyzer_kw``
names (the corpus passes its overrides, e.g. ``device``, through it).

Archetypes
----------
``KillProducerMidChunk``   producer dies at a chosen write/rename
                           boundary inside a chosen segment flush
``StallProducer``          producer goes silent mid-run without closing
                           (consumer must detect the stall, then recover)
``TruncateSegment``        a flushed segment loses its tail on disk
``FlipBytesInSegment``     silent bit rot inside a flushed segment
``CorruptLatestCheckpoint``the newest checkpoint's payload is damaged
                           (restore must fall back to a verified step)

Fleet archetypes (``repro_torch.fleet``, corpus backend ``fleet``) —
the fault lands on one (or two) of many concurrent runs and the contract
widens to *isolation*: every unaffected run's per-window verdicts must be
bit-identical to a solo tail of the same spool, while the affected runs
degrade or quarantine with structured events:

``FleetConcurrentKill``    two producers die mid-flush at different
                           seams; stall detection + spool recovery drain
                           their salvageable tails, siblings unperturbed
``FleetTenantCorruption``  one tenant's segments rot in two waves; the
                           first wave degrades windows, the second trips
                           the circuit breaker and quarantines the run
``FleetAnalysisLagFlood``  one run produces faster than the shared
                           worker pool drains; its bounded queue sheds
                           oldest-first, siblings never shed
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import Verdict
from repro_torch.core.faultpoints import InjectedCrash, armed
from repro_torch.core.trace import RegionTrace
from repro_torch.fleet import FleetConfig, FleetIngest, VerdictIndex
from repro_torch.stream import (OnlineAnalyzer, ProducerStalledError,
                                SpooledTrace, TraceSpool)
from repro_torch.train import checkpoint as ckpt_mod

# -- archetypes -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KillProducerMidChunk:
    """The producer process dies at fault point ``point`` while flushing
    segment ``kill_segment`` (0-based).  ``spool.segment.written`` leaves
    a torn ``.tmp`` to quarantine; ``spool.segment.renamed`` leaves a
    fully-written orphan segment for recovery to *adopt*."""

    kill_segment: int = 2
    point: str = "spool.segment.written"


@dataclasses.dataclass(frozen=True)
class StallProducer:
    """The producer stops appending after ``segments`` flushed segments
    and never closes the spool — the live consumer must bound its wait
    (:class:`repro_torch.stream.StallDetector`) instead of tailing forever."""

    segments: int = 2


@dataclasses.dataclass(frozen=True)
class TruncateSegment:
    """Segment ``segment`` is truncated to a seeded fraction of its bytes
    (torn write surfacing only at read time — e.g. a lost NFS flush)."""

    segment: int = 1


@dataclasses.dataclass(frozen=True)
class FlipBytesInSegment:
    """``n_flips`` bytes of segment ``segment`` are inverted at seeded
    offsets: silent bit rot the length check cannot see — only the
    manifest's sha256 record catches it."""

    segment: int = 1
    n_flips: int = 8


@dataclasses.dataclass(frozen=True)
class CorruptLatestCheckpoint:
    """``n_flips`` bytes of the newest checkpoint's ``params.npz`` are
    inverted at seeded offsets; restore must fall back to the newest
    *verified* step and report the skip."""

    n_flips: int = 16


@dataclasses.dataclass(frozen=True)
class FleetConcurrentKill:
    """Two of the fleet's producers die concurrently while flushing
    segment ``kill_segment``, each at its own seam: the ``written``
    victim leaves a torn ``.tmp`` (quarantined), the ``renamed`` victim
    a fully-written orphan (adopted).  Both stall out, recover, and
    drain their salvaged tails; the other runs must not notice."""

    victims: Tuple[Tuple[int, str], ...] = (
        (2, "spool.segment.written"), (5, "spool.segment.renamed"))
    kill_segment: int = 5

    @property
    def victim_runs(self) -> Tuple[int, ...]:
        return tuple(r for r, _ in self.victims)


@dataclasses.dataclass(frozen=True)
class FleetTenantCorruption:
    """One tenant's flushed segments rot in two waves.  Wave one (one
    bad segment mid-spool) stays under the circuit-breaker threshold:
    the window over it degrades, the rest analyze.  Wave two (two more
    bad segments) trips the breaker: the run is quarantined, its queue
    drained as degraded — and not one byte of it may leak into a
    sibling's verdicts."""

    victim: int = 3
    n_flips: int = 8
    wave1_segment: int = 2          # corrupted after the first 4 flush
    wave2_segments: Tuple[int, ...] = (5, 6)

    @property
    def victim_runs(self) -> Tuple[int, ...]:
        return (self.victim,)


@dataclasses.dataclass(frozen=True)
class FleetAnalysisLagFlood:
    """The last run produces ``flood_steps`` steps at 3x the siblings'
    rate against a deliberately tight service budget: its bounded queue
    overflows and sheds oldest-first (structured :class:`ShedEvent` +
    ``DegradedWindow`` — degrade, never fabricate), while every sibling
    is drained in time and stays shed-free and bit-identical."""

    flood_steps: int = 48
    queue_windows: int = 2
    max_workers: int = 4

    @property
    def victim_runs(self) -> Tuple[int, ...]:
        return ()                   # resolved by the collector (last run)


# -- ground truth ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChaosTruth:
    """What a chaos entry demands of the recovery (``check`` returns the
    list of violated demands — empty means the pipeline held).

    ``min_matched_windows`` guards against vacuous success: at least that
    many windows must be comparable between the clean and chaos runs, and
    *every* comparable window must match bit-identically."""

    min_quarantined: int = 0      # recovery must quarantine >= this many
    min_degraded: int = 0         # consumer must log >= this many gaps
    min_matched_windows: int = 1
    expect_adopted: int = 0       # orphan segments recovery must adopt
    expect_stall: bool = False    # consumer must detect producer death
    min_shed: int = 0             # fleet: backpressure must shed >= this
    fallback_steps: int = 0       # ckpt: restored == corrupted - this

    def check(self, outcome: "ChaosOutcome") -> List[str]:
        bad = []
        if not outcome.survived:
            bad.append(f"pipeline did not survive: {outcome.error}")
        if outcome.quarantined < self.min_quarantined:
            bad.append(f"quarantined {outcome.quarantined} < "
                       f"{self.min_quarantined}")
        if outcome.degraded < self.min_degraded:
            bad.append(f"degraded windows {outcome.degraded} < "
                       f"{self.min_degraded}")
        if outcome.adopted < self.expect_adopted:
            bad.append(f"adopted {outcome.adopted} < {self.expect_adopted}")
        if outcome.stalled != self.expect_stall:
            bad.append(f"stall detected={outcome.stalled}, "
                       f"expected {self.expect_stall}")
        if outcome.shed < self.min_shed:
            bad.append(f"shed {outcome.shed} < {self.min_shed}")
        if outcome.comparable < self.min_matched_windows:
            bad.append(f"only {outcome.comparable} comparable windows "
                       f"(need {self.min_matched_windows})")
        if outcome.matched != outcome.comparable:
            bad.append(f"verdicts diverged on unaffected windows "
                       f"{outcome.mismatched}")
        if self.fallback_steps:
            if outcome.fallback_from is None:
                bad.append("no checkpoint fallback recorded")
            elif outcome.restored_step != \
                    outcome.fallback_from - self.fallback_steps:
                bad.append(f"restored step {outcome.restored_step}, wanted "
                           f"{outcome.fallback_from - self.fallback_steps}")
        return bad


@dataclasses.dataclass
class ChaosOutcome:
    """Everything one chaos run observed, for scoring and reporting."""

    survived: bool
    verdict: Optional[Verdict] = None   # a flagged post-recovery verdict
    error: Optional[str] = None
    quarantined: int = 0
    adopted: int = 0
    degraded: int = 0
    stalled: bool = False
    shed: int = 0                       # fleet: backpressure drops
    matched: int = 0                    # same-bounds windows, verdict ==
    comparable: int = 0                 # same-bounds windows compared
    mismatched: List[int] = dataclasses.field(default_factory=list)
    fallback_from: Optional[int] = None  # ckpt step that failed verify
    restored_step: Optional[int] = None
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)


EMPTY_VERDICT = Verdict(
    dissimilar=False, dissimilarity_paths=(), dissimilarity_ccr_paths=(),
    disparity_paths=(), disparity_ccr_paths=(),
    cause_attributes=frozenset(),
    dissimilarity_cause_attributes=frozenset(), per_path_causes=())


def _decisions(onlines) -> Optional[Dict[str, float]]:
    """The kernel lane's candidacy counts (``AutoAnalyzer.decisions``)
    summed over a harness's analyzers; None on the exact lane."""
    total = None
    for online in onlines:
        d = online.decisions
        if d is not None:
            total = dict(d) if total is None else \
                {k: total[k] + v for k, v in d.items()}
    return total


# -- spool pipeline -------------------------------------------------------


def _produce_spool(trace: RegionTrace, directory: str, chunk_steps: int,
                   upto: Optional[int] = None, close: bool = True) -> None:
    """Replay ``trace`` step-by-step through a TraceSpool, as the real
    producer (Trainer) would."""
    spool = TraceSpool(directory, chunk_steps=chunk_steps,
                       meta=dict(trace.meta))
    stop = trace.n_steps if upto is None else upto
    for s in range(stop):
        spool.append(trace.window(s, s + 1))
    if close:
        spool.close(meta=dict(trace.meta))


def _corrupt_file(path: str, archetype, rng: np.random.Generator) -> None:
    size = os.path.getsize(path)
    if isinstance(archetype, TruncateSegment):
        keep = max(1, int(size * rng.uniform(0.2, 0.8)))
        with open(path, "rb+") as f:
            f.truncate(keep)
    else:   # FlipBytesInSegment / CorruptLatestCheckpoint
        offsets = rng.choice(size, size=min(archetype.n_flips, size),
                             replace=False)
        with open(path, "rb+") as f:
            for off in sorted(int(o) for o in offsets):
                f.seek(off)
                byte = f.read(1)
                f.seek(off)
                f.write(bytes([byte[0] ^ 0xFF]))


class SpoolChaosCollector:
    """Run one spool-layer archetype end-to-end and diff against the clean
    pipeline.

    The scenario trace (``make_trace``) is produced twice through real
    TraceSpool writers: once untouched (the baseline), once under the
    archetype's interference.  After :meth:`TraceSpool.recover`, both
    spools are consumed by identically-configured OnlineAnalyzers and the
    per-window verdicts are compared on every window with identical step
    bounds — the chaos run must reproduce the clean run bit-for-bit
    wherever the fault did not reach, and must degrade (not crash, not
    fabricate) where it did."""

    def __init__(self, tree, make_trace: Callable[[], RegionTrace],
                 archetype, seed: int, chunk_steps: int = 2,
                 window_steps: int = 4, persist: int = 2,
                 analyzer_kw: Tuple[Tuple[str, Any], ...] = ()):
        self.tree = tree
        self.make_trace = make_trace
        self.archetype = archetype
        self.seed = seed
        self.chunk_steps = chunk_steps
        self.window_steps = window_steps
        self.persist = persist
        self.analyzer_kw = analyzer_kw

    def _online(self) -> OnlineAnalyzer:
        online = OnlineAnalyzer(tree=self.tree,
                                window_steps=self.window_steps,
                                persist=self.persist,
                                analyzer_kw=dict(self.analyzer_kw))
        self._onlines.append(online)
        return online

    def run_chaos(self) -> ChaosOutcome:
        arch = self.archetype
        self._onlines: List[OnlineAnalyzer] = []
        trace = self.make_trace()
        rng = np.random.default_rng(self.seed * 9173 + 11)
        with tempfile.TemporaryDirectory(prefix="repro-chaos-") as base:
            clean_dir = os.path.join(base, "clean")
            chaos_dir = os.path.join(base, "chaos")
            _produce_spool(trace, clean_dir, self.chunk_steps)
            clean = self._online()
            clean_windows = clean.poll(SpooledTrace(clean_dir))

            stalled = False
            try:
                if isinstance(arch, KillProducerMidChunk):
                    # each flush hits each seam once -> the nth hit of the
                    # seam is segment n-1's flush
                    with armed(arch.point, nth=arch.kill_segment + 1):
                        try:
                            _produce_spool(trace, chaos_dir,
                                           self.chunk_steps)
                        except InjectedCrash:
                            pass        # the producer is dead; move on
                elif isinstance(arch, StallProducer):
                    _produce_spool(trace, chaos_dir, self.chunk_steps,
                                   upto=arch.segments * self.chunk_steps,
                                   close=False)
                    # the consumer side: a live tail must give up in
                    # bounded time, not poll forever
                    tail = self._online()
                    try:
                        for _ in tail.follow(SpooledTrace(chaos_dir),
                                             interval=0.01,
                                             max_stall=0.05):
                            pass
                    except ProducerStalledError:
                        stalled = True
                else:   # TruncateSegment / FlipBytesInSegment
                    _produce_spool(trace, chaos_dir, self.chunk_steps)
                    fname = f"segment-{arch.segment:05d}.npz"
                    _corrupt_file(os.path.join(chaos_dir, fname), arch, rng)

                event = TraceSpool.recover(chaos_dir)
                online = self._online()
                chaos_windows = online.poll(SpooledTrace(chaos_dir))
            except Exception as e:      # any escape = pipeline did NOT hold
                return ChaosOutcome(
                    survived=False, error=f"{type(e).__name__}: {e}",
                    stalled=stalled)

        by_bounds = {(w.start, w.stop): w for w in clean_windows
                     if not w.degraded}
        matched, comparable, mismatched = 0, 0, []
        flagged_verdict = None
        for w in chaos_windows:
            if w.degraded:
                continue
            if flagged_verdict is None and w.flagged():
                flagged_verdict = w.verdict
            ref = by_bounds.get((w.start, w.stop))
            if ref is None:
                continue
            comparable += 1
            # fingerprint equality is doc() equality (sha256 of the
            # canonical form) — the bit-identity gate, one line each
            if w.verdict.fingerprint() == ref.verdict.fingerprint():
                matched += 1
            else:
                mismatched.append(w.index)
        degraded = sum(1 for w in chaos_windows if w.degraded)
        return ChaosOutcome(
            survived=True, verdict=flagged_verdict or EMPTY_VERDICT,
            quarantined=len(event["quarantined"]),
            adopted=len(event["adopted"]), degraded=degraded,
            stalled=stalled, matched=matched, comparable=comparable,
            mismatched=mismatched,
            detail={"recovery": event,
                    "salvaged_steps": event["n_steps"],
                    "chaos_windows": len(chaos_windows),
                    "clean_windows": len(clean_windows),
                    "decisions": _decisions(self._onlines)})


# -- fleet pipeline -------------------------------------------------------


def _corrupt_segment(directory: str, segment: int, archetype,
                     rng: np.random.Generator) -> None:
    _corrupt_file(os.path.join(directory, f"segment-{segment:05d}.npz"),
                  archetype, rng)


class FleetChaosCollector:
    """Run one fleet archetype against a real :class:`FleetIngest` over
    ``n_runs`` concurrent spools and score the *isolation* contract.

    Every run replays the same planted scenario with a distinct seed
    (``make_trace(run, n_steps)``), produced through real TraceSpool
    writers — the victims under the archetype's interference, interleaved
    with the fleet's cooperative ticks on a fake clock (one second per
    tick; nothing here reads the wall clock, so seeds {0, 1, 7} replay
    exactly).  After the fleet drains to idle, each unaffected run's
    per-window verdicts are compared against a fresh *solo*
    :class:`OnlineAnalyzer` poll of the same spool: every window must be
    present and fingerprint-identical — one corrupt/dead/flooding tenant
    must not perturb a sibling by a single bit.  The affected runs are
    scored on the degrade path instead: recovery, quarantine, and shed
    accounting from the supervisors' structured events."""

    def __init__(self, tree, make_trace: Callable[[int, int], RegionTrace],
                 archetype, seed: int, n_runs: int = 8, n_steps: int = 16,
                 chunk_steps: int = 2, window_steps: int = 4,
                 persist: int = 2,
                 analyzer_kw: Tuple[Tuple[str, Any], ...] = ()):
        if n_runs < 8:
            raise ValueError(f"fleet isolation gate needs >= 8 runs, "
                             f"got {n_runs}")
        self.tree = tree
        self.make_trace = make_trace
        self.archetype = archetype
        self.seed = seed
        self.n_runs = n_runs
        self.n_steps = n_steps
        self.chunk_steps = chunk_steps
        self.window_steps = window_steps
        self.persist = persist
        self.analyzer_kw = analyzer_kw

    def _config(self) -> FleetConfig:
        arch = self.archetype
        kw = dict(window_steps=self.window_steps, persist=self.persist,
                  analyzer_kw=tuple(self.analyzer_kw))
        if isinstance(arch, FleetConcurrentKill):
            # dead producers must be noticed: 3 fake-clock seconds
            return FleetConfig(max_stall=3.0, **kw)
        if isinstance(arch, FleetAnalysisLagFlood):
            return FleetConfig(queue_windows=arch.queue_windows,
                               max_workers=arch.max_workers, **kw)
        return FleetConfig(**kw)

    def run_chaos(self) -> ChaosOutcome:
        arch = self.archetype
        rng = np.random.default_rng(self.seed * 9173 + 47)
        clock = [0.0]
        flood = (self.n_runs - 1
                 if isinstance(arch, FleetAnalysisLagFlood) else None)
        victims = set(arch.victim_runs) | (
            set() if flood is None else {flood})
        with tempfile.TemporaryDirectory(prefix="repro-fleet-") as base:
            dirs = [os.path.join(base, f"run-{r}")
                    for r in range(self.n_runs)]
            traces = [self.make_trace(
                r, arch.flood_steps if r == flood else self.n_steps)
                for r in range(self.n_runs)]
            index = VerdictIndex(os.path.join(base, "index"))
            fleet = FleetIngest(self._config(), index=index,
                                time_fn=lambda: clock[0])
            for r, d in enumerate(dirs):
                fleet.add_run(f"run-{r}", d)

            def tick(n: int = 1) -> None:
                for _ in range(n):
                    clock[0] += 1.0
                    fleet.tick()

            try:
                if isinstance(arch, FleetConcurrentKill):
                    # every spool is on disk before the fleet tails them;
                    # the victims' producers died mid-flush and the torn
                    # residue waits for stall-driven recovery
                    kill = dict(arch.victims)
                    for r in range(self.n_runs):
                        if r in kill:
                            with armed(kill[r],
                                       nth=arch.kill_segment + 1):
                                try:
                                    _produce_spool(traces[r], dirs[r],
                                                   self.chunk_steps)
                                except InjectedCrash:
                                    pass
                        else:
                            _produce_spool(traces[r], dirs[r],
                                           self.chunk_steps)
                elif isinstance(arch, FleetTenantCorruption):
                    # wave one mid-production (degrades a window), wave
                    # two after close (trips the circuit breaker)
                    spools = [TraceSpool(d, chunk_steps=self.chunk_steps,
                                         meta=dict(traces[r].meta))
                              for r, d in enumerate(dirs)]
                    half = self.n_steps // 2
                    for s in range(half):
                        for r in range(self.n_runs):
                            spools[r].append(traces[r].window(s, s + 1))
                    _corrupt_segment(dirs[arch.victim],
                                     arch.wave1_segment, arch, rng)
                    tick(5)
                    for s in range(half, self.n_steps):
                        for r in range(self.n_runs):
                            spools[r].append(traces[r].window(s, s + 1))
                    for r in range(self.n_runs):
                        spools[r].close(meta=dict(traces[r].meta))
                    for seg in arch.wave2_segments:
                        _corrupt_segment(dirs[arch.victim], seg, arch,
                                         rng)
                else:   # FleetAnalysisLagFlood
                    # the flood run appends 3x the siblings' rate while
                    # the fleet ticks against a tight worker budget
                    spools = [TraceSpool(d, chunk_steps=self.chunk_steps,
                                         meta=dict(traces[r].meta))
                              for r, d in enumerate(dirs)]
                    rounds = self.n_steps // self.chunk_steps
                    flood_per = arch.flood_steps // rounds
                    done_n = [0] * self.n_runs
                    for _ in range(rounds):
                        for r in range(self.n_runs):
                            per = (flood_per if r == flood
                                   else self.chunk_steps)
                            for s in range(done_n[r], done_n[r] + per):
                                spools[r].append(traces[r].window(s, s + 1))
                            done_n[r] += per
                        tick()
                    for r in range(self.n_runs):
                        spools[r].close(meta=dict(traces[r].meta))
                for _ in range(400):
                    if fleet.done:
                        break
                    tick()
                index.close()
            except Exception as e:  # any escape = isolation did NOT hold
                return ChaosOutcome(
                    survived=False, error=f"{type(e).__name__}: {e}")

            # -- score: unaffected runs vs solo, bit for bit ------------
            matched, comparable, mismatched = 0, 0, []
            flagged_verdict = None
            onlines = [sup.online for sup in fleet.runs.values()]
            for r in sorted(set(range(self.n_runs)) - victims):
                sup = fleet.runs[f"run-{r}"]
                solo = OnlineAnalyzer(
                    tree=self.tree, window_steps=self.window_steps,
                    persist=self.persist,
                    analyzer_kw=dict(self.analyzer_kw))
                onlines.append(solo)
                by_bounds = {(w.start, w.stop): w
                             for w in solo.poll(SpooledTrace(dirs[r]))
                             if not w.degraded}
                for w in sup.windows:
                    if w.degraded:
                        continue
                    if flagged_verdict is None and w.flagged():
                        flagged_verdict = w.verdict
                    ref = by_bounds.get((w.start, w.stop))
                    if ref is None:
                        continue
                    comparable += 1
                    if w.verdict.fingerprint() == ref.verdict.fingerprint():
                        matched += 1
                    else:
                        mismatched.append(w.index)

            sups = list(fleet.runs.values())
            events = [e for s in sups for e in s.events]
            return ChaosOutcome(
                survived=fleet.done,
                error=None if fleet.done else "fleet never drained",
                verdict=flagged_verdict or EMPTY_VERDICT,
                quarantined=sum(1 for s in sups
                                if s.state == "quarantined"),
                adopted=sum(len(e.recovery.get("adopted", []))
                            for e in events if e.kind == "recover"),
                degraded=sum(s.degraded for s in sups),
                stalled=any(e.kind == "stall" for e in events),
                shed=sum(s.shed for s in sups),
                matched=matched, comparable=comparable,
                mismatched=mismatched,
                detail={"status": fleet.status(),
                        "index_report": index.report(),
                        "unaffected": sorted(
                            set(range(self.n_runs)) - victims),
                        "ticks": fleet.ticks,
                        "decisions": _decisions(onlines)})


# -- checkpoint pipeline --------------------------------------------------


class CheckpointChaosCollector:
    """Corrupt-latest-checkpoint archetype: ``n_saves`` deterministic
    checkpoints, seeded damage to the newest, then a verified restore that
    must fall back one step and reproduce that step's arrays bit-exactly.
    The "window comparison" here is the restored state itself: 1/1 when
    the fallback state equals what was saved, 0/1 otherwise."""

    def __init__(self, archetype: CorruptLatestCheckpoint, seed: int,
                 n_saves: int = 3):
        self.archetype = archetype
        self.seed = seed
        self.n_saves = n_saves

    def _trees(self, step: int) -> Dict[str, Any]:
        rng = np.random.default_rng(self.seed * 7919 + step)
        f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)
        return {"params": {"w": f32(8, 8), "b": f32(8)},
                "opt_state": {"m": f32(8, 8)}}

    def run_chaos(self) -> ChaosOutcome:
        with tempfile.TemporaryDirectory(prefix="repro-chaos-ckpt-") as d:
            try:
                for step in range(1, self.n_saves + 1):
                    ckpt_mod.save(d, step, self._trees(step))
                latest = ckpt_mod.latest_step(d)
                rng = np.random.default_rng(self.seed * 9173 + 29)
                _corrupt_file(os.path.join(d, f"step_{latest:010d}",
                                           "params.npz"),
                              self.archetype, rng)
                # detection: the damaged step must fail verification ...
                reason = ckpt_mod.verify_step(d, latest)
                verified, skipped = ckpt_mod.latest_verified_step(d)
                # ... and a default restore must land on the fallback
                templates = self._trees(1)
                import warnings
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)
                    step, out = ckpt_mod.restore(d, templates)
                want = self._trees(step)
                exact = all(
                    np.array_equal(np.asarray(a), np.asarray(b))
                    for tree in ("params", "opt_state")
                    for a, b in zip(
                        _leaves(out[tree]), _leaves(want[tree])))
            except Exception as e:
                return ChaosOutcome(survived=False,
                                    error=f"{type(e).__name__}: {e}")
        return ChaosOutcome(
            survived=True, verdict=EMPTY_VERDICT,
            quarantined=len(skipped),   # steps skipped by verification
            matched=int(exact), comparable=1,
            mismatched=[] if exact else [step],
            fallback_from=latest, restored_step=step,
            detail={"corrupt_reason": reason, "skipped": skipped,
                    "verified_step": verified})


def _leaves(tree: Any) -> List[Any]:
    """The leaves of nested dicts in sorted key order (the order
    ``jax.tree_util.tree_leaves`` walks them in)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]
