"""FleetIngest: many concurrent runs, one analyzer service.

The PyTorch port of the reference's ``repro/fleet/ingest.py``: every run's
windows go through the port's :class:`~repro_torch.stream.OnlineAnalyzer`,
on the seed-row kernel on the card unless ``FleetConfig`` says otherwise.

The paper's method is per-run; the fleet tier applies it at the scale of
a production cluster: a :class:`FleetIngest` supervisor tails many trace
spools at once — one :class:`RunSupervisor` per run — and keeps analyzing
the healthy ones *no matter what the sick ones do*.  The MPI tooling
survey (arXiv:1311.0864) observation drives the design: an automated
debugger earns trust only when it survives the failures it diagnoses, so
every per-run failure here is a contained, structured, reported event —
never a service outage.

Isolation contract (gated by the fleet chaos corpus,
the ``fleet/*`` entries of ``repro_torch.scenarios.corpus``):

* a corrupt, torn, stalled, or runaway run **cannot** perturb any other
  run's verdict stream — unaffected runs produce per-window verdicts
  bit-identical to a solo :class:`~repro_torch.stream.OnlineAnalyzer` tail of
  the same spool;
* any unexpected exception inside one run's supervision quarantines that
  run (with the error recorded) instead of propagating.

Mechanics, per tick of the cooperative poll loop (:meth:`FleetIngest.tick`):

1. **Discovery** — each live run reloads its manifest, verifies every
   newly flushed segment against its integrity record (length + sha256
   — the fleet trusts nothing it did not hash), and enqueues the bounds
   of each newly completed window on the run's **bounded window queue**.
   Transient read errors retry with exponential backoff
   (:class:`RetryEvent`); repeated integrity failures trip the **circuit
   breaker**: the run is quarantined, invoking
   :meth:`~repro_torch.stream.TraceSpool.recover` where salvageable
   (:class:`QuarantineEvent`).  A producer whose heartbeat goes silent
   past ``max_stall`` is presumed dead (:class:`StallEvent`), recovered,
   and its salvaged tail drained.
2. **Backpressure** — when analysis lags collection the queue fills; at
   ``queue_windows`` the *oldest* queued window is shed: resolved as a
   structured ``DegradedWindow(reason="shed: backpressure")`` plus a
   :class:`ShedEvent`.  Memory stays bounded and nothing is silently
   lost — a shed window is visible in the log, the events, and every
   consumer ("degrade, never fabricate", fleet-sized).
3. **Analysis** — a bounded shared worker pool (``max_workers`` window
   analyses per tick, round-robin across runs so one noisy tenant cannot
   starve the rest) drains the queues through each run's own
   :class:`~repro_torch.stream.OnlineAnalyzer`.  Flagged verdicts feed the
   :class:`~repro_torch.fleet.index.VerdictIndex` for cross-run dedup.

The loop is cooperative and deterministic: no threads, an injectable
clock (``time_fn``) for the liveness machinery, and strictly ordered
per-run window resolution — which is what lets the fleet chaos corpus
pin bit-identical healthy-run verdicts at seeds {0, 1, 7}.
"""
from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.stream import (OnlineAnalyzer, ProducerStalledError,
                                SpooledTrace, StallDetector, TraceSpool,
                                check_lane, lane_kw, verify_segment)

from .index import VerdictIndex

# Run lifecycle states.
WAITING = "waiting"          # no manifest yet (producer not started)
LIVE = "live"                # tailing a healthy spool
DONE = "done"                # spool complete, every window resolved
QUARANTINED = "quarantined"  # circuit breaker tripped; run isolated

TERMINAL = (DONE, QUARANTINED)


# -- structured events ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShedEvent:
    """Backpressure shed: the oldest queued window was dropped (resolved
    as a DegradedWindow) to keep the run's queue bounded."""

    run: str
    index: int               # window index in the run's verdict log
    start: int
    stop: int
    queued: int              # queue length at shed time

    kind = "shed"

    def doc(self) -> Dict[str, Any]:
        return {"event": self.kind, "run": self.run, "window": self.index,
                "steps": [self.start, self.stop], "queued": self.queued}


@dataclasses.dataclass(frozen=True)
class IntegrityEvent:
    """A flushed segment failed its manifest integrity record."""

    run: str
    file: str
    reason: str
    failures: int            # run's cumulative integrity failures

    kind = "integrity"

    def doc(self) -> Dict[str, Any]:
        return {"event": self.kind, "run": self.run, "file": self.file,
                "reason": self.reason, "failures": self.failures}


@dataclasses.dataclass(frozen=True)
class RetryEvent:
    """Transient read error; the run backs off exponentially."""

    run: str
    attempt: int
    error: str
    retry_tick: int          # tick the next attempt is scheduled for

    kind = "retry"

    def doc(self) -> Dict[str, Any]:
        return {"event": self.kind, "run": self.run,
                "attempt": self.attempt, "error": self.error,
                "retry_tick": self.retry_tick}


@dataclasses.dataclass(frozen=True)
class StallEvent:
    """The run's producer heartbeat went silent past the stall bound."""

    run: str
    elapsed: float

    kind = "stall"

    def doc(self) -> Dict[str, Any]:
        return {"event": self.kind, "run": self.run,
                "elapsed": round(self.elapsed, 3)}


@dataclasses.dataclass(frozen=True)
class RecoveryEvent:
    """``TraceSpool.recover`` salvaged the run's spool (after a stall or
    on quarantine); carries the spool's recovery event."""

    run: str
    recovery: Dict[str, Any]

    kind = "recover"

    def doc(self) -> Dict[str, Any]:
        return {"event": self.kind, "run": self.run,
                "recovery": self.recovery}


@dataclasses.dataclass(frozen=True)
class QuarantineEvent:
    """Circuit breaker tripped: the run is isolated from the fleet."""

    run: str
    reason: str
    failures: int
    recovered: bool          # TraceSpool.recover salvaged something

    kind = "quarantine"

    def doc(self) -> Dict[str, Any]:
        return {"event": self.kind, "run": self.run, "reason": self.reason,
                "failures": self.failures, "recovered": self.recovered}


AnyEvent = Any


# -- configuration --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Knobs of the ingest tier (per-run analyzer geometry + service
    bounds).  Defaults match the streaming layer's; the service bounds
    are deliberately small — a fleet earns its memory ceiling by
    shedding, not by buffering."""

    window_steps: int = 4
    stride: Optional[int] = None
    persist: int = 2
    analyzer_kw: Tuple[Tuple[str, Any], ...] = ()
    # distance backend and device for every run's analyzer ("kernel" on
    # the card by default; "numpy" is the exact host lane, device "cpu"
    # the kernel's plain version).  None defers to analyzer_kw / per-run
    # header meta.
    distance_backend: Optional[str] = None
    device: Optional[str] = None
    # service bounds
    max_workers: int = 4           # window analyses per tick, fleet-wide
    queue_windows: int = 8         # bounded per-run window queue
    max_integrity_failures: int = 3  # circuit breaker threshold
    max_read_retries: int = 3      # transient-read retries before failure
    max_stall: Optional[float] = None  # producer liveness bound (seconds)

    def __post_init__(self):
        if self.max_workers < 1:
            raise ValueError(f"max_workers must be >= 1, "
                             f"got {self.max_workers}")
        if self.queue_windows < 1:
            raise ValueError(f"queue_windows must be >= 1, "
                             f"got {self.queue_windows}")
        if self.max_integrity_failures < 1:
            raise ValueError(f"max_integrity_failures must be >= 1, "
                             f"got {self.max_integrity_failures}")


# -- per-run supervision --------------------------------------------------


class RunSupervisor:
    """One run's containment cell: its analyzer, its bounded queue, its
    failure accounting.  Everything that can go wrong with this run is
    absorbed here and surfaced as structured events; nothing crosses to
    a sibling run."""

    def __init__(self, run_id: str, directory: str, cfg: FleetConfig,
                 time_fn: Callable[[], float] = time.monotonic):
        self.run_id = run_id
        self.directory = directory
        self.cfg = cfg
        self._time = time_fn
        self.online = OnlineAnalyzer(window_steps=cfg.window_steps,
                                     stride=cfg.stride,
                                     persist=cfg.persist,
                                     analyzer_kw=dict(cfg.analyzer_kw),
                                     distance_backend=cfg.distance_backend,
                                     device=cfg.device)
        self.state = WAITING
        self.spooled: Optional[SpooledTrace] = None
        # queue entries: (start, stop, bad_detail-or-None); strict FIFO —
        # windows are resolved in discovery order, always.
        self.queue: Deque[Tuple[int, int, Optional[Dict[str, Any]]]] = \
            deque()
        self.events: List[AnyEvent] = []
        self.integrity_failures = 0
        self.recovered = False
        self.quarantine_reason: Optional[str] = None
        self._verified: Dict[str, Optional[str]] = {}  # file -> bad reason
        self._bad_ranges: List[Tuple[int, int]] = []
        self._retry_attempts = 0
        self._retry_tick = 0
        self._detector = (None if cfg.max_stall is None else
                          StallDetector(cfg.max_stall, time_fn=time_fn))
        self._waiting_since = time_fn()
        self.error: Optional[str] = None

    # -- accounting views --------------------------------------------------
    @property
    def windows(self) -> List[Any]:
        return self.online.log.windows

    @property
    def shed(self) -> int:
        return sum(1 for e in self.events if e.kind == "shed")

    @property
    def degraded(self) -> int:
        return len(self.online.log.degraded_windows)

    def status(self) -> Dict[str, Any]:
        """One JSON-ready status row (``cli.fleet_watch`` prints these)."""
        return {
            "run": self.run_id,
            "directory": self.directory,
            "state": self.state,
            "n_steps": self.spooled.n_steps if self.spooled else 0,
            "complete": bool(self.spooled.complete) if self.spooled
            else False,
            "windows": len(self.windows),
            "degraded": self.degraded,
            "shed": self.shed,
            "queued": len(self.queue),
            "integrity_failures": self.integrity_failures,
            "recovered": self.recovered,
            "quarantine_reason": self.quarantine_reason,
            "events": [e.doc() for e in self.events],
        }

    # -- failure handling --------------------------------------------------
    def _integrity_failure(self, file: str, reason: str) -> None:
        self.integrity_failures += 1
        self.events.append(IntegrityEvent(
            run=self.run_id, file=file, reason=reason,
            failures=self.integrity_failures))
        if self.integrity_failures >= self.cfg.max_integrity_failures:
            self.quarantine(f"circuit breaker: {self.integrity_failures} "
                            f"integrity failures (last: {file}: {reason})")

    def quarantine(self, reason: str) -> None:
        """Trip the breaker: salvage what TraceSpool.recover can, resolve
        every outstanding window as degraded (the log stays coherent and
        complete — no fabricated, no vanished windows), and isolate the
        run."""
        if self.state == QUARANTINED:
            return
        recovered = False
        try:
            event = TraceSpool.recover(self.directory)
            recovered = True
            self.events.append(RecoveryEvent(run=self.run_id,
                                             recovery=event))
        except (ValueError, OSError):
            pass        # nothing durable to salvage — quarantine anyway
        while self.queue:
            start, stop, _ = self.queue.popleft()
            self.online.skip(start, stop, "run quarantined",
                             {"reason": reason})
        self.state = QUARANTINED
        self.quarantine_reason = reason
        self.events.append(QuarantineEvent(
            run=self.run_id, reason=reason,
            failures=self.integrity_failures, recovered=recovered))

    def _transient(self, tick: int, err: Exception) -> None:
        """Transient read error: exponential tick backoff, then breaker."""
        self._retry_attempts += 1
        if self._retry_attempts > self.cfg.max_read_retries:
            self._integrity_failure(
                "spool.json", f"unreadable after "
                f"{self._retry_attempts - 1} retries: {err}")
            self._retry_attempts = 0
            return
        self._retry_tick = tick + 2 ** (self._retry_attempts - 1)
        self.events.append(RetryEvent(
            run=self.run_id, attempt=self._retry_attempts,
            error=f"{type(err).__name__}: {err}",
            retry_tick=self._retry_tick))

    def _stalled(self, elapsed: float) -> None:
        """Producer presumed dead: salvage the spool and drain the tail
        (the salvaged manifest is complete, so discovery finishes the
        remaining windows on the following ticks)."""
        self.events.append(StallEvent(run=self.run_id, elapsed=elapsed))
        try:
            event = TraceSpool.recover(self.directory)
        except (ValueError, OSError) as e:
            self.quarantine(f"stalled and nothing recoverable: {e}")
            return
        self.recovered = True
        self.events.append(RecoveryEvent(run=self.run_id, recovery=event))

    # -- the discovery half ------------------------------------------------
    def discover(self, tick: int) -> None:
        """One poll: reload the manifest, verify new segments, enqueue
        newly completed windows (shedding the oldest past the bound),
        detect stalls, and settle terminal states."""
        if self.state in TERMINAL:
            return
        if tick < self._retry_tick:
            return                      # backing off a transient error
        try:
            if self.spooled is None:
                self.spooled = SpooledTrace(self.directory)
            else:
                self.spooled.reload()
        except (OSError, json.JSONDecodeError) as e:
            self._transient(tick, e)
            return
        except ValueError as e:
            if self.spooled is not None:
                # manifest vanished / turned foreign mid-run
                self._transient(tick, e)
                return
            # no manifest yet: keep waiting, but not forever
            if (self.cfg.max_stall is not None
                    and self._time() - self._waiting_since
                    > self.cfg.max_stall):
                self._stalled(self._time() - self._waiting_since)
                if self.state == QUARANTINED:
                    return
                try:
                    self.spooled = SpooledTrace(self.directory)
                except ValueError:
                    self.quarantine("no manifest after stall recovery")
                    return
            else:
                return
        self._retry_attempts = 0
        if self.state == WAITING:
            self.state = LIVE

        # integrity: hash every newly flushed segment before trusting it
        for seg in self.spooled.segment_records:
            fname = seg["file"]
            if fname in self._verified:
                continue
            reason = verify_segment(self.directory, seg)
            self._verified[fname] = reason
            if reason is not None:
                self._bad_ranges.append(
                    (seg["start"], seg["start"] + seg["n_steps"]))
                self._integrity_failure(fname, reason)
                if self.state == QUARANTINED:
                    return

        # enqueue newly completed windows; shed the oldest past the bound
        for start, stop in self.online.pending_bounds(self.spooled,
                                                      reload=False):
            bad = [(a, b) for a, b in self._bad_ranges
                   if a < stop and b > start]
            detail = ({"bad_ranges": [list(r) for r in bad]}
                      if bad else None)
            self.queue.append((start, stop, detail))
            if len(self.queue) > self.cfg.queue_windows:
                s0, s1, _ = self.queue.popleft()
                wv = self.online.skip(s0, s1, "shed: backpressure",
                                      {"queued": len(self.queue)})
                self.events.append(ShedEvent(
                    run=self.run_id, index=wv.index, start=s0, stop=s1,
                    queued=len(self.queue)))

        # liveness, completion
        if self.spooled.complete:
            if not self.queue:
                self.state = DONE
        elif self._detector is not None:
            try:
                self._detector.observe(self.spooled)
            except ProducerStalledError as e:
                self._stalled(e.elapsed)

    # -- the analysis half -------------------------------------------------
    def work_one(self, index: Optional[VerdictIndex] = None) -> bool:
        """Resolve the oldest queued window (one unit of worker-pool
        budget).  Integrity-flagged windows resolve as degraded without
        touching the corrupt bytes; healthy windows run the full
        analyzer, and a flagged verdict feeds the cross-run index."""
        if not self.queue:
            return False
        start, stop, bad = self.queue.popleft()
        if bad is not None:
            self.online.skip(start, stop, "integrity: segment failed "
                             "verification", bad)
            return True
        wv = self.online.consume(self.spooled, start, stop)
        if index is not None and not wv.degraded and wv.flagged():
            index.record(self.run_id, wv.verdict, start, stop)
        return True


# -- the fleet ------------------------------------------------------------


class FleetIngest:
    """The multi-tenant supervisor: a deterministic cooperative poll loop
    over every registered run, with a shared bounded worker pool.

    ``tick()`` is the unit of service time: one discovery pass over all
    runs, then up to ``max_workers`` window analyses drained round-robin
    across the non-empty queues.  Any unexpected exception inside one
    run's supervision quarantines *that run* and the loop continues —
    fault isolation is the invariant, not an aspiration.
    """

    def __init__(self, cfg: Optional[FleetConfig] = None,
                 index: Optional[VerdictIndex] = None,
                 time_fn: Callable[[], float] = time.monotonic):
        self.cfg = cfg or FleetConfig()
        # A kernel lane without its card would quarantine every run as an
        # internal error; refuse here instead.
        check_lane(lane_kw(self.cfg.analyzer_kw, self.cfg.distance_backend,
                           self.cfg.device))
        self.index = index
        self._time = time_fn
        self.runs: Dict[str, RunSupervisor] = {}
        self.ticks = 0

    def add_run(self, run_id: str, directory: str) -> RunSupervisor:
        if run_id in self.runs:
            raise ValueError(f"duplicate run id {run_id!r}")
        sup = RunSupervisor(run_id, directory, self.cfg, time_fn=self._time)
        self.runs[run_id] = sup
        return sup

    # -- service loop ------------------------------------------------------
    def _contain(self, sup: RunSupervisor, fn, *args) -> Any:
        """Run one supervision step with the isolation guarantee: an
        escape quarantines the run, never the fleet."""
        try:
            return fn(*args)
        except Exception as e:      # noqa: BLE001 — isolation by design
            sup.error = f"{type(e).__name__}: {e}"
            try:
                sup.quarantine(f"internal error: {sup.error}")
            except Exception:       # even quarantine must not escape
                sup.state = QUARANTINED
                sup.quarantine_reason = f"internal error: {sup.error}"
            return None

    def tick(self) -> int:
        """One service round; returns the number of windows resolved."""
        self.ticks += 1
        for sup in self.runs.values():
            self._contain(sup, sup.discover, self.ticks)
        budget = self.cfg.max_workers
        resolved = 0
        progressed = True
        while budget > 0 and progressed:
            progressed = False
            for sup in self.runs.values():
                if budget == 0:
                    break
                if sup.state == QUARANTINED or not sup.queue:
                    continue
                if self._contain(sup, sup.work_one, self.index):
                    budget -= 1
                    resolved += 1
                    progressed = True
                # a run whose spool completed drains to DONE as soon as
                # its queue empties, without waiting for the next tick
                if (sup.state == LIVE and sup.spooled is not None
                        and sup.spooled.complete and not sup.queue):
                    sup.state = DONE
        return resolved

    @property
    def done(self) -> bool:
        """Every run reached a terminal state (done or quarantined)."""
        return all(s.state in TERMINAL for s in self.runs.values())

    def run_until_idle(self, max_ticks: int = 10_000,
                       sleep: float = 0.0,
                       sleep_fn: Callable[[float], None] = time.sleep
                       ) -> bool:
        """Tick until every run is terminal; False when ``max_ticks``
        elapsed first (a live producer still going, or no stall bound
        configured for a dead one)."""
        for _ in range(max_ticks):
            if self.done:
                return True
            self.tick()
            if sleep:
                sleep_fn(sleep)
        return self.done

    # -- reporting ---------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        doc = {
            "ticks": self.ticks,
            "runs": [sup.status() for sup in self.runs.values()],
            "done": self.done,
        }
        if self.index is not None:
            doc["index"] = self.index.report()
        return doc
