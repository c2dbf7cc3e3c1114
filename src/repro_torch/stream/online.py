"""OnlineAnalyzer: windowed AutoAnalyzer verdicts while the run is going.

The PyTorch port of the reference's ``repro/stream/online.py``.  Each
window runs the port's :class:`AutoAnalyzer`, whose clustering runs on the
CUDA seed-row kernel on the card by default (``distance_backend`` and
``device`` pass through to it; ``device="cpu"`` runs the kernel's plain
version, ``distance_backend="numpy"`` the exact host lane).  The kernel
lane re-decides on the exact lane every candidacy its float32 bound cannot
settle, so a window's verdict is the exact lane's.

The companion similarity-analysis work (arXiv:0906.1326) frames
dissimilarity detection as something you can run continuously over
collected phases.  This module does exactly that over a
:class:`~repro_torch.stream.spool.TraceSpool`: as tumbling step windows complete
on disk, each one is reassembled (exact — see ``spool.py``), reduced, and
pushed through the *full* AutoAnalyzer; the per-window verdicts accumulate
in a :class:`WindowVerdictLog` whose **onset detector** reports the first
window where a bottleneck verdict appears and persists for ``persist``
consecutive windows — localizing a drifting fault (e.g.
``ThermalThrottleDrift``) in *time*, not just in the region tree.

Window ``i`` covers steps ``[i*stride, i*stride + window_steps)``
(``stride`` defaults to ``window_steps``: tumbling, non-overlapping).  A
window is analyzed once its last step is flushed; when the spool is marked
complete, a trailing partial window (if any steps remain) is analyzed too,
matching ``python -m repro_torch.cli.analyze_trace --per-window``.

Per-window verdicts are bit-identical to an offline
``analyze_trace --per-window`` replay of the finalized artifact: window
reassembly concatenates the very float64 rows the collector recorded, and
the analyzer configuration defaults to the ``analyzer_kw`` the producer
put in the trace header (tests/test_torch_stream.py pins this).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import AutoAnalyzer, Verdict, tree_from_schema
from repro_torch.core.trace import RegionTrace, TraceFormatError
from repro_torch.device import resolve_device

from .spool import SpooledTrace, SpoolGapError, StallDetector

DISSIMILARITY = "dissimilarity"
DISPARITY = "disparity"


@dataclasses.dataclass(frozen=True)
class WindowVerdict:
    """One window's analysis outcome."""

    index: int
    start: int
    stop: int
    verdict: Verdict

    degraded = False     # class-level: see DegradedWindow

    @property
    def kinds(self) -> frozenset:
        """Bottleneck kinds this window's verdict asserts."""
        out = set()
        if self.verdict.dissimilar:
            out.add(DISSIMILARITY)
        if self.verdict.disparity_paths:
            out.add(DISPARITY)
        return frozenset(out)

    def flagged(self, kind: Optional[str] = None) -> bool:
        return bool(self.kinds) if kind is None else kind in self.kinds

    def paths(self, kind: Optional[str] = None) -> Tuple[str, ...]:
        """Located bottleneck paths — of one kind, or of both merged."""
        out = set()
        if kind in (None, DISSIMILARITY):
            out |= set(self.verdict.dissimilarity_paths)
        if kind in (None, DISPARITY):
            out |= set(self.verdict.disparity_paths)
        return tuple(sorted(out))


@dataclasses.dataclass(frozen=True)
class DegradedWindow:
    """A window the analyzer could not trust: corrupt/lost samples
    (quarantined segment, compacted history) or non-finite values.

    Structurally a :class:`WindowVerdict` stand-in — same
    index/start/stop slot in the log, never flagged, no paths — so the
    onset detector sees it as a run-breaker: a fault cannot be claimed
    *persistent* across steps nobody observed, and detection resumes
    cleanly after the gap.  ``reason``/``detail`` record why, so a
    skipped window is visible in every consumer (``cli.watch_trace``
    prints it; the chaos corpus asserts on it), never silently absent.
    """

    index: int
    start: int
    stop: int
    reason: str
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)

    degraded = True
    verdict = None       # class-level: no analysis happened

    @property
    def kinds(self) -> frozenset:
        return frozenset()

    def flagged(self, kind: Optional[str] = None) -> bool:
        return False

    def paths(self, kind: Optional[str] = None) -> Tuple[str, ...]:
        return ()


AnyWindow = Union[WindowVerdict, DegradedWindow]


def lane_kw(analyzer_kw: Optional[Dict[str, Any]] = None,
            distance_backend: Optional[str] = None,
            device: Union[None, str, torch.device] = None) -> Dict[str, Any]:
    """``analyzer_kw`` with the lane overrides applied: a non-None
    ``distance_backend`` or ``device`` wins over the same key in
    ``analyzer_kw`` (and so over the producer's header meta)."""
    kw = dict(analyzer_kw or {})
    if distance_backend is not None:
        kw["distance_backend"] = distance_backend
    if device is not None:
        kw["device"] = device
    return kw


def check_lane(kw: Dict[str, Any]) -> None:
    """Raise at construction, not at the first window, when the lane
    ``kw`` names needs a card that is absent: every lane but the exact
    ``"numpy"`` one runs the seed-row kernel on ``kw["device"]`` (None:
    the card), with no fallback to the CPU."""
    if kw.get("distance_backend", "kernel") != "numpy":
        resolve_device(kw.get("device"))


class WindowVerdictLog:
    """Ordered per-window verdicts + the onset detector.

    Onset = the first window index ``i`` such that windows
    ``i .. i+persist-1`` all carry a (matching-kind) bottleneck verdict —
    one anomalous window is noise, ``persist`` consecutive ones are a
    fault with a start time.  A monotone fault (thermal drift) therefore
    reports the window its ramp first crossed the analyzer's threshold.

    A :class:`DegradedWindow` occupies its slot but never flags, so it
    breaks any in-progress persistence run — onset detection resumes
    after the gap rather than asserting continuity across unobserved
    steps.
    """

    def __init__(self, persist: int = 2):
        if persist < 1:
            raise ValueError(f"persist must be >= 1, got {persist}")
        self.persist = persist
        self.windows: List[AnyWindow] = []

    @property
    def degraded_windows(self) -> List[DegradedWindow]:
        return [w for w in self.windows if w.degraded]

    def append(self, wv: AnyWindow) -> None:
        if wv.index != len(self.windows):
            raise ValueError(f"window {wv.index} appended out of order "
                             f"(expected {len(self.windows)})")
        self.windows.append(wv)

    def onset(self, kind: Optional[str] = None) -> Optional[int]:
        """First window id beginning ``persist`` consecutive flagged
        windows, or None if no such run has been observed (yet)."""
        run_start, run_len = None, 0
        for wv in self.windows:
            if wv.flagged(kind):
                if run_start is None:
                    run_start, run_len = wv.index, 0
                run_len += 1
                if run_len >= self.persist:
                    return run_start
            else:
                run_start, run_len = None, 0
        return None

    def onset_report(self, kind: Optional[str] = None
                     ) -> Optional[Dict[str, Any]]:
        """Machine-readable onset summary (None while nothing persisted).
        With ``kind`` set, kinds/paths are restricted to that kind — a
        standing benign verdict of the other kind stays out of the
        report, just as it stays out of the detection."""
        i = self.onset(kind)
        if i is None:
            return None
        wv = self.windows[i]
        return {
            "onset_window": i,
            # Window-granular; OnlineAnalyzer.onset_report refines this by
            # bisection inside the window when stride < window_steps.
            "onset_step": wv.start,
            "window": [wv.start, wv.stop],
            "persist": self.persist,
            "kinds": sorted(wv.kinds) if kind is None else [kind],
            "paths": list(wv.paths(kind)),
        }


class OnlineAnalyzer:
    """Consume a spool (or an in-memory trace) window-by-window.

    The analyzer configuration resolves exactly like
    ``cli.analyze_trace``: explicit ``analyzer`` wins, else an
    :class:`AutoAnalyzer` is built from ``tree`` (or the spool/trace
    schema) with ``analyzer_kw`` layered over the ``analyzer_kw`` the
    producer recorded in the header meta.  ``distance_backend`` and
    ``device`` override both; ``device=None`` leaves the analyzer's
    default, the card.
    """

    def __init__(self, tree=None, window_steps: int = 4,
                 stride: Optional[int] = None, persist: int = 2,
                 analyzer_kw: Optional[Dict[str, Any]] = None,
                 analyzer: Optional[AutoAnalyzer] = None,
                 distance_backend: Optional[str] = None,
                 device: Union[None, str, torch.device] = None):
        if window_steps < 1:
            raise ValueError(f"window_steps must be >= 1, got {window_steps}")
        self.window_steps = window_steps
        self.stride = window_steps if stride is None else stride
        if self.stride < 1:
            raise ValueError(f"stride must be >= 1, got {self.stride}")
        self.tree = tree
        # One analyzer serves every window, so its lane's counts
        # (AutoAnalyzer.decisions) accumulate over the stream.
        self.analyzer_kw = lane_kw(analyzer_kw, distance_backend, device)
        if analyzer is None:
            check_lane(self.analyzer_kw)
        self._analyzer = analyzer
        self.log = WindowVerdictLog(persist=persist)
        # Most recent consumed source (SpooledTrace or RegionTrace), kept
        # so onset_report can re-analyze prefixes of the onset window to
        # bisect the onset *step* — overlapping windows (stride <
        # window_steps) localize in time finer than a whole window.
        self._source: Any = None
        # Window bounds discovered by pending_bounds but not yet resolved
        # by consume/skip — keeps re-discovery from double-counting when a
        # scheduler holds bounds in a queue.
        self._handed = 0

    # -- analyzer resolution ----------------------------------------------
    def _resolve_analyzer(self, schema, meta) -> AutoAnalyzer:
        if self._analyzer is None:
            tree = self.tree if self.tree is not None \
                else tree_from_schema(schema)
            kw = dict(meta.get("analyzer_kw", {}))
            kw.update(self.analyzer_kw)
            self._analyzer = AutoAnalyzer(tree, **kw)
        return self._analyzer

    # -- window geometry ---------------------------------------------------
    def _next_bounds(self) -> Tuple[int, int]:
        i = len(self.log.windows) + self._handed
        start = i * self.stride
        return start, start + self.window_steps

    def pending_bounds(self, spooled: SpooledTrace,
                       reload: bool = True) -> List[Tuple[int, int]]:
        """Discover (without analyzing) the step bounds of every window
        that has completed on disk and has not yet been handed out.

        This is the discovery half of :meth:`poll`, split out so a
        scheduler (the fleet ingest tier) can queue the bounds, bound the
        queue, and decide *when* — or whether — each window is analyzed.
        Every returned bound must eventually be resolved, in order, by
        :meth:`consume` or :meth:`skip`; until then it counts as
        outstanding and will not be re-discovered."""
        if reload:
            spooled.reload()
        self._source = spooled
        out: List[Tuple[int, int]] = []
        while True:
            start, stop = self._next_bounds()
            if stop <= spooled.n_steps:
                pass
            elif spooled.complete and start < spooled.n_steps:
                stop = spooled.n_steps         # trailing partial window
            else:
                break
            out.append((start, stop))
            self._handed += 1
        return out

    def consume(self, spooled: SpooledTrace, start: int,
                stop: int) -> AnyWindow:
        """Analyze one discovered window (bounds from
        :meth:`pending_bounds`), degrading instead of crashing: a range
        lost to quarantine/compaction or a segment that fails to parse
        logs a :class:`DegradedWindow` and the stream continues."""
        analyzer = self._resolve_analyzer(spooled.schema, spooled.meta)
        self._handed = max(0, self._handed - 1)
        try:
            win = spooled.window(start, stop)
        except SpoolGapError as e:
            wv: AnyWindow = DegradedWindow(
                index=len(self.log.windows), start=start, stop=stop,
                reason="window range lost",
                detail={"missing": [list(m) for m in e.missing]})
            self.log.append(wv)
            return wv
        except TraceFormatError as e:
            wv = DegradedWindow(
                index=len(self.log.windows), start=start, stop=stop,
                reason="corrupt segment",
                detail={"path": e.path, "error": e.reason})
            self.log.append(wv)
            return wv
        return self._analyze_window(win, (0, win.n_steps), start, stop,
                                    analyzer)

    def skip(self, start: int, stop: int, reason: str,
             detail: Optional[Dict[str, Any]] = None) -> DegradedWindow:
        """Resolve a discovered window *without* analyzing it — the
        backpressure path (a shed window) and the integrity path (a
        window over a segment that failed verification) both land here.
        The window still occupies its slot in the log as a structured
        :class:`DegradedWindow`: degraded, never fabricated, never
        silently absent."""
        self._handed = max(0, self._handed - 1)
        wv = DegradedWindow(index=len(self.log.windows), start=start,
                            stop=stop, reason=reason,
                            detail=dict(detail or {}))
        self.log.append(wv)
        return wv

    def _analyze_window(self, trace: RegionTrace,
                        window: Tuple[int, int], start: int, stop: int,
                        analyzer: AutoAnalyzer) -> AnyWindow:
        """``window`` indexes into ``trace`` (which may be rebased to step
        0 when reassembled from a spool); ``start``/``stop`` are the
        absolute run-step labels the log reports.

        Degrades instead of crashing: non-finite samples or an analyzer
        exception yield a :class:`DegradedWindow` so a single bad window
        cannot take down a live watcher mid-run."""
        idx = len(self.log.windows)
        w0, w1 = window
        bad = sorted(k for k, v in trace.data.items()
                     if not np.isfinite(v[w0:w1]).all())
        if bad:
            wv: AnyWindow = DegradedWindow(
                index=idx, start=start, stop=stop,
                reason="non-finite samples", detail={"metrics": bad})
        else:
            try:
                res = analyzer.analyze_trace(trace, window=window)
            except Exception as e:
                wv = DegradedWindow(
                    index=idx, start=start, stop=stop,
                    reason=f"analysis error: {type(e).__name__}",
                    detail={"error": str(e)})
            else:
                wv = WindowVerdict(index=idx, start=start, stop=stop,
                                   verdict=res.verdict)
        self.log.append(wv)
        return wv

    # -- consumption -------------------------------------------------------
    def poll(self, spooled: SpooledTrace) -> List[AnyWindow]:
        """Analyze every window that has completed since the last poll.

        Reloads the manifest first, so a live tail picks up freshly
        flushed segments; a window is reassembled only from the segments
        it overlaps.  When the spool is complete, the trailing partial
        window (if any) is analyzed as the final window.

        A window that cannot be reassembled — range lost to a quarantined
        segment, pruned by compaction, or a segment that fails to parse —
        is logged as a :class:`DegradedWindow` and consumption continues
        with the next window.  Equivalent to :meth:`pending_bounds`
        followed by an immediate :meth:`consume` of every bound — the
        fleet ingest tier uses the split form to interpose its bounded
        queue between the two halves."""
        return [self.consume(spooled, start, stop)
                for start, stop in self.pending_bounds(spooled)]

    def follow(self, spooled: SpooledTrace,
               interval: float = 1.0,
               max_stall: Optional[float] = None,
               sleep_fn=time.sleep):
        """Generator over a *live* spool: yields windows as they complete
        and returns when the producer closes the spool.

        With ``max_stall`` set, a :class:`StallDetector` bounds the wait —
        polling backs off exponentially while nothing changes, and once
        the producer's heartbeat (manifest mtime / step count) has been
        silent for ``max_stall`` seconds, :class:`ProducerStalledError`
        propagates: the producer is presumed dead and the consumer exits
        instead of tailing forever."""
        detector = (None if max_stall is None else
                    StallDetector(max_stall, base_interval=interval))
        while True:
            for wv in self.poll(spooled):
                yield wv
            if spooled.complete:
                return
            delay = interval
            if detector is not None:
                delay = detector.observe(spooled)
            sleep_fn(delay)

    def process_trace(self, trace: RegionTrace) -> WindowVerdictLog:
        """Run every window of an already-materialized trace (a finished
        in-memory run, or a loaded artifact) through the analyzer —
        window-for-window identical to tailing the same run's spool."""
        self._source = trace
        analyzer = self._resolve_analyzer(trace.schema, trace.meta)
        while True:
            start, stop = self._next_bounds()
            if start >= trace.n_steps:
                break
            stop = min(stop, trace.n_steps)
            self._analyze_window(trace, (start, stop), start, stop,
                                 analyzer)
        return self.log

    # -- results -----------------------------------------------------------
    @property
    def decisions(self) -> Optional[Dict[str, float]]:
        """The window analyzer's :attr:`AutoAnalyzer.decisions` over every
        window so far (None before the first window, and on the exact
        lane)."""
        return None if self._analyzer is None else self._analyzer.decisions

    def onset(self, kind: Optional[str] = None) -> Optional[int]:
        return self.log.onset(kind)

    def onset_report(self, kind: Optional[str] = None
                     ) -> Optional[Dict[str, Any]]:
        """The log's onset report, refined to step granularity when the
        windows overlap (stride < window_steps): the onset *step* is
        bisected inside the first flagged window as the first step whose
        inclusion flips the window's prefix verdict to flagged."""
        rep = self.log.onset_report(kind)
        if (rep is None or self.stride >= self.window_steps
                or self._source is None):
            return rep
        rep["onset_step"] = self._bisect_onset_step(
            rep["window"][0], rep["window"][1], kind)
        return rep

    def _window_trace(self, start: int, stop: int
                      ) -> Tuple[RegionTrace, int]:
        """The onset window's steps as a trace plus the base step its
        step 0 corresponds to."""
        src = self._source
        if isinstance(src, RegionTrace):
            return src, 0
        return src.window(start, stop), start

    def _bisect_onset_step(self, start: int, stop: int,
                           kind: Optional[str]) -> int:
        """First step s in [start, stop) such that analyzing the prefix
        [start, s] of the onset window yields a flagged verdict.  A
        persistent fault makes the prefix verdict monotone in practice
        (more faulty steps can only strengthen the signal), so binary
        search applies; the full window is flagged by construction, which
        bounds the search."""
        trace, base = self._window_trace(start, stop)
        analyzer = self._analyzer

        def flagged(prefix_stop: int) -> bool:
            res = analyzer.analyze_trace(
                trace, window=(start - base, prefix_stop - base))
            wv = WindowVerdict(index=-1, start=start, stop=prefix_stop,
                               verdict=res.verdict)
            return wv.flagged(kind)

        lo, hi = start + 1, stop     # prefix end in (start, stop]
        while lo < hi:
            mid = (lo + hi) // 2
            if flagged(mid):
                hi = mid
            else:
                lo = mid + 1
        return lo - 1
