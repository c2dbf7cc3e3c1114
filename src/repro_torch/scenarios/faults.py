"""Parameterized fault archetypes — the paper's injected-bottleneck
methodology (§6, and arXiv:0906.1326) as a composable engine.

The paper validates AutoAnalyzer by injecting *known* bottlenecks into real
applications and checking the pipeline recovers them.  This module turns
that experiment into reusable machinery: each archetype is a small frozen
dataclass that perturbs a :class:`RegionMetrics` deterministically (the
*synthetic* backend — no device execution) and declares the ground truth it
plants (which region paths must be located, which decision attributes must
surface as root causes, and whether the bottleneck is a process
*dissimilarity* or a code-region *disparity*).

Perturbations respect inclusive nested timing: a delta applied to a region
is propagated additively to every ancestor present in the metrics, exactly
as real instrumentation would observe it.

The PyTorch port's copy of the reference's ``repro/scenarios/faults.py``
(numpy only): the snapshot and step-aware archetypes through
:class:`ThermalThrottleDrift`, and the runtime backend's
:func:`iterated_work`, whose iteration count runs as a host loop.  The
serving archetypes are not ported yet (ROADMAP.md queue 1, item 3).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, FrozenSet, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.metrics import (BYTES, COMM_BYTES, COMM_TIME,
                                      CPU_TIME, FLOPS, HBM_INTENSITY,
                                      HOST_BYTES, VMEM_PRESSURE, WALL_TIME,
                                      RegionMetrics)
from repro_torch.core.regions import RegionTree
from repro_torch.core.trace import RegionTrace

DISSIMILARITY = "dissimilarity"
DISPARITY = "disparity"

# Metrics that scale together when a region simply does more of the same
# work (a straggler / skewed shard).
_WORK_METRICS = (WALL_TIME, CPU_TIME, FLOPS, BYTES)


def _ancestor_cols(tree: RegionTree, rm: RegionMetrics, rid: int):
    """Metric columns of the ancestors of ``rid`` (inclusive timing)."""
    cols = []
    node = tree[rid].parent
    while node is not None:
        try:
            cols.append(rm.col(node.region_id))
        except KeyError:
            pass
        node = node.parent
    return cols


def _add_cells(tree: RegionTree, rm: RegionMetrics, path: str,
               metric: str, deltas: np.ndarray) -> None:
    """Add per-process ``deltas`` to (``path``, metric), propagating the
    additive delta up the region tree."""
    rid = tree.by_path(path).region_id
    j = rm.col(rid)
    M = rm.metric(metric)
    M[:, j] += deltas
    for c in _ancestor_cols(tree, rm, rid):
        M[:, c] += deltas


def _scale_cells(tree: RegionTree, rm: RegionMetrics, path: str,
                 metric: str, factors: np.ndarray) -> None:
    """Multiply (``path``, metric) per process by ``factors``; ancestors
    receive the additive delta (their other children are untouched)."""
    rid = tree.by_path(path).region_id
    j = rm.col(rid)
    M = rm.metric(metric)
    deltas = M[:, j] * (factors - 1.0)
    M[:, j] += deltas
    for c in _ancestor_cols(tree, rm, rid):
        M[:, c] += deltas


def _proc_factors(m: int, procs: Sequence[int], factor: float) -> np.ndarray:
    f = np.ones(m)
    f[list(procs)] = factor
    return f


@dataclasses.dataclass(frozen=True)
class ComputeStraggler:
    """Designated processes do ``factor``× the work in one region — the
    paper's ST region-11 style load imbalance, sharpened to a known set of
    straggler ranks."""

    region: str
    procs: Tuple[int, ...]
    factor: float = 4.0
    kind: ClassVar[str] = DISSIMILARITY
    causes: ClassVar[FrozenSet[str]] = frozenset({FLOPS})

    def apply(self, tree: RegionTree, rm: RegionMetrics,
              rng: np.random.Generator) -> None:
        f = _proc_factors(rm.n_processes, self.procs, self.factor)
        for metric in _WORK_METRICS:
            _scale_cells(tree, rm, self.region, metric, f)

    @property
    def paths(self) -> Tuple[str, ...]:
        return (self.region,)


@dataclasses.dataclass(frozen=True)
class JitteredStraggler:
    """A straggler whose excess work varies per process around ``factor``
    (deterministic given the injection rng) — models stragglers whose
    magnitude drifts run to run while the culprit region stays fixed."""

    region: str
    procs: Tuple[int, ...]
    factor: float = 4.0
    jitter: float = 0.2
    kind: ClassVar[str] = DISSIMILARITY
    causes: ClassVar[FrozenSet[str]] = frozenset({FLOPS})

    def apply(self, tree: RegionTree, rm: RegionMetrics,
              rng: np.random.Generator) -> None:
        f = np.ones(rm.n_processes)
        for p in self.procs:
            # clamp: a wild jitter draw must never produce negative work
            f[p] = max(0.05, self.factor *
                       (1.0 + self.jitter * rng.standard_normal()))
        for metric in _WORK_METRICS:
            _scale_cells(tree, rm, self.region, metric, f)

    @property
    def paths(self) -> Tuple[str, ...]:
        return (self.region,)


@dataclasses.dataclass(frozen=True)
class DataSkew:
    """A full per-process work profile on one region (the ST Fig. 11 shape
    generalised): time/flops multiply by ``profile[i]`` on process i,
    producing several behaviour clusters at once."""

    region: str
    profile: Tuple[float, ...]
    kind: ClassVar[str] = DISSIMILARITY
    causes: ClassVar[FrozenSet[str]] = frozenset({FLOPS})

    def apply(self, tree: RegionTree, rm: RegionMetrics,
              rng: np.random.Generator) -> None:
        f = np.asarray(self.profile, dtype=np.float64)
        if f.size != rm.n_processes:
            raise ValueError(
                f"profile size {f.size} != n_processes {rm.n_processes}")
        for metric in _WORK_METRICS:
            _scale_cells(tree, rm, self.region, metric, f)

    @property
    def paths(self) -> Tuple[str, ...]:
        return (self.region,)


@dataclasses.dataclass(frozen=True)
class CommImbalance:
    """Extra collective traffic on one region.  With ``procs`` given, only
    those processes pay the wire time (e.g. a congested link) — a
    dissimilarity visible on the *wall* clock but not the CPU clock, so
    corpus entries pair this with ``similarity_metric=wall_time``.  With
    ``procs=None`` every process pays equally: a disparity bottleneck (the
    NPAR1WAY region-12 / MPIBZIP2 region-7 pattern)."""

    region: str
    extra_bytes: float
    procs: Optional[Tuple[int, ...]] = None
    bandwidth: float = 1e9         # bytes/s over the congested link
    causes: ClassVar[FrozenSet[str]] = frozenset({COMM_BYTES})

    @property
    def kind(self) -> str:
        return DISPARITY if self.procs is None else DISSIMILARITY

    def apply(self, tree: RegionTree, rm: RegionMetrics,
              rng: np.random.Generator) -> None:
        m = rm.n_processes
        mask = np.zeros(m) if self.procs is not None else np.ones(m)
        if self.procs is not None:
            mask[list(self.procs)] = 1.0
        byts = mask * self.extra_bytes
        wait = byts / self.bandwidth
        _add_cells(tree, rm, self.region, COMM_BYTES, byts)
        _add_cells(tree, rm, self.region, COMM_TIME, wait)
        # Wire time is wall-clock waiting, not CPU burn.
        _add_cells(tree, rm, self.region, WALL_TIME, wait)

    @property
    def paths(self) -> Tuple[str, ...]:
        return (self.region,)


@dataclasses.dataclass(frozen=True)
class CollectiveStraggler:
    """One slow rank stretches every collective (the ROADMAP's
    collective-straggler archetype): the straggler arrives ``delay``
    seconds late to each listed comm region, so every *other* rank sits in
    the collective for an extra ``delay`` of wall/comm time while the
    straggler itself, arriving last, never waits.  The signal spreads
    evenly over all the comm regions, so no single region reproduces it —
    Algorithm 2 must fall back to composite regions to locate the set.

    Pure waiting: the CPU clock is untouched, so corpus entries pair this
    with ``similarity_metric=wall_time``.  No decision attribute inflates
    (no extra bytes are moved), hence ``causes`` is empty."""

    regions: Tuple[str, ...]
    straggler: int
    delay: float = 2.0
    kind: ClassVar[str] = DISSIMILARITY
    causes: ClassVar[FrozenSet[str]] = frozenset()

    def apply(self, tree: RegionTree, rm: RegionMetrics,
              rng: np.random.Generator) -> None:
        waits = np.full(rm.n_processes, self.delay)
        waits[self.straggler] = 0.0
        for region in self.regions:
            _add_cells(tree, rm, region, WALL_TIME, waits)
            _add_cells(tree, rm, region, COMM_TIME, waits)

    @property
    def paths(self) -> Tuple[str, ...]:
        return tuple(self.regions)


@dataclasses.dataclass(frozen=True)
class CheckpointStall:
    """One shard flushes the checkpoint (the ROADMAP's checkpoint-stall
    archetype): a ``extra_bytes`` host-I/O burst lands on a single rank —
    the one that owns the write leg this step — which stalls for
    ``stall`` seconds of wall clock while the data drains.  Waiting, not
    compute: the CPU clock is untouched, so corpus entries pair this
    with ``similarity_metric=wall_time``; the host-traffic spike is what
    surfaces ``host_bytes`` as the root cause in the Fig. 4 table."""

    region: str
    proc: int
    extra_bytes: float = 80e9
    stall: float = 5.0
    kind: ClassVar[str] = DISSIMILARITY
    causes: ClassVar[FrozenSet[str]] = frozenset({HOST_BYTES})

    def apply(self, tree: RegionTree, rm: RegionMetrics,
              rng: np.random.Generator) -> None:
        m = rm.n_processes
        burst = np.zeros(m)
        burst[self.proc] = self.extra_bytes
        waits = np.zeros(m)
        waits[self.proc] = self.stall
        _add_cells(tree, rm, self.region, HOST_BYTES, burst)
        _add_cells(tree, rm, self.region, WALL_TIME, waits)

    @property
    def paths(self) -> Tuple[str, ...]:
        return (self.region,)


@dataclasses.dataclass(frozen=True)
class CacheThrash:
    """A region starts missing in cache: HBM traffic per flop inflates by
    ``byte_factor`` and the same flops take ``slowdown``× longer on every
    process (the paper's ST region-11 L2 pressure, fixed by loop
    blocking)."""

    region: str
    slowdown: float = 4.0
    byte_factor: float = 8.0
    kind: ClassVar[str] = DISPARITY
    causes: ClassVar[FrozenSet[str]] = frozenset({HBM_INTENSITY})

    def apply(self, tree: RegionTree, rm: RegionMetrics,
              rng: np.random.Generator) -> None:
        ones = np.ones(rm.n_processes)
        _scale_cells(tree, rm, self.region, BYTES, ones * self.byte_factor)
        for metric in (WALL_TIME, CPU_TIME):
            _scale_cells(tree, rm, self.region, metric, ones * self.slowdown)
        # intensity is a rate, not additive: bump only the target region
        rid = tree.by_path(self.region).region_id
        rm.metric(HBM_INTENSITY)[:, rm.col(rid)] *= self.byte_factor

    @property
    def paths(self) -> Tuple[str, ...]:
        return (self.region,)


@dataclasses.dataclass(frozen=True)
class MemoryPressure:
    """Working set blows past fast memory: VMEM pressure (the L1-rate
    analogue) jumps to ``pressure`` and the region slows by ``slowdown``×
    on every process."""

    region: str
    pressure: float = 0.45
    slowdown: float = 4.0
    kind: ClassVar[str] = DISPARITY
    causes: ClassVar[FrozenSet[str]] = frozenset({VMEM_PRESSURE})

    def apply(self, tree: RegionTree, rm: RegionMetrics,
              rng: np.random.Generator) -> None:
        ones = np.ones(rm.n_processes)
        for metric in (WALL_TIME, CPU_TIME):
            _scale_cells(tree, rm, self.region, metric, ones * self.slowdown)
        rid = tree.by_path(self.region).region_id
        rm.metric(VMEM_PRESSURE)[:, rm.col(rid)] = self.pressure

    @property
    def paths(self) -> Tuple[str, ...]:
        return (self.region,)


@dataclasses.dataclass(frozen=True)
class IOHotspot:
    """A region turns disk/host-I/O bound (the paper's ST region 8, 106 GB
    unbuffered writes): ``extra_bytes`` of host traffic and ``slowdown``×
    wall time — waiting, so the CPU clock is untouched."""

    region: str
    extra_bytes: float = 100e9
    slowdown: float = 6.0
    kind: ClassVar[str] = DISPARITY
    causes: ClassVar[FrozenSet[str]] = frozenset({HOST_BYTES})

    def apply(self, tree: RegionTree, rm: RegionMetrics,
              rng: np.random.Generator) -> None:
        ones = np.ones(rm.n_processes)
        _add_cells(tree, rm, self.region, HOST_BYTES,
                   ones * self.extra_bytes)
        _scale_cells(tree, rm, self.region, WALL_TIME, ones * self.slowdown)

    @property
    def paths(self) -> Tuple[str, ...]:
        return (self.region,)


@dataclasses.dataclass(frozen=True)
class ComputeHotspot:
    """One region simply does ``factor``× everyone else's work on every
    process — the NPAR1WAY region-3 instructions-retired disparity."""

    region: str
    factor: float = 8.0
    kind: ClassVar[str] = DISPARITY
    causes: ClassVar[FrozenSet[str]] = frozenset({FLOPS})

    def apply(self, tree: RegionTree, rm: RegionMetrics,
              rng: np.random.Generator) -> None:
        ones = np.ones(rm.n_processes)
        for metric in _WORK_METRICS:
            _scale_cells(tree, rm, self.region, metric, ones * self.factor)

    @property
    def paths(self) -> Tuple[str, ...]:
        return (self.region,)


@dataclasses.dataclass(frozen=True)
class ExpertLoadImbalance:
    """MoE routing collapse toward one expert: the hot expert processes
    ``factor``× the tokens, and once its capacity saturates each token also
    waits ``congestion``× longer (queueing — time inflates beyond the token
    count, the signature that separates collapse from benign skew).  With
    ``procs`` set, only those data shards route hot (a dissimilarity);
    otherwise every shard does (a disparity on the hot expert's region)."""

    layer: str                     # path of the layer region
    hot_expert: int
    factor: float = 4.0
    congestion: float = 1.0
    procs: Optional[Tuple[int, ...]] = None
    causes: ClassVar[FrozenSet[str]] = frozenset({FLOPS})

    @property
    def kind(self) -> str:
        return DISPARITY if self.procs is None else DISSIMILARITY

    @property
    def hot_path(self) -> str:
        return f"{self.layer}/expert_{self.hot_expert}"

    def apply(self, tree: RegionTree, rm: RegionMetrics,
              rng: np.random.Generator) -> None:
        layer = tree.by_path(self.layer)
        if not any(c.name == f"expert_{self.hot_expert}"
                   for c in layer.children):
            raise ValueError(f"no expert_{self.hot_expert} under {self.layer}")
        m = rm.n_processes
        work_f = (_proc_factors(m, self.procs, self.factor)
                  if self.procs is not None else np.full(m, self.factor))
        time_f = (_proc_factors(m, self.procs,
                                self.factor * self.congestion)
                  if self.procs is not None
                  else np.full(m, self.factor * self.congestion))
        for metric in (FLOPS, BYTES):
            _scale_cells(tree, rm, self.hot_path, metric, work_f)
        for metric in (WALL_TIME, CPU_TIME):
            _scale_cells(tree, rm, self.hot_path, metric, time_f)

    @property
    def paths(self) -> Tuple[str, ...]:
        return (self.hot_path,)


@dataclasses.dataclass(frozen=True)
class ThermalThrottleDrift:
    """Designated processes slow down progressively across the run — a
    chip heating up and down-clocking (time-varying, so only the trace
    layer's per-step axis can express it; a single-snapshot collection
    sees just the average).  The chip runs at full clock until
    ``onset_step`` (heat soak), then ramps linearly: per step
    ``s >= onset_step`` the throttled processes' wall *and* CPU time in
    ``region`` scale by

        1 + (peak_factor - 1) * ((s - onset_step + 1)
                                 / (n_steps - onset_step))

    reaching ``peak_factor`` at the final step (``onset_step=0``, the
    default, is the original whole-run ramp, bit-for-bit).  The onset
    step is what the streaming layer's onset detector must localize in
    time (the reference's docs/streaming.md).  Same
    instructions, lower clock: no quantity metric inflates, so (like
    :class:`CollectiveStraggler`) ``causes`` is empty; unlike the pure-
    waiting archetypes the CPU clock stretches too, so the default
    CPU-time similarity metric sees it."""

    region: str
    procs: Tuple[int, ...]
    peak_factor: float = 4.0
    onset_step: int = 0
    kind: ClassVar[str] = DISSIMILARITY
    causes: ClassVar[FrozenSet[str]] = frozenset()

    def apply_trace(self, tree: RegionTree, trace: RegionTrace,
                    rng: np.random.Generator) -> None:
        if not (0 <= self.onset_step < trace.n_steps):
            raise ValueError(f"onset_step {self.onset_step} outside the "
                             f"{trace.n_steps}-step run")
        rid = tree.by_path(self.region).region_id
        j = trace.col(rid)
        # _ancestor_cols only needs .col(), which RegionTrace shares with
        # RegionMetrics — same inclusive-timing propagation, per step.
        anc = _ancestor_cols(tree, trace, rid)
        mask = np.zeros(trace.n_processes)
        mask[list(self.procs)] = 1.0
        for s in range(self.onset_step, trace.n_steps):
            ramp = (self.peak_factor - 1.0) * (s - self.onset_step + 1) \
                / (trace.n_steps - self.onset_step)
            factors = 1.0 + mask * ramp
            for metric in (WALL_TIME, CPU_TIME):
                M = trace.metric(metric)[s]          # (R, m, n) view
                deltas = M[:, :, j] * (factors - 1.0)
                M[:, :, j] += deltas
                for c in anc:
                    M[:, :, c] += deltas

    @property
    def paths(self) -> Tuple[str, ...]:
        return (self.region,)


def inject(tree: RegionTree, rm: RegionMetrics,
           faults: Sequence, seed: int = 0) -> RegionMetrics:
    """Apply ``faults`` in order to ``rm`` (mutates and returns it).

    Deterministic: the shared rng is seeded from ``seed`` alone, so the same
    (metrics, faults, seed) triple always yields the same perturbation."""
    rng = np.random.default_rng(seed + 0x5EED)
    for f in faults:
        f.apply(tree, rm, rng)
    return rm


def inject_trace(tree: RegionTree, trace: RegionTrace,
                 faults: Sequence, seed: int = 0) -> RegionTrace:
    """Trace-level injection (mutates and returns ``trace``).

    Step-aware archetypes (those defining ``apply_trace``) perturb the
    per-step samples directly.  Classic snapshot archetypes apply to each
    (step, repeat) slice through a mutable :meth:`RegionTrace.step_views`
    view — for a single-step, single-repeat trace the rng stream and the
    arithmetic match :func:`inject` on the reduced metrics exactly, which
    keeps the pre-trace corpus verdicts bit-identical."""
    # Views only alias metrics the trace already holds; materialize the
    # standard set so an archetype writing e.g. vmem_pressure into a
    # runtime trace (which records five metrics) is not silently lost.
    from repro_torch.core.metrics import RAW_METRICS
    for name in RAW_METRICS:
        trace.metric(name)
    rng = np.random.default_rng(seed + 0x5EED)
    for f in faults:
        if hasattr(f, "apply_trace"):
            f.apply_trace(tree, trace, rng)
        else:
            for view in trace.step_views():
                f.apply(tree, view, rng)
    return trace


# -- runtime backend ------------------------------------------------------

def iterated_work(fn, indexed: bool = False):
    """Wrap a region callable for the runtime fault backend.

    ``fn(state, data) -> state`` becomes ``wrapped(state, (data, iters))``
    running the body ``iters`` times in a host loop: one callable serves
    every shard, and a shard whose bundle carries a larger ``iters``
    genuinely executes (and launches) more work — calibrated extra work
    rather than a post-hoc metric edit.  The reference runs the same loop
    as a data-driven ``fori_loop``; eager PyTorch has no loop-invariant
    code motion to defeat, so each iteration is the body's full work.
    With ``indexed=True`` the body receives ``(data, i)`` instead of
    ``data``."""

    def wrapped(state, bundle):
        data, iters = bundle
        for i in range(int(iters)):
            state = fn(state, (data, i) if indexed else data)
        return state

    return wrapped
