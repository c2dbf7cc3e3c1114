"""Collectors: produce :class:`RegionTrace` samples from real or simulated
runs (paper §4.1 step 2, §5 "Data collector").

Collection is decoupled from analysis: a collector records raw
per-(step, repeat, shard, region) samples into a :class:`RegionTrace` and
derives its classic :class:`RegionMetrics` output through the single
deterministic :meth:`RegionTrace.reduce` path — so an in-process analysis
and an offline analysis of the saved artifact see bit-identical inputs.

The PyTorch port of the reference's ``repro/core/collector.py``, with its
three backends:

* :class:`TimedRegionRunner` — runtime collector.  Runs a region tree
  whose leaves carry callables on tensors of one device (the card unless
  the caller asks for the CPU), timing each call: wall time is the host's
  ``perf_counter`` around the call ending in ``torch.cuda.synchronize()``
  (the twin of the reference's ``block_until_ready``), CPU time the
  chosen CPU clock (:func:`_pick_cpu_clock`), FLOPs and bytes
  :func:`~repro_torch.core.hlo.cost_of`'s.  CUDA events around the same
  call give each region's device time beside the trace.  "Processes" are
  emulated SPMD shards: the same region callables run once per shard on
  that shard's data.
* :func:`static_metrics_from_costs` — dry-run collector: metrics from
  per-region static costs broadcast over shards.
* :class:`SyntheticWorkload` — generates metrics with injected behaviours
  (imbalance, I/O-heavy regions, cache-hostile regions) used to reproduce
  the paper's ST / NPAR1WAY / MPIBZIP2 studies and the fault corpus.  It is
  numpy-only and draws the same random stream as the reference, so a
  scenario collected by either package holds the same samples bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device

from . import hlo as hlo_mod
from .metrics import (BYTES, COMM_BYTES, COMM_TIME, CPU_TIME, FLOPS,
                      HBM_INTENSITY, HOST_BYTES, RAW_METRICS, VMEM_PRESSURE,
                      WALL_TIME, RegionMetrics)
from .regions import CodeRegion, RegionTree
from .trace import RegionTrace


def _measure_tick(clock: Callable[[], float],
                  resolution: float) -> Optional[float]:
    """Effective resolution of a CPU clock.

    Some kernels advance CPU clocks in ~10ms jiffies even though the
    advertised resolution is nanoseconds; measure the actual tick by
    spinning until the clock moves (bounded at 50ms of busy work).  Returns
    None when the clock never advanced — e.g. the spin itself got preempted
    — so a failed calibration is retried rather than trusted."""
    t0 = clock()
    deadline = time.perf_counter() + 0.05
    while time.perf_counter() < deadline:
        t1 = clock()
        if t1 != t0:
            return max(resolution, t1 - t0)
    return None


def _cpu_clock_tick() -> Optional[float]:
    """Measured tick of ``time.process_time`` (the classic CPU clock)."""
    return _measure_tick(time.process_time,
                         time.get_clock_info("process_time").resolution)


def _thread_clock_attributes_torch(clock: Callable[[], float],
                                   tick: float) -> bool:
    """Does tensor work accrue on the *calling* thread's CPU clock?

    PyTorch may run an operator on its intra-op worker threads, in which
    case ``CLOCK_THREAD_CPUTIME_ID`` of the timing thread reads ~0 for a
    region that genuinely burned CPU — per-thread timing would then report
    every compute region as idle.  Probe with a CPU matrix product long
    enough to span several ticks: accept the thread clock only when it
    observed at least half the wall time."""
    x = torch.ones((256, 256), dtype=torch.float32)
    torch.tanh(x @ x).sum()                          # warm up outside
    budget = max(4.0 * tick, 0.02)
    t0w, t0c = time.perf_counter(), clock()
    while time.perf_counter() - t0w < budget:
        torch.tanh(x @ x).sum()
    wall, cpu = time.perf_counter() - t0w, clock() - t0c
    return cpu >= 0.5 * wall


def _pick_cpu_clock() -> Tuple[Callable[[], float], Optional[float], str]:
    """Choose the CPU clock for region timing: ``(clock, tick, name)``.

    Prefers the per-thread CPU clock (``CLOCK_THREAD_CPUTIME_ID``) over
    ``time.process_time`` — but only when it is measurably *finer* than the
    process clock's jiffy tick AND tensor work actually accrues on the
    calling thread (see :func:`_thread_clock_attributes_torch`); otherwise
    region timing keeps the process clock, whose coarse tick the
    reduce-time snap (``RegionTrace.reduce``) already compensates for.  A
    None tick means calibration failed this time and should be retried."""
    process_tick = _cpu_clock_tick()
    if hasattr(time, "clock_gettime") and \
            hasattr(time, "CLOCK_THREAD_CPUTIME_ID"):
        clk_id = time.CLOCK_THREAD_CPUTIME_ID

        def thread_clock() -> float:
            return time.clock_gettime(clk_id)

        thread_tick = _measure_tick(thread_clock, time.clock_getres(clk_id))
        if (thread_tick is not None
                and (process_tick is None or thread_tick < process_tick)
                and _thread_clock_attributes_torch(thread_clock,
                                                   thread_tick)):
            return thread_clock, thread_tick, "thread"
    return time.process_time, process_tick, "process"


@contextlib.contextmanager
def _calling_thread_only(device: torch.device):
    """On the CPU, run PyTorch's operators on the calling thread alone
    (``torch.set_num_threads(1)``) for the block, then restore the count.

    A region's CPU time must be its own work.  With the intra-op pool on,
    PyTorch hands even a (64, 64) product to worker threads that spin
    while they wait: the process clock then charges the spin to whichever
    region woke them, and on a loaded host the wait itself runs to
    milliseconds (a 4-iteration expert probe of mixtral-smoke, 0.2 ms on
    one thread, read 0.5 s of wall and 0.7 s of CPU at worst of 20 alone
    on 8 threads, and its 48-iteration twin a median CPU time 10x its
    minimum).  The reference's XLA runs computations this small on the
    calling thread.  The card's regions are not affected."""
    if device.type != "cpu":
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# Share of a CPU take's wall time its thread may spend off the CPU before
# the take reads as descheduled (:func:`_descheduled`), and how many times
# such a take is taken again.
OFF_CPU_SHARE = 0.25
RETAKES = 3


def _descheduled(wall: float, cpu: float, tick: float) -> bool:
    """Was the timing thread off the CPU for a real part of this take?

    On the CPU every operator of a region runs on the calling thread
    (:func:`_calling_thread_only`), so ``wall - cpu`` is time the region's
    own thread did not run: the scheduler gave its core to another
    process.  A take is descheduled when that gap exceeds
    :data:`OFF_CPU_SHARE` of its wall and two ticks of the CPU clock (a
    coarse clock reads a short region's CPU time as 0 or one tick, so
    below two ticks the gap is the clock's, not the scheduler's)."""
    return wall - cpu > max(OFF_CPU_SHARE * wall, 2.0 * tick)


class TimedRegionRunner:
    """Run an instrumented step shard-by-shard, region-by-region.

    Region callables have signature ``fn(state, data) -> state`` on
    tensors of the runner's device, where ``state`` is threaded through
    the regions in tree (pre-order) sequence and ``data`` is the shard's
    input batch.  There is no jit: each call runs eagerly.

    ``repeats`` measures each (region, shard) pair that many times, and
    :meth:`RegionTrace.reduce` keeps the minimum (the classic noise-robust
    timing statistic — scheduler preemption only ever adds time), so load
    on the host does not masquerade as process dissimilarity.  The takes
    run repeat-major, in ``repeats`` rounds: each round takes every region
    of every shard once, regions in tree order, shards in turn, each
    region on the same input state in every round (the first round also
    counts each region's cost and warms each shard up right before its
    take, and its outputs carry the state on; with one repeat that is
    the whole order).  A burst then lands on one take of one shard, and a
    drift of the host that lasts a region's takes on every shard (one
    expert probe read 2.9x its neighbours on all 12 takes of a window on
    an H100) lands on one round of them; the minimum drops both.  Every
    take is recorded; the header states the order and the rule
    (``meta["takes"]``).

    On the CPU a take whose thread was descheduled (:func:`_descheduled`)
    is taken again, up to :data:`RETAKES` times, and the take with the
    least wall time is recorded: with one repeat a single preemption
    would otherwise be the sample (beside CPU-bound processes such a
    sample made a sub-millisecond expert probe read hot, and broke the
    MoE recovery entry's persisting verdict).  :attr:`retakes` counts the takes made again,
    and each trace's header states the rule and its own count
    (``meta["retake"]``, :meth:`run_trace`).
    The card's regions are not taken again: their wall includes the
    device's time, which no CPU clock sees.

    Each region's FLOPs and bytes come from one
    :func:`~repro_torch.core.hlo.cost_of` call on shard 0's inputs, made
    once before any timed call and never timed; they are the same for
    every shard, as the reference's compiled costs are.  ``COMM_BYTES`` is
    the result bytes of the collectives the same call issues
    (:func:`~repro_torch.core.hlo.collectives_of`): 0 for a region on one
    card with no process group.

    On the CPU every call (and the CPU clock's calibration) runs on the
    calling thread alone (:func:`_calling_thread_only`).

    ``WALL_TIME`` is the host's ``perf_counter`` around the call, ending
    in ``torch.cuda.synchronize()`` on the card — device time alone would
    hide a host-side straggler, which the wall shows.  CUDA events
    recorded around the same call give the region's device time in
    :attr:`device_s` (``{region_id: (shards, repeats) seconds}``; empty on
    the CPU); it is not a trace metric, because the reference has none.

    The CPU clock is chosen once per process by :func:`_pick_cpu_clock`:
    the per-thread clock when it is finer than ``time.process_time``'s
    jiffy tick *and* tensor work accrues on the calling thread, else the
    process clock.  Either way the measured tick lands in the trace header
    (``cpu_tick``) and drives the reduce-time quantization guard: when a
    region's wall time is below the tick the CPU delta is pure noise (0 or
    one full jiffy) and the wall delta stands in.
    """

    # class-level lazy cache: (clock, measured tick, clock name)
    _cpu_clock: Optional[Tuple[Callable[[], float], float, str]] = None

    def __init__(self, tree: RegionTree, warmup: int = 1, repeats: int = 3,
                 device: Union[None, str, torch.device] = None):
        self.tree = tree
        self.warmup = warmup
        self.repeats = max(1, repeats)
        self.device = resolve_device(device)
        self.costs: Dict[int, Tuple[float, float, float]] = {}
        self.device_s: Dict[int, np.ndarray] = {}
        self.retakes = 0

    def _leaf_regions(self) -> List[CodeRegion]:
        return [r for r in self.tree.regions() if r.fn is not None]

    def run_trace(self, shard_states: Sequence[Any],
                  shard_data: Sequence[Any]) -> RegionTrace:
        """Execute one instrumented step and record *raw* samples: every
        repeat's wall/CPU reading survives into the trace; min-of-repeats
        and the CPU-tick snap happen in :meth:`RegionTrace.reduce`, driven
        by the ``cpu_tick`` stored in the header — so an offline analysis
        of the saved artifact reproduces this host's decisions exactly.

        The takes are made in rounds over the whole step
        (``meta["takes"]``: ``order`` ``"repeat-major"``, ``reduce``
        ``"min"``).  The one choice made before a sample is recorded is
        the CPU's retake rule: a take whose thread was descheduled is
        taken again and the least-wall take of it and its retakes is the
        repeat's sample; the others are dropped.  The header's
        ``meta["retake"]`` states the rule (``off_cpu_share``, ``most``
        takes again a sample: 0 on the card) and how many takes this call
        made again (``made``); a merged trace keeps its first trace's
        header."""
        with _calling_thread_only(self.device):
            return self._run_trace(shard_states, shard_data)

    def _run_trace(self, shard_states: Sequence[Any],
                   shard_data: Sequence[Any]) -> RegionTrace:
        regions = self._leaf_regions()
        m = len(shard_states)
        states = list(shard_states)
        # Lazy: clock selection busy-spins up to 50ms per candidate (plus
        # a short matrix-product probe when the thread clock looks finer),
        # so pay it only when actually timing.  Cached once calibration
        # succeeds; a failed calibration (None tick) falls back to the
        # advertised process-clock resolution for this run and is
        # re-attempted next time.
        if TimedRegionRunner._cpu_clock is None:
            clock, tick, name = _pick_cpu_clock()
            if tick is not None:
                TimedRegionRunner._cpu_clock = (clock, tick, name)
        else:
            clock, tick, name = TimedRegionRunner._cpu_clock
        if tick is None:
            tick = time.get_clock_info("process_time").resolution
        trace = RegionTrace.for_tree(
            self.tree, [r.region_id for r in regions], m,
            n_steps=1, n_repeats=self.repeats,
            meta={"collector": "runtime", "cpu_tick": tick,
                  "cpu_clock": name, "derived": True})
        on_card = self.device.type == "cuda"
        most = 0 if on_card else RETAKES
        made = 0

        def sync() -> None:
            if on_card:
                torch.cuda.synchronize(self.device)

        def take(r: CodeRegion, k: int, i: int, state: Any) -> Any:
            """Time one call of ``r`` on shard ``i``'s ``state`` as repeat
            ``k`` and record it; return its output."""
            nonlocal made
            rid = r.region_id
            if on_card:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            t0w, t0c = time.perf_counter(), clock()
            out = r.fn(state, shard_data[i])
            if on_card:
                ev1.record()
            sync()
            t1w, t1c = time.perf_counter(), clock()
            wall, cpu = t1w - t0w, t1c - t0c
            for _ in range(most):
                if not _descheduled(wall, cpu, tick):
                    break
                made += 1
                t0w, t0c = time.perf_counter(), clock()
                out = r.fn(state, shard_data[i])
                t1w, t1c = time.perf_counter(), clock()
                if t1w - t0w < wall:
                    wall, cpu = t1w - t0w, t1c - t0c
            flops, byts, comm = self.costs[rid]
            trace.record(WALL_TIME, 0, k, i, rid, wall)
            trace.record(CPU_TIME, 0, k, i, rid, cpu)
            trace.record(FLOPS, 0, k, i, rid, flops)
            trace.record(BYTES, 0, k, i, rid, byts)
            trace.record(COMM_BYTES, 0, k, i, rid, comm)
            if on_card:
                self.device_s[rid][i, k] = ev0.elapsed_time(ev1) / 1e3
            return out

        inputs = {}                      # region id -> each shard's input
        for r in regions:
            rid = r.region_id
            if rid not in self.costs:
                flops, byts, coll = hlo_mod.costs_of(r.fn, states[0],
                                                     shard_data[0])
                self.costs[rid] = (flops, byts, float(coll.total_bytes))
            if on_card:
                self.device_s[rid] = np.zeros((m, self.repeats))
            if self.repeats > 1:
                inputs[rid] = list(states)
            for i in range(m):
                # Each shard's warmup right before its first take: the
                # take then reuses the blocks the warmup freed, so no
                # allocation of the card's caching allocator lands in it.
                for _ in range(self.warmup):
                    r.fn(states[i], shard_data[i])
                    sync()
                states[i] = take(r, 0, i, states[i])
        for k in range(1, self.repeats):
            for r in regions:
                for i in range(m):
                    take(r, k, i, inputs[r.region_id][i])
        self.retakes += made
        trace.meta["takes"] = {"order": "repeat-major", "reduce": "min"}
        trace.meta["retake"] = {"off_cpu_share": OFF_CPU_SHARE,
                                "most": most, "made": made}
        self.final_states = states
        return trace

    def run(self, shard_states: Sequence[Any],
            shard_data: Sequence[Any]) -> RegionMetrics:
        return self.run_trace(shard_states, shard_data).reduce()


def static_trace_from_costs(
    tree: RegionTree,
    region_ids: Sequence[int],
    costs: Dict[int, Dict[str, float]],
    n_processes: int = 1,
) -> RegionTrace:
    """Dry-run backend: per-region static costs -> single-step trace.

    ``costs[rid]`` maps metric name -> value (same for every shard; the
    dry-run has no per-shard variation by construction).
    """
    trace = RegionTrace.for_tree(
        tree, list(region_ids), n_processes,
        meta={"collector": "static", "derived": True})
    for rid in region_ids:
        for name, v in costs.get(rid, {}).items():
            trace.metric(name)[0, 0, :, trace.col(rid)] = float(v)
    return trace


def static_metrics_from_costs(
    region_ids: Sequence[int],
    costs: Dict[int, Dict[str, float]],
    n_processes: int = 1,
    tree: Optional[RegionTree] = None,
) -> RegionMetrics:
    """Classic dry-run entry point, routed through the trace layer.

    Without a ``tree`` the trace header gets a flat stand-in schema (the
    static callers predate region trees); the reduction is identical."""
    if tree is None:
        tree = RegionTree("static")
        for rid in region_ids:
            tree.add(f"cr{rid}", region_id=rid)   # raises if rid is 0
    return static_trace_from_costs(tree, region_ids, costs,
                                   n_processes).reduce()


@dataclasses.dataclass
class RegionBehavior:
    """Synthetic behaviour of one code region (per-shard parametrised)."""

    base_time: float = 0.0
    # per-process multiplicative imbalance on time & flops (len m or scalar)
    imbalance: Optional[Sequence[float]] = None
    flops_per_s: float = 1e9
    hbm_intensity: float = 0.05      # bytes/flop (L2-miss-rate analogue)
    vmem_pressure: float = 0.05      # L1-miss-rate analogue
    host_bytes: float = 0.0          # disk-I/O analogue
    comm_bytes: float = 0.0          # network-I/O analogue
    comm_time_frac: float = 0.0
    management: bool = False


class SyntheticWorkload:
    """Generates RegionMetrics from declared per-region behaviours.

    Deterministic given the seed; a small multiplicative jitter models
    measurement noise (kept below the OPTICS threshold so it never creates
    spurious clusters).
    """

    def __init__(self, tree: RegionTree,
                 behaviors: Dict[int, RegionBehavior],
                 n_processes: int, seed: int = 0, jitter: float = 0.005):
        self.tree = tree
        self.behaviors = behaviors
        self.m = n_processes
        self.rng = np.random.default_rng(seed)
        self.jitter = jitter

    def collect_trace(self, n_steps: int = 1) -> RegionTrace:
        """Per-step samples: every step re-runs the declared behaviour
        with a fresh measurement-noise draw (one ``standard_normal(m)``
        per (region, step), region-major — for ``n_steps=1`` the rng
        stream is consumed exactly as the classic single-shot collection
        did, so the reduced metrics are bit-identical)."""
        rids = sorted(self.behaviors)
        trace = RegionTrace.for_tree(
            self.tree, rids, self.m, n_steps=n_steps,
            metrics=RAW_METRICS, meta={"collector": "synthetic"})
        for rid, b in self.behaviors.items():
            j = trace.col(rid)
            if b.imbalance is None:
                scale = np.ones(self.m)
            else:
                scale = np.asarray(b.imbalance, dtype=np.float64)
                if scale.size == 1:
                    scale = np.full(self.m, float(scale))
            noise = 1.0 + self.jitter * self.rng.standard_normal(
                (n_steps, self.m))
            t = b.base_time * scale * noise           # (S, m)
            trace.metric(WALL_TIME)[:, 0, :, j] = t
            trace.metric(CPU_TIME)[:, 0, :, j] = t * (1.0 - b.comm_time_frac)
            trace.metric(FLOPS)[:, 0, :, j] = t * b.flops_per_s
            trace.metric(BYTES)[:, 0, :, j] = \
                t * b.flops_per_s * b.hbm_intensity
            trace.metric(VMEM_PRESSURE)[:, 0, :, j] = b.vmem_pressure
            trace.metric(HBM_INTENSITY)[:, 0, :, j] = b.hbm_intensity
            trace.metric(HOST_BYTES)[:, 0, :, j] = b.host_bytes * scale
            trace.metric(COMM_BYTES)[:, 0, :, j] = b.comm_bytes * scale
            trace.metric(COMM_TIME)[:, 0, :, j] = t * b.comm_time_frac
        return trace

    def collect(self) -> RegionMetrics:
        return self.collect_trace().reduce()
