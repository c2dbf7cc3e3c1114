"""Collectors: produce :class:`RegionTrace` samples from simulated runs
(paper §4.1 step 2, §5 "Data collector").

Collection is decoupled from analysis: a collector records raw
per-(step, repeat, shard, region) samples into a :class:`RegionTrace` and
derives its classic :class:`RegionMetrics` output through the single
deterministic :meth:`RegionTrace.reduce` path — so an in-process analysis
and an offline analysis of the saved artifact see bit-identical inputs.

This part of the port holds the synthetic backend —
:class:`SyntheticWorkload` generates metrics with injected behaviours
(imbalance, I/O-heavy regions, cache-hostile regions) used to reproduce
the paper's ST / NPAR1WAY / MPIBZIP2 studies and the fault corpus.  It is
numpy-only and draws the same random stream as the reference, so a
scenario collected by either package holds the same samples bit for bit —
and the CPU-clock calibration (:func:`_pick_cpu_clock`) that the serving
runtime (``repro_torch.serve.runtime``) records in its trace header.  The
runtime collector that times real regions on the card
(``TimedRegionRunner``) and the static collectors are not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .metrics import (BYTES, COMM_BYTES, COMM_TIME, CPU_TIME, FLOPS,
                      HBM_INTENSITY, HOST_BYTES, RAW_METRICS, VMEM_PRESSURE,
                      WALL_TIME, RegionMetrics)
from .regions import RegionTree
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
