"""Golden fault-injection corpus: named scenarios with machine-checkable
ground truth, pipelined end-to-end through :class:`AutoAnalyzer`.

Each :class:`CorpusEntry` pairs a *builder* (seed -> (tree, collector)) with
a :class:`GroundTruth` (which region paths the analysis must locate, which
decision attributes must surface as causes, and whether the planted
bottleneck is a dissimilarity or a disparity).  The registry spans the
paper's three applications (ST, NPAR1WAY, MPIBZIP2) plus MoE and dense
transformer trees derived from the ``repro_torch.configs`` smoke models.

The PyTorch port of the reference's ``repro/scenarios/corpus.py``, over
seven backends:

* ``synthetic`` — clean balanced baseline behaviours through
  :class:`SyntheticWorkload`, then deterministic fault perturbation
  (scenarios/faults.py).  Bit-reproducible given the seed, and the same 19
  entries as the reference, so their verdicts can be held against the
  committed ``VERDICTS_synthetic.json``.
* ``runtime``  — real execution on the card through
  :class:`TimedRegionRunner`, with designated shards running genuinely
  more work via :func:`faults.iterated_work`.
* ``train``    — a real region-instrumented smoke :class:`Trainer` run
  (train/loop.py) on the device the caller names: the actual
  forward/backward + optimizer regions, fault-injected through per-shard
  iteration counts, analyzed from the trace the trainer emits.
* ``recovery`` — the closed mitigation loop: live per-step verdicts drive
  a :class:`MitigationPolicy` and the entry is additionally scored against
  a :class:`RecoveryTruth` (which action, by when, and that the fault
  actually cleared).
* ``chaos``    — infrastructure fault injection (scenarios/chaos.py): the
  fault lands on the spool writer, the checkpoint writer or the live
  consumer, and the entry is scored against a
  :class:`~repro_torch.scenarios.chaos.ChaosTruth`.
* ``fleet``    — one tenant (or two) of eight concurrent spools tailed by
  a :class:`~repro_torch.fleet.FleetIngest` is attacked; every other
  tenant's window verdicts must equal a solo tail's.
* ``serving``  — deterministic cost-model traffic through the serving
  engine's scheduler, serving-only archetypes injected per engine step
  through the engine's step hook, and a :class:`ServingTruth` (the traffic
  actually got served).  Bit-reproducible given the seed.

``evaluate_corpus`` scores every entry (precision/recall of located paths,
cause recall) — the paper's validation experiment as a regression gate.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import (Any, Callable, Dict, FrozenSet, List, Optional, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.core import (COMM_BYTES, FLOPS, HBM_INTENSITY, HOST_BYTES,
                              VMEM_PRESSURE, WALL_TIME, AutoAnalyzer,
                              RegionBehavior, RegionMetrics, RegionTrace,
                              RegionTree, SyntheticWorkload,
                              TimedRegionRunner, Verdict, st_region_tree)
from repro_torch.stream import OnlineAnalyzer

from . import faults as F
from .traffic import saturated_sessions
from .chaos import (EMPTY_VERDICT, ChaosTruth, CheckpointChaosCollector,
                    CorruptLatestCheckpoint, FleetAnalysisLagFlood,
                    FleetChaosCollector, FleetConcurrentKill,
                    FleetTenantCorruption, FlipBytesInSegment,
                    KillProducerMidChunk, SpoolChaosCollector,
                    StallProducer, TruncateSegment)

N_PROCESSES = 8


# -- ground truth and registry -------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroundTruth:
    """What a corpus entry plants, in verdict-comparable terms."""

    kind: str                               # dissimilarity | disparity | both
    bottleneck_paths: FrozenSet[str]
    cause_attributes: FrozenSet[str] = frozenset()


@dataclasses.dataclass(frozen=True)
class RecoveryTruth:
    """Ground truth for the closed mitigation loop (docs/mitigation.md),
    the recovery analogue of ``expect_onset_window``: which action the
    MitigationPolicy must take, by when (time-to-mitigate, in policy
    window indices), and how many consecutive *clean* verdict windows
    must close the run afterwards (the mitigation actually cleared the
    fault — not just fired)."""

    kind: str                    # expected MitigationAction.kind
    mitigate_by_window: int      # action window index must be <= this
    clean_windows: int           # trailing clean windows required


@dataclasses.dataclass(frozen=True)
class ServingTruth:
    """Ground truth for the serving engine itself (backend "serving"):
    locating the planted bottleneck only counts if the engine also did
    its job — at least ``min_completed`` requests finished inside the
    entry's step budget.  Deterministic scheduling makes the expected
    count exact, so entries pin it tight."""

    min_completed: int


@dataclasses.dataclass(frozen=True)
class CorpusEntry:
    name: str
    # st | npar1way | mpibzip2 | moe | transformer | runtime | train | chaos
    # | fleet | serve
    app: str
    # synthetic | runtime | train | recovery | chaos | fleet | serving
    backend: str
    description: str
    build: Callable[[int], Tuple[RegionTree, Any]]
    truth: GroundTruth
    analyzer_kw: Tuple[Tuple[str, Any], ...] = ()
    # Ratcheted from the original 0.34 floor: every synthetic entry has
    # held precision 1.0 across seeds {0,1,2,3,7,11}, so the default now
    # tolerates no spurious located path (one spurious on a single-truth
    # entry reads 0.5).  Wall-clock backends (runtime/train) keep explicit
    # wider floors.
    min_precision: float = 0.9
    # -- time localization -------------------------------------------------
    # When set, the entry's trace is additionally replayed through an
    # OnlineAnalyzer in onset_window_steps-step tumbling windows, and the
    # detected onset window (first window whose bottleneck verdict
    # persists onset_persist windows) must equal this id.
    expect_onset_window: Optional[int] = None
    onset_window_steps: int = 4
    onset_persist: int = 2
    # -- recovery (closed mitigation loop, train/mitigate.py) --------------
    # When set, the entry runs the full loop — live per-step verdicts
    # drive a MitigationPolicy — and is scored against recovery ground
    # truth in addition to locating the planted fault (the location is
    # scored from the verdict that *triggered* the action: the loop must
    # have acted for the right reason).
    recovery: Optional[RecoveryTruth] = None
    # -- chaos (infrastructure fault injection, scenarios/chaos.py) --------
    # When set, the collector runs an infrastructure-fault archetype
    # against the real pipeline and the outcome (survival, quarantine
    # accounting, clean-vs-chaos window verdict identity) must satisfy
    # this truth in addition to the regular verdict score.
    chaos: Optional[ChaosTruth] = None
    # -- serving (the serve engine) ----------------------------------------
    # When set, the entry's collector drove traffic through the serving
    # engine and must have completed at least this many requests.
    serving: Optional[ServingTruth] = None


CORPUS: Dict[str, CorpusEntry] = {}


def register_entry(entry: CorpusEntry) -> CorpusEntry:
    if entry.name in CORPUS:
        raise ValueError(f"duplicate corpus entry {entry.name!r}")
    CORPUS[entry.name] = entry
    return entry


def corpus_entries(backend: Optional[str] = None,
                   app: Optional[str] = None) -> List[CorpusEntry]:
    out = [e for e in CORPUS.values()
           if (backend is None or e.backend == backend)
           and (app is None or e.app == app)]
    return sorted(out, key=lambda e: e.name)


# -- collectors -----------------------------------------------------------

class FaultedSyntheticCollector:
    """Synthetic backend: balanced baseline behaviours + fault injection.
    Deterministic given the seed (measurement jitter and fault rng both
    derive from it); no device execution.  Collection emits a
    :class:`RegionTrace` (``n_steps`` samples; step-aware archetypes like
    ``ThermalThrottleDrift`` perturb the per-step axis) and the classic
    metrics fall out of the trace's deterministic reduction."""

    def __init__(self, tree: RegionTree,
                 behaviors: Dict[int, RegionBehavior],
                 fault_list: Tuple, seed: int,
                 n_processes: int = N_PROCESSES, n_steps: int = 1):
        self.tree = tree
        self.behaviors = behaviors
        self.faults = fault_list
        self.seed = seed
        self.m = n_processes
        self.n_steps = n_steps
        self.last_trace: Optional[RegionTrace] = None

    def collect_trace(self) -> RegionTrace:
        wl = SyntheticWorkload(self.tree, self.behaviors, self.m,
                               seed=self.seed)
        self.last_trace = F.inject_trace(
            self.tree, wl.collect_trace(self.n_steps), self.faults,
            seed=self.seed)
        return self.last_trace

    def collect(self) -> RegionMetrics:
        return self.collect_trace().reduce()


class ServingFaultCollector:
    """Serving backend: deterministic cost-model traffic through the real
    :class:`~repro.serve.ServeEngine` scheduler, with the serving fault
    archetypes injected *per engine step* through the engine's step hook
    rather than post-hoc — so a spool (or live tail) of the run carries
    the faulted samples while the traffic is still in flight, and the
    merged trace the whole-run verdict scores is the exact same data.
    The serving archetypes are rng-free and schedule-conditioned, so
    per-step injection is bit-identical to whole-trace injection.

    Archetypes carrying an ``onset_step`` are gated on the *engine's*
    global step here (a 1-step trace has no past), then applied with
    their local onset zeroed."""

    def __init__(self, scfg, traffic, fault_list: Tuple, seed: int,
                 moe_experts: int = 0, top_k: int = 2, hot_expert: int = 0):
        from repro_torch.serve import CostModelBackend, ServeEngine
        self.faults = tuple(fault_list)
        self.seed = seed
        backend = CostModelBackend(lanes=scfg.lanes, moe_experts=moe_experts,
                                   top_k=top_k, hot_expert=hot_expert,
                                   seed=seed)
        self.tree = backend.tree
        self.engine = ServeEngine(scfg, traffic, backend,
                                  step_hook=self._inject_step)
        self.last_trace: Optional[RegionTrace] = None

    def _inject_step(self, engine, step: int, step_trace: RegionTrace
                     ) -> None:
        active = []
        for f in self.faults:
            onset = getattr(f, "onset_step", 0)
            if step < onset:
                continue
            active.append(dataclasses.replace(f, onset_step=0)
                          if onset else f)
        if active:
            F.inject_trace(self.tree, step_trace, tuple(active),
                           seed=self.seed)

    def collect_trace(self) -> RegionTrace:
        if self.engine.trace is None:
            self.engine.run()
        self.last_trace = self.engine.trace
        return self.last_trace

    def collect(self) -> RegionMetrics:
        return self.collect_trace().reduce()

    @property
    def completed(self) -> int:
        return self.engine.completed


class RuntimeFaultCollector:
    """Runtime backend: real regions on ``device`` (None: the card) timed
    by :class:`TimedRegionRunner`; per-shard iteration counts carry the
    injected extra work.  Shard ``i``'s state and data are standard
    normals from ``np.random.default_rng(seed*131 + i)`` and
    ``(seed*131 + 64 + i)``, in float32 on the device.  ``runner`` and
    ``last_trace`` keep the last collection's timings and samples."""

    def __init__(self, tree: RegionTree, size: int,
                 iters_per_shard: Tuple[int, ...], seed: int,
                 repeats: int = 5,
                 device: Union[None, str, torch.device] = None):
        self.tree = tree
        self.size = size
        self.iters = iters_per_shard
        self.seed = seed
        self.repeats = repeats
        self.device = device
        self.runner: Optional[TimedRegionRunner] = None
        self.last_trace: Optional[RegionTrace] = None

    def _normal(self, key: int) -> torch.Tensor:
        x = np.random.default_rng(key).standard_normal(
            (self.size, self.size)).astype(np.float32)
        return torch.from_numpy(x).to(self.runner.device)

    def collect(self) -> RegionMetrics:
        self.runner = TimedRegionRunner(self.tree, warmup=1,
                                        repeats=self.repeats,
                                        device=self.device)
        m = len(self.iters)
        states = [self._normal(self.seed * 131 + i) for i in range(m)]
        data = [(self._normal(self.seed * 131 + 64 + i), int(self.iters[i]))
                for i in range(m)]
        self.last_trace = self.runner.run_trace(states, data)
        return self.last_trace.reduce()


class TrainFaultCollector:
    """Train backend: a real region-instrumented smoke training run on
    ``device`` (None: the card; ``run_entry`` sets it from the analyzer
    overrides).  The designated shards genuinely execute more fwd_bwd
    iterations per step; ``collect`` builds the trainer
    (``make_trainer(device)``), runs it and reduces the trace it emitted —
    the same artifact ``repro_torch.cli.analyze_trace`` replays offline."""

    def __init__(self, make_trainer: Callable[[Any], Any],
                 device: Union[None, str, torch.device] = None):
        self.make_trainer = make_trainer
        self.device = device
        self.trainer = None

    def collect(self) -> RegionMetrics:
        self.trainer = self.make_trainer(self.device)
        self.trainer.run()
        return self.trainer.trace.reduce()

    @property
    def last_trace(self) -> Optional[RegionTrace]:
        return self.trainer.trace if self.trainer is not None else None


class MitigatedTrainCollector:
    """Recovery backend: a closed-loop mitigated smoke training run on
    ``device`` (None: the card).  ``run_recovery`` supervises the run with
    :func:`run_with_restarts`, building each trainer under the policy's
    config overrides (a remesh rebuilds), and returns the policy's
    recovery accounting."""

    def __init__(self, cfg, opt_cfg, data_cfg, tcfg, policy,
                 device: Union[None, str, torch.device] = None):
        self.cfg, self.opt_cfg, self.data_cfg, self.tcfg = (
            cfg, opt_cfg, data_cfg, tcfg)
        self.policy = policy
        self.device = device
        self.trainer = None

    def _make(self):
        from repro_torch.train.mitigate import mitigated_trainer
        self.trainer = mitigated_trainer(self.cfg, self.opt_cfg,
                                         self.data_cfg, self.tcfg,
                                         self.policy, device=self.device)
        return self.trainer

    def run_recovery(self) -> Dict[str, Any]:
        from repro_torch.train.fault_tolerance import run_with_restarts
        from repro_torch.train.mitigate import recovery_summary
        self.trainer = run_with_restarts(self._make, steps=self.tcfg.steps)
        return recovery_summary(self.policy)


# -- balanced baseline workloads -----------------------------------------

def _beh(base_time: float, flops_per_s: float = 2e9,
         vmem: float = 0.02, hbm: float = 0.02, host: float = 1e6,
         comm: float = 1e7, comm_frac: float = 0.0) -> RegionBehavior:
    return RegionBehavior(base_time=base_time, imbalance=None,
                          flops_per_s=flops_per_s, vmem_pressure=vmem,
                          hbm_intensity=hbm, host_bytes=host,
                          comm_bytes=comm, comm_time_frac=comm_frac)


def baseline_st() -> Tuple[RegionTree, Dict[int, RegionBehavior]]:
    """The ST region tree with *balanced* behaviours — the paper's
    application after its fixes, ready for fresh fault injection."""
    tree = st_region_tree()
    # Flat enough that no *planted* region is pre-flagged by the relative
    # severity banding (tests/test_fault_corpus.py asserts this).
    times = {1: 0.6, 2: 0.9, 3: 0.7, 4: 0.5, 5: 1.0, 6: 0.9, 7: 0.5,
             8: 0.8, 9: 0.6, 10: 0.7, 13: 0.5, 11: 1.0, 12: 0.6}
    b = {rid: _beh(t) for rid, t in times.items()}
    b[14] = _beh(times[11] + times[12] + 0.1)   # inclusive of 11 and 12
    return tree, b


def baseline_npar1way() -> Tuple[RegionTree, Dict[int, RegionBehavior]]:
    tree = RegionTree("NPAR1WAY")
    for i in range(1, 13):
        tree.add(f"cr{i}")
    # Planted regions (cr3, cr12) sit mid-band: only injection flags them.
    times = [0.5, 0.9, 0.6, 0.5, 1.0, 0.4, 0.5, 0.8, 0.6, 0.5, 0.7, 0.6]
    b = {i + 1: _beh(t, comm=1e8, comm_frac=0.05)
         for i, t in enumerate(times)}
    return tree, b


def baseline_mpibzip2() -> Tuple[RegionTree, Dict[int, RegionBehavior]]:
    tree = RegionTree("MPIBZIP2")
    for i in range(1, 17):
        tree.add(f"cr{i}", management=(i in (1, 2)))
    # Distinct times with the planted regions (cr6 compressor, cr7 block
    # send) mid-band — severity banding is relative, so a near-flat profile
    # would smear noise across all five bands.
    times = {1: 0.5, 2: 0.5, 3: 0.6, 4: 0.5, 5: 0.9, 6: 0.6, 7: 0.7,
             8: 0.5, 9: 1.0, 10: 0.6, 11: 0.4, 12: 0.8, 13: 0.6, 14: 0.5,
             15: 0.9, 16: 0.5}
    b = {i: _beh(times[i], comm=5e7) for i in range(1, 17)}
    b[7] = _beh(times[7], comm=2e8, comm_frac=0.2)   # block send
    return tree, b


def model_region_tree(arch: str):
    """Region tree + balanced behaviours for a ``repro_torch.configs`` smoke
    model: embed / layer_i {attn, mlp | router + expert_j [+ shared]} /
    final_norm / head / optimizer, with inclusive layer timing."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch).smoke
    tree = RegionTree(cfg.name)
    b: Dict[int, RegionBehavior] = {}

    def leaf(name, parent, t, **kw):
        r = tree.add(name, parent=parent)
        b[r.region_id] = _beh(t, **kw)
        return r

    # Deliberately flat-ish leaf times: the natural spread stays well under
    # the >=8x stretch a fault injects, so severity banding has headroom.
    leaf("embed", None, 0.5)
    # attn and mlp share one band in the clean baseline — only an injected
    # fault may separate them (the clean-baseline test relies on this).
    attn_t = 1.0
    mlp_t = 1.0
    for L in range(cfg.n_layers):
        layer = tree.add(f"layer_{L}")
        total = 0.0
        leaf("attn", layer, attn_t, hbm=0.03)
        total += attn_t
        if cfg.moe is not None:
            leaf("router", layer, 0.4)
            total += 0.4
            per_expert = mlp_t * cfg.moe.top_k / cfg.moe.n_experts + 0.2
            for e in range(cfg.moe.n_experts):
                leaf(f"expert_{e}", layer, per_expert)
                total += per_expert
            for s in range(cfg.moe.n_shared):
                leaf(f"shared_expert_{s}", layer, mlp_t * 0.5)
                total += mlp_t * 0.5
        else:
            leaf("mlp", layer, mlp_t)
            total += mlp_t
        b[layer.region_id] = _beh(total + 0.05)
    leaf("final_norm", None, 0.5)
    leaf("head", None, 0.6)
    leaf("optimizer", None, 0.5)
    return tree, b, cfg


# -- entry builders -------------------------------------------------------

def _synthetic(baseline: Callable, *fault_list, n_steps: int = 1):
    def build(seed: int):
        tree, behaviors = baseline()
        return tree, FaultedSyntheticCollector(tree, behaviors,
                                               tuple(fault_list), seed,
                                               n_steps=n_steps)
    return build


def _model_synthetic(arch: str, *fault_list):
    def build(seed: int):
        tree, behaviors, _ = model_region_tree(arch)
        return tree, FaultedSyntheticCollector(tree, behaviors,
                                               tuple(fault_list), seed)
    return build


def _serving(*fault_list, traffic: Callable[[], List], lanes: int = 4,
             max_len: int = 24, chunk: int = 8, steps: int = 32,
             moe_experts: int = 0, top_k: int = 2, hot_expert: int = 0,
             analyzer_kw: Tuple[Tuple[str, Any], ...] = ()):
    """Builder for the serving backend: rng-free corpus traffic
    (``traffic`` is a zero-arg callable so each build gets fresh Request
    objects) through the cost-model ServeEngine, with per-step fault
    injection.  ``analyzer_kw`` rides in the trace header so an offline
    replay of a saved/spooled serving artifact resolves the exact same
    analyzer configuration (the train-artifact convention)."""
    def build(seed: int):
        from repro_torch.serve import ServeConfig
        scfg = ServeConfig(lanes=lanes, max_len=max_len,
                           prefill_chunk=chunk, max_steps=steps,
                           trace_meta={"analyzer_kw": dict(analyzer_kw)})
        collector = ServingFaultCollector(
            scfg, traffic(), tuple(fault_list), seed,
            moe_experts=moe_experts, top_k=top_k, hot_expert=hot_expert)
        return collector.tree, collector
    return build


_TRAIN_KW = (("threshold_frac", 0.45),)

# Timing repeats of each (region, shard) in the wall-clock recovery
# entries (see ``_train_recovery``): the minimum of three takes, one in
# each round over the step (core/collector.py::TimedRegionRunner).
RECOVERY_REPEATS = 3

# When set (set by a caller), every train-backend
# entry collects through a TraceSpool under this base directory instead of
# accumulating step traces in memory — the CI spool round-trip gate runs
# the identical smoke train through the streaming path.
TRAIN_SPOOL_BASE: Optional[str] = None
_SPOOL_SEQ = [0]


def _spool_dir(arch: str, seed: int) -> Optional[str]:
    if TRAIN_SPOOL_BASE is None:
        return None
    _SPOOL_SEQ[0] += 1   # unique per build: retries must not collide
    return os.path.join(TRAIN_SPOOL_BASE,
                        f"{arch}-seed{seed}-{_SPOOL_SEQ[0]:03d}")


def _shards(iters_per_shard, expert_iters) -> int:
    if iters_per_shard is None and expert_iters is None:
        raise ValueError("need iters_per_shard and/or expert_iters")
    return (len(iters_per_shard) if iters_per_shard is not None
            else len(expert_iters))


def _train(iters_per_shard: Optional[Tuple[int, ...]] = None,
           steps: int = 2, arch: str = "st-100m", repeats: int = 1,
           expert_iters: Optional[Tuple[Tuple[int, ...], ...]] = None):
    """Builder for the train backend: a region-instrumented smoke Trainer
    whose per-shard fwd_bwd iteration counts (``iters_per_shard``) and/or
    per-(shard, expert) probe counts (``expert_iters``, MoE configs) carry
    the injected fault.  The region tree is built at corpus-build time so
    the entry exposes it before any execution; the trainer is built at
    collection, on the device ``run_entry`` names."""
    shards = _shards(iters_per_shard, expert_iters)
    iters = tuple(iters_per_shard) if iters_per_shard is not None else None

    def build(seed: int):
        from repro_torch.configs import get_arch
        from repro_torch.data import DataConfig
        from repro_torch.optim import AdamWConfig
        from repro_torch.train import Trainer, TrainerConfig
        from repro_torch.train.loop import train_region_tree
        cfg = get_arch(arch).smoke
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)

        def make_trainer(device):
            return Trainer(
                cfg, opt_cfg,
                DataConfig(seq_len=32, global_batch=2 * shards,
                           vocab=cfg.vocab),
                TrainerConfig(steps=steps, ckpt_dir=None, ckpt_every=0,
                              seed=seed, trace=True, trace_shards=shards,
                              trace_iters=iters,
                              trace_expert_iters=expert_iters,
                              trace_repeats=repeats,
                              trace_spool_dir=_spool_dir(arch, seed),
                              trace_chunk_steps=1,
                              trace_meta={"analyzer_kw": dict(_TRAIN_KW)}),
                device=device)
        tree = train_region_tree(cfg, opt_cfg, iterated=iters is not None,
                                 expert_probe=expert_iters is not None)
        return tree, TrainFaultCollector(make_trainer)
    return build


def _train_recovery(iters_per_shard: Optional[Tuple[int, ...]] = None,
                    steps: int = 6, arch: str = "st-100m",
                    expert_iters: Optional[Tuple[Tuple[int, ...], ...]]
                    = None, ckpt_every: int = 0,
                    analyzer_kw: Tuple[Tuple[str, Any], ...] = _TRAIN_KW,
                    trace_inject_for: Optional[Callable[[int], Any]]
                    = None, repeats: int = 1):
    """Builder for the recovery backend: the same region-instrumented
    smoke Trainer as ``_train``, but supervised by a
    :class:`MitigationPolicy` watching per-step verdict windows — the
    closed loop of the reference's docs/mitigation.md.  Checkpoints go to
    a fresh temporary directory (the remesh path must save/restore
    through it).

    ``repeats`` is the trainer's ``trace_repeats``.  The reference takes
    one; the port's straggler and MoE recovery entries take
    :data:`RECOVERY_REPEATS`, because each of their windows is one step
    judged on single takes of a few milliseconds, and on an H100 one
    noisy take (the straggler's optimizer at 1.48-1.53x the other
    shards', an expert probe at 2.8x its neighbours) split the persisting
    signature or brought a mitigated one back.  The checkpoint-stall
    entry keeps one: its stall is injected into each repeat from the
    reference's random stream, which only one repeat keeps equal to the
    reference's samples.

    ``trace_inject_for`` (seed -> TrainerConfig.trace_inject callable)
    plants faults through the trainer's trace-injection seam — the
    injection sees the *live* config, so a mitigation that edits the
    config (e.g. reschedule_ckpt phase-shifting ``ckpt_every``) genuinely
    stops the fault, closing the loop end-to-end."""
    shards = _shards(iters_per_shard, expert_iters)
    iters = tuple(iters_per_shard) if iters_per_shard is not None else None

    def build(seed: int):
        import tempfile

        from repro_torch.configs import get_arch
        from repro_torch.data import DataConfig
        from repro_torch.optim import AdamWConfig
        from repro_torch.train import MitigationPolicy, TrainerConfig
        from repro_torch.train.loop import train_region_tree
        cfg = get_arch(arch).smoke
        policy = MitigationPolicy(window_steps=1, persist=2,
                                  analyzer_kw=dict(analyzer_kw))
        tcfg = TrainerConfig(
            steps=steps,
            ckpt_dir=tempfile.mkdtemp(prefix="repro-recovery-"),
            ckpt_every=ckpt_every, seed=seed, trace=True,
            trace_shards=shards, trace_iters=iters,
            trace_expert_iters=expert_iters, trace_repeats=repeats,
            trace_inject=(trace_inject_for(seed)
                          if trace_inject_for is not None else None),
            trace_meta={"analyzer_kw": dict(analyzer_kw)})
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
        coll = MitigatedTrainCollector(
            cfg, opt_cfg,
            DataConfig(seq_len=32, global_batch=2 * shards,
                       vocab=cfg.vocab),
            tcfg, policy)
        tree = train_region_tree(cfg, opt_cfg, iterated=iters is not None,
                                 expert_probe=expert_iters is not None)
        return tree, coll
    return build


def _runtime(iters_per_shard: Tuple[int, ...], size: int = 96):
    def build(seed: int):
        tree = RegionTree("rt")

        def embed(state, data):
            return state + data @ data.T * 1e-3

        def solver_body(state, data):
            return torch.tanh(state @ state) * 0.5 + state * 0.5

        def reduce_(state, bundle):
            data, _ = bundle
            return state + data.sum() * 1e-6

        def embed_w(state, bundle):
            data, _ = bundle
            return embed(state, data)

        tree.add("embed", fn=embed_w)
        tree.add("solver", fn=F.iterated_work(solver_body))
        tree.add("reduce", fn=reduce_)
        return tree, RuntimeFaultCollector(tree, size, iters_per_shard, seed)
    return build


def _ckpt_stall_inject(seed: int):
    """TrainerConfig.trace_inject closure for the reschedule-ckpt loop:
    a host-I/O burst + wall stall lands on shard 2's optimizer region on
    every step that coincides with a periodic save — but only while
    ``ckpt_every < 2``, so the policy's +1 phase shift genuinely clears
    the collision and the trailing windows come back clean."""
    def inject(trainer, step, trace):
        t = trainer.tcfg
        if t.ckpt_every and t.ckpt_every < 2 \
                and (step + 1) % t.ckpt_every == 0:
            return F.inject_trace(
                trainer.region_tree, trace,
                (F.CheckpointStall("train/optimizer", proc=2),),
                seed=seed * 613 + step)
        return None
    return inject


def _chaos_spool(archetype, n_steps: int = 16, chunk_steps: int = 2,
                 window_steps: int = 4):
    """Build function of the spool-layer chaos entries: the ST
    compute-straggler scenario (active on every step, so each window flags
    it) produced through a real TraceSpool under the archetype's
    interference."""
    def build(seed: int):
        tree, behaviors = baseline_st()
        inner = FaultedSyntheticCollector(
            tree, behaviors,
            (F.ComputeStraggler("ST/cr5", procs=(6,), factor=5.0),),
            seed, n_steps=n_steps)
        return tree, SpoolChaosCollector(
            tree, inner.collect_trace, archetype, seed,
            chunk_steps=chunk_steps, window_steps=window_steps, persist=2)
    return build


def _chaos_ckpt(archetype):
    def build(seed: int):
        tree, _ = baseline_st()     # every entry exposes a region tree
        return tree, CheckpointChaosCollector(archetype, seed)
    return build


def _fleet_spool(archetype, n_runs: int = 8, n_steps: int = 16,
                 chunk_steps: int = 2, window_steps: int = 4):
    """Build function of the fleet chaos entries: ``n_runs`` concurrent
    copies of the ST compute-straggler scenario (distinct per-run seeds, same
    planted fault) tailed by one FleetIngest while the archetype attacks
    the victim run(s)."""
    def build(seed: int):
        tree, behaviors = baseline_st()

        def make_trace(run: int, steps: int):
            inner = FaultedSyntheticCollector(
                tree, behaviors,
                (F.ComputeStraggler("ST/cr5", procs=(6,), factor=5.0),),
                seed * 131 + run, n_steps=steps)
            return inner.collect_trace()

        return tree, FleetChaosCollector(
            tree, make_trace, archetype, seed, n_runs=n_runs,
            n_steps=n_steps, chunk_steps=chunk_steps,
            window_steps=window_steps, persist=2)
    return build


# -- scoring --------------------------------------------------------------

@dataclasses.dataclass
class CorpusRunResult:
    entry: CorpusEntry
    verdict: Verdict
    found: FrozenSet[str]
    missed: FrozenSet[str]
    spurious: FrozenSet[str]
    precision: float
    recall: float
    cause_recall: float
    # causes as scored: location-gated, unlike verdict.cause_attributes
    causes_found: FrozenSet[str] = frozenset()
    # wall seconds of every collection+analysis attempt (run_entry_robust
    # may retry the wall-clock runtime backend; all attempts are
    # reported, not just the one whose result was kept)
    attempt_walls: Tuple[float, ...] = ()
    # one record per attempt, in the same order, of a wall-clock entry
    # (runtime, train, recovery): its seed, whether it passed and its
    # window log (train/mitigate.py::MitigationPolicy.window_log; a
    # runtime or train entry's whole run is its one window, index None)
    attempt_logs: Tuple[Dict[str, Any], ...] = ()
    # the collector behind the kept result — lets callers reach the
    # RegionTrace it produced without re-collecting
    collector: Any = None
    # onset window the OnlineAnalyzer detected (None when the entry does
    # not assert time localization)
    onset_window: Optional[int] = None
    # the kernel lane's candidacy counts behind the kept result
    # (AutoAnalyzer.decisions, summed over a chaos harness's analyzers);
    # None on the exact lane
    decisions: Optional[Dict[str, float]] = None
    # -- recovery accounting (entries with RecoveryTruth) ------------------
    recovery_kind: Optional[str] = None      # first MitigationAction kind
    mitigation_window: Optional[int] = None  # window index it fired at
    clean_after: Optional[int] = None        # trailing clean windows
    # -- chaos accounting (entries with ChaosTruth) ------------------------
    chaos_outcome: Any = None                # full ChaosOutcome
    chaos_failures: Optional[List[str]] = None  # ChaosTruth violations
    # -- serving accounting (entries with ServingTruth) --------------------
    completed: Optional[int] = None          # requests the engine finished

    @property
    def recovered(self) -> bool:
        """The closed loop met the entry's RecoveryTruth (vacuously true
        for entries without one)."""
        want = self.entry.recovery
        if want is None:
            return True
        return (self.recovery_kind == want.kind
                and self.mitigation_window is not None
                and self.mitigation_window <= want.mitigate_by_window
                and (self.clean_after or 0) >= want.clean_windows)

    @property
    def served(self) -> Optional[bool]:
        """None for non-serving entries; else whether the engine met the
        entry's completed-request floor."""
        if self.entry.serving is None:
            return None
        return (self.completed or 0) >= self.entry.serving.min_completed

    @property
    def chaos_ok(self) -> Optional[bool]:
        """None for non-chaos entries; else whether the recovery held."""
        if self.chaos_failures is None:
            return None
        return not self.chaos_failures

    @property
    def passed(self) -> bool:
        return (self.recall == 1.0 and self.cause_recall == 1.0
                and self.precision >= self.entry.min_precision
                and (self.entry.expect_onset_window is None
                     or self.onset_window
                     == self.entry.expect_onset_window)
                and self.recovered
                and self.chaos_ok is not False
                and self.served is not False)


def _related(a: str, b: str) -> bool:
    """True when one path is the other or its ancestor/descendant — a
    nested hit (the paper flags both cr14 and its nested cr11)."""
    return a == b or a.startswith(b + "/") or b.startswith(a + "/")


def score_verdict(entry: CorpusEntry, verdict: Verdict) -> CorpusRunResult:
    kind = entry.truth.kind
    found: set = set()
    if kind in ("dissimilarity", "both"):
        found |= set(verdict.dissimilarity_paths)
    if kind in ("disparity", "both"):
        found |= set(verdict.disparity_paths)
    expected = set(entry.truth.bottleneck_paths)
    # Recall demands the *exact* planted path: reporting only an ancestor
    # is a miss (the paper's search descends to the nested culprit).
    # Precision is forgiving of the enclosing CCR chain via _related below.
    hit = {p for p in expected if p in found}
    missed = expected - hit
    spurious = {p for p in found
                if not any(_related(p, e) for e in expected)}
    precision = (len(found - spurious) / len(found)) if found else 0.0
    recall = len(hit) / len(expected) if expected else 1.0
    # Causes must be recovered *where they were planted*: disparity causes
    # count only when attributed to an expected region (or its nested
    # chain); dissimilarity causes are global by construction (the Fig. 4
    # decision table is per-process, not per-region).
    got_causes: set = set()
    if kind in ("dissimilarity", "both"):
        got_causes |= set(verdict.dissimilarity_cause_attributes)
    if kind in ("disparity", "both"):
        for path, attrs in verdict.per_path_causes:
            if any(_related(path, e) for e in expected):
                got_causes |= set(attrs)
    want_causes = entry.truth.cause_attributes
    cause_recall = (len(want_causes & got_causes)
                    / len(want_causes)) if want_causes else 1.0
    return CorpusRunResult(entry=entry, verdict=verdict,
                           found=frozenset(found), missed=frozenset(missed),
                           spurious=frozenset(spurious),
                           precision=precision, recall=recall,
                           cause_recall=cause_recall,
                           causes_found=frozenset(got_causes))



def run_entry(entry: CorpusEntry, seed: int = 0,
              analyzer_overrides: Optional[Dict[str, Any]] = None
              ) -> CorpusRunResult:
    """Build the scenario and pipe it end-to-end through AutoAnalyzer.

    Entries asserting ``expect_onset_window`` additionally replay the
    collected trace through an :class:`OnlineAnalyzer` in tumbling
    windows — the same trace the whole-run verdict came from, so the
    onset check costs no extra collection.

    ``analyzer_overrides`` merges on top of every entry's ``analyzer_kw``
    (e.g. ``{"distance_backend": "numpy"}`` for the exact host lane, or
    ``{"device": "cpu"}`` to run the kernel lane's plain version).  Its
    ``device`` is also where a runtime entry's regions and a train or
    recovery entry's trainers run (None: the card).  Recovery entries take
    only the lane keys (``device``, ``distance_backend``) into their
    policy's analyzer: the closed loop pins the rest of its own."""
    t0 = time.perf_counter()
    tree, collector = entry.build(seed)
    kw = dict(entry.analyzer_kw)
    if analyzer_overrides:
        kw.update(analyzer_overrides)
    if entry.backend in ("chaos", "fleet"):
        if analyzer_overrides:
            # chaos/fleet harnesses build their analyzers lazily from
            # collector.analyzer_kw at run_chaos() time
            collector.analyzer_kw = tuple(sorted(kw.items()))
        # The archetype attacks the pipeline (one run, or one tenant of a
        # multi-run fleet), recovery runs, and the post-recovery flagged
        # verdict is scored like any other entry — locating the planted
        # fault *through* the damaged artifacts is the point.
        outcome = collector.run_chaos()
        r = score_verdict(entry, outcome.verdict or EMPTY_VERDICT)
        r.collector = collector
        r.chaos_outcome = outcome
        r.chaos_failures = (entry.chaos.check(outcome)
                            if entry.chaos is not None else [])
        r.decisions = outcome.detail.get("decisions")
        r.attempt_walls = (time.perf_counter() - t0,)
        return r
    if entry.recovery is not None:
        # Recovery backend: the closed loop runs the whole (possibly
        # remeshed) training; the fault location is scored from the
        # verdict that *triggered* the action — post-mitigation steps are
        # clean by design (and a remesh changes the shard count), so a
        # whole-run reduction would dilute exactly the signal the loop
        # acted on.
        collector.device = kw.get("device")
        for key in ("device", "distance_backend"):
            if key in kw:
                collector.policy.analyzer_kw[key] = kw[key]
        summary = collector.run_recovery()
        policy = collector.policy
        verdict = policy.trigger_verdict
        if verdict is None:
            if not policy.log.windows:
                raise RuntimeError(
                    f"{entry.name}: recovery run produced no verdict "
                    f"windows (steps={collector.tcfg.steps}, "
                    f"window_steps={policy.window_steps})")
            verdict = policy.log.windows[-1].verdict
        r = score_verdict(entry, verdict)
        r.collector = collector
        r.recovery_kind = summary["action_kind"]
        r.mitigation_window = summary["action_window"]
        r.clean_after = summary["clean_windows_after"]
        r.decisions = policy._analyzer.decisions \
            if policy._analyzer is not None else None
        r.attempt_walls = (time.perf_counter() - t0,)
        r.attempt_logs = ({"seed": seed, "passed": r.passed,
                           "windows": policy.window_log()},)
        return r
    if entry.backend in ("runtime", "train"):
        collector.device = kw.get("device")
    analyzer = AutoAnalyzer(tree, **kw)
    result = analyzer.analyze_collector(collector)
    r = score_verdict(entry, result.verdict)
    r.collector = collector
    r.decisions = analyzer.decisions
    if entry.serving is not None:
        r.completed = getattr(collector, "completed", None)
    if entry.expect_onset_window is not None:
        online = OnlineAnalyzer(tree=tree,
                                window_steps=entry.onset_window_steps,
                                persist=entry.onset_persist,
                                analyzer_kw=kw)
        online.process_trace(collector.last_trace)
        # Any-kind onset: the pre-fault windows are clean, so the detector
        # need not be told which kind of fault to wait for.
        r.onset_window = online.onset()
    r.attempt_walls = (time.perf_counter() - t0,)
    if entry.backend in ("runtime", "train"):
        r.attempt_logs = ({"seed": seed, "passed": r.passed,
                           "windows": [_run_window(collector.last_trace,
                                                   result.verdict)]},)
    return r


def _run_window(trace: RegionTrace, verdict: Verdict) -> Dict[str, Any]:
    """A whole run's trace and verdict in the form of one window of
    ``MitigationPolicy.window_log``."""
    from repro_torch.train.mitigate import region_takes
    return {"index": None, "signature": None,
            "dissimilarity_paths": sorted(verdict.dissimilarity_paths),
            "disparity_paths": sorted(verdict.disparity_paths),
            **region_takes(trace)}


def run_entry_robust(entry: CorpusEntry, seed: int = 0,
                     analyzer_overrides: Optional[Dict[str, Any]] = None
                     ) -> CorpusRunResult:
    """run_entry, with one fresh collection for wall-clock backends
    (runtime, train, recovery) that fail: collection on a loaded host can lose a
    measurement to a pathological scheduler burst.  The better of the two
    results is kept; ``attempt_walls`` records the wall seconds of *every*
    attempt, and ``attempt_logs`` its window log, so a retry is visible
    in reports rather than silently folded into one number.  Other
    entries never retry — they are deterministic, so a failure is a real
    regression."""
    r = run_entry(entry, seed=seed, analyzer_overrides=analyzer_overrides)
    if entry.backend in ("runtime", "train", "recovery") and not r.passed:
        r2 = run_entry(entry, seed=seed + 1,
                       analyzer_overrides=analyzer_overrides)
        walls = r.attempt_walls + r2.attempt_walls
        logs = r.attempt_logs + r2.attempt_logs
        if (r2.passed, r2.recall, r2.precision) >= \
                (r.passed, r.recall, r.precision):
            r = r2
        r.attempt_walls = walls
        r.attempt_logs = logs
    return r


def select_entries(backend: Optional[str] = None,
                   names: Optional[List[str]] = None) -> List[CorpusEntry]:
    """Resolve a backend/name selection, rejecting contradictions.

    Naming an entry that doesn't exist — or that the backend filter
    excludes — is an error, not an empty selection: a CI gate must never
    silently run zero checks."""
    if names is None:
        return corpus_entries(backend=backend)
    unknown = [n for n in names if n not in CORPUS]
    if unknown:
        raise ValueError(f"unknown entries {unknown}; known: "
                         f"{sorted(CORPUS)}")
    entries = [CORPUS[n] for n in names]
    conflicts = [e.name for e in entries
                 if backend is not None and e.backend != backend]
    if conflicts:
        raise ValueError(
            f"entries {conflicts} are not in backend {backend!r}")
    return entries



def evaluate_corpus(seed: int = 0, backend: Optional[str] = None,
                    names: Optional[List[str]] = None,
                    analyzer_overrides: Optional[Dict[str, Any]] = None
                    ) -> List[CorpusRunResult]:
    """Run entries (all, by backend, or by name) with runtime-retry."""
    return [run_entry_robust(e, seed=seed,
                             analyzer_overrides=analyzer_overrides)
            for e in select_entries(backend=backend, names=names)]


# -- the registry ---------------------------------------------------------

# The ST Fig. 11 five-group shape, normalised around 1.
_ST_SKEW = (0.3, 0.8, 0.81, 1.2, 1.6, 2.0, 1.61, 2.01)

register_entry(CorpusEntry(
    name="st/compute-straggler-cr5",
    app="st", backend="synthetic",
    description="One ST rank does 5x the solver work in cr5",
    build=_synthetic(baseline_st,
                     F.ComputeStraggler("ST/cr5", procs=(6,), factor=5.0)),
    truth=GroundTruth("dissimilarity", frozenset({"ST/cr5"}),
                      frozenset({FLOPS})),
))

register_entry(CorpusEntry(
    name="st/data-skew-cr11",
    app="st", backend="synthetic",
    description="ST Fig.11 five-group work skew on nested cr11",
    build=_synthetic(baseline_st,
                     F.DataSkew("ST/cr14/cr11", profile=_ST_SKEW)),
    truth=GroundTruth("dissimilarity", frozenset({"ST/cr14/cr11"}),
                      frozenset({FLOPS})),
))

register_entry(CorpusEntry(
    name="st/io-hotspot-cr8",
    app="st", backend="synthetic",
    description="ST cr8 goes disk-I/O bound (the paper's 106GB writes)",
    build=_synthetic(baseline_st,
                     F.IOHotspot("ST/cr8", extra_bytes=100e9, slowdown=6.0)),
    truth=GroundTruth("disparity", frozenset({"ST/cr8"}),
                      frozenset({HOST_BYTES})),
))

register_entry(CorpusEntry(
    name="st/cache-thrash-cr11",
    app="st", backend="synthetic",
    description="ST cr11 L2-pressure analogue: HBM traffic inflates 10x",
    build=_synthetic(baseline_st,
                     F.CacheThrash("ST/cr14/cr11", slowdown=5.0,
                                   byte_factor=10.0)),
    truth=GroundTruth("disparity", frozenset({"ST/cr14/cr11"}),
                      frozenset({HBM_INTENSITY})),
))

register_entry(CorpusEntry(
    name="st/memory-pressure-cr9",
    app="st", backend="synthetic",
    description="ST cr9 working set spills: VMEM pressure jumps, 5x slower",
    build=_synthetic(baseline_st,
                     F.MemoryPressure("ST/cr9", pressure=0.45, slowdown=5.0)),
    truth=GroundTruth("disparity", frozenset({"ST/cr9"}),
                      frozenset({VMEM_PRESSURE})),
))

register_entry(CorpusEntry(
    name="st/checkpoint-stall-cr10",
    app="st", backend="synthetic",
    description="Rank 2 owns the checkpoint write leg in cr10: an 80GB "
                "host-I/O burst stalls it for 5s of wall clock (CPU "
                "clock untouched)",
    build=_synthetic(baseline_st,
                     F.CheckpointStall("ST/cr10", proc=2,
                                       extra_bytes=80e9, stall=5.0)),
    truth=GroundTruth("dissimilarity", frozenset({"ST/cr10"}),
                      frozenset({HOST_BYTES})),
    analyzer_kw=(("similarity_metric", WALL_TIME),),
))

register_entry(CorpusEntry(
    name="st/combined-straggler-io",
    app="st", backend="synthetic",
    description="Straggler in cr5 AND an I/O hotspot in cr8 at once",
    build=_synthetic(baseline_st,
                     F.ComputeStraggler("ST/cr5", procs=(6,), factor=5.0),
                     F.IOHotspot("ST/cr8", extra_bytes=100e9, slowdown=6.0)),
    truth=GroundTruth("both", frozenset({"ST/cr5", "ST/cr8"}),
                      frozenset({FLOPS, HOST_BYTES})),
))

register_entry(CorpusEntry(
    name="npar1way/comm-imbalance-cr12",
    app="npar1way", backend="synthetic",
    description="Two ranks pay congested-link wire time in cr12 (wall-"
                "clock dissimilarity, invisible to the CPU clock)",
    build=_synthetic(baseline_npar1way,
                     F.CommImbalance("NPAR1WAY/cr12", extra_bytes=30e9,
                                     procs=(0, 1), bandwidth=1e10)),
    truth=GroundTruth("dissimilarity", frozenset({"NPAR1WAY/cr12"}),
                      frozenset({COMM_BYTES})),
    analyzer_kw=(("similarity_metric", WALL_TIME),),
))

register_entry(CorpusEntry(
    name="npar1way/collective-straggler",
    app="npar1way", backend="synthetic",
    description="Rank 4 arrives late to both collectives (cr9+cr10): "
                "every other rank waits in each — only the composite-"
                "region phase of Algorithm 2 can pin the pair",
    build=_synthetic(baseline_npar1way,
                     F.CollectiveStraggler(("NPAR1WAY/cr9", "NPAR1WAY/cr10"),
                                           straggler=4, delay=2.0)),
    truth=GroundTruth("dissimilarity",
                      frozenset({"NPAR1WAY/cr9", "NPAR1WAY/cr10"})),
    analyzer_kw=(("similarity_metric", WALL_TIME),),
))

register_entry(CorpusEntry(
    name="npar1way/compute-hotspot-cr3",
    app="npar1way", backend="synthetic",
    description="NPAR1WAY cr3 instructions-retired disparity (8x work)",
    build=_synthetic(baseline_npar1way,
                     F.ComputeHotspot("NPAR1WAY/cr3", factor=8.0)),
    truth=GroundTruth("disparity", frozenset({"NPAR1WAY/cr3"}),
                      frozenset({FLOPS})),
))

register_entry(CorpusEntry(
    name="mpibzip2/straggler-cr6",
    app="mpibzip2", backend="synthetic",
    description="Two worker ranks hit incompressible blocks: 4x compressor "
                "time in cr6",
    build=_synthetic(baseline_mpibzip2,
                     F.ComputeStraggler("MPIBZIP2/cr6", procs=(2, 5),
                                        factor=4.0)),
    truth=GroundTruth("dissimilarity", frozenset({"MPIBZIP2/cr6"}),
                      frozenset({FLOPS})),
))

register_entry(CorpusEntry(
    name="mpibzip2/comm-hotspot-cr7",
    app="mpibzip2", backend="synthetic",
    description="MPIBZIP2 cr7 block send saturates the wire on every rank",
    build=_synthetic(baseline_mpibzip2,
                     F.CommImbalance("MPIBZIP2/cr7", extra_bytes=20e9,
                                     procs=None, bandwidth=2e9)),
    truth=GroundTruth("disparity", frozenset({"MPIBZIP2/cr7"}),
                      frozenset({COMM_BYTES})),
))

register_entry(CorpusEntry(
    name="moe/mixtral-expert-hotspot",
    app="moe", backend="synthetic",
    description="Routing collapse: every shard over-routes to expert 0 of "
                "mixtral-smoke layer 1",
    build=_model_synthetic("mixtral-8x22b",
                           F.ExpertLoadImbalance("mixtral-smoke/layer_1",
                                                 hot_expert=0, factor=4.0,
                                                 congestion=4.0)),
    truth=GroundTruth("disparity",
                      frozenset({"mixtral-smoke/layer_1/expert_0"}),
                      frozenset({FLOPS})),
))

register_entry(CorpusEntry(
    name="moe/deepseek-expert-skew",
    app="moe", backend="synthetic",
    description="Two data shards route hot to expert 2 of dsv2-smoke "
                "layer 0 (per-shard dissimilarity)",
    build=_model_synthetic("deepseek-v2-lite-16b",
                           F.ExpertLoadImbalance("dsv2-smoke/layer_0",
                                                 hot_expert=2, factor=4.0,
                                                 procs=(0, 3))),
    truth=GroundTruth("dissimilarity",
                      frozenset({"dsv2-smoke/layer_0/expert_2"}),
                      frozenset({FLOPS})),
))

register_entry(CorpusEntry(
    name="transformer/gemma-attn-cache-thrash",
    app="transformer", backend="synthetic",
    description="gemma-smoke layer 0 attention starts thrashing HBM",
    build=_model_synthetic("gemma-7b",
                           F.CacheThrash("gemma-smoke/layer_0/attn",
                                         slowdown=5.0, byte_factor=10.0)),
    truth=GroundTruth("disparity",
                      frozenset({"gemma-smoke/layer_0/attn"}),
                      frozenset({HBM_INTENSITY})),
))

register_entry(CorpusEntry(
    name="transformer/chatglm-jittered-straggler",
    app="transformer", backend="synthetic",
    description="One shard straggles ~5x (with jitter) in chatglm3-smoke "
                "layer 1 mlp",
    build=_model_synthetic("chatglm3-6b",
                           F.JitteredStraggler("chatglm3-smoke/layer_1/mlp",
                                               procs=(5,), factor=5.0,
                                               jitter=0.2)),
    truth=GroundTruth("dissimilarity",
                      frozenset({"chatglm3-smoke/layer_1/mlp"}),
                      frozenset({FLOPS})),
))

register_entry(CorpusEntry(
    name="st/triple-straggler-thrash-stall",
    app="st", backend="synthetic",
    description="Three simultaneous bottlenecks: rank 6 does 5x the cr5 "
                "solver work, nested cr11 starts thrashing HBM on every "
                "rank, and rank 2 owns an 80GB checkpoint stall in cr10 "
                "— the analyzer must separate two distinct dissimilarity "
                "culprits from a global disparity in one pass",
    build=_synthetic(baseline_st,
                     F.ComputeStraggler("ST/cr5", procs=(6,), factor=5.0),
                     F.CacheThrash("ST/cr14/cr11", slowdown=5.0,
                                   byte_factor=10.0),
                     F.CheckpointStall("ST/cr10", proc=2,
                                       extra_bytes=80e9, stall=5.0)),
    truth=GroundTruth("both",
                      frozenset({"ST/cr5", "ST/cr14/cr11", "ST/cr10"}),
                      frozenset({FLOPS, HBM_INTENSITY, HOST_BYTES})),
    analyzer_kw=(("similarity_metric", WALL_TIME),),
))

register_entry(CorpusEntry(
    name="st/thermal-throttle-cr5",
    app="st", backend="synthetic",
    description="Rank 1's chip down-clocks progressively over a 12-step "
                "run: cr5 wall+CPU time ramps to 4x by the final step "
                "(time-varying — only the trace layer's per-step axis "
                "expresses it; no quantity metric inflates)",
    build=_synthetic(baseline_st,
                     F.ThermalThrottleDrift("ST/cr5", procs=(1,),
                                            peak_factor=4.0),
                     n_steps=12),
    truth=GroundTruth("dissimilarity", frozenset({"ST/cr5"})),
))

register_entry(CorpusEntry(
    name="st/thermal-drift-onset",
    app="st", backend="synthetic",
    description="Rank 1 holds full clock for 8 steps of a 16-step run, "
                "then down-clocks toward 4x: the OnlineAnalyzer must "
                "localize the fault in time (onset at window 2 = steps "
                "[8,12) of 4-step windows) as well as locate ST/cr5",
    build=_synthetic(baseline_st,
                     F.ThermalThrottleDrift("ST/cr5", procs=(1,),
                                            peak_factor=4.0, onset_step=8),
                     n_steps=16),
    truth=GroundTruth("dissimilarity", frozenset({"ST/cr5"})),
    expect_onset_window=2, onset_window_steps=4, onset_persist=2,
))


# Train backend: a real smoke training run through the region-instrumented
# Trainer.  Shard 3's fwd_bwd genuinely executes 12x the iterations per
# step; the wide threshold_frac absorbs wall-clock noise.  The
# fault is present from step 0, so the per-step window stream must flag it
# from window 0 onward (onset in *time* checked on a real run too).
register_entry(CorpusEntry(
    name="train/fwdbwd-straggler-smoke",
    app="train", backend="train",
    description="Region-instrumented smoke Trainer run: shard 3 executes "
                "12x the fwd_bwd iterations per step (real "
                "fwd/bwd + optimizer, trace-collected)",
    build=_train(iters_per_shard=(1, 1, 1, 12), steps=2),
    truth=GroundTruth("dissimilarity", frozenset({"train/fwd_bwd"})),
    analyzer_kw=_TRAIN_KW,
    min_precision=0.2,
    expect_onset_window=0, onset_window_steps=1, onset_persist=2,
))

# MoE smoke train: per-expert probe regions in the instrumented tree run
# each expert's FFN its routed share of iterations inside the step — a
# routing collapse toward expert 1 (12x the iterations on every shard)
# surfaces as a disparity on the expert's own region.
register_entry(CorpusEntry(
    name="train/moe-routing-collapse-smoke",
    app="train", backend="train",
    description="Region-instrumented mixtral-smoke Trainer run with "
                "per-expert probe regions: every shard over-routes to "
                "expert 1 (48 vs 4 probe iterations), a real-execution "
                "routing collapse localized to train/moe/expert_1",
    build=_train(expert_iters=tuple(
        tuple(48 if e == 1 else 4 for e in range(4))
        for _ in range(4)), steps=2, arch="mixtral-8x22b"),
    truth=GroundTruth("disparity", frozenset({"train/moe/expert_1"})),
    analyzer_kw=_TRAIN_KW,
    min_precision=0.2,
))

# Recovery backend: the closed loop end-to-end (the reference's docs/mitigation.md).
# Shard 3's genuine 12x fwd_bwd work must be flagged by the live
# per-step verdict stream (windows 0 and 1), remeshed away at window 1
# (checkpoint -> drop shard 3 -> restart -> remesh-restore under the
# 3-shard layout), and every window after the restart must come back
# clean — recall, time-to-mitigate and recovery all machine-checked.
register_entry(CorpusEntry(
    name="train/straggler-remesh-recovery",
    app="train", backend="recovery",
    description="Closed loop: live verdicts catch shard 3's 12x fwd_bwd "
                "straggler at window 1, remesh drops the shard via "
                "run_with_restarts, post-restart windows are clean",
    build=_train_recovery(iters_per_shard=(1, 1, 1, 12), steps=6,
                          repeats=RECOVERY_REPEATS),
    truth=GroundTruth("dissimilarity", frozenset({"train/fwd_bwd"})),
    analyzer_kw=_TRAIN_KW,
    min_precision=0.2,
    recovery=RecoveryTruth(kind="remesh", mitigate_by_window=1,
                           clean_windows=3),
))

# Routing collapse -> expert rebalance, in place (no restart): expert 1's
# 48-vs-4 probe iterations are flagged as a disparity on its own region;
# the policy redistributes each shard's probe budget evenly, and the
# remaining windows must be clean.
register_entry(CorpusEntry(
    name="train/moe-collapse-rebalance-recovery",
    app="train", backend="recovery",
    description="Closed loop: routing collapse onto expert 1 triggers "
                "in-place expert rebalancing (trace_expert_iters "
                "redistributed) at window 1; post-rebalance windows are "
                "clean",
    build=_train_recovery(expert_iters=tuple(
        tuple(48 if e == 1 else 4 for e in range(4))
        for _ in range(4)), steps=6, arch="mixtral-8x22b",
        repeats=RECOVERY_REPEATS),
    truth=GroundTruth("disparity", frozenset({"train/moe/expert_1"})),
    analyzer_kw=_TRAIN_KW,
    min_precision=0.2,
    recovery=RecoveryTruth(kind="rebalance_experts", mitigate_by_window=1,
                           clean_windows=3),
))

# Runtime backend: designated shards genuinely execute ~10x the solver
# iterations.  The wide threshold_frac absorbs scheduler noise on a loaded
# host; the >=10x injected stretch keeps the straggler unambiguous.
register_entry(CorpusEntry(
    name="runtime/compute-straggler",
    app="runtime", backend="runtime",
    description="Real run on the card; shard 3 executes ~10x solver "
                "iterations",
    build=_runtime(iters_per_shard=(6, 6, 6, 64)),
    truth=GroundTruth("dissimilarity", frozenset({"rt/solver"})),
    analyzer_kw=(("threshold_frac", 0.45),),
    min_precision=0.2,
))

register_entry(CorpusEntry(
    name="runtime/data-skew",
    app="runtime", backend="runtime",
    description="Real run on the card; solver iterations skewed 6/6/18/64 "
                "across shards",
    build=_runtime(iters_per_shard=(6, 6, 18, 64)),
    truth=GroundTruth("dissimilarity", frozenset({"rt/solver"})),
    analyzer_kw=(("threshold_frac", 0.45),),
    min_precision=0.2,
))


# Checkpoint-stall collision -> reschedule_ckpt, in place: every periodic
# save lands a host-I/O burst + wall stall on shard 2's optimizer
# (injected through the trainer's trace seam, conditioned on the *live*
# ckpt_every), the policy phase-shifts the cadence, and — because the
# injection reads the updated config — the collision genuinely stops.
_CKPT_STALL_KW = _TRAIN_KW + (("similarity_metric", WALL_TIME),)

register_entry(CorpusEntry(
    name="train/ckpt-stall-reschedule-recovery",
    app="train", backend="recovery",
    description="Closed loop: periodic saves collide with shard 2's "
                "optimizer (host-I/O burst + wall stall each save step); "
                "reschedule_ckpt phase-shifts ckpt_every at window 1 and "
                "the collision stops",
    build=_train_recovery(iters_per_shard=(1, 1, 1, 1), steps=6,
                          ckpt_every=1, analyzer_kw=_CKPT_STALL_KW,
                          trace_inject_for=_ckpt_stall_inject),
    truth=GroundTruth("dissimilarity", frozenset({"train/optimizer"}),
                      frozenset({HOST_BYTES})),
    analyzer_kw=_CKPT_STALL_KW,
    min_precision=0.2,
    recovery=RecoveryTruth(kind="reschedule_ckpt", mitigate_by_window=1,
                           clean_windows=3),
))


# -- chaos: infrastructure fault injection (scenarios/chaos.py) -----------
#
# The fault lands on the pipeline itself.  Spool entries run the ST
# compute-straggler scenario (16 steps, 2-step segments, 4-step verdict
# windows — the fault is active in every window) twice: clean and under
# the archetype.  After TraceSpool.recover the chaos run must survive,
# quarantine exactly the damage, and reproduce the clean run's verdicts
# bit-for-bit on every window the fault did not touch.  Deterministic at
# any seed; the tests replay {0, 1, 7}.

_CHAOS_ST_TRUTH = GroundTruth("dissimilarity", frozenset({"ST/cr5"}),
                              frozenset({FLOPS}))

register_entry(CorpusEntry(
    name="chaos/kill-producer-torn-segment",
    app="chaos", backend="chaos",
    description="Producer killed between segment write and rename: the "
                "torn .tmp is quarantined, 10 of 16 steps salvage, both "
                "complete windows match the clean run",
    build=_chaos_spool(KillProducerMidChunk(
        kill_segment=5, point="spool.segment.written")),
    truth=_CHAOS_ST_TRUTH,
    chaos=ChaosTruth(min_quarantined=1, min_matched_windows=2),
))

register_entry(CorpusEntry(
    name="chaos/kill-producer-orphan-segment",
    app="chaos", backend="chaos",
    description="Producer killed between segment rename and manifest "
                "update: recovery adopts the orphan segment, 12 of 16 "
                "steps salvage, all three windows match the clean run",
    build=_chaos_spool(KillProducerMidChunk(
        kill_segment=5, point="spool.segment.renamed")),
    truth=_CHAOS_ST_TRUTH,
    chaos=ChaosTruth(expect_adopted=1, min_matched_windows=3),
))

register_entry(CorpusEntry(
    name="chaos/truncate-segment",
    app="chaos", backend="chaos",
    description="Flushed segment loses its tail on disk (seeded "
                "truncation): length check quarantines it, the window "
                "over the hole degrades, the other three match clean",
    build=_chaos_spool(TruncateSegment(segment=1)),
    truth=_CHAOS_ST_TRUTH,
    chaos=ChaosTruth(min_quarantined=1, min_degraded=1,
                     min_matched_windows=3),
))

register_entry(CorpusEntry(
    name="chaos/flip-bytes-segment",
    app="chaos", backend="chaos",
    description="Silent bit rot inside a flushed segment (seeded byte "
                "flips, length unchanged): sha256 quarantines it, the "
                "window over it degrades, the other three match clean",
    build=_chaos_spool(FlipBytesInSegment(segment=1, n_flips=8)),
    truth=_CHAOS_ST_TRUTH,
    chaos=ChaosTruth(min_quarantined=1, min_degraded=1,
                     min_matched_windows=3),
))

register_entry(CorpusEntry(
    name="chaos/stall-producer",
    app="chaos", backend="chaos",
    description="Producer goes silent after 2 segments without closing: "
                "the live consumer's StallDetector gives up in bounded "
                "time, recovery seals 4 steps, window 0 matches clean",
    build=_chaos_spool(StallProducer(segments=2)),
    truth=_CHAOS_ST_TRUTH,
    chaos=ChaosTruth(expect_stall=True, min_matched_windows=1),
))


# The checkpoint archetype has no verdict windows: the "comparison" is
# the restored state itself (bit-equal to the fallback step's saved
# arrays).  An empty verdict scores found=∅ -> precision 0.0 by
# convention, so the floor is 0 and the truth plants no paths.
register_entry(CorpusEntry(
    name="chaos/corrupt-latest-checkpoint",
    app="chaos", backend="chaos",
    description="Newest checkpoint's payload damaged after save (seeded "
                "byte flips): verification skips it and restore falls "
                "back one step, bit-exact",
    build=_chaos_ckpt(CorruptLatestCheckpoint(n_flips=16)),
    truth=GroundTruth("dissimilarity", frozenset()),
    min_precision=0.0,
    chaos=ChaosTruth(min_quarantined=1, min_matched_windows=1,
                     fallback_steps=1),
))


# -- fleet: fault-isolated multi-run ingest (repro_torch/fleet) -----------
#
# Eight concurrent ST compute-straggler runs (distinct seeds, same
# planted fault) tailed by one FleetIngest while the archetype attacks
# one or two of them.  The gate is isolation: every unaffected run's
# per-window verdicts must be fingerprint-identical to a solo
# OnlineAnalyzer poll of the same spool (6 runs x 4 windows = 24 for the
# two-victim kill, 7 x 4 = 28 otherwise), while the affected runs
# degrade, recover, or quarantine with structured events.  For fleet
# entries ``quarantined`` counts quarantined *runs* (circuit breaker),
# not quarantined files.  Deterministic on a fake clock; the tests replay
# seeds {0, 1, 7}.

register_entry(CorpusEntry(
    name="fleet/concurrent-producer-kill",
    app="fleet", backend="fleet",
    description="Two of eight producers die concurrently mid-flush at "
                "different seams: both stall out, spool recovery "
                "quarantines the torn tmp and adopts the orphan, their "
                "salvaged tails drain, and the six unaffected runs stay "
                "bit-identical to solo",
    build=_fleet_spool(FleetConcurrentKill()),
    truth=_CHAOS_ST_TRUTH,
    chaos=ChaosTruth(expect_stall=True, expect_adopted=1,
                     min_matched_windows=24),
))

register_entry(CorpusEntry(
    name="fleet/one-tenant-corruption",
    app="fleet", backend="fleet",
    description="One tenant's segments rot in two waves: wave one "
                "degrades the window over it, wave two trips the "
                "circuit breaker and quarantines the run — the seven "
                "unaffected runs stay bit-identical to solo",
    build=_fleet_spool(FleetTenantCorruption()),
    truth=_CHAOS_ST_TRUTH,
    chaos=ChaosTruth(min_quarantined=1, min_degraded=1,
                     min_matched_windows=28),
))

register_entry(CorpusEntry(
    name="fleet/analysis-lag-flood",
    app="fleet", backend="fleet",
    description="One run floods 3x faster than the shared worker pool "
                "drains against a 2-window queue: its oldest windows "
                "shed as structured events, the seven unaffected runs "
                "never shed and stay bit-identical to solo",
    build=_fleet_spool(FleetAnalysisLagFlood()),
    truth=_CHAOS_ST_TRUTH,
    chaos=ChaosTruth(min_shed=3, min_degraded=3, min_matched_windows=28),
))

# -- serving: the batched prefill/decode engine (repro_torch/serve) --------------
# Corpus traffic is saturated synchronized sessions: every lane runs the
# same request shape back to back, so the clean baseline is flat across
# lanes and cycle-periodic across steps by construction — the balanced-
# behaviours discipline, realized by scheduling.  (The reference's docs/serving.md.)

# The interleave archetype stalls pure wall (CPU idles while the batcher
# serves someone else's prefill), like the wait-style train archetypes.
_SERVE_WALL_KW = (("similarity_metric", WALL_TIME),)

register_entry(CorpusEntry(
    name="serving/kv-cache-thrash",
    app="serve", backend="serving",
    description="Every lane's KV cache crosses 50% occupancy over the "
                "back half of each request cycle: appends re-stream "
                "cache lines through HBM (5x wall, 10x bytes) — a "
                "memory-bound disparity at serve/kv_append, cause "
                "hbm_intensity",
    build=_serving(F.KVCacheThrash(),
                   traffic=lambda: saturated_sessions(4, 4)),
    truth=GroundTruth(kind="disparity",
                      bottleneck_paths=frozenset({"serve/kv_append"}),
                      cause_attributes=frozenset({HBM_INTENSITY})),
    serving=ServingTruth(min_completed=16),
))

register_entry(CorpusEntry(
    name="serving/kv-thrash-onset",
    app="serve", backend="serving",
    description="Same KV-cache thrash, switching on at engine step 16 of "
                "32 (a hot neighbor landing on the host): the online "
                "replay must localize onset to window 2 of the 8-step "
                "windows while the whole-run verdict still locates "
                "serve/kv_append",
    build=_serving(F.KVCacheThrash(onset_step=16),
                   traffic=lambda: saturated_sessions(4, 4)),
    truth=GroundTruth(kind="disparity",
                      bottleneck_paths=frozenset({"serve/kv_append"}),
                      cause_attributes=frozenset({HBM_INTENSITY})),
    serving=ServingTruth(min_completed=16),
    expect_onset_window=2, onset_window_steps=8, onset_persist=2,
))

register_entry(CorpusEntry(
    name="serving/interleave-imbalance",
    app="serve", backend="serving",
    description="Staggered sessions de-synchronize lane phases; an "
                "unfair batcher lets co-scheduled prefill chunks starve "
                "lane 3's decode (pure wall stall, CPU untouched) — one "
                "dissimilar lane at serve/decode under the wall-time "
                "similarity metric",
    build=_serving(F.InterleaveImbalance(victim=3, stall=0.02),
                   traffic=lambda: saturated_sessions(4, 8, stagger=1),
                   steps=64, analyzer_kw=_SERVE_WALL_KW),
    truth=GroundTruth(kind="dissimilarity",
                      bottleneck_paths=frozenset({"serve/decode"})),
    analyzer_kw=_SERVE_WALL_KW,
    serving=ServingTruth(min_completed=29),
))

register_entry(CorpusEntry(
    name="serving/hot-expert-routing",
    app="serve", backend="serving",
    description="Hot-prompt repetition routes 85% of MoE decode mass to "
                "expert 0 (17x sibling FLOPS, emergent from the traffic "
                "mix alone); its congested queue triples wall where the "
                "skew holds — a disparity localized to "
                "serve/moe/expert_0, cause flops",
    build=_serving(F.HotExpertRouting(),
                   traffic=lambda: saturated_sessions(4, 4, hot=True),
                   moe_experts=4),
    truth=GroundTruth(kind="disparity",
                      bottleneck_paths=frozenset({"serve/moe/expert_0"}),
                      cause_attributes=frozenset({FLOPS})),
    serving=ServingTruth(min_completed=16),
))

register_entry(CorpusEntry(
    name="serving/long-tail-prompt-straggler",
    app="serve", backend="serving",
    description="Lane 3 serves the long tail (64-token prompts, 24-token "
                "generations — token rates match the short lanes, only "
                "the quadratic prefill cost differs) and its deep prefill "
                "chunks blow the fast path (4x work past 15 ms/chunk): "
                "one dissimilar lane whose extra FLOPS sit in "
                "serve/prefill",
    build=_serving(F.LongTailPromptStraggler(),
                   traffic=lambda: saturated_sessions(
                       4, 8, tail_lane=3, tail_prompt_len=64,
                       tail_gen_len=24),
                   max_len=96, steps=64),
    truth=GroundTruth(kind="dissimilarity",
                      bottleneck_paths=frozenset({"serve/prefill"}),
                      cause_attributes=frozenset({FLOPS})),
    serving=ServingTruth(min_completed=26),
))
