"""Closed-loop mitigation: online verdicts drive automatic recovery.

The PyTorch port of the reference's ``repro/train/mitigate.py``, whole:
the policy is framework-free; the trainers it drives are the port's, on
the device the caller names (None: the card).

The collection/analysis stack localizes a bottleneck while the run is
still going (stream/online.py); this module closes the loop by *acting*
on those verdicts.  A :class:`MitigationPolicy` rides inside a live
:class:`~repro_torch.train.loop.Trainer` (``TrainerConfig.mitigate``), windows
the per-step traces through the same :class:`WindowVerdictLog` the
streaming layer uses, and when a bottleneck verdict has persisted it maps
the verdict to an action:

* **straggler** (dissimilarity verdict + one shard's step wall clearly
  above the rest) — ``remesh`` around the slow shard: checkpoint, drop
  the shard from the emulated mesh, and restart via
  :func:`~repro_torch.train.fault_tolerance.run_with_restarts`; the
  rebuilt trainer restores the checkpoint under the scaled-down layout
  with :func:`~repro_torch.train.fault_tolerance.remesh`.
* **routing collapse** (disparity verdict pinned to a
  ``moe/expert_<e>`` probe region) — rebalance: redistribute
  ``trace_expert_iters`` evenly per shard (total preserved), applied
  in place, no restart.
* **checkpoint stall** (persisted verdict whose causes include
  ``host_bytes`` while periodic saves are on) — reschedule saves off
  the hot step by shifting ``ckpt_every``.

Verdict-driven, not threshold-driven: the policy consumes the same
analyzer output `scripts/watch_train.py` streams, so anything the paper's
analysis can localize, the loop can act on.  Every action is recorded
(:class:`MitigationAction`), actions are idempotent per verdict signature
(a persisting identical verdict never re-fires the same action), and the
fault-injection corpus scores the whole loop against *recovery* ground
truth (time-to-mitigate + post-mitigation clean windows) — see
docs/mitigation.md and scenarios/corpus.py.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import CPU_TIME, HOST_BYTES, WALL_TIME, AutoAnalyzer
from repro_torch.core.trace import RegionTrace
from repro_torch.stream.online import (DegradedWindow, WindowVerdict,
                                 WindowVerdictLog)

from . import checkpoint as ckpt_mod
from .fault_tolerance import remesh, run_with_restarts
from .loop import Trainer, TrainerConfig

REMESH = "remesh"
REBALANCE_EXPERTS = "rebalance_experts"
RESCHEDULE_CKPT = "reschedule_ckpt"
ALL_ACTIONS = (REMESH, REBALANCE_EXPERTS, RESCHEDULE_CKPT)


class MitigationRestart(RuntimeError):
    """Raised inside ``Trainer.run`` when an action needs a rebuild (the
    remesh path).  A RuntimeError on purpose: ``run_with_restarts``
    already supervises exactly this — it rebuilds the trainer (whose
    config the policy now overrides) and resumes from the checkpoint the
    policy saved before raising."""

    def __init__(self, action: "MitigationAction"):
        super().__init__(f"mitigation restart: {action.kind} at "
                         f"step {action.step}")
        self.action = action


@dataclasses.dataclass(frozen=True)
class MitigationAction:
    """One applied mitigation, in replayable terms."""

    step: int                    # completed train steps when it fired
    window: int                  # verdict-log window index that triggered
    kind: str                    # remesh | rebalance_experts | reschedule_ckpt
    paths: Tuple[str, ...]       # verdict paths behind the decision
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)


def region_takes(trace: RegionTrace) -> Dict[str, Any]:
    """Every wall and CPU take of ``trace`` by region path, in ms
    ((steps, shards, repeats) nested lists), and the CPU clock's tick:
    what the analyzer judged a window on (its dissimilarity on the CPU
    times, snapped to the wall below a tick)."""
    tree = trace.tree()
    out: Dict[str, Any] = {"cpu_tick_ms": round(
        float(trace.meta.get("cpu_tick", 0.0)) * 1e3, 3)}
    for key, name in (("wall_ms", WALL_TIME), ("cpu_ms", CPU_TIME)):
        a = trace.metric(name)
        out[key] = {tree[rid].path: np.round(
            a[:, :, :, j].transpose(0, 2, 1) * 1e3, 3).tolist()
            for j, rid in enumerate(trace.region_ids)}
    return out


def rebalance_expert_iters(rows: Tuple[Tuple[int, ...], ...]
                           ) -> Tuple[Tuple[int, ...], ...]:
    """Even redistribution per shard: each shard keeps its total probe
    iterations (the routed token budget) but spreads them across experts,
    remainder to the lowest expert ids — the emulated analogue of
    rebalancing the router."""
    out = []
    for row in rows:
        base, rem = divmod(sum(row), len(row))
        out.append(tuple(base + (1 if e < rem else 0)
                         for e in range(len(row))))
    return tuple(out)


class MitigationPolicy:
    """Map persisted online verdicts to mitigation actions.

    The policy is handed to ``TrainerConfig.mitigate``; the trainer calls
    :meth:`observe` after every traced step.  Steps accumulate into
    ``window_steps``-sized tumbling windows, each analyzed by the full
    AutoAnalyzer into the same :class:`WindowVerdictLog` the streaming
    layer uses.  Every window is *classified* into an action candidate
    (or none); an action fires only when the last ``persist`` windows
    classified the **same** candidate (one anomalous window is noise,
    and a persisting verdict that maps to no action — e.g. standing
    heavy regions in an instrumented tree — never triggers anything).
    Each (kind, paths) signature fires at most once — the same verdict
    persisting after its mitigation is a report to escalate, not a
    reason to thrash.

    The policy outlives any single trainer: a remesh action records
    config overrides that :func:`mitigated_trainer` applies when
    ``run_with_restarts`` rebuilds, so state (verdict log, actions,
    fired signatures) carries across the restart.
    """

    def __init__(self, window_steps: int = 1, persist: int = 2,
                 analyzer_kw: Optional[Dict[str, Any]] = None,
                 straggler_ratio: float = 1.5,
                 enabled: Tuple[str, ...] = ALL_ACTIONS):
        if window_steps < 1:
            raise ValueError(f"window_steps must be >= 1, got {window_steps}")
        self.window_steps = window_steps
        self.analyzer_kw = dict(analyzer_kw or {})
        self.straggler_ratio = straggler_ratio
        self.enabled = frozenset(enabled)
        unknown = self.enabled - set(ALL_ACTIONS)
        if unknown:
            raise ValueError(f"unknown actions {sorted(unknown)}; "
                             f"known: {list(ALL_ACTIONS)}")
        self.log = WindowVerdictLog(persist=persist)
        self.actions: List[MitigationAction] = []
        # Per-window classification signature ((kind, paths) or None),
        # parallel to log.windows — recovery accounting reads this: a
        # post-mitigation window is clean iff it no longer classifies to
        # the mitigated signature.
        self.window_candidates: List[Optional[Tuple[str, Tuple[str, ...]]]] \
            = []
        # Every window's takes (region_takes), parallel to log.windows:
        # what window_log reports beside each verdict.
        self.window_takes: List[Dict[str, Any]] = []
        self.remeshed = False
        self._pending: List[RegionTrace] = []
        self._fired: set = set()
        self._overrides: Dict[str, Any] = {}
        self._tree = None
        self._analyzer: Optional[AutoAnalyzer] = None

    # -- results -----------------------------------------------------------
    @property
    def trigger_verdict(self):
        """The verdict that caused the first action (None before any)."""
        if not self.actions:
            return None
        return self.log.windows[self.actions[0].window].verdict

    def window_log(self) -> List[Dict[str, Any]]:
        """Each window as a report of a run shows it: its index, its
        signature (``window_candidates``), the verdict's CCR paths (None
        for a degraded window) and every take by region path
        (:func:`region_takes`)."""
        out = []
        for w, sig, takes in zip(self.log.windows, self.window_candidates,
                                 self.window_takes):
            v = None if w.degraded else w.verdict
            out.append({
                "index": w.index,
                "signature": None if sig is None else [sig[0], list(sig[1])],
                "dissimilarity_paths": (None if v is None else
                                        sorted(v.dissimilarity_paths)),
                "disparity_paths": (None if v is None else
                                    sorted(v.disparity_paths)),
                **takes})
        return out

    # -- the observation loop ----------------------------------------------
    def observe(self, trainer: Trainer) -> Optional[MitigationAction]:
        """Consume the step the trainer just finished; analyze a window
        when one completes; fire at most one action.  Called by
        ``Trainer.run`` after every traced step.  The remesh action
        raises :class:`MitigationRestart` (by design — see class doc)."""
        step_trace = trainer._last_step_trace
        if step_trace is None:
            return None
        self._pending.append(step_trace)
        if len(self._pending) < self.window_steps:
            return None
        win = (self._pending[0] if len(self._pending) == 1
               else RegionTrace.merge(self._pending))
        self._pending = []
        stop = trainer.step
        self.window_takes.append(region_takes(win))
        bad = sorted(k for k, v in win.data.items()
                     if not np.isfinite(v).all())
        if bad:
            # Corrupt samples must not drive a mitigation (or crash the
            # trainer): log the gap and resume with the next window —
            # same degradation contract as the OnlineAnalyzer.
            self.log.append(DegradedWindow(
                index=len(self.log.windows), start=stop - win.n_steps,
                stop=stop, reason="non-finite samples",
                detail={"metrics": bad}))
            self.window_candidates.append(None)
            return None
        res = self._analyzer_for(trainer.region_tree).analyze_trace(win)
        wv = WindowVerdict(index=len(self.log.windows),
                           start=stop - win.n_steps, stop=stop,
                           verdict=res.verdict)
        self.log.append(wv)
        rm = win.reduce()
        per_shard = rm.metric(WALL_TIME).sum(axis=1)
        hot = self.hot_expert_paths(trainer.region_tree, rm) \
            if trainer.tcfg.trace_expert_iters is not None else None
        action = self.classify(trainer.tcfg, wv, per_shard,
                               hot_expert_paths=hot)
        sig = (action.kind, action.paths) if action is not None else None
        self.window_candidates.append(sig)
        if action is None:
            return None
        tail = self.window_candidates[-self.log.persist:]
        if len(tail) < self.log.persist or any(t != sig for t in tail):
            return None               # candidate has not persisted yet
        if sig in self._fired:
            return None               # idempotence: one action per verdict
        self._fired.add(sig)
        self.actions.append(action)
        self._apply(trainer, action)  # REMESH raises MitigationRestart
        return action

    def _analyzer_for(self, tree) -> AutoAnalyzer:
        # Rebuilt when the trainer rebuilds (post-remesh the tree object
        # is new); the analyzer itself is indifferent to shard count.
        if self._analyzer is None or self._tree is not tree:
            self._tree = tree
            self._analyzer = AutoAnalyzer(tree, **self.analyzer_kw)
        return self._analyzer

    # -- verdict -> action --------------------------------------------------
    def hot_expert_paths(self, tree, rm) -> Tuple[str, ...]:
        """Expert probe regions whose measured wall stands out *among the
        experts* (``straggler_ratio`` x their median).  The probe regions
        are heavy by design relative to cheap regions like the optimizer,
        so the analyzer's relative severity legitimately flags them all
        even when routing is perfectly balanced — a collapse is imbalance
        across the expert set, not the set being expensive."""
        experts = [r for r in tree.regions() if "/moe/expert_" in r.path]
        if len(experts) < 2:
            return ()
        walls = np.array([rm.region_mean(WALL_TIME, r.region_id)
                          for r in experts])
        med = float(np.median(walls))
        return tuple(sorted(r.path for r, w in zip(experts, walls)
                            if w > self.straggler_ratio * med))

    def classify(self, tcfg: TrainerConfig, wv: WindowVerdict,
                 per_shard: Optional[np.ndarray],
                 hot_expert_paths: Optional[Tuple[str, ...]] = None
                 ) -> Optional[MitigationAction]:
        """Decide what a verdict calls for.  Precedence: a disparity
        pinned to a *measured-hot* expert probe region is the most
        specific signal; a host-I/O cause while periodic saves are on
        reads as a checkpoint stall (rescheduling is cheaper than
        remeshing, and the stalled shard is not genuinely slow
        hardware); only then does an isolated slow shard justify the
        remesh.  ``hot_expert_paths=None`` means no measurement is
        available and the verdict's own localization is trusted."""
        v = wv.verdict
        if REBALANCE_EXPERTS in self.enabled \
                and tcfg.trace_expert_iters is not None:
            expert_paths = tuple(sorted(
                p for p in v.disparity_paths if "/moe/expert_" in p))
            if hot_expert_paths is not None:
                expert_paths = tuple(p for p in expert_paths
                                     if p in hot_expert_paths)
            if expert_paths:
                hot = sorted(int(p.rsplit("expert_", 1)[1])
                             for p in expert_paths)
                return MitigationAction(
                    step=wv.stop, window=wv.index, kind=REBALANCE_EXPERTS,
                    paths=expert_paths, detail={"hot_experts": hot})
        if RESCHEDULE_CKPT in self.enabled and tcfg.ckpt_every \
                and HOST_BYTES in v.cause_attributes:
            return MitigationAction(
                step=wv.stop, window=wv.index, kind=RESCHEDULE_CKPT,
                paths=wv.paths(),
                detail={"ckpt_every": tcfg.ckpt_every})
        if REMESH in self.enabled and v.dissimilar \
                and per_shard is not None and len(per_shard) > 1:
            slow = int(np.argmax(per_shard))
            rest = np.delete(np.asarray(per_shard, dtype=np.float64), slow)
            if per_shard[slow] > self.straggler_ratio * float(np.median(rest)):
                return MitigationAction(
                    step=wv.stop, window=wv.index, kind=REMESH,
                    paths=v.dissimilarity_paths,
                    detail={"slow_shard": slow,
                            "new_shards": len(per_shard) - 1,
                            "per_shard_seconds": [float(x)
                                                  for x in per_shard]})
        return None

    # -- action application --------------------------------------------------
    def _apply(self, trainer: Trainer, action: MitigationAction) -> None:
        if action.kind == REBALANCE_EXPERTS:
            new = rebalance_expert_iters(trainer.tcfg.trace_expert_iters)
            action.detail["new_expert_iters"] = new
            # In place: _traced_step re-reads tcfg every step, so the
            # balanced probe counts apply from the next step, no restart.
            trainer.tcfg.trace_expert_iters = new
            self._overrides["trace_expert_iters"] = new
        elif action.kind == RESCHEDULE_CKPT:
            # Phase-shift the save cadence off the step it collided with
            # (a +1 period moves every future save to a different step
            # residue; frequency stays within 1 of the configured one).
            new_every = trainer.tcfg.ckpt_every + 1
            action.detail["new_ckpt_every"] = new_every
            trainer.tcfg.ckpt_every = new_every
            self._overrides["ckpt_every"] = new_every
        else:   # REMESH: checkpoint, drop the shard, rebuild via restart
            slow = action.detail["slow_shard"]
            keep = [i for i in range(trainer.tcfg.trace_shards) if i != slow]
            self._overrides["trace_shards"] = len(keep)
            if trainer.tcfg.trace_iters is not None:
                self._overrides["trace_iters"] = tuple(
                    trainer.tcfg.trace_iters[i] for i in keep)
            if trainer.tcfg.trace_expert_iters is not None:
                self._overrides["trace_expert_iters"] = tuple(
                    trainer.tcfg.trace_expert_iters[i] for i in keep)
            self._pending.clear()
            self.remeshed = True
            trainer.save()
            raise MitigationRestart(action)

    # -- config plumbing for the rebuild path --------------------------------
    def apply_config(self, tcfg: TrainerConfig) -> TrainerConfig:
        """The base config with this policy's accumulated overrides (and
        the policy itself) applied — what every (re)build must use so a
        remesh survives the restart."""
        return dataclasses.replace(tcfg, mitigate=self, **self._overrides)


def mitigated_trainer(cfg, opt_cfg, data_cfg, tcfg: TrainerConfig,
                      policy: MitigationPolicy, device=None) -> Trainer:
    """Build a Trainer under the policy's current config overrides — the
    ``make_trainer`` body for a supervised closed loop.  After a remesh
    action the checkpoint (written under the old shard layout) is
    restored under the new one via :func:`remesh` — checkpoints store
    unsharded-logical arrays, so the elastic scale-down is just a restore
    with the new layout (replicated: the port has no mesh yet).
    ``run_with_restarts``'s own ``maybe_resume`` then re-restores
    idempotently."""
    trainer = Trainer(cfg, opt_cfg, data_cfg, policy.apply_config(tcfg),
                      device=device)
    if policy.remeshed and tcfg.ckpt_dir \
            and ckpt_mod.latest_step(tcfg.ckpt_dir) is not None:
        step, trees = remesh(tcfg.ckpt_dir, cfg,
                             trainer.checkpoint_templates())
        trainer.adopt_restore(step, trees)
    return trainer


def run_mitigated(cfg, opt_cfg, data_cfg, tcfg: TrainerConfig,
                  policy: MitigationPolicy, steps: Optional[int] = None,
                  max_restarts: int = 3, device=None) -> Trainer:
    """The closed loop, end to end: a policy-instrumented trainer
    supervised by :func:`run_with_restarts`, so a remesh action's
    :class:`MitigationRestart` is handled exactly like a node failure —
    rebuild (now under the policy's overrides) and resume from the
    checkpoint the policy saved."""
    steps = tcfg.steps if steps is None else steps
    return run_with_restarts(
        lambda: mitigated_trainer(cfg, opt_cfg, data_cfg, tcfg, policy,
                                  device=device),
        steps, max_restarts=max_restarts)


def recovery_summary(policy: MitigationPolicy) -> Dict[str, Any]:
    """Post-run recovery accounting, in the corpus's ground-truth terms:
    which action fired, at which window/step (time-to-mitigate), and how
    many consecutive windows closed the run *clean of the mitigated
    signature* (did the mitigation actually clear the fault it acted
    on?).  Clean is relative to the action: a window that still
    classifies to the very signature the policy mitigated is dirty;
    standing verdicts that map to no action — or to a different fault —
    do not mask a successful recovery."""
    act = policy.actions[0] if policy.actions else None
    clean_tail = 0
    if act is not None:
        sig = (act.kind, act.paths)
        for w, cand in zip(reversed(policy.log.windows),
                           reversed(policy.window_candidates)):
            if w.index <= act.window:
                break
            if cand == sig:
                break
            clean_tail += 1
    return {
        "action_kind": act.kind if act else None,
        "action_window": act.window if act else None,
        "action_step": act.step if act else None,
        "n_actions": len(policy.actions),
        "clean_windows_after": clean_tail,
        "trigger_paths": list(act.paths) if act else [],
    }
