"""Training loop: the step function, the traced step, checkpoints.

The PyTorch port of the reference's ``repro/train/loop.py`` for every
family (the ssm family trains through the WKV-6 kernel's autograd
Function, the hybrid family through its plain RG-LRU scan, encdec's
cross-attention through the attention kernel's autograd Function; a vlm
or encdec batch carries its frontend's ``embeds``:
``data.batch_for_model``).  The models recompute their blocks in the
backward as the config's ``remat_policy`` says
(``models.transformer.remat``).
Parameters are a dict of tensors keyed as the model's state dict; the
model module itself is a skeleton on the ``meta`` device that its
family's ``loss_fn`` (``models.family_module``) runs with those tensors
swapped in (held through the backward, which recomputes blocks: see
:func:`value_and_grad`), and gradients come from
``torch.autograd.grad`` with respect to detached leaf copies.  Every
step function returns new tensors and updates nothing in place: a traced
step runs each region more than once on the same input state
(``TimedRegionRunner``'s cost count and warmup) and keeps only the last
output, so training state advances exactly once per step.

With ``TrainerConfig.trace`` set the trainer runs a *region-instrumented*
step — the forward/backward and the optimizer as leaves of a
:class:`RegionTree`, executed once per emulated SPMD shard on that shard's
slice of the batch — and records every step into a :class:`RegionTrace`.
The trace is the single source of truth: :class:`StragglerMonitor`
observations are derived from its per-shard samples, ``run`` emits a
portable ``.npz`` artifact (the reference's format), and
``python -m repro_torch.cli.analyze_trace`` replays the full analysis
offline.  Long runs stream through a
:class:`repro_torch.stream.TraceSpool` (``trace_spool_dir``), finalized
byte-identically to the monolithic save.  On MoE configs
``trace_expert_iters`` adds per-expert probe regions to the instrumented
tree, so routing imbalance is per-region work the analyzer can localize.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.nn.utils.stateless import _reparametrize_module

from repro_torch.configs.base import ModelConfig
from repro_torch.core import (RegionTrace, RegionTree, TimedRegionRunner,
                              WALL_TIME, optics_cluster)
from repro_torch.data import DataConfig, device_batch, host_batch, to_device
from repro_torch.device import resolve_device
from repro_torch.models import family_module
from repro_torch.models.convert import params_from_tree, params_to_tree
from repro_torch.optim import AdamWConfig, apply_updates, init_opt_state

from . import checkpoint as ckpt_mod

Params = Dict[str, torch.Tensor]


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family the reference does not know."""
    family_module(cfg)


def _skeleton(cfg: ModelConfig) -> torch.nn.Module:
    """The model's structure with no storage: every call swaps a
    parameter dict in."""
    check_trainable(cfg)
    return family_module(cfg).init(cfg, None, "meta")


def value_and_grad(model: torch.nn.Module, params: Params,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Params]:
    """``(total, info, grads)`` of the loss at ``params``, differentiated
    through detached leaf copies (``params`` gains no graph or ``.grad``).
    ``batch`` holds ``tokens``, ``labels``, optionally ``mask`` and, for
    a vlm or encdec model, ``embeds``.

    The leaves stay swapped into ``model`` through the backward too, where
    ``remat``'s checkpoints recompute blocks: ``functional_call`` swaps
    them in for one module call only, so this holds the swap it is built
    on (``_reparametrize_module``) around both."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    with _reparametrize_module(model, leaves, tie_weights=True, strict=True):
        total, info = family_module(model.cfg).loss_fn(model, None, batch)
        grads = torch.autograd.grad(total, list(leaves.values()))
    return (total.detach(), {k: v.detach() for k, v in info.items()},
            dict(zip(leaves, grads)))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, new tensors out."""
    model = _skeleton(cfg)

    def train_step(params, opt_state, batch):
        total, info, grads = value_and_grad(model, params, batch)
        new_params, new_opt, om = apply_updates(opt_cfg, params, grads,
                                                opt_state)
        metrics = {"loss": info["loss"], "total_loss": total, **om}
        if "expert_counts" in info:
            metrics["expert_counts"] = info["expert_counts"]
        return new_params, new_opt, metrics

    return train_step


def shard_train_state(cfg: ModelConfig, params: Params,
                      opt_state: Dict[str, Any], mesh
                      ) -> Tuple[Params, Dict[str, Any]]:
    """``params`` and the AdamW state (the same full tensors on every
    rank) as DTensors on ``mesh``: each parameter and its two moments
    placed by the reference's ``PARAM_RULES`` (``rules_for(cfg)``) over
    its logical axes (``models.convert.param_axes``), the step count
    replicated.  Each rank keeps its own shards; nothing is sent."""
    from repro_torch.models.convert import param_axes
    from repro_torch.sharding import (distribute, distribute_tree,
                                      rules_for, sharding_for,
                                      tree_shardings)
    sh = tree_shardings(params, param_axes(cfg), rules_for(cfg), mesh)
    step = distribute(opt_state["step"], sharding_for((), (), {}, mesh))
    return distribute_tree(params, sh), {
        "m": distribute_tree(opt_state["m"], sh),
        "v": distribute_tree(opt_state["v"], sh), "step": step}


def make_sharded_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                            mesh) -> Callable:
    """:func:`make_train_step` on DTensor parameters, optimizer state and
    batch (:func:`shard_train_state`, ``data.device_batch(...,
    mesh=mesh)``) under the reference's activation rules
    (``sharding.activation_sharding``): the twin of the reference's train
    step jitted with shardings.  The kernels run on each rank's shards
    (``kernels.local``)."""
    from repro_torch.sharding import activation_sharding, rules_for
    step = make_train_step(cfg, opt_cfg)
    act_rules = rules_for(cfg, param=False)

    def sharded_step(params, opt_state, batch):
        with activation_sharding(mesh, act_rules):
            return step(params, opt_state, batch)

    return sharded_step


def _expert_probe_leaf(cfg: ModelConfig, expert: int) -> Callable:
    """A per-expert instrumented region: run expert ``expert``'s gated FFN
    (layer 0's weights from the live params) on the shard's probe-token
    tile ``bundle["expert_iters"][expert]`` times, so a hot expert
    genuinely executes more work, per shard, inside its own region.  Each
    iteration rolls the tile by its index and adds to the carried
    accumulator, as the reference's ``fori_loop`` does; under a cost
    count the body runs once, as the reference's compiled cost counts
    it (``kernels.loop_trips``), so every expert's region counts the same
    FLOPs and its time per FLOP grows with its iterations."""
    from repro_torch.kernels import loop_trips
    from repro_torch.models.layers import _act

    def leaf(state, bundle):
        toks = bundle["probe_tokens"]                       # (T, d_model)
        # the float32 tile promotes the product, as in the reference
        wi, wg, wo = (state["params"][f"blocks.0.moe.{n}"][expert]
                      .to(toks.dtype) for n in ("wi", "wg", "wo"))
        probe = state["probe"]
        for i in range(loop_trips(int(bundle["expert_iters"][expert]))):
            x = torch.roll(toks, i, dims=0)
            h = _act(x @ wg, cfg.activation) * (x @ wi)
            probe = probe + (h @ wo).sum()
        return {**state, "probe": probe}

    return leaf


def train_region_tree(cfg: ModelConfig, opt_cfg: AdamWConfig,
                      iterated: bool = False,
                      expert_probe: bool = False) -> RegionTree:
    """The training step as a code-region tree (paper §2 applied to the
    train loop): ``train/{fwd_bwd, optimizer}`` leaves threading a stable
    ``{params, opt_state, grads, loss}`` state dict, runnable by
    :class:`TimedRegionRunner` once per emulated shard.

    With ``iterated=True`` the forward/backward leaf is wrapped in
    :func:`repro_torch.scenarios.faults.iterated_work`, so shard data
    arrives as ``(batch, iters)`` bundles and a shard carrying a larger
    ``iters`` genuinely executes more work — the corpus fault-injection
    hook on real model steps.  Each iteration grads the batch rolled by
    the loop index, as the reference does (the loss is
    permutation-invariant over the batch).

    With ``expert_probe=True`` (MoE configs only) the tree grows a
    ``moe/expert_<e>`` leaf per routed expert (:func:`_expert_probe_leaf`)
    and shard data arrives as a dict bundle ``{batch, iters, expert_iters,
    probe_tokens}``."""
    model = _skeleton(cfg)

    def fwd_bwd(state, batch):
        # Accumulate into the carried grads (zero on step entry; the
        # optimizer region resets them), as the reference does.
        _, info, grads = value_and_grad(model, state["params"], batch)
        acc = {k: state["grads"][k] + g for k, g in grads.items()}
        return {**state, "grads": acc, "loss": info["loss"]}

    def optimizer(state, batch):
        new_params, new_opt, _ = apply_updates(
            opt_cfg, state["params"], state["grads"], state["opt_state"])
        return {**state, "params": new_params, "opt_state": new_opt,
                "grads": {k: torch.zeros_like(g)
                          for k, g in state["grads"].items()}}

    tree = RegionTree("train")
    if expert_probe and cfg.moe is None:
        raise ValueError(f"{cfg.name}: expert_probe needs an MoE config")
    if iterated:
        # Lazy import: scenarios.corpus imports this module for the train
        # backend, so the reverse edge must not exist at module scope.
        from repro_torch.scenarios.faults import iterated_work

        def fwd_bwd_micro(state, bundle):
            batch, i = bundle
            rolled = {k: torch.roll(v, i, dims=0) for k, v in batch.items()}
            return fwd_bwd(state, rolled)

        fwd_bwd_iter = iterated_work(fwd_bwd_micro, indexed=True)

    if expert_probe:
        # Dict bundles: every region unpacks the piece it consumes.
        if iterated:
            def fwd_bwd_leaf(state, bundle):
                return fwd_bwd_iter(state, (bundle["batch"],
                                            bundle["iters"]))
        else:
            def fwd_bwd_leaf(state, bundle):
                return fwd_bwd(state, bundle["batch"])
        tree.add("fwd_bwd", fn=fwd_bwd_leaf)
        moe_parent = tree.add("moe")
        for e in range(cfg.moe.n_experts):
            tree.add(f"expert_{e}", parent=moe_parent,
                     fn=_expert_probe_leaf(cfg, e))

        def optimizer_leaf(state, bundle):
            return optimizer(state, bundle["batch"])
        tree.add("optimizer", fn=optimizer_leaf)
    elif iterated:
        tree.add("fwd_bwd", fn=fwd_bwd_iter)

        def optimizer_b(state, bundle):
            batch, _ = bundle
            return optimizer(state, batch)
        tree.add("optimizer", fn=optimizer_b)
    else:
        tree.add("fwd_bwd", fn=fwd_bwd)
        tree.add("optimizer", fn=optimizer)
    return tree


def make_eval_step(cfg: ModelConfig) -> Callable:
    model = _skeleton(cfg)

    def eval_step(params, batch):
        with torch.no_grad():
            _, info = family_module(cfg).loss_fn(model, params, batch)
        return info["loss"]

    return eval_step


@dataclasses.dataclass
class TrainerConfig:
    """The reference's trainer settings, without the two it never reads
    (``log_every``, ``analyze_every``)."""
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    seed: int = 0
    straggler_threshold: float = 1.75  # step_time > thr × running median
    # -- region-instrumented (traced) mode --------------------------------
    trace: bool = False            # run the region-instrumented step
    trace_path: Optional[str] = None   # save the merged artifact here
    trace_shards: int = 4          # emulated SPMD shards
    trace_repeats: int = 1         # timing repeats per (region, shard)
    # Per-shard fwd_bwd iteration counts (fault-injection hook: a shard
    # with more iterations genuinely executes more work).
    trace_iters: Optional[Tuple[int, ...]] = None
    trace_meta: Optional[Dict[str, Any]] = None  # merged into the header
    # -- streaming collection ---------------------------------------------
    # With a spool directory set, per-step traces stream to disk as
    # segment files instead of accumulating in memory; trace_path still
    # works — the closed spool finalizes into the same (byte-identical)
    # artifact.
    trace_spool_dir: Optional[str] = None
    trace_chunk_steps: int = 8
    # -- MoE expert probe (expert regions in the instrumented tree) -------
    # Per-shard per-expert probe iteration counts ((n_shards, n_experts)):
    # each expert_<e> region runs its FFN expert_iters[shard][e] times, so
    # routing imbalance becomes genuinely executed per-region work.
    trace_expert_iters: Optional[Tuple[Tuple[int, ...], ...]] = None
    trace_probe_tokens: int = 64   # probe tile rows per expert iteration
    # -- closed-loop mitigation (train/mitigate.py) -------------------------
    # A MitigationPolicy (duck-typed: observe(trainer)) consulted after
    # every traced step.
    mitigate: Optional[Any] = None
    # Trace-injection seam: called as trace_inject(trainer, step, trace)
    # right after the instrumented step produces its RegionTrace and
    # before anything consumes it (spool, monitor, mitigation policy).
    # May return a replacement trace (or mutate in place and return
    # None).
    trace_inject: Optional[Callable[["Trainer", int, RegionTrace],
                                    Optional[RegionTrace]]] = None

    def __post_init__(self) -> None:
        if self.trace_path or self.trace_iters or self.trace_spool_dir \
                or self.trace_expert_iters or self.mitigate is not None:
            self.trace = True
        if self.trace_iters is not None and \
                len(self.trace_iters) != self.trace_shards:
            raise ValueError(
                f"trace_iters has {len(self.trace_iters)} entries for "
                f"{self.trace_shards} shards")
        if self.trace_expert_iters is not None and \
                len(self.trace_expert_iters) != self.trace_shards:
            raise ValueError(
                f"trace_expert_iters has {len(self.trace_expert_iters)} "
                f"entries for {self.trace_shards} shards")


class StragglerMonitor:
    """Dissimilarity-based straggler detection (paper §4.2.1 applied to the
    time dimension).  Per-shard step-time vectors are clustered with the
    simplified OPTICS algorithm when available; the scalar fallback flags
    steps slower than ``threshold ×`` the running median (restart/evict
    trigger for the fault-tolerance layer)."""

    def __init__(self, threshold: float = 1.75, window: int = 32):
        self.threshold = threshold
        self.window = window
        self.times: List[float] = []
        self.events: List[Dict] = []

    def observe_step(self, step: int, seconds: float,
                     per_shard: Optional[np.ndarray] = None) -> bool:
        self.times.append(seconds)
        hist = self.times[-self.window:]
        med = float(np.median(hist))
        flagged = len(hist) >= 8 and seconds > self.threshold * med
        if per_shard is not None and len(per_shard) > 1:
            res = optics_cluster(np.asarray(per_shard)[:, None])
            if res.n_clusters > 1:
                flagged = True
                self.events.append({"step": step, "kind": "shard-dissimilarity",
                                    "clusters": res.n_clusters})
        if flagged:
            self.events.append({"step": step, "kind": "slow-step",
                                "seconds": seconds, "median": med})
        return flagged


def _host(tree: Params) -> Params:
    return {k: t.detach().cpu() for k, t in tree.items()}


class Trainer:
    """Trains ``cfg`` on ``device`` (None: the card, which raises without
    one; ``"cpu"`` runs the kernels' plain versions).  ``mesh`` is kept as
    :attr:`mesh` and not used, as in the reference.  The initial weights
    come from a ``torch.Generator`` seeded with ``tcfg.seed`` on the
    device; :meth:`adopt_restore` replaces them (a checkpoint, or the
    reference's weights carried across)."""

    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig,
                 data_cfg: DataConfig, tcfg: TrainerConfig,
                 device: Union[None, str, torch.device] = None, mesh=None):
        check_trainable(cfg)
        self.cfg, self.opt_cfg, self.data_cfg, self.tcfg = (
            cfg, opt_cfg, data_cfg, tcfg)
        # stored and used nowhere else, as the reference's Trainer does
        # (its loop.py:293-296); a sharded step is make_sharded_train_step
        self.mesh = mesh
        self.device = resolve_device(device)
        self.monitor = StragglerMonitor(tcfg.straggler_threshold)
        self.history: List[Dict] = []
        self._build()

    def _build(self) -> None:
        model = family_module(self.cfg).init(self.cfg, self.tcfg.seed,
                                             self.device)
        self.params: Params = {k: p.detach()
                               for k, p in model.named_parameters()}
        del model
        self.opt_state = init_opt_state(self.params)
        self.train_step = make_train_step(self.cfg, self.opt_cfg)
        self.step = 0
        self.trace: Optional[RegionTrace] = None
        self._step_traces: List[RegionTrace] = []
        self._last_step_trace: Optional[RegionTrace] = None
        self.spool = None
        if self.tcfg.trace_spool_dir:
            # Lazy import: repro_torch.stream sits above the core trace
            # layer.  trace_meta rides along provisionally so a live tail
            # resolves run-level configuration (analyzer_kw) before the run
            # ends; close() replaces it with the definitive final meta.
            from repro_torch.stream import TraceSpool
            self.spool = TraceSpool(self.tcfg.trace_spool_dir,
                                    chunk_steps=self.tcfg.trace_chunk_steps,
                                    meta=self.tcfg.trace_meta)
        if self.tcfg.trace:
            if self.tcfg.trace_expert_iters is not None and self.cfg.moe:
                # the shard count is checked in TrainerConfig; the expert
                # count needs the model config (train_region_tree rejects
                # a config without an MoE itself)
                want = self.cfg.moe.n_experts
                for i, row in enumerate(self.tcfg.trace_expert_iters):
                    if len(row) != want:
                        raise ValueError(
                            f"trace_expert_iters[{i}] has {len(row)} "
                            f"entries for {want} experts")
            self.region_tree = train_region_tree(
                self.cfg, self.opt_cfg,
                iterated=self.tcfg.trace_iters is not None,
                expert_probe=self.tcfg.trace_expert_iters is not None)
            # warmup=1, as the reference: the first call of a region pays
            # one-time costs (the kernels' build and load, allocator
            # growth) that would otherwise read as a shard-0 straggler.
            # Warmup outputs are discarded, so training state still
            # advances exactly once per step.
            self.runner = TimedRegionRunner(self.region_tree, warmup=1,
                                            repeats=self.tcfg.trace_repeats,
                                            device=self.device)
            zero_grads = {k: torch.zeros_like(p)
                          for k, p in self.params.items()}
            # Replicated start: every emulated shard trains its own copy
            # of the same initial state on its slice of the global batch.
            state = {"params": self.params, "opt_state": self.opt_state,
                     "grads": zero_grads,
                     "loss": torch.zeros((), dtype=torch.float32,
                                         device=self.device)}
            if self.tcfg.trace_expert_iters is not None:
                state["probe"] = torch.zeros((), dtype=torch.float32,
                                             device=self.device)
                # Per-shard probe-token tiles, seeded and constant across
                # steps (the per-iteration roll varies the work).
                self._probe_tokens = [
                    torch.randn((self.tcfg.trace_probe_tokens,
                                 self.cfg.d_model),
                                generator=torch.Generator().manual_seed(
                                    self.tcfg.seed * 977 + i)
                                ).to(self.device)
                    for i in range(self.tcfg.trace_shards)]
            self._shard_states = [dict(state)
                                  for _ in range(self.tcfg.trace_shards)]

    def _traced_step(self, step: int) -> Dict[str, Any]:
        """One region-instrumented step over all emulated shards; appends
        the per-step trace and feeds the StragglerMonitor from it."""
        m = self.tcfg.trace_shards
        data = []
        for i in range(m):
            batch = to_device(host_batch(self.data_cfg, step, n_shards=m,
                                         shard=i), self.device)
            if self.tcfg.trace_expert_iters is not None:
                # iters is 1 when the entry injects through the expert
                # probe alone
                iters = (self.tcfg.trace_iters[i]
                         if self.tcfg.trace_iters is not None else 1)
                data.append({
                    "batch": batch, "iters": int(iters),
                    "expert_iters": tuple(
                        int(n) for n in self.tcfg.trace_expert_iters[i]),
                    "probe_tokens": self._probe_tokens[i]})
            elif self.tcfg.trace_iters is not None:
                data.append((batch, int(self.tcfg.trace_iters[i])))
            else:
                data.append(batch)
        step_trace = self.runner.run_trace(self._shard_states, data)
        self._shard_states = self.runner.final_states
        if self.tcfg.trace_inject is not None:
            replaced = self.tcfg.trace_inject(self, step, step_trace)
            if replaced is not None:
                step_trace = replaced
        self._last_step_trace = step_trace
        if self.spool is not None:
            self.spool.append(step_trace)
        else:
            self._step_traces.append(step_trace)
        rm = step_trace.reduce()
        per_shard = rm.metric(WALL_TIME).sum(axis=1)   # (m,) step seconds
        # SPMD semantics: the step ends when the slowest shard does.
        seconds = float(per_shard.max())
        self.monitor.observe_step(step, seconds, per_shard=per_shard)
        # Shard 0 is the canonical replica (checkpoints resume from it).
        self.params = self._shard_states[0]["params"]
        self.opt_state = self._shard_states[0]["opt_state"]
        return {"step": step,
                "loss": float(self._shard_states[0]["loss"]),
                "seconds": seconds,
                "per_shard_seconds": [float(x) for x in per_shard]}

    def _final_meta(self, base: Dict[str, Any]) -> Dict[str, Any]:
        """The merged artifact's header meta, built the same way (and in
        the same key order) for the in-memory and spooled paths — key
        order matters because spool finalization must reproduce the
        monolithic save byte-for-byte."""
        meta = dict(base)
        meta["collector"] = "train"
        meta.update(self.tcfg.trace_meta or {})
        meta["straggler_events"] = len(self.monitor.events)
        return meta

    def finalize_trace(self) -> Optional[RegionTrace]:
        """Merge the per-step traces into one artifact (saved to
        ``trace_path`` when set) and expose it as ``self.trace``.  In spool
        mode the spool is closed with the final header meta and the merged
        trace reassembled from its segments."""
        if self.spool is not None:
            if self.spool.n_steps == 0:
                return None
            from repro_torch.stream import SpooledTrace
            if not self.spool.closed:
                self.spool.close(
                    meta=self._final_meta(self.spool.head_meta))
            self.trace = SpooledTrace(self.spool.directory).to_trace()
            if self.tcfg.trace_path:
                self.trace.save(self.tcfg.trace_path)
            return self.trace
        if not self._step_traces:
            return None
        self.trace = RegionTrace.merge(self._step_traces)
        self.trace.meta = self._final_meta(self.trace.meta)
        if self.tcfg.trace_path:
            self.trace.save(self.tcfg.trace_path)
        return self.trace

    # -- checkpoint/resume --------------------------------------------------
    def checkpoint_trees(self) -> Dict[str, Any]:
        """The live state in the reference's checkpoint trees, on the
        host: ``{"params": tree, "opt_state": {"m", "v", "step"}}``."""
        cfg = self.cfg
        return {"params": params_to_tree(_host(self.params), cfg),
                "opt_state": {
                    "m": params_to_tree(_host(self.opt_state["m"]), cfg),
                    "v": params_to_tree(_host(self.opt_state["v"]), cfg),
                    "step": self.opt_state["step"].detach().cpu()}}

    def checkpoint_templates(self) -> Dict[str, Any]:
        """:meth:`checkpoint_trees`' shapes and dtypes on the ``meta``
        device (the templates :func:`checkpoint.restore` reads)."""
        def meta(tree: Params) -> Params:
            return {k: torch.empty_like(t, device="meta")
                    for k, t in tree.items()}
        cfg = self.cfg
        return {"params": params_to_tree(meta(self.params), cfg),
                "opt_state": {
                    "m": params_to_tree(meta(self.opt_state["m"]), cfg),
                    "v": params_to_tree(meta(self.opt_state["v"]), cfg),
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}

    def adopt_restore(self, step: int, trees: Dict[str, Any]) -> None:
        """Adopt restored checkpoint trees (the reference's layout, as
        :func:`checkpoint.restore` returns them) as the live training
        state, on the trainer's device.  In traced mode the emulated
        shards' replicated states are refreshed too — they were built from
        the *initial* params, and a resumed run that kept them would
        silently continue the shards from scratch while reporting the
        checkpoint's step."""
        def live(tree) -> Params:
            return {k: t.to(self.device)
                    for k, t in params_from_tree(tree, self.cfg).items()}
        opt = trees["opt_state"]
        self.params = live(trees["params"])
        self.opt_state = {"m": live(opt["m"]), "v": live(opt["v"]),
                          "step": opt["step"].to(self.device)}
        self.step = step
        if self.tcfg.trace and hasattr(self, "_shard_states"):
            for s in self._shard_states:
                s["params"] = self.params
                s["opt_state"] = self.opt_state

    def maybe_resume(self) -> bool:
        d = self.tcfg.ckpt_dir
        if not d:
            return False
        latest = ckpt_mod.latest_step(d)
        if latest is None:
            return False
        try:
            # restore() verifies integrity and falls back to the newest
            # *verified* step on its own.
            step, trees = ckpt_mod.restore(d, self.checkpoint_templates())
        except ckpt_mod.CheckpointCorruptError as e:
            # Every checkpoint is damaged: a fresh start beats a crash
            # loop, but never silently — the failure list is warned.
            import warnings
            warnings.warn(f"resume abandoned, starting fresh: {e}",
                          RuntimeWarning)
            return False
        self.adopt_restore(step, trees)
        return True

    def save(self) -> None:
        if self.tcfg.ckpt_dir:
            ckpt_mod.save(self.tcfg.ckpt_dir, self.step,
                          self.checkpoint_trees(),
                          meta={"config": self.cfg.name})

    # -- run -----------------------------------------------------------------
    def run(self, steps: Optional[int] = None,
            fail_at: Optional[int] = None) -> List[Dict]:
        """``fail_at`` injects a crash (fault-tolerance tests)."""
        steps = steps if steps is not None else self.tcfg.steps
        end = self.step + steps
        while self.step < end:
            if fail_at is not None and self.step == fail_at:
                raise RuntimeError(f"injected failure at step {self.step}")
            if self.tcfg.trace:
                rec = self._traced_step(self.step)
            else:
                batch = device_batch(self.data_cfg, self.step, self.device)
                t0 = time.perf_counter()
                self.params, self.opt_state, metrics = self.train_step(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])     # waits for the step
                dt = time.perf_counter() - t0
                self.monitor.observe_step(self.step, dt)
                rec = {"step": self.step, "loss": loss, "seconds": dt,
                       "grad_norm": float(metrics["grad_norm"])}
                if "expert_counts" in metrics:
                    rec["expert_counts"] = (
                        metrics["expert_counts"].cpu().numpy())
            self.history.append(rec)
            self.step += 1
            if self.tcfg.trace and self.tcfg.mitigate is not None:
                # Closed loop (train/mitigate.py): the policy windows the
                # step traces, analyzes, and may act — in place (expert
                # rebalance, ckpt reschedule) or by raising
                # MitigationRestart (remesh), which run_with_restarts
                # handles like any failure.
                self.tcfg.mitigate.observe(self)
            if self.tcfg.ckpt_every and self.step % self.tcfg.ckpt_every == 0:
                self.save()
        self.save()
        if self.tcfg.trace:
            self.finalize_trace()
        return self.history
