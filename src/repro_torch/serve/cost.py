"""Deterministic analytic cost model for the serving engine.

A copy of the reference's ``repro.serve.cost`` (numpy only): the same
salt, noise-draw order and float arithmetic, so a run's trace equals the
reference's bit for bit.

The serving corpus (scenarios/corpus.py, backend "serving") needs
bit-reproducible traces at any seed, which real timing cannot give; this
backend plays the role ``SyntheticWorkload`` plays for the synthetic
backend — same schedule as the jitted path (the scheduler is shared and
timing-independent), analytic per-region costs instead of measured ones.

Cost model (work units; seconds = units x ``unit_time``):

* prefill of a ``k``-token chunk at positions ``[a, a+k)`` costs
  ``prefill_tok * (k + sum(positions)/attn_ref)`` — the quadratic
  attention term, which is what makes a long-tail prompt's *later*
  chunks genuinely more expensive than a short prompt's (the long-tail
  straggler entry keys on it).
* decode costs a flat ``decode_tok`` per token (the per-position KV-scan
  term is deliberately dropped — documented simplification; occupancy
  effects are the fault archetypes' job, not the baseline's).
* kv_append costs ``kv_tok`` per appended slot and records the lane's
  cache *occupancy* as VMEM_PRESSURE — the condition signal
  ``KVCacheThrash`` triggers on.
* sample costs ``sample_tok`` per sampled token.
* MoE decode adds an inclusive ``moe`` parent: ``moe_router`` per token
  plus per-expert shares of ``expert_tok * top_k`` per token.  Hot
  requests (hot-prompt repetition) route ``hot_share`` of their expert
  work to ``hot_expert``; cold requests route uniformly.  Routing skew
  is therefore *emergent from the traffic mix*, not injected.

Derived metrics mirror ``SyntheticWorkload``: cpu = wall (no comms in
serving), flops = t * flops_per_s, bytes = t * flops_per_s * intensity,
HBM_INTENSITY/VMEM_PRESSURE constants where the region is active.
Multiplicative jitter (0.5 %) is drawn region-major per step in a fixed
order from one seeded generator, so the full run is a pure function of
(traffic, config, seed).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core import (BYTES, CPU_TIME, FLOPS, HBM_INTENSITY,
                              RAW_METRICS, VMEM_PRESSURE, WALL_TIME)
from repro_torch.core.trace import RegionTrace

from .engine import DECODE, KV_APPEND, MOE, PREFILL, SAMPLE, LaneEvent, \
    serve_region_tree

# Salt keeps measurement-noise draws decoupled from traffic generation
# at the same seed.
_COST_SALT = 0xC057


@dataclasses.dataclass(frozen=True)
class ServeCostModel:
    """Work-unit costs (docs/serving.md has the derivations)."""

    unit_time: float = 1e-3      # seconds per work unit
    prefill_tok: float = 1.0
    attn_ref: float = 16.0       # positions per extra prefill work unit
    decode_tok: float = 3.5
    kv_tok: float = 0.8
    sample_tok: float = 2.0
    # -- MoE ---------------------------------------------------------------
    moe_router: float = 0.5
    expert_tok: float = 3.0
    hot_share: float = 0.85      # hot requests' routing mass on hot_expert
    # -- derived-metric constants (SyntheticWorkload conventions) ----------
    jitter: float = 0.005
    flops_per_s: float = 2e9
    hbm: float = 0.02            # bytes per flop, compute regions
    kv_hbm: float = 0.03         # bytes per flop, kv_append
    vmem: float = 0.25           # resting VMEM_PRESSURE where active


class CostModelBackend:
    """Execution backend producing analytic per-step traces."""

    def __init__(self, lanes: int, cost: ServeCostModel = None,
                 moe_experts: int = 0, top_k: int = 2, hot_expert: int = 0,
                 seed: int = 0, name: str = "serve"):
        self.lanes = lanes
        self.cost = cost or ServeCostModel()
        self.moe_experts = moe_experts
        self.top_k = top_k
        self.hot_expert = hot_expert
        self.tree = serve_region_tree(moe_experts=moe_experts, name=name)
        self.region_ids = [r.region_id for r in self.tree.regions()]
        self._rng = np.random.default_rng(seed + _COST_SALT)
        root = self.tree.root.name
        self._rid = {p: self.tree.by_path(f"{root}/{p}").region_id
                     for p in (PREFILL, DECODE, KV_APPEND, SAMPLE)}
        if moe_experts:
            self._rid[MOE] = self.tree.by_path(f"{root}/{MOE}").region_id
            self._expert_rids = [
                self.tree.by_path(f"{root}/{MOE}/expert_{e}").region_id
                for e in range(moe_experts)]
        else:
            self._expert_rids = []
        # Fixed noise-draw order: one (lanes,) vector per work region per
        # step, drawn whether or not any lane is active there, so the
        # noise stream is independent of the schedule (and of faults).
        self._noise_order = [PREFILL, DECODE, KV_APPEND, SAMPLE]
        if moe_experts:
            self._noise_order += [MOE] + [f"expert_{e}"
                                          for e in range(moe_experts)]

    def warmup(self) -> None:  # nothing to compile
        pass

    def _shares(self, hot: bool) -> np.ndarray:
        E = self.moe_experts
        if not hot:
            return np.full(E, 1.0 / E)
        shares = np.full(E, (1.0 - self.cost.hot_share) / max(E - 1, 1))
        shares[self.hot_expert] = self.cost.hot_share
        return shares

    def execute(self, s: int, events: Sequence[LaneEvent]) -> RegionTrace:
        c = self.cost
        m = self.lanes
        # Work units per (region, lane), this step.
        W: Dict[str, np.ndarray] = {p: np.zeros(m) for p in self._noise_order}
        router = np.zeros(m)
        occ = np.zeros(m)
        for ev in events:
            if ev.request is None:
                continue
            lane = ev.lane
            if ev.prefill_tokens:
                k, a = ev.prefill_tokens, ev.prefill_start
                possum = k * a + k * (k - 1) / 2.0
                W[PREFILL][lane] = c.prefill_tok * (k + possum / c.attn_ref)
            if ev.decode_tokens:
                d = ev.decode_tokens
                W[DECODE][lane] = c.decode_tok * d
                if self.moe_experts:
                    router[lane] = c.moe_router * d
                    shares = self._shares(ev.request.hot)
                    for e in range(self.moe_experts):
                        W[f"expert_{e}"][lane] = \
                            d * c.expert_tok * self.top_k * shares[e]
            if ev.kv_tokens:
                W[KV_APPEND][lane] = c.kv_tok * ev.kv_tokens
                occ[lane] = ev.occupancy
            if ev.sample_tokens:
                W[SAMPLE][lane] = c.sample_tok * ev.sample_tokens

        tr = RegionTrace.for_tree(self.tree, self.region_ids, m, n_steps=1,
                                  metrics=RAW_METRICS,
                                  meta={"collector": "serve"})
        wall = tr.metric(WALL_TIME)[0, 0]
        cpu = tr.metric(CPU_TIME)[0, 0]
        flops = tr.metric(FLOPS)[0, 0]
        byts = tr.metric(BYTES)[0, 0]
        vmem = tr.metric(VMEM_PRESSURE)[0, 0]
        hbm = tr.metric(HBM_INTENSITY)[0, 0]

        times: Dict[str, np.ndarray] = {}
        for region in self._noise_order:
            noise = 1.0 + c.jitter * self._rng.standard_normal(m)
            if region == MOE:
                # The inclusive parent: router work with its own noise;
                # expert children (drawn after) are summed in below.
                times[region] = router * c.unit_time * noise
                continue
            times[region] = W[region] * c.unit_time * noise
        for e in range(self.moe_experts):
            times[MOE] = times[MOE] + times[f"expert_{e}"]

        for region, t in times.items():
            rid = self._rid.get(region)
            if rid is None:  # expert children
                e = int(region.split("_")[1])
                rid = self._expert_rids[e]
            j = tr.col(rid)
            active = t > 0
            intensity = c.kv_hbm if region == KV_APPEND else c.hbm
            wall[:, j] = t
            cpu[:, j] = t
            flops[:, j] = t * c.flops_per_s
            byts[:, j] = t * c.flops_per_s * intensity
            hbm[:, j] = np.where(active, intensity, 0.0)
            if region == KV_APPEND:
                vmem[:, j] = occ
            else:
                vmem[:, j] = np.where(active, c.vmem, 0.0)
        return tr


def serving_analyzer_meta(analyzer_kw: Dict) -> Dict:
    """Header meta that lets ``analyze_trace.py`` / a live tail replay
    the exact analyzer configuration (the train-artifact convention)."""
    return {"analyzer_kw": dict(analyzer_kw)} if analyzer_kw else {}


__all__: List[str] = ["ServeCostModel", "CostModelBackend",
                      "serving_analyzer_meta"]
