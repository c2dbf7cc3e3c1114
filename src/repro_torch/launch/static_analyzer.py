"""AutoAnalyzer over a dry-run cell: the twin of the reference's
``repro/launch/static_analyzer.py`` — the paper's disparity analysis
applied to the *phases* of a training step.

Each code region (embed / attention sublayer / mlp-or-moe sublayer /
head+loss / optimizer) runs once, standalone, on ``meta`` DTensors under
the mesh and the reference's shardings, with its activation rules under
sequence parallelism as the reference's; its per-rank FLOPs, bytes and
collective bytes (``core.hlo.costs_of`` on the local shards) become the
region's metrics, scaled as the reference scales them (each layer region
by depth x ``TRAIN_MULTIPLIER``, embed and head by 3 for forward and
backward), with estimated time = max(three roofline terms, on the H100
by default) standing in for the clock.  The counts follow the reference's
compiled cost analysis: elementwise FLOPs as XLA counts them, bytes as a
fused module moves them (``costs_of(xla=True, fused=True)``), and, for a
configuration that does not declare the flash path (``use_flash``: every
shipped config, whose reference attention XLA compiles unfused), the
attention as the unfused attention's work
(``kernels.flash_attention.unfused_attention_work``) in place of the
flash kernel's.  The k-means severity bands and the rough-set root causes
of the port's :class:`~repro_torch.core.AutoAnalyzer` then point at what
to optimize.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import (BYTES, COMM_BYTES, COMM_TIME, CPU_TIME, FLOPS,
                              WALL_TIME, AnalysisResult, AutoAnalyzer,
                              RegionMetrics, RegionTree, render,
                              static_metrics_from_costs)
from repro_torch.core.hlo import (H100_SXM, HardwareSpec, costs_of,
                                  roofline_terms)
from repro_torch.launch.specs import abstract_model_state, model_shardings
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (attention, embed, mla_angles,
                                       mla_attention, mla_rope_cfg, mlp,
                                       rms_norm, rope_angles, rope_dim)
from repro_torch.models.transformer import chunked_ce_from_hidden
from repro_torch.optim import AdamWConfig, apply_updates
from repro_torch.sharding import (activation_sharding, distribute,
                                  rules_for, scatter_seq, sharding_for)

# backward pass ~ 2x forward FLOPs; +1x recompute under remat "nothing"
TRAIN_MULTIPLIER = 4.0


def _region_cost(fn, args, mesh, act_rules, unfused) -> Dict[str, float]:
    with activation_sharding(mesh, act_rules):
        flops, nbytes, coll = costs_of(fn, *args, device_type="meta",
                                       xla=True, fused=True, unfused=unfused)
    return {"flops": flops, "bytes": nbytes,
            "coll": float(coll.total_bytes)}


def _layer(params: Dict[str, torch.Tensor], prefix: str):
    """Layer 0's entries of ``params`` as a nested dict (``attn.wq`` ->
    ``{"attn": {"wq": ...}}``)."""
    out: Dict = {}
    for key, t in params.items():
        if key.startswith(prefix):
            *heads, leaf = key[len(prefix):].split(".")
            node = out
            for h in heads:
                node = node.setdefault(h, {})
            node[leaf] = t
    return out


def analyze_train_cell(cfg: ModelConfig, shape: InputShape, mesh,
                       hw: HardwareSpec = H100_SXM,
                       device: Union[None, str, torch.device] = None,
                       distance_backend: str = "kernel"
                       ) -> Tuple[RegionTree, RegionMetrics, AnalysisResult]:
    """Static per-region analysis of a train step for a dense or moe
    arch; the analyzer runs on the ``distance_backend`` lane on
    ``device`` (None: the card; the "numpy" lane is the exact host lane
    and needs none)."""
    params, axes, opt_shapes, opt_axes = abstract_model_state(cfg)
    p_sh, o_sh = model_shardings(cfg, params, axes, opt_shapes, opt_axes,
                                 mesh)
    p = {k: distribute(t, p_sh[k]) for k, t in params.items()}
    act_rules = rules_for(cfg, param=False, sp=True)
    unfused = not cfg.use_flash
    chips = int(mesh.size())
    B, S, D = shape.global_batch, shape.seq_len, cfg.d_model
    meta = torch.device("meta")
    x = distribute(torch.empty((B, S, D), dtype=cfg.activation_dtype(),
                               device=meta),
                   sharding_for((B, S, D), ("batch", "seq", None),
                                act_rules, mesh))
    tok = distribute(torch.empty((B, S), dtype=torch.int64, device=meta),
                     sharding_for((B, S), ("batch", None), act_rules, mesh))
    lp = _layer(p, "blocks.0.")
    positions = torch.arange(S, dtype=torch.int32, device=meta)

    def attn_fn(lp, x):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.mla is not None:
            out = mla_attention(lp["attn"], cfg, h, positions,
                                mla_angles(cfg, positions),
                                mla_rope_cfg(cfg))
        else:
            angles = rope_angles(positions,
                                 rope_dim(cfg, cfg.resolved_head_dim),
                                 cfg.rope_theta)
            out = attention(lp["attn"], cfg, h, positions, angles)
        return x + scatter_seq(out)

    def ffn_fn(lp, x):
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        if cfg.moe is not None:
            out = moe_mod.moe_block(lp["moe"], cfg, h)[0]
        else:
            out = mlp(lp["mlp"], h, cfg.activation)
        return x + scatter_seq(out)

    def embed_fn(table, tokens):
        return embed(table, cfg, tokens)

    def loss_fn(table, head, x, labels):
        q = {"embed": table}
        if head is not None:
            q["head"] = head
        return chunked_ce_from_hidden(q, cfg, x, labels)

    def opt_fn(p, g, st):
        return apply_updates(AdamWConfig(), p, g, st)[0]

    o = {"m": {k: distribute(t, o_sh["m"][k])
               for k, t in opt_shapes["m"].items()},
         "v": {k: distribute(t, o_sh["v"][k])
               for k, t in opt_shapes["v"].items()},
         "step": distribute(opt_shapes["step"], o_sh["step"])}
    costs: Dict[str, Dict[str, float]] = {}
    def cost(fn, *args):
        return _region_cost(fn, args, mesh, act_rules, unfused)

    costs["embed"] = cost(embed_fn, p["embed"], tok)
    costs["attention"] = cost(attn_fn, lp, x)
    kind = "moe" if cfg.moe is not None else "mlp"
    costs[kind] = cost(ffn_fn, lp, x)
    costs["head_loss"] = cost(loss_fn, p["embed"], p.get("head"), x, tok)
    costs["optimizer"] = cost(opt_fn, p, p, o)

    # scale per-layer regions by depth and the fwd+bwd multiplier
    L = cfg.n_layers
    for name in ("attention", kind):
        for k in costs[name]:
            costs[name][k] *= L * TRAIN_MULTIPLIER
    for name in ("embed", "head_loss"):
        for k in costs[name]:
            costs[name][k] *= 3.0  # fwd + bwd

    tree = RegionTree("train_step")
    metrics: Dict[int, Dict[str, float]] = {}
    for name in costs:
        r = tree.add(name)
        c = costs[name]
        terms = roofline_terms(c["flops"], c["bytes"], c["coll"], chips, hw)
        t = terms.bound_s
        metrics[r.region_id] = {
            WALL_TIME: t,
            CPU_TIME: max(t - terms.collective_s, 1e-12),
            COMM_TIME: terms.collective_s,
            FLOPS: c["flops"],
            BYTES: c["bytes"],
            COMM_BYTES: c["coll"],
        }
    rm = static_metrics_from_costs(sorted(metrics), metrics, n_processes=1,
                                   tree=tree)
    az = AutoAnalyzer(tree, peak_flops_per_s=hw.peak_flops,
                      distance_backend=distance_backend, device=device)
    return tree, rm, az.analyze(rm)


def report_cell(cfg, shape, mesh,
                device: Union[None, str, torch.device] = None,
                distance_backend: str = "kernel") -> str:
    tree, rm, res = analyze_train_cell(cfg, shape, mesh, device=device,
                                       distance_backend=distance_backend)
    lines = [f"AutoAnalyzer disparity triage — {cfg.name} × {shape.name}",
             render(tree, res)]
    return "\n".join(lines)
