"""Multi-pod dry-run: the twin of the reference's
``repro/launch/dryrun.py``, with the same flags and JSON keys.

For every (architecture x input shape x mesh) cell:
  * PRODUCTION pass — the cell runs once on ``meta`` DTensors under the
    production mesh, placed by the reference's rules
    (``launch.specs.model_shardings``, ``sharding.activation_sharding``):
    a training step's forward, backward and AdamW update, a prefill's
    last-position forward, or one ``decode_step``.  Nothing is allocated
    and the process group is fake (``launch.mesh.fake_world``), so one
    host runs a 512-rank cell; its per-rank FLOPs, bytes and collectives
    are counted on the local shards as the cell runs
    (``core.hlo.costs_of``), and its per-rank memory from the shards
    (``launch.roofline.memory_analysis_dict``);
  * COST probes — the same cell at depth L=1 and L=2, fitted as
    cost(L) = fixed + L·body and extrapolated to the real depth.  The
    reference needs them because XLA's cost analysis counts a scan body
    once; the port runs every layer eagerly, so its production count is
    already the full count and the extrapolation equals it (for depths
    that are whole units: a hybrid's tail counts as a fraction of a
    block, as in the reference).  They are kept so the two packages'
    ``cost`` fields mean the same.

The kernels (RMSNorm, attention, WKV-6) return shaped outputs on ``meta``
and count their analytic work (``kernels.counting_costs``) on each
rank's shards (``kernels.local``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x22b \\
      --shape train_4k [--multi-pod] [--no-probes] [--out out.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out f.json]
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Any, Dict

import torch
from torch.nn.utils.stateless import _reparametrize_module

from repro_torch.configs import SHAPES, get_arch, list_archs, shapes_for
from repro_torch.core.hlo import H100_SXM, costs_of, roofline_terms
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import (PRODUCTION, fake_world,
                                    make_production_mesh)
from repro_torch.launch.specs import (abstract_model_state, batch_shardings,
                                      decode_input_specs, decode_state_specs,
                                      model_shardings, param_count,
                                      state_shardings, train_batch_specs)
from repro_torch.models import family_module
from repro_torch.models.layers import logits_from
from repro_torch.models.transformer import LOGIT_AXES
from repro_torch.optim import AdamWConfig
from repro_torch.sharding import (activation_sharding, constrain,
                                  distribute, rules_for)
from repro_torch.train.loop import make_train_step


def _place(tree, shardings):
    """``tree`` (meta tensors; ints pass) as DTensors under
    ``shardings`` (a tree of the same structure)."""
    if isinstance(tree, dict):
        return {k: _place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_place(v, s) for v, s in zip(tree, shardings)]
    if isinstance(tree, torch.Tensor):
        return distribute(tree, shardings)
    return tree


def _cell(cfg, shape, mesh):
    """``(fn, args, forward)`` of one cell on ``mesh``: ``fn(*args)`` is
    the cell; ``forward()`` (train only) the loss alone, for the bytes
    the backward keeps."""
    decode = shape.kind == "decode"
    params, axes, opt_shapes, opt_axes = abstract_model_state(cfg)
    p_sh, o_sh = model_shardings(cfg, params, axes, opt_shapes, opt_axes,
                                 mesh, decode=decode)
    p = _place(params, p_sh)
    model = family_module(cfg).init(cfg, None, "meta")
    if shape.kind == "train":
        o = _place(opt_shapes, o_sh)
        specs = train_batch_specs(cfg, shape)
        b = _place(specs, batch_shardings(specs, mesh))
        step = make_train_step(cfg, AdamWConfig())

        def forward():
            leaves = {k: t.detach().requires_grad_() for k, t in p.items()}
            with _reparametrize_module(model, leaves, tie_weights=True,
                                       strict=True):
                return family_module(cfg).loss_fn(model, None, b)[0]

        return step, (p, o, b), forward
    if shape.kind == "prefill":
        specs = train_batch_specs(cfg, shape)
        specs.pop("labels")
        b = _place(specs, batch_shardings(specs, mesh))

        def prefill(p, batch):
            with torch.no_grad(), _reparametrize_module(
                    model, p, tie_weights=True, strict=True):
                x, _ = model(batch["tokens"], embeds=batch.get("embeds"),
                             return_hidden=True)
                return constrain(logits_from(p["embed"], p.get("head"), cfg,
                                             x[:, -1:]), LOGIT_AXES)

        return prefill, (p, b), None
    st = decode_state_specs(cfg, shape)
    st = _place(st, state_shardings(st, mesh, shape.global_batch,
                                    n_kv_heads=cfg.n_kv_heads))
    ins = decode_input_specs(cfg, shape)
    tok = _place(ins["tokens"], batch_shardings(
        {"tokens": ins["tokens"]}, mesh)["tokens"])

    def decode_step(p, state, tokens, pos):
        with _reparametrize_module(model, p, tie_weights=True, strict=True):
            return model.decode_step(state, tokens, pos)

    return decode_step, (p, st, tok, ins["pos"]), None


def _run(cfg, shape, mesh, *, seq_sharded=False, memory: bool = False):
    """Run one cell, counted: ``(cost, memory dict or None, seconds)``."""
    act = rules_for(cfg, param=False, seq_sharded=seq_sharded)
    t0 = time.perf_counter()
    with activation_sharding(mesh, act):
        fn, args, forward = _cell(cfg, shape, mesh)
        out = []
        flops, nbytes, coll = costs_of(lambda: out.append(fn(*args)),
                                       device_type="meta")
        mem = None
        if memory:
            temp = rl.kept_bytes(forward)[1] if forward else None
            mem = rl.memory_analysis_dict(args, out, temp)
    cost = {"flops": flops, "bytes": nbytes,
            "collective_bytes": float(coll.total_bytes),
            "coll_by_op": dict(coll.bytes_by_op),
            "coll_counts": dict(coll.count_by_op)}
    return cost, mem, time.perf_counter() - t0


def _probe_cfg(cfg, depth_units: int):
    """A depth-reduced clone for the cost probes."""
    if cfg.family == "hybrid":
        return cfg.with_(
            n_layers=depth_units * len(cfg.recurrent.block_pattern))
    if cfg.family == "encdec":
        return cfg.with_(n_layers=depth_units, n_encoder_layers=depth_units)
    return cfg.with_(n_layers=depth_units)


def _extrapolate(c1: Dict, c2: Dict, depth: float) -> Dict[str, Any]:
    """cost(L) = fixed + L·body, fitted at L=1,2, evaluated at ``depth``
    (the reference's fit and clamps)."""
    out: Dict[str, Any] = {}
    for k in ("flops", "bytes", "collective_bytes"):
        body = c2[k] - c1[k]
        fixed = c1[k] - body
        out[k] = max(fixed + depth * body, c1[k], c2[k], 0.0)
    ops = set(c1["coll_by_op"]) | set(c2["coll_by_op"])
    out["coll_by_op"] = {}
    out["coll_counts"] = {}
    for op in ops:
        b1, b2 = c1["coll_by_op"].get(op, 0), c2["coll_by_op"].get(op, 0)
        n1, n2 = c1["coll_counts"].get(op, 0), c2["coll_counts"].get(op, 0)
        out["coll_by_op"][op] = max(0.0, (b1 - (b2 - b1)) + depth * (b2 - b1))
        out["coll_counts"][op] = max(0.0, (n1 - (n2 - n1)) + depth * (n2 - n1))
    return out


def _depth_units(cfg) -> float:
    from repro_torch.models.transformer import hybrid_pattern
    if cfg.family == "hybrid":
        n_blocks, tail = hybrid_pattern(cfg)
        return n_blocks + len(tail) / len(cfg.recurrent.block_pattern)
    return float(cfg.n_layers)


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool = False,
             probes: bool = True, cfg_override=None, hw=None, mesh=None
             ) -> Dict[str, Any]:
    """One cell's JSON record (the reference's keys; ``count_s`` is the
    production pass's seconds, in place of XLA's lower and compile
    times).  Without ``mesh`` the production mesh, on a fake world of its
    size started here when no process group is live.

    The port's cells run without sequence parallelism (SP), where the
    reference's training cells have it: with a batch cut over (pod, data)
    and the sequence over model, the backward's products take activations
    DTensor holds as strided shards.  DTensor (PyTorch 2.13) plans each
    such product by a graph search that took 15 to 60 s a product on a
    (2, 16, 16) mesh (a one-layer mixtral smoke cell: 252 s with SP, 16 s
    without, on a CPU host), and PyTorch 2.11 refuses them.  So the
    port's training cells keep the residual stream whole along the
    sequence, and their temp bytes are those of the reference's rules
    without SP."""
    hw = hw or H100_SXM
    cfg = cfg_override or get_arch(arch_id).full
    shape = SHAPES[shape_name]
    seq_sharded = shape.name == "long_500k"
    if mesh is None:
        if not torch.distributed.is_initialized():
            fake_world(math.prod(PRODUCTION[multi_pod][0]))
        mesh = make_production_mesh(multi_pod=multi_pod)
    params = abstract_model_state(cfg)[0]
    n_total = param_count(params)
    n_active = n_total
    if cfg.moe is not None:
        mo = cfg.moe
        n_active -= int(cfg.n_layers * (mo.n_experts - mo.top_k)
                        * 3 * cfg.d_model * mo.d_ff)
    model_flops = rl.model_flops_for(cfg, shape, n_total, n_active)
    cost, mem, count_s = _run(cfg, shape, mesh, seq_sharded=seq_sharded,
                              memory=True)
    chips = int(mesh.size())
    result: Dict[str, Any] = {
        "arch": arch_id, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.shape), "chips": chips,
        "count_s": count_s, "memory": mem, "production_cost_raw": cost,
        "model_flops": model_flops, "params_b": n_total / 1e9,
        "active_params_b": n_active / 1e9,
    }
    if probes:
        costs = [_run(_probe_cfg(cfg, d), shape, mesh,
                      seq_sharded=seq_sharded)[0]
                 for d in (1, 2)]
        ext = _extrapolate(costs[0], costs[1], _depth_units(cfg))
        result["cost"] = ext
        terms = roofline_terms(ext["flops"], ext["bytes"],
                               ext["collective_bytes"], chips, hw,
                               model_flops=model_flops / chips)
        result["roofline"] = {
            "compute_s": terms.compute_s, "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "dominant": terms.dominant,
            "useful_ratio": terms.useful_flops_ratio,
            "roofline_fraction": terms.roofline_fraction,
            "bound_s": terms.bound_s,
        }
    return result


def iter_cells():
    for arch_id in list_archs():
        if arch_id == "st-100m":
            continue
        for shape in shapes_for(get_arch(arch_id).full):
            yield arch_id, shape.name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cells = list(iter_cells()) if args.all else [(args.arch, args.shape)]
    results = []
    for arch_id, shape_name in cells:
        t0 = time.perf_counter()
        try:
            r = run_cell(arch_id, shape_name, multi_pod=args.multi_pod,
                         probes=not args.no_probes)
            r["ok"] = True
        except Exception as e:  # a dry-run failure is a bug to surface
            r = {"arch": arch_id, "shape": shape_name, "ok": False,
                 "error": f"{type(e).__name__}: {e}"}
        r["wall_s"] = time.perf_counter() - t0
        results.append(r)
        print(json.dumps(r)[:2000], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r for r in results if not r.get("ok")]
    print(f"\n{len(results) - len(bad)}/{len(results)} cells OK",
          file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
