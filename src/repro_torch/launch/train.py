"""Training launcher: the twin of the reference's ``repro.launch.train``,
with the same flags plus ``--device``.

On the card (RMSNorm, attention and WKV-6 through the hand-written CUDA
kernels, their gradients through plain PyTorch formulas; each block
recomputed in the backward as the config's ``remat_policy`` says)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch st-100m \\
        --steps 20 --batch 8 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
        --steps 20 --batch 8 --seq 1024

Smoke-scale on the host (the kernels' plain versions)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch st-100m \\
        --smoke --steps 20 --batch 4 --seq 64 --device cpu

With ``--mesh DxM`` (data x model, or ``PxDxM`` with a pod axis) the
parameters and the optimizer state are DTensors placed by the
reference's ``PARAM_RULES`` and each step runs under its activation
rules (``train.loop.make_sharded_train_step``), over the process group
``torchrun`` starts (``nccl`` on the card, ``gloo`` with ``--device
cpu``), or a world of one::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch st-100m --steps 20 --batch 8 --seq 1024 --mesh 2x2
    PYTHONPATH=src python -m repro_torch.launch.train --arch st-100m \
        --steps 3 --batch 8 --seq 1024 --mesh 1x1

A sharded run resumes from and saves to ``--ckpt-dir`` as an unsharded
one does (the checkpoints hold whole tensors, the same bytes) and traces
nothing; it prints a step's loss and kernel launches every
``--log-every`` steps, and its final JSON line adds the mesh, the losses
and the launches per step.

Without a card the default fails.  Weights are random, drawn from a
``torch.Generator`` seeded with ``--seed``.  Before the reference's final
JSON line it prints the median step time, the tokens per second at that
median, and the peak device memory; step 0, which pays one-time costs
(the kernels' load, the allocator's growth), is left out of the median.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.data import DataConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="st-100m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of the model (default: cuda)")
    ap.add_argument("--mesh", default=None,
                    help="DxM or PxDxM: train sharded on this mesh")
    return ap


def build_trainer(args: argparse.Namespace, mesh=None) -> Trainer:
    entry = get_arch(args.arch)
    cfg = entry.smoke if args.smoke else entry.full
    return Trainer(
        cfg,
        AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                    total_steps=args.steps),
        DataConfig(seq_len=args.seq, global_batch=args.batch,
                   vocab=cfg.vocab),
        TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, seed=args.seed),
        device=args.device, mesh=mesh)


def throughput(trainer: Trainer, args: argparse.Namespace) -> dict:
    """Median step seconds over steps 1.. (all steps when there is one),
    tokens per second at that median, and the peak device memory (None
    on the CPU)."""
    secs = [h["seconds"] for h in trainer.history]
    steady = secs[1:] or secs
    med = float(np.median(steady))
    on_card = trainer.device.type == "cuda"
    return {"median_step_s": med,
            "tokens_per_s": args.batch * args.seq / med,
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(
                trainer.device) if on_card else None)}


def sharded_main(args: argparse.Namespace) -> int:
    """``--mesh``: every rank builds the same seeded state (or resumes the
    newest checkpoint in ``--ckpt-dir``, read whole), keeps its shards,
    and runs ``args.steps`` sharded steps; checkpoints are saved whole
    every ``--ckpt-every`` steps and at the end, as ``Trainer.run`` saves
    them."""
    import time

    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.data import device_batch
    from repro_torch.launch.mesh import make_mesh, mesh_axes_for, \
        start_world
    from repro_torch.models.convert import params_to_tree
    from repro_torch.train import checkpoint
    from repro_torch.train.loop import (make_sharded_train_step,
                                        shard_train_state)
    shape = tuple(int(n) for n in args.mesh.split("x"))
    on_card = args.device is None or str(args.device).startswith("cuda")
    local_rank = start_world("nccl" if on_card else "gloo")
    if on_card:
        args.device = f"cuda:{local_rank}"
    try:
        mesh = make_mesh(shape, mesh_axes_for(shape),
                         "cuda" if on_card else "cpu")
        trainer = build_trainer(args, mesh)
        cfg = trainer.cfg
        rank0 = dist.get_rank() == 0
        if trainer.maybe_resume() and rank0:
            print(f"resumed from step {trainer.step}")
        params, opt = shard_train_state(cfg, trainer.params,
                                        trainer.opt_state, mesh)
        del trainer.params, trainer.opt_state
        step_fn = make_sharded_train_step(cfg, trainer.opt_cfg, mesh)

        def save(step: int) -> None:
            if args.ckpt_dir:
                checkpoint.save(args.ckpt_dir, step, {
                    "params": params_to_tree(params, cfg),
                    "opt_state": {"m": params_to_tree(opt["m"], cfg),
                                  "v": params_to_tree(opt["v"], cfg),
                                  "step": opt["step"]}},
                    meta={"config": cfg.name})

        start = trainer.step
        end = start + args.steps
        losses, launches, secs = [], [], []
        for step in range(start, end):
            before = dict(K.LAUNCHES)
            t0 = time.perf_counter()
            batch = device_batch(trainer.data_cfg, step, trainer.device,
                                 mesh=mesh)
            params, opt, metrics = step_fn(params, opt, batch)
            losses.append(float(metrics["loss"].full_tensor()))
            secs.append(time.perf_counter() - t0)
            trainer.monitor.observe_step(step, secs[-1])
            launches.append({k: v - before[k]
                             for k, v in K.LAUNCHES.items()})
            if rank0 and (step % args.log_every == 0 or step == end - 1):
                print(f"step {step:6d} loss {losses[-1]:.4f} "
                      f"({secs[-1] * 1e3:.1f} ms) launches {launches[-1]}")
            if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
        save(end)
        if rank0:
            print(json.dumps({
                "final_loss": losses[-1], "steps": end,
                "straggler_events": len(trainer.monitor.events),
                "mesh": args.mesh, "losses": losses,
                "launches_per_step": launches,
                "median_step_s": float(np.median(secs[1:] or secs)),
                "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                                      if on_card else None)}))
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.mesh:
        return sharded_main(args)
    trainer = build_trainer(args)
    resumed = trainer.maybe_resume()
    if resumed:
        print(f"resumed from step {trainer.step}")
    hist = trainer.run()
    for h in hist:
        if h["step"] % args.log_every == 0 or h["step"] == hist[-1]["step"]:
            print(f"step {h['step']:6d} loss {h['loss']:.4f} "
                  f"({h['seconds']*1e3:.1f} ms)")
    tp = throughput(trainer, args)
    print(f"median step {tp['median_step_s'] * 1e3:.3f} ms (step 0 "
          f"excluded), {tp['tokens_per_s']:.1f} tokens/s")
    print(f"peak device memory {tp['peak_memory_bytes']} bytes")
    print(json.dumps({"final_loss": hist[-1]["loss"],
                      "steps": trainer.step,
                      "straggler_events": len(trainer.monitor.events)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
