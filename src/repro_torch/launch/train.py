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
    return ap


def build_trainer(args: argparse.Namespace) -> Trainer:
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
        device=args.device)


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


def main(argv=None) -> int:
    args = parser().parse_args(argv)
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
