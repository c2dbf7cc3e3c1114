"""Quickstart: train a small LM for a few steps, then time its step
phases shard by shard with AutoAnalyzer attached and print the
paper-style performance-debugging report.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--device cpu|cuda]

The twin of the reference's ``examples/quickstart.py``: the trainer, the
timed regions and the analyzer (the CUDA seed-row kernel's lane) on the
card unless ``--device`` says otherwise (without a card the default
fails).
"""
import argparse

import torch

from repro_torch.configs import get_arch
from repro_torch.core import (AutoAnalyzer, RegionTree, TimedRegionRunner,
                              render)
from repro_torch.data import DataConfig, device_batch
from repro_torch.models import family_module
from repro_torch.models.layers import embed
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    cfg = get_arch("st-100m").smoke
    trainer = Trainer(
        cfg,
        AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=30),
        DataConfig(seq_len=64, global_batch=4, vocab=cfg.vocab),
        TrainerConfig(steps=30, ckpt_dir=None),
        device=args.device,
    )
    hist = trainer.run()
    print(f"trained {len(hist)} steps: "
          f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")

    # -- AutoAnalyzer over an instrumented region tree --------------------
    # Regions = the step phases; shards emulate SPMD processes.
    tree = RegionTree("train_step")
    mod = family_module(cfg)
    model = mod.init(cfg, None, "meta")   # structure only; params swap in

    def fwd_embed(state, batch):
        return embed(state["params"]["embed"], cfg, batch["tokens"])

    def loss_region(state, batch):
        with torch.no_grad():
            loss, _ = mod.loss_fn(model, state["params"], batch)
        return loss

    tree.add("embed", fn=lambda s, b: (s, fwd_embed(s, b))[0])
    tree.add("loss", fn=lambda s, b: (s, loss_region(s, b))[0])

    shards = 4
    dcfg = DataConfig(seq_len=64, global_batch=shards, vocab=cfg.vocab)
    batches = [
        {k: v[i:i + 1] for k, v in
         device_batch(dcfg, 0, trainer.device).items()}
        for i in range(shards)
    ]
    states = [{"params": trainer.params} for _ in range(shards)]
    runner = TimedRegionRunner(tree, device=trainer.device)
    rm = runner.run(states, batches)
    res = AutoAnalyzer(tree, device=trainer.device).analyze(rm)
    print()
    print(render(tree, res))


if __name__ == "__main__":
    main()
