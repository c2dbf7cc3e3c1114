"""End to end: train the ~100M-parameter 'st-100m' config (the
paper-workload analogue) for a few hundred steps with checkpointing,
straggler monitoring, and the trainer's step history.

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 200 \\
        --batch 2 --seq 128
    PYTHONPATH=src python -m repro_torch.examples.train_100m --smoke \\
        --steps 20 --device cpu

The twin of the reference's ``examples/train_100m.py``, with the same
arguments plus ``--device`` (default: the card; without one it fails).
Checkpoints go to ``--ckpt-dir``, by default a directory under the
system's temporary directory; a run resumes from the newest one there.
Full production shapes go through ``repro_torch.launch.train`` instead.
"""
import argparse
import json
import os
import tempfile

from repro_torch.configs import get_arch
from repro_torch.data import DataConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="use the tiny config instead of the 100M one")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_100m_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    entry = get_arch("st-100m")
    cfg = entry.smoke if args.smoke else entry.full
    trainer = Trainer(
        cfg,
        AdamWConfig(lr=6e-4, warmup_steps=max(args.steps // 20, 1),
                    total_steps=args.steps),
        DataConfig(seq_len=args.seq, global_batch=args.batch,
                   vocab=cfg.vocab),
        TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=max(args.steps // 4, 1)),
        device=args.device,
    )
    if trainer.maybe_resume():
        print(f"resumed from step {trainer.step}")
    hist = trainer.run()
    for h in hist:
        if h["step"] % max(args.steps // 10, 1) == 0:
            print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
                  f"{h['seconds']*1e3:7.1f} ms")
    print(json.dumps({
        "params": sum(p.numel() for p in trainer.params.values()),
        "first_loss": hist[0]["loss"],
        "final_loss": hist[-1]["loss"],
        "straggler_events": trainer.monitor.events,
    }, default=str))


if __name__ == "__main__":
    main()
