"""Fault tolerance: restart-on-failure, and the re-mesh restore.

The PyTorch port of the reference's ``repro/train/fault_tolerance.py``.

* :func:`run_with_restarts` — supervises a Trainer; on an exception it
  rebuilds from the newest complete checkpoint and continues, up to
  ``max_restarts``.  Restores are integrity-verified: a checkpoint
  corrupted by the very crash that triggered the restart is skipped and
  the newest *verified* step is used instead (``checkpoint.restore``).
* :func:`remesh` — restores a checkpoint for a different shard layout.
  Checkpoints store unsharded arrays, so with no mesh the restore is
  replicated; a restore under a real device mesh waits for multi-device
  (ROADMAP.md queue 1, item 7).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from . import checkpoint as ckpt_mod
from .loop import Trainer


def run_with_restarts(make_trainer: Callable[[], Trainer], steps: int,
                      max_restarts: int = 3,
                      fail_at: Optional[int] = None) -> Trainer:
    """Run ``steps`` total steps, recreating the trainer from its latest
    checkpoint after each failure."""
    restarts = 0
    trainer = make_trainer()
    trainer.maybe_resume()
    while True:
        try:
            remaining = steps - trainer.step
            if remaining <= 0:
                return trainer
            trainer.run(remaining, fail_at=fail_at)
            return trainer
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
            fail_at = None  # injected failure fires once
            trainer = make_trainer()
            # maybe_resume survives a torn/corrupt latest checkpoint:
            # restore falls back to the newest verified step, and when
            # *nothing* verifies it warns and starts fresh.
            trainer.maybe_resume()


def remesh(ckpt_dir: str, cfg, templates: Dict[str, Any], new_mesh=None,
           axes_tree=None):
    """Restore a checkpoint for a new shard layout: replicated (no mesh),
    as host tensors shaped like ``templates``."""
    if new_mesh is not None or axes_tree is not None:
        raise NotImplementedError(
            "a restore sharded over a device mesh is not ported yet "
            "(ROADMAP.md queue 1, item 7)")
    return ckpt_mod.restore(ckpt_dir, templates)
