"""Fault tolerance: restart-on-failure, and the re-mesh restore.

The PyTorch port of the reference's ``repro/train/fault_tolerance.py``.

* :func:`run_with_restarts` — supervises a Trainer; on an exception it
  rebuilds from the newest complete checkpoint and continues, up to
  ``max_restarts``.  Restores are integrity-verified: a checkpoint
  corrupted by the very crash that triggered the restart is skipped and
  the newest *verified* step is used instead (``checkpoint.restore``).
* :func:`remesh` — restores a checkpoint for a different shard layout.
  Checkpoints store unsharded arrays (a sharded run saves them whole), so
  any mesh can read any checkpoint: with no mesh the restore is
  replicated host tensors, under a mesh with an axes tree each parameter
  is a DTensor placed by the reference's ``PARAM_RULES``.
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
    """Restore a checkpoint under ``new_mesh`` (elastic re-mesh), as the
    reference's: with an ``axes_tree`` (the logical axes of the
    ``"params"`` template, ``models.convert.axes_tree``) the parameters
    come back as DTensors on ``new_mesh`` placed by ``rules_for(cfg)``;
    otherwise every tree restores replicated, as host tensors."""
    shardings = None
    if new_mesh is not None and axes_tree is not None:
        from repro_torch.sharding import rules_for, tree_shardings
        shardings = {"params": _tree_map2(
            lambda leaf, axes: tree_shardings(
                {"x": leaf}, {"x": axes}, rules_for(cfg), new_mesh)["x"],
            templates["params"], axes_tree)}
    return ckpt_mod.restore(ckpt_dir, templates, shardings=shardings)


def _tree_map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)
