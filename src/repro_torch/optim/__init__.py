"""The optimizer (the reference's ``repro.optim`` without its compressed
all-reduce, which waits for multi-device: ROADMAP.md queue 1, item 7)."""
from .adamw import (AdamWConfig, apply_updates, global_norm, init_opt_state,
                    lr_at)

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_opt_state",
           "lr_at"]
