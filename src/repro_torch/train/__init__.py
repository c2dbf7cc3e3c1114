"""Training: the loop, checkpoints, restarts and closed-loop mitigation
(the reference's ``repro.train``, for the dense and ssm families)."""
from . import checkpoint
from .checkpoint import CheckpointCorruptError
from .fault_tolerance import remesh, run_with_restarts
from .loop import (StragglerMonitor, Trainer, TrainerConfig, make_eval_step,
                   make_train_step, train_region_tree)
from .mitigate import (MitigationAction, MitigationPolicy, MitigationRestart,
                       mitigated_trainer, rebalance_expert_iters,
                       recovery_summary, run_mitigated)

__all__ = ["checkpoint", "CheckpointCorruptError", "remesh",
           "run_with_restarts", "StragglerMonitor",
           "Trainer", "TrainerConfig", "make_eval_step", "make_train_step",
           "train_region_tree", "MitigationAction", "MitigationPolicy",
           "MitigationRestart", "mitigated_trainer",
           "rebalance_expert_iters", "recovery_summary", "run_mitigated"]
