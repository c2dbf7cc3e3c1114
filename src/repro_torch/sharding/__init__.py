"""Logical-axis sharding on DTensor (the reference's ``repro.sharding``)."""
from .rules import (ACT_RULES, DECODE_PARAM_RULES, PARAM_RULES,
                    activation_sharding, constrain, distribute,
                    distribute_tree, gather_seq, placements_for, rules_for,
                    scatter_seq, sequence_parallel, sharding_for, spec_for,
                    tree_shardings, weights_cheaper)

__all__ = ["ACT_RULES", "DECODE_PARAM_RULES", "PARAM_RULES",
           "activation_sharding", "constrain", "distribute",
           "distribute_tree", "gather_seq", "placements_for", "rules_for",
           "scatter_seq", "sequence_parallel", "sharding_for", "spec_for",
           "tree_shardings", "weights_cheaper"]
