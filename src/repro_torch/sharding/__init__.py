"""Logical-axis sharding on DTensor (the reference's ``repro.sharding``)."""
from .rules import (ACT_RULES, DECODE_PARAM_RULES, PARAM_RULES,
                    activation_sharding, constrain, distribute,
                    distribute_tree, placements_for, rules_for, sharding_for,
                    spec_for, tree_shardings)

__all__ = ["ACT_RULES", "DECODE_PARAM_RULES", "PARAM_RULES",
           "activation_sharding", "constrain", "distribute",
           "distribute_tree", "placements_for", "rules_for", "sharding_for",
           "spec_for", "tree_shardings"]
