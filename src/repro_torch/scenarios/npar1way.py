"""Synthetic reproduction of the paper's NPAR1WAY study (§6.2).

12 code regions, 8 processes, no dissimilarity bottleneck.  Disparity
bottlenecks: region 3 (instructions-retired heavy, 26% of total) and
region 12 (instructions + network I/O heavy: 60% of instructions, 70% of
network bytes).  Rough-set core: {a4, a5} (network I/O + instructions).
``optimize=True`` models the paper's common-subexpression elimination
(instructions of region 3 -36.32%, region 12 -16.93%)."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core import (RegionBehavior, RegionMetrics, RegionTree,
                        SyntheticWorkload)

N_PROCESSES = 8


def npar1way_scenario(optimize: bool = False,
                      seed: int = 0) -> Tuple[RegionTree, RegionMetrics]:
    tree = RegionTree("NPAR1WAY")
    for i in range(1, 13):
        tree.add(f"cr{i}")
    bal = np.ones(N_PROCESSES)
    b = {}
    for rid in range(1, 13):
        b[rid] = RegionBehavior(base_time=0.4, imbalance=bal,
                                flops_per_s=1e9, vmem_pressure=0.02,
                                hbm_intensity=0.02, comm_bytes=1e8)
    # paper §6.2.2: instructions -36.32% (r3) / -16.93% (r12), wall clock
    # -20.33% / -8.46%; flops_per_s compensates so flops == time × fps
    # drops by exactly the instruction delta
    t3 = 12.0 * (1.0 - (0.2033 if optimize else 0.0))
    t12 = 26.0 * (1.0 - (0.0846 if optimize else 0.0))
    f3 = (1.0 - 0.3632) / (1.0 - 0.2033) if optimize else 1.0
    f12 = (1.0 - 0.1693) / (1.0 - 0.0846) if optimize else 1.0
    b[3] = RegionBehavior(base_time=t3, imbalance=bal,
                          flops_per_s=8e9 * f3, vmem_pressure=0.02,
                          hbm_intensity=0.02, comm_bytes=2e8)
    b[12] = RegionBehavior(base_time=t12, imbalance=bal,
                           flops_per_s=8e9 * f12, vmem_pressure=0.02,
                           hbm_intensity=0.02, comm_bytes=70e9,
                           comm_time_frac=0.3)
    wl = SyntheticWorkload(tree, b, N_PROCESSES, seed=seed)
    return tree, wl.collect()
