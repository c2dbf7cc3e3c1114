"""Synthetic reproduction of the paper's MPIBZIP2 study (§6.3).

16 code regions, 8 processes (worker processes; master management regions
excluded).  No dissimilarity bottleneck.  Disparity bottlenecks: region 6
(BZ2_bzBuffToBuffCompress — 96% of instructions retired) and region 7
(MPI_Send of compressed data — 50% of network bytes).  Rough-set core:
{a4, a5}.  The paper could NOT optimize these (third-party compressor,
already-compressed traffic) — there is no optimized variant."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core import (RegionBehavior, RegionMetrics, RegionTree,
                        SyntheticWorkload)

N_PROCESSES = 8


def mpibzip2_scenario(seed: int = 0) -> Tuple[RegionTree, RegionMetrics]:
    tree = RegionTree("MPIBZIP2")
    for i in range(1, 17):
        tree.add(f"cr{i}", management=(i in (1, 2)))
    bal = np.ones(N_PROCESSES)
    b = {}
    for rid in range(1, 17):
        b[rid] = RegionBehavior(base_time=0.5, imbalance=bal,
                                flops_per_s=1e9, vmem_pressure=0.02,
                                hbm_intensity=0.02, comm_bytes=5e7)
    # region 3: block distribution from the master (the other ~half of the
    # network traffic; cheap in time, so not a bottleneck)
    b[3] = RegionBehavior(base_time=0.6, imbalance=bal, flops_per_s=0.5e9,
                          vmem_pressure=0.02, hbm_intensity=0.02,
                          comm_bytes=18e9, comm_time_frac=0.1)
    # region 6: compression (96% of instructions)
    b[6] = RegionBehavior(base_time=40.0, imbalance=bal, flops_per_s=9e9,
                          vmem_pressure=0.02, hbm_intensity=0.02)
    # region 7: sending compressed blocks (50% of network bytes)
    b[7] = RegionBehavior(base_time=8.0, imbalance=bal, flops_per_s=0.5e9,
                          vmem_pressure=0.02, hbm_intensity=0.02,
                          comm_bytes=20e9, comm_time_frac=0.6)
    wl = SyntheticWorkload(tree, b, N_PROCESSES, seed=seed)
    return tree, wl.collect()
