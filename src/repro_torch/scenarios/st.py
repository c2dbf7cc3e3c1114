"""Synthetic reproduction of the paper's ST study (§6.1).

ST: seismic tomography, 4307 lines, 14 coarse code regions (Fig. 8),
8 MPI processes.  Injected behaviours match the published analysis:

  * region 11 (nested in 14): imbalanced instructions retired across
    processes -> 5 clusters {0},{1,2},{3},{4,6},{5,7} (Fig. 9/11);
    high L2-miss-rate analogue (17.8% in the paper);
  * region 8: disk-I/O heavy (106 GB) -> disparity bottleneck;
  * severity banding (Fig. 12): very-high {14, 11}, high {8},
    medium {5, 6}, low {2}, very-low rest;
  * rough-set outcomes: dissimilarity core {a5}=instructions retired
    (Table 3); disparity core {a2,a3}=L2-miss + disk I/O (Table 4).

``optimize_*`` flags model the paper's fixes (§6.1.1): dynamic load
dispatch (balances 11), buffered I/O (shrinks region 8), loop blocking
(halves region 11's CRNM, removing the L2 cause) — the Fig. 14
before/after benchmark replays them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core import (FLOPS, HBM_INTENSITY, HOST_BYTES, RegionBehavior,
                        RegionMetrics, RegionTree, SyntheticWorkload,
                        st_region_tree)

N_PROCESSES = 8

# per-process imbalance of region 11 (paper Fig. 11 shape): five groups
IMBALANCE_11 = np.array([0.1, 0.4, 0.405, 0.7, 1.0, 1.3, 1.005, 1.305])


def st_scenario(optimize_dissimilarity: bool = False,
                optimize_disparity: bool = False,
                seed: int = 0) -> Tuple[RegionTree, RegionMetrics]:
    tree = st_region_tree()
    bal = np.ones(N_PROCESSES)
    # dynamic dispatch redistributes the SAME total work evenly: the
    # balanced per-process share is the mean of the imbalanced profile
    imb11 = (np.full(N_PROCESSES, IMBALANCE_11.mean())
             if optimize_dissimilarity else IMBALANCE_11)

    t11 = 60.0 if not optimize_disparity else 35.0
    hbm11 = 0.178 if not optimize_disparity else 0.04
    io8 = 106e9 if not optimize_disparity else 8e9
    t8 = 28.0 if not optimize_disparity else 3.0

    b: Dict[int, RegionBehavior] = {}
    lo, hi = 0.02, 0.09  # vmem-pressure (L1-analogue) levels
    # defaults: tiny balanced regions
    for rid in (1, 3, 4, 7, 9, 10, 13):
        b[rid] = RegionBehavior(base_time=0.5, imbalance=bal,
                                flops_per_s=2e9, vmem_pressure=lo,
                                hbm_intensity=0.02)
    # paper Table 4 high-a1 rows: 2, 9, 10 (and 5, 6, 11, 14 below)
    for rid in (9, 10):
        b[rid].vmem_pressure = hi
    b[2] = RegionBehavior(base_time=1.2, imbalance=bal, flops_per_s=2e9,
                          vmem_pressure=hi, hbm_intensity=0.02)
    # regions 5, 6: flops-heavy (a5=1 in Table 4) but efficient (low CRNM)
    b[5] = RegionBehavior(base_time=7.0, imbalance=bal, flops_per_s=22e9,
                          vmem_pressure=hi, hbm_intensity=0.178)
    b[6] = RegionBehavior(base_time=7.0, imbalance=bal, flops_per_s=22e9,
                          vmem_pressure=hi, hbm_intensity=0.02)
    # region 8: disk-I/O bound disparity bottleneck
    b[8] = RegionBehavior(base_time=t8, imbalance=bal, flops_per_s=6e9,
                          vmem_pressure=lo, hbm_intensity=0.02,
                          host_bytes=io8)
    # region 11: the dissimilarity CCCR; L2-heavy disparity CCCR
    b[11] = RegionBehavior(base_time=t11, imbalance=imb11, flops_per_s=6e9,
                           vmem_pressure=hi, hbm_intensity=hbm11)
    # region 12: balanced sibling inside 14
    b[12] = RegionBehavior(base_time=0.6, imbalance=bal, flops_per_s=2e9,
                           vmem_pressure=lo, hbm_intensity=0.02)
    # region 14 = 11 + 12 + overhead (nested inclusive timing)
    b[14] = RegionBehavior(base_time=t11 + 0.6 + 0.5,
                           imbalance=imb11 * 0.97 + 0.03,
                           flops_per_s=6e9, vmem_pressure=hi,
                           hbm_intensity=hbm11)
    wl = SyntheticWorkload(tree, b, N_PROCESSES, seed=seed)
    return tree, wl.collect()


def st_fine_scenario(seed: int = 0) -> Tuple[RegionTree, RegionMetrics]:
    """The paper's §6.1.2 second-round (fine-grain) instrumentation
    (Fig. 15): the coarse CCRs are split into inner loops.  Region 19 is
    nested in region 8 and carries its disk I/O; region 21 is nested in
    region 11 and carries its imbalance + L2 pressure.  Expected results
    (paper): dissimilarity CCCR = region 21; disparity bottlenecks =
    regions 19 and 21."""
    from repro_torch.core import st_region_tree
    tree = st_region_tree()
    n8 = tree[8]
    n11 = tree[11]
    # fine regions: 15-18 trivial inner loops, 19 in 8, 20 trivial in 8,
    # 21 in 11 (paper keeps coarse ids stable and adds new ones)
    for rid, parent in ((15, tree[2]), (16, tree[5]), (17, tree[6]),
                        (18, tree[13])):
        node = tree.add(f"cr{rid}", parent=parent)
        node.region_id = rid
        tree._by_id[rid] = node
    for rid, parent in ((19, n8), (20, n8), (21, n11)):
        node = tree.add(f"cr{rid}", parent=parent)
        node.region_id = rid
        tree._by_id[rid] = node

    bal = np.ones(N_PROCESSES)
    b: Dict[int, RegionBehavior] = {}
    lo, hi = 0.02, 0.09
    for rid in (1, 3, 4, 7, 9, 10, 13):
        b[rid] = RegionBehavior(base_time=0.5, imbalance=bal,
                                flops_per_s=2e9, vmem_pressure=lo,
                                hbm_intensity=0.02)
    b[2] = RegionBehavior(base_time=1.2, imbalance=bal, flops_per_s=2e9,
                          vmem_pressure=hi, hbm_intensity=0.02)
    b[5] = RegionBehavior(base_time=7.0, imbalance=bal, flops_per_s=22e9,
                          vmem_pressure=hi, hbm_intensity=0.178)
    b[6] = RegionBehavior(base_time=7.0, imbalance=bal, flops_per_s=22e9,
                          vmem_pressure=hi, hbm_intensity=0.02)
    # fine trivial loops
    for rid in (15, 16, 17, 18, 20):
        b[rid] = RegionBehavior(base_time=0.3, imbalance=bal,
                                flops_per_s=2e9, vmem_pressure=lo,
                                hbm_intensity=0.02)
    # region 19 carries region 8's disk I/O (nested: 8 = 19 + 20 + eps)
    b[19] = RegionBehavior(base_time=26.0, imbalance=bal, flops_per_s=6e9,
                           vmem_pressure=lo, hbm_intensity=0.02,
                           host_bytes=100e9)
    b[8] = RegionBehavior(base_time=26.0 + 0.3 + 0.2, imbalance=bal,
                          flops_per_s=6e9, vmem_pressure=lo,
                          hbm_intensity=0.02, host_bytes=106e9)
    # region 21 carries region 11's imbalance (11 = 21 + eps; 14 = 11 + 12)
    b[21] = RegionBehavior(base_time=57.0, imbalance=IMBALANCE_11,
                           flops_per_s=6e9, vmem_pressure=hi,
                           hbm_intensity=0.178)
    b[11] = RegionBehavior(base_time=58.0, imbalance=IMBALANCE_11,
                           flops_per_s=6e9, vmem_pressure=hi,
                           hbm_intensity=0.178)
    b[12] = RegionBehavior(base_time=0.6, imbalance=bal, flops_per_s=2e9,
                           vmem_pressure=lo, hbm_intensity=0.02)
    b[14] = RegionBehavior(base_time=58.0 + 0.6 + 0.5,
                           imbalance=IMBALANCE_11 * 0.97 + 0.03,
                           flops_per_s=6e9, vmem_pressure=hi,
                           hbm_intensity=0.178)
    wl = SyntheticWorkload(tree, b, N_PROCESSES, seed=seed)
    return tree, wl.collect()


def st_total_time(rm: RegionMetrics) -> float:
    """Wall time of the whole program ≈ max over processes of Σ depth-1
    regions (nested regions are inclusive)."""
    from repro_torch.core import WALL_TIME
    d1 = [r for r in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 13, 14)]
    T = rm.vectors(WALL_TIME, d1)
    return float(T.sum(axis=1).max())
