"""Performance metrics and vectors (paper §4.1, §4.2.2).

The collector produces, per (process/shard i, code region j), a set of raw
measurements drawn from four hierarchies (paper §4.1).  The metric names
are those of the reference package ``repro`` (which adapted them to a TPU),
kept unchanged so RegionTrace artifacts and verdicts stay byte-compatible
between the two packages; on a GPU, ``vmem_pressure`` reads as shared-memory
/ L1 pressure and ``hbm_intensity`` as L2 / HBM traffic per flop:

  application    : wall_time, cpu_time           (seconds)
  hardware       : flops (≈ instructions retired),
                   bytes (HBM traffic; cache-miss analogue),
                   vmem_pressure (working-set / VMEM; L1-rate analogue),
                   hbm_intensity (bytes/flop; L2-rate analogue)
  communication  : comm_time, comm_bytes         (collectives)
  OS / host      : host_bytes                    (host<->device, ckpt I/O)

and the derived single normalized metric CRNM (Eq. 2):

    CRNM = CRWT / WPWT * CPI

where on an accelerator the CPI analogue is *cycles per useful flop*.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

# Canonical metric names.
WALL_TIME = "wall_time"
CPU_TIME = "cpu_time"
FLOPS = "flops"                 # instructions-retired analogue
BYTES = "bytes"                 # HBM traffic
VMEM_PRESSURE = "vmem_pressure"  # L1 miss-rate analogue
HBM_INTENSITY = "hbm_intensity"  # L2 miss-rate analogue
COMM_TIME = "comm_time"
COMM_BYTES = "comm_bytes"       # network I/O quantity
HOST_BYTES = "host_bytes"       # disk I/O quantity

RAW_METRICS = [WALL_TIME, CPU_TIME, FLOPS, BYTES, VMEM_PRESSURE,
               HBM_INTENSITY, COMM_TIME, COMM_BYTES, HOST_BYTES]

# The five conditional attributes of the paper's decision tables
# (a1..a5 = L1 rate, L2 rate, disk I/O, network I/O, instructions retired).
DECISION_ATTRIBUTES = [VMEM_PRESSURE, HBM_INTENSITY, HOST_BYTES,
                       COMM_BYTES, FLOPS]


@dataclasses.dataclass
class RegionMetrics:
    """Per-(process, region) measurement store.

    ``data[metric]`` is an (m, n) array: m processes/shards, n regions in
    ``region_ids`` order.  Missing metrics default to zeros (a region not on
    a process' call path contributes zero — paper §4.2.2).
    """

    region_ids: List[int]
    n_processes: int
    data: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        n = len(self.region_ids)
        for k, v in list(self.data.items()):
            v = np.asarray(v, dtype=np.float64)
            if v.shape != (self.n_processes, n):
                raise ValueError(f"{k}: shape {v.shape} != ({self.n_processes},{n})")
            self.data[k] = v
        self._col = {rid: j for j, rid in enumerate(self.region_ids)}

    def metric(self, name: str) -> np.ndarray:
        n = len(self.region_ids)
        if name not in self.data:
            self.data[name] = np.zeros((self.n_processes, n))
        return self.data[name]

    def set(self, name: str, proc: int, region_id: int, value: float) -> None:
        self.metric(name)[proc, self._col[region_id]] += value

    def col(self, region_id: int) -> int:
        return self._col[region_id]

    def vectors(self, name: str = CPU_TIME,
                region_ids: Optional[Sequence[int]] = None) -> np.ndarray:
        """Per-process performance vectors V_i = (T_i1 .. T_in) (paper
        §4.2.1) for a chosen measurement, restricted to ``region_ids``."""
        m = self.metric(name)
        if region_ids is None:
            return m.copy()
        cols = [self._col[r] for r in region_ids]
        return m[:, cols].copy()

    def region_mean(self, name: str, region_id: int) -> float:
        return float(self.metric(name)[:, self._col[region_id]].mean())

    # -- CRNM (paper Eq. 2) ----------------------------------------------
    def crnm(self, region_id: int, peak_flops_per_s: Optional[float] = None,
             whole_program_id: int = 0) -> float:
        """CRNM = CRWT/WPWT * CPI, averaged over processes.

        CPI on an accelerator: cycles per useful flop = wall_time * peak_flops / flops
        when ``peak_flops_per_s`` is given; otherwise the classical
        cycles/instructions ratio is approximated by cpu_time/flops scaled
        to be O(1) (pure-ratio, scale-free in comparisons)."""
        wall = self.metric(WALL_TIME)
        j = self._col[region_id]
        wp = self._col.get(whole_program_id)
        crwt = wall[:, j]
        if wp is not None:
            wpwt = wall[:, wp]
        else:
            wpwt = wall.sum(axis=1)
        wpwt = np.where(wpwt <= 0, 1e-30, wpwt)
        flops = self.metric(FLOPS)[:, j]
        if peak_flops_per_s is not None:
            cpi = np.where(flops > 0, crwt * peak_flops_per_s / np.maximum(flops, 1.0), 0.0)
        else:
            cpu = self.metric(CPU_TIME)[:, j]
            cpi = np.where(flops > 0, cpu / np.maximum(flops, 1.0), 0.0)
            # scale-free normalisation across regions happens in the caller
        vals = crwt / wpwt * cpi
        return float(vals.mean())

    def crnm_all(self, region_ids: Sequence[int],
                 peak_flops_per_s: Optional[float] = None,
                 whole_program_id: int = 0) -> np.ndarray:
        vals = np.array([self.crnm(r, peak_flops_per_s, whole_program_id)
                         for r in region_ids])
        if peak_flops_per_s is None and vals.max() > 0:
            vals = vals / vals.max()  # scale-free CPI variant
        return vals

    def cpi_all(self, region_ids: Sequence[int],
                peak_flops_per_s: Optional[float] = None) -> np.ndarray:
        """Plain CPI per region (for the §6.4 metric comparison)."""
        out = []
        for r in region_ids:
            j = self._col[r]
            flops = self.metric(FLOPS)[:, j]
            t = self.metric(WALL_TIME)[:, j]
            scale = peak_flops_per_s if peak_flops_per_s else 1.0
            cpi = np.where(flops > 0, t * scale / np.maximum(flops, 1.0), 0.0)
            out.append(float(cpi.mean()))
        return np.array(out)

    def wall_all(self, region_ids: Sequence[int]) -> np.ndarray:
        return np.array([self.region_mean(WALL_TIME, r) for r in region_ids])

    def derived(self) -> None:
        """Fill derived metrics where raw inputs exist (L1/L2-rate
        analogues): hbm_intensity = bytes/flops."""
        if BYTES in self.data and FLOPS in self.data:
            f = np.maximum(self.metric(FLOPS), 1.0)
            self.data[HBM_INTENSITY] = self.metric(BYTES) / f
