"""AutoAnalyzer orchestration (paper §4, Fig. 4-6).

Pipeline per analysis:
  1. similarity pass (simplified OPTICS over per-process vectors)
  2. dissimilarity bottleneck search (Algorithm 2) + rough-set root causes
     (decision table of Fig. 4: per-process per-metric cluster ids)
  3. disparity pass (CRNM -> k-means severity -> CCR/CCCR) + rough-set root
     causes (decision table of Fig. 5: binarised per-region severities)

The PyTorch port of ``repro/core/analyzer.py``.  Its clustering runs on
the CUDA seed-row kernel (``distance_backend="kernel"``) on the card by
default; ``device="cpu"`` runs the same lane through the kernel's plain
version, and ``distance_backend="numpy"`` is the exact float64 host lane,
the authority for verdicts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .clustering import (HIGH, MEDIUM, SEVERITY_SPAN_DECADES,
                         ClusterResult, get_distance_backend,
                         kmeans_severity, optics_cluster)
from .metrics import (COMM_BYTES, CPU_TIME, DECISION_ATTRIBUTES, FLOPS,
                      HBM_INTENSITY, HOST_BYTES, VMEM_PRESSURE, WALL_TIME,
                      RegionMetrics)
from .regions import RegionTree
from .roughset import DecisionTable
from .search import (DisparityReport, DissimilarityReport,
                     find_disparity_bottlenecks,
                     find_dissimilarity_bottlenecks)

# Human-readable root-cause names for the five attributes (paper a1..a5).
# The wording is the reference package's, kept so reports render alike.
ATTRIBUTE_MEANING = {
    VMEM_PRESSURE: "high VMEM pressure (L1-miss-rate analogue)",
    HBM_INTENSITY: "high HBM traffic per flop (L2-miss-rate analogue)",
    HOST_BYTES: "high host/disk I/O quantity",
    COMM_BYTES: "high collective/network I/O quantity",
    FLOPS: "high quantity of instructions retired (FLOPs)",
}


@dataclasses.dataclass(frozen=True)
class Verdict:
    """Machine-checkable summary of one analysis.

    All members are region *paths* (``tree.by_path`` form) and raw metric
    names, so a verdict can be compared directly against a fault-corpus
    entry's ground truth (scenarios/corpus.py) — and two verdicts compare
    equal iff the analyses located the same bottlenecks for the same
    reasons (used by the determinism tests).
    """

    dissimilar: bool
    dissimilarity_paths: Tuple[str, ...]        # CCCRs (innermost culprits)
    dissimilarity_ccr_paths: Tuple[str, ...]
    disparity_paths: Tuple[str, ...]            # CCCRs
    disparity_ccr_paths: Tuple[str, ...]
    cause_attributes: FrozenSet[str]            # raw metric names (a1..a5)
    # dissimilarity root causes are global (the Fig. 4 table is per-process,
    # not per-region); disparity causes are per bottleneck region:
    dissimilarity_cause_attributes: FrozenSet[str]
    per_path_causes: Tuple[Tuple[str, Tuple[str, ...]], ...]

    def doc(self) -> dict:
        """Canonical JSON-ready form (sorted, sets -> lists) — the single
        serialization every verdict-emitting surface shares
        (``analyze_trace.py``, ``snapshot_verdicts.py``,
        ``watch_train.py``), so committed snapshots never drift on
        formatting).  Equal across the JAX and PyTorch packages for the
        same analysis."""
        return {
            "dissimilar": self.dissimilar,
            "dissimilarity_paths": sorted(self.dissimilarity_paths),
            "dissimilarity_ccr_paths": sorted(self.dissimilarity_ccr_paths),
            "disparity_paths": sorted(self.disparity_paths),
            "disparity_ccr_paths": sorted(self.disparity_ccr_paths),
            "cause_attributes": sorted(self.cause_attributes),
            "dissimilarity_cause_attributes":
                sorted(self.dissimilarity_cause_attributes),
            "per_path_causes": [[p, list(a)]
                                for p, a in self.per_path_causes],
        }

    def fingerprint(self) -> str:
        """Stable cross-run dedup key — a digest of :meth:`doc`, so
        fingerprint equality is exactly canonical-doc equality (see
        :func:`repro_torch.core.report.verdict_fingerprint`, where the format
        is defined).  The reference's fleet verdict index and chaos corpus
        gates dedupe by this key."""
        from .report import verdict_fingerprint
        return verdict_fingerprint(self)


@dataclasses.dataclass
class AnalysisResult:
    dissimilarity: DissimilarityReport
    disparity: DisparityReport
    dissimilarity_table: Optional[DecisionTable]
    disparity_table: Optional[DecisionTable]
    dissimilarity_causes: List[FrozenSet[str]]
    disparity_causes: List[FrozenSet[str]]
    metric_used: str = CPU_TIME
    # raw attribute names per disparity CCR
    per_region_attributes: Dict[int, List[str]] = \
        dataclasses.field(default_factory=dict)
    verdict: Optional[Verdict] = None

    @property
    def per_region_causes(self) -> Dict[int, List[str]]:
        """Human-readable meanings of :attr:`per_region_attributes`."""
        return {rid: [ATTRIBUTE_MEANING.get(a, a) for a in attrs]
                for rid, attrs in self.per_region_attributes.items()}

    def has_bottlenecks(self) -> bool:
        return self.dissimilarity.exists or bool(self.disparity.ccrs)


class AutoAnalyzer:
    """The analysis engine.  Stateless w.r.t. collection: callers hand it a
    :class:`RegionMetrics` (runtime, static or synthetic backend)."""

    def __init__(self, tree: RegionTree,
                 similarity_metric: str = CPU_TIME,
                 disparity_metric: str = "crnm",
                 attributes: Sequence[str] = tuple(DECISION_ATTRIBUTES),
                 peak_flops_per_s: Optional[float] = None,
                 threshold_frac: float = 0.10,
                 distance_backend: str = "kernel",
                 device: Union[None, str, torch.device] = None):
        self.tree = tree
        self.similarity_metric = similarity_metric
        self.disparity_metric = disparity_metric
        self.attributes = list(attributes)
        self.peak = peak_flops_per_s
        # OPTICS neighbourhood radius as a fraction of the seed vector's
        # norm; the paper's 10% suits low-noise collection, runtime
        # (wall-clock) collection wants a wider band.
        self.threshold_frac = threshold_frac
        # Distance backend for the clustering passes: "kernel" (the CUDA
        # seed-row kernel on ``device``; None means the card, and raises
        # without one), "torch" (one ``addmm`` on ``device``, likewise) or
        # "numpy" (the exact float64 host lane, which ignores ``device``)
        # — see clustering.get_distance_backend.
        self.distance_backend = distance_backend
        self._backend = get_distance_backend(distance_backend, device)
        self.device = getattr(self._backend, "device", None)

    @property
    def decisions(self) -> Optional[Dict[str, float]]:
        """A float32 lane's running counts of candidacies its float32
        bound could not settle and of re-decisions on the exact lane
        (``flagged``, ``redecided``, ``redecide_s``, ``kmeans_redecided``;
        see clustering._Certifier), over every analysis of this analyzer;
        None on the exact lane."""
        return getattr(self._backend, "decisions", None)

    def _cluster(self, vectors) -> ClusterResult:
        return optics_cluster(vectors, threshold_frac=self.threshold_frac,
                              backend=self._backend)

    # -- passes -----------------------------------------------------------
    def analyze(self, rm: RegionMetrics) -> AnalysisResult:
        rids = [r for r in rm.region_ids
                if not self._is_management(r)]
        dis = self._dissimilarity_pass(rm, rids)
        disp = self._disparity_pass(rm, rids)
        dis_table = dis_causes = None
        if dis.exists:
            dis_table = self._dissimilarity_table(rm, rids)
            dis_causes = dis_table.reducts()
        disp_table = self._disparity_table(rm, rids, disp)
        # Root causes: per-bottleneck discernibility functions (the paper
        # 'searches the decision table' per region) — the union of each
        # bottleneck's minimal hitting attributes with a positive value.
        per_region_attrs: Dict[int, List[str]] = {}
        union: set = set()
        for rid in disp.ccrs:
            idx = disp_table.object_ids.index(rid)
            reds = disp_table.object_reducts(idx)
            row = disp_table.rows[idx]
            pos = {a for red in reds for a in red
                   if row[disp_table.attributes.index(a)]}
            union |= pos
            per_region_attrs[rid] = sorted(pos)
        disp_causes = [frozenset(union)] if union else []
        result = AnalysisResult(
            dissimilarity=dis,
            disparity=disp,
            dissimilarity_table=dis_table,
            disparity_table=disp_table,
            dissimilarity_causes=dis_causes or [],
            disparity_causes=disp_causes,
            metric_used=self.similarity_metric,
            per_region_attributes=per_region_attrs,
        )
        result.verdict = self._verdict(result)
        return result

    def analyze_collector(self, collector) -> AnalysisResult:
        """Run the pipeline against an injected collector — anything with a
        ``collect() -> RegionMetrics`` method (synthetic fault backends,
        TimedRegionRunner wrappers, replayed traces)."""
        return self.analyze(collector.collect())

    def analyze_trace(self, trace,
                      window: Optional[Tuple[int, Optional[int]]] = None
                      ) -> AnalysisResult:
        """Run the pipeline on a :class:`repro_torch.core.trace.RegionTrace`
        (in-memory or loaded from a saved artifact), optionally restricted
        to a step window of a long run.  The trace's own deterministic
        reduction feeds :meth:`analyze`, so offline analysis of a saved
        artifact equals the in-process result bit-for-bit."""
        return self.analyze(trace.reduce(window))

    def _paths(self, rids: Sequence[int]) -> Tuple[str, ...]:
        out = []
        for rid in rids:
            try:
                out.append(self.tree[rid].path)
            except KeyError:
                out.append(str(rid))
        return tuple(sorted(out))

    def _verdict(self, res: AnalysisResult) -> Verdict:
        dis_attrs = {a for red in res.dissimilarity_causes for a in red}
        disp_attrs = {a for attrs in res.per_region_attributes.values()
                      for a in attrs}
        per_path = tuple(sorted(
            (self._paths([rid])[0], tuple(attrs))
            for rid, attrs in res.per_region_attributes.items()))
        return Verdict(
            dissimilar=res.dissimilarity.exists,
            dissimilarity_paths=self._paths(res.dissimilarity.cccrs),
            dissimilarity_ccr_paths=self._paths(res.dissimilarity.ccrs),
            disparity_paths=self._paths(res.disparity.cccrs),
            disparity_ccr_paths=self._paths(res.disparity.ccrs),
            cause_attributes=frozenset(dis_attrs | disp_attrs),
            dissimilarity_cause_attributes=frozenset(dis_attrs),
            per_path_causes=per_path,
        )

    def _is_management(self, rid: int) -> bool:
        try:
            return self.tree[rid].management
        except KeyError:
            return False

    def _dissimilarity_pass(self, rm: RegionMetrics,
                            rids: List[int]) -> DissimilarityReport:
        T = rm.vectors(self.similarity_metric, rids)
        # Passing the OPTICS parameters (rather than a cluster_fn closure)
        # selects the incremental-D² fast path of Algorithm 2.
        return find_dissimilarity_bottlenecks(
            self.tree, T, rids, threshold_frac=self.threshold_frac,
            backend=self._backend)

    def _disparity_values(self, rm: RegionMetrics,
                          rids: List[int]) -> np.ndarray:
        if self.disparity_metric == "crnm":
            return rm.crnm_all(rids, self.peak)
        if self.disparity_metric == "cpi":
            return rm.cpi_all(rids, self.peak)
        if self.disparity_metric == WALL_TIME:
            return rm.wall_all(rids)
        return np.array([rm.region_mean(self.disparity_metric, r)
                         for r in rids])

    def _disparity_pass(self, rm: RegionMetrics,
                        rids: List[int]) -> DisparityReport:
        vals = self._disparity_values(rm, rids)
        return find_disparity_bottlenecks(self.tree, vals, rids,
                                          wall=rm.wall_all(rids),
                                          backend=self._backend)

    # -- decision tables ---------------------------------------------------
    def _dissimilarity_table(self, rm: RegionMetrics,
                             rids: List[int]) -> DecisionTable:
        """Fig. 4: per-process rows; attribute value = cluster id of the
        process under that metric's per-region vectors; decision = cluster
        id under the main (CPU time) metric."""
        decision = self._cluster(rm.vectors(self.similarity_metric, rids))
        rows = []
        per_attr_labels = []
        for a in self.attributes:
            labels = self._cluster(rm.vectors(a, rids)).labels
            per_attr_labels.append(labels)
        m = rm.n_processes
        for i in range(m):
            rows.append(tuple(int(per_attr_labels[k][i])
                              for k in range(len(self.attributes))))
        return DecisionTable(
            attributes=list(self.attributes),
            rows=rows,
            decisions=[int(x) for x in decision.labels],
            object_ids=list(range(m)),
        )

    def _disparity_table(self, rm: RegionMetrics, rids: List[int],
                         disp: DisparityReport) -> DecisionTable:
        """Fig. 5: per-region rows; attribute = 1 iff the k-means severity
        of the region's average metric value is higher than medium;
        decision = 1 iff the region is a disparity bottleneck.  Attribute
        banding gets the severity-range floor: a near-flat metric column
        (all regions within ~2x) lights nobody's bit, where the unfloored
        relative banding always crowned the column maximum.  Columns
        genuinely stretched past the floor band exactly as before, so the
        paper's Table 4 / §6 cause tables are unchanged.  No
        exclusive-share discount here: rows are cause *candidates*,
        location-gated by the per-CCR reduct search, and an enclosing
        region's causes legitimately include its children's (paper
        Table 4 lists region 14's L2 pressure, which lives in 11)."""
        rows_by_attr = []
        for a in self.attributes:
            avg = np.array([rm.region_mean(a, r) for r in rids])
            sev = kmeans_severity(avg,
                                  floor_decades=SEVERITY_SPAN_DECADES,
                                  backend=self._backend)
            rows_by_attr.append([1 if s > MEDIUM else 0 for s in sev])
        rows = [tuple(rows_by_attr[k][j] for k in range(len(self.attributes)))
                for j in range(len(rids))]
        decisions = [1 if r in set(disp.ccrs) else 0 for r in rids]
        return DecisionTable(
            attributes=list(self.attributes),
            rows=rows,
            decisions=decisions,
            object_ids=list(rids),
        )
