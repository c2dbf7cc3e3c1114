"""AutoAnalyzer core, ported to PyTorch (the reference is ``repro.core``).

Public API:
  RegionTree / CodeRegion        — code-region tree (paper §2)
  RegionMetrics / RegionTrace    — per-(shard, region) measurements and the
                                   artifact they are saved in
  optics_cluster / kmeans_severity — the two clustering algorithms (§4.2)
  find_dissimilarity_bottlenecks / find_disparity_bottlenecks — §4.3
  DecisionTable                  — rough-set root causes (§4.4)
  AutoAnalyzer                   — end-to-end orchestration
  collectors                     — runtime / static / synthetic backends
"""
from .analyzer import (ATTRIBUTE_MEANING, AnalysisResult, AutoAnalyzer,
                       Verdict)
from .clustering import (DISTANCE_BACKENDS, HIGH, LOW, MEDIUM,
                         SEVERITY_NAMES, VERY_HIGH, VERY_LOW, ClusterResult,
                         IncrementalClusterState, dissimilarity_severity,
                         get_distance_backend, is_similar, kmeans_1d,
                         kmeans_severity, optics_cluster, resolve_device)
from .collector import (RegionBehavior, SyntheticWorkload, TimedRegionRunner,
                        static_metrics_from_costs, static_trace_from_costs)
from .hlo import (H100_SXM, HardwareSpec, RooflineTerms, cost_of,
                  roofline_terms)
from .metrics import (BYTES, COMM_BYTES, COMM_TIME, CPU_TIME,
                      DECISION_ATTRIBUTES, FLOPS, HBM_INTENSITY, HOST_BYTES,
                      RAW_METRICS, VMEM_PRESSURE, WALL_TIME, RegionMetrics)
from .regions import CodeRegion, RegionTree, st_region_tree
from .report import render, verdict_fingerprint
from .roughset import (DecisionTable, format_matrix, paper_table2,
                       paper_table3, paper_table4)
from .search import (DisparityReport, DissimilarityReport,
                     find_disparity_bottlenecks,
                     find_dissimilarity_bottlenecks, severity_banding)
from .trace import (RATE_METRICS, TRACE_FORMAT_VERSION, RegionTrace,
                    TraceFormatError, schema_from_tree, tree_from_schema)

__all__ = [name for name in dir() if not name.startswith("_")]
