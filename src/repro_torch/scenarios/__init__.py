"""Scenarios of the port: the paper's three applications (synthetic
reproductions), the fault archetypes, the infrastructure chaos archetypes,
the serving traffic and the fault corpus."""
from . import faults, traffic
from .chaos import (ChaosOutcome, ChaosTruth, CheckpointChaosCollector,
                    CorruptLatestCheckpoint, FleetAnalysisLagFlood,
                    FleetChaosCollector, FleetConcurrentKill,
                    FleetTenantCorruption, FlipBytesInSegment,
                    KillProducerMidChunk, SpoolChaosCollector,
                    StallProducer, TruncateSegment)
from .corpus import (CORPUS, CorpusEntry, CorpusRunResult,
                     FaultedSyntheticCollector, GroundTruth,
                     MitigatedTrainCollector, RecoveryTruth,
                     RuntimeFaultCollector, ServingFaultCollector,
                     ServingTruth, TrainFaultCollector, baseline_mpibzip2,
                     baseline_npar1way, baseline_st, corpus_entries,
                     evaluate_corpus, model_region_tree, run_entry,
                     run_entry_robust, score_verdict, select_entries)
from .mpibzip2 import mpibzip2_scenario
from .npar1way import npar1way_scenario
from .st import (IMBALANCE_11, st_fine_scenario, st_scenario,
                 st_total_time)
from .traffic import (Request, TrafficConfig, generate_traffic,
                      prompt_tokens, saturated_sessions)

__all__ = ["CORPUS", "ChaosOutcome", "ChaosTruth", "CorpusEntry",
           "CorpusRunResult", "CheckpointChaosCollector",
           "CorruptLatestCheckpoint", "FaultedSyntheticCollector",
           "FleetAnalysisLagFlood", "FleetChaosCollector",
           "FleetConcurrentKill", "FleetTenantCorruption",
           "FlipBytesInSegment", "GroundTruth", "IMBALANCE_11",
           "KillProducerMidChunk", "MitigatedTrainCollector",
           "RecoveryTruth", "Request", "RuntimeFaultCollector",
           "ServingFaultCollector", "ServingTruth", "SpoolChaosCollector",
           "StallProducer", "TrafficConfig", "TrainFaultCollector",
           "TruncateSegment",
           "baseline_mpibzip2", "baseline_npar1way", "baseline_st",
           "corpus_entries", "evaluate_corpus", "faults",
           "generate_traffic", "model_region_tree", "mpibzip2_scenario",
           "npar1way_scenario", "prompt_tokens", "run_entry",
           "run_entry_robust", "saturated_sessions", "score_verdict",
           "select_entries", "st_fine_scenario", "st_scenario",
           "st_total_time", "traffic"]
