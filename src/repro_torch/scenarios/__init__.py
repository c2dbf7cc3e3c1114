"""Scenarios of the port: the paper's three applications (synthetic
reproductions), the fault archetypes, and the synthetic fault corpus."""
from . import faults
from .corpus import (CORPUS, CorpusEntry, CorpusRunResult,
                     FaultedSyntheticCollector, GroundTruth,
                     baseline_mpibzip2, baseline_npar1way, baseline_st,
                     corpus_entries, evaluate_corpus, model_region_tree,
                     onset_window, run_entry, score_verdict, select_entries)
from .mpibzip2 import mpibzip2_scenario
from .npar1way import npar1way_scenario
from .st import (IMBALANCE_11, st_fine_scenario, st_scenario,
                 st_total_time)

__all__ = ["CORPUS", "CorpusEntry", "CorpusRunResult",
           "FaultedSyntheticCollector", "GroundTruth", "IMBALANCE_11",
           "baseline_mpibzip2", "baseline_npar1way", "baseline_st",
           "corpus_entries", "evaluate_corpus", "faults",
           "model_region_tree", "mpibzip2_scenario", "npar1way_scenario",
           "onset_window", "run_entry", "score_verdict", "select_entries",
           "st_fine_scenario", "st_scenario", "st_total_time"]
