"""Streaming trace collection + online windowed analysis.

``spool``  — :class:`TraceSpool` (bounded-memory segment writer with
             per-segment integrity records, crash recovery and
             retention/compaction) and :class:`SpooledTrace` (lazy reader
             / window reassembly / byte-identical finalize), plus
             :class:`StallDetector` (producer heartbeat → bounded-backoff
             "presumed dead" detection).
``online`` — :class:`OnlineAnalyzer` (per-window AutoAnalyzer verdicts as
             the spool grows, degrading gracefully on bad windows via
             :class:`DegradedWindow`) and :class:`WindowVerdictLog`
             (onset detection: the first window where a bottleneck
             verdict persists).

The PyTorch port of the reference's ``repro.stream``; the spool format is
shared byte for byte.
"""
from .online import (DISPARITY, DISSIMILARITY, DegradedWindow,
                     OnlineAnalyzer, WindowVerdict, WindowVerdictLog,
                     check_lane, lane_kw)
from .spool import (MANIFEST_NAME, QUARANTINE_DIR, SPOOL_FORMAT_VERSION,
                    ProducerStalledError, SpooledTrace, SpoolGapError,
                    StallDetector, TraceSpool, verify_segment)

__all__ = ["DISPARITY", "DISSIMILARITY", "DegradedWindow", "MANIFEST_NAME",
           "OnlineAnalyzer", "ProducerStalledError", "QUARANTINE_DIR",
           "SPOOL_FORMAT_VERSION", "SpoolGapError", "SpooledTrace",
           "StallDetector", "TraceSpool", "WindowVerdict",
           "WindowVerdictLog", "check_lane", "lane_kw", "verify_segment"]
