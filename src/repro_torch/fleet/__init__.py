"""Fleet-scale ingest: fault-isolated multi-run analysis.

``ingest`` — :class:`FleetIngest` (cooperative multi-tenant poll loop
             with a bounded shared worker pool), :class:`RunSupervisor`
             (per-run containment: retry backoff, integrity circuit
             breaker, stall recovery, bounded window queue with
             drop-oldest shedding) and the structured event types.
``index``  — :class:`VerdictIndex` (crash-safe append-only journal +
             atomic snapshot deduplicating verdict fingerprints into
             "seen in N runs" reports).

The PyTorch port of the reference's ``repro.fleet``; the index's journal
and snapshot are shared byte for byte.
"""
from .index import (INDEX_FORMAT_VERSION, JOURNAL_NAME, SNAPSHOT_NAME,
                    VerdictIndex)
from .ingest import (DONE, LIVE, QUARANTINED, WAITING, FleetConfig,
                     FleetIngest, IntegrityEvent, QuarantineEvent,
                     RecoveryEvent, RetryEvent, RunSupervisor, ShedEvent,
                     StallEvent)

__all__ = ["DONE", "FleetConfig", "FleetIngest", "INDEX_FORMAT_VERSION",
           "IntegrityEvent", "JOURNAL_NAME", "LIVE", "QUARANTINED",
           "QuarantineEvent", "RecoveryEvent", "RetryEvent",
           "RunSupervisor", "SNAPSHOT_NAME", "ShedEvent", "StallEvent",
           "VerdictIndex", "WAITING"]
