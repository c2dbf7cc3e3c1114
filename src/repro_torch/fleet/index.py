"""VerdictIndex: a crash-safe cross-run index of bottleneck signatures.

The port's copy of the reference's ``repro/fleet/index.py``: the journal
lines and the snapshot are the same bytes, so an index written by either
package opens in the other with equal counts.

The similarity-analysis companion work (arXiv:0906.1326) frames recurring
dissimilarity signatures as the reusable unit of diagnosis: the same
bottleneck showing up across many runs of a fleet is one fault, not N.
This module gives that idea a durable home.  Every flagged window verdict
any run produces is fingerprinted (:meth:`repro_torch.core.Verdict.fingerprint`
— kind, located region paths, cause attributes, digested from the
canonical ``doc()`` form) and recorded; the index deduplicates recurring
signatures into "seen in N runs" reports, so a fleet operator reads *one*
line per distinct fault, with the run count as its blast radius.

Durability model (the same two-tier shape as the trace spool, and gated
by the same kill-schedule sweep through :mod:`repro_torch.core.faultpoints`):

* an **append-only journal** (``journal.jsonl``): one JSON record per
  line, written + flushed before the in-memory state advances.  The
  journal is the source of truth — every aggregate is a pure function of
  its intact lines, so replay after *any* crash rebuilds exact counts.
* an **atomic snapshot** (``snapshot.json``): the aggregated state,
  rewritten tmp+rename every ``snapshot_every`` records so recovery does
  not have to replay an unbounded journal.  A snapshot is an
  optimization, never a requirement: recovery loads the newest valid
  snapshot (if any) and replays the journal tail past it.

Crash safety specifics:

* a torn final journal line (killed mid-append) is detected by JSON
  parse failure and set aside as ``recovered_event["torn_tail"]`` — the
  record was never acknowledged, so dropping it is old-state semantics,
  and the truncated bytes are preserved in the event, never silently
  lost;
* a torn snapshot tmp is ignored (the rename never happened — old-state);
* records are **idempotent** per ``(run, fingerprint, start, stop)``:
  replaying a record that already made it into the journal (a caller
  that crashed between append and its own bookkeeping re-sends) changes
  nothing, so "seen in N runs" counts are exact under at-least-once
  delivery.

Retention (both knobs optional; off by default):

* ``retain_runs=N`` ages out aggregate evidence beyond a horizon of the
  N most-recently-contributing runs: when run N+1 arrives, the stalest
  run's window counts are subtracted from every signature (signatures
  left with no runs disappear from the report).  Eviction drops
  **aggregates only** — the ``(run, fp, start, stop)`` idempotence keys
  are never dropped, so crash-recover-refeed of an evicted run's
  records stays a no-op and live counts stay exact.  Eviction is a pure
  function of journal order (recency = the order runs contribute *new*
  windows; duplicates do not advance it), so journal-only replay
  reconstructs the same retained state the live index held.
* ``journal_max_records=M`` caps journal growth past snapshots: once M
  records accumulate since the last truncation, the journal is
  atomically rewritten (tmp + rename) to a single ``{"_base": N}``
  control line meaning "records 1..N are covered by the snapshot" —
  and truncation only ever runs immediately after a successful snapshot
  rename, so the snapshot on disk always covers the truncated prefix.

Fault points (armed by tests/test_torch_fleet_chaos.py's kill sweep):
``vindex.journal.pre_append``, ``vindex.journal.appended``,
``vindex.snapshot.written``, ``vindex.snapshot.renamed``,
``vindex.journal.truncate.written``, ``vindex.journal.truncated``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import Verdict
from repro_torch.core.faultpoints import fault_point

INDEX_FORMAT_VERSION = 1
JOURNAL_NAME = "journal.jsonl"
SNAPSHOT_NAME = "snapshot.json"


class VerdictIndex:
    """Cross-run verdict dedup index over one directory.

    Opening a directory *is* recovery: the newest valid snapshot is
    loaded, the journal tail is replayed, and a torn trailing line is
    set aside — the constructor never raises on crash residue, only on a
    directory that holds a foreign/newer-format index.
    """

    def __init__(self, directory: str, snapshot_every: int = 16,
                 retain_runs: Optional[int] = None,
                 journal_max_records: Optional[int] = None):
        if snapshot_every < 1:
            raise ValueError(
                f"snapshot_every must be >= 1, got {snapshot_every}")
        if retain_runs is not None and retain_runs < 1:
            raise ValueError(
                f"retain_runs must be >= 1, got {retain_runs}")
        if journal_max_records is not None and journal_max_records < 1:
            raise ValueError(f"journal_max_records must be >= 1, "
                             f"got {journal_max_records}")
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.snapshot_every = snapshot_every
        self.retain_runs = retain_runs
        self.journal_max_records = journal_max_records
        self._journal_path = os.path.join(directory, JOURNAL_NAME)
        self._snapshot_path = os.path.join(directory, SNAPSHOT_NAME)
        # fingerprint -> {"kinds", "paths", "runs": {run: n_windows},
        #                 "windows": total recorded windows}
        self._by_fp: Dict[str, Dict[str, Any]] = {}
        self._keys: set = set()      # (run, fp, start, stop) idempotence
        self._applied = 0            # journal records folded into state
        self._since_snapshot = 0
        # run -> recency rank (order of last *new* window); drives the
        # retain_runs horizon and replays deterministically
        self._run_seq: Dict[str, int] = {}
        self._seq = 0
        self._journal_base = 0       # records folded into a {"_base"} line
        self.evicted_runs = 0        # lifetime eviction count (telemetry)
        self.recovered_event: Optional[Dict[str, Any]] = None
        self._recover()

    # -- recovery ----------------------------------------------------------
    def _load_snapshot(self) -> int:
        """Apply the snapshot if present and valid; returns the journal
        record count it covers (0 when absent/invalid)."""
        try:
            with open(self._snapshot_path) as f:
                doc = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return 0
        if doc.get("format") != "repro.verdict_index":
            raise ValueError(f"{self._snapshot_path}: not a verdict-index "
                             f"snapshot")
        if doc.get("version", 0) > INDEX_FORMAT_VERSION:
            raise ValueError(
                f"{self._snapshot_path}: index version {doc['version']} "
                f"is newer than supported {INDEX_FORMAT_VERSION}")
        for fp, agg in doc["by_fingerprint"].items():
            self._by_fp[fp] = {
                "kinds": list(agg["kinds"]), "paths": list(agg["paths"]),
                "runs": dict(agg["runs"]), "windows": int(agg["windows"]),
            }
        self._keys = {tuple(k) for k in doc["keys"]}
        # pre-retention snapshots carry no run ordering: reconstruct a
        # deterministic one from the aggregate (alphabetical — the
        # journal-order recency is gone, but any fixed order keeps
        # subsequent evictions replayable from *this* snapshot on)
        seq = doc.get("run_seq")
        if seq is None:
            runs = sorted({r for agg in self._by_fp.values()
                           for r in agg["runs"]})
            seq = {r: i + 1 for i, r in enumerate(runs)}
        self._run_seq = {r: int(s) for r, s in seq.items()}
        self._seq = int(doc.get("seq", max(self._run_seq.values(),
                                           default=0)))
        return int(doc["applied"])

    def _recover(self) -> None:
        applied = self._load_snapshot()
        event: Dict[str, Any] = {"snapshot_applied": applied,
                                 "replayed": 0, "torn_tail": None}
        replayed = 0
        if os.path.exists(self._journal_path):
            with open(self._journal_path) as f:
                lines = f.readlines()
            for i, line in enumerate(lines):
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    if i == len(lines) - 1:
                        # killed mid-append: unacknowledged record —
                        # old-state semantics, preserved in the event
                        event["torn_tail"] = line
                        break
                    raise ValueError(
                        f"{self._journal_path}: corrupt journal record "
                        f"{i} (not the tail — the index cannot trust "
                        f"anything after it)")
                if "_base" in rec:
                    # truncation marker: records 1..N live only in the
                    # snapshot now.  Truncation runs strictly after the
                    # covering snapshot's rename, so a marker past the
                    # snapshot means the directory was tampered with.
                    if i != 0:
                        raise ValueError(
                            f"{self._journal_path}: truncation marker at "
                            f"record {i}, expected only at the head")
                    base = int(rec["_base"])
                    if base > applied:
                        raise ValueError(
                            f"{self._journal_path}: truncation marker "
                            f"covers {base} records but the snapshot "
                            f"only covers {applied} — truncated records "
                            f"are unrecoverable")
                    replayed = self._journal_base = base
                    continue
                replayed += 1
                if replayed <= applied:
                    continue            # already folded into the snapshot
                self._fold(rec)
        self._applied = max(applied, replayed)
        event["replayed"] = max(0, replayed - applied)
        # a tightened horizon on reopen evicts immediately (and the
        # replay above already enforced the configured one per fold)
        self._evict_stale()
        self.recovered_event = event

    # -- state -------------------------------------------------------------
    def _fold(self, rec: Dict[str, Any]) -> bool:
        """Apply one journal record to the aggregate; False if it was a
        duplicate (idempotent replay)."""
        key = (rec["run"], rec["fp"], int(rec["start"]), int(rec["stop"]))
        if key in self._keys:
            return False
        self._keys.add(key)
        agg = self._by_fp.setdefault(
            rec["fp"], {"kinds": list(rec["kinds"]),
                        "paths": list(rec["paths"]), "runs": {},
                        "windows": 0})
        agg["runs"][rec["run"]] = agg["runs"].get(rec["run"], 0) + 1
        agg["windows"] += 1
        # recency advances only on a genuinely new window, so journal
        # replay (where duplicates fold to nothing) re-derives the same
        # ordering the live index used
        self._seq += 1
        self._run_seq[rec["run"]] = self._seq
        self._evict_stale()
        return True

    def _evict_stale(self) -> None:
        """Age out the stalest runs' aggregate evidence past the
        ``retain_runs`` horizon.  Idempotence keys are kept: an evicted
        run's refed records must still fold to nothing."""
        if self.retain_runs is None:
            return
        while len(self._run_seq) > self.retain_runs:
            run = min(self._run_seq, key=self._run_seq.get)
            del self._run_seq[run]
            self.evicted_runs += 1
            for fp in list(self._by_fp):
                agg = self._by_fp[fp]
                n = agg["runs"].pop(run, None)
                if n:
                    agg["windows"] -= n
                if not agg["runs"]:
                    del self._by_fp[fp]

    def record(self, run: str, verdict: Verdict, start: int,
               stop: int) -> Dict[str, Any]:
        """Journal one flagged window verdict of ``run`` over steps
        ``[start, stop)`` and fold it into the aggregate.  Idempotent:
        re-recording the same (run, fingerprint, window) is a no-op after
        the journal append — exact counts under at-least-once delivery.
        Returns the journal record."""
        fp = verdict.fingerprint()
        kinds = []
        if verdict.dissimilar or verdict.dissimilarity_paths:
            kinds.append("dissimilarity")
        if verdict.disparity_paths:
            kinds.append("disparity")
        paths = sorted(set(verdict.dissimilarity_paths)
                       | set(verdict.disparity_paths))
        rec = {"run": run, "fp": fp, "start": int(start), "stop": int(stop),
               "kinds": kinds, "paths": paths}
        fault_point("vindex.journal.pre_append")
        with open(self._journal_path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True,
                               separators=(",", ":")) + "\n")
            f.flush()
        fault_point("vindex.journal.appended")
        self._applied += 1
        self._fold(rec)
        # count journal records, not just unique folds: a duplicate
        # advances `applied` too, and the snapshot must keep covering it
        # so reopening replays a bounded (eventually empty) tail
        self._since_snapshot += 1
        if self._since_snapshot >= self.snapshot_every:
            self.snapshot()
        return rec

    # -- snapshot ----------------------------------------------------------
    def snapshot(self) -> str:
        """Atomically rewrite the snapshot to cover every applied record
        (tmp + rename — a concurrent reader, or a crash, sees the old or
        the new snapshot, never a torn one)."""
        doc = {
            "format": "repro.verdict_index",
            "version": INDEX_FORMAT_VERSION,
            "applied": self._applied,
            "by_fingerprint": {
                fp: {"kinds": agg["kinds"], "paths": agg["paths"],
                     "runs": dict(sorted(agg["runs"].items())),
                     "windows": agg["windows"]}
                for fp, agg in sorted(self._by_fp.items())},
            "keys": sorted(list(k) for k in self._keys),
            "run_seq": dict(sorted(self._run_seq.items())),
            "seq": self._seq,
        }
        tmp = self._snapshot_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        fault_point("vindex.snapshot.written")
        os.replace(tmp, self._snapshot_path)
        fault_point("vindex.snapshot.renamed")
        self._since_snapshot = 0
        if self.journal_max_records is not None and \
                self._applied - self._journal_base >= \
                self.journal_max_records:
            self._truncate_journal()
        return self._snapshot_path

    def _truncate_journal(self) -> None:
        """Atomically collapse the journal to a ``{"_base": N}`` control
        line.  Called only right after a snapshot rename, so the
        snapshot on disk covers every collapsed record; a crash between
        the tmp write and the rename leaves the long journal in place
        (old-state semantics, replay skips the covered prefix)."""
        marker = json.dumps({"_base": self._applied},
                            separators=(",", ":")) + "\n"
        tmp = self._journal_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(marker)
            f.flush()
        fault_point("vindex.journal.truncate.written")
        os.replace(tmp, self._journal_path)
        fault_point("vindex.journal.truncated")
        self._journal_base = self._applied

    def close(self) -> None:
        """Final snapshot, so a reopened index replays no journal tail."""
        if self._since_snapshot or not os.path.exists(self._snapshot_path):
            self.snapshot()

    # -- queries -----------------------------------------------------------
    @property
    def n_records(self) -> int:
        """Journal records applied (duplicates included)."""
        return self._applied

    @property
    def fingerprints(self) -> List[str]:
        return sorted(self._by_fp)

    def seen_in(self, fingerprint: str) -> int:
        """Distinct runs this signature was recorded in."""
        agg = self._by_fp.get(fingerprint)
        return 0 if agg is None else len(agg["runs"])

    def report(self) -> List[Dict[str, Any]]:
        """The dedup report, one row per distinct signature, widest blast
        radius first: ``{fingerprint, kinds, paths, n_runs, runs,
        n_windows}`` — "seen in N runs" with the evidence attached."""
        rows = []
        for fp, agg in self._by_fp.items():
            rows.append({
                "fingerprint": fp,
                "kinds": list(agg["kinds"]),
                "paths": list(agg["paths"]),
                "n_runs": len(agg["runs"]),
                "runs": dict(sorted(agg["runs"].items())),
                "n_windows": agg["windows"],
            })
        rows.sort(key=lambda r: (-r["n_runs"], -r["n_windows"],
                                 r["fingerprint"]))
        return rows
