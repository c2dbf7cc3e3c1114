"""Tail a fleet of trace spools and report cross-run deduplicated verdicts.

    PYTHONPATH=src python -m repro_torch.cli.fleet_watch --root RUNS_DIR
    PYTHONPATH=src python -m repro_torch.cli.fleet_watch --root RUNS_DIR --follow
    PYTHONPATH=src python -m repro_torch.cli.fleet_watch --run a=/path/a --run b=/path/b
    PYTHONPATH=src python -m repro_torch.cli.fleet_watch --root RUNS_DIR --index idx --json
    PYTHONPATH=src python -m repro_torch.cli.fleet_watch --root RUNS_DIR --device cpu

The port's twin of the reference's ``scripts/fleet_watch.py``, with the
same flags and exit codes plus ``--device``; spools and the index are
shared formats, so either package's are read here.  Every run's windows
are analyzed on the CUDA seed-row kernel on the card unless ``--device
cpu`` (the kernel's plain version) or ``--distance-backend numpy`` (the
exact host lane) is given; without a card the default fails.

Where ``cli.watch_trace`` tails one run, this command supervises many:
every immediate subdirectory of ``--root`` that contains (or grows) a
``spool.json`` becomes a tenant of one
:class:`repro_torch.fleet.FleetIngest`
— per-run analyzers behind a bounded shared worker pool, per-run
bounded window queues with drop-oldest shedding under backpressure,
integrity-checked segments with a circuit breaker that quarantines a
repeatedly corrupt run, and stall detection + spool recovery for dead
producers (``--max-stall``).  One sick tenant cannot perturb the
others' verdicts.

Flagged window verdicts from every run feed a crash-safe
:class:`repro_torch.fleet.VerdictIndex` (append-only journal + atomic
snapshot under ``--index DIR``; a temporary directory when omitted).
The closing report deduplicates recurring bottleneck signatures across
the fleet: one line per distinct verdict fingerprint, "seen in N runs"
— rerunning with the same persistent ``--index`` resumes its counts
exactly, even after a kill.

Without ``--follow`` the fleet drains everything flushed so far and
exits; with it, polling continues until every producer closes (or
stalls out past ``--max-stall``).

Exit codes: 0 — every run analyzed to completion; 2 — usage error;
3 — no runs found; 4 — at least one run quarantined (report printed);
5 — runs still in progress (without ``--follow``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def discover_runs(root: str) -> dict:
    """Immediate subdirectories of ``root`` holding a spool manifest."""
    from repro_torch.stream import MANIFEST_NAME
    runs = {}
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if os.path.isdir(d) and os.path.exists(
                os.path.join(d, MANIFEST_NAME)):
            runs[name] = d
    return runs


def run_line(st: dict) -> str:
    events = sum(1 for e in st["events"])
    return (f"{st['run']:24s} {st['state']:12s} {st['n_steps']:5d} steps  "
            f"{st['windows']:3d} windows  {st['degraded']:2d} degraded  "
            f"{st['shed']:2d} shed  {events:2d} events")


def report_line(row: dict) -> str:
    paths = ",".join(row["paths"]) or "-"
    kinds = ",".join(row["kinds"]) or "-"
    return (f"{row['fingerprint']:24s} seen in {row['n_runs']} runs  "
            f"{row['n_windows']:3d} windows  {kinds:13s} {paths}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--root", default=None, metavar="DIR",
                    help="directory whose subdirectories are run spools")
    ap.add_argument("--run", action="append", default=[],
                    metavar="NAME=DIR",
                    help="add one run explicitly (repeatable)")
    ap.add_argument("--window", type=int, default=4, metavar="N",
                    help="tumbling window size in steps (default 4)")
    ap.add_argument("--persist", type=int, default=2, metavar="K",
                    help="consecutive flagged windows that define onset")
    ap.add_argument("--analyzer-kw", default=None, metavar="JSON",
                    help="AutoAnalyzer kwargs, overriding trace headers")
    ap.add_argument("--distance-backend", default=None,
                    choices=("numpy", "kernel"),
                    help="distance backend for every run's analyzer "
                         "(default: the trace headers', else the CUDA "
                         "kernel)")
    ap.add_argument("--device", default=None,
                    help="torch device of the kernel lane (default: cuda)")
    ap.add_argument("--workers", type=int, default=4, metavar="N",
                    help="shared worker budget: window analyses per poll "
                         "round, fleet-wide (default 4)")
    ap.add_argument("--queue", type=int, default=8, metavar="N",
                    help="bounded per-run window queue; the oldest window "
                         "is shed past this (default 8)")
    ap.add_argument("--max-integrity-failures", type=int, default=3,
                    metavar="N",
                    help="circuit breaker: quarantine a run after N "
                         "corrupt segments / unreadable manifests "
                         "(default 3)")
    ap.add_argument("--max-stall", type=float, default=None, metavar="SEC",
                    help="presume a producer dead after SEC seconds "
                         "without progress, recover its spool, and drain "
                         "the salvaged tail")
    ap.add_argument("--index", default=None, metavar="DIR",
                    help="persist the cross-run VerdictIndex here "
                         "(journal + snapshot; reruns resume its counts). "
                         "Default: a temporary directory")
    ap.add_argument("--retain-runs", type=int, default=None, metavar="N",
                    help="age index evidence out beyond the N most "
                         "recently contributing runs (default: unbounded)")
    ap.add_argument("--journal-max-records", type=int, default=None,
                    metavar="M",
                    help="collapse the index journal behind its snapshot "
                         "once M records accumulate (default: unbounded)")
    ap.add_argument("--follow", action="store_true",
                    help="keep polling until every producer closes")
    ap.add_argument("--interval", type=float, default=1.0, metavar="SEC",
                    help="poll interval (default 1s)")
    ap.add_argument("--max-ticks", type=int, default=100_000, metavar="N",
                    help="hard bound on poll rounds (default 100000)")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON document instead of text lines")
    args = ap.parse_args(argv)
    if not args.root and not args.run:
        ap.error("need --root and/or --run")

    from repro_torch.fleet import FleetConfig, FleetIngest, VerdictIndex

    runs = discover_runs(args.root) if args.root else {}
    for spec in args.run:
        name, _, d = spec.partition("=")
        if not d:
            ap.error(f"--run wants NAME=DIR, got {spec!r}")
        runs[name] = d
    if not runs:
        print(f"no runs found under {args.root}", file=sys.stderr)
        return 3

    kw = json.loads(args.analyzer_kw) if args.analyzer_kw else {}
    cfg = FleetConfig(window_steps=args.window, persist=args.persist,
                      analyzer_kw=tuple(sorted(kw.items())),
                      distance_backend=args.distance_backend,
                      device=args.device,
                      max_workers=args.workers,
                      queue_windows=args.queue,
                      max_integrity_failures=args.max_integrity_failures,
                      max_stall=args.max_stall)
    tmp = None
    index_dir = args.index
    if index_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="repro-vindex-")
        index_dir = tmp.name
    try:
        index = VerdictIndex(index_dir, retain_runs=args.retain_runs,
                             journal_max_records=args.journal_max_records)
        fleet = FleetIngest(cfg, index=index)
        for name, d in sorted(runs.items()):
            fleet.add_run(name, d)

        resolved = fleet.tick()
        for _ in range(args.max_ticks):
            if fleet.done:
                break
            if not args.follow and resolved == 0 \
                    and not any(s.queue for s in fleet.runs.values()):
                break       # everything flushed so far is analyzed
            if args.follow:
                time.sleep(args.interval)
            resolved = fleet.tick()
        index.close()

        status = fleet.status()
        if args.json:
            json.dump(status, sys.stdout, indent=1, sort_keys=True)
            print()
        else:
            for st in status["runs"]:
                print(run_line(st))
                for e in st["events"]:
                    print(f"{'':24s} event: "
                          + json.dumps(e, sort_keys=True))
            rows = status.get("index", [])
            print(f"-- {len(rows)} distinct verdict signature(s) across "
                  f"{len(runs)} run(s)")
            for row in rows:
                print(report_line(row))
    finally:
        if tmp is not None:
            tmp.cleanup()

    states = [st["state"] for st in status["runs"]]
    if any(s == "quarantined" for s in states):
        return 4
    if not all(s == "done" for s in states):
        print("runs still in progress: "
              + ", ".join(st["run"] for st in status["runs"]
                          if st["state"] != "done"), file=sys.stderr)
        return 5
    return 0


if __name__ == "__main__":
    sys.exit(main())
