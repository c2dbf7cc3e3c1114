"""Tail a trace spool — live or finished — and stream per-window verdicts.

    PYTHONPATH=src python -m repro_torch.cli.watch_trace SPOOL_DIR
    PYTHONPATH=src python -m repro_torch.cli.watch_trace SPOOL_DIR --follow
    PYTHONPATH=src python -m repro_torch.cli.watch_trace SPOOL_DIR --window 8 --json
    PYTHONPATH=src python -m repro_torch.cli.watch_trace SPOOL_DIR --finalize out.npz
    PYTHONPATH=src python -m repro_torch.cli.watch_trace SPOOL_DIR --device cpu

The port's twin of the reference's ``scripts/watch_train.py``, with the
same flags and exit codes plus ``--device``.  The spool format is shared,
so a spool written by either package is tailed here.

The collection side (``python -m repro_torch.launch.serve --spool-dir``,
or anything appending to a :class:`repro_torch.stream.TraceSpool`)
flushes step segments as the run goes; this command re-reads the spool
manifest, runs the full AutoAnalyzer on each completed tumbling window,
prints one verdict line per window, and reports the **onset**: the first
window whose bottleneck verdict persisted ``--persist`` consecutive
windows — so a drifting fault is localized in time while the run is
still going. With overlapping windows (``--stride`` smaller than
``--window``) the reported onset step is additionally bisected *inside*
the first flagged window, down to the exact step whose inclusion first
flips the verdict.

Analyzer keyword arguments default to the ``analyzer_kw`` the collector
recorded in the trace header (same resolution as ``cli.analyze_trace``)
and can be overridden with ``--analyzer-kw '{"threshold_frac": 0.2}'``.
The clustering runs on the CUDA seed-row kernel on the card unless
``--device cpu`` (the kernel's plain version) or ``--distance-backend
numpy`` (the exact float64 host lane) is given; without a card the
default fails rather than falling back.

``--follow`` keeps polling until the producer closes the spool; without it
the command processes everything flushed so far and exits (nonzero if the
spool is still incomplete, so CI can assert it saw a whole run).
``--follow --max-stall SEC`` bounds the wait: when the spool makes no
progress for SEC seconds the producer is presumed dead and the command
exits rather than tailing a corpse forever (exit code 4 below; rerun
with ``--recover`` to salvage and re-analyze).
``--recover`` runs :meth:`TraceSpool.recover` before tailing — torn
``.tmp`` residue is quarantined, a crash-orphaned trailing segment is
adopted, and the quarantine/adopt/lost-range event log is printed —
then analyzes the sealed manifest like any complete spool.
``--finalize PATH`` converts the complete spool into the classic
single-``.npz`` artifact — byte-identical to the monolithic save of the
same run.

Windows the analyzer could not judge (a quarantined segment's range, a
non-finite sample burst) print as ``DEGRADED`` with the reason — they are
reported, never silently skipped, and never count toward onset.

Exit codes: 0 — complete run analyzed; 2 — usage error (argparse);
3 — spool missing/invalid, or run still in progress without ``--follow``;
4 — ``--max-stall`` exceeded, producer presumed dead.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def window_line(wv) -> str:
    if wv.degraded:
        return (f"window {wv.index:3d}  steps [{wv.start}:{wv.stop})  "
                f"{'DEGRADED':26s} {wv.reason}")
    kinds = ",".join(sorted(wv.kinds)) or "-"
    paths = ",".join(wv.paths()) or "-"
    return (f"window {wv.index:3d}  steps [{wv.start}:{wv.stop})  "
            f"{kinds:26s} {paths}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("spool", help="spool directory (contains spool.json)")
    ap.add_argument("--window", type=int, default=4, metavar="N",
                    help="tumbling window size in steps (default 4)")
    ap.add_argument("--stride", type=int, default=None, metavar="N",
                    help="window stride (default: window size; a stride "
                         "smaller than the window overlaps windows and "
                         "bisects the onset down to a step)")
    ap.add_argument("--persist", type=int, default=2, metavar="K",
                    help="consecutive flagged windows that define onset")
    ap.add_argument("--kind", choices=("dissimilarity", "disparity"),
                    default=None,
                    help="restrict onset detection to one bottleneck kind")
    ap.add_argument("--analyzer-kw", default=None, metavar="JSON",
                    help="AutoAnalyzer kwargs, overriding the trace header")
    ap.add_argument("--distance-backend", default=None,
                    choices=("numpy", "kernel", "torch"),
                    help="distance backend for the per-window analyzer "
                         "(default: the trace header's, else the CUDA "
                         "kernel)")
    ap.add_argument("--device", default=None,
                    help="device of the kernel and torch lanes "
                         "(default: cuda)")
    ap.add_argument("--follow", action="store_true",
                    help="keep polling until the producer closes the spool")
    ap.add_argument("--interval", type=float, default=1.0, metavar="SEC",
                    help="poll interval with --follow (default 1s)")
    ap.add_argument("--max-stall", type=float, default=None, metavar="SEC",
                    help="with --follow: exit 4 (producer presumed dead) "
                         "when the spool makes no progress for SEC seconds")
    ap.add_argument("--recover", action="store_true",
                    help="run TraceSpool.recover on the spool before "
                         "tailing (salvage a crashed producer's residue: "
                         "torn tmps quarantined, orphan segments adopted) "
                         "and print the quarantine/adopt event log")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON document instead of text lines")
    ap.add_argument("--finalize", default=None, metavar="PATH",
                    help="after a complete run, write the classic "
                         "single-.npz artifact here (byte-identical to "
                         "the monolithic save)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.window < 1:
        ap.error("--window must be a positive step count")

    import os

    from repro_torch.stream import (MANIFEST_NAME, OnlineAnalyzer,
                                    ProducerStalledError, SpooledTrace,
                                    StallDetector, TraceSpool, check_lane,
                                    lane_kw)
    kw = json.loads(args.analyzer_kw) if args.analyzer_kw else None
    # a kernel lane without its card fails before any waiting
    check_lane(lane_kw(kw, args.distance_backend, args.device))

    if args.recover:
        # salvage first, then tail the sealed manifest like any other
        # complete spool; the event log says exactly what was kept
        try:
            event = TraceSpool.recover(args.spool)
        except (ValueError, OSError) as e:
            print(str(e), file=sys.stderr)
            return 3
        for q in event["quarantined"]:
            print(f"recover: quarantined {q['file']} ({q['reason']})")
        for a in event["adopted"]:
            print(f"recover: adopted {a}")
        for lo, hi in event["lost_ranges"]:
            print(f"recover: lost steps [{lo}:{hi})")
        print(f"recover: sealed at {event['n_steps']} steps")

    if args.follow:
        # a process that starts the producer after this one can wait for
        # this line: the tail is up from here on
        print(f"following {args.spool} (polling every {args.interval} s)",
              file=sys.stderr, flush=True)
    # A live run has no manifest until its first chunk flushes; --follow
    # waits for it rather than dying at startup — but a producer that
    # died *before* its first flush must not be tailed forever either,
    # so --max-stall bounds this wait too.  A *present* but invalid
    # manifest (foreign file, newer version) still aborts.
    waited = 0.0
    while True:
        try:
            spooled = SpooledTrace(args.spool)
            break
        except ValueError as e:
            missing = not os.path.exists(
                os.path.join(args.spool, MANIFEST_NAME))
            if not (args.follow and missing):
                print(str(e), file=sys.stderr)
                return 3
            if args.max_stall is not None and waited >= args.max_stall:
                print(f"{args.spool}: no spool manifest after "
                      f"{waited:.1f}s — producer presumed dead",
                      file=sys.stderr)
                return 4
            time.sleep(args.interval)
            waited += args.interval
    online = OnlineAnalyzer(window_steps=args.window, stride=args.stride,
                            persist=args.persist, analyzer_kw=kw,
                            distance_backend=args.distance_backend,
                            device=args.device)

    detector = (StallDetector(args.max_stall, base_interval=args.interval)
                if args.follow and args.max_stall is not None else None)
    while True:
        for wv in online.poll(spooled):
            # with --json, stdout stays one document; the live lines go to
            # stderr as each window is judged
            print(window_line(wv), flush=True,
                  file=sys.stderr if args.json else sys.stdout)
        if spooled.complete or not args.follow:
            break
        if detector is not None:
            try:
                delay = detector.observe(spooled)
            except ProducerStalledError as e:
                print(str(e), file=sys.stderr)
                return 4
            time.sleep(delay)
        else:
            time.sleep(args.interval)

    decisions = online.decisions
    if decisions is not None:
        # the kernel lane's seed-row launches and exact-lane re-decisions
        from repro_torch import kernels
        print(json.dumps({"lane": {
            "launches": kernels.LAUNCHES["multi_seed_rows"],
            "seed_counts": {str(k): n for k, n in
                            sorted(kernels.SEED_COUNTS.items())},
            "decisions": decisions}}), file=sys.stderr, flush=True)
    onset = online.onset_report(args.kind)
    if args.json:
        doc = {
            "spool": args.spool,
            "complete": spooled.complete,
            "n_steps": spooled.n_steps,
            "window_steps": args.window,
            "persist": args.persist,
            "windows": [
                ({"index": wv.index, "steps": [wv.start, wv.stop],
                  "degraded": True, "reason": wv.reason,
                  "detail": wv.detail}
                 if wv.degraded else
                 {"index": wv.index, "steps": [wv.start, wv.stop],
                  "kinds": sorted(wv.kinds),
                  "verdict": wv.verdict.doc()})
                for wv in online.log.windows],
            "onset": onset,
        }
        json.dump(doc, sys.stdout, indent=1, sort_keys=True)
        print()
    else:
        if onset is not None:
            print(f"onset: window {onset['onset_window']} (step "
                  f"{onset['onset_step']}; kinds "
                  f"{','.join(onset['kinds'])}; paths "
                  f"{','.join(onset['paths']) or '-'})")
        else:
            print(f"onset: none ({len(online.log.windows)} windows, "
                  f"persist {args.persist})")
    if not spooled.complete:
        print(f"{args.spool}: run still in progress "
              f"({spooled.n_steps} steps flushed)", file=sys.stderr)
        return 3
    if args.finalize:
        # stderr keeps --json stdout a single parseable document
        print(f"finalized: {spooled.finalize(args.finalize)}",
              file=sys.stderr if args.json else sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
