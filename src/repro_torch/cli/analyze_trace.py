"""Run the full AutoAnalyzer offline on a saved RegionTrace artifact.

    PYTHONPATH=src python -m repro_torch.cli.analyze_trace trace.npz
    PYTHONPATH=src python -m repro_torch.cli.analyze_trace trace.npz --window 0:8
    PYTHONPATH=src python -m repro_torch.cli.analyze_trace trace.npz --per-window 4
    PYTHONPATH=src python -m repro_torch.cli.analyze_trace trace.npz --json
    PYTHONPATH=src python -m repro_torch.cli.analyze_trace trace.npz --device cpu

The port's twin of the reference's ``scripts/analyze_trace.py``.  The
artifact format is shared, so a trace saved by either package is analyzed
here: the region tree is rebuilt from the artifact's schema header, and
behaviour analysis, bottleneck location and root-cause uncovering replay
on it.

Analyzer keyword arguments default to the ``analyzer_kw`` the collector
recorded in the trace header and can be overridden with
``--analyzer-kw '{"threshold_frac": 0.2}'``.  The clustering runs on the
CUDA kernel on the card unless ``--device cpu`` (the kernel's plain
version) or ``--distance-backend numpy`` (the exact float64 host lane) is
given; without a card the default fails rather than falling back.

Exit codes: 0 — analyzed; 2 — usage error (argparse); 3 — artifact
missing; 4 — artifact present but damaged (truncated, bit-rotted, or a
malformed header: the structured ``TraceFormatError`` is printed with the
offending member).
"""
from __future__ import annotations

import argparse
import json
import sys


def parse_window(spec: str):
    start, _, stop = spec.partition(":")
    return (int(start) if start else 0, int(stop) if stop else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("trace", help="path to a RegionTrace .npz artifact")
    ap.add_argument("--window", default=None, metavar="START:STOP",
                    help="analyze only this step window of the run")
    ap.add_argument("--per-window", type=int, default=None, metavar="N",
                    help="analyze the run in consecutive N-step windows")
    ap.add_argument("--analyzer-kw", default=None, metavar="JSON",
                    help="AutoAnalyzer kwargs, overriding the trace header")
    ap.add_argument("--distance-backend", default=None,
                    choices=("numpy", "kernel", "torch"),
                    help="distance backend override (default: the trace "
                         "header's, else the CUDA kernel)")
    ap.add_argument("--device", default=None,
                    help="device of the kernel and torch lanes "
                         "(default: cuda)")
    ap.add_argument("--json", action="store_true",
                    help="emit the verdict(s) as JSON instead of the report")
    args = ap.parse_args(argv)
    if args.window and args.per_window:
        ap.error("--window and --per-window are mutually exclusive")
    if args.per_window is not None and args.per_window < 1:
        ap.error("--per-window must be a positive step count")

    from repro_torch.core import (AutoAnalyzer, RegionTrace,
                                  TraceFormatError, render, tree_from_schema)

    try:
        trace = RegionTrace.load(args.trace)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 3
    except TraceFormatError as e:
        print(f"corrupt trace artifact: {e}", file=sys.stderr)
        return 4
    tree = tree_from_schema(trace.schema)
    kw = dict(trace.meta.get("analyzer_kw", {}))
    if args.analyzer_kw:
        kw.update(json.loads(args.analyzer_kw))
    if args.distance_backend:
        kw["distance_backend"] = args.distance_backend
    kw["device"] = args.device
    analyzer = AutoAnalyzer(tree, **kw)

    if args.per_window:
        windows = [(s, min(s + args.per_window, trace.n_steps))
                   for s in range(0, trace.n_steps, args.per_window)]
    else:
        windows = [parse_window(args.window)] if args.window else [None]

    docs = []
    for w in windows:
        res = analyzer.analyze_trace(trace, window=w)
        label = (f"steps [{w[0]}:{w[1] if w[1] is not None else trace.n_steps})"
                 if w else f"all {trace.n_steps} steps")
        if args.json:
            docs.append({"window": label, "verdict": res.verdict.doc()})
        else:
            print(f"== {args.trace}: {trace.n_processes} shards x "
                  f"{len(trace.region_ids)} regions, {label} "
                  f"(collector: {trace.meta.get('collector', '?')}) ==")
            print(render(tree, res))
            print()
    if args.json:
        json.dump(docs if len(docs) > 1 else docs[0], sys.stdout,
                  indent=1, sort_keys=True)
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
