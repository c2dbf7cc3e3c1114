"""Run the golden fault-injection corpus end-to-end and report scores.

    PYTHONPATH=src python -m repro_torch.cli.run_corpus [--seed N]
        [--backend B] [--jobs N] [--list] [--entry NAME ...]
        [--distance-backend numpy|kernel|torch] [--device cpu|cuda]

The port's twin of the reference's ``scripts/run_corpus.py``, over
``repro_torch.scenarios``: the same flags, the same per-entry
precision/recall table and the same exit codes — 0 when every entry
passes, 1 when one misses its ground-truth bottleneck paths or cause
attributes (usable directly as a CI gate), 2 on a usage error.

The analyzers run on the CUDA seed-row kernel on the card unless
``--distance-backend`` names another lane (``torch``: one PyTorch
``addmm`` on the card; ``numpy``: the exact float64 host lane) or
``--device cpu`` runs the device lanes' plain versions; ``--device`` is
also where runtime entries time their regions and train, recovery and
checkpoint entries train.  Without a card the device lanes fail rather
than fall back.

``--jobs N`` fans the entries out over a process pool (spawn context:
fork is unsafe once CUDA is initialised).  Workers receive entry *names*
and return plain result rows, so nothing unpicklable crosses the process
boundary, and the table is printed in deterministic entry order
regardless of which worker finishes first: the output is byte-identical
to a sequential run apart from the wall_s column.

The columns are the reference's: ``onset`` (got/want window of a fault's
onset), ``recov`` (the window a recovery entry's mitigation fired at
against its bound), ``chaos`` (matched/comparable window verdicts of a
chaos or fleet entry), ``serve`` (completed requests against a serving
entry's floor); the detail lines below a row are the reference's too.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional


def run_one(name: str, seed: int, train_trace_dir: Optional[str] = None,
            train_spool_dir: Optional[str] = None,
            distance_backend: Optional[str] = None,
            device: Optional[str] = None) -> dict:
    """Run one corpus entry by name and reduce the result to a plain row
    dict (the only thing that crosses the --jobs process boundary:
    CorpusRunResult holds closures and collectors that do not pickle)."""
    from repro_torch.scenarios import run_entry_robust, select_entries
    if train_spool_dir:
        from repro_torch.scenarios import corpus as corpus_mod
        corpus_mod.TRAIN_SPOOL_BASE = train_spool_dir
    entry = select_entries(names=[name])[0]
    overrides = {}
    if distance_backend:
        overrides["distance_backend"] = distance_backend
    if device:
        overrides["device"] = device
    r = run_entry_robust(entry, seed=seed,
                         analyzer_overrides=overrides or None)
    notes = []
    if train_trace_dir and entry.backend == "train":
        trace = r.collector.trainer.trace
        path = os.path.join(train_trace_dir,
                            name.replace("/", "-") + ".npz")
        os.makedirs(train_trace_dir, exist_ok=True)
        notes.append(f"saved trace artifact: {trace.save(path)}")
    if train_spool_dir and entry.backend == "train":
        # the kept run's spool (a retry spools separately)
        notes.append(f"spool: {name} -> "
                     f"{r.collector.trainer.tcfg.trace_spool_dir}")
    o = r.chaos_outcome
    rwant = entry.recovery
    return {
        "name": name,
        "kind": entry.truth.kind,
        "passed": r.passed,
        "precision": r.precision,
        "recall": r.recall,
        "cause_recall": r.cause_recall,
        "walls": list(r.attempt_walls),
        "onset": (None if entry.expect_onset_window is None
                  else [r.onset_window, entry.expect_onset_window]),
        "recov": (None if rwant is None
                  else [r.mitigation_window, rwant.mitigate_by_window]),
        "recovery": (None if rwant is None else {
            "got_kind": r.recovery_kind, "window": r.mitigation_window,
            "clean_after": r.clean_after, "want_kind": rwant.kind,
            "by_window": rwant.mitigate_by_window,
            "clean_windows": rwant.clean_windows}),
        "chaos": (None if o is None else {
            "survived": o.survived, "quarantined": o.quarantined,
            "adopted": o.adopted, "degraded": o.degraded,
            "stalled": o.stalled, "shed": o.shed,
            "matched": o.matched, "comparable": o.comparable,
            "fallback_from": o.fallback_from,
            "restored_step": o.restored_step}),
        "chaos_failures": list(r.chaos_failures or ()),
        "serve": (None if entry.serving is None
                  else [r.completed, entry.serving.min_completed]),
        "missed": sorted(r.missed),
        "spurious": sorted(r.spurious),
        "causes_wanted": sorted(entry.truth.cause_attributes),
        "causes_found": sorted(r.causes_found),
        "causes_global": sorted(r.verdict.cause_attributes),
        "notes": notes,
    }


def _print_row(row: dict, wname: int) -> None:
    status = "ok" if row["passed"] else "FAIL"

    def fmt(gw):
        return "-" if gw is None else f"{gw[0]}/{gw[1]}"

    o = row["chaos"]
    chaos = "-" if o is None else f"{o['matched']}/{o['comparable']}"
    print(f"{row['name']:{wname}s} {row['kind']:13s} "
          f"{row['precision']:6.2f} {row['recall']:6.2f} "
          f"{row['cause_recall']:6.2f} {fmt(row['onset']):>7s} "
          f"{fmt(row['recov']):>7s} {chaos:>7s} "
          f"{fmt(row.get('serve')):>7s} "
          f"{sum(row['walls']):7.3f}  {status}")
    pad = " " * wname
    rec = row["recovery"]
    if rec is not None:
        print(f"{pad}   recovery: got {rec['got_kind']} at window "
              f"{rec['window']}, clean tail {rec['clean_after']} "
              f"(want {rec['want_kind']} by window {rec['by_window']}, "
              f"clean >= {rec['clean_windows']})")
    if o is not None:
        fb = (f", fell back step {o['fallback_from']}->"
              f"{o['restored_step']}"
              if o["fallback_from"] is not None else "")
        shed = f" shed={o['shed']}" if o["shed"] else ""
        print(f"{pad}   chaos: survived={o['survived']} "
              f"quarantined={o['quarantined']} adopted={o['adopted']} "
              f"degraded={o['degraded']} stalled={o['stalled']}"
              f"{shed}{fb}")
        for msg in row["chaos_failures"]:
            print(f"{pad}   chaos FAIL: {msg}")
    if len(row["walls"]) > 1:
        # a retried wall-clock entry: report every attempt, not just
        # the one whose result was kept
        print(f"{pad}   retried: attempt wall_s "
              + ", ".join(f"{w:.3f}" for w in row["walls"]))
    if row["missed"]:
        print(f"{pad}   missed: {row['missed']}")
    if not row["passed"] and row["spurious"]:
        print(f"{pad}   spurious: {row['spurious']}")
    want = row["causes_wanted"]
    if want and not set(want) <= set(row["causes_found"]):
        print(f"{pad}   causes wanted {want}, got {row['causes_found']} "
              f"at the planted paths (globally: {row['causes_global']})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend",
                    choices=("synthetic", "runtime", "train", "recovery",
                             "chaos", "fleet", "serving"),
                    default=None, help="restrict to one backend")
    ap.add_argument("--entry", action="append", default=None,
                    help="run only these entries (repeatable)")
    ap.add_argument("--jobs", type=int, default=1, metavar="N",
                    help="run entries on an N-process pool (spawn "
                         "context); output stays in entry order")
    ap.add_argument("--list", action="store_true",
                    help="list registered entries and exit")
    ap.add_argument("--train-trace-dir", default=None, metavar="DIR",
                    help="save each train-backend entry's RegionTrace "
                         "artifact here (one training run serves both the "
                         "gate and the artifact)")
    ap.add_argument("--train-spool-dir", default=None, metavar="DIR",
                    help="collect train-backend entries through a "
                         "TraceSpool under this base directory (streaming "
                         "collection; each run's spool path is printed)")
    ap.add_argument("--distance-backend", default=None,
                    choices=("numpy", "kernel", "torch"),
                    help="override every entry's analyzer distance "
                         "backend (default: the CUDA kernel; the device "
                         "lanes must reproduce the exact-lane verdicts)")
    ap.add_argument("--device", default=None,
                    help="device of the kernel and torch lanes, the "
                         "runtime regions and the trainers (default: "
                         "cuda)")
    args = ap.parse_args(argv)
    if args.jobs < 1:
        print("--jobs must be >= 1", file=sys.stderr)
        return 2

    from repro_torch.scenarios import select_entries
    try:
        entries = select_entries(backend=args.backend, names=args.entry)
    except ValueError as e:  # unknown entry, or one excluded by --backend
        print(str(e), file=sys.stderr)
        return 2

    if args.list:
        for e in entries:
            print(f"{e.name:44s} [{e.backend:9s}] {e.truth.kind:13s} "
                  f"{e.description}")
        return 0
    if not entries:
        print("no entries selected", file=sys.stderr)
        return 2

    names = [e.name for e in entries]
    job = (args.seed, args.train_trace_dir, args.train_spool_dir,
           args.distance_backend, args.device)
    if args.jobs > 1 and len(names) > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        ctx = mp.get_context("spawn")   # fork is unsafe once CUDA is up
        with ProcessPoolExecutor(max_workers=min(args.jobs, len(names)),
                                 mp_context=ctx) as pool:
            futures = [pool.submit(run_one, n, *job) for n in names]
            # collect in submit order: the table is deterministic no
            # matter which worker finishes first
            rows = [f.result() for f in futures]
    else:
        rows = [run_one(n, *job) for n in names]

    for row in rows:
        for note in row["notes"]:
            print(note)
    wname = max(len(n) for n in names) + 2
    print(f"{'entry':{wname}s} {'kind':13s} {'prec':>6s} {'recall':>6s} "
          f"{'causes':>6s} {'onset':>7s} {'recov':>7s} {'chaos':>7s} "
          f"{'serve':>7s} {'wall_s':>7s}  status")
    print("-" * (wname + 84))
    failures = sum(1 for row in rows if not row["passed"])
    for row in rows:
        _print_row(row, wname)
    print("-" * (wname + 84))
    print(f"{len(rows) - failures}/{len(rows)} entries passed "
          f"(seed {args.seed})")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
