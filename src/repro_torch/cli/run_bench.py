"""Run the analyzer scaling benchmarks, record them as JSON, and gate
regressions against a baseline.

    PYTHONPATH=src python -m repro_torch.cli.run_bench          # default grid
    PYTHONPATH=src python -m repro_torch.cli.run_bench --grid smoke
    PYTHONPATH=src python -m repro_torch.cli.run_bench --out bench.json
    PYTHONPATH=src python -m repro_torch.cli.run_bench --check bench.json
    PYTHONPATH=src python -m repro_torch.cli.run_bench --device cpu

The port's twin of the reference's ``scripts/run_bench.py`` over
``repro_torch.bench.analyzer_bench``, with the same flags plus
``--device``.  It writes only where ``--out`` says.

``--check`` re-runs the baseline file's grid and exits 1 when any entry
regresses by more than ``--factor`` (default 2x), 2 when a baseline entry
is not produced by this run.  Entries whose baseline time is below
``--min-seconds`` are reported but never fail the check (timer noise);
baseline entries whose requirement this machine cannot meet (a device
row's ``"requires": "cuda"`` without a card, or a module that does not
import) are skipped, not failed.  Timings are best-of-``--repeat`` wall
clock after an untimed warmup, each device row's call ending in a device
sync.

The device rows (the ``kernel`` and ``torch`` lanes) run on the card; on
a machine without one they are left out unless ``--device cpu`` runs
them on the lanes' plain versions, and ``meta`` records which.  ``meta``
also records the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints them, and
torch's and CUDA's versions (``"device": null`` and ``"card": null`` for
a run without a card).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def _requirement_met(requires) -> bool:
    """An entry's ``requires`` is ``"cuda"`` (a card), an importable module
    name, or None."""
    if not requires:
        return True
    if requires == "cuda":
        import torch
        return torch.cuda.is_available()
    try:
        __import__(requires)
        return True
    except ImportError:
        return False


def card_line():
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (the
    first card), or None without a card."""
    import torch
    if not torch.cuda.is_available():
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--grid", choices=("smoke", "default"), default="default")
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write results JSON here")
    ap.add_argument("--check", metavar="BASELINE", default=None,
                    help="compare against a baseline JSON; exit nonzero "
                         "on regression")
    ap.add_argument("--factor", type=float, default=2.0,
                    help="regression threshold for --check (default 2x)")
    ap.add_argument("--min-seconds", type=float, default=2e-3,
                    help="baseline entries faster than this never fail "
                         "--check (timer noise floor)")
    ap.add_argument("--device", default=None,
                    help="device of the kernel and torch rows (default: "
                         "the card; left out without one)")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.bench.analyzer_bench import bench_device, run_grid

    grid = args.grid
    baseline = None
    if args.check:
        with open(args.check) as f:
            baseline = json.load(f)
        grid = baseline.get("meta", {}).get("grid", grid)

    dev = bench_device(args.device)
    entries = run_grid(grid, repeat=args.repeat, seed=args.seed,
                       device=dev)
    doc = {
        "meta": {"grid": grid, "repeat": args.repeat, "seed": args.seed,
                 "unix_time": int(time.time()),
                 "device": None if dev is None else str(dev),
                 "device_rows": ("left out: no card and no --device"
                                 if dev is None else "kernel, torch"),
                 "card": card_line(), "torch": torch.__version__,
                 "cuda": torch.version.cuda},
        "entries": entries,
    }

    width = max(len(n) for n in entries) + 2
    print(f"{'entry':{width}s} {'ms':>10s}")
    for name, e in entries.items():
        print(f"{name:{width}s} {e['seconds'] * 1e3:10.3f}")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out}")

    if baseline is None:
        return 0

    base_entries = baseline.get("entries", {})
    missing = sorted(set(base_entries) - set(entries))
    skipped = [n for n in missing
               if not _requirement_met(base_entries[n].get("requires"))]
    if skipped:
        missing = [n for n in missing if n not in set(skipped)]
        print(f"skipping {len(skipped)} baseline entries with unmet "
              f"requirements: {skipped}")
        base_entries = {n: e for n, e in base_entries.items()
                        if n not in set(skipped)}
    if missing:
        print(f"baseline entries not produced by this run: {missing}",
              file=sys.stderr)
        return 2
    regressions = []
    for name, base in sorted(base_entries.items()):
        now = entries[name]["seconds"]
        ref = base["seconds"]
        ratio = now / ref if ref > 0 else float("inf")
        flag = ""
        if ratio > args.factor:
            if ref < args.min_seconds:
                flag = "  (noise floor, ignored)"
            else:
                regressions.append((name, ref, now, ratio))
                flag = "  REGRESSION"
        if flag:
            print(f"{name}: {ref * 1e3:.3f} ms -> {now * 1e3:.3f} ms "
                  f"({ratio:.2f}x){flag}")
    if regressions:
        print(f"{len(regressions)} entries regressed more than "
              f"{args.factor}x", file=sys.stderr)
        return 1
    print(f"check ok: no entry regressed more than {args.factor}x "
          f"vs {args.check}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
