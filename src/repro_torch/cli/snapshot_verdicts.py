"""Dump full analyzer verdicts for every *synthetic* corpus entry to JSON,
or diff the current verdicts against a committed baseline.

    PYTHONPATH=src python -m repro_torch.cli.snapshot_verdicts out.json
    PYTHONPATH=src python -m repro_torch.cli.snapshot_verdicts \\
        --check VERDICTS_synthetic.json \\
        [--distance-backend numpy|kernel|torch] [--device cpu|cuda] \\
        [--seed N]

The port's twin of the reference's ``scripts/snapshot_verdicts.py``, with
the same snapshot fields, so the repository's committed
``VERDICTS_synthetic.json`` (made by the reference) is the baseline the
port is held to.  A snapshot captures everything a verdict contains —
partitions, CCR/CCCR paths, cause attributes, per-path causes,
dissimilarity severity, composite_s, disparity severities.

The default lane is the CUDA kernel on the card (``--device`` defaults to
``cuda`` and the run fails without one); ``--device cpu`` runs the same
lane through the kernel's plain version, ``--distance-backend torch`` the
lane of one PyTorch ``addmm`` and ``--distance-backend numpy`` the exact
float64 host lane.

``--check`` compares the live verdicts against a baseline file: every
baseline entry must still exist and match bit-for-bit; entries added since
the baseline are listed but allowed.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional


def snapshot(seed: int, distance_backend: str = "kernel",
             device: Optional[str] = None) -> dict:
    from repro_torch.core import AutoAnalyzer
    from repro_torch.scenarios import corpus_entries

    out = {}
    for entry in corpus_entries(backend="synthetic"):
        tree, collector = entry.build(seed)
        kw = dict(entry.analyzer_kw)
        kw.update(distance_backend=distance_backend, device=device)
        analyzer = AutoAnalyzer(tree, **kw)
        res = analyzer.analyze_collector(collector)
        out[entry.name] = {
            **res.verdict.doc(),
            "dissimilarity_severity": res.dissimilarity.severity,
            "composite_s": res.dissimilarity.composite_s,
            "baseline_n_clusters": res.dissimilarity.baseline.n_clusters,
            "baseline_partition": [list(g) for g in
                                   res.dissimilarity.baseline
                                   .partition_signature],
            "disparity_severities": {str(k): int(s) for k, s in
                                     sorted(res.disparity.severities.items())},
        }
    return out


def drift(baseline: dict, current: dict) -> list:
    """(entry, reason) for every baseline entry the current snapshot
    lacks or disagrees with."""
    out = []
    for name, want in sorted(baseline.items()):
        got = current.get(name)
        if got is None:
            out.append((name, "entry missing from current corpus"))
        elif got != want:
            detail = ", ".join(k for k in sorted(set(want) | set(got))
                               if got.get(k) != want.get(k))
            out.append((name, f"fields drifted: {detail}"))
    return out


def check(baseline_path: str, seed: int, distance_backend: str = "kernel",
          device: Optional[str] = None) -> int:
    with open(baseline_path) as f:
        baseline = json.load(f)
    current = snapshot(seed, distance_backend, device)
    new = sorted(set(current) - set(baseline))
    if new:
        print(f"{len(new)} entries not in baseline (ok, regenerate to pin): "
              f"{new}")
    drifted = drift(baseline, current)
    if drifted:
        print(f"VERDICT DRIFT vs {baseline_path} (seed {seed}):")
        for name, why in drifted:
            print(f"  {name}: {why}")
        return 1
    print(f"{len(baseline)} baseline entries bit-identical "
          f"(seed {seed}, {distance_backend} lane) vs {baseline_path}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("out", nargs="?", default=None,
                    help="snapshot output path (omit with --check)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", default=None, metavar="BASELINE",
                    help="diff live verdicts against this snapshot; exit "
                         "1 on any drift")
    ap.add_argument("--distance-backend", default="kernel",
                    choices=("numpy", "kernel", "torch"),
                    help="clustering lane (default: the CUDA kernel)")
    ap.add_argument("--device", default=None,
                    help="device of the kernel and torch lanes "
                         "(default: cuda)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.check:
        if args.out:
            ap.error("--check does not write a snapshot; drop the output "
                     "path")
        return check(args.check, args.seed, args.distance_backend,
                     args.device)
    if not args.out:
        ap.error("either an output path or --check is required")
    doc = snapshot(args.seed, args.distance_backend, args.device)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {args.out} ({len(doc)} entries)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
