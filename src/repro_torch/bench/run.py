"""Benchmark harness of the port: one function per paper table/figure, the
kernels beside their plain versions and library calls, and the analyzer's
scaling grid.  Prints ``name,us_per_call,derived`` CSV.

    PYTHONPATH=src python -m repro_torch.bench.run \\
        [--only paper|kernels|analyzer|roofline] \\
        [--lane kernel|torch|numpy] [--device cpu|cuda] [--results GLOB]

The twin of the reference's ``benchmarks/run.py``.  Everything runs on the
card (None: ``cuda``, which raises without one) unless ``--device cpu``
is given; there the kernel rows are left out (a CPU tensor launches no
kernel).  ``--lane`` is the paper tables' distance backend.
``roofline`` reads the port's dry-run results (``bench/roofline_report.py``;
``--results`` names other files than ``build/dryrun/*.json``) and needs no
card.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--only", choices=["paper", "kernels", "analyzer",
                                       "roofline"], default=None)
    ap.add_argument("--lane", choices=["kernel", "torch", "numpy"],
                    default="kernel",
                    help="the paper tables' distance backend")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--results", default=None,
                    help="glob of dry-run JSONs for the roofline rows")
    args = ap.parse_args(argv)
    from repro_torch.bench import (analyzer_bench, kernel_bench,
                                   paper_tables, roofline_report)
    from repro_torch.core import resolve_device
    # the card is needed by every section but the roofline's
    device = None if args.only == "roofline" \
        else str(resolve_device(args.device))
    rows = []
    if args.only in (None, "paper"):
        rows += paper_tables.all_rows(args.lane, device)
    if args.only in (None, "kernels"):
        rows += kernel_bench.all_rows(device)
    if args.only in (None, "roofline"):
        rows += roofline_report.all_rows(args.results)
    if args.only in (None, "analyzer"):
        rows += analyzer_bench.all_rows(device)
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
