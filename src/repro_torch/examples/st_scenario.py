"""The paper's ST case study (§6.1), end to end: locate the dissimilarity
and disparity bottlenecks, uncover root causes with the rough-set engine,
apply the paper's two fixes, and re-analyze (Fig. 14).

    PYTHONPATH=src python -m repro_torch.examples.st_scenario \\
        [--distance-backend kernel|torch|numpy] [--device cpu|cuda]

The twin of the reference's ``examples/st_scenario.py``: the same report,
from analyzers on the CUDA seed-row kernel on the card unless the flags
say otherwise (without a card the default fails).
"""
import argparse

from repro_torch.core import AutoAnalyzer, format_matrix, render
from repro_torch.scenarios import st_scenario, st_total_time


def analyze(title, lane: dict, **kw):
    tree, rm = st_scenario(**kw)
    res = AutoAnalyzer(tree, **lane).analyze(rm)
    print(f"===== {title} =====")
    print(render(tree, res))
    print(f"total wall time: {st_total_time(rm):.1f}s")
    print()
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--distance-backend", default="kernel",
                    choices=("kernel", "torch", "numpy"))
    ap.add_argument("--device", default=None,
                    help="device of the kernel and torch lanes "
                         "(default: cuda)")
    args = ap.parse_args(argv)
    lane = dict(distance_backend=args.distance_backend, device=args.device)

    res = analyze("ST, original", lane)
    if res.dissimilarity_table is not None:
        print("discernibility matrix (dissimilarity decision table):")
        print(format_matrix(res.dissimilarity_table))
        print()

    base = st_total_time(st_scenario()[1])
    analyze("ST, dynamic load dispatching (fixes region 11 imbalance)",
            lane, optimize_dissimilarity=True)
    analyze("ST, buffered I/O + loop blocking (fixes regions 8 & 11)",
            lane, optimize_disparity=True)
    analyze("ST, both fixes", lane, optimize_dissimilarity=True,
            optimize_disparity=True)
    both = st_total_time(st_scenario(optimize_dissimilarity=True,
                                     optimize_disparity=True)[1])
    print(f"Fig. 14 analogue: overall speedup {100 * (base / both - 1):.0f}%"
          f" (paper: +170%)")


if __name__ == "__main__":
    main()
