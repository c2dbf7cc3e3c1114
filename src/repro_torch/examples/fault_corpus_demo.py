"""Fault-injection corpus walkthrough: plant a known bottleneck, watch
AutoAnalyzer recover it, and compare against the ground truth — the
paper's §6 validation loop in miniature.

    PYTHONPATH=src python -m repro_torch.examples.fault_corpus_demo \\
        [entry-name ...] [--distance-backend kernel|torch|numpy] \\
        [--device cpu|cuda]

The twin of the reference's ``examples/fault_corpus_demo.py``: the same
report, from analyzers on the CUDA seed-row kernel on the card unless the
flags say otherwise (without a card the default fails).
"""
import argparse

from repro_torch.core import AutoAnalyzer, render
from repro_torch.scenarios import CORPUS, corpus_entries, score_verdict

DEFAULT_ENTRIES = ("st/data-skew-cr11", "st/io-hotspot-cr8",
                   "moe/mixtral-expert-hotspot")


def show(name: str, lane: dict) -> None:
    entry = CORPUS[name]
    print(f"== {entry.name} [{entry.backend}] — {entry.description}")
    print(f"   planted: {sorted(entry.truth.bottleneck_paths)} "
          f"({entry.truth.kind}); "
          f"causes {sorted(entry.truth.cause_attributes) or '(any)'}")
    tree, collector = entry.build(seed=0)
    analyzer = AutoAnalyzer(tree, **{**dict(entry.analyzer_kw), **lane})
    result = analyzer.analyze_collector(collector)
    print(render(tree, result))
    r = score_verdict(entry, result.verdict)
    print(f"   verdict paths: {sorted(r.found)}")
    print(f"   precision {r.precision:.2f}  recall {r.recall:.2f}  "
          f"cause recall {r.cause_recall:.2f}\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("names", nargs="*", metavar="entry-name")
    ap.add_argument("--distance-backend", default="kernel",
                    choices=("kernel", "torch", "numpy"))
    ap.add_argument("--device", default=None,
                    help="device of the kernel and torch lanes "
                         "(default: cuda)")
    args = ap.parse_args(argv)
    lane = dict(distance_backend=args.distance_backend, device=args.device)
    for name in args.names or DEFAULT_ENTRIES:
        if name not in CORPUS:
            known = ", ".join(e.name for e in corpus_entries())
            raise SystemExit(f"unknown entry {name!r}; known: {known}")
        show(name, lane)


if __name__ == "__main__":
    main()
