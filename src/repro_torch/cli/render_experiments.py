"""Render the dry-run and roofline tables from the port's sweep JSONs:
the twin of the reference's ``scripts/render_experiments.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --out build/dryrun/single_pod.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod \\
        --out build/dryrun/multi_pod.json
    PYTHONPATH=src python -m repro_torch.cli.render_experiments \\
        [--single F] [--multi F]

prints markdown to stdout.  Memory columns are per rank (the local
shards); the roofline terms are per rank on one H100 (NVLink's one-way
rate for the collective term, a lower bound on a mesh that spans nodes).
"""
from __future__ import annotations

import argparse
import json
import sys

HINTS = {
    "compute": "increase arithmetic intensity / larger per-rank batch",
    "memory": "fuse operators (the count is unfused aten traffic), "
              "shrink saved activations, bf16 end to end",
    "collective": "reshard to cut cross-shard traffic; overlap "
                  "collectives with compute",
}


def load(path):
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return []


def dryrun_table(rows, title):
    out = [f"### {title}", ""]
    out.append("| arch | shape | mesh | ok | count_s | args GB/rank | "
               "temp GB/rank | collectives (production pass) |")
    out.append("|---|---|---|---|---|---|---|---|")
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if not r.get("ok"):
            out.append(f"| {r['arch']} | {r['shape']} | - | **FAIL** | - |"
                       f" - | - | {r.get('error', '')[:60]} |")
            continue
        mem = r.get("memory") or {}
        coll = r.get("production_cost_raw", {}).get("coll_counts", {})
        cstr = " ".join(f"{k.split('-')[-1][:3]}:{v}"
                        for k, v in sorted(coll.items()))
        temp = mem.get("temp_size_in_bytes")
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | yes | "
            f"{r.get('count_s', 0):.1f} | "
            f"{mem.get('argument_size_in_bytes', 0)/1e9:.1f} | "
            f"{'-' if temp is None else f'{temp/1e9:.1f}'} | {cstr} |")
    return "\n".join(out)


def roofline_table(rows):
    out = ["| arch | shape | compute_s | memory_s | collective_s | "
           "dominant | MODEL_FLOPS | useful | roofline% | one-line next-step |"]
    out.append("|---|---|---|---|---|---|---|---|---|---|")
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if not r.get("ok") or "roofline" not in r:
            continue
        t = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.3e} | "
            f"{t['memory_s']:.3e} | {t['collective_s']:.3e} | "
            f"**{t['dominant']}** | {r['model_flops']:.2e} | "
            f"{t['useful_ratio']:.2f} | {100*t['roofline_fraction']:.1f}% | "
            f"{HINTS[t['dominant']]} |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--single", default="build/dryrun/single_pod.json")
    ap.add_argument("--multi", default="build/dryrun/multi_pod.json")
    args = ap.parse_args(argv)
    single, multi = load(args.single), load(args.multi)
    print(dryrun_table(single, "Single pod (16×16 = 256 ranks)"))
    print()
    print(dryrun_table(multi, "Multi-pod (2×16×16 = 512 ranks), "
                       "production pass"))
    print()
    print("### Roofline (single pod; per-rank terms on one H100)")
    print()
    print(roofline_table(single))
    return 0


if __name__ == "__main__":
    sys.exit(main())
