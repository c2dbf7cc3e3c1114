"""Roofline summary: the twin of the reference's
``benchmarks/roofline_report.py``.  Reads the port's own dry-run results
(``python -m repro_torch.launch.dryrun ... --out build/dryrun/<name>.json``;
``RESULTS_GLOB``) and emits one row per (arch x shape x mesh) cell with
the three per-rank roofline terms on the H100 (``launch/roofline.py``):
``(name, bound in microseconds, derived)``."""
from __future__ import annotations

import glob
import json
import pathlib
from typing import List, Optional, Tuple

Row = Tuple[str, float, str]

RESULTS_GLOB = str(pathlib.Path(__file__).resolve().parents[3] / "build"
                   / "dryrun" / "*.json")


def load_cells(pattern: Optional[str] = None) -> List[dict]:
    """The ok cells with a roofline, the last one read of each (arch,
    shape, mesh), in sorted order."""
    cells = {}
    for path in sorted(glob.glob(pattern or RESULTS_GLOB)):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(data, dict):
            data = [data]
        for r in data:
            if r.get("ok") and "roofline" in r:
                cells[(r["arch"], r["shape"], r["mesh"])] = r
    return [cells[k] for k in sorted(cells)]


def all_rows(pattern: Optional[str] = None) -> List[Row]:
    rows: List[Row] = []
    for r in load_cells(pattern):
        t = r["roofline"]
        derived = (f"mesh={r['mesh']};dominant={t['dominant']};"
                   f"compute_s={t['compute_s']:.3e};"
                   f"memory_s={t['memory_s']:.3e};"
                   f"collective_s={t['collective_s']:.3e};"
                   f"useful={t['useful_ratio']:.3f};"
                   f"roofline={100*t['roofline_fraction']:.1f}%")
        rows.append((f"roofline_{r['arch']}_{r['shape']}",
                     t["bound_s"] * 1e6, derived))
    if not rows:
        rows.append(("roofline_summary", 0.0,
                     "no dry-run results found (run "
                     "repro_torch.launch.dryrun --out build/dryrun/...)"))
    return rows
