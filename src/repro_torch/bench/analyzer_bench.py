"""Scaling benchmarks for the AutoAnalyzer hot path.

The port's twin of the reference's ``benchmarks/analyzer_bench.py``: a
deterministic grid over shards m × regions n for the four analyzer
kernels — simplified-OPTICS clustering, the full Algorithm 2
dissimilarity search, the disparity search, and rough-set reducts — on
the same numpy workloads, under the same entry names (``cluster/``,
``algo2/``, ``disparity/``, ``reducts/``).

The device rows time the two device lanes where the reference timed its
jax and pallas lanes: ``algo2/m{m}/n{n}/{kernel,torch}`` (Algorithm 2
routed through the lockstep device path) and
``seedrows/m{m}/n{n}/{numpy,kernel,torch}`` (8 seed rows through the
host surface ``seed_rows``, the shape Algorithm 2's lockstep rounds
fetch).  Each device row carries ``"requires": "cuda"``, so
``run_bench --check`` skips it on a machine without a card.  The device
rows run on the card; with no card they are left out unless the caller
passes ``device="cpu"`` (the lanes' plain versions), and never fall back.
Every device row's timed call ends in a device sync.

``python -m repro_torch.cli.run_bench`` drives these into a JSON file and
gates regressions against a baseline; ``python -m repro_torch.bench.run
--only analyzer`` prints the same rows as CSV.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import (RegionTree, find_disparity_bottlenecks,
                              find_dissimilarity_bottlenecks,
                              get_distance_backend, optics_cluster,
                              resolve_device)
from repro_torch.core.roughset import DecisionTable

# Grid points: shards m in {8..16384} x regions n in {16..512}, the
# reference's.  The smoke grid is the tier-1 CI lane (sub-second).
_MN_SMOKE = [(8, 16), (32, 16)]
_MN_DEFAULT = [(m, n)
               for m in (8, 32, 128, 512, 2048)
               for n in (16, 64, 128, 512)] + \
              [(8192, 64), (8192, 128), (16384, 64), (16384, 128)]
# Distance-backend seed-row fetches (8 seeds).
_SEEDROWS = [(2048, 128), (16384, 128)]
_SEEDROW_SEEDS = 8
# Device-lane Algorithm 2: the algo2/ search routed through the lockstep
# device path.
_ALGO2_DEVICE = [(2048, 128), (16384, 128)]
GRIDS: Dict[str, Dict[str, list]] = {
    "smoke": {"mn": _MN_SMOKE, "disparity_n": [16, 64],
              "reducts_attrs": [5, 8], "seedrows": [],
              "algo2_device": [(32, 16)]},
    "default": {"mn": _MN_DEFAULT, "disparity_n": [16, 64, 128, 512],
                "reducts_attrs": [5, 10, 14], "seedrows": _SEEDROWS,
                "algo2_device": _ALGO2_DEVICE},
}
DEVICE_LANES = ("kernel", "torch")
# The requirement a device row declares (run_bench's --check skips a
# baseline row whose requirement this machine cannot meet).
REQUIRES = "cuda"


def cluster_workload(m: int, n: int, seed: int = 0) -> np.ndarray:
    """(m, n) near-balanced measurement matrix with one straggling shard
    block — several clusters, like real dissimilar runs."""
    rng = np.random.default_rng(seed)
    T = 1.0 + 0.05 * rng.random((m, n))
    T[: max(1, m // 8), n // 3] *= 6.0
    return T


def algo2_workload(m: int, n: int,
                   seed: int = 0) -> Tuple[RegionTree, np.ndarray, List[int]]:
    """Flat n-region tree + matrix with a planted single-region straggler:
    Algorithm 2 walks every depth-1 region and pins one CCR."""
    tree = RegionTree("bench")
    for j in range(1, n + 1):
        tree.add(f"cr{j}")
    return tree, cluster_workload(m, n, seed), list(range(1, n + 1))


def disparity_workload(n: int,
                       seed: int = 0) -> Tuple[RegionTree, np.ndarray,
                                               List[int]]:
    tree = RegionTree("bench")
    for j in range(1, n + 1):
        tree.add(f"cr{j}")
    rng = np.random.default_rng(seed)
    vals = 0.01 + 0.02 * rng.random(n)
    vals[n // 3] = 0.9
    return tree, vals, list(range(1, n + 1))


def reducts_workload(n_attrs: int, n_rows: int = 24,
                     seed: int = 0) -> DecisionTable:
    rng = np.random.default_rng(seed)
    rows = [tuple(int(x) for x in rng.integers(0, 2, n_attrs))
            for _ in range(n_rows)]
    decisions = [int(x) for x in rng.integers(0, 2, n_rows)]
    return DecisionTable([f"a{i}" for i in range(n_attrs)], rows, decisions)


def best_of(fn: Callable[[], object], repeat: int,
            sync: Callable[[], None] = lambda: None) -> float:
    """Best wall seconds of ``repeat`` calls, each ending in ``sync()``,
    after an untimed warmup call (first-touch page faults, BLAS spin-up,
    the kernels' load)."""
    fn()
    sync()
    best = float("inf")
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def bench_device(device: Union[None, str, torch.device] = None
                 ) -> Optional[torch.device]:
    """Where the device rows run: ``device`` when given (a card asked for
    and absent raises), else the card when there is one, else None — the
    device rows are then left out."""
    if device is not None:
        return resolve_device(device)
    return torch.device("cuda") if torch.cuda.is_available() else None


def run_grid(grid: str = "default", repeat: int = 3, seed: int = 0,
             device: Union[None, str, torch.device] = None
             ) -> Dict[str, Dict[str, float]]:
    """Time every grid entry (best of ``repeat``); returns
    ``{entry_name: {dims..., "seconds": t}}``.  The device rows run on
    :func:`bench_device` ``(device)`` and are left out when it is None."""
    spec = GRIDS[grid]
    dev = bench_device(device)
    sync = (torch.cuda.synchronize if dev is not None and dev.type == "cuda"
            else lambda: None)
    lanes = DEVICE_LANES if dev is not None else ()
    entries: Dict[str, Dict[str, float]] = {}

    for m, n in spec["mn"]:
        T = cluster_workload(m, n, seed)
        entries[f"cluster/m{m}/n{n}"] = {
            "m": m, "n": n,
            "seconds": best_of(lambda: optics_cluster(T), repeat)}

    for m, n in spec["mn"]:
        tree, T, rids = algo2_workload(m, n, seed)
        entries[f"algo2/m{m}/n{n}"] = {
            "m": m, "n": n,
            "seconds": best_of(
                lambda: find_dissimilarity_bottlenecks(tree, T, rids),
                repeat)}

    for m, n in spec.get("algo2_device", ()):
        tree, T, rids = algo2_workload(m, n, seed)
        for lane in lanes:
            be = get_distance_backend(lane, dev)
            entries[f"algo2/m{m}/n{n}/{lane}"] = {
                "m": m, "n": n, "requires": REQUIRES,
                "seconds": best_of(
                    lambda: find_dissimilarity_bottlenecks(
                        tree, T, rids, backend=be),
                    repeat, sync)}

    for n in spec["disparity_n"]:
        tree, vals, rids = disparity_workload(n, seed)
        entries[f"disparity/n{n}"] = {
            "n": n,
            "seconds": best_of(
                lambda: find_disparity_bottlenecks(tree, vals, rids),
                repeat)}

    for a in spec["reducts_attrs"]:
        table = reducts_workload(a, seed=seed)
        entries[f"reducts/a{a}"] = {
            "attrs": a,
            "seconds": best_of(table.reducts, repeat)}

    for m, n in spec.get("seedrows", ()):
        W = cluster_workload(m, n, seed)
        sq = np.einsum("ij,ij->i", W, W)
        idx = list(range(_SEEDROW_SEEDS))
        for lane in ("numpy",) + lanes:
            be = get_distance_backend(lane, dev)
            handle = be.prepare(W, sq)
            entry = {
                "m": m, "n": n,
                "seconds": best_of(
                    lambda: be.seed_rows(handle, idx), repeat, sync)}
            if lane != "numpy":
                entry["requires"] = REQUIRES
            entries[f"seedrows/m{m}/n{n}/{lane}"] = entry

    return entries


def all_rows(device: Union[None, str, torch.device] = None
             ) -> List[Tuple[str, float, str]]:
    """(name, us_per_call, derived) rows for ``bench.run`` CSV."""
    entries = run_grid("default", repeat=3, device=device)
    return [(name, e["seconds"] * 1e6,
             "x".join(str(int(e[d])) for d in ("m", "n", "attrs") if d in e))
            for name, e in entries.items()]
