#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. the card: present (there is no CPU path), its name and power limit
   from nvidia-smi, TF32 off for matmuls and cuDNN;
2. build: compile ``src/repro_torch/csrc/distance.cu`` with nvcc for
   sm_90a and print ptxas' registers / shared memory;
3. kernel vs plain: the seed-row kernel against its plain PyTorch version
   (and a float64 evaluation) at the fleet shape m=16384, n=128 with
   k = 1, 8, 64, 256 seeds and at a ragged (1000, 37, 3), on fleet-like
   and on centred inputs, each element within its own rounding
   tolerance; results >= 0 and a seed's distance to itself 0; batched rows
   bitwise equal to per-seed rows; CUDA-event times of the kernel, the
   plain version and one PyTorch expression of the same function, beside
   the kernel's bound;
4. corpus: the 19 synthetic fault-corpus entries through
   ``AutoAnalyzer(distance_backend="kernel")`` on the card; the verdict
   snapshot must equal the committed ``VERDICTS_synthetic.json``;
5. fleet: a 16384-shard x 128-region trace with a 2048-shard compute
   straggler and an I/O hotspot, saved, loaded and analyzed on the kernel
   lane and on the exact numpy lane; the two verdicts must be equal.

Phases 4 and 5 count the kernel's launches from 0 and fail if the main
path never launched it.  The last two lines of standard output are a
``{"kernels": [...]}`` JSON line and ``{"ok": true, "device": {...}}``.

The phases are importable functions, so the CPU tests rehearse them at a
small size with ``device="cpu"``; ``main()`` itself refuses to run
without a card.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet) at its full 700 W:
# the kernel's bound is the larger of bytes over the memory rate and
# operations over the float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

FLEET_M, FLEET_N = 16384, 128
KERNEL_KS = (1, 8, 64, 256)
RAGGED = (1000, 37, 3)
# The main path's launches are single-seed fetches at the fleet shape
# (each greedy round of the lockstep sweep introduces one new seed);
# that shape goes into the machine-readable kernels line.
MAIN_PATH_SHAPE = (FLEET_M, FLEET_N, 1)
TPU_KERNEL = "src/repro/kernels/distance.py:56"
KERNEL_SOURCE = "src/repro_torch/csrc/distance.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 1 ---------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- phase 3 ---------------------------------------------------------------

def kernel_inputs(m: int, n: int, k: int, device, centred: bool = False):
    """Seeded points, their float32 squared norms, and k distinct seed
    indices.  Fleet-like (``centred=False``): per-region times near 100
    with a straggler block 5x the rest, so the Gram identity cancels
    heavily.  ``centred=True``: standard-normal features whose last k rows
    copy the seeds' rows, so each seed row holds two zero distances (its
    own and its copy's) and the rounding error is small against every
    value."""
    import numpy as np
    import torch
    rng = np.random.default_rng(7919 * k + 31 * n + m + int(centred))
    if centred:
        W = rng.standard_normal((m, n))
        idx = rng.choice(m - k, size=k, replace=False).astype(np.int32)
        W[m - k:] = W[idx]
    else:
        W = 100.0 + rng.random((m, n))
        W[: m // 8] *= 5.0
        idx = rng.choice(m, size=k, replace=False).astype(np.int32)
    pts = torch.as_tensor(W, dtype=torch.float32, device=device)
    sq = (pts.double() ** 2).sum(dim=1).float()
    return pts, sq, torch.as_tensor(idx, device=device)


def bound_ms(m: int, n: int, k: int) -> tuple:
    """The least time the card could take for one call: each input read
    once (points, sq, idx), the output written once; 2n flops per output
    element for the dot product plus 3 for the epilogue."""
    nbytes = 4 * (m * n + m + k + k * m)
    flops = k * m * (2 * n + 3)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_rows(points, sq, idx):
    """One PyTorch expression of the same function (timed as a yardstick
    only; the port never calls it)."""
    il = idx.long()
    return (sq[il, None] + sq[None, :]).addmm(
        points[il], points.T, alpha=-2).clamp_min(0)


# Tolerances, in units of each element's own float32 rounding scale
# (repro_torch.kernels.distance.rounding_scale): the kernel against a
# float64 evaluation of the same inputs, and against the plain float32
# version, whose own rounding adds to the kernel's.
C_F64 = 3.0
C_PLAIN = 4.0


def _within(got, want, scale, c: float, what: str) -> tuple:
    """Max |got - want| and max |got - want| / scale; raises where an
    element exceeds its own tolerance, c times its scale."""
    err = (got.double() - want.double()).abs()
    tol = c * scale
    bad = err > tol
    if bool(bad.any()):
        s, q = (int(v) for v in bad.nonzero()[0])
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements off, e.g. (s, q) = ({s}, {q}):"
            f" got {float(got[s, q])}, want {float(want[s, q])}, "
            f"tolerance {float(tol[s, q])}")
    ratio = (err / scale)[scale > 0]
    return float(err.max()), float(ratio.max()) if ratio.numel() else 0.0


def check_kernel(m: int, n: int, k: int, device) -> dict:
    """Kernel vs plain version and vs a float64 evaluation on one shape,
    for fleet-like and for centred inputs; every element must lie within
    its own tolerance (C_F64 or C_PLAIN times its rounding scale), be >= 0,
    and a seed's distance to itself must be within tolerance of 0.
    Batched rows must equal per-seed rows bit for bit."""
    import torch
    from repro_torch.kernels import distance as D
    out = {"max_abs_err": 0.0, "max_abs_err_f64": 0.0,
           "max_ratio_plain": 0.0, "max_ratio_f64": 0.0}
    for centred in (False, True):
        pts, sq, idx = kernel_inputs(m, n, k, device, centred)
        got = D.multi_seed_rows(pts, sq, idx)
        plain = D.multi_seed_rows_ref(pts, sq, idx)
        exact = D.multi_seed_rows_ref(pts.double(), sq.double(), idx)
        if device != "cpu":
            torch.cuda.synchronize()
        scale = D.rounding_scale(sq, idx, n)
        what = f"(m, n, k) = {(m, n, k)}, centred={centred}"
        e_plain, r_plain = _within(got, plain, scale, C_PLAIN,
                                   f"kernel vs plain at {what}")
        e_f64, r_f64 = _within(got, exact, scale, C_F64,
                               f"kernel vs float64 at {what}")
        if bool((got < 0).any()):
            raise AssertionError(f"negative distances at {what}")
        seeds = torch.arange(k, device=got.device)
        own = got[seeds, idx.long()].double()
        if bool((own > C_F64 * scale[seeds, idx.long()]).any()):
            raise AssertionError(f"a seed's distance to itself is not 0 "
                                 f"at {what}: {own.tolist()}")
        per_seed = torch.cat([D.multi_seed_rows(pts, sq, idx[i:i + 1])
                              for i in range(k)])
        if not torch.equal(got, per_seed):
            raise AssertionError(f"batched rows differ from per-seed rows "
                                 f"at {what}")
        out = {"max_abs_err": max(out["max_abs_err"], e_plain),
               "max_abs_err_f64": max(out["max_abs_err_f64"], e_f64),
               "max_ratio_plain": max(out["max_ratio_plain"], r_plain),
               "max_ratio_f64": max(out["max_ratio_f64"], r_f64)}
    return out


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, from
    CUDA events after a warm-up (inputs stay in L2, as they do between
    the analyzer's rounds)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(m: int, n: int, k: int):
    """Device time per launch of the CUDA kernel alone, from
    torch.profiler's CUPTI trace (None when it records no device time).
    Back-to-back calls through the wrapper can be bound by the host's
    per-call work instead; this separates the two."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import distance as D
    pts, sq, idx = kernel_inputs(m, n, k, "cuda")
    D.multi_seed_rows(pts, sq, idx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            D.multi_seed_rows(pts, sq, idx)
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for e in prof.key_averages():
        if "multi_seed_rows_kernel" in e.key:
            total_us += e.device_time_total
            count += e.count
    return total_us / count / 1e3 if count and total_us > 0 else None


def time_kernel(m: int, n: int, k: int) -> dict:
    from repro_torch.kernels import distance as D
    pts, sq, idx = kernel_inputs(m, n, k, "cuda")
    b_ms, b_by = bound_ms(m, n, k)
    return {
        "ms": cuda_ms(lambda: D.multi_seed_rows(pts, sq, idx), 200),
        "plain_ms": cuda_ms(lambda: D.multi_seed_rows_ref(pts, sq, idx),
                            max(3, 200 // k)),
        "library_ms": cuda_ms(lambda: library_rows(pts, sq, idx), 200),
        "bound_ms": b_ms, "bound_by": b_by,
        "device_ms": kernel_device_ms(m, n, k),
    }


# -- phase 4 ---------------------------------------------------------------

def corpus_phase(device) -> dict:
    """The 19 synthetic corpus entries on the kernel lane, held to the
    committed verdict snapshot.  Returns the kernel's launch count."""
    import torch
    from repro_torch.cli.snapshot_verdicts import drift, snapshot
    from repro_torch.kernels import distance as D
    with open(ROOT / "VERDICTS_synthetic.json") as f:
        baseline = json.load(f)
    D.reset_launches()
    t0 = time.perf_counter()
    current = snapshot(0, "kernel", device)
    wall = time.perf_counter() - t0
    launches = D.LAUNCHES["multi_seed_rows"]
    bad = drift(baseline, current)
    if bad or set(current) != set(baseline):
        raise AssertionError(f"kernel-lane verdicts drifted from "
                             f"VERDICTS_synthetic.json: {bad}")
    # On the CPU (a rehearsal) the wrapper runs its plain version, which
    # launches nothing.
    if launches == 0 and torch.device(device).type == "cuda":
        raise AssertionError("the corpus never launched the kernel")
    return {"entries": len(current), "launches": launches, "wall_s": wall}


# -- phase 5 ---------------------------------------------------------------

def fleet_collector(m: int, n: int, straggler_procs: int):
    """A flat FLEET/cr1..cr<n> tree of balanced regions with distinct
    times, a compute straggler (the first ``straggler_procs`` shards do 5x
    the work of FLEET/cr<43>) and an I/O hotspot on FLEET/cr<90>, both
    region ids scaled down proportionally when n < 128."""
    from repro_torch.core import RegionBehavior, RegionTree
    from repro_torch.scenarios import FaultedSyntheticCollector, faults as F
    tree = RegionTree("FLEET")
    behaviors = {}
    for i in range(1, n + 1):
        r = tree.add(f"cr{i}")
        behaviors[r.region_id] = RegionBehavior(
            base_time=0.4 + 0.6 * ((7 * i) % n) / n, flops_per_s=2e9,
            vmem_pressure=0.02, hbm_intensity=0.02, host_bytes=1e6,
            comm_bytes=1e7)
    slow = f"FLEET/cr{max(1, 43 * n // 128)}"
    hot = f"FLEET/cr{max(2, 90 * n // 128)}"
    faults = (F.ComputeStraggler(slow, procs=tuple(range(straggler_procs)),
                                 factor=5.0),
              F.IOHotspot(hot, extra_bytes=100e9, slowdown=6.0))
    return tree, FaultedSyntheticCollector(tree, behaviors, faults, seed=0,
                                           n_processes=m), (slow, hot)


def host_breakdown(fn) -> list:
    """(cumulative s, calls, function) of the port's functions that took
    longest in one call of ``fn``, from cProfile — where the host's time
    goes (cProfile's per-call cost inflates Python-heavy rows)."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    rows = [(v[3], v[1], f"{pathlib.Path(k[0]).name}:{k[2]}")
            for k, v in pstats.Stats(prof).stats.items()
            if "repro_torch" in k[0]]
    return sorted(rows, reverse=True)[:14]


def fleet_phase(m: int, n: int, straggler_procs: int, device) -> dict:
    """Save -> load -> analyze the fleet trace on both lanes; the verdict
    docs must be equal and the kernel lane must have launched the kernel."""
    import torch
    from repro_torch.core import AutoAnalyzer, RegionTrace, tree_from_schema
    from repro_torch.kernels import distance as D
    _, collector, planted = fleet_collector(m, n, straggler_procs)
    with tempfile.TemporaryDirectory() as tmp:
        path = collector.collect_trace().save(str(pathlib.Path(tmp) / "t.npz"))
        trace = RegionTrace.load(path)
    tree = tree_from_schema(trace.schema)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    D.reset_launches()
    t0 = time.perf_counter()
    res_k = AutoAnalyzer(tree, distance_backend="kernel",
                         device=device).analyze_trace(trace)
    if on_card:
        torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    launches = D.LAUNCHES["multi_seed_rows"]
    t0 = time.perf_counter()
    res_n = AutoAnalyzer(tree, distance_backend="numpy").analyze_trace(trace)
    wall_n = time.perf_counter() - t0
    doc_k, doc_n = res_k.verdict.doc(), res_n.verdict.doc()
    if doc_k != doc_n:
        raise AssertionError(f"fleet verdicts differ between lanes:\n"
                             f"kernel {doc_k}\nnumpy  {doc_n}")
    if launches == 0 and on_card:
        raise AssertionError("the fleet analysis never launched the kernel")
    named = set(doc_n["dissimilarity_paths"]) | set(doc_n["disparity_paths"])
    # A third, profiled kernel-lane analysis (not in the walls above).
    analyzer = AutoAnalyzer(tree, distance_backend="kernel", device=device)
    breakdown = host_breakdown(
        lambda: (analyzer.analyze_trace(trace),
                 on_card and torch.cuda.synchronize()))
    return {
        "shape": [m, n], "planted": list(planted),
        "dissimilarity_ccrs": doc_n["dissimilarity_ccr_paths"],
        "disparity_ccrs": doc_n["disparity_ccr_paths"],
        "causes": doc_n["cause_attributes"],
        "planted_named": all(p in named for p in planted),
        "kernel_lane_s": wall_k, "numpy_lane_s": wall_n,
        "launches": launches, "breakdown": breakdown,
        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                 if on_card else None),
    }


# -- driver ----------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the "
              "card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    # 1. the card
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    lib = build.load_library("distance")
    log(f"[2] built {lib.path.name} in {time.perf_counter() - t0:.1f} s "
        f"({'fresh' if lib.built else 'cached'} build); ptxas:")
    for line in lib.ptxas_log.splitlines():
        if "registers" in line or "Compiling" in line or "spill" in line:
            log("    " + line.strip())

    # 3. kernel vs plain
    timings = {}
    for m, n, k in [(FLEET_M, FLEET_N, k) for k in KERNEL_KS] + [RAGGED]:
        err = check_kernel(m, n, k, "cuda")
        t = time_kernel(m, n, k)
        timings[(m, n, k)] = {**err, **t}
        log(f"[3] m={m} n={n} k={k}: max|kernel-plain| "
            f"{err['max_abs_err']:.6g} (at most {err['max_ratio_plain']:.3f}"
            f" of an element's scale; tolerance {C_PLAIN}), max|kernel-f64| "
            f"{err['max_abs_err_f64']:.6g} (at most "
            f"{err['max_ratio_f64']:.3f}; tolerance {C_F64}); kernel "
            f"{t['ms']:.6f} ms, plain {t['plain_ms']:.6f} ms, library "
            f"{t['library_ms']:.6f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}); kernel device time (profiler) "
            f"{t['device_ms']} ms; batched == per-seed bitwise")

    # 4. corpus on the kernel lane
    corpus = corpus_phase("cuda")
    log(f"[4] corpus: {corpus['entries']} synthetic entries match "
        f"VERDICTS_synthetic.json on the kernel lane; "
        f"{corpus['launches']} kernel launches; {corpus['wall_s']:.3f} s")

    # 5. fleet
    fleet = fleet_phase(FLEET_M, FLEET_N, 2048, "cuda")
    log(f"[5] fleet {FLEET_M}x{FLEET_N}: verdicts equal on both lanes; "
        f"dissimilarity CCRs {fleet['dissimilarity_ccrs']}, disparity "
        f"CCRs {fleet['disparity_ccrs']}, causes {fleet['causes']}; "
        f"planted {fleet['planted']} named: {fleet['planted_named']}; "
        f"kernel lane {fleet['kernel_lane_s']:.3f} s, numpy lane "
        f"{fleet['numpy_lane_s']:.3f} s; {fleet['launches']} kernel "
        f"launches; max_memory_allocated "
        f"{fleet['max_memory_allocated']} bytes")
    log("[5] kernel-lane host breakdown (cProfile, cumulative s, calls):")
    for cum, calls, name in fleet["breakdown"]:
        log(f"    {cum:10.4f} {calls:8d}  {name}")

    main_t = timings[MAIN_PATH_SHAPE]
    kernels = [{
        "name": "multi_seed_rows", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": fleet["launches"],
        "max_abs_err": max(t["max_abs_err"] for t in timings.values()),
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "device_ms": main_t["device_ms"], "shape": list(MAIN_PATH_SHAPE),
        "corpus_launches": corpus["launches"],
    }]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
