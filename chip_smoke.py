#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. the card: present (there is no CPU path), its name and power limit
   from nvidia-smi, TF32 off for matmuls and cuDNN;
2. build: compile the four ``src/repro_torch/csrc/*.cu`` sources with
   nvcc for sm_90a, one process each, started together, and print
   ptxas' registers / shared memory;
3. kernel vs plain: the seed-row kernel against its plain PyTorch version
   (and a float64 evaluation) at the fleet shape m=16384, n=128 with
   k = 1, 8, 64, 256 seeds and at a ragged (1000, 37, 3), on fleet-like
   and on centred inputs, each element within its own rounding
   tolerance; results >= 0 and a seed's distance to itself 0; batched rows
   bitwise equal to per-seed rows; the path ``seed_rows_plan`` picks for
   each shape, and the profiled CUDA symbol of each k (k = 1 on the row
   path); CUDA-event and profiler times of the kernel, the plain version
   and one PyTorch expression of the same function (``addmm``), beside
   the kernel's bound;
4. corpus: the 19 synthetic fault-corpus entries through
   ``AutoAnalyzer(distance_backend="kernel")`` on the card; the verdict
   snapshot must equal the committed ``VERDICTS_synthetic.json``; then
   the fault pin: the 2 x 4 matrix whose composite trial once split the
   lanes, clustered on the kernel lane on the card as the exact lane
   does;
5. fleet: a 16384-shard x 128-region trace with a 2048-shard compute
   straggler and an I/O hotspot, saved, loaded and analyzed on the kernel
   lane and on the exact numpy lane; the two verdicts must be equal;
6. serving kernels vs plain: RMSNorm at gemma-7b's and rwkv6-3b's decode
   rows (1, 3072) and (1, 2560), the prefill chunk (256, 3072), (300,
   3840), a d that is not a multiple of 8 (3, 3004) and an unaligned view
   (4, 2560) at one element's offset, with the path each takes, and the
   row path timed at 1, 2 and 4 vectors a thread; attention at
   gemma-7b's decode, its first 256-token prefill chunk (positions
   0..255, slots 256.. unwritten: key tiles skipped) and its second, over
   a 545-slot cache, and at danube's GQA with a 4096 window over a
   wrapped 4096-slot ring, each in float32
   (tolerance 2e-5) and bf16 (3e-2 against the float32 plain version);
   the path each attention case takes; CUDA-event and profiler times
   beside the plain version, one library call (per-call and device time;
   for RMSNorm also ``F.rms_norm`` on the bf16 rows themselves) and the
   bound;
7. model parity: gemma-7b's full width cut to 2 layers, float32, seeded
   weights on the host and a copy on the card; a 16-token prefill chunk
   and 4 greedy decode steps on each; logits within 1e-4 of their scale,
   greedy tokens equal;
8. serving: gemma-7b FULL in bf16 through ``repro_torch.launch.serve``
   (4 lanes, 8 requests of 512 prompt tokens in 256-token chunks and 32
   generated tokens), every model call launching 57 RMSNorms and 28
   attentions; one lane's decode call profiled; the served trace
   analyzed on the kernel and numpy lanes with equal verdicts;
9. WKV-6 kernel vs plain: rwkv6-3b's decode shape (B=1, T=1, H=40,
   dh=64) from a non-zero state on the decode kernel, and on the
   sequential kernel T = 64, T = 512 (the reference's
   chunked threshold, where the output is rounded to r's dtype) and a
   ragged (2, 100, 4, 16); decays of the model's form and long-memory
   ones; float32 and bf16 r/k/v; output and final state within 2e-5 of
   their scale; CUDA-event and profiler times beside the plain version
   and the bound (no single PyTorch call computes WKV-6);
10. rwkv parity: rwkv6-3b's full width cut to 2 layers, float32, card vs
   host; a 64-token call then 4 greedy per-token steps carrying the
   state; logits within 1e-4 of their scale, greedy tokens equal;
11. serving: rwkv6-3b FULL in bf16 through ``repro_torch.launch.serve``
   (4 lanes, 8 requests of 64 prompt tokens, 16 generated, one token per
   call), every model call launching 65 RMSNorms and 32 WKV-6s; one
   lane's decode call profiled (its RMSNorms on the row-per-block kernel,
   its WKV-6s on the decode kernel); the served trace analyzed on both
   lanes with equal verdicts.  The server spools its steps to
   ``build/spool_rwkv`` (``--spool-dir``) while a child process started
   before it, ``python -m repro_torch.cli.watch_trace build/spool_rwkv
   --follow --json --device cuda``, tails the spool on the kernel lane:
   the child exits 0, prints a window verdict before the server's last
   engine step, its verdicts equal the exact lane's replay of the
   finalized spool, and the finalized spool is the served trace; each
   window's lag from its segment's flush is printed;
12. runtime collector: ``runtime/compute-straggler`` and
   ``runtime/data-skew`` through the port's corpus on the card, kernel
   lane, each naming rt/solver; each region's wall, CUDA-event device
   time, ``cost_of`` FLOPs and bytes and H100 roofline bound;
13. the fleet shape streamed: phase 5's collector for 4 steps, the
   straggler's onset at step 2, spooled one step a segment under
   ``build/spool_fleet`` (deleted after), read by ``OnlineAnalyzer`` in
   2-step windows with persist 1 on the kernel and numpy lanes: equal
   window verdicts, dissimilarity onset window 1 on both;
14. chaos and fleet: the five spool ``chaos/*`` and three ``fleet/*``
   corpus entries at seeds 0, 1 and 7 on the kernel lane, each passing
   with the reference's outcome (``CHAOS_OUTCOMES``).

Phases 4, 5, 8, 11, 12, 13 and 14 count the kernels' launches from 0 and
fail if the main path never launched them (phase 11's tail counts its own
in the child); they also record the seed-row launches by
seed count k (``SEED_COUNTS``) and the kernel lane's candidacies that its
float32 error bound could not settle and re-decided on the exact lane
(``AutoAnalyzer.decisions``).  A served trace whose verdicts differ
between the lanes is saved under ``build/split_traces/`` (the path
printed) before the phase raises.  The last two lines of standard output are a
``{"kernels": [...]}`` JSON line and ``{"ok": true, "device": {...}}``.

The phases are importable functions, so the CPU tests rehearse them at a
small size with ``device="cpu"``; ``main()`` itself refuses to run
without a card.
"""
from __future__ import annotations

import importlib
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Tolerances of the seed-row kernel, in units of each element's own float32
# rounding scale (repro_torch.kernels.distance.rounding_scale): the kernel
# against a float64 evaluation of the same inputs (C_F64), and against the
# plain float32 version, whose own rounding adds to the kernel's
# (C_PLAIN).  The kernel lane's decision bound is built on the same
# constants, so a kernel whose error grows fails here first.
from repro_torch.kernels.distance import C_F64, C_PLAIN  # noqa: E402

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
KERNEL_SOURCES = ("distance", "rmsnorm", "flash_attention", "wkv6")
TPU_KERNELS = {"rmsnorm": "src/repro/kernels/rmsnorm.py:23",
               "flash_attention": "src/repro/kernels/flash_attention.py:84",
               "wkv6": "src/repro/kernels/rwkv6_scan.py:69"}
# The CUDA symbols of each ported kernel.  Every wrapper call launches one
# of its entry kernels (one per path of the kernel's plan); the attention's
# split-K decode path then launches its merge kernel (FOLLOWERS: follower
# -> the entry it follows).
ENTRY_SYMBOLS = {
    "multi_seed_rows": ("seed_row_kernel", "seed_tile_kernel"),
    "rmsnorm": ("rmsnorm_row_kernel", "rmsnorm_kernel"),
    "flash_attention": ("flash_attention_split_kernel",
                        "flash_attention_wgmma_kernel",
                        "flash_attention_kernel"),
    "wkv6": ("wkv6_decode_kernel", "wkv6_kernel")}
# The entry kernel each decode call of the served models must run: one
# token per call is the row-per-block RMSNorm and the decode WKV-6.
DECODE_SYMBOLS = {"rmsnorm": "rmsnorm_row_kernel",
                  "wkv6": "wkv6_decode_kernel"}
FOLLOWERS = {"flash_attention_merge_kernel": "flash_attention_split_kernel"}


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


def _symbols(kernel: str) -> tuple:
    """Every CUDA symbol of a ported kernel: its entries and followers."""
    entries = ENTRY_SYMBOLS[kernel]
    return entries + tuple(f for f, lead in FOLLOWERS.items()
                           if lead in entries)


def symbol_counts(rows) -> dict:
    """Launches and device time (us) per CUDA symbol of the ported
    kernels in profiler ``rows`` ((device time, count, key)), a key
    matching a symbol when it holds the symbol as a whole word."""
    known = {s for n in ENTRY_SYMBOLS for s in _symbols(n)}
    counts, times = {}, {}
    for t, c, key in rows:
        for sym in known & set(re.findall(r"\w+", key)):
            counts[sym] = counts.get(sym, 0) + c
            times[sym] = times.get(sym, 0.0) + t
    return {"counts": counts, "times": times}


def _profile_rows(fn, iters: int) -> list:
    """(device time us, count, key) of every profiler row with device time
    over ``iters`` calls of ``fn``, after one call outside the profile and
    a pause inside it: CUPTI can miss the kernels of the first milliseconds
    after recording starts (a run lost all 50 calls of a 0.02 ms kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.2)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(e.device_time_total, e.count, e.key)
            for e in prof.key_averages() if e.device_time_total > 0]


PROFILE_TRIES = 3


def device_ms(fn, kernel: str, iters: int = 100):
    """Device time per wrapper call of the ported kernel ``kernel``: the
    device time of all its CUDA symbols (a split-K call's split and merge
    kernels together) over ``iters`` calls of ``fn``, divided by the
    profiled launches of its entry kernels (CUPTI may list fewer); from
    torch.profiler's CUPTI trace, profiled again (``PROFILE_TRIES`` in
    all) while it lists no launch, and None when it records no device
    time.  Back-to-back calls through the wrapper can be bound by the
    host's per-call work instead; this separates the two."""
    for _ in range(PROFILE_TRIES):
        sc = symbol_counts(_profile_rows(fn, iters))
        calls = sum(sc["counts"].get(s, 0) for s in ENTRY_SYMBOLS[kernel])
        if calls:
            break
    total_us = sum(sc["times"].get(s, 0.0) for s in _symbols(kernel))
    return total_us / calls / 1e3 if calls and total_us > 0 else None


def library_device_ms(fn, iters: int = 50):
    """Device time per call of a library yardstick: every profiler row
    with device time over ``iters`` calls of ``fn`` (all the kernels and
    copies it launches), divided by ``iters``."""
    return sum(t for t, _, _ in _profile_rows(fn, iters)) / iters / 1e3


# The CUDA symbol each path of seed_rows_plan launches.
SEED_ROWS_SYMBOLS = {"row": "seed_row_kernel", "tile": "seed_tile_kernel"}


def time_kernel(m: int, n: int, k: int) -> dict:
    """CUDA-event and profiler times of the kernel, its plain version and
    the ``addmm`` expression, the bound, the plan, and the CUDA symbols
    one profiled window of the kernel lists (held to the plan's path)."""
    from repro_torch.kernels import distance as D
    pts, sq, idx = kernel_inputs(m, n, k, "cuda")
    b_ms, b_by = bound_ms(m, n, k)
    plan = D.seed_rows_plan(m, n, k)     # buffers from the allocator align

    def kernel():
        return D.multi_seed_rows(pts, sq, idx)

    def library():
        return library_rows(pts, sq, idx)
    for _ in range(PROFILE_TRIES):
        symbols = symbol_counts(_profile_rows(kernel, 20))["counts"]
        if symbols:
            break
    if set(symbols) != {SEED_ROWS_SYMBOLS[plan.path]}:
        raise AssertionError(f"(m, n, k) = {(m, n, k)} plans the "
                             f"{plan.path} path but the profiler lists "
                             f"{symbols}")
    return {
        "ms": cuda_ms(kernel, 200),
        "plain_ms": cuda_ms(lambda: D.multi_seed_rows_ref(pts, sq, idx),
                            max(3, 200 // k)),
        "library_ms": cuda_ms(library, 200),
        "library_device_ms": library_device_ms(library),
        "bound_ms": b_ms, "bound_by": b_by,
        "device_ms": device_ms(kernel, "multi_seed_rows"),
        "plan": plan._asdict(), "symbols": symbols,
    }


# -- phase 4 ---------------------------------------------------------------

def corpus_phase(device) -> dict:
    """The 19 synthetic corpus entries on the kernel lane, held to the
    committed verdict snapshot.  Returns the kernel's launch count, its
    launches by seed count and the lane's re-decided candidacies."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.cli.snapshot_verdicts import drift, snapshot
    from repro_torch.core.clustering import get_distance_backend
    with open(ROOT / "VERDICTS_synthetic.json") as f:
        baseline = json.load(f)
    backend = get_distance_backend("kernel", device)
    K.reset_launches()
    t0 = time.perf_counter()
    current = snapshot(0, backend, device)
    wall = time.perf_counter() - t0
    launches = K.LAUNCHES["multi_seed_rows"]
    seed_counts = dict(K.SEED_COUNTS)
    bad = drift(baseline, current)
    if bad or set(current) != set(baseline):
        raise AssertionError(f"kernel-lane verdicts drifted from "
                             f"VERDICTS_synthetic.json: {bad}")
    # On the CPU (a rehearsal) the wrapper runs its plain version, which
    # launches nothing.
    if launches == 0 and torch.device(device).type == "cuda":
        raise AssertionError("the corpus never launched the kernel")
    return {"entries": len(current), "launches": launches, "wall_s": wall,
            "seed_counts": seed_counts, "decisions": dict(backend.decisions)}


# The (m, n) matrix of a CPU-timed serving trace on which the kernel lane
# once split from the exact lane: zeroing columns 0 and 1 together leaves
# an exact D² of 5.68e-8 against a squared radius of 2.62e-9, and float32
# base rows of norm 0.71 put it at about 0.
FAULT_PIN = ((1.4126013409999993, 0.8884826409999995, 0.0,
              5.1191000056860503e-04),
             (0.67398050800000009, 0.48293688799999934, 0.0,
              2.7357000044503366e-04))


def fault_pin_phase(device) -> dict:
    """The fault pin through ``IncrementalClusterState`` on the kernel lane
    (cluster_batch, the lockstep rounds, and push/cluster, the host pass)
    and on the exact lane: the partitions must be equal, 2 clusters."""
    import numpy as np
    from repro_torch.core import IncrementalClusterState
    from repro_torch.core.clustering import get_distance_backend
    W = np.array(FAULT_PIN)
    out = {}
    for lane in ("kernel", "numpy"):
        backend = get_distance_backend(lane, device)
        st = IncrementalClusterState(W, backend=backend)
        batch = st.cluster_batch([([0, 1], 0.0)])[0]
        st.push([0, 1], 0.0)
        pushed = st.cluster()
        out[lane] = (batch, pushed, st.fetch_stats)
    want = out["numpy"][0]
    for res in out["kernel"][:2]:
        if not (res.n_clusters == want.n_clusters == 2
                and res.same_partition(want)):
            raise AssertionError(f"fault pin: the kernel lane gives "
                                 f"{res.n_clusters} clusters, the exact "
                                 f"lane {want.n_clusters}")
    stats = out["kernel"][2]
    return {"n_clusters": want.n_clusters, "flagged": stats["flagged"],
            "redecided": stats["redecided"]}


# -- phase 5 ---------------------------------------------------------------

def fleet_collector(m: int, n: int, straggler_procs: int,
                    n_steps: int = 1, onset_step: int | None = None):
    """A flat FLEET/cr1..cr<n> tree of balanced regions with distinct
    times, a compute straggler (the first ``straggler_procs`` shards do 5x
    the work of FLEET/cr<43>) and an I/O hotspot on FLEET/cr<90>, both
    region ids scaled down proportionally when n < 128.  With
    ``onset_step`` the straggler's shards run at full speed until that
    step and then slow down toward 5x by the last of ``n_steps`` (the
    ``ThermalThrottleDrift`` archetype); the hotspot stands from step 0."""
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
    procs = tuple(range(straggler_procs))
    straggler = (F.ComputeStraggler(slow, procs=procs, factor=5.0)
                 if onset_step is None else
                 F.ThermalThrottleDrift(slow, procs=procs, peak_factor=5.0,
                                        onset_step=onset_step))
    faults = (straggler, F.IOHotspot(hot, extra_bytes=100e9, slowdown=6.0))
    return tree, FaultedSyntheticCollector(tree, behaviors, faults, seed=0,
                                           n_processes=m,
                                           n_steps=n_steps), (slow, hot)


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
    from repro_torch import kernels as K
    from repro_torch.core import AutoAnalyzer, RegionTrace, tree_from_schema
    _, collector, planted = fleet_collector(m, n, straggler_procs)
    with tempfile.TemporaryDirectory() as tmp:
        path = collector.collect_trace().save(str(pathlib.Path(tmp) / "t.npz"))
        trace = RegionTrace.load(path)
    tree = tree_from_schema(trace.schema)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    an_k = AutoAnalyzer(tree, distance_backend="kernel", device=device)
    res_k = an_k.analyze_trace(trace)
    if on_card:
        torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    launches = K.LAUNCHES["multi_seed_rows"]
    seed_counts = dict(K.SEED_COUNTS)
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
        "launches": launches, "seed_counts": seed_counts,
        "decisions": dict(an_k.decisions), "breakdown": breakdown,
        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                 if on_card else None),
    }


# -- phase 6 ---------------------------------------------------------------

# The serving path's shapes (gemma-7b FULL, bf16, at --prompt-len 512
# --chunk 256 --gen 32: a 545-slot cache; rwkv6-3b's d = 2560) and
# danube's GQA + window.
RMS_EPS = 1e-6
# (N, d, offset): the rows start ``offset`` elements into their buffer.
# The decode rows of gemma-7b and rwkv6-3b and the prefill chunk, a wider
# d over more rows, a d that is not a multiple of 8 (the scalar path in
# bf16, a vector path in float32) and an unaligned view (the scalar path).
RMS_SHAPES = ((1, 3072, 0), (1, 2560, 0), (256, 3072, 0), (300, 3840, 0),
              (3, 3004, 0), (4, 2560, 1))
# Timed in bf16: the shapes the served models launch, and (300, 3840).
RMS_TIMED = ((1, 3072), (1, 2560), (256, 3072), (300, 3840))
GEMMA_SLOTS = 545
UNWRITTEN = 2 ** 30
ATTN_CASES = ("gemma-decode", "gemma-prefill", "danube-decode",
              "danube-prefill", "gemma-prefill-first")
# The main path launches the decode shapes most (57 and 28 launches per
# decode call, 8 x 32 decode calls against 16 prefill chunks); those go
# into the machine-readable kernels line, the prefill shapes beside them
# (and rwkv6-3b's decode rows beside gemma-7b's).
RMS_MAIN, RMS_PREFILL, RMS_RWKV = (1, 3072), (256, 3072), (1, 2560)
ATTN_MAIN, ATTN_PREFILL = "gemma-decode", "gemma-prefill"
# Tolerances of the kernels against their plain versions, |got - want| <=
# tol + tol * |want| per element: float32 at the reference kernel tests'
# 2e-5; bf16 kernels against the float32 plain version of the same
# (bf16-rounded) inputs at tests/test_kernels.py's bf16 3e-2.  Both sides
# of the bf16 check compute in float32, so the kernel may add only the
# rounding of its output: each element is also held to half a bf16 ulp,
# |got - want| <= 2^-8 * |want| + BF16_ROUND_ATOL.
F32_TOL, BF16_TOL = 2e-5, 3e-2
BF16_ROUND_ATOL = 1e-3
BF16_FLOP_PER_S = 989e12


def attention_case(name: str) -> dict:
    """Shape and positions of one attention check.  gemma: H = KV = 16,
    dh = 256 over the 545-slot cache; decode at position 272 with slots
    273.. unwritten, prefill of the first 256-token chunk (positions
    0..255 over written slots 0..255, slots 256..544 unwritten: the main
    path's first chunk, where key tiles are skipped) and of the second
    (positions 256..511 over written slots 0..511).  danube: H = 32,
    KV = 8, dh = 120, window 4096 over a 4096-slot ring at position 5000
    (slot i holds position i + 4096 for i <= 904, else i), decode and a
    256-token chunk ending there."""
    import numpy as np
    if name.startswith("gemma"):
        Q, written = {"gemma-decode": (1, 273), "gemma-prefill": (256, 512),
                      "gemma-prefill-first": (256, 256)}[name]
        k_pos = np.full(GEMMA_SLOTS, UNWRITTEN, np.int64)
        k_pos[:written] = np.arange(written)
        q_pos = np.arange(written - Q, written)
        return dict(H=16, KV=16, dh=256, window=None, q_pos=q_pos,
                    k_pos=k_pos)
    slots, last = 4096, 5000
    i = np.arange(slots)
    k_pos = np.where(i <= last - slots, i + slots, i)
    Q = 1 if name == "danube-decode" else 256
    return dict(H=32, KV=8, dh=120, window=4096,
                q_pos=np.arange(last - Q + 1, last + 1), k_pos=k_pos)


def attention_shape(name: str) -> list:
    """[B, Q, H, KV, dh, K] of one attention case."""
    c = attention_case(name)
    return [1, len(c["q_pos"]), c["H"], c["KV"], c["dh"], len(c["k_pos"])]


def rmsnorm_inputs(n: int, d: int, dtype, device, offset: int = 0):
    """Seeded x (N, d) and w (d,); x is a contiguous view ``offset``
    elements into a flat buffer (unaligned for an offset of 1)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(7919 * n + d)
    x = 2.0 * rng.standard_normal(n * d + offset) + 0.5
    w = 0.1 * rng.standard_normal(d)
    return (torch.as_tensor(x, dtype=dtype, device=device)[offset:]
            .view(n, d), torch.as_tensor(w, dtype=dtype, device=device))


def attention_inputs(name: str, dtype, device):
    import numpy as np
    import torch
    c = attention_case(name)
    rng = np.random.default_rng(ATTN_CASES.index(name) + 17)
    Q, K = len(c["q_pos"]), len(c["k_pos"])
    q = rng.standard_normal((1, Q, c["H"], c["dh"]))
    k = rng.standard_normal((1, K, c["KV"], c["dh"]))
    v = rng.standard_normal((1, K, c["KV"], c["dh"]))
    ts = [torch.as_tensor(a, dtype=dtype, device=device) for a in (q, k, v)]
    pos = [torch.as_tensor(a, dtype=torch.int32, device=device)
           for a in (c["q_pos"], c["k_pos"])]
    return (*ts, *pos), c["window"]


def _close(got, want, tol: float, what: str) -> float:
    """Max |got - want|; raises where an element is off by more than
    tol + tol * |want|, or, for a bf16 result, by more than its output
    rounding."""
    import torch
    err = (got.float() - want.float()).abs()
    bad = err > tol + tol * want.float().abs()
    if got.dtype == torch.bfloat16:
        bad |= err > 2.0 ** -8 * want.float().abs() + BF16_ROUND_ATOL
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} of {bad.numel()} "
                             f"elements off, max |err| {float(err.max())}")
    return float(err.max())


def rmsnorm_plan_of(n: int, d: int, dtype, offset: int = 0):
    """The kernel path :func:`rmsnorm_plan` picks for one case (an offset
    view is unaligned; buffers from the allocator are aligned)."""
    from repro_torch.kernels.rmsnorm import rmsnorm_plan
    return rmsnorm_plan(n, d, dtype, aligned=offset == 0)


def check_rmsnorm(n: int, d: int, device, offset: int = 0) -> dict:
    """The kernel against its plain version, float32 and bf16."""
    import torch
    from repro_torch import kernels as K
    errs = {}
    for dtype, tol, tag in ((torch.float32, F32_TOL, "f32"),
                            (torch.bfloat16, BF16_TOL, "bf16")):
        x, w = rmsnorm_inputs(n, d, dtype, device, offset)
        got = K.rmsnorm(x, w, RMS_EPS)
        want = K.rmsnorm_ref(x.float(), w.float(), RMS_EPS)
        if got.dtype != dtype or got.shape != x.shape:
            raise AssertionError(f"rmsnorm gave {got.dtype} {got.shape}")
        errs[tag] = _close(got, want, tol,
                           f"rmsnorm ({n}, {d}) offset {offset} {tag}")
    return errs


def check_attention(name: str, device) -> dict:
    """The kernel against its plain version, float32 and bf16."""
    import torch
    from repro_torch import kernels as K
    errs = {}
    for dtype, tol, tag in ((torch.float32, F32_TOL, "f32"),
                            (torch.bfloat16, BF16_TOL, "bf16")):
        (q, k, v, qp, kp), window = attention_inputs(name, dtype, device)
        got = K.flash_attention(q, k, v, qp, kp, causal=True, window=window)
        want = K.flash_attention_ref(q.float(), k.float(), v.float(), qp, kp,
                                     causal=True, window=window)
        if got.dtype != dtype or got.shape != q.shape:
            raise AssertionError(f"attention gave {got.dtype} {got.shape}")
        errs[tag] = _close(got, want, tol, f"attention {name} {tag}")
    return errs


def rmsnorm_bound_ms(n: int, d: int, itemsize: int) -> tuple:
    """x and w read once, y written once; 4 float32 operations an
    element (square-add, scale, 1 + w, product)."""
    t_bytes = (2 * n * d + d) * itemsize / HBM_BYTES_PER_S
    t_ops = 4 * n * d / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def needed_keys(live) -> int:
    """Keys whose k and v the function must read, from the (Q, K) mask of
    live pairs: those live for some query, or all K when a query has no
    live key (it averages v over every key)."""
    import numpy as np
    if not live.any(axis=1).all():
        return live.shape[1]
    return int(np.count_nonzero(live.any(axis=0)))


def attention_bound_ms(name: str, itemsize: int) -> tuple:
    """q, the k and v of the keys the function needs (``needed_keys``) and
    the positions read once, the output written once; 4·dh operations
    (score and P·V) for every unmasked (query, key, head) of this case's
    positions, at the tensor-core rate for bf16 and the float32 rate
    otherwise."""
    import numpy as np
    c = attention_case(name)
    Q, K = len(c["q_pos"]), len(c["k_pos"])
    qp, kp = c["q_pos"][:, None], c["k_pos"][None, :]
    live = kp <= qp
    if c["window"] is not None:
        live &= kp > qp - c["window"]
    nbytes = (itemsize * (2 * Q * c["H"] * c["dh"]
                          + 2 * needed_keys(live) * c["KV"] * c["dh"])
              + 4 * (Q + K))
    ops = 4 * c["dh"] * c["H"] * int(np.count_nonzero(live))
    rate = BF16_FLOP_PER_S if itemsize == 2 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_rmsnorm(n: int, d: int) -> dict:
    """bf16 (the served dtype): the kernel, its plain version and two
    library calls (timed only): ``F.rms_norm`` on float32 copies with
    weight 1 + w (the function's float32 arithmetic; per call and device
    time), and ``F.rms_norm`` on the bf16 rows with weight (1 + w) rounded
    to bf16 (the bytes the kernel moves; device time).  Beside them the
    scalar path (the kernel's first design, two passes over the row)
    forced on the same rows, the redesign's gain measured in the same run,
    and one PyTorch
    copy of x into a tensor of its shape (device time): what the card
    takes in practice to read x and write y, with no arithmetic."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K
    RN = importlib.import_module("repro_torch.kernels.rmsnorm")
    x, w = rmsnorm_inputs(n, d, torch.bfloat16, "cuda")
    out = torch.empty_like(x)
    scalar = RN.RmsnormPlan("scalar", RN.SCALAR_THREADS, 0)
    xf, w1 = x.float(), 1.0 + w.float()
    w1b = (1.0 + w).to(x.dtype)
    b_ms, b_by = rmsnorm_bound_ms(n, d, 2)

    def library():
        return F.rms_norm(xf, (d,), w1, RMS_EPS)

    def library_bf16():
        return F.rms_norm(x, (d,), w1b, RMS_EPS)
    return {
        "ms": cuda_ms(lambda: K.rmsnorm(x, w, RMS_EPS), 200),
        "device_ms": device_ms(lambda: K.rmsnorm(x, w, RMS_EPS), "rmsnorm"),
        "plain_ms": cuda_ms(lambda: K.rmsnorm_ref(x, w, RMS_EPS), 200),
        "library_ms": cuda_ms(library, 200),
        "library_device_ms": library_device_ms(library),
        "library_bf16_device_ms": library_device_ms(library_bf16),
        "scalar_device_ms": device_ms(
            lambda: RN._launch(x, w, out, RMS_EPS, scalar), "rmsnorm"),
        "copy_device_ms": library_device_ms(lambda: out.copy_(x)),
        "bound_ms": b_ms, "bound_by": b_by,
        "plan": rmsnorm_plan_of(n, d, torch.bfloat16)._asdict(),
    }


# The shapes at which phase 6 times the row path at every vector count a
# thread (the evidence for rmsnorm_plan's choice): the decode row and two
# row counts above SMS.
RMS_SWEEP = ((1, 3072), (256, 3072), (300, 3840))


def rmsnorm_sweep(n: int, d: int) -> dict:
    """bf16 device time per call of the row path with each thread owning
    1, 2 or 4 vectors of the row."""
    import torch
    RN = importlib.import_module("repro_torch.kernels.rmsnorm")
    x, w = rmsnorm_inputs(n, d, torch.bfloat16, "cuda")
    out = torch.empty_like(x)
    nv = d * 2 // RN.VEC_BYTES
    res = {}
    for items in RN.ITEMS:
        threads = (-(-nv // items) + 31) // 32 * 32
        plan = RN.RmsnormPlan("row", threads, items)
        if plan.threads <= RN.MAX_THREADS:
            res[f"items={items} threads={plan.threads}"] = device_ms(
                lambda: RN._launch(x, w, out, RMS_EPS, plan), "rmsnorm")
    return res


def attention_plan_of(name: str, dtype):
    """The kernel path :func:`attention_plan` picks for one case."""
    from repro_torch.kernels.flash_attention import attention_plan
    B, Q, H, KV, dh, K = attention_shape(name)
    return attention_plan(B, Q, H, KV, dh, K, dtype)


def time_attention(name: str) -> dict:
    """bf16: the kernel, its plain version and one library call,
    ``F.scaled_dot_product_attention`` with a boolean mask built from the
    positions over k/v repeated to the query heads (timed only, per call
    and on the device)."""
    import math
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K
    (q, k, v, qp, kp), window = attention_inputs(name, torch.bfloat16,
                                                 "cuda")
    g = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2).contiguous()
    kh = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    mask = kp[None, :] <= qp[:, None]
    if window is not None:
        mask &= kp[None, :] > qp[:, None] - window
    scale = 1.0 / math.sqrt(q.shape[3])
    b_ms, b_by = attention_bound_ms(name, 2)

    def kernel():
        return K.flash_attention(q, k, v, qp, kp, causal=True, window=window)

    def plain():
        return K.flash_attention_ref(q, k, v, qp, kp, causal=True,
                                     window=window)

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              scale=scale)
    plan = attention_plan_of(name, torch.bfloat16)
    return {
        "ms": cuda_ms(kernel, 100),
        "device_ms": device_ms(kernel, "flash_attention", 50),
        "plain_ms": cuda_ms(plain, 20), "library_ms": cuda_ms(library, 100),
        "library_device_ms": library_device_ms(library),
        "bound_ms": b_ms, "bound_by": b_by, "plan": plan._asdict(),
    }


# -- phase 7 ---------------------------------------------------------------

# Logits of the card's kernel path against the host's plain path, both
# float32 with TF32 off: max |card - host| <= PARITY_RTOL * max |host|.
# The two differ only in summation order (cuBLAS and the kernels against
# the CPU's BLAS and the plain versions), about 1e-6 of the logits' scale.
PARITY_RTOL = 1e-4


def parity_config(arch: str = "gemma-7b"):
    """``arch`` at full width, cut to 2 layers, in float32."""
    from repro_torch.configs import get_arch
    return get_arch(arch).full.with_(
        n_layers=2, dtype="float32", param_dtype="float32")


def launches_per_call(cfg) -> dict:
    """The kernel launches of one model call of ``cfg`` on the card: two
    RMSNorms a block and the final one, and one attention (dense) or WKV-6
    (ssm) a block; no other kernel."""
    mixer = "wkv6" if cfg.family == "ssm" else "flash_attention"
    return {"rmsnorm": 2 * cfg.n_layers + 1, mixer: cfg.n_layers}


def _check_launches(launches: dict, cfg, calls: int, what: str) -> None:
    """Every kernel launched exactly ``calls`` times its per-call count,
    the others not at all."""
    from repro_torch import kernels as K
    want = {name: 0 for name in K.LAUNCHES}
    want.update({k: n * calls for k, n in launches_per_call(cfg).items()})
    if launches != want or calls == 0:
        raise AssertionError(f"{what} launched {launches}, want {want} for "
                             f"{calls} model calls")


def model_parity_phase(cfg, device, chunk: int = 16, steps: int = 4,
                       seed: int = 0) -> dict:
    """Seeded weights on the host, copied to ``device``; a ``chunk``-token
    prefill then ``steps`` greedy decode steps on each, each side feeding
    its own greedy tokens.  Logits must agree within PARITY_RTOL of their
    scale and the greedy tokens must be equal; on the card every model
    call must launch 2L+1 RMSNorms and L attentions or WKV-6s."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.models.transformer import Transformer
    host = Transformer(cfg, "cpu", seed)
    card = Transformer(cfg, device, seed=None)
    card.load_state_dict(host.state_dict())
    prompt = np.random.default_rng(seed + 11).integers(
        0, cfg.vocab, size=(1, chunk), dtype=np.int32)
    out = {}
    for side, model in (("card", card), ("host", host)):
        dev = model.device
        K.reset_launches()
        state = model.init_decode_state(1, chunk + steps + 1)
        logits, _ = model.decode_step(
            state, torch.as_tensor(prompt, device=dev),
            torch.arange(chunk, dtype=torch.int32, device=dev))
        rows = [logits[0].cpu()]
        tokens = []
        for i in range(steps + 1):
            tokens.append(int(rows[-1][-1].argmax()))
            if i == steps:
                break
            logits, _ = model.decode_step(
                state, torch.tensor([[tokens[-1]]], dtype=torch.int32,
                                    device=dev), chunk + i)
            rows.append(logits[0].cpu())
        out[side] = (torch.cat(rows), tokens, dict(K.LAUNCHES))
    (card_rows, card_tokens, launches), (host_rows, host_tokens, _) = \
        out["card"], out["host"]
    if not bool(torch.isfinite(card_rows).all()):
        raise AssertionError("non-finite logits on the card")
    err = float((card_rows - host_rows).abs().max())
    scale = float(host_rows.abs().max())
    if err > PARITY_RTOL * scale:
        raise AssertionError(f"model parity: max |card - host| {err} above "
                             f"{PARITY_RTOL} x {scale}")
    if card_tokens != host_tokens:
        raise AssertionError(f"greedy tokens differ: card {card_tokens}, "
                             f"host {host_tokens}")
    calls = steps + 1
    if torch.device(device).type == "cuda":
        _check_launches(launches, cfg, calls, "model parity run")
    return {"max_abs_err": err, "logit_scale": scale, "tokens": card_tokens,
            "launches": launches, "calls": calls}


# -- phase 8 ---------------------------------------------------------------

SERVE_ARGV = ("--arch", "gemma-7b", "--lanes", "4", "--requests", "8",
              "--prompt-len", "512", "--chunk", "256", "--gen", "32",
              "--arrival-rate", "2.0", "--seed", "0")


# A phase whose wall time is this many ticks of the trace's CPU clock
# reads a raw CPU time of 0 with a chance below e**-20 (each call's reading
# crosses a tick with odds of its length over the tick), so its raw CPU
# time is held to be positive.
RAW_CPU_TICKS = 20


def check_phase_times(trace, tree, phases) -> None:
    """Wall and CPU time of every serving phase, finite and positive.

    A CPU clock may advance in ticks (10 ms on some hosts) longer than a
    whole phase (the sampling region's 256 calls of about 0.03 ms), whose
    raw CPU reading is then 0 by chance; the trace records the tick, and
    ``RegionTrace.reduce`` snaps such readings to wall.  So each phase's
    raw CPU time must be positive where its wall time spans at least
    ``RAW_CPU_TICKS`` ticks (or the trace records no tick), and only
    below that is it read after the reduction, as the analyzer reads it."""
    import numpy as np
    from repro_torch.core import CPU_TIME, WALL_TIME
    tick = trace.meta.get("cpu_tick") or 0.0
    reduced = trace.reduce()
    for phase in phases:
        rid = tree.by_path(f"serve/{phase}").region_id
        wall = trace.metric(WALL_TIME)[..., trace.col(rid)]
        cpu = trace.metric(CPU_TIME)[..., trace.col(rid)]
        for metric, col in ((WALL_TIME, wall), (CPU_TIME, cpu)):
            if not (np.isfinite(col).all() and (col >= 0).all()):
                raise AssertionError(f"serving trace: {metric} of "
                                     f"serve/{phase} is not finite and "
                                     f"non-negative")
        raw = wall.sum() >= RAW_CPU_TICKS * tick
        total = {WALL_TIME: float(wall.sum()),
                 CPU_TIME: float(cpu.sum() if raw else
                                 reduced.metric(CPU_TIME)[:, reduced.col(rid)]
                                 .sum())}
        for metric, t in total.items():
            if not t > 0:
                raise AssertionError(
                    f"serving trace: {metric} of serve/{phase} is {t} "
                    f"({'raw' if metric == WALL_TIME or raw else 'reduced'};"
                    f" CPU clock {trace.meta.get('cpu_clock')}, tick {tick}"
                    f" s)")


def serve_phase(argv, device, spool_dir: str | None = None,
                watch_interval: float | None = None) -> dict:
    """Serve the traffic through ``repro_torch.launch.serve`` with launch
    counts from 0; every model call must have launched 2L+1 RMSNorms and L
    attentions or WKV-6s (``launches_per_call``), the peak device memory
    must fit the card, every request must complete with its tokens in the
    vocabulary, and the saved serving trace, analyzed on the kernel lane
    and on the numpy lane, must give equal verdict docs.

    With ``spool_dir`` the server also spools its steps there while a
    child process tails the spool live (``LiveTail``); the result's
    ``live`` holds what the tail saw."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import AutoAnalyzer, RegionTrace, tree_from_schema
    from repro_torch.launch import serve
    on_card = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "serve.npz")
        spool = [] if spool_dir is None else ["--spool-dir", spool_dir]
        args = serve.parser().parse_args(
            [*argv, "--device", str(device), "--trace", path, *spool])
        tail = None
        if spool_dir is not None:
            shutil.rmtree(spool_dir, ignore_errors=True)
            tail = LiveTail(spool_dir, device, watch_interval)
        step_times = []
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        served = False
        try:
            engine, backend = serve.run(
                args, step_hook=lambda *_: step_times.append(time.time()))
            served = True
        finally:
            # a server that failed leaves the tail waiting: stop it (one
            # that finished closed the spool, and the tail exits itself)
            if tail is not None and not served:
                tail.proc.kill()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() if on_card else None
        trace = RegionTrace.load(path)
        live = (None if tail is None else
                tail.check(path, step_times[-1], device, tmp))
    cfg, calls = backend.cfg, backend.model_calls
    if on_card:
        _check_launches(launches, cfg, calls, "serving")
        total = torch.cuda.get_device_properties(0).total_memory
        if peak > total:
            raise AssertionError(f"peak device memory {peak} above the "
                                 f"card's {total} bytes")
    launches = {k: launches[k] for k in launches_per_call(cfg)}
    if engine.completed != args.requests or sorted(backend.outputs) != \
            list(range(args.requests)):
        raise AssertionError(f"served {engine.completed} of {args.requests}")
    for rid, toks in backend.outputs.items():
        if len(toks) != args.gen or not all(0 <= t < cfg.vocab
                                            for t in toks):
            raise AssertionError(f"request {rid} generated {toks}")
    tree = tree_from_schema(trace.schema)
    check_phase_times(trace, tree, ("prefill", "decode", "sample"))
    K.reset_launches()
    an_k = AutoAnalyzer(tree, distance_backend="kernel", device=device)
    res_k = an_k.analyze_trace(trace)
    analysis_launches = K.LAUNCHES["multi_seed_rows"]
    seed_counts = dict(K.SEED_COUNTS)
    res_n = AutoAnalyzer(tree, distance_backend="numpy").analyze_trace(trace)
    doc_k, doc_n = res_k.verdict.doc(), res_n.verdict.doc()
    if doc_k != doc_n:
        kept = ROOT / "build" / "split_traces" / f"{time.time_ns()}.npz"
        kept.parent.mkdir(parents=True, exist_ok=True)
        trace.save(str(kept))
        log(f"serving verdicts differ between lanes; the served trace is "
            f"saved to {kept}")
        raise AssertionError(f"serving verdicts differ between lanes:\n"
                             f"kernel {doc_k}\nnumpy  {doc_n}")
    return {"summary": serve.summary(engine), "wall_s": wall,
            "cpu_clock": (trace.meta.get("cpu_clock"),
                          trace.meta.get("cpu_tick")),
            "breakdown": decode_breakdown(backend) if on_card else None,
            "model_calls": calls, "launches": launches,
            "max_memory_allocated": peak, "verdict": doc_n,
            "analysis_launches": analysis_launches,
            "seed_counts": seed_counts, "decisions": dict(an_k.decisions),
            "trace_shape": [trace.n_steps, trace.n_processes,
                            len(trace.region_ids)], "live": live}


# The window line the watch command prints as it judges each window.
WINDOW_LINE = re.compile(r"^window\s+(\d+)\s+steps \[(\d+):(\d+)\)")


class LiveTail:
    """``python -m repro_torch.cli.watch_trace SPOOL --follow --json`` in a
    child process on ``device``, started before the server.  A thread
    stamps each line of the child's standard error with the host's clock
    as it arrives: one line per window as the child judges it, then the
    kernel lane's launch and re-decision counts.  ``interval`` is the
    child's poll interval (None: the command's default, 1 s), ``threads``
    its thread pools' size (None: the defaults).  The constructor returns
    once the child says it is following the spool."""

    def __init__(self, spool_dir: str, device, interval: float | None,
                 threads: int | None = None):
        self.spool_dir = spool_dir
        cmd = [sys.executable, "-m", "repro_torch.cli.watch_trace",
               spool_dir, "--follow", "--json", "--device", str(device)]
        if interval is not None:
            cmd += ["--interval", str(interval)]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src"), *filter(None, [os.environ.get(
                "PYTHONPATH")])]))
        if threads is not None:
            # the child's intra-op and BLAS thread pools
            env.update({v: str(threads) for v in (
                "OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")})
        self.proc = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE)
        self.lines: list = []
        self.out: list = []
        self.threads = [
            threading.Thread(target=lambda: self.lines.extend(
                (time.time(), ln.rstrip("\n")) for ln in self.proc.stderr)),
            threading.Thread(target=lambda: self.out.append(
                self.proc.stdout.read()))]
        for t in self.threads:
            t.start()
        # the server starts once the child is tailing (its "following"
        # line), not while it is still importing
        deadline = time.time() + 300
        while not any(ln.startswith("following ") for _, ln in self.lines):
            if self.proc.poll() is not None or time.time() > deadline:
                self.proc.kill()
                raise AssertionError(
                    f"the live tail did not start (exit {self.proc.poll()})"
                    f":\n" + "\n".join(ln for _, ln in self.lines[-20:]))
            time.sleep(0.05)

    def check(self, served_path: str, last_step_t: float, device,
              tmp: str) -> dict:
        """Wait for the child and hold what it saw: it exits 0; it printed
        a window verdict before the server's last engine step (host clock
        ``last_step_t``); its window verdicts equal the exact numpy lane's
        replay of the finalized spool; the finalized spool is the served
        trace (bytes and ``reduce()``).  Returns the windows' lags from the
        flush of the segment that completed each to its verdict line, and
        the child's kernel-lane counts."""
        import numpy as np
        import torch
        from repro_torch.core import RegionTrace
        from repro_torch.stream import OnlineAnalyzer, SpooledTrace
        rc = self.proc.wait(timeout=900)
        for t in self.threads:
            t.join()
        err = [ln for _, ln in self.lines]
        if rc != 0:
            raise AssertionError(f"the live tail exited {rc}:\n"
                                 + "\n".join(err[-20:]))
        doc = json.loads(self.out[0])
        seen = [(t, WINDOW_LINE.match(ln)) for t, ln in self.lines]
        seen = [(t, int(m.group(1)), int(m.group(3))) for t, m in seen if m]
        lane = [json.loads(ln)["lane"] for ln in err
                if ln.startswith('{"lane"')]
        if len(seen) != len(doc["windows"]) or len(lane) != 1:
            raise AssertionError(f"the live tail printed {len(seen)} window"
                                 f" lines for {len(doc['windows'])} windows:"
                                 f"\n" + "\n".join(err[-20:]))
        if not seen or not seen[0][0] < last_step_t:
            raise AssertionError(
                f"no window verdict before the server's last step: the "
                f"first came {seen[0][0] - last_step_t if seen else None} s "
                f"after it")
        sp = SpooledTrace(self.spool_dir)
        exact = OnlineAnalyzer(distance_backend="numpy").poll(sp)
        got = [(tuple(w["steps"]), w.get("verdict")) for w in doc["windows"]]
        want = [((w.start, w.stop), None if w.degraded else w.verdict.doc())
                for w in exact]
        if got != want or any(v is None for _, v in want):
            raise AssertionError(f"live window verdicts differ from the "
                                 f"exact lane's replay:\nlive  {got}\n"
                                 f"exact {want}")
        fin = sp.finalize(str(pathlib.Path(tmp) / "finalized.npz"))
        same_bytes = (pathlib.Path(fin).read_bytes()
                      == pathlib.Path(served_path).read_bytes())
        a = RegionTrace.load(fin).reduce()
        b = RegionTrace.load(served_path).reduce()
        same_reduce = all(np.array_equal(a.metric(k), b.metric(k))
                          for k in b.data)
        if not (same_bytes and same_reduce):
            raise AssertionError("the finalized spool is not the served "
                                 "trace")
        if torch.device(device).type == "cuda" and \
                lane[0]["launches"] == 0:
            raise AssertionError("the live tail never launched the kernel")
        flushed = {}
        for seg in sp.segment_records:
            t = os.stat(pathlib.Path(self.spool_dir) / seg["file"]).st_mtime
            for step in range(seg["start"], seg["start"] + seg["n_steps"]):
                flushed[step] = t
        return {"windows": len(seen), "verdicts_equal": True,
                "finalized_equal": True,
                "first_verdict_before_last_step_s": last_step_t - seen[0][0],
                "lags_s": [t - flushed[stop - 1] for t, _, stop in seen],
                "segments": len(sp.segment_records),
                "launches": lane[0]["launches"],
                "seed_counts": lane[0]["seed_counts"],
                "decisions": lane[0]["decisions"],
                "flagged_windows": sum(bool(w.kinds) for w in exact)}


DECODE_PROFILE_STEPS = 8


def decode_breakdown(backend,
                     steps: int = DECODE_PROFILE_STEPS) -> dict:
    """Where one lane's decode call spends the card's time: a fresh lane
    state, one prefill chunk, one decode call while torch.profiler (CUDA
    activity only) warms up and drops its records, then ``steps`` greedy
    decode calls recorded.  Returns the host wall per call, the device's
    busy time per call (the sum of its kernels' and copies' times), the
    idle share 1 - busy / wall, the device operations per call, each
    ported kernel's device time per call and the kernels that took
    longest.  The busy time is only as complete as the
    profiler's event list, so each ported kernel's profiled launches are
    held to the launch counter over the same calls (``profile_complete``).
    CUPTI has dropped single kernel records from such a window (a run
    listed 519 of 520 RMSNorm launches), so a window whose list disagrees
    with the counter is recorded again, the lane's state carried on, up to
    ``PROFILE_TRIES`` windows in all; the last must agree."""
    import torch
    api, model, k = backend.api, backend.model, backend.prefill_chunk
    state = api.init_decode_state(1, backend.max_len)
    logits, _ = api.decode_step(
        model, state, torch.zeros((1, k), dtype=torch.int32,
                                  device=backend.device),
        torch.arange(k, dtype=torch.int32, device=backend.device))
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    pos = k
    for tries in range(1, PROFILE_TRIES + 1):
        rows, launched, wall, tok = _decode_window(api, model, state, tok,
                                                   pos, steps)
        pos += steps + 1
        if not _profiled_launches(rows, launched)[1]:
            break
    busy = sum(r[0] for r in rows) / 1e6
    profiled = profile_complete(rows, launched)
    sc = symbol_counts(rows)
    check_decode_symbols(sc["counts"], launched)
    times = sc["times"]
    ported = {n: sum(times.get(sym, 0.0) for sym in _symbols(n)) / steps
              / 1e3 for n, c in launched.items() if c}
    return {"wall_ms": wall / steps * 1e3, "busy_ms": busy / steps * 1e3,
            "ported_ms": ported,
            "idle_share": 1.0 - busy / wall,
            "launches": sum(r[1] for r in rows) / steps,
            "profiled_launches": profiled,
            "counted_launches": {n: c for n, c in launched.items() if c},
            "symbols": sc["counts"], "profile_tries": tries,
            "top": [(t / steps / 1e3, c // steps, key[:90])
                    for t, c, key in rows[:10]]}


def _decode_window(api, model, state, tok, pos: int, steps: int) -> tuple:
    """One warm-up decode call at ``pos`` (records dropped), then ``steps``
    greedy decode calls recorded by torch.profiler (CUDA activity).
    Returns (profiler rows with device time, launch-counter delta over the
    recorded calls, their host wall in s, the last token)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch import kernels as K
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        logits, _ = api.decode_step(model, state, tok, pos)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        prof.step()  # the warm-up call's records are dropped
        # Recording starts at that step; CUPTI can miss the kernels of the
        # first milliseconds after it (a run lost the first layer's), so
        # the recorded calls start after a pause.
        time.sleep(0.2)
        before = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            logits, _ = api.decode_step(model, state, tok, pos + i)
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {n: K.LAUNCHES[n] - before[n] for n in before}
        prof.step()  # ends the recorded step
    # Only rows with device time: the CUDA activity also records runtime
    # calls (cudaLaunchKernel, ...), which take none.
    rows = sorted(((e.device_time_total, e.count, e.key)
                   for e in prof.key_averages() if e.device_time_total > 0),
                  reverse=True)
    return rows, launched, wall, tok


def profile_complete(rows, launched: dict) -> dict:
    """The launches of each ported kernel in the profiler's ``rows``
    ((device time, count, key), keys holding a CUDA symbol of
    ENTRY_SYMBOLS or FOLLOWERS), held to ``launched``, the launch
    counter's delta over the same calls: each wrapper call is one launch
    of an entry kernel, and each follower (the split-K merge) is launched
    exactly as often as the entry it follows.  Raises when the profiler
    lists another number for any kernel, since a busy time and idle share
    summed from a list that lost events would be wrong."""
    profiled, lost = _profiled_launches(rows, launched)
    if lost:
        raise AssertionError(lost)
    return profiled


def _profiled_launches(rows, launched: dict) -> tuple:
    """(profiled launches per ported kernel, "" or why the profiler's list
    disagrees with the launch counter's ``launched``)."""
    counts = symbol_counts(rows)["counts"]
    profiled = {n: sum(counts.get(s, 0) for s in ENTRY_SYMBOLS[n])
                for n in launched}
    followers = {f: (counts.get(f, 0), counts.get(lead, 0))
                 for f, lead in FOLLOWERS.items()}
    lost = ""
    if profiled != launched or any(a != b for a, b in followers.values()):
        lost = (f"the profiler lists {profiled} launches of the ported "
                f"kernels (followers against their entries: {followers}; "
                f"by CUDA symbol {counts}) where the launch counter reads "
                f"{launched} over the same calls: its event list is "
                f"incomplete")
    return {n: c for n, c in profiled.items() if c}, lost


def check_decode_symbols(counts: dict, launched: dict) -> None:
    """Every launch of a kernel in DECODE_SYMBOLS over decode calls went
    through its decode entry kernel (``counts``: profiled launches per
    CUDA symbol; ``launched``: the launch counter's delta)."""
    for name, sym in DECODE_SYMBOLS.items():
        if launched.get(name) and counts.get(sym, 0) != launched[name]:
            theirs = {s: c for s, c in counts.items() if s in _symbols(name)}
            raise AssertionError(
                f"{name}: {counts.get(sym, 0)} of the decode calls' "
                f"{launched[name]} launches ran {sym}; the profiler lists "
                f"{theirs}")


def log_breakdown(phase: str, bd: dict) -> None:
    log(f"[{phase}] one lane's decode call (torch.profiler, CUDA only): "
        f"host wall {bd['wall_ms']:.4f} ms, device busy {bd['busy_ms']:.4f} "
        f"ms, idle share {bd['idle_share']:.4f}, {bd['launches']:.1f} "
        f"device operations per call; kernels by device time (ms per call, "
        f"launches per call):")
    for t, c, key in bd["top"]:
        log(f"    {t:10.5f} {c:6d}  {key}")
    log(f"[{phase}] ported kernels' device ms per call (all of each "
        f"kernel's CUDA symbols): {bd['ported_ms']}")
    log(f"[{phase}] ported kernels' launches over the "
        f"{DECODE_PROFILE_STEPS} profiled calls: profiler "
        f"{bd['profiled_launches']}, launch counter "
        f"{bd['counted_launches']} (held equal; window {bd['profile_tries']} "
        f"of at most {PROFILE_TRIES}); by CUDA symbol {bd['symbols']}")


# -- phase 9 ---------------------------------------------------------------

# (B, T, H, dh, initial state) of each WKV-6 check: rwkv6-3b's decode call
# (the serving path's only shape: the ssm family runs one token per call),
# the parity phase's 64-token call, the reference's chunked threshold
# (from S = 0, as the Pallas kernel starts) and a ragged small case with
# masked lanes (dh = 16 of 32 threads).
WKV_CASES = {"decode": (1, 1, 40, 64, "normal"), "t64": (1, 64, 40, 64,
                                                          "normal"),
             "t512": (1, 512, 40, 64, "zero"), "ragged": (2, 100, 4, 16,
                                                          "normal")}
WKV_DECAYS = ("model", "long")
WKV_MAIN, WKV_LONG = "decode", "t512"
# Output and final state within WKV_TOL of their max |value| against the
# plain version.  Both sides compute in float32 from the same inputs (bf16
# ones rounded before either sees them) and differ only in the order of
# their float32 sums.  Where the output is rounded to bf16 (T >= 512 with
# bf16 inputs, as the reference's chunked form does), each element may
# also be off by its own rounding, 2^-8 of its size.
WKV_TOL = 2e-5


def wkv6_inputs(name: str, decay: str, dtype, device):
    """Seeded r, k, v (normal, in ``dtype``), w (float32: the model's
    exp(-exp(N(0, 1))), or the reference kernel test's uniform(0.75,
    0.999), a long memory), u = 0.5 N(0, 1) and the initial state (zeros,
    or 0.1 N(0, 1))."""
    import numpy as np
    import torch
    B, T, H, dh, state = WKV_CASES[name]
    rng = np.random.default_rng(list(WKV_CASES).index(name) * 2
                                + WKV_DECAYS.index(decay) + 101)
    shape = (B, T, H, dh)
    r, k, v = (rng.standard_normal(shape) for _ in range(3))
    w = (np.exp(-np.exp(rng.standard_normal(shape))) if decay == "model"
         else rng.uniform(0.75, 0.999, shape))
    u = 0.5 * rng.standard_normal((H, dh))
    S0 = (np.zeros((B, H, dh, dh)) if state == "zero"
          else 0.1 * rng.standard_normal((B, H, dh, dh)))
    f32 = dict(dtype=torch.float32, device=device)
    return ([torch.as_tensor(a, dtype=dtype, device=device)
             for a in (r, k, v)]
            + [torch.as_tensor(a, **f32) for a in (w, u, S0)])


def check_wkv6(name: str, device) -> dict:
    """The kernel against its plain version for both decay forms, float32
    and bf16 r/k/v.  Returns the max |kernel - plain| of the output per
    dtype and the largest error of output and state over their scale."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.kernels.wkv6 import CHUNKED_T
    out = {"f32": 0.0, "bf16": 0.0, "rel": 0.0}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for decay in WKV_DECAYS:
            r, k, v, w, u, S0 = wkv6_inputs(name, decay, dtype, device)
            S = S0.clone()
            got = K.wkv6(r, k, v, w, u, S)
            want, S_want = K.wkv6_ref(r, k, v, w, u, S0)
            what = f"wkv6 {name} {tag} {decay} decays"
            if got.dtype != torch.float32 or got.shape != r.shape:
                raise AssertionError(f"{what} gave {got.dtype} {got.shape}")
            rounded = dtype != torch.float32 and r.shape[1] >= CHUNKED_T
            if rounded and not torch.equal(got, got.bfloat16().float()):
                raise AssertionError(f"{what}: output not rounded to bf16")
            err = (got - want).abs()
            scale = float(want.abs().max())
            tol = WKV_TOL * scale + (2.0 ** -8 * want.abs() if rounded
                                     else 0.0)
            s_err = float((S - S_want).abs().max())
            s_scale = float(S_want.abs().max())
            if bool((err > tol).any()) or s_err > WKV_TOL * s_scale:
                raise AssertionError(
                    f"{what}: max |out err| {float(err.max())} of scale "
                    f"{scale}, max |state err| {s_err} of scale {s_scale} "
                    f"(tolerance {WKV_TOL} x scale)")
            out[tag] = max(out[tag], float(err.max()))
            out["rel"] = max(out["rel"], s_err / s_scale,
                             0.0 if rounded else float(err.max()) / scale)
    return out


def wkv6_bound_ms(B: int, T: int, H: int, dh: int, itemsize: int) -> tuple:
    """r, k, v (``itemsize``), w (float32) and u read once, the float32
    state read and written once, the float32 output written once; the
    float32 operations that the function needs per (token, head), at the
    rate outside the tensor cores: r·S, dh² fused multiply-adds (2·dh²),
    and the state update w_i·S_ij + k_i·v_j (3·dh²), so 5·dh².  The bonus
    term factors as (Σ_i r_i·u_i·k_i)·v_j, O(dh), as the decode kernel
    computes it."""
    n = B * T * H * dh
    nbytes = 3 * itemsize * n + 4 * n + 4 * H * dh + 8 * B * H * dh * dh \
        + 4 * n
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 5 * B * H * T * dh * dh / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def wkv6_plan_of(name: str, dtype):
    """The kernel :func:`wkv6_plan` picks for one case."""
    from repro_torch.kernels.wkv6 import wkv6_plan
    B, T, H, dh, _ = WKV_CASES[name]
    return wkv6_plan(B, T, H, dh, dtype)


def time_wkv6(name: str) -> dict:
    """bf16 r/k/v (the served dtype), the model's decays: the kernel and
    its plain version.  No single PyTorch call computes WKV-6, so there is
    no library time.  The state evolves in place from call to call.  At
    T = 1 also the sequential kernel (the decode kernel's predecessor
    there) forced on the same inputs."""
    import torch
    from repro_torch import kernels as K
    WK = importlib.import_module("repro_torch.kernels.wkv6")
    r, k, v, w, u, S = wkv6_inputs(name, "model", torch.bfloat16, "cuda")
    B, T, H, dh, _ = WKV_CASES[name]
    b_ms, b_by = wkv6_bound_ms(B, T, H, dh, 2)

    def kernel():
        return K.wkv6(r, k, v, w, u, S)
    extra = {}
    if T == 1:
        seq = WK.wkv6_plan(B, 2, H, dh, r.dtype)
        out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
        extra["sequential_device_ms"] = device_ms(
            lambda: WK._launch(r, k, v, w, u, S, out, False, seq), "wkv6")
    return {
        **extra,
        "ms": cuda_ms(kernel, 200),
        "device_ms": device_ms(kernel, "wkv6"),
        "plain_ms": cuda_ms(lambda: K.wkv6_ref(r, k, v, w, u, S),
                            max(3, 100 // T)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "plan": wkv6_plan_of(name, torch.bfloat16)._asdict(),
    }


# -- phases 10 and 11 -------------------------------------------------------

RWKV_SERVE_ARGV = ("--arch", "rwkv6-3b", "--lanes", "4", "--requests", "8",
                   "--prompt-len", "64", "--gen", "16", "--arrival-rate",
                   "2.0", "--seed", "0")
RWKV_PARITY_PROMPT = 64


# Phase 11's live tail: the spool the served rwkv6-3b steps go to.
RWKV_SPOOL = ROOT / "build" / "spool_rwkv"


def tail_cost(argv=RWKV_SERVE_ARGV, device="cuda",
              order=("none", "tail", "tail-1-thread", "tail-1-thread",
                     "tail", "none")) -> list:
    """Not a phase of ``main()``: what a live tail costs the server it
    shares the host with.  Serves ``argv`` once per entry of ``order`` —
    alone (``none``), with ``LiveTail`` following its spool (``tail``), or
    with the tail's thread pools cut to one thread (``tail-1-thread``) —
    and returns each run's serving summary (decode tok/s ...).  The order
    alternates the arms so that drift on the host does not favour one.

        python3 -c 'import chip_smoke as c, json
        print(json.dumps(c.tail_cost()))'
    """
    from repro_torch.launch import serve
    rows = []
    for arm in order:
        with tempfile.TemporaryDirectory() as tmp:
            spool = str(pathlib.Path(tmp) / "spool")
            args = serve.parser().parse_args(
                [*argv, "--device", str(device),
                 *([] if arm == "none" else ["--spool-dir", spool])])
            tail = None if arm == "none" else LiveTail(
                spool, device, None, 1 if arm == "tail-1-thread" else None)
            engine, _ = serve.run(args)
            if tail is not None:
                tail.proc.wait(timeout=600)
                for t in tail.threads:
                    t.join()
            rows.append({"arm": arm, **serve.summary(engine)})
            log(json.dumps(rows[-1]))
    return rows


# -- phase 12 --------------------------------------------------------------

RUNTIME_ENTRIES = ("runtime/compute-straggler", "runtime/data-skew")


def runtime_phase(device) -> dict:
    """The two runtime corpus entries through the port's corpus on
    ``device``, kernel lane, with the corpus's one retry
    (``run_entry_robust``): each must name rt/solver with recall 1.0.
    Returns, per entry and region, each shard's wall (min of repeats, as
    ``reduce`` takes it), its CUDA-event device time (min of repeats; None
    on the CPU), ``cost_of``'s FLOPs and bytes and the roofline bound on
    the H100 spec; and the seed-row launches and re-decisions of the
    phase's analyses, counted from 0."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.core import H100_SXM, WALL_TIME, roofline_terms
    from repro_torch.scenarios import CORPUS, run_entry_robust
    K.reset_launches()
    out, decisions = {}, []
    for name in RUNTIME_ENTRIES:
        r = run_entry_robust(CORPUS[name], seed=0,
                             analyzer_overrides={"device": device})
        if not (r.passed and r.recall == 1.0 and "rt/solver" in r.found):
            raise AssertionError(f"{name}: found {sorted(r.found)}, "
                                 f"precision {r.precision}")
        runner, trace = r.collector.runner, r.collector.last_trace
        wall = trace.data[WALL_TIME].min(axis=1)[0]     # (shards, regions)
        regions = {}
        for reg in runner.tree.regions():
            if reg.fn is None:
                continue
            rid = reg.region_id
            flops, nbytes, comm = runner.costs[rid]
            dev = runner.device_s.get(rid)
            regions[reg.path] = {
                "wall_s": wall[:, trace.col(rid)].tolist(),
                "device_s": None if dev is None else dev.min(axis=1).tolist(),
                "flops": flops, "bytes": nbytes,
                "bound_s": roofline_terms(flops, nbytes, comm, 1,
                                          H100_SXM).bound_s}
        out[name] = {"found": sorted(r.found), "precision": r.precision,
                     "attempt_walls": list(r.attempt_walls),
                     "iters": list(r.collector.iters),
                     "cpu_clock": [trace.meta["cpu_clock"],
                                   trace.meta["cpu_tick"]],
                     "regions": regions}
        decisions.append(r.decisions)
    launches = K.LAUNCHES["multi_seed_rows"]
    if launches == 0 and _on_card(device):
        raise AssertionError("the runtime entries never launched the kernel")
    return {"entries": out, "launches": launches,
            "seed_counts": dict(K.SEED_COUNTS),
            "decisions": _sum_counts(decisions)}


def _on_card(device) -> bool:
    import torch
    return torch.device(device).type == "cuda"


def _sum_counts(dicts) -> dict | None:
    """Element-wise sum of count dicts (None entries skipped)."""
    dicts = [d for d in dicts if d is not None]
    if not dicts:
        return None
    return {k: sum(d[k] for d in dicts) for k in dicts[0]}


# -- phase 13 --------------------------------------------------------------

STREAM_STEPS, STREAM_ONSET, STREAM_WINDOW = 4, 2, 2
STREAM_SPOOL = ROOT / "build" / "spool_fleet"


def stream_fleet_phase(m: int, n: int, straggler_procs: int, device,
                       spool_dir=STREAM_SPOOL) -> dict:
    """Phase 5's collector for ``STREAM_STEPS`` steps with the straggler's
    onset at step ``STREAM_ONSET``, spooled one step a segment, then read
    by ``OnlineAnalyzer`` in ``STREAM_WINDOW``-step tumbling windows with
    persist 1 on the kernel lane and on the numpy lane.  The window
    verdicts must be equal on the two lanes, the dissimilarity onset must
    be window 1 on both (the I/O hotspot's disparity stands from window
    0), and the kernel lane must have launched the kernel.  The spool is
    deleted at the end.  Returns its bytes on disk, the write time, each
    window's wall on each lane and its reassembly alone, and the seed-row
    launches and re-decisions of the kernel lane's windows."""
    from repro_torch import kernels as K
    from repro_torch.stream import OnlineAnalyzer, SpooledTrace, TraceSpool
    _, collector, planted = fleet_collector(
        m, n, straggler_procs, n_steps=STREAM_STEPS,
        onset_step=STREAM_ONSET)
    trace = collector.collect_trace()
    shutil.rmtree(spool_dir, ignore_errors=True)
    t0 = time.perf_counter()
    spool = TraceSpool(str(spool_dir), chunk_steps=1, meta=dict(trace.meta))
    for step in range(trace.n_steps):
        spool.append(trace.window(step, step + 1))
    spool.close(meta=dict(trace.meta))
    write_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in pathlib.Path(spool_dir).iterdir()
                 if f.is_file())
    del trace
    lanes = {}
    for lane, kw in (("kernel", {"distance_backend": "kernel",
                                 "device": device}),
                     ("numpy", {"distance_backend": "numpy"})):
        online = OnlineAnalyzer(window_steps=STREAM_WINDOW, persist=1, **kw)
        sp = SpooledTrace(str(spool_dir))
        bounds = online.pending_bounds(sp)
        # each window's reassembly alone (its segments read and merged),
        # timed in a call of its own before the window is consumed
        reads = []
        for start, stop in bounds:
            t0 = time.perf_counter()
            sp.window(start, stop)
            reads.append(time.perf_counter() - t0)
        K.reset_launches()
        walls, windows = [], []
        for start, stop in bounds:
            t0 = time.perf_counter()
            windows.append(online.consume(sp, start, stop))
            if _on_card(device):
                import torch
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        lanes[lane] = {"walls_s": walls, "reads_s": reads,
                       "onset": online.onset("dissimilarity"),
                       "windows": windows,
            "launches": K.LAUNCHES["multi_seed_rows"],
            "seed_counts": dict(K.SEED_COUNTS),
            "decisions": online.decisions}
    docs = {lane: [(w.start, w.stop, None if w.degraded else w.verdict.doc())
                   for w in v["windows"]] for lane, v in lanes.items()}
    if docs["kernel"] != docs["numpy"] or None in \
            [d for *_, d in docs["numpy"]]:
        raise AssertionError(f"streamed fleet windows differ between "
                             f"lanes:\nkernel {docs['kernel']}\n"
                             f"numpy  {docs['numpy']}")
    if not lanes["kernel"]["onset"] == lanes["numpy"]["onset"] == 1:
        raise AssertionError(f"streamed fleet onset: kernel lane "
                             f"{lanes['kernel']['onset']}, numpy lane "
                             f"{lanes['numpy']['onset']}; want window 1")
    if lanes["kernel"]["launches"] == 0 and _on_card(device):
        raise AssertionError("the streamed fleet windows never launched "
                             "the kernel")
    shutil.rmtree(spool_dir)
    k = lanes["kernel"]
    return {"shape": [m, n], "steps": STREAM_STEPS, "planted": list(planted),
            "spool_bytes": nbytes, "write_s": write_s,
            "kernel_walls_s": k["walls_s"],
            "numpy_walls_s": lanes["numpy"]["walls_s"],
            "reads_s": k["reads_s"] + lanes["numpy"]["reads_s"],
            "onset": k["onset"],
            "kinds": [sorted(w.kinds) for w in k["windows"]],
            "launches": k["launches"], "seed_counts": k["seed_counts"],
            "decisions": k["decisions"]}


# -- phase 14 --------------------------------------------------------------

CHAOS_SEEDS = (0, 1, 7)
# (quarantined, adopted, degraded, stalled, shed, matched, comparable) of
# each entry, the same at every seed of CHAOS_SEEDS: the reference's own
# outcomes, which tests/test_torch_chaos_corpus.py and
# tests/test_torch_fleet_corpus.py hold this table to on the CPU.
CHAOS_OUTCOMES = {
    "chaos/flip-bytes-segment": (1, 0, 1, False, 0, 3, 3),
    "chaos/kill-producer-orphan-segment": (0, 1, 0, False, 0, 3, 3),
    "chaos/kill-producer-torn-segment": (1, 0, 0, False, 0, 2, 2),
    "chaos/stall-producer": (0, 0, 0, True, 0, 1, 1),
    "chaos/truncate-segment": (1, 0, 1, False, 0, 3, 3),
    "fleet/analysis-lag-flood": (0, 0, 6, False, 6, 28, 28),
    "fleet/concurrent-producer-kill": (0, 1, 0, True, 0, 24, 24),
    "fleet/one-tenant-corruption": (1, 0, 1, False, 0, 28, 28),
}
CHAOS_FIELDS = ("quarantined", "adopted", "degraded", "stalled", "shed",
                "matched", "comparable")


def chaos_phase(device, seeds=CHAOS_SEEDS) -> dict:
    """The five spool chaos and three fleet corpus entries at ``seeds`` on
    the kernel lane on ``device``: each passes (``ChaosTruth.check``
    reports nothing) with its ``CHAOS_OUTCOMES`` row.  Returns the walls,
    the seed-row launches and the re-decisions, counted from 0."""
    from repro_torch import kernels as K
    from repro_torch.scenarios import CORPUS, run_entry
    K.reset_launches()
    walls, decisions = {}, []
    for name, want in CHAOS_OUTCOMES.items():
        for seed in seeds:
            r = run_entry(CORPUS[name], seed=seed,
                          analyzer_overrides={"device": device})
            got = tuple(getattr(r.chaos_outcome, f) for f in CHAOS_FIELDS)
            if r.chaos_failures or not r.passed or got != want:
                raise AssertionError(
                    f"{name}@{seed}: failures {r.chaos_failures}, passed "
                    f"{r.passed}, outcome {dict(zip(CHAOS_FIELDS, got))}, "
                    f"want {dict(zip(CHAOS_FIELDS, want))}")
            walls[f"{name}@{seed}"] = r.attempt_walls[0]
            decisions.append(r.decisions)
    launches = K.LAUNCHES["multi_seed_rows"]
    if launches == 0 and _on_card(device):
        raise AssertionError("the chaos entries never launched the kernel")
    return {"runs": len(walls), "walls_s": walls, "launches": launches,
            "seed_counts": dict(K.SEED_COUNTS),
            "decisions": _sum_counts(decisions)}


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

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = build.load_libraries(KERNEL_SOURCES)
    log(f"[2] built {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for lib in libs.values():
        log(f"[2] {lib.path.name} ({'fresh' if lib.built else 'cached'} "
            f"build); ptxas:")
        for line in lib.ptxas_log.splitlines():
            if "registers" in line or "Compiling" in line or "spill" in line:
                log("    " + line.strip())

    # 3. kernel vs plain
    timings = {}
    for m, n, k in [(FLEET_M, FLEET_N, k) for k in KERNEL_KS] + [RAGGED]:
        err = check_kernel(m, n, k, "cuda")
        t = time_kernel(m, n, k)
        timings[(m, n, k)] = {**err, **t}
        log(f"[3] m={m} n={n} k={k}: plan {t['plan']}, profiled "
            f"{t['symbols']}; max|kernel-plain| "
            f"{err['max_abs_err']:.6g} (at most {err['max_ratio_plain']:.3f}"
            f" of an element's scale; tolerance {C_PLAIN}), max|kernel-f64| "
            f"{err['max_abs_err_f64']:.6g} (at most "
            f"{err['max_ratio_f64']:.3f}; tolerance {C_F64}); kernel "
            f"{t['ms']:.6f} ms, plain {t['plain_ms']:.6f} ms, library "
            f"{t['library_ms']:.6f} ms (device {t['library_device_ms']:.6f} "
            f"ms), bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}); kernel device time (profiler) "
            f"{t['device_ms']} ms; batched == per-seed bitwise")

    # 4. corpus on the kernel lane, then the fault pin
    corpus = corpus_phase("cuda")
    log(f"[4] corpus: {corpus['entries']} synthetic entries match "
        f"VERDICTS_synthetic.json on the kernel lane; "
        f"{corpus['launches']} kernel launches, by seed count k "
        f"{corpus['seed_counts']}; re-decided on the exact lane "
        f"{corpus['decisions']}; {corpus['wall_s']:.3f} s")
    pin = fault_pin_phase("cuda")
    log(f"[4] fault pin: {pin['n_clusters']} clusters on both lanes "
        f"(cluster_batch and push/cluster); the kernel lane flagged "
        f"{pin['flagged']} candidacies and re-decided {pin['redecided']} "
        f"trials")

    # 5. fleet
    fleet = fleet_phase(FLEET_M, FLEET_N, 2048, "cuda")
    log(f"[5] fleet {FLEET_M}x{FLEET_N}: verdicts equal on both lanes; "
        f"dissimilarity CCRs {fleet['dissimilarity_ccrs']}, disparity "
        f"CCRs {fleet['disparity_ccrs']}, causes {fleet['causes']}; "
        f"planted {fleet['planted']} named: {fleet['planted_named']}; "
        f"kernel lane {fleet['kernel_lane_s']:.3f} s, numpy lane "
        f"{fleet['numpy_lane_s']:.3f} s; {fleet['launches']} kernel "
        f"launches, by seed count k {fleet['seed_counts']}; "
        f"max_memory_allocated {fleet['max_memory_allocated']} bytes")
    fd = fleet["decisions"]
    log(f"[5] kernel lane: {fd['flagged']} candidacies flagged, "
        f"{fd['redecided']} trials re-decided on the exact lane in "
        f"{fd['redecide_s']:.6f} s of host time, {fd['kmeans_redecided']} "
        f"Lloyd loops re-run")
    log("[5] kernel-lane host breakdown (cProfile, cumulative s, calls):")
    for cum, calls, name in fleet["breakdown"]:
        log(f"    {cum:10.4f} {calls:8d}  {name}")

    # 6. the serving path's kernels vs plain, float32 and bf16
    rms_err, rms_t, rms_paths = {}, {}, {}
    for n, d, off in RMS_SHAPES:
        rms_err[(n, d, off)] = e = check_rmsnorm(n, d, "cuda", off)
        rms_paths[f"{n}x{d}+{off}"] = paths = {
            tag: rmsnorm_plan_of(n, d, dt, off).path
            for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
        msg = ""
        if off == 0 and (n, d) in RMS_TIMED:
            rms_t[(n, d)] = t = time_rmsnorm(n, d)
            msg = (f"; bf16 kernel {t['ms']:.6f} ms per call, device "
                   f"{t['device_ms']} ms, plain {t['plain_ms']:.6f} ms, "
                   f"library (float32 copies) {t['library_ms']:.6f} ms per "
                   f"call, device {t['library_device_ms']:.6f} ms, library "
                   f"(bf16) device {t['library_bf16_device_ms']:.6f} ms, "
                   f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}); bf16 "
                   f"plan {t['plan']}")
        log(f"[6] rmsnorm ({n}, {d}) at offset {off}: paths {paths}; "
            f"max|kernel-plain| f32 {e['f32']:.6g} (tolerance {F32_TOL}), "
            f"bf16 {e['bf16']:.6g} (tolerance {BF16_TOL})" + msg)
    rms_sweep = {f"{n}x{d}": rmsnorm_sweep(n, d) for n, d in RMS_SWEEP}
    for shape, res in rms_sweep.items():
        log(f"[6] rmsnorm {shape} bf16, device ms per call of the row path "
            f"by vectors a thread: {json.dumps(res)}")
    attn_err, attn_t = {}, {}
    for name in ATTN_CASES:
        attn_err[name] = check_attention(name, "cuda")
        attn_t[name] = t = time_attention(name)
        log(f"[6] attention {name} {attention_shape(name)} (B, Q, H, KV, "
            f"dh, K): paths f32 {attention_plan_of(name, torch.float32).path}"
            f", bf16 {t['plan']}; max|kernel-plain| f32 "
            f"{attn_err[name]['f32']:.6g} (tolerance {F32_TOL}), bf16 "
            f"{attn_err[name]['bf16']:.6g} (tolerance {BF16_TOL}); bf16 "
            f"kernel {t['ms']:.6f} ms per call, device {t['device_ms']} ms,"
            f" plain {t['plain_ms']:.6f} ms, library {t['library_ms']:.6f} "
            f"ms per call, device {t['library_device_ms']:.6f} ms, bound "
            f"{t['bound_ms']:.6f} ms ({t['bound_by']})")
    first, second = attn_t["gemma-prefill-first"], attn_t["gemma-prefill"]
    if first["device_ms"] is None or second["device_ms"] is None:
        raise AssertionError("the profiler recorded no device time for a "
                             "gemma prefill case")
    if not first["device_ms"] < second["device_ms"]:
        raise AssertionError(
            f"key tiles were not skipped: gemma-prefill-first took "
            f"{first['device_ms']} ms of device time, gemma-prefill "
            f"{second['device_ms']} ms")

    # 7. model parity, card vs host
    t0 = time.perf_counter()
    parity = model_parity_phase(parity_config(), "cuda")
    log(f"[7] gemma-7b width, 2 layers, f32: max|card-host| logits "
        f"{parity['max_abs_err']:.6g} of scale {parity['logit_scale']:.6g} "
        f"(tolerance {PARITY_RTOL} x scale); greedy tokens equal "
        f"{parity['tokens']}; card launches {parity['launches']} over "
        f"{parity['calls']} model calls; {time.perf_counter() - t0:.1f} s")

    # 8. serving gemma-7b FULL on the card, then its trace analyzed
    served = serve_phase(SERVE_ARGV, "cuda")
    log(f"[8] serve {' '.join(SERVE_ARGV)}: {json.dumps(served['summary'])}")
    log(f"[8] {served['model_calls']} model calls, launches "
        f"{served['launches']} (= 57 and 28 per call); "
        f"max_memory_allocated {served['max_memory_allocated']} bytes; "
        f"phase wall {served['wall_s']:.1f} s (model init included); trace "
        f"(steps, lanes, regions) {served['trace_shape']}; CPU clock "
        f"(name, tick s) {served['cpu_clock']}")
    log_breakdown("8", served["breakdown"])
    log(f"[8] verdict, equal on the kernel and numpy lanes "
        f"({served['analysis_launches']} seed-row launches, by seed count k "
        f"{served['seed_counts']}; re-decided {served['decisions']}): "
        f"{json.dumps(served['verdict'], sort_keys=True)}")

    # 9. the WKV-6 kernel vs plain, float32 and bf16
    wkv_err, wkv_t = {}, {}
    for name in WKV_CASES:
        wkv_err[name] = e = check_wkv6(name, "cuda")
        path = wkv6_plan_of(name, torch.bfloat16).path
        if path != ("decode" if name == WKV_MAIN else "sequential"):
            raise AssertionError(f"wkv6 {name} takes the {path} kernel")
        msg = ""
        if name in (WKV_MAIN, WKV_LONG):
            wkv_t[name] = t = time_wkv6(name)
            msg = (f"; bf16 kernel {t['ms']:.6f} ms per call, device "
                   f"{t['device_ms']} ms, plain {t['plain_ms']:.6f} ms, "
                   f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}), no "
                   f"library call")
        log(f"[9] wkv6 {name} (B, T, H, dh, state) = {WKV_CASES[name]}, "
            f"{path} kernel: max|kernel-plain| f32 {e['f32']:.6g}, bf16 "
            f"{e['bf16']:.6g}; largest error over scale {e['rel']:.3g} "
            f"(tolerance {WKV_TOL})"
            + msg)

    # 10. rwkv parity, card vs host
    t0 = time.perf_counter()
    rparity = model_parity_phase(parity_config("rwkv6-3b"), "cuda",
                                 chunk=RWKV_PARITY_PROMPT)
    log(f"[10] rwkv6-3b width, 2 layers, f32: max|card-host| logits "
        f"{rparity['max_abs_err']:.6g} of scale {rparity['logit_scale']:.6g}"
        f" (tolerance {PARITY_RTOL} x scale); greedy tokens equal "
        f"{rparity['tokens']}; card launches {rparity['launches']} over "
        f"{rparity['calls']} model calls; {time.perf_counter() - t0:.1f} s")

    # 11. serving rwkv6-3b FULL on the card, tailed live, then its trace
    # analyzed
    rserved = serve_phase(RWKV_SERVE_ARGV, "cuda", spool_dir=str(RWKV_SPOOL))
    log(f"[11] serve {' '.join(RWKV_SERVE_ARGV)}: "
        f"{json.dumps(rserved['summary'])}")
    log(f"[11] {rserved['model_calls']} model calls, launches "
        f"{rserved['launches']} (= 65 and 32 per call); "
        f"max_memory_allocated {rserved['max_memory_allocated']} bytes; "
        f"phase wall {rserved['wall_s']:.1f} s (model init included); "
        f"trace (steps, lanes, regions) {rserved['trace_shape']}; CPU clock "
        f"(name, tick s) {rserved['cpu_clock']}")
    log_breakdown("11", rserved["breakdown"])
    log(f"[11] verdict, equal on the kernel and numpy lanes "
        f"({rserved['analysis_launches']} seed-row launches, by seed count k "
        f"{rserved['seed_counts']}; re-decided {rserved['decisions']}): "
        f"{json.dumps(rserved['verdict'], sort_keys=True)}")
    live = rserved["live"]
    lags = sorted(live["lags_s"])
    log(f"[11] live tail (cli.watch_trace --follow --json --device cuda in "
        f"a child process, 1 s polls): {live['windows']} window verdicts "
        f"({live['flagged_windows']} flagged) over {live['segments']} "
        f"segments, equal to the exact lane's replay of the finalized "
        f"spool; the first came {live['first_verdict_before_last_step_s']:.3f}"
        f" s before the server's last step; the finalized spool is the "
        f"served trace byte for byte; decode tok/s with the tail on the "
        f"host {rserved['summary']['decode_tok_per_s']:.4f}")
    log(f"[11] live lag from a segment's flush to its window's verdict, s: "
        f"min {lags[0]:.4f}, median {lags[len(lags) // 2]:.4f}, max "
        f"{lags[-1]:.4f}; all {json.dumps(live['lags_s'])}")
    log(f"[11] live tail's kernel lane: {live['launches']} seed-row "
        f"launches, by seed count k {live['seed_counts']}; re-decided "
        f"{live['decisions']}")

    # 12. the runtime collector on the card
    t0 = time.perf_counter()
    runtime = runtime_phase("cuda")
    log(f"[12] runtime entries name rt/solver on the kernel lane "
        f"({runtime['launches']} seed-row launches, by seed count k "
        f"{runtime['seed_counts']}; re-decided {runtime['decisions']}); "
        f"{time.perf_counter() - t0:.1f} s")
    for name, res in runtime["entries"].items():
        log(f"[12] {name}: iterations {res['iters']}, found {res['found']}"
            f" (precision {res['precision']}), attempts' walls "
            f"{res['attempt_walls']}, CPU clock (name, tick s) "
            f"{res['cpu_clock']}")
        for path, reg in res["regions"].items():
            log(f"[12]   {path}: wall s per shard {reg['wall_s']}; CUDA-event"
                f" device s {reg['device_s']}; cost_of {reg['flops']:.6g} "
                f"FLOPs, {reg['bytes']:.6g} bytes; H100 roofline bound "
                f"{reg['bound_s']:.6g} s")

    # 13. the fleet shape streamed through a spool
    stream = stream_fleet_phase(FLEET_M, FLEET_N, 2048, "cuda")
    log(f"[13] streamed fleet {FLEET_M}x{FLEET_N}, {stream['steps']} steps "
        f"one a segment, straggler onset at step {STREAM_ONSET}: spool "
        f"{stream['spool_bytes']} bytes written in {stream['write_s']:.3f} "
        f"s; {STREAM_WINDOW}-step windows equal on both lanes, kinds "
        f"{stream['kinds']}, dissimilarity onset window {stream['onset']}; "
        f"wall per window kernel lane {stream['kernel_walls_s']} s, numpy "
        f"lane {stream['numpy_walls_s']} s, of which reassembling the "
        f"window from its segments (timed alone, kernel then numpy lane's "
        f"turn) {stream['reads_s']} s; {stream['launches']} seed-row "
        f"launches, by seed count k {stream['seed_counts']}; re-decided "
        f"{stream['decisions']}")

    # 14. chaos and fleet entries on the card
    t0 = time.perf_counter()
    chaos = chaos_phase("cuda")
    log(f"[14] {len(CHAOS_OUTCOMES)} chaos and fleet entries at seeds "
        f"{list(CHAOS_SEEDS)} pass on the kernel lane with the reference's "
        f"outcomes ({chaos['runs']} runs, {time.perf_counter() - t0:.1f} s;"
        f" {chaos['launches']} seed-row launches, by seed count k "
        f"{chaos['seed_counts']}; re-decided {chaos['decisions']})")
    log(f"[14] wall per run, s: {json.dumps(chaos['walls_s'])}")

    main_t = timings[MAIN_PATH_SHAPE]
    kernels = [{
        "name": "multi_seed_rows", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": fleet["launches"],
        "max_abs_err": max(t["max_abs_err"] for t in timings.values()),
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "library_device_ms": main_t["library_device_ms"],
        "device_ms": main_t["device_ms"], "shape": list(MAIN_PATH_SHAPE),
        "plan": main_t["plan"],
        "ks": {str(k): {key: timings[(FLEET_M, FLEET_N, k)][key] for key in
                        ("device_ms", "library_device_ms", "bound_ms",
                         "bound_by", "ms", "library_ms", "plan")}
               for k in KERNEL_KS},
        "corpus_launches": corpus["launches"],
        "serve_trace_launches": served["analysis_launches"],
        "seed_counts": {"corpus": corpus["seed_counts"],
                        "fleet": fleet["seed_counts"],
                        "serve_gemma": served["seed_counts"],
                        "serve_rwkv": rserved["seed_counts"],
                        "runtime": runtime["seed_counts"],
                        "stream_fleet": stream["seed_counts"],
                        "live_rwkv": live["seed_counts"],
                        "chaos": chaos["seed_counts"]},
        "decisions": {"corpus": corpus["decisions"],
                      "fleet": fleet["decisions"],
                      "serve_gemma": served["decisions"],
                      "serve_rwkv": rserved["decisions"],
                      "runtime": runtime["decisions"],
                      "stream_fleet": stream["decisions"],
                      "live_rwkv": live["decisions"],
                      "chaos": chaos["decisions"]},
    }]
    for name, errs, times, main, prefill, shape in (
            ("rmsnorm", rms_err, rms_t, RMS_MAIN, RMS_PREFILL, list),
            ("flash_attention", attn_err, attn_t, ATTN_MAIN, ATTN_PREFILL,
             attention_shape)):
        t = times[main]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": TPU_KERNELS[name],
            "launches": served["launches"][name],
            "max_abs_err": max(e["f32"] for e in errs.values()),
            "max_abs_err_bf16": max(e["bf16"] for e in errs.values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"],
            "device_ms": t["device_ms"], "plan": t["plan"],
            "shape": shape(main), "dtype": "bfloat16",
            "prefill": {"shape": shape(prefill), **times[prefill]},
            "model_calls": served["model_calls"],
        })
    attn = next(kd for kd in kernels if kd["name"] == "flash_attention")
    attn["cases"] = {name: {"shape": attention_shape(name), **attn_t[name]}
                     for name in ATTN_CASES}
    rms = next(kd for kd in kernels if kd["name"] == "rmsnorm")
    rms["launches_rwkv6_serve"] = rserved["launches"]["rmsnorm"]
    for key in ("library_bf16_device_ms", "scalar_device_ms",
                "copy_device_ms"):
        rms[key] = rms_t[RMS_MAIN][key]
    rms["rwkv_decode"] = {"shape": list(RMS_RWKV), **rms_t[RMS_RWKV]}
    rms["paths"] = rms_paths
    rms["plan_sweep"] = rms_sweep
    t = wkv_t[WKV_MAIN]
    kernels.append({
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": TPU_KERNELS["wkv6"],
        "launches": rserved["launches"]["wkv6"],
        "max_abs_err": max(e["f32"] for e in wkv_err.values()),
        "max_abs_err_bf16": max(e["bf16"] for e in wkv_err.values()),
        "max_err_over_scale": max(e["rel"] for e in wkv_err.values()),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "device_ms": t["device_ms"],
        "sequential_device_ms": t["sequential_device_ms"], "plan": t["plan"],
        "shape": list(WKV_CASES[WKV_MAIN][:4]),
        "dtype": "bfloat16",
        "t512": {"shape": list(WKV_CASES[WKV_LONG][:4]), **wkv_t[WKV_LONG]},
        "model_calls": rserved["model_calls"],
    })
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
