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
   and one PyTorch expression of the same function (the torch lane's
   ``addmm``), beside the kernel's bound;
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
   3840), a d that is not a multiple of 8 (3, 3004), an unaligned view
   (4, 2560) at one element's offset, deepseek-v2-lite-16b's (1, 2048)
   and (256, 2048), recurrentgemma-9b's (1, 4096) and seamless-m4t-medium's
   (1, 1024) and (1024, 1024), with the path each takes, and the
   row path timed at 1, 2 and 4 vectors a thread; attention at
   gemma-7b's decode, its first 256-token prefill chunk (positions
   0..255, slots 256.. unwritten: key tiles skipped) and its second, over
   a 545-slot cache, at danube's GQA with a 4096 window over a
   wrapped 4096-slot ring, and at MLA's dh 192 with v zero-padded from
   128 (decode at position 544 and the second 256-token chunk over the
   545-slot latent cache; the output's padded columns must be 0; the
   bound counts v at 128, the padded call's bound beside it), at
   phi-3-vision-4.2b's dh 96 (H = KV = 32: decode and the second chunk
   over the 545-slot cache), at recurrentgemma-9b's local MQA decode (H
   16, KV 1, dh 256, window 2048 over a wrapped 2048-slot ring) and at
   seamless-m4t-medium's non-causal encoder (Q = K = 1024, H 16, dh 64)
   and cross-attention decode (Q 1 over 1024 frames), each in
   float32
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
   with the reference's outcome (``CHAOS_OUTCOMES``);
15. training kernels vs plain: ``RmsnormFunction`` at (8192, 768) and
   (300, 3840) and ``FlashAttentionFunction`` at st-100m's heads (B = 2,
   S = 1024, causal) and a GQA case with a window and a softcap, float32:
   the kernel forward within 2e-5 and every input gradient (the plain
   backward formulas) within 1e-4 of its scale, against
   ``torch.autograd.grad`` through the plain versions on the card; times
   of the forward, the backward formulas, the plain forward+backward and
   ``F.rms_norm`` / ``F.scaled_dot_product_attention`` forward+backward;
   attention's forward also as device time per call beside SDPA's;
16. training parity: st-100m's full width cut to 2 layers, float32,
   seeded weights on the host and a copy on the card; one step's loss
   within 1e-5 relative and every gradient within 1e-4 of its scale, then
   the losses of 3 AdamW steps within 1e-4 relative;
17. training: st-100m FULL through ``repro_torch.launch.train --steps 20
   --batch 8 --seq 1024``; the loss falls (mean of the last 5 steps below
   the first 5), every step launches 25 RMSNorms and 12 attentions in its
   forward and, under the config's remat_policy "nothing", 24 and 12 in
   its recompute (``recompute_per_step``; every training check counts
   them);
   the median step, tokens/s and peak memory; one step profiled (device
   busy against host wall, idle share, top operations, each window's
   launches against the counter and lost records); then a traced
   ``Trainer`` at full width, 4 emulated shards with fwd_bwd iterations
   (1, 1, 1, 4), 2 steps, analyzed on the kernel and numpy lanes with
   equal verdicts naming train/fwd_bwd;
18. the slice's corpus entries: the five ``serving/*``, the three dense
   ``train/*`` and ``chaos/corrupt-latest-checkpoint`` at seeds 0, 1 and 7
   on the kernel lane, trainers on the card, each passing with the
   reference's outcome (completed requests, the mitigation, the
   checkpoint fallback);
19. MoE parity: deepseek-v2-lite-16b's full width cut to 2 layers,
   float32, card vs host as in phase 7 (a 16-token prefill, 4 greedy
   decode steps): logits within 1e-4 of their scale, greedy tokens equal,
   every token's expert ids equal in every layer and call, the smallest
   top-k margin of the router printed; 5 RMSNorms and 2 attentions a call;
20. serving: deepseek-v2-lite-16b FULL in bf16 (32.4 GB: MLA and 64
   routed experts) through ``repro_torch.launch.serve`` with phase 8's
   traffic, every model call launching 55 RMSNorms and 27 attentions; one
   lane's decode call profiled (its attentions the split-K kernel and its
   merge); the served trace analyzed on both lanes with equal verdicts;
21. MoE training: one step of mixtral-smoke and of dsv2-smoke card vs
   host (loss within 1e-5 relative, every gradient within 1e-4 of its
   scale), then ``train/moe-routing-collapse-smoke`` and
   ``train/moe-collapse-rebalance-recovery`` at seeds 0, 1 and 7 on the
   kernel lane, trainers on the card, each passing with the reference's
   outcome (the disparity on ``train/moe/expert_1``; the rebalance by
   window 1 and 3 clean windows after);
22. vlm: phi-3-vision-4.2b's full width cut to 2 layers, float32, card vs
   host: a forward over a 576-patch prefix and 64 text tokens, then a
   16-token prefill and 4 greedy decode steps (logits within 1e-4 of
   their scale, greedy tokens equal), then one training step's loss
   (1e-5 relative) and every gradient, ``vis_proj``'s included (1e-4 of
   its scale); then FULL in bf16 served with phase 8's traffic, every
   model call launching 65 RMSNorms and 32 attentions, one lane's decode
   call profiled, the trace's verdicts equal on both lanes; then one FULL
   forward over the 576-patch prefix and 64 tokens, its logits finite;
23. hybrid: recurrentgemma-9b's full width cut to 5 layers (one (rec,
   rec, attn) block and a (rec, rec) tail), float32, card vs host: a
   16-token forward, the prompt fed one token a call carrying the conv
   and h state and 4 greedy steps, one training step through the plain
   RG-LRU scan, checked as in phase 22; then FULL in bf16 served one
   token a call with phase 11's traffic, 77 RMSNorms and 12 attentions a
   call, its decode attentions on the ``wgmma`` path the plan picks for
   16 query rows on one kv head;
24. encdec: seamless-m4t-medium's full width cut to 2 encoder and 2
   decoder layers, float32, card vs host: the encoder output over 1024
   stub frames and a forward, then 4 prompt tokens fed one a call and 4
   greedy steps, then one training step (cross-attention's gradient
   through the kernel's autograd Function), checked as in phase 22; then
   FULL in bf16 served with phase 11's traffic, each request encoding its
   1024 frames when it arrives: 37 RMSNorms and 24 attentions a decode
   call, 25 and 12 an encode;
25. WKV-6's training call: ``Wkv6Function`` (the kernel forward on a copy
   of the state, the plain backward formulas) against autograd through
   ``wkv6_ref`` on the card, at rwkv6-3b's heads with T = 1024 (B = 1 and
   8) and phase 9's ragged case, from a non-zero state, both decay forms,
   float32 and bf16: output and final state within 2e-5 of their scale,
   every gradient within 1e-4 of its scale (plus the bf16 rounding where
   a value is bf16); one launch a forward; at (8, 1024, 40, 64) bf16 the
   times of the forward, the backward formulas and the plain version
   beside the bounds of the forward and of the gradient;
26. rwkv6-3b's full width cut to 2 layers, float32: one training step's
   loss (1e-5 relative) and every gradient (1e-4 of scale) card against
   host at S = 256 (the reference's scan) and 640 (past its chunked
   threshold), the card under remat_policy "full", "dots" and "nothing"
   with each policy's launches; the card's gradients under the three
   within 1e-6 of their scale of each other;
27. ssm training: rwkv6-3b FULL in bf16 through ``repro_torch.launch.train
   --steps 20 --batch 8 --seq 1024`` (the reference's train_4k is 256 x
   4096, more than one card holds); the loss falls; every step launches
   65 RMSNorms and 32 WKV-6s in its forward and 64 and 32 in its
   recompute; the median step, tokens/s and peak memory; one step
   profiled as in phase 17, with the WKV-6 kernel's share of its device
   time, and one more with CPU activity too, with the share of the
   kernels launched inside ``Wkv6Function.backward``'s profiler range
   (32 calls);
28. remat measured: st-100m FULL (8 x 1024, float32) and rwkv6-3b FULL
   (2 x 1024, bf16), 12 steps under each of "full", "dots" and "nothing"
   from the same weights and batches: every step's time, the median
   (step 0 excluded), tokens/s, the run's
   peak memory and, apart, one forward and backward's peak over the
   memory held before it; each step's loss equal across the policies
   within 1e-5 relative;
29. the torch lane (one PyTorch ``addmm`` in full float32): its seed rows
   at the fleet shape for k = 1, 8, 64, 256 against float64 within its
   own order-free bound, once with the caller's TF32 on (switched off and
   restored); the fleet trace analyzed on the numpy, kernel and torch
   lanes with equal verdicts, each lane's analysis wall, seed-row
   launches and re-decided candidacies logged; the 19 synthetic entries
   on the torch lane equal to ``VERDICTS_synthetic.json``;
30. the command-line twins in child processes: ``python -m
   repro_torch.cli.run_bench --grid default --out <tmp>`` with every
   kernel and torch device row present, then ``--check <tmp>`` at its
   default factor 2; where it flags a regression, a fresh baseline and
   one more check, failing only where one row regressed in both
   (``bench_self_check``; every row's ratio of every check logged);
   ``repro_torch.cli.run_corpus --backend synthetic
   --distance-backend torch`` passing 19/19, and printing the same table
   under ``--jobs 4`` apart from wall_s;
31. the benchmark and example twins, in this process (no process
   start-up each): ``repro_torch.bench.run --only paper`` on the numpy,
   kernel and torch lanes with equal ``derived`` columns; ``--only
   kernels`` with every row finite and positive (a kernel row fails
   unless its kernel launched); ``repro_torch.examples.quickstart`` and
   ``moe_imbalance`` returning from ``main``;
32. multi-device and ``launch/``: the dry-run of mixtral-8x22b train_4k on
   the (2, 16, 16) mesh and of gemma-7b decode_32k on (16, 16), each a
   child process on the host's CPU (a fake world of 512 or 256 ranks,
   ``meta`` tensors), started first; meanwhile st-100m FULL float32 at
   8 x 1024 takes 3 AdamW steps through ``repro_torch.launch.train --mesh
   1x1`` (its parameters DTensors placed by ``PARAM_RULES``, each step
   under ``activation_sharding``, NCCL at world size 1, in a child) with
   each loss within 1e-5 relative of the unsharded trainer's and as many
   RMSNorm and attention launches a step; the compressed all-reduce on
   st-100m's gradient tree over NCCL in a one-rank child, equal to
   ``dequantize(quantize(g))`` bit for bit, ``collectives_of`` counting
   its int32 payload; ``examples.dryrun_triage`` in a child; each cell's
   per-rank bytes against the card's 80 GB and its three roofline
   terms logged.  The whole script's time is logged.

The six serving phases (8, 11, 20, 22, 23, 24) serve through the
compiled decode call: ``TorchBackend`` replays one CUDA graph per lane
and call shape, captured at warmup (or at a shape's first use), and adds
each graph's captured launches to the launch counter at each replay.  In
each of them a graph-parity check then runs a fresh two-lane backend of
the served model: on each lane one prompt call of the chunk shape and 4
greedy one-token calls, the lanes' replays interleaved, each against an
eager ``api.decode_step`` on a copy of the lane's state, with bit-equal
logits, equal tokens and, for MoE, equal expert ids in every layer (read
from the graph's memory).  The profiled decode window times the graphed
call (host wall, device busy, idle share, device operations per call,
profiled launches against the counter, copies to the host) and keeps
the eager call's row beside it.  Every profiled window (a decode call's,
a training step's, a kernel's or a library call's timing) starts
recording ``PROFILE_PAUSE_S`` after a warm-up launched under the freshly
turned-on CUPTI (whose first ~10 ms of launches lose their device
records), and again as long before its calls, and closes as long after
them (the card's device stamps run milliseconds off the host's clock);
it must list every launch's device records and no other, and the ported
kernels' launches the counter counts, or it is recorded again, up to
``PROFILE_TRIES`` windows, before the phase fails; decode and training
windows are logged with where any record went.

Phases 4, 5, 8, 11, 12, 13, 14, 17, 18, 20, 21, 22-24, 26-28, 29 and 32
count the kernels' launches from 0 and fail if the main path never
launched them (phase 11's tail counts its own in the child; phase 29's
torch lane must launch none, and phase 31's kernel bench checks each of
its kernel rows); they also record the
seed-row launches by seed count k (``SEED_COUNTS``) and the kernel
lane's candidacies that its float32 error bound could not settle and
re-decided on the exact lane (``AutoAnalyzer.decisions``).  A served trace whose verdicts differ
between the lanes is saved under ``build/split_traces/`` (the path
printed) before the phase raises.  The last two lines of standard output are a
``{"kernels": [...]}`` JSON line and ``{"ok": true, "device": {...}}``.

The phases are importable functions, so the CPU tests rehearse them at a
small size with ``device="cpu"``; ``main()`` itself refuses to run
without a card.
"""
from __future__ import annotations

import contextlib
import gc
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
                        "flash_attention_simt_kernel"),
    "wkv6": ("wkv6_decode_kernel", "wkv6_kernel")}
# The entry kernel each decode call of the served models must run: one
# token per call is the row-per-block RMSNorm, split-K attention (its merge
# held to it by FOLLOWERS; ``decode_symbols`` puts in the path the plan
# picks where a call packs more query rows) and the decode WKV-6.
DECODE_SYMBOLS = {"rmsnorm": "rmsnorm_row_kernel",
                  "flash_attention": "flash_attention_split_kernel",
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
    element for the dot product plus 3 for the epilogue (the kernel
    module's ``seed_rows_work``, which ``cost_of`` counts too)."""
    from repro_torch.kernels.distance import seed_rows_work
    flops, nbytes = seed_rows_work(m, n, k)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_rows(points, sq, idx):
    """One PyTorch expression of the same function: the torch lane's own
    ``addmm`` (``core/clustering.py::torch_seed_rows``, full float32), so
    the library column times the code that ships."""
    from repro_torch.core.clustering import torch_seed_rows
    return torch_seed_rows(points, sq, idx)


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


# Kineto keeps a device record only if its stamp (the device's clock, as
# CUPTI converts it to the host's) lies inside the host's recording
# window, and the two clocks disagree by milliseconds either way.  So
# recorded calls start this long after recording starts, and where a
# window is held to the launch counter it closes this long after the
# final synchronize and, when a warm-up call ran under the profiler,
# opens this long after that call's synchronize.  Closed right after the
# synchronize, a decode window dropped its last 4-197 records
# (deepseek-v2-lite-16b: 16 of 60 eager and 7 of 60 graphed windows, on
# an H100); opened right after the warm-up's, one in 60 took in the
# warm-up's last 14.
PROFILE_PAUSE_S = 0.2


PROFILE_TRIES = 3
# What :func:`_profile_rows` cost over a run: its calls, the windows they
# recorded (a lossy one is recorded again), the seconds of the two pauses
# a window gained against a window recorded from its first launch (after
# the warm-up, before the close) and of reading each window's raw list.
PROFILE_ROWS_COST = {"calls": 0, "windows": 0, "pause_s": 0.0,
                     "check_s": 0.0}


# Launches made under the freshly turned-on CUPTI before a window starts
# recording (:func:`_warm_up_cupti`).  On an H100, rwkv6-3b training
# steps recorded after none or two such launches lost the device records
# of their first 1-58 launches in 78 of 118 windows (the number grew with
# the windows the process had recorded); decode windows, warmed up by one
# decode call, lost none of 166.
CUPTI_WARM_UP_LAUNCHES = 8192


def _warm_up_cupti() -> None:
    """``CUPTI_WARM_UP_LAUNCHES`` launches of a one-element kernel: the
    first launches under a freshly turned-on CUPTI, whose device records
    are lost."""
    import torch
    x = torch.zeros(1, device="cuda")
    for _ in range(CUPTI_WARM_UP_LAUNCHES):
        x.add_(1)


def _record_window(run, activities, warm_up=None) -> tuple:
    """``run()`` recorded by torch.profiler over ``activities``: the
    profiler turns CUPTI on, :func:`_warm_up_cupti` and then ``warm_up()``
    run and are synchronized, and only ``PROFILE_PAUSE_S`` later does
    recording start (a one-cycle schedule: the warm-up's records are
    dropped; opened right at its synchronize, a window once took in its
    last records), as long again before ``run()``, and it closes
    ``PROFILE_PAUSE_S`` after ``run()``'s final synchronize (closed right
    at it, a window lost its last records).  The first launches under a
    freshly turned-on CUPTI lose their device records, each counted in
    Kineto's ``Out-of-range``, however long the window has been open
    before them.  Returns (the closed profile, the launch counter's
    delta over ``run()``, its host wall in s)."""
    import torch
    from torch.profiler import profile, schedule
    from repro_torch import kernels as K
    torch.cuda.synchronize()
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        _warm_up_cupti()
        if warm_up is not None:
            warm_up()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAUSE_S)
        prof.step()  # the warm-up's records are dropped
        time.sleep(PROFILE_PAUSE_S)
        before = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {n: K.LAUNCHES[n] - before[n] for n in before}
        time.sleep(PROFILE_PAUSE_S)
        prof.step()  # ends the recorded step
    return prof, launched, wall


def _device_rows(prof) -> list:
    """(device time us, count, key) of every row of a closed CUDA-only
    profile with device time, longest first: the CUDA activity also
    records runtime calls (cudaLaunchKernel, ...), which take none."""
    return sorted(((e.device_time_total, e.count, e.key)
                   for e in prof.key_averages() if e.device_time_total > 0),
                  reverse=True)


def _until_whole(record, what: str, span: str = "") -> tuple:
    """Profiled windows of ``record()`` -> (rows, launched, lost_at, ...),
    up to ``PROFILE_TRIES``, until one is whole: the rows' launches of
    every ported kernel equal the launch counter's delta ``launched``
    (:func:`_profiled_launches`) and the raw list lost and took in no
    device record (``lost_at`` "": counts can agree while both happen).
    Returns (the whole window's ``record()``, every window's profiled and
    counted launches and ``lost_at``); if no window is whole, fails naming
    ``what``, every window's counts and where its records went."""
    windows = []
    for _ in range(PROFILE_TRIES):
        got = record()
        rows, launched, lost_at = got[:3]
        profiled, lost = _profiled_launches(rows, launched)
        windows.append({"profiled": profiled, "counted": {
            n: c for n, c in launched.items() if c}, "lost_at": lost_at})
        if not (lost or lost_at):
            return got, windows
    raise AssertionError(
        f"{what}: none of {PROFILE_TRIES} profiled windows{span} was whole "
        f"(profiled against counted launches; what the raw list lost or "
        f"took in): "
        + "; ".join(f"window {i} {w['profiled']} against {w['counted']}, "
                    f"{w['lost_at'] or 'nothing'}"
                    for i, w in enumerate(windows, 1))
        + (f"; the last window: {lost}" if lost else ""))


def _profile_rows(fn, iters: int) -> list:
    """(device time us, count, key) of every profiler row with device time
    over ``iters`` calls of ``fn``, after one call outside the profile,
    recorded by :func:`_record_window` (recorded from the first launch
    on, a run once lost all 50 calls of a 0.02 ms kernel).  The window is
    recorded again (:func:`_until_whole`)
    while its rows' ported launches disagree with the launch counter (a
    library call's rows list none), its raw list lost or took in a device
    record, or it lists no device time."""
    import torch
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            fn()

    def record():
        prof, launched, _ = _record_window(calls, [ProfilerActivity.CUDA])
        t0 = time.perf_counter()
        lost_at = lost_records(*_launch_records(prof))
        PROFILE_ROWS_COST["check_s"] += time.perf_counter() - t0
        rows = _device_rows(prof)
        PROFILE_ROWS_COST["windows"] += 1
        PROFILE_ROWS_COST["pause_s"] += 2 * PROFILE_PAUSE_S
        return rows, launched, lost_at or ("" if rows else
                                           "no device time listed")
    PROFILE_ROWS_COST["calls"] += 1
    (rows, _, _), _ = _until_whole(
        record, f"{iters} calls of {getattr(fn, '__qualname__', fn)}")
    return rows


def device_ms(fn, kernel: str, iters: int = 100) -> float:
    """Device time per wrapper call of the ported kernel ``kernel``: the
    device time of all its CUDA symbols (a split-K call's split and merge
    kernels together) over ``iters`` calls of ``fn``, divided by the
    profiled launches of its entry kernels (held to the launch counter by
    :func:`_profile_rows`); from torch.profiler's CUPTI trace.
    Back-to-back calls through the wrapper can be bound by the host's
    per-call work instead; this separates the two."""
    sc = symbol_counts(_profile_rows(fn, iters))
    calls = sum(sc["counts"].get(s, 0) for s in ENTRY_SYMBOLS[kernel])
    return sum(sc["times"].get(s, 0.0) for s in _symbols(kernel)) / calls / 1e3


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
    symbols = symbol_counts(_profile_rows(kernel, 20))["counts"]
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

@contextlib.contextmanager
def heap_frozen():
    """The garbage of the phases before collected and what lives on
    frozen (``gc.freeze``) for the block, so the cyclic collector's full
    passes inside it scan only the block's own objects: one over phase
    17's took 140-270 ms and, landing in a corpus entry's timed call,
    read as a straggler in the wrong shard.  Unfrozen after, so what the
    block held can be collected again."""
    gc.collect()
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


def corpus_phase(device, lane: str = "kernel") -> dict:
    """The 19 synthetic corpus entries on ``lane`` (the kernel lane, or
    the torch lane), held to the committed verdict snapshot as
    ``snapshot_verdicts --check`` holds them.  Returns the seed-row
    kernel's launch count (the kernel lane must launch it on the card, the
    torch lane never), its launches by seed count and the lane's
    re-decided candidacies."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.cli.snapshot_verdicts import drift, snapshot
    from repro_torch.core.clustering import get_distance_backend
    with open(ROOT / "VERDICTS_synthetic.json") as f:
        baseline = json.load(f)
    backend = get_distance_backend(lane, device)
    K.reset_launches()
    t0 = time.perf_counter()
    current = snapshot(0, backend, device)
    wall = time.perf_counter() - t0
    launches = K.LAUNCHES["multi_seed_rows"]
    seed_counts = dict(K.SEED_COUNTS)
    bad = drift(baseline, current)
    if bad or set(current) != set(baseline):
        raise AssertionError(f"{lane}-lane verdicts drifted from "
                             f"VERDICTS_synthetic.json: {bad}")
    # On the CPU (a rehearsal) the wrapper runs its plain version, which
    # launches nothing.
    if lane == "kernel" and launches == 0 and \
            torch.device(device).type == "cuda":
        raise AssertionError("the corpus never launched the kernel")
    if lane == "torch" and launches:
        raise AssertionError("the torch lane launched the seed-row kernel")
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
              (3, 3004, 0), (4, 2560, 1), (1, 2048, 0), (256, 2048, 0),
              (1, 4096, 0), (1, 1024, 0), (1024, 1024, 0))
# Timed in bf16: the shapes the served models launch, and (300, 3840).
RMS_TIMED = ((1, 3072), (1, 2560), (256, 3072), (300, 3840), (1, 2048),
             (256, 2048), (1, 4096), (1, 1024), (1024, 1024))
GEMMA_SLOTS = 545
UNWRITTEN = 2 ** 30
ATTN_CASES = ("gemma-decode", "gemma-prefill", "danube-decode",
              "danube-prefill", "gemma-prefill-first", "mla-decode",
              "mla-prefill", "phi3v-decode", "phi3v-prefill",
              "rgemma-decode", "seamless-encode", "seamless-cross")
# The main path launches the decode shapes most (57 and 28 launches per
# decode call, 8 x 32 decode calls against 16 prefill chunks); those go
# into the machine-readable kernels line, the prefill shapes beside them
# (and rwkv6-3b's decode rows beside gemma-7b's).
RMS_MAIN, RMS_PREFILL, RMS_RWKV = (1, 3072), (256, 3072), (1, 2560)
ATTN_MAIN, ATTN_PREFILL = "gemma-decode", "gemma-prefill"
# deepseek-v2-lite-16b's serving shapes (phase 20): the d = 2048 norm rows
# and MLA's attention at dh 192 (nope 128 + rope 64, v padded from 128).
RMS_DSV2, RMS_DSV2_PREFILL = (1, 2048), (256, 2048)
ATTN_MLA = ("mla-decode", "mla-prefill")
# The last three families' serving shapes (phases 22-24): the norm rows of
# recurrentgemma-9b (d 4096) and seamless-m4t-medium (d 1024, and its
# 1024-frame encode), phi-3-vision-4.2b's dh 96 (padded to 128 inside the
# kernel), recurrentgemma-9b's local MQA decode (16 query rows on one kv
# head) and seamless's non-causal encoder and cross-attention.
RMS_FAMILIES = ((1, 4096), (1, 1024), (1024, 1024))
ATTN_FAMILIES = ("phi3v-decode", "phi3v-prefill", "rgemma-decode",
                 "seamless-encode", "seamless-cross")
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
    """Shape and positions of one attention check (causal unless the case
    says ``causal=False``).  gemma: H = KV = 16, dh = 256 over the
    545-slot cache; decode at position 272 with slots 273.. unwritten,
    prefill of the first 256-token chunk (positions 0..255 over written
    slots 0..255, slots 256..544 unwritten: the main path's first chunk,
    where key tiles are skipped) and of the second (positions 256..511
    over written slots 0..511).  phi3v: the same over H = KV = 32 heads of
    dh = 96.  danube: H = 32, KV = 8, dh = 120, window 4096 over a
    4096-slot ring at position 5000 (slot i holds position i + 4096 for
    i <= 904, else i), decode and a 256-token chunk ending there.  rgemma:
    recurrentgemma-9b's local MQA, H = 16, KV = 1, dh = 256, window 2048
    over a wrapped 2048-slot ring at position 3000, decode.  mla
    (deepseek-v2-lite-16b at --prompt-len 512 --gen 32): H = KV = 16, q
    and k at dh = 192, v at ``dv`` = 128 zero-padded to 192, over the
    545-slot latent cache decompressed whole (slot i at position i, as
    MLA's cache places its keys); decode at position 544 and the second
    256-token chunk at positions 256..511.  seamless: H = KV = 16, dh =
    64, non-causal over 1024 encoder frames, the encoder's self-attention
    (Q = 1024) and a decoder token's cross-attention (Q = 1 at position
    40)."""
    import numpy as np
    if name.startswith("mla"):
        q_pos = (np.array([GEMMA_SLOTS - 1]) if name == "mla-decode"
                 else np.arange(256, 512))
        return dict(H=16, KV=16, dh=192, dv=128, window=None, q_pos=q_pos,
                    k_pos=np.arange(GEMMA_SLOTS))
    if name.startswith("seamless"):
        q_pos = (np.arange(1024) if name == "seamless-encode"
                 else np.array([40]))
        return dict(H=16, KV=16, dh=64, window=None, causal=False,
                    q_pos=q_pos, k_pos=np.arange(1024))
    if name.startswith(("gemma", "phi3v")):
        model, kind = name.split("-", 1)
        Q, written = {"decode": (1, 273), "prefill": (256, 512),
                      "prefill-first": (256, 256)}[kind]
        k_pos = np.full(GEMMA_SLOTS, UNWRITTEN, np.int64)
        k_pos[:written] = np.arange(written)
        q_pos = np.arange(written - Q, written)
        H, dh = (16, 256) if model == "gemma" else (32, 96)
        return dict(H=H, KV=H, dh=dh, window=None, q_pos=q_pos,
                    k_pos=k_pos)
    H, KV, dh, slots, last = ((32, 8, 120, 4096, 5000)
                              if name.startswith("danube")
                              else (16, 1, 256, 2048, 3000))
    i = np.arange(slots)
    k_pos = np.where(i <= last - slots, i + slots, i)
    Q = 1 if name.endswith("decode") else 256
    return dict(H=H, KV=KV, dh=dh, window=slots,
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
    v[..., c.get("dv", c["dh"]):] = 0.0   # MLA's v, zero-padded
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
        causal = attention_case(name).get("causal", True)
        got = K.flash_attention(q, k, v, qp, kp, causal=causal,
                                window=window)
        want = K.flash_attention_ref(q.float(), k.float(), v.float(), qp, kp,
                                     causal=causal, window=window)
        if got.dtype != dtype or got.shape != q.shape:
            raise AssertionError(f"attention gave {got.dtype} {got.shape}")
        errs[tag] = _close(got, want, tol, f"attention {name} {tag}")
        dv = attention_case(name).get("dv", q.shape[3])
        if bool(got[..., dv:].any()):   # zero columns of v average to 0
            raise AssertionError(f"attention {name} {tag}: columns {dv}.. "
                                 f"of the output are not 0")
    return errs


def rmsnorm_bound_ms(n: int, d: int, itemsize: int) -> tuple:
    """x and w read once, y written once; 4 float32 operations an
    element (square-add, scale, 1 + w, product): the kernel module's
    ``rmsnorm_work``, which ``cost_of`` counts too."""
    from repro_torch.kernels.rmsnorm import rmsnorm_work
    flops, nbytes = rmsnorm_work(n, d, itemsize)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
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


def attention_bound_ms(name: str, itemsize: int, padded: bool = False
                       ) -> tuple:
    """q, the k and v of the keys the function needs (``needed_keys``) and
    the positions read once, the output written once; 4·dh operations
    (score and P·V) for every unmasked (query, key, head) of this case's
    positions, at the tensor-core rate for bf16 and the float32 rate
    otherwise.  The counts are the kernel module's ``attention_work``,
    which ``cost_of`` counts too.  An MLA case counts the function's own
    work, v and the output at its ``dv`` columns (2·(dh + dv) operations
    a live pair); ``padded`` counts them at dh, as the kernel is called."""
    import numpy as np
    from repro_torch.kernels.flash_attention import attention_work
    c = attention_case(name)
    Q, K, H, KV, dh = (len(c["q_pos"]), len(c["k_pos"]), c["H"], c["KV"],
                       c["dh"])
    qp, kp = c["q_pos"][:, None], c["k_pos"][None, :]
    live = (kp <= qp if c.get("causal", True)
            else np.ones((Q, K), dtype=bool))
    if c["window"] is not None:
        live &= kp > qp - c["window"]
    pairs, keys = int(np.count_nonzero(live)), needed_keys(live)
    ops, nbytes = attention_work(1, Q, H, KV, dh, K, itemsize, pairs, keys)
    dv = c.get("dv", dh)
    if dv != dh and not padded:
        ops = 2.0 * (dh + dv) * H * pairs
        nbytes = (itemsize * (Q * H * (dh + dv) + keys * KV * (dh + dv))
                  + 4 * (Q + K))
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
    causal = attention_case(name).get("causal", True)
    g = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2).contiguous()
    kh = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    mask = (kp[None, :] <= qp[:, None] if causal else
            torch.ones((len(qp), len(kp)), dtype=torch.bool, device="cuda"))
    if window is not None:
        mask &= kp[None, :] > qp[:, None] - window
    scale = 1.0 / math.sqrt(q.shape[3])
    b_ms, b_by = attention_bound_ms(name, 2)

    def kernel():
        return K.flash_attention(q, k, v, qp, kp, causal=causal,
                                 window=window)

    def plain():
        return K.flash_attention_ref(q, k, v, qp, kp, causal=causal,
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
        "bound_ms": b_ms, "bound_by": b_by,
        "padded_bound_ms": attention_bound_ms(name, 2, padded=True)[0],
        "plan": plan._asdict(),
    }


# -- phase 7 ---------------------------------------------------------------

# Logits of the card's kernel path against the host's plain path, both
# float32 with TF32 off: max |card - host| <= PARITY_RTOL * max |host|.
# The two differ only in summation order (cuBLAS and the kernels against
# the CPU's BLAS and the plain versions), about 1e-6 of the logits' scale.
PARITY_RTOL = 1e-4


def parity_config(arch: str = "gemma-7b", n_layers: int = 2):
    """``arch`` at full width, cut to ``n_layers`` layers (an encdec's
    encoder too), in float32."""
    from repro_torch.configs import get_arch
    full = get_arch(arch).full
    enc = {"n_encoder_layers": n_layers} if full.family == "encdec" else {}
    return full.with_(n_layers=n_layers, dtype="float32",
                      param_dtype="float32", **enc)


def _attention_layers(cfg) -> int:
    """Attention sublayers of a decoder-only model: every layer but a
    hybrid's recurrent ones."""
    if cfg.family != "hybrid":
        return cfg.n_layers
    from repro_torch.models.transformer import hybrid_pattern
    n_blocks, tail = hybrid_pattern(cfg)
    kinds = list(cfg.recurrent.block_pattern) * n_blocks + list(tail)
    return cfg.n_layers - kinds.count("rec")


def launches_per_call(cfg) -> dict:
    """The kernel launches of one model call (a decode call, or a
    decoder-only forward) of ``cfg`` on the card: two RMSNorms a layer and
    the final one, and one attention a layer (a hybrid's attention
    sublayers only) or one WKV-6 a layer (ssm); an encdec decoder layer has
    three RMSNorms and two attentions (self and cross).  No other kernel."""
    L = cfg.n_layers
    if cfg.family == "encdec":
        return {"rmsnorm": 3 * L + 1, "flash_attention": 2 * L}
    if cfg.family == "ssm":
        return {"rmsnorm": 2 * L + 1, "wkv6": L}
    return {"rmsnorm": 2 * L + 1, "flash_attention": _attention_layers(cfg)}


def launches_per_encode(cfg) -> dict:
    """An encdec encode's launches: two RMSNorms an encoder layer and the
    final one, one (non-causal) attention a layer."""
    L = cfg.n_encoder_layers
    return {"rmsnorm": 2 * L + 1, "flash_attention": L}


def recompute_per_step(cfg) -> dict:
    """The launches the backward's recompute adds to one training step
    under ``cfg.remat_policy`` (``models.transformer.remat``, the
    reference's ``_maybe_remat``): none under "full"; under any other
    policy every remat'd block runs its kernels again — each layer of a
    decoder-only model (a hybrid's pattern groups, not its tail), each
    encoder and decoder layer of an encdec.  The embedding, the final
    norms and the head are not recomputed."""
    if cfg.remat_policy == "full":
        return {}
    L = cfg.n_layers
    if cfg.family == "encdec":
        Le = cfg.n_encoder_layers
        return {"rmsnorm": 3 * L + 2 * Le, "flash_attention": 2 * L + Le}
    if cfg.family == "ssm":
        return {"rmsnorm": 2 * L, "wkv6": L}
    if cfg.family == "hybrid":
        from repro_torch.models.transformer import hybrid_pattern
        n_blocks, _ = hybrid_pattern(cfg)
        pat = cfg.recurrent.block_pattern
        return {"rmsnorm": 2 * n_blocks * len(pat),
                "flash_attention": n_blocks * (len(pat) - pat.count("rec"))}
    return {"rmsnorm": 2 * L, "flash_attention": L}


def _check_launches(launches: dict, cfg, calls: int, what: str,
                    encodes: int = 0, steps: int = 0) -> None:
    """Every kernel launched exactly ``calls`` times its per-call count,
    ``encodes`` times its per-encode count and ``steps`` times the
    recompute of a training step (``steps`` of the calls were forwards
    that autograd recorded and differentiated), the others not at all."""
    from repro_torch import kernels as K
    want = {name: 0 for name in K.LAUNCHES}
    want.update({k: n * calls for k, n in launches_per_call(cfg).items()})
    if encodes:
        for k, n in launches_per_encode(cfg).items():
            want[k] += n * encodes
    for k, n in recompute_per_step(cfg).items():
        want[k] += n * steps
    if launches != want or calls == 0:
        raise AssertionError(f"{what} launched {launches}, want {want} for "
                             f"{calls} model calls, {encodes} encodes and "
                             f"{steps} training steps under remat_policy "
                             f"{cfg.remat_policy!r}")


def parity_models(cfg, device, seed: int = 0) -> tuple:
    """Seeded weights on the host and a copy of them on ``device``."""
    from repro_torch.models import family_module
    mod = family_module(cfg)
    host = mod.init(cfg, seed, "cpu")
    card = mod.init(cfg, None, device)
    card.load_state_dict(host.state_dict())
    return host, card


def stub_frames(cfg, seed: int = 0, batch: int = 1):
    """The stub frontend's frames (batch, frontend_tokens, d), float32 on
    the host, seeded."""
    import torch
    gen = torch.Generator().manual_seed(seed * 131 + 7)
    return torch.randn((batch, cfg.frontend_tokens, cfg.d_model),
                       generator=gen)


def model_parity_phase(cfg, device, chunk: int = 16, steps: int = 4,
                       seed: int = 0, record=None, models=None,
                       prefill_chunk: int | None = None) -> dict:
    """Seeded weights on the host, copied to ``device`` (or the ``models``
    (host, card) given); a ``chunk``-token prompt prefilled in pieces of
    ``prefill_chunk`` tokens (default: one piece) then ``steps`` greedy
    decode steps on each, each side feeding its own greedy tokens; an
    encdec decodes against the encoding of :func:`stub_frames`.  Logits
    must agree within PARITY_RTOL of their scale and the greedy tokens
    must be equal; on the card every model call must launch its
    ``launches_per_call`` (and the encode its ``launches_per_encode``).
    With ``record`` (model -> a list it fills during the calls) the
    result's ``recorded`` holds each side's list."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    host, card = models if models is not None else \
        parity_models(cfg, device, seed)
    piece = prefill_chunk or chunk
    prompt = np.random.default_rng(seed + 11).integers(
        0, cfg.vocab, size=(1, chunk), dtype=np.int32)
    encodes = int(cfg.family == "encdec")
    out, recorded = {}, {}
    for side, model in (("card", card), ("host", host)):
        dev = model.device
        if record is not None:
            recorded[side] = record(model)
        K.reset_launches()
        max_len = chunk + steps + 1
        if encodes:
            with torch.no_grad():
                enc = model.encode(stub_frames(cfg, seed).to(dev))
            state = model.init_decode_state(1, max_len, enc_out=enc)
        else:
            state = model.init_decode_state(1, max_len)
        rows = []
        for a in range(0, chunk, piece):
            k = min(piece, chunk - a)
            pos = (torch.arange(a, a + k, dtype=torch.int32, device=dev)
                   if k > 1 else a)
            logits, _ = model.decode_step(
                state, torch.as_tensor(prompt[:, a:a + k], device=dev), pos)
            rows.append(logits[0].cpu())
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
    calls = -(-chunk // piece) + steps
    if torch.device(device).type == "cuda":
        _check_launches(launches, cfg, calls, "model parity run", encodes)
    return {"max_abs_err": err, "logit_scale": scale, "tokens": card_tokens,
            "launches": launches, "calls": calls, "recorded": recorded}


# -- phases 22-24 ----------------------------------------------------------

# Each new family's width cut card against host (phase 7's check, with the
# family's inputs), then one training step's loss and gradients (phase
# 16's tolerances): (forward text tokens, decode prompt, its prefill
# pieces, train batch, train sequence).  A vlm's forward and train batch
# carry its patch prefix (text after the prefix: 64 tokens), an encdec's
# its 1024 stub frames; the hybrid and encdec families prefill one token a
# call, as they are served.
FAMILY_PARITY = {"vlm": (64, 16, None, 1, None),
                 "hybrid": (16, 16, 1, 1, 32),
                 "encdec": (16, 4, 1, 1, 64)}


def forward_parity(cfg, host, card, device, text: int, seed: int = 0
                   ) -> dict:
    """One forward on each side: ``text`` tokens after a vlm's patch
    prefix, or over an encdec's encoded stub frames (its encoder output
    compared too); logits within PARITY_RTOL of their scale."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    toks = torch.as_tensor(np.random.default_rng(seed + 5).integers(
        0, cfg.vocab, size=(1, text), dtype=np.int32))
    frames = stub_frames(cfg, seed) if cfg.frontend else None
    out = {}
    for side, model in (("card", card), ("host", host)):
        dev = model.device
        emb = None if frames is None else frames.to(dev)
        K.reset_launches()
        with torch.no_grad():
            logits, _ = model(toks.to(dev), embeds=emb)
            enc = (model.encode(emb).cpu() if cfg.family == "encdec"
                   else None)
        out[side] = (logits.cpu(), enc, dict(K.LAUNCHES))
    (c_logits, c_enc, launches), (h_logits, h_enc, _) = \
        out["card"], out["host"]
    if not bool(torch.isfinite(c_logits).all()):
        raise AssertionError("non-finite forward logits on the card")
    res = {"shape": list(c_logits.shape)}
    for what, c, h in (("forward logits", c_logits, h_logits),
                       ("encoder output", c_enc, h_enc)):
        if c is None:
            continue
        err, scale = float((c - h).abs().max()), float(h.abs().max())
        if err > PARITY_RTOL * scale:
            raise AssertionError(f"{what}: max |card - host| {err} above "
                                 f"{PARITY_RTOL} x {scale}")
        key = "max_abs_err" if what == "forward logits" else "encoder_err"
        res[key] = err
        res[key.replace("err", "scale").replace("max_abs_", "")] = scale
    if torch.device(device).type == "cuda":
        encodes = 2 * int(cfg.family == "encdec")
        _check_launches(launches, cfg, 1, "forward parity", encodes)
    res["launches"] = launches
    return res


def step_grads(cfg, model, batch: int, seq: int, seed: int = 0) -> tuple:
    """``(loss, {name: gradient on the host}, launches, text shape)`` of
    one training step's differentiation (``value_and_grad``, under
    ``cfg``'s remat policy) at ``model``'s weights, for the
    ``data.batch_for_model`` batch of ``seed`` (a vlm's and an encdec's
    with their stub embeds), launch counts from 0."""
    from repro_torch import kernels as K
    from repro_torch.configs import SHAPES
    from repro_torch.data import batch_for_model
    from repro_torch.models import family_module
    from repro_torch.train.loop import value_and_grad
    skeleton = family_module(cfg).init(cfg, None, "meta")
    b = batch_for_model(cfg, SHAPES["train_4k"], batch_override=batch,
                        seq_override=seq, step=seed, device=model.device)
    params = {k: p.detach() for k, p in model.named_parameters()}
    K.reset_launches()
    loss, _, grads = value_and_grad(skeleton, params, b)
    return (float(loss), {k: g.cpu() for k, g in grads.items()},
            dict(K.LAUNCHES), list(b["tokens"].shape))


def hold_grads(cfg, card_step: tuple, host_step: tuple, device,
               what: str = "training step") -> dict:
    """A card step (:func:`step_grads`) against the host's: loss within
    TRAIN_LOSS_RTOL relative, every gradient within GRAD_TOL of its scale,
    and on the card the launches of one differentiated forward."""
    (c_loss, c_grads, launches, shape), (h_loss, h_grads, _, _) = \
        card_step, host_step
    if not abs(c_loss - h_loss) <= TRAIN_LOSS_RTOL * abs(h_loss):
        raise AssertionError(f"{what}: loss card {c_loss}, host {h_loss}")
    grad_err = {k: _within_scale(c_grads[k], h_grads[k], GRAD_TOL,
                                 f"{what}: gradient {k}") for k in h_grads}
    if _on_card(device):
        _check_launches(launches, cfg, 1, what,
                        int(cfg.family == "encdec"), steps=1)
    worst = max(grad_err, key=grad_err.get)
    return {"loss": [c_loss, h_loss], "worst_grad": [worst, grad_err[worst]],
            "grad_err": {k: grad_err[k] for k in ("vis_proj",)
                         if k in grad_err},
            "launches": launches, "text_shape": shape}


def grad_parity(cfg, host, card, device, batch: int, seq: int,
                seed: int = 0) -> dict:
    """One training step's loss and every gradient on each side for the
    same batch (:func:`step_grads`), held by :func:`hold_grads`."""
    return hold_grads(cfg, step_grads(cfg, card, batch, seq, seed),
                      step_grads(cfg, host, batch, seq, seed), device)


def family_parity_phase(cfg, device, seed: int = 0) -> dict:
    """A vlm, hybrid or encdec config card against host (``FAMILY_PARITY``):
    a forward, prefill and greedy decode, then one training step."""
    text, prompt, piece, batch, seq = FAMILY_PARITY[cfg.family]
    host, card = parity_models(cfg, device, seed)
    res = {"forward": forward_parity(cfg, host, card, device, text, seed)}
    res["decode"] = model_parity_phase(cfg, device, chunk=prompt, seed=seed,
                                       models=(host, card),
                                       prefill_chunk=piece)
    res["decode"].pop("recorded")
    if seq is None:
        seq = cfg.frontend_tokens + text
    res["train"] = grad_parity(cfg, host, card, device, batch, seq, seed)
    return res


def prefixed_forward(model, text: int = 64, seed: int = 0) -> dict:
    """A vlm's forward over its stub patch prefix and ``text`` tokens, on
    its device: the logits must be finite."""
    import torch
    cfg = model.cfg
    gen = torch.Generator().manual_seed(seed)
    embeds = torch.randn((1, cfg.frontend_tokens, cfg.d_model),
                         generator=gen).to(model.device)
    toks = torch.randint(0, cfg.vocab, (1, text), generator=gen)
    with torch.no_grad():
        logits, _ = model(toks.to(model.device), embeds=embeds)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits in the prefixed forward")
    return {"shape": list(logits.shape), "finite": True,
            "scale": float(logits.abs().max())}


# -- phase 19 --------------------------------------------------------------

def record_routes(model) -> list:
    """A list that fills, as ``model`` runs, with one (expert ids (L, S,
    k), router probabilities (L, S, E)) pair a model call, both on the
    host: a forward hook on every layer's MoE recomputes its routing
    (``moe.route``, the function ``moe_block`` routes with) from the
    layer's input, on its device."""
    import torch
    from repro_torch.models import moe
    layers, calls = [], []
    n = len(model.blocks)

    def hook(mod, args, out):
        probs, _, ids = moe.route(mod, mod.cfg, args[0])
        layers.append((ids[0].cpu(), probs[0].cpu()))
        if len(layers) == n:
            calls.append(tuple(torch.stack(t) for t in zip(*layers)))
            layers.clear()
    for block in model.blocks:
        block.moe.register_forward_hook(hook)
    return calls


def moe_parity_phase(cfg, device, chunk: int = 16, steps: int = 4,
                     seed: int = 0) -> dict:
    """``model_parity_phase`` on an MoE config, with every token's expert
    ids in every layer held equal on card and host, call by call, and the
    smallest top-k margin over them on the host (the k-th largest router
    probability minus the (k+1)-th): a flip of routing between the sides
    where the margin nears float32 rounding would show here first."""
    import torch
    res = model_parity_phase(cfg, device, chunk, steps, seed,
                             record=record_routes)
    rec = res.pop("recorded")
    card, host = rec["card"], rec["host"]
    if len(card) != len(host) or len(host) != res["calls"]:
        raise AssertionError(f"recorded {len(card)} and {len(host)} routed "
                             f"calls for {res['calls']} model calls")
    k = cfg.moe.top_k
    margin = float("inf")
    for i, ((c_ids, _), (h_ids, h_probs)) in enumerate(zip(card, host)):
        if not torch.equal(c_ids, h_ids):
            raise AssertionError(
                f"model call {i}: expert ids differ between card and host "
                f"at (layer, token, choice) "
                f"{(c_ids != h_ids).nonzero().tolist()[:8]}")
        top = torch.sort(h_probs, dim=-1, descending=True).values
        margin = min(margin, float((top[..., k - 1] - top[..., k]).min()))
    res["expert_ids"] = [c.tolist() for c, _ in card]
    res["min_margin"] = margin
    return res


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
                watch_interval: float | None = None, after=None) -> dict:
    """Serve the traffic through ``repro_torch.launch.serve`` with launch
    counts from 0 (on the card every call a replay of its lane's graph);
    every model call must have launched its ``launches_per_call`` (and
    every encdec encode its ``launches_per_encode``), the peak device
    memory must fit the card, the compiled call must equal the eager one
    (:func:`graph_parity`),
    every request must complete with its tokens in the vocabulary, and the
    saved serving trace, analyzed on the kernel lane and on the numpy
    lane, must give equal verdict docs.

    With ``spool_dir`` the server also spools its steps there while a
    child process tails the spool live (``LiveTail``); the result's
    ``live`` holds what the tail saw.  ``after(backend)``, run last, puts
    its result under ``after`` (the served model is freed when the phase
    returns)."""
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
    cfg, calls, encodes = backend.cfg, backend.model_calls, \
        backend.encode_calls
    if on_card:
        _check_launches(launches, cfg, calls, "serving", encodes)
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
    parity = graph_parity(backend)
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
            "graph_parity": parity,
            "model_calls": calls, "encode_calls": encodes,
            "launches": launches,
            "max_memory_allocated": peak, "verdict": doc_n,
            "analysis_launches": analysis_launches,
            "seed_counts": seed_counts, "decisions": dict(an_k.decisions),
            "trace_shape": [trace.n_steps, trace.n_processes,
                            len(trace.region_ids)], "live": live,
            "after": None if after is None else after(backend)}


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


def clone_state(state):
    """A copy of a decode state (nested dicts and lists of tensors)."""
    if isinstance(state, dict):
        return {k: clone_state(v) for k, v in state.items()}
    if isinstance(state, list):
        return [clone_state(v) for v in state]
    return state.clone()


def decode_breakdown(backend,
                     steps: int = DECODE_PROFILE_STEPS) -> dict:
    """Where one lane's decode call spends the card's time, as served and
    eagerly: lane 0 reset and one prefill chunk through its graph; then,
    for the graphed call (lane 0's (1, 1) graph replayed,
    ``TorchBackend.model_call``) and for the eager call (``api.decode_step``
    on a copy of the lane's state), one decode call while torch.profiler
    (CUDA activity only) warms up and drops its records, then ``steps``
    greedy decode calls recorded.  Returns the graphed call's row with the
    eager one's under ``eager``: the host wall per call, the device's busy
    time per call (the sum of its kernels' and copies' times), the idle
    share 1 - busy / wall, the device operations per call, each ported
    kernel's device time per call and the kernels that took longest.  The
    busy time is only as complete as the profiler's event list, so each
    ported kernel's profiled launches are held to the launch counter over
    the same calls (``profile_complete``; a replay adds its graph's
    captured launches to the counter), and no call may copy a value to
    the host (deepseek's MoE dispatch included).  Each window closes
    ``PROFILE_PAUSE_S`` after its last call (closed right after it, the
    window's last records fell out of it) and opens as long after the
    warm-up call (opened at once, it took in the warm-up's last records);
    a window whose list still disagrees with the counter, or whose raw
    list lost or took in a device record (``lost_records``: counts can
    agree while both happen), is recorded again, the state carried on,
    up to ``PROFILE_TRIES`` windows in all, and if none is whole the
    phase fails naming the model, the way, every window's counts and
    where its records were lost.  Each row keeps its way's windows under
    ``windows`` (the row's is the last)."""
    import torch
    api, model, k = backend.api, backend.model, backend.prefill_chunk
    state = backend.fresh_state(lane=0)
    logits = backend.model_call(
        0, torch.zeros((1, k), dtype=torch.int32, device=backend.device), 0)
    tok = backend._sample(logits)
    torch.cuda.synchronize()
    eager_state = clone_state(state)
    ways = {"graphed": lambda t, pos: backend.model_call(0, t, pos),
            "eager": lambda t, pos: api.decode_step(model, eager_state, t,
                                                    pos)[0]}
    out = {}
    for way, call in ways.items():
        at = {"tok": tok, "pos": k}

        def record():
            rows, launched, wall, at["tok"], lost_at = _decode_window(
                call, at["tok"], at["pos"], steps)
            at["pos"] += steps + 1
            return rows, launched, lost_at, wall
        (rows, launched, _, wall), windows = _until_whole(
            record, f"{backend.cfg.name}'s {way} decode call",
            f" of {steps} calls")
        out[way] = row = _window_row(
            rows, launched, wall, steps,
            decode_symbols(backend.cfg, backend.max_len))
        row["windows"] = windows
        if row["copies_to_host"]:
            raise AssertionError(
                f"{backend.cfg.name}'s {way} decode call copies "
                f"{row['copies_to_host']} values a call to the host")
    return {**out["graphed"], "eager": out["eager"]}


def _window_row(rows, launched: dict, wall: float, steps: int,
                symbols: dict) -> dict:
    """A profiled window's row: see :func:`decode_breakdown`."""
    busy = sum(r[0] for r in rows) / 1e6
    profiled = profile_complete(rows, launched)
    sc = symbol_counts(rows)
    check_decode_symbols(sc["counts"], launched, symbols)
    times = sc["times"]
    ported = {n: sum(times.get(sym, 0.0) for sym in _symbols(n)) / steps
              / 1e3 for n, c in launched.items() if c}
    # a value read back to the host inside a call (.item(), nonzero, a
    # boolean mask) shows as a copy to the host
    to_host = sum(c for _, c, key in rows if key.startswith("Memcpy DtoH"))
    return {"wall_ms": wall / steps * 1e3, "busy_ms": busy / steps * 1e3,
            "copies_to_host": to_host / steps,
            "ported_ms": ported,
            "idle_share": 1.0 - busy / wall,
            "launches": sum(r[1] for r in rows) / steps,
            "profiled_launches": profiled,
            "counted_launches": {n: c for n, c in launched.items() if c},
            "symbols": sc["counts"],
            "top": [(t / steps / 1e3, c // steps, key[:90])
                    for t, c, key in rows[:10]]}


def _decode_window(call, tok, pos: int, steps: int) -> tuple:
    """One decode call ``call(tok, pos)`` -> logits as the warm-up of
    :func:`_record_window` (CUDA activity), then ``steps`` greedy decode
    calls recorded.  Returns (profiler rows with device time, the
    launch-counter delta over the recorded calls, their host wall in s,
    the last token, where the raw list lost device records or took in
    others: :func:`lost_records` of :func:`_launch_records`)."""
    import torch
    from torch.profiler import ProfilerActivity
    at = {"tok": tok}

    def greedy(i):
        logits = call(at["tok"], pos + i)
        at["tok"] = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)

    def calls():
        for i in range(1, steps + 1):
            greedy(i)
    prof, launched, wall = _record_window(calls, [ProfilerActivity.CUDA],
                                          warm_up=lambda: greedy(0))
    return (_device_rows(prof), launched, wall, at["tok"],
            lost_records(*_launch_records(prof)))


def _launch_records(prof) -> tuple:
    """A closed profile's raw Kineto list as launches: (each runtime
    launch in launch order as (its API call, the device records it has),
    the device records of launches outside the list).  A kernel, copy or
    memset launch has one device record; a graph launch one per node.  A
    device record shares its launch's correlation id."""
    from torch.autograd import DeviceType
    device, runtime = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():   # a range's span, with CPU activity
            continue
        if e.device_type() == DeviceType.CUDA:
            device[e.correlation_id()] = device.get(e.correlation_id(),
                                                    0) + 1
        elif e.name().startswith("cu") and any(
                w in e.name() for w in ("Launch", "Memcpy", "Memset")):
            runtime[e.correlation_id()] = e.name()
    return ([(runtime[c], device.get(c, 0)) for c in sorted(runtime)],
            sum(n for c, n in device.items() if c not in runtime))


def lost_records(launches, strays: int = 0) -> str:
    """Where a window's raw list lost device records, from its launches
    ((API call, device records) in launch order, :func:`_launch_records`):
    a launch lost what it has fewer than one record, or, a graph launch,
    than the most any launch of the window's graphs has.  ``strays``, the
    device records of launches outside the window, are named too.  ""
    when none was lost and none strayed in."""
    most = max((n for api, n in launches if "Graph" in api), default=1)
    short = [(i, want - n) for i, (api, n) in enumerate(launches)
             for want in [most if "Graph" in api else 1] if n < want]
    where = []
    if short:
        first, last = short[0][0], short[-1][0]
        tail = (last == len(launches) - 1
                and last - first + 1 == len(short))
        where.append(
            f"{sum(n for _, n in short)} device records of {len(short)} "
            f"launches, launch {first + 1} to {last + 1} of "
            f"{len(launches)}"
            + (" (the window's last launches)" if tail else ""))
    if strays:
        where.append(f"{strays} device records of launches made before "
                     f"the window opened")
    return "; ".join(where)


GRAPH_LANES = 2
GRAPH_DECODES = 4


class GraphRoutes:
    """Expert ids of every MoE layer of ``model``, recorded by a forward
    hook that recomputes the layer's routing (``moe.route``) from its
    input.  Ids of an eager call go to ``eager``; a graph capture's ids
    tensor goes to ``captured``, in the graph's memory, where every replay
    of that graph writes the replay's ids (a replay runs no Python)."""

    def __init__(self, model):
        self.eager, self.captured = [], []
        self.handles = [block.moe.register_forward_hook(self._hook)
                        for block in model.blocks]

    def _hook(self, mod, args, out):
        import torch
        from repro_torch.models import moe
        ids = moe.route(mod, mod.cfg, args[0])[2]
        capturing = (args[0].is_cuda
                     and torch.cuda.is_current_stream_capturing())
        (self.captured if capturing else self.eager).append(ids)

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def graph_parity(served, seed: int = 0, lanes: int = GRAPH_LANES,
                 decodes: int = GRAPH_DECODES) -> dict:
    """The compiled decode call against the eager one, on a fresh
    ``lanes``-lane backend of ``served``'s model: its calls of both shapes
    made ready (on the card each lane's graphs captured), each lane reset
    (an encdec's from stub frames), then one prompt call of the chunk
    shape (a seeded prompt) and ``decodes`` greedy one-token calls, the
    lanes' calls run one after another before any is checked (a graph's
    logits must survive the other lanes' replays).  Each call's logits
    must equal bit for bit those of ``api.decode_step`` on a copy of the
    lane's state, its greedy token the eager one, and for MoE every
    layer's expert ids the eager call's.  On the card every launch is
    held to ``launches_per_call``; on the CPU the backend's static path
    calls the model, so the check holds it to the eager call there."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.serve import TorchBackend
    cfg, dev, api = served.cfg, served.device, served.api
    b = TorchBackend(cfg, api, served.model, lanes=lanes,
                     max_len=served.max_len,
                     prefill_chunk=served.prefill_chunk, seed=seed,
                     embeds_fn=served.embeds_fn)
    k = b.prefill_chunk
    routes = GraphRoutes(served.model) if cfg.moe is not None else None
    try:
        K.reset_launches()
        captured = {}
        for lane in range(lanes):
            for shape in sorted({1, k}):
                n = len(routes.captured) if routes else 0
                b.prepare(lane, shape)
                if routes:
                    captured[(lane, shape)] = routes.captured[n:]
        eager_states, tokens = [], [[] for _ in range(lanes)]
        for lane in range(lanes):
            frames = (stub_frames(cfg, seed + lane).to(dev)
                      if cfg.family == "encdec" else None)
            eager_states.append(clone_state(b.fresh_state(frames, lane=lane)))
        prompts = [torch.from_numpy(np.random.default_rng(seed + 31 + lane)
                                    .integers(0, cfg.vocab, (1, k),
                                              dtype=np.int32)).to(dev)
                   for lane in range(lanes)]
        eager_calls, ids_checked = 0, 0
        for i in range(decodes + 1):
            start = 0 if i == 0 else k + i - 1
            ins = [prompts[lane] if i == 0 else torch.tensor(
                [[tokens[lane][-1]]], dtype=torch.int32, device=dev)
                for lane in range(lanes)]
            graphed, graphed_ids = [], []
            for lane in range(lanes):
                n = len(routes.eager) if routes else 0
                graphed.append(b.model_call(lane, ins[lane], start))
                if routes:   # the CPU's static path calls the model
                    ids = routes.eager[n:] or captured[(lane, ins[lane]
                                                        .shape[1])]
                    graphed_ids.append(torch.stack([t[0] for t in ids])
                                       .cpu())
                    del routes.eager[n:]
            for lane in range(lanes):
                pos = (torch.arange(start, start + k, dtype=torch.int32,
                                    device=dev) if i == 0 and k > 1
                       else start)
                n = len(routes.eager) if routes else 0
                want = api.decode_step(served.model, eager_states[lane],
                                       ins[lane], pos)[0]
                eager_calls += 1
                got, shape = graphed[lane], tuple(ins[lane].shape)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{cfg.name} lane {lane}, call {i} (shape {shape}): "
                        f"graphed logits differ from eager ones by up to "
                        f"{float((got - want).abs().max())}")
                tok, want_tok = (int(torch.argmax(t[0, -1]))
                                 for t in (got, want))
                if tok != want_tok:
                    raise AssertionError(f"{cfg.name} lane {lane}, call {i}"
                                         f": greedy token {tok} against "
                                         f"the eager {want_tok}")
                tokens[lane].append(tok)
                if routes:
                    want_ids = torch.stack([t[0] for t in routes.eager[n:]]
                                           ).cpu()
                    if not torch.equal(graphed_ids[lane], want_ids):
                        raise AssertionError(
                            f"{cfg.name} lane {lane}, call {i}: expert ids "
                            f"of the graphed call differ from the eager "
                            f"call's")
                    ids_checked += 1
                    del routes.eager[n:]
        launches = dict(K.LAUNCHES)
        if dev.type == "cuda":
            _check_launches(launches, cfg, b.model_calls + eager_calls,
                            "graph parity", b.encode_calls)
    finally:
        if routes:
            routes.remove()
    return {"lanes": lanes, "calls_per_lane": decodes + 1,
            "shapes": sorted({1, k}), "tokens": tokens,
            "graphs": sum(c.graph is not None for c in b._calls.values()),
            "expert_id_calls": ids_checked, "launches": {
                n: c for n, c in launches.items() if c},
            "model_calls": b.model_calls, "eager_calls": eager_calls}


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


def decode_symbols(cfg, max_len: int) -> dict:
    """``DECODE_SYMBOLS`` for a served model's decode call: the attention
    entry kernel is the path ``attention_plan`` picks for the call's bf16
    shapes (one token over the cache's slots, and an encdec's over its
    cross frames too): split-K for at most DECODE_ROWS query rows per kv
    head, ``wgmma`` above (recurrentgemma-9b's MQA packs 16)."""
    import torch
    from repro_torch.kernels.flash_attention import attention_plan
    if cfg.family == "ssm":
        return dict(DECODE_SYMBOLS)
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if cfg.mla is not None:    # q and k at nope + rope over H kv heads
        KV, dh = H, cfg.mla.nope_head_dim + cfg.mla.rope_head_dim
    keys = [max_len if cfg.window is None else min(max_len, cfg.window)]
    if cfg.family == "encdec":
        keys.append(cfg.frontend_tokens)
    paths = {attention_plan(1, 1, H, KV, dh, K, torch.bfloat16).path
             for K in keys}
    if len(paths) != 1:
        raise AssertionError(f"{cfg.name}'s decode attentions take the "
                             f"paths {paths}")
    return {**DECODE_SYMBOLS,
            "flash_attention": f"flash_attention_{paths.pop()}_kernel"}


def check_decode_symbols(counts: dict, launched: dict,
                         symbols: dict = DECODE_SYMBOLS) -> None:
    """Every launch of a kernel in ``symbols`` over decode calls went
    through its decode entry kernel (``counts``: profiled launches per
    CUDA symbol; ``launched``: the launch counter's delta)."""
    for name, sym in symbols.items():
        if launched.get(name) and counts.get(sym, 0) != launched[name]:
            theirs = {s: c for s, c in counts.items() if s in _symbols(name)}
            raise AssertionError(
                f"{name}: {counts.get(sym, 0)} of the decode calls' "
                f"{launched[name]} launches ran {sym}; the profiler lists "
                f"{theirs}")


def log_breakdown(phase: str, bd: dict) -> None:
    for way, row in (("graphed (a replay of the lane's graph)", bd),
                     ("eager", bd["eager"])):
        log(f"[{phase}] one lane's decode call, {way} (torch.profiler, "
            f"CUDA only): host wall {row['wall_ms']:.4f} ms, device busy "
            f"{row['busy_ms']:.4f} ms, idle share {row['idle_share']:.4f}, "
            f"{row['launches']:.1f} device operations per call; copies to "
            f"the host per call {row['copies_to_host']}; ported kernels' "
            f"device ms per call (all of each kernel's CUDA symbols) "
            f"{row['ported_ms']}; launches over the {DECODE_PROFILE_STEPS} "
            f"profiled calls: profiler {row['profiled_launches']}, launch "
            f"counter {row['counted_launches']} (held equal; the row is "
            f"window {len(row['windows'])} of at most {PROFILE_TRIES}); by "
            f"CUDA symbol {row['symbols']}; kernels by device time (ms per "
            f"call, launches per call):")
        for t, c, key in row["top"]:
            log(f"    {t:10.5f} {c:6d}  {key}")
        log_windows(phase, way.split()[0], row["windows"])


def log_windows(phase: str, what: str, windows) -> None:
    """One line for each profiled window of a row (the row's is the
    last): its ported launches, the launch counter's, and where its raw
    list lost device records or took in others."""
    for i, w in enumerate(windows, 1):
        log(f"[{phase}]   {what} window {i}: profiler {w['profiled']}, "
            f"launch counter {w['counted']}, lost records: "
            f"{w['lost_at'] or 'none'}")


def log_train_breakdown(phase: str, bd: dict) -> None:
    log(f"[{phase}] one training step (torch.profiler, CUDA only): host "
        f"wall {bd['wall_ms']:.4f} ms, device busy {bd['busy_ms']:.4f} ms, "
        f"idle share {bd['idle_share']:.4f}, {bd['operations']} device "
        f"operations; ported kernels' device ms {bd['ported_ms']}, launches"
        f" profiled {bd['profiled_launches']} against counted "
        f"{bd['counted_launches']} (held equal; the row is window "
        f"{len(bd['windows'])} of at most {PROFILE_TRIES}); operations by "
        f"device time (ms, count):")
    for t, n, key in bd["top"]:
        log(f"    {t:10.4f} {n:6d}  {key}")
    log_windows(phase, "training", bd["windows"])


def log_graph_parity(phase: str, gp: dict) -> None:
    ids = (f", expert ids equal in {gp['expert_id_calls']} calls"
           if gp["expert_id_calls"] else "")
    log(f"[{phase}] graph parity: {gp['graphs']} graphs over "
        f"{gp['lanes']} lanes and shapes {gp['shapes']}; {gp['lanes']} x "
        f"{gp['calls_per_lane']} calls, each bit-equal to the eager call "
        f"on a copy of its lane's state, greedy tokens equal "
        f"{gp['tokens']}{ids}; launches {gp['launches']} over "
        f"{gp['model_calls']} backend and {gp['eager_calls']} eager calls")


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
    computes it.  The counts are the kernel module's ``wkv6_work``, which
    ``cost_of`` counts too."""
    from repro_torch.kernels.wkv6 import wkv6_work
    flops, nbytes = wkv6_work(B, T, H, dh, itemsize)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
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


# -- phase 15 --------------------------------------------------------------

# Gradients of the kernel forward plus the backward formulas against
# torch.autograd.grad through the plain versions, both float32 with TF32
# off: max |got - want| <= GRAD_TOL * max |want| for each gradient (the
# two differ in summation order: the kernels', cuBLAS's and the CPU's).
GRAD_TOL = 1e-4
# RMSNorm rows: st-100m's training call (8 x 1024 tokens of width 768)
# and (300, 3840).  Attention: st-100m's heads at S = 1024 (B = 2),
# causal, and danube-smoke's GQA heads (4 over 2, dh = 16) with its
# 16-token window and a logit softcap, at S = 256.
TRAIN_RMS_SHAPES = ((8192, 768), (300, 3840))
TRAIN_ATTN_CASES = {
    "st-100m": dict(B=2, S=1024, H=12, KV=12, dh=64, window=None,
                    softcap=None),
    "danube-gqa-softcap": dict(B=2, S=256, H=4, KV=2, dh=16, window=16,
                               softcap=30.0)}
TRAIN_RMS_MAIN, TRAIN_ATTN_MAIN = (8192, 768), "st-100m"


def _within_scale(got, want, tol: float, what: str) -> float:
    """max |got - want| over max |want|; raises above ``tol``."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if not err <= tol * scale:
        raise AssertionError(f"{what}: max |err| {err} above {tol} x scale "
                             f"{scale}")
    return err / scale if scale else 0.0


def train_rmsnorm_inputs(n: int, d: int, device):
    """Seeded float32 x (n, d), w (d,) and an output gradient g (n, d)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(104729 * n + d)
    ts = (2.0 * rng.standard_normal((n, d)) + 0.5,
          0.1 * rng.standard_normal(d), rng.standard_normal((n, d)))
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in ts]


def train_attention_inputs(name: str, device):
    """Seeded float32 q, k, v, positions 0..S-1 and an output gradient."""
    import numpy as np
    import torch
    c = TRAIN_ATTN_CASES[name]
    B, S, H, KV, dh = c["B"], c["S"], c["H"], c["KV"], c["dh"]
    rng = np.random.default_rng(list(TRAIN_ATTN_CASES).index(name) + 31)
    q, k, v, g = (rng.standard_normal(s) for s in (
        (B, S, H, dh), (B, S, KV, dh), (B, S, KV, dh), (B, S, H, dh)))
    ts = [torch.as_tensor(a, dtype=torch.float32, device=device)
          for a in (q, k, v, g)]
    pos = torch.arange(S, dtype=torch.int32, device=device)
    return ts[:3], pos, ts[3]


def _grads(fn, inputs, g):
    """(output, input gradients) of ``fn(*inputs)`` for output gradient
    ``g``, through fresh leaves."""
    import torch
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, g)


def check_train_rmsnorm(n: int, d: int, device) -> dict:
    """RmsnormFunction (kernel forward, plain backward formulas) against
    autograd through the plain version: the output within F32_TOL and dx,
    dw within GRAD_TOL of their scales."""
    from repro_torch import kernels as K
    x, w, g = train_rmsnorm_inputs(n, d, device)
    y, (dx, dw) = _grads(lambda a, b: K.RmsnormFunction.apply(a, b, RMS_EPS),
                         (x, w), g)
    yp, (dxp, dwp) = _grads(lambda a, b: K.rmsnorm_ref(a, b, RMS_EPS),
                            (x, w), g)
    what = f"training rmsnorm ({n}, {d})"
    return {"fwd": _within_scale(y, yp, F32_TOL, what + " output"),
            "dx": _within_scale(dx, dxp, GRAD_TOL, what + " dx"),
            "dw": _within_scale(dw, dwp, GRAD_TOL, what + " dw")}


def check_train_attention(name: str, device) -> dict:
    """FlashAttentionFunction (kernel forward, plain backward formulas)
    against autograd through the plain version: the output within F32_TOL
    and dq, dk, dv within GRAD_TOL of their scales."""
    from repro_torch import kernels as K
    c = TRAIN_ATTN_CASES[name]
    (q, k, v), pos, g = train_attention_inputs(name, device)
    opts = dict(causal=True, window=c["window"], softcap=c["softcap"])
    o, grads = _grads(lambda a, b, d: K.FlashAttentionFunction.apply(
        a, b, d, pos, pos, True, c["window"], c["softcap"]), (q, k, v), g)
    op, gp = _grads(lambda a, b, d: K.flash_attention_ref(
        a, b, d, pos, pos, **opts), (q, k, v), g)
    what = f"training attention {name}"
    out = {"fwd": _within_scale(o, op, F32_TOL, what + " output")}
    for tag, a, b in zip(("dq", "dk", "dv"), grads, gp):
        out[tag] = _within_scale(a, b, GRAD_TOL, f"{what} {tag}")
    return out


def _fwd_bwd_ms(fn, inputs, g, iters: int) -> float:
    """CUDA-event ms of one forward and backward of ``fn`` through
    autograd (fresh leaves made outside the timed calls)."""
    import torch
    leaves = [t.detach().clone().requires_grad_() for t in inputs]

    def call():
        return torch.autograd.grad(fn(*leaves), leaves, g)
    return cuda_ms(call, iters)


def time_train_rmsnorm(n: int, d: int) -> dict:
    """float32 on the card: the kernel forward, the backward formulas, the
    plain version's forward and its forward and backward, and
    ``F.rms_norm`` with weight 1 + w, forward and forward and backward
    (the library's times, for the record); the forward's bound."""
    import torch.nn.functional as F
    from repro_torch import kernels as K
    RN = importlib.import_module("repro_torch.kernels.rmsnorm")
    x, w, g = train_rmsnorm_inputs(n, d, "cuda")
    flops, nbytes = RN.rmsnorm_work(n, d, 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    w1 = 1.0 + w
    return {
        "ms": cuda_ms(lambda: K.rmsnorm(x, w, RMS_EPS), 100),
        "backward_ms": cuda_ms(
            lambda: K.rmsnorm_backward(x, w, g, RMS_EPS), 100),
        "plain_ms": cuda_ms(lambda: K.rmsnorm_ref(x, w, RMS_EPS), 100),
        "library_ms": cuda_ms(lambda: F.rms_norm(x, (d,), w1, RMS_EPS), 100),
        "plain_fwd_bwd_ms": _fwd_bwd_ms(
            lambda a, b: K.rmsnorm_ref(a, b, RMS_EPS), (x, w), g, 50),
        "library_fwd_bwd_ms": _fwd_bwd_ms(
            lambda a, b: F.rms_norm(a, (d,), 1.0 + b, RMS_EPS), (x, w), g,
            50),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def attention_plan_of_shape(c: dict):
    """The kernel path :func:`attention_plan` picks for a float32 training
    case."""
    import torch
    from repro_torch.kernels.flash_attention import attention_plan
    return attention_plan(c["B"], c["S"], c["H"], c["KV"], c["dh"], c["S"],
                          torch.float32)


def time_train_attention(name: str) -> dict:
    """float32 on the card: the kernel forward (CUDA events over
    back-to-back calls, and device time per call from the profiler), the
    backward formulas, the plain version's forward and its forward and
    backward, and ``F.scaled_dot_product_attention`` over k/v repeated to
    the query heads (causal, or a boolean window mask), forward (CUDA
    events and device time) and forward and backward (None where the case
    has a softcap, which SDPA does not compute); the forward's bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K
    FA = importlib.import_module("repro_torch.kernels.flash_attention")
    c = TRAIN_ATTN_CASES[name]
    (q, k, v), pos, g = train_attention_inputs(name, "cuda")
    opts = dict(causal=True, window=c["window"], softcap=c["softcap"])
    o = K.flash_attention(q, k, v, pos, pos, **opts)
    live = FA.live_mask(pos, pos, True, c["window"])
    flops, nbytes = FA.attention_work(
        c["B"], c["S"], c["H"], c["KV"], c["dh"], c["S"], 4,
        int(live.sum()), FA.needed_keys(live))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S

    def kernel():
        return K.flash_attention(q, k, v, pos, pos, **opts)
    res = {
        "ms": cuda_ms(kernel, 50),
        "device_ms": device_ms(kernel, "flash_attention", 50),
        "backward_ms": cuda_ms(lambda: K.flash_attention_backward(
            q, k, v, pos, pos, o, g, **opts), 20),
        "plain_ms": cuda_ms(lambda: K.flash_attention_ref(
            q, k, v, pos, pos, **opts), 20),
        "library_ms": None, "library_device_ms": None,
        "plain_fwd_bwd_ms": _fwd_bwd_ms(
            lambda a, b, d: K.flash_attention_ref(a, b, d, pos, pos, **opts),
            (q, k, v), g, 10),
        "library_fwd_bwd_ms": None,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "plan": attention_plan_of_shape(c).path}
    if c["softcap"] is None:
        rep = c["H"] // c["KV"]
        heads = [t.transpose(1, 2) if t.shape[2] == c["H"] else
                 t.repeat_interleave(rep, dim=2).transpose(1, 2)
                 for t in (q, k, v)]
        gh = g.transpose(1, 2)
        kw = ({"is_causal": True} if c["window"] is None
              else {"attn_mask": live})

        def library():
            return F.scaled_dot_product_attention(*heads, **kw)
        res["library_ms"] = cuda_ms(library, 20)
        res["library_device_ms"] = library_device_ms(library)
        res["library_fwd_bwd_ms"] = _fwd_bwd_ms(
            lambda a, b, d: F.scaled_dot_product_attention(a, b, d, **kw),
            heads, gh, 20)
    return res


# -- phase 16 --------------------------------------------------------------

# Training parity, card vs host, float32 with TF32 off: the loss of one
# step within TRAIN_LOSS_RTOL of the host's, every gradient within
# GRAD_TOL of its scale; the losses of TRAIN_PARITY_STEPS AdamW steps
# within TRAIN_TRAJ_RTOL (AdamW's first step moves a parameter by lr times
# the sign of its gradient, so two sides whose gradients differ in
# rounding part by up to 2 lr there).
TRAIN_LOSS_RTOL, TRAIN_TRAJ_RTOL = 1e-5, 1e-4
TRAIN_PARITY_STEPS = 3


def train_parity_phase(cfg, device, batch: int = 2, seq: int = 256,
                       steps: int = TRAIN_PARITY_STEPS,
                       seed: int = 0) -> dict:
    """Seeded weights on the host and a copy on ``device``: the loss and
    every gradient of one step (:func:`grad_parity`), then the losses of
    ``steps`` + 1 AdamW steps, on each; on the card every forward
    launches its ``launches_per_call``."""
    from repro_torch import kernels as K
    from repro_torch.data import DataConfig, host_batch, to_device
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train.loop import make_train_step
    host, card = parity_models(cfg, device, seed)
    res = grad_parity(cfg, host, card, device, batch, seq)
    dcfg = DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab)
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=20)
    losses, launches = {}, {}
    for side, model in (("card", card), ("host", host)):
        params = {k: p.detach() for k, p in model.named_parameters()}
        step, opt = make_train_step(cfg, opt_cfg), init_opt_state(params)
        K.reset_launches()
        losses[side] = []
        for s in range(steps + 1):
            params, opt, m = step(params, opt, to_device(
                host_batch(dcfg, s), model.device))
            losses[side].append(float(m["loss"]))
        launches[side] = dict(K.LAUNCHES)
    for a, b in zip(losses["card"], losses["host"]):
        if not abs(a - b) <= TRAIN_TRAJ_RTOL * abs(b):
            raise AssertionError(f"AdamW losses card {losses['card']}, host "
                                 f"{losses['host']}")
    if _on_card(device):
        _check_launches(launches["card"], cfg, steps + 1, "training parity",
                        steps=steps + 1)
    return {"loss": res["loss"], "losses": [losses["card"], losses["host"]],
            "worst_grad": res["worst_grad"],
            "launches": {k: n + res["launches"][k]
                         for k, n in launches["card"].items()},
            "forwards": steps + 2}


# -- phase 17 --------------------------------------------------------------

TRAIN_ARGV = ("--arch", "st-100m", "--steps", "20", "--batch", "8",
              "--seq", "1024")
# The traced trainer: st-100m FULL over 4 emulated shards, shard 3 running
# 4 fwd_bwd iterations a step, 2 steps, analyzed with the train corpus's
# threshold.
TRACE_ITERS = (1, 1, 1, 4)
TRACE_STEPS = 2
TRACE_ANALYZER_KW = {"threshold_frac": 0.45}


def train_phase(argv, device, ranges=()) -> dict:
    """Train through ``repro_torch.launch.train`` with launch counts from
    0: the loss must fall (the mean of the last 5 steps below the mean of
    the first 5) and on the card every step must launch its forward's
    kernels (``launches_per_call``) and its recompute's
    (``recompute_per_step``); then one more step profiled (on the
    card), and one more with the profiler ``ranges`` read
    (:func:`range_breakdown`) if any are named."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.launch import train
    args = train.parser().parse_args([*argv, "--device", str(device)])
    trainer = train.build_trainer(args)
    on_card = _on_card(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    hist = trainer.run()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)) or not \
            np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"training loss did not fall: {losses}")
    if on_card:
        _check_launches(launches, trainer.cfg, len(hist), "training",
                        steps=len(hist))
    tp = train.throughput(trainer, args)
    return {"losses": losses, "launches": launches, "steps": len(hist),
            "wall_s": wall, **tp,
            "breakdown": train_breakdown(trainer) if on_card else None,
            "ranges": (range_breakdown(trainer, ranges)
                       if on_card and ranges else None)}


def train_breakdown(trainer) -> dict:
    """One more training step recorded by :func:`_record_window`
    (torch.profiler, CUDA activity): the host wall of the step, the
    device's busy time (its kernels' and copies' times summed), the idle
    share 1 - busy / wall, the device operations, each ported kernel's
    launches and the operations that took longest.  A window is whole
    only if those launches equal the launch counter's and its raw list
    lost and took in no device record; otherwise one more step is
    recorded, up to ``PROFILE_TRIES`` (:func:`_until_whole`), and the row
    is the whole window's, with every window under ``windows``."""
    from torch.profiler import ProfilerActivity

    def record():
        prof, launched, wall = _record_window(lambda: trainer.run(1),
                                              [ProfilerActivity.CUDA])
        return (_device_rows(prof), launched,
                lost_records(*_launch_records(prof)), wall)
    (rows, launched, _, wall), windows = _until_whole(
        record, f"{trainer.cfg.name}'s training step")
    busy = sum(r[0] for r in rows) / 1e6
    sc = symbol_counts(rows)
    return {"wall_ms": wall * 1e3, "busy_ms": busy * 1e3,
            "idle_share": 1.0 - busy / wall,
            "operations": sum(r[1] for r in rows),
            "profiled_launches": windows[-1]["profiled"],
            "counted_launches": windows[-1]["counted"],
            "windows": windows,
            "ported_ms": {n: sum(sc["times"].get(s, 0.0)
                                 for s in _symbols(n)) / 1e3
                          for n, c in launched.items() if c},
            "top": [(t / 1e3, c, key[:90]) for t, c, key in rows[:12]]}


def range_breakdown(trainer, names) -> dict:
    """One more training step recorded by :func:`_record_window` with CPU
    and CUDA activity (apart from :func:`train_breakdown`'s, whose host
    wall the CPU activity would slow): the device's busy time (kernels
    and copies, not the annotations' spans) and, per profiler range in
    ``names`` (``torch.profiler.record_function``), its calls and the
    device time of the kernels launched inside it.  Held whole as
    :func:`train_breakdown`'s step is, its device records' ported
    launches against the launch counter."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    def record():
        prof, launched, _ = _record_window(
            lambda: trainer.run(1),
            [ProfilerActivity.CPU, ProfilerActivity.CUDA])
        events = prof.events()
        per = {}
        for e in events:
            if e.device_type == DeviceType.CUDA and \
                    not getattr(e, "is_user_annotation", False):
                t, c = per.get(e.name, (0.0, 0))
                per[e.name] = (t + e.device_time_total, c + 1)
        rows = sorted(((t, c, key) for key, (t, c) in per.items()),
                      reverse=True)
        return rows, launched, lost_records(*_launch_records(prof)), events
    (rows, _, _, events), windows = _until_whole(
        record, f"{trainer.cfg.name}'s training step with profiler ranges")
    out = {"busy_ms": sum(r[0] for r in rows) / 1e3, "ranges": {},
           "profiled_launches": windows[-1]["profiled"],
           "counted_launches": windows[-1]["counted"], "windows": windows}
    for name in names:
        hits = [e for e in events
                if e.name == name and e.device_type == DeviceType.CPU]
        out["ranges"][name] = {
            "calls": len(hits),
            "device_ms": sum(e.device_time_total for e in hits) / 1e3}
    return out


def traced_train_phase(cfg, device, batch: int = 8, seq: int = 1024,
                       iters=TRACE_ITERS, steps: int = TRACE_STEPS) -> dict:
    """A traced Trainer of ``cfg``: len(iters) emulated shards, shard i
    running iters[i] fwd_bwd iterations a step.  The trace, analyzed on
    the kernel lane and on the numpy lane, must give equal verdict docs
    naming train/fwd_bwd as the dissimilarity; on the card every forward
    (warmup, timed repeat and the first step's cost count) launched 2L+1
    RMSNorms and L attentions."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import AutoAnalyzer
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    trainer = Trainer(
        cfg, AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=20),
        DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab),
        TrainerConfig(steps=steps, ckpt_every=0, trace=True,
                      trace_shards=len(iters), trace_iters=tuple(iters),
                      trace_meta={"analyzer_kw": dict(TRACE_ANALYZER_KW)}),
        device=device)
    on_card = _on_card(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    hist = trainer.run()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    runner = trainer.runner
    forwards = steps * (runner.warmup + runner.repeats) * sum(iters) \
        + iters[0]
    if on_card:
        _check_launches(launches, cfg, forwards, "traced training",
                        steps=forwards)
    trace = trainer.trace
    K.reset_launches()
    an_k = AutoAnalyzer(trainer.region_tree, distance_backend="kernel",
                        device=device, **TRACE_ANALYZER_KW)
    res_k = an_k.analyze_trace(trace)
    analysis_launches = K.LAUNCHES["multi_seed_rows"]
    res_n = AutoAnalyzer(trainer.region_tree, distance_backend="numpy",
                         **TRACE_ANALYZER_KW).analyze_trace(trace)
    doc_k, doc_n = res_k.verdict.doc(), res_n.verdict.doc()
    if doc_k != doc_n or "train/fwd_bwd" not in \
            res_n.verdict.dissimilarity_paths:
        raise AssertionError(f"traced training verdicts:\nkernel {doc_k}\n"
                             f"numpy  {doc_n}")
    fid = trainer.region_tree.by_path("train/fwd_bwd").region_id
    oid = trainer.region_tree.by_path("train/optimizer").region_id
    return {"steps": [{k: h[k] for k in ("loss", "seconds",
                                         "per_shard_seconds")}
                      for h in hist],
            "wall_s": wall, "launches": launches, "forwards": forwards,
            "costs": {"train/fwd_bwd": runner.costs[fid][:2],
                      "train/optimizer": runner.costs[oid][:2]},
            "device_s": {p: runner.device_s[r].tolist() for p, r in
                         (("train/fwd_bwd", fid),
                          ("train/optimizer", oid))} if on_card else None,
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if on_card else None),
            "verdict": doc_n, "analysis_launches": analysis_launches,
            "seed_counts": dict(K.SEED_COUNTS),
            "decisions": dict(an_k.decisions)}


# -- phase 18 --------------------------------------------------------------

# The corpus entries of the training and serving slice: the five serving
# entries, the three dense train and recovery entries and the checkpoint
# chaos entry, at CHAOS_SEEDS on the kernel lane, the trainers on the card.
NEW_ENTRIES = ("serving/kv-cache-thrash", "serving/kv-thrash-onset",
               "serving/interleave-imbalance", "serving/hot-expert-routing",
               "serving/long-tail-prompt-straggler",
               "train/fwdbwd-straggler-smoke",
               "train/straggler-remesh-recovery",
               "train/ckpt-stall-reschedule-recovery",
               "chaos/corrupt-latest-checkpoint")


def _outcome(entry, r) -> dict:
    """The part of a run the reference pins for each kind of entry, and
    whether the run meets it: the exact completed requests (serving), the
    mitigation (recovery), the fallback step and exactness (checkpoint
    chaos)."""
    if entry.serving is not None:
        return {"completed": r.completed,
                "ok": r.completed == entry.serving.min_completed}
    if entry.recovery is not None:
        return {"action": r.recovery_kind, "window": r.mitigation_window,
                "clean_after": r.clean_after, "ok": r.recovered}
    if entry.chaos is not None:
        o = r.chaos_outcome
        return {"fallback_from": o.fallback_from,
                "restored_step": o.restored_step,
                "exact": o.matched == o.comparable == 1,
                "ok": (o.restored_step == o.fallback_from - 1
                       and o.matched == o.comparable == 1)}
    return {"onset_window": r.onset_window, "ok": True}


def log_failed_attempts(phase: str, name: str, attempts) -> None:
    """One line for each failed attempt of ``name`` and one for each of
    its windows (``CorpusRunResult.attempt_logs``): the window's index,
    signature, CCR paths, every shard's wall and CPU takes by region in
    ms, and the CPU clock's tick."""
    for a in attempts:
        if a["passed"]:
            continue
        log(f"[{phase}] failed attempt {name}@{a['seed']}, "
            f"{len(a['windows'])} windows:")
        for w in a["windows"]:
            log(f"[{phase}]   window {json.dumps(w)}")


def new_entries_phase(device, seeds=CHAOS_SEEDS, names=NEW_ENTRIES,
                      phase: str = "18") -> dict:
    """``names`` at ``seeds`` through the port's corpus on ``device``
    (``run_entry_robust``: the wall-clock train and recovery entries get
    the corpus's one retry): each passes with the reference's outcome
    (``_outcome``).  Every failed attempt, a first one the retry passed
    included, is logged window by window first (``log_failed_attempts``).
    Returns each run's outcome and wall, the launches of every kernel and
    the re-decisions, counted from 0."""
    from repro_torch import kernels as K
    from repro_torch.scenarios import CORPUS, run_entry_robust
    K.reset_launches()
    runs, decisions = {}, []
    for name in names:
        entry = CORPUS[name]
        for seed in seeds:
            r = run_entry_robust(entry, seed=seed,
                                 analyzer_overrides={"device": device})
            log_failed_attempts(phase, name, r.attempt_logs)
            got = _outcome(entry, r)
            if not (r.passed and got["ok"]):
                raise AssertionError(
                    f"{name}@{seed}: passed {r.passed}, found "
                    f"{sorted(r.found)}, precision {r.precision}, outcome "
                    f"{got}")
            runs[f"{name}@{seed}"] = {**got,
                                      "walls_s": list(r.attempt_walls)}
            decisions.append(r.decisions)
    launches = dict(K.LAUNCHES)
    if _on_card(device) and not (launches["multi_seed_rows"]
                                 and launches["rmsnorm"]
                                 and launches["flash_attention"]):
        raise AssertionError(f"the new entries launched {launches}")
    return {"runs": runs, "launches": launches,
            "seed_counts": dict(K.SEED_COUNTS),
            "decisions": _sum_counts(decisions)}


# -- phases 19-21 ----------------------------------------------------------

# deepseek-v2-lite-16b FULL in bf16, served as gemma-7b is in phase 8.
DSV2_SERVE_ARGV = ("--arch", "deepseek-v2-lite-16b", "--lanes", "4",
                   "--requests", "8", "--prompt-len", "512", "--chunk",
                   "256", "--gen", "32", "--arrival-rate", "2.0", "--seed",
                   "0")
# The MoE smoke configs trained one step card against host, and the two
# MoE train entries.
MOE_TRAIN_ARCHS = ("mixtral-8x22b", "deepseek-v2-lite-16b")
MOE_TRAIN_SEQ = 64
MOE_ENTRIES = ("train/moe-routing-collapse-smoke",
               "train/moe-collapse-rebalance-recovery")


# The last three families, served FULL in bf16: the vlm with phase 8's
# traffic, the hybrid and the encdec (one token per call) with phase 11's.
PHI3V, RGEMMA, SEAMLESS = ("phi-3-vision-4.2b", "recurrentgemma-9b",
                           "seamless-m4t-medium")
PHI3V_SERVE_ARGV = ("--arch", PHI3V, *SERVE_ARGV[2:])
RGEMMA_SERVE_ARGV = ("--arch", RGEMMA, *RWKV_SERVE_ARGV[2:])
SEAMLESS_SERVE_ARGV = ("--arch", SEAMLESS, *RWKV_SERVE_ARGV[2:])


# -- phases 25-28: ssm training and the remat policy ------------------------

# WKV-6's training call (B, T, H, dh), each from a non-zero state: rwkv6-3b's
# heads at the trainer's T = 1024, one batch row and the trainer's eight,
# and phase 9's ragged case.
TRAIN_WKV_CASES = {"t1024": (1, 1024, 40, 64), "b8": (8, 1024, 40, 64),
                   "ragged": (2, 100, 4, 16)}
TRAIN_WKV_MAIN = "b8"
WKV_GRADS = ("dr", "dk", "dv", "dw", "du", "dS0")
# The policies of models.transformer.remat, in the order of phase 28.
REMAT_POLICIES = ("full", "dots", "nothing")
# Phase 26: rwkv6-3b's width cut to 2 layers, float32, one batch row at the
# reference's scan path (256) and past its chunked threshold (640); card
# gradients under the three policies equal within REMAT_TOL of their scale
# (the backward's order of float32 sums may differ from run to run on the
# card: atomics in the embedding's gradient).
RWKV_GRAD_SEQS = (256, 640)
REMAT_TOL = 1e-6
# Phase 27: rwkv6-3b FULL trained in bf16 at 8 x 1024 (the reference's
# train_4k is 256 x 4096, which one card cannot hold).
RWKV_TRAIN_ARGV = ("--arch", "rwkv6-3b", "--steps", "20", "--batch", "8",
                   "--seq", "1024")
# Phase 28: (arch, batch, seq, steps) measured under each policy; the
# losses of each step equal across policies within REMAT_LOSS_RTOL.  Runs
# of 5 steps read rwkv6-3b's "full" 3% to 13% below "nothing" from one
# run to the next, so each policy takes 12 (11 timed) and the log gives
# every step's time.
REMAT_RUNS = (("st-100m", 8, 1024, 12), ("rwkv6-3b", 2, 1024, 12))
REMAT_LOSS_RTOL = 1e-5


def train_wkv6_inputs(name: str, decay: str, dtype, device) -> tuple:
    """Seeded r, k, v (normal, in ``dtype``), float32 w (the model's
    exp(-exp(N(0, 1))) or uniform(0.75, 0.999)), u = 0.5 N(0, 1), S0 =
    0.1 N(0, 1), and an output gradient g = N(0, 1)."""
    import numpy as np
    import torch
    B, T, H, dh = TRAIN_WKV_CASES[name]
    rng = np.random.default_rng(list(TRAIN_WKV_CASES).index(name) * 2
                                + WKV_DECAYS.index(decay) + 211)
    shape = (B, T, H, dh)
    r, k, v, g = (rng.standard_normal(shape) for _ in range(4))
    w = (np.exp(-np.exp(rng.standard_normal(shape))) if decay == "model"
         else rng.uniform(0.75, 0.999, shape))
    u = 0.5 * rng.standard_normal((H, dh))
    S0 = 0.1 * rng.standard_normal((B, H, dh, dh))
    f32 = dict(dtype=torch.float32, device=device)
    return ([torch.as_tensor(a, dtype=dtype, device=device)
             for a in (r, k, v)]
            + [torch.as_tensor(a, **f32) for a in (w, u, S0)],
            torch.as_tensor(g, **f32))


def check_train_wkv6(name: str, device) -> dict:
    """``Wkv6Function`` (the kernel forward, the plain backward formulas)
    against autograd through ``wkv6_ref`` on the same device, for both
    decay forms, float32 and bf16 r/k/v: the output and the final state
    within WKV_TOL of their scale, every gradient within GRAD_TOL of its
    scale (plus, where a value is rounded to bf16, that rounding: 2^-8 of
    a long call's output, rounded on one side only, and one bf16 ulp,
    up to 2^-7 of its size, for the gradients of bf16 r, k and v, rounded
    on both);
    on the card one launch a forward.  Returns the largest error over
    scale of the output and of each float32-input gradient, and the
    largest share of its tolerance any bf16 gradient used."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.kernels.wkv6 import CHUNKED_T
    res = {"fwd": 0.0, **{t: 0.0 for t in WKV_GRADS}, "bf16_share": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for decay in WKV_DECAYS:
            ins, g = train_wkv6_inputs(name, decay, dtype, device)
            what = f"training wkv6 {name} {dtype} {decay} decays"
            K.reset_launches()
            (out, S), got = _function_grads(K.Wkv6Function.apply, ins, g)
            if _on_card(device) and K.LAUNCHES["wkv6"] != 1:
                raise AssertionError(f"{what}: {K.LAUNCHES} launches")
            (want, S_want), grads = _function_grads(K.wkv6_ref, ins, g)
            rounded = dtype != torch.float32 and ins[0].shape[1] >= CHUNKED_T
            err = (out - want).abs()
            tol = WKV_TOL * want.abs().max() + (2.0 ** -8 * want.abs()
                                                if rounded else 0.0)
            if bool((err > tol).any()):
                raise AssertionError(f"{what}: output max |err| "
                                     f"{float(err.max())}")
            _within_scale(S, S_want, WKV_TOL, what + " final state")
            if not rounded:
                res["fwd"] = max(res["fwd"], float(err.max()
                                                   / want.abs().max()))
            for tag, a, b in zip(WKV_GRADS, got, grads):
                if a.dtype != b.dtype:
                    raise AssertionError(f"{what} {tag}: {a.dtype}")
                if a.dtype == torch.float32:
                    e = _within_scale(a, b, GRAD_TOL, f"{what} {tag}")
                    if dtype == torch.float32:
                        res[tag] = max(res[tag], e)
                    continue
                a, b = a.float(), b.float()
                tol = GRAD_TOL * b.abs().max() + 2.0 ** -7 * b.abs()
                share = float(((a - b).abs() / tol).max())
                if not share <= 1.0:
                    raise AssertionError(f"{what} {tag}: {share} of its "
                                         f"tolerance")
                res["bf16_share"] = max(res["bf16_share"], share)
    return res


def _function_grads(fn, inputs, g) -> tuple:
    """((out, S), input gradients) of ``fn(*inputs) -> (out, S)`` for
    output gradient ``g`` (none for S), through fresh leaves."""
    import torch
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out, S = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, g, materialize_grads=True)
    return (out.detach(), S.detach()), grads


def wkv6_backward_bound_ms(B: int, T: int, H: int, dh: int,
                           itemsize: int) -> tuple:
    """The least time of the gradient: r, k, v, the output's gradient
    (float32), w and u read once, the state S0 read once, dr, dk, dv
    (``itemsize``), dw, du and dS0 written once; per (token, head) the
    float32 operations of the sequential form's backward: the state again
    (3·dh²), dS ← w ⊙ dS + r gᵀ (3·dh²), S g, dS v, dSᵀ k and Σ dS ⊙ S
    (2·dh² each): 14·dh²."""
    n = B * T * H * dh
    nbytes = n * (2 * 3 * itemsize + 4 + 4 + 4) + 8 * B * H * dh * dh \
        + 8 * H * dh
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 14.0 * B * T * H * dh * dh / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_train_wkv6(name: str) -> dict:
    """bf16 r/k/v (the trainer's dtype), the model's decays, on the card:
    the training forward (a state copy and one kernel launch; CUDA events
    and the kernel's device time from the profiler), the backward
    formulas, the Function's forward and backward, the plain version's
    forward and its forward and backward through autograd; the bounds of
    the forward and of the gradient.  No PyTorch call computes WKV-6."""
    import torch
    from repro_torch import kernels as K
    ins, g = train_wkv6_inputs(name, "model", torch.bfloat16, "cuda")
    B, T, H, dh = TRAIN_WKV_CASES[name]
    b_ms, b_by = wkv6_bound_ms(B, T, H, dh, 2)
    bb_ms, bb_by = wkv6_backward_bound_ms(B, T, H, dh, 2)

    def forward():
        return K.Wkv6Function.apply(*ins)
    return {
        "ms": cuda_ms(forward, 20),
        "device_ms": device_ms(forward, "wkv6", 20),
        "backward_ms": cuda_ms(lambda: K.wkv6_backward(*ins, g), 3),
        "fwd_bwd_ms": _fwd_bwd_ms(lambda *a: K.Wkv6Function.apply(*a)[0],
                                  ins, g, 3),
        "plain_ms": cuda_ms(lambda: K.wkv6_ref(*ins), 1),
        "plain_fwd_bwd_ms": _fwd_bwd_ms(lambda *a: K.wkv6_ref(*a)[0], ins,
                                        g, 1),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "backward_bound_ms": bb_ms, "backward_bound_by": bb_by,
        "launches_per_forward": 1}


def rwkv_grad_phase(cfg, device, seqs=RWKV_GRAD_SEQS, batch: int = 1,
                    seed: int = 0) -> dict:
    """``cfg`` (rwkv6-3b's width cut) card against host, one training
    step per sequence length: the host's under ``cfg``'s own policy, the
    card's under each of REMAT_POLICIES, each held to the host's by
    :func:`hold_grads` (its launches with the policy's recompute); the
    card's gradients under the three policies equal within REMAT_TOL of
    their scale.  Keyed "policy/seq"."""
    import torch
    host, card = parity_models(cfg, device, seed)
    res = {}
    for seq in seqs:
        h = step_grads(cfg, host, batch, seq, seed)
        first = None
        for pol in REMAT_POLICIES:
            pcfg = cfg.with_(remat_policy=pol)
            c = step_grads(pcfg, card, batch, seq, seed)
            r = hold_grads(pcfg, c, h, device, f"rwkv step {pol} S={seq}")
            if first is None:
                first = c[1]
            else:
                r["vs_" + REMAT_POLICIES[0]] = max(
                    _within_scale(c[1][k], first[k], REMAT_TOL,
                                  f"{pol} gradient {k} against "
                                  f"{REMAT_POLICIES[0]}")
                    for k in first)
                same = sum(bool(torch.equal(c[1][k], first[k]))
                           for k in first)
                r["bitwise_equal"] = f"{same} of {len(first)}"
            res[f"{pol}/{seq}"] = r
            del c
    return res


def wkv6_shares(breakdown: dict, ranges: dict, layers: int) -> dict:
    """WKV-6's part of a profiled training step: its kernel's device time
    in :func:`train_breakdown`'s step, and the device time of the kernels
    its backward formulas launched (the ``wkv6_backward`` range of
    ``Wkv6Function.backward``) in :func:`range_breakdown`'s, each over its
    own step's busy time.  The range must hold ``layers`` calls and some
    device time."""
    fwd = breakdown["ported_ms"].get("wkv6", 0.0)
    bwd = ranges["ranges"]["wkv6_backward"]
    if bwd["calls"] != layers or not bwd["device_ms"] > 0:
        raise AssertionError(f"the profiled step's wkv6_backward range: "
                             f"{bwd}, expected {layers} calls with device "
                             f"time")
    return {"forward_ms": fwd, "forward_share": fwd / breakdown["busy_ms"],
            "backward_calls": bwd["calls"], "backward_ms": bwd["device_ms"],
            "backward_step_busy_ms": ranges["busy_ms"],
            "backward_share": bwd["device_ms"] / ranges["busy_ms"]}


def remat_phase(cfg, device, batch: int, seq: int, steps: int) -> dict:
    """``steps`` training steps of ``cfg`` under each of REMAT_POLICIES
    from the same seeded weights and batches: every step's time and the
    median (step 0 excluded), the tokens per second at it and the peak
    device memory of the run; then, apart, the peak of one more forward
    and backward (``value_and_grad``, where the policy acts; the
    optimizer's new and old moments can set the step's peak) over the
    memory held before it (weights and optimizer state); on the card
    every step's launches with the policy's recompute; each step's loss
    equal across the policies within REMAT_LOSS_RTOL."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.data import DataConfig, host_batch, to_device
    from repro_torch.models import family_module
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.loop import value_and_grad
    on_card = _on_card(device)
    dcfg = DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab)
    res = {}
    for pol in REMAT_POLICIES:
        pcfg = cfg.with_(remat_policy=pol)
        trainer = Trainer(
            pcfg, AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=20),
            dcfg, TrainerConfig(steps=steps, ckpt_every=0), device=device)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        hist = trainer.run()
        if on_card:
            _check_launches(dict(K.LAUNCHES), pcfg, steps, f"remat {pol}",
                            steps=steps)
        timed = [h["seconds"] for h in hist[1:]]
        med = float(np.median(timed))
        res[pol] = r = {"losses": [h["loss"] for h in hist],
                        "step_s": timed, "median_step_s": med,
                        "tokens_per_s": batch * seq / med,
                        "peak_memory_bytes": (
                            torch.cuda.max_memory_allocated()
                            if on_card else None)}
        if on_card:
            skeleton = family_module(pcfg).init(pcfg, None, "meta")
            b = to_device(host_batch(dcfg, steps), trainer.device)
            torch.cuda.synchronize()
            r["resident_bytes"] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            value_and_grad(skeleton, trainer.params, b)
            torch.cuda.synchronize()
            r["fwd_bwd_peak_bytes"] = torch.cuda.max_memory_allocated()
        del trainer, hist
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    base = res[REMAT_POLICIES[0]]["losses"]
    for pol in REMAT_POLICIES[1:]:
        for a, b in zip(res[pol]["losses"], base):
            if not abs(a - b) <= REMAT_LOSS_RTOL * abs(b):
                raise AssertionError(f"remat {pol} losses "
                                     f"{res[pol]['losses']}, "
                                     f"{REMAT_POLICIES[0]} {base}")
    return res


def ssm_training_phases() -> dict:
    """Phases 25-28 on the card, logged; returns what the kernels line
    reads: phase 25's errors and times, phase 27's training run."""
    from repro_torch.configs import get_arch

    # 25. WKV-6's training call: the Function against the plain version
    tr_wkv = {}
    for name, shape in TRAIN_WKV_CASES.items():
        t0 = time.perf_counter()
        tr_wkv[name] = r = check_train_wkv6(name, "cuda")
        if name == TRAIN_WKV_MAIN:
            r.update(time_train_wkv6(name))
        log(f"[25] training wkv6 {name} {shape}, f32 and bf16, both decay "
            f"forms, from a non-zero state: max error over scale output "
            f"{r['fwd']:.3g} (tolerance {WKV_TOL}), gradients (f32 inputs) "
            + ", ".join(f"{g} {r[g]:.3g}" for g in WKV_GRADS)
            + f" (tolerance {GRAD_TOL}); bf16 gradients used at most "
            f"{r['bf16_share']:.3g} of their tolerance; "
            f"{time.perf_counter() - t0:.1f} s")
    t = tr_wkv[TRAIN_WKV_MAIN]
    log(f"[25] training wkv6 {TRAIN_WKV_MAIN} bf16, model decays: forward "
        f"{t['ms']:.6f} ms (kernel device {t['device_ms']} ms; "
        f"{t['launches_per_forward']} launch), bound {t['bound_ms']:.6f} ms "
        f"({t['bound_by']}); backward formulas {t['backward_ms']:.6f} ms, "
        f"bound {t['backward_bound_ms']:.6f} ms ({t['backward_bound_by']}); "
        f"Function forward+backward {t['fwd_bwd_ms']:.6f} ms; plain forward "
        f"{t['plain_ms']:.6f} ms, forward+backward "
        f"{t['plain_fwd_bwd_ms']:.6f} ms; no library call")

    # 26. rwkv6-3b's width cut, card vs host, under the three policies
    t0 = time.perf_counter()
    rgrad = rwkv_grad_phase(parity_config("rwkv6-3b"), "cuda")
    for key, r in rgrad.items():
        log(f"[26] rwkv6-3b width, 2 layers, f32, {key} (policy/seq): loss "
            f"card, host {r['loss']} (tolerance {TRAIN_LOSS_RTOL} relative), "
            f"worst gradient over its scale {r['worst_grad']} (tolerance "
            f"{GRAD_TOL}); card launches {r['launches']}"
            + (f"; against {REMAT_POLICIES[0]} on the card at most "
               f"{r['vs_' + REMAT_POLICIES[0]]:.3g} of scale (tolerance "
               f"{REMAT_TOL}), {r['bitwise_equal']} gradients bit for "
               f"bit"
               if "bitwise_equal" in r else ""))
    log(f"[26] {time.perf_counter() - t0:.1f} s")

    # 27. rwkv6-3b FULL trained in bf16
    rtrained = train_phase(RWKV_TRAIN_ARGV, "cuda",
                           ranges=("wkv6_backward",))
    per = {k: n + recompute_per_step(get_arch("rwkv6-3b").full).get(k, 0)
           for k, n in launches_per_call(get_arch("rwkv6-3b").full).items()}
    log(f"[27] train {' '.join(RWKV_TRAIN_ARGV)} under remat_policy "
        f"'nothing': losses {json.dumps(rtrained['losses'])}; launches "
        f"{rtrained['launches']} (= {per} per step with the recompute, "
        f"{rtrained['steps']} steps); median step "
        f"{rtrained['median_step_s'] * 1e3:.4f} ms (step 0 excluded), "
        f"{rtrained['tokens_per_s']:.1f} tokens/s, peak memory "
        f"{rtrained['peak_memory_bytes']} bytes; wall "
        f"{rtrained['wall_s']:.1f} s")
    bd = rtrained["breakdown"]
    log_train_breakdown("27", bd)
    log_windows("27", "ranges' training", rtrained["ranges"]["windows"])
    layers = get_arch("rwkv6-3b").full.n_layers
    rtrained["shares"] = sh = wkv6_shares(bd, rtrained["ranges"], layers)
    log(f"[27] WKV-6 in the profiled steps: the kernel (forward and "
        f"recompute) {sh['forward_ms']:.4f} ms, {sh['forward_share']:.4f} "
        f"of the device time; the backward formulas (profiler range "
        f"wkv6_backward, CPU and CUDA activity, a step apart), "
        f"{sh['backward_calls']} calls launching {sh['backward_ms']:.4f} ms"
        f" of kernels, {sh['backward_share']:.4f} of that step's "
        f"{sh['backward_step_busy_ms']:.4f} ms; for comparison, {layers} "
        f"calls at phase 25's isolated {t['backward_ms']:.6f} ms would be "
        f"{layers * t['backward_ms']:.4f} ms")

    # 28. remat measured: memory and step time under each policy
    remat = {}
    for arch, batch, seq, steps in REMAT_RUNS:
        t0 = time.perf_counter()
        remat[arch] = r = remat_phase(get_arch(arch).full, "cuda", batch,
                                      seq, steps)
        for pol in REMAT_POLICIES:
            x = r[pol]
            log(f"[28] {arch} FULL {batch} x {seq} "
                f"({get_arch(arch).full.dtype}), remat_policy {pol!r}: "
                f"median step "
                f"{x['median_step_s'] * 1e3:.4f} ms of {steps} (step 0 "
                f"excluded; min {min(x['step_s']) * 1e3:.4f}, max "
                f"{max(x['step_s']) * 1e3:.4f}; steps ms "
                f"{[round(v * 1e3, 4) for v in x['step_s']]}), "
                f"{x['tokens_per_s']:.1f} tokens/s, peak memory "
                f"{x['peak_memory_bytes']} bytes; one forward and backward "
                f"apart: peak {x['fwd_bwd_peak_bytes']} bytes over "
                f"{x['resident_bytes']} held before it; losses "
                f"{x['losses']}")
        log(f"[28] {arch}: losses equal across policies within "
            f"{REMAT_LOSS_RTOL} relative; {time.perf_counter() - t0:.1f} s")
    return {"train_wkv": tr_wkv, "rgrad": rgrad, "rtrained": rtrained,
            "remat": remat}


# -- phases 29-31 ------------------------------------------------------------

LANES = ("numpy", "kernel", "torch")


def lane_inputs(m: int, n: int, k: int):
    """Phase 3's fleet-like float64 points (the same seeded matrix), their
    squared norms and k distinct seeds, on the host: a lane prepares its
    float32 copies from the float64 matrix itself."""
    import numpy as np
    rng = np.random.default_rng(7919 * k + 31 * n + m)
    W = 100.0 + rng.random((m, n))
    W[: m // 8] *= 5.0
    idx = rng.choice(m, size=k, replace=False)
    return W, np.einsum("ij,ij->i", W, W), idx


def torch_lane_rows_phase(device, m: int = FLEET_M, n: int = FLEET_N,
                          ks=KERNEL_KS) -> dict:
    """The torch lane's seed rows at each k against a float64 evaluation
    on the same device: every element within the lane's own bound,
    ``row_error_coef(n)·(|W_s|² + |W_q|²)``.  Each k twice: with the
    caller's TF32 off, and on (the lane must switch it off around its
    product and restore it).  Beside them the lane's product with TF32 on
    and no guard, its error logged in units of the same bound."""
    import torch
    from repro_torch.core.clustering import get_distance_backend
    from repro_torch.kernels.distance import row_error_coef
    be = get_distance_backend("torch", device)
    coef = be.row_error_coef(n)
    out = {"coef_u": coef * 2 ** 24, "kernel_coef_u": row_error_coef(n)
           * 2 ** 24, "ks": {}}
    caller = torch.backends.cuda.matmul.allow_tf32
    try:
        for k in ks:
            W, sq, idx = lane_inputs(m, n, k)
            pts, sq32 = handle = be.prepare(W, sq)
            Wd = torch.as_tensor(W, device=device)
            sqd = torch.as_tensor(sq, device=device)
            ii = torch.as_tensor(idx, device=device).long()
            exact = (sqd[ii, None] + sqd[None, :]).addmm(
                Wd[ii], Wd.T, alpha=-2).clamp_min(0)
            bound = coef * (sqd[ii, None] + sqd[None, :])
            res = {}
            for tf32 in (False, True):
                torch.backends.cuda.matmul.allow_tf32 = tf32
                got = be.device_rows(handle, idx).double()
                if torch.backends.cuda.matmul.allow_tf32 != tf32:
                    raise AssertionError("the torch lane did not restore "
                                         "the caller's TF32 setting")
                ratio = float(((got - exact).abs() / bound).max())
                if not ratio <= 1.0:
                    raise AssertionError(
                        f"torch lane rows at (m, n, k) = {(m, n, k)}, "
                        f"caller's TF32 {tf32}: error {ratio:.4g} of the "
                        f"lane's bound")
                res["tf32_on" if tf32 else "tf32_off"] = ratio
            torch.backends.cuda.matmul.allow_tf32 = True
            raw = (sq32[ii, None] + sq32[None, :]).addmm(
                pts[ii], pts.T, alpha=-2).clamp_min(0).double()
            res["unguarded_tf32"] = float(((raw - exact).abs()
                                           / bound).max())
            out["ks"][k] = res
    finally:
        torch.backends.cuda.matmul.allow_tf32 = caller
    return out


def lanes_fleet_phase(m: int, n: int, straggler_procs: int, device,
                      lanes=LANES) -> dict:
    """Phase 5's fleet trace analyzed on every lane: each verdict doc
    equal to the numpy lane's; per lane the analysis wall (host clock,
    ending in a device sync), the seed-row kernel's launches (the kernel
    lane launches it, the torch lane never) and the candidacies flagged
    and re-decided on the exact lane."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import AutoAnalyzer
    _, collector, _ = fleet_collector(m, n, straggler_procs)
    trace = collector.collect_trace()
    tree = trace.tree()
    on_card = torch.device(device).type == "cuda"
    out, docs = {}, {}
    for lane in lanes:
        an = AutoAnalyzer(tree, distance_backend=lane, device=device)
        K.reset_launches()
        t0 = time.perf_counter()
        docs[lane] = an.analyze_trace(trace).verdict.doc()
        if on_card:
            torch.cuda.synchronize()
        out[lane] = {"wall_s": time.perf_counter() - t0,
                     "launches": K.LAUNCHES["multi_seed_rows"],
                     "decisions": an.decisions}
    for lane in lanes:
        if docs[lane] != docs["numpy"]:
            raise AssertionError(f"fleet verdicts differ between the "
                                 f"{lane} and numpy lanes:\n"
                                 f"{docs[lane]}\n{docs['numpy']}")
    if on_card and "kernel" in out and out["kernel"]["launches"] == 0:
        raise AssertionError("the kernel lane never launched the kernel")
    if "torch" in out and out["torch"]["launches"]:
        raise AssertionError("the torch lane launched the seed-row kernel")
    return out


def child(args, timeout: int = 600,
          check: bool = True) -> subprocess.CompletedProcess:
    """``python -m <args>`` from the checkout's root with its ``src`` on
    the path; raises unless it exits 0 (or, with ``check=False``, returns
    whatever it exited)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    r = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=timeout)
    if check and r.returncode != 0:
        raise AssertionError(f"python -m {' '.join(args)} exited "
                             f"{r.returncode}:\n{r.stdout[-4000:]}\n"
                             f"{r.stderr[-4000:]}")
    return r


WALL_S = re.compile(r" +\d+\.\d{3}  (ok|FAIL)$")


def corpus_table(stdout: str) -> list:
    """run_corpus's table with its wall_s column masked."""
    return [WALL_S.sub(r" WALL  \1", line) for line in stdout.splitlines()]


REGRESSED = re.compile(r"^(\S+): .*  REGRESSION$", re.M)


def bench_self_check(run, path: str, args=()) -> dict:
    """``run_bench --check path`` against the run's own baseline, at the
    CLI's default factor.  Where it flags a regression, a fresh baseline
    is taken (the first's grid and repeat) and checked once more, as
    ``run_entry_robust`` gives a wall-clock entry one fresh collection: a
    baseline taken in a quiet moment of the host is not held against
    every later check.

    ``run(argv) -> (exit code, stdout)`` runs the CLI.  Every check writes
    its own timings (``--out``), so each row's ratio to its baseline is
    kept, whether the CLI flagged it or not.  Raises when a baseline run
    exits other than 0, a check other than 0 or 1, or when one row
    regressed in both checks.  Returns ``{"checks": [{"rc", "regressed",
    "ratios"}, ...], "last": line}``."""
    with open(path) as f:
        meta = json.load(f)["meta"]
    checks = []
    base_path = path
    for k in range(2):
        if k:
            base_path = f"{path}.base{k}.json"
            rc, stdout = run(["--grid", meta["grid"], "--repeat",
                              str(meta["repeat"]), "--out", base_path,
                              *args])
            if rc != 0:
                raise AssertionError(f"run_bench --out {base_path} exited "
                                     f"{rc}:\n{stdout[-4000:]}")
        with open(base_path) as f:
            base = json.load(f)["entries"]
        out = f"{path}.check{k}.json"
        rc, stdout = run(["--check", base_path, "--out", out, *args])
        if rc not in (0, 1):
            raise AssertionError(f"run_bench --check exited {rc}:\n"
                                 f"{stdout[-4000:]}")
        with open(out) as f:
            now = json.load(f)["entries"]
        checks.append({
            "rc": rc, "regressed": REGRESSED.findall(stdout),
            "ratios": {n: now[n]["seconds"] / e["seconds"]
                       for n, e in base.items()
                       if n in now and e["seconds"] > 0}})
        if rc == 0:
            return {"checks": checks,
                    "last": stdout.strip().splitlines()[-1]}
    both = sorted(set(checks[0]["regressed"]) & set(checks[1]["regressed"]))
    if both:
        raise AssertionError(
            f"run_bench --check: {both} regressed in both checks; ratios "
            f"{json.dumps([c['ratios'] for c in checks])}")
    return {"checks": checks,
            "last": f"check ok: no row regressed in both checks "
                    f"({checks[0]['regressed']}, then "
                    f"{checks[1]['regressed']})"}


def cli_twins_phase(device, grid: str = "default", jobs: int = 4) -> dict:
    """The command-line twins, each in a child process: ``run_bench``
    writes the grid (every kernel and torch device row present) and
    ``--check`` against its own output passes; ``run_corpus`` on the
    torch lane passes 19/19, and under ``--jobs`` prints the same table
    apart from wall_s."""
    from repro_torch.bench.analyzer_bench import DEVICE_LANES, GRIDS
    dev = ["--device", str(device)]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "bench.json")
        t0 = time.perf_counter()
        child(["repro_torch.cli.run_bench", "--grid", grid, "--out", path,
               *dev])
        out["bench_s"] = time.perf_counter() - t0
        with open(path) as f:
            doc = json.load(f)
        spec = GRIDS[grid]
        want = [f"algo2/m{m}/n{n}/{lane}" for m, n in spec["algo2_device"]
                for lane in DEVICE_LANES] + \
            [f"seedrows/m{m}/n{n}/{lane}" for m, n in spec["seedrows"]
             for lane in ("numpy",) + DEVICE_LANES]
        missing = [w for w in want if w not in doc["entries"]]
        if missing:
            raise AssertionError(f"run_bench left out device rows {missing}")
        out["device_rows_ms"] = {w: doc["entries"][w]["seconds"] * 1e3
                                 for w in want}
        out["meta"] = doc["meta"]
        t0 = time.perf_counter()

        def run(argv):
            r = child(["repro_torch.cli.run_bench", *argv], check=False)
            return r.returncode, r.stdout + r.stderr

        check = bench_self_check(run, path, dev)
        out["check"], out["checks"] = check["last"], check["checks"]
        out["check_s"] = time.perf_counter() - t0
    argv = ["repro_torch.cli.run_corpus", "--backend", "synthetic",
            "--distance-backend", "torch", *dev]
    t0 = time.perf_counter()
    one = child(argv).stdout
    out["corpus_s"] = time.perf_counter() - t0
    if "19/19 entries passed" not in one:
        raise AssertionError(f"run_corpus on the torch lane:\n{one}")
    t0 = time.perf_counter()
    many = child(argv + ["--jobs", str(jobs)]).stdout
    out["corpus_jobs_s"] = time.perf_counter() - t0
    if corpus_table(many) != corpus_table(one):
        raise AssertionError(f"run_corpus --jobs {jobs} printed another "
                             f"table:\n{many}\nagainst\n{one}")
    return out


def csv_rows(stdout: str) -> list:
    """(name, us_per_call, derived) of ``bench.run``'s CSV (a derived
    string may hold commas)."""
    lines = stdout.strip().splitlines()
    if lines[0] != "name,us_per_call,derived":
        raise AssertionError(f"bench.run printed no CSV header: {lines[:3]}")
    rows = []
    for line in lines[1:]:
        name, us, derived = line.split(",", 2)
        rows.append((name, float(us), derived))
    return rows


def in_process(module: str, args) -> str:
    """What ``python -m <module> <args>`` prints, run in this process (the
    kernels already loaded, no process start-up); raises unless its
    ``main`` returns 0 or None, as ``sys.exit`` would exit 0."""
    import contextlib
    import io
    main = importlib.import_module(module).main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(args))
    if rc not in (0, None):
        raise AssertionError(f"{module} {' '.join(args)} returned {rc}")
    return buf.getvalue()


def bench_run(args) -> str:
    return in_process("repro_torch.bench.run", args)


def bench_examples_phase(device, kernels: bool = True,
                         examples=("quickstart", "moe_imbalance")) -> dict:
    """The benchmark and example twins, in this process: the paper
    tables' ``derived`` equal on every lane; the kernel bench's rows
    finite and positive (a kernel row raises unless its kernel launched);
    the examples' ``main`` returns (their exit 0)."""
    import math
    out = {"paper_s": {}, "paper": {}}
    derived = {}
    for lane in LANES:
        t0 = time.perf_counter()
        rows = csv_rows(bench_run(["--only", "paper", "--lane", lane,
                                   "--device", str(device)]))
        out["paper_s"][lane] = time.perf_counter() - t0
        derived[lane] = [(name, d) for name, _, d in rows]
        out["paper"][lane] = {name: us for name, us, _ in rows}
    for lane in LANES:
        if derived[lane] != derived["numpy"]:
            raise AssertionError(f"paper tables differ on the {lane} lane: "
                                 f"{derived[lane]} against "
                                 f"{derived['numpy']}")
    out["derived"] = dict(derived["numpy"])
    if kernels:
        t0 = time.perf_counter()
        rows = csv_rows(bench_run(["--only", "kernels", "--device",
                                   str(device)]))
        out["kernels_s"] = time.perf_counter() - t0
        bad = [r for r in rows if not (math.isfinite(r[1]) and r[1] > 0)]
        if bad or not rows:
            raise AssertionError(f"kernel bench rows not finite and "
                                 f"positive: {bad or rows}")
        out["kernels"] = rows
    for name in examples:
        t0 = time.perf_counter()
        printed = in_process(f"repro_torch.examples.{name}",
                             ["--device", str(device)])
        out[name] = {"s": time.perf_counter() - t0,
                     "tail": printed.strip().splitlines()[-3:]}
    return out


def lane_phases() -> dict:
    """Phases 29-31 on the card, logged."""
    # 29. the torch lane
    t0 = time.perf_counter()
    rows = torch_lane_rows_phase("cuda")
    for k, r in rows["ks"].items():
        log(f"[29] torch lane rows ({FLEET_M}, {FLEET_N}, k = {k}) vs "
            f"float64: at most {r['tf32_off']:.4g} of the lane's bound "
            f"({rows['coef_u']:.2f} u per unit of norm; the kernel lane's "
            f"{rows['kernel_coef_u']:.2f} u), {r['tf32_on']:.4g} with the "
            f"caller's TF32 on (switched off and restored); the same "
            f"product unguarded under TF32 {r['unguarded_tf32']:.4g}")
    fleet = lanes_fleet_phase(FLEET_M, FLEET_N, 2048, "cuda")
    for lane, r in fleet.items():
        d = r["decisions"]
        log(f"[29] fleet {FLEET_M}x{FLEET_N} on the {lane} lane: verdict "
            f"equal to the numpy lane's; analysis {r['wall_s']:.4f} s; "
            f"{r['launches']} seed-row kernel launches; "
            + ("exact lane" if d is None else
               f"{d['flagged']} candidacies flagged, {d['redecided']} "
               f"trials re-decided in {d['redecide_s']:.6f} s, "
               f"{d['kmeans_redecided']} Lloyd loops re-run"))
    with heap_frozen():
        corpus = corpus_phase("cuda", lane="torch")
    log(f"[29] corpus: {corpus['entries']} synthetic entries match "
        f"VERDICTS_synthetic.json on the torch lane; {corpus['launches']} "
        f"seed-row kernel launches; re-decided on the exact lane "
        f"{corpus['decisions']}; {corpus['wall_s']:.3f} s; phase "
        f"{time.perf_counter() - t0:.1f} s")

    # 30. the command-line twins
    t0 = time.perf_counter()
    cli = cli_twins_phase("cuda")
    log(f"[30] run_bench --grid default: device rows (ms) "
        f"{json.dumps(cli['device_rows_ms'])}; meta "
        f"{json.dumps(cli['meta'])}; {cli['bench_s']:.1f} s; --check: "
        f"{cli['check']} ({cli['check_s']:.1f} s)")
    for k, c in enumerate(cli["checks"]):
        log(f"[30] --check {k + 1}: rc {c['rc']}, regressed "
            f"{c['regressed']}, ratios to its baseline "
            f"{json.dumps({n: round(v, 4) for n, v in c['ratios'].items()})}")
    log(f"[30] run_corpus --backend synthetic --distance-backend torch: "
        f"19/19 in {cli['corpus_s']:.1f} s; --jobs 4 the same table in "
        f"{cli['corpus_jobs_s']:.1f} s; phase "
        f"{time.perf_counter() - t0:.1f} s")

    # 31. the benchmark and example twins
    t0 = time.perf_counter()
    bench = bench_examples_phase("cuda")
    log(f"[31] bench.run --only paper: derived equal on the {LANES} lanes "
        f"({json.dumps(bench['paper_s'])} s): "
        f"{json.dumps(bench['derived'])}")
    log(f"[31] bench.run --only kernels ({bench['kernels_s']:.1f} s), "
        f"us per call (CUDA events):")
    for name, us, derived in bench["kernels"]:
        log(f"    {name:36s} {us:12.3f}  {derived}")
    for name in ("quickstart", "moe_imbalance"):
        log(f"[31] examples.{name} ran in {bench[name]['s']:.1f} s: "
            f"{bench[name]['tail']}")
    log(f"[31] phase {time.perf_counter() - t0:.1f} s")
    return {"rows": rows, "fleet": fleet, "corpus": corpus, "cli": cli,
            "bench": bench}


# -- phase 32 --------------------------------------------------------------

# The sharded step: st-100m FULL, float32, 8 x 1024, 3 AdamW steps on a
# (1, 1) mesh ("data", "model") over NCCL at world size 1.
SHARDED_ARGV = ("--arch", "st-100m", "--steps", "3", "--batch", "8",
                "--seq", "1024")
SHARDED_TOL = 1e-5
# The dry-run cells (arch, shape, multi-pod), each a child process on the
# host's CPU, started first and run while the card works.
DRYRUN_CELLS = (("mixtral-8x22b", "train_4k", True),
                ("gemma-7b", "decode_32k", False))
# Sequence parallelism's planning cost: the one-layer mixtral smoke
# training cell (train_4k) on the (2, 16, 16) fake world, with and without
# SP, each a cold child process; SP may take at most SP_PLAN_RATIO times
# the time without it.
SP_PLAN_RATIO = 2.0
SP_PLANNING = r"""
import json, sys, time
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun
sp = sys.argv[1] == "1"
cfg = get_arch("mixtral-8x22b").smoke.with_(n_layers=1)
t0 = time.perf_counter()
r = dryrun.run_cell("mixtral-8x22b", "train_4k", multi_pod=True,
                    probes=False, cfg_override=cfg, sp=sp)
print(json.dumps({"sp": sp, "count_s": r["count_s"],
                  "cell_s": time.perf_counter() - t0,
                  "memory": r["memory"]}))
"""


def compression_child(rank: int, smoke: bool = False) -> dict:
    """In a process group of one rank: st-100m's gradient tree (one step
    at 8 x 1024, float32; the smoke config at 2 x 32 with ``smoke``)
    through ``compressed_psum_fn`` and ``pod_compressed_allreduce`` on a
    (1,) "pod" mesh.  Each leaf must equal ``dequantize(quantize(g))`` bit
    for bit (one rank: the mean of one), and ``collectives_of`` must count
    the int32 codes and the shared amax of every leaf."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_arch
    from repro_torch.core.hlo import collectives_of
    from repro_torch.data import DataConfig, device_batch
    from repro_torch.models import family_module
    from repro_torch.optim import (compressed_psum_fn, dequantize_int8,
                                   pod_compressed_allreduce, quantize_int8)
    from repro_torch.train.loop import _skeleton, value_and_grad
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    entry = get_arch("st-100m")
    cfg = entry.smoke if smoke else entry.full
    batch, seq = (2, 32) if smoke else (8, 1024)
    model = family_module(cfg).init(cfg, 0, device)
    params = {k: p.detach() for k, p in model.named_parameters()}
    del model
    _, _, grads = value_and_grad(_skeleton(cfg), params, device_batch(
        DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab), 0,
        device))
    mean = compressed_psum_fn(grads)     # the group's first collectives
    t0 = time.perf_counter()
    compressed_psum_fn(grads)
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    mesh = init_device_mesh(device, (1,), mesh_dim_names=("pod",))
    pod = pod_compressed_allreduce(mesh, {k: g[None]
                                          for k, g in grads.items()})
    bad = [k for k, g in grads.items()
           if not (torch.equal(mean[k], dequantize_int8(*quantize_int8(g)))
                   and torch.equal(pod[k], mean[k]))]
    if bad:
        raise AssertionError(f"compressed mean != dequantize(quantize(g)) "
                             f"for {bad[:5]}")
    stats = collectives_of(compressed_psum_fn, grads)
    want = sum(4 * g.numel() + 4 for g in grads.values())
    if stats.bytes_by_op != {"all-reduce": want} or \
            stats.count_by_op != {"all-reduce": 2 * len(grads)}:
        raise AssertionError(f"collectives_of counted {stats.summary()}; "
                             f"want all-reduce {want:,} bytes in "
                             f"{2 * len(grads)} calls")
    return {"leaves": len(grads), "elements": sum(g.numel()
                                                  for g in grads.values()),
            "allreduce_bytes": want, "summary": stats.summary(),
            "psum_s": secs}


def unsharded_steps(argv, device) -> dict:
    """The unsharded trainer on ``argv``'s config, step by step: each
    step's loss and kernel launches."""
    from repro_torch import kernels as K
    from repro_torch.launch import train
    trainer = train.build_trainer(train.parser().parse_args(
        [*argv, "--device", str(device)]))
    losses, launches = [], []
    for _ in range(trainer.tcfg.steps):
        before = dict(K.LAUNCHES)
        losses.append(trainer.run(1)[-1]["loss"])
        launches.append({k: v - before[k] for k, v in K.LAUNCHES.items()})
    return {"losses": losses, "launches_per_step": launches}


def last_json(stdout: str) -> dict:
    return json.loads([l for l in stdout.splitlines()
                       if l.startswith("{")][-1])


def multi_device_phase(device, argv=SHARDED_ARGV, cells=DRYRUN_CELLS,
                       smoke: bool = False) -> dict:
    """Phase 32, its parts side by side: the dry-run cells and
    ``examples.dryrun_triage`` start as child processes on the CPU (fake
    256-, 512- or 8-rank worlds, ``meta`` tensors); the compressed
    all-reduce runs in a one-rank child (``compression_child``, waited
    for on a thread); and on the card ``repro_torch.launch.train --mesh
    1x1`` (a child: its NCCL group of one touches nothing else) runs
    against the unsharded trainer in this process — each step's loss
    within ``SHARDED_TOL`` relative, and RMSNorm and attention launched
    as many times each step, through the CUDA kernels on each rank's
    shards.  Each cell must be ok, with its per-rank bytes and the three
    roofline terms logged; a training cell runs under sequence
    parallelism, and the one-layer mixtral smoke cell plans with SP in at
    most ``SP_PLAN_RATIO`` times its time without (two cold children,
    ``SP_PLANNING``).  The triage runs twice, its analysis on the card's
    kernel lane and on the exact host lane, and the two verdicts must be
    equal."""
    from repro_torch.launch.mesh import run_ranks
    on_card = _on_card(device)
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    out = {"cells": {}}
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for arch, shape, multi in cells:
            path = str(pathlib.Path(tmp) / f"{arch}_{shape}.json")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--out", path]
            procs.append((arch, shape, path, subprocess.Popen(
                cmd + (["--multi-pod"] if multi else []), cwd=ROOT,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        triage = {lane: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.examples.dryrun_triage",
             *flags], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for lane, flags in (
                ("kernel", ["--device", str(device)]),
                ("exact", ["--distance-backend", "numpy"]))}
        planning = {sp: subprocess.Popen(
            [sys.executable, "-c", SP_PLANNING, str(int(sp))], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for sp in (True, False)}
        compression = {}

        def compress() -> None:
            t1 = time.perf_counter()
            try:
                compression["result"] = run_ranks(
                    compression_child, 1, "nccl" if on_card else "gloo",
                    args=(smoke,))[0]
            except BaseException as e:  # re-raised on the main thread
                compression["error"] = e
            compression["s"] = time.perf_counter() - t1

        worker = threading.Thread(target=compress)
        worker.start()
        try:
            t1 = time.perf_counter()
            flags = (["--smoke"] if smoke else []) + ["--device",
                                                     str(device)]
            sharded = last_json(child(["repro_torch.launch.train", *argv,
                                       *flags, "--mesh", "1x1"]).stdout)
            plain = unsharded_steps([*argv] + (["--smoke"] if smoke
                                               else []), device)
            for i, (a, b) in enumerate(zip(sharded["losses"],
                                           plain["losses"])):
                if not abs(a - b) <= SHARDED_TOL * abs(b):
                    raise AssertionError(f"sharded step {i} loss {a} != "
                                         f"unsharded {b}")
            for i, (a, b) in enumerate(zip(sharded["launches_per_step"],
                                           plain["launches_per_step"])):
                for name in ("rmsnorm", "flash_attention"):
                    if a[name] != b[name] or (on_card and not a[name]):
                        raise AssertionError(
                            f"sharded step {i} launched {name} {a[name]} "
                            f"times, the unsharded step {b[name]}")
            out["sharded"], out["plain"] = sharded, plain
            out["sharded_s"] = time.perf_counter() - t1
        finally:
            worker.join()
            t_out = {}
            for lane, p in triage.items():
                stdout, stderr = p.communicate(timeout=600)
                if p.returncode != 0 or "CCR:" not in stdout:
                    raise AssertionError(
                        f"dryrun_triage ({lane} lane) exited "
                        f"{p.returncode}, found no CCR:\n{stdout[-2000:]}"
                        f"\n{stderr[-3000:]}")
                t_out[lane] = [l for l in stdout.splitlines()
                               if l.startswith(("CCR", "CCCR", "root-cause"))]
            for sp, p in planning.items():
                stdout, stderr = p.communicate(timeout=600)
                if p.returncode != 0:
                    raise AssertionError(f"SP planning child (sp={sp}) "
                                         f"exited {p.returncode}:\n"
                                         f"{stderr[-3000:]}")
                out.setdefault("sp_planning", {})[
                    "sp" if sp else "no_sp"] = last_json(stdout)
            for arch, shape, path, p in procs:
                try:
                    stdout, stderr = p.communicate(timeout=600)
                except subprocess.TimeoutExpired:
                    p.kill()
                    stdout, stderr = p.communicate()
                if p.returncode != 0:
                    raise AssertionError(f"dry-run {arch} {shape} exited "
                                         f"{p.returncode}:\n{stdout[-2000:]}"
                                         f"\n{stderr[-3000:]}")
                with open(path) as f:
                    (r,) = json.load(f)
                if not r.get("ok"):
                    raise AssertionError(f"dry-run {arch} {shape}: {r}")
                out["cells"][f"{arch}/{shape}"] = r
    if "error" in compression:
        raise compression["error"]
    out["compression"] = compression["result"]
    out["compression_s"] = compression["s"]
    if t_out["kernel"] != t_out["exact"]:
        raise AssertionError(f"the triage's kernel-lane verdict "
                             f"{t_out['kernel']} differs from the exact "
                             f"lane's {t_out['exact']}")
    out["triage"] = t_out["kernel"]
    plan = out["sp_planning"]
    if plan["sp"]["count_s"] > SP_PLAN_RATIO * plan["no_sp"]["count_s"]:
        raise AssertionError(f"the SP cell planned in {plan['sp']} s, over "
                             f"{SP_PLAN_RATIO} x the {plan['no_sp']} s "
                             f"without SP")
    out["phase_s"] = time.perf_counter() - t0
    return out


def log_multi_device(res: dict, card_bytes: float = 80e9) -> None:
    sh, pl = res["sharded"], res["plain"]
    log(f"[32] launch.train --mesh 1x1 (NCCL, world 1), st-100m FULL f32 "
        f"8 x 1024, 3 steps: losses {sh['losses']} against the "
        f"unsharded {pl['losses']} (tolerance {SHARDED_TOL} relative); "
        f"launches per step {sh['launches_per_step']} (unsharded "
        f"{pl['launches_per_step']}); median step "
        f"{sh['median_step_s'] * 1e3:.1f} ms; peak memory "
        f"{sh['peak_memory_bytes']} bytes; {res['sharded_s']:.1f} s")
    c = res["compression"]
    log(f"[32] compressed_psum_fn / pod_compressed_allreduce over NCCL on "
        f"st-100m's {c['leaves']} gradient leaves ({c['elements']:,} "
        f"elements): equal to dequantize(quantize(g)) bit for bit; "
        f"collectives_of: {c['summary']} (int32 codes, 4 bytes an "
        f"element); psum {c['psum_s'] * 1e3:.1f} ms (a second call); "
        f"{res['compression_s']:.1f} s")
    for name, r in res["cells"].items():
        mem, t = r["memory"], r["roofline"]
        mem_s = ", ".join(f"{k} {v:.4g} ({v / card_bytes:.3f} of 80 GB)"
                          for k, v in mem.items())
        log(f"[32] dryrun {name} on {r['mesh']} ({r['chips']} fake ranks, "
            f"meta, CPU host; sequence parallel: "
            f"{r['shape'].startswith('train')}): counted in "
            f"{r['count_s']:.1f} s; per rank {mem_s}; FLOPs "
            f"{r['cost']['flops']:.4g}, "
            f"bytes {r['cost']['bytes']:.4g}, collectives "
            f"{r['cost']['collective_bytes']:.4g}; H100 terms compute "
            f"{t['compute_s']:.4g} s, memory {t['memory_s']:.4g} s, "
            f"collective {t['collective_s']:.4g} s (NVLink 450 GB/s, a "
            f"lower bound across nodes): {t['dominant']}; "
            f"{r['wall_s']:.1f} s")
    sp, no_sp = res["sp_planning"]["sp"], res["sp_planning"]["no_sp"]
    log(f"[32] one-layer mixtral smoke train_4k on (2, 16, 16), cold "
        f"children on the CPU host: counted in {sp['count_s']:.2f} s with "
        f"SP, {no_sp['count_s']:.2f} s without (at most {SP_PLAN_RATIO} "
        f"x); temp {sp['memory']['temp_size_in_bytes']:.4g} against "
        f"{no_sp['memory']['temp_size_in_bytes']:.4g} bytes a rank")
    log(f"[32] examples.dryrun_triage, kernel lane on the card = exact "
        f"lane: {res['triage']}")
    log(f"[32] phase {res['phase_s']:.1f} s")


def log_family_parity(phase: str, cfg, res: dict, wall: float) -> None:
    f, d, t = res["forward"], res["decode"], res["train"]
    enc = (f"; encoder output max|card-host| {f['encoder_err']:.6g} of "
           f"scale {f['encoder_scale']:.6g}" if "encoder_err" in f else "")
    enc_layers = (f" (+{cfg.n_encoder_layers} encoder)"
                  if cfg.n_encoder_layers else "")
    log(f"[{phase}] {cfg.name} width, {cfg.n_layers} layers{enc_layers}"
        f", f32: forward logits {f['shape']} max|card-host| "
        f"{f['max_abs_err']:.6g} of scale {f['scale']:.6g}{enc} "
        f"(tolerance {PARITY_RTOL} x scale); decode max|card-host| "
        f"{d['max_abs_err']:.6g} of scale {d['logit_scale']:.6g}, greedy "
        f"tokens equal {d['tokens']}; card launches forward "
        f"{f['launches']}, decode {d['launches']} over {d['calls']} calls")
    log(f"[{phase}] one training step at tokens {t['text_shape']}: loss "
        f"{t['loss']} (tolerance {TRAIN_LOSS_RTOL} relative), worst gradient "
        f"over its scale {t['worst_grad']} (tolerance {GRAD_TOL}) "
        f"{t['grad_err']}; card launches {t['launches']}; "
        f"{wall:.1f} s")


def log_served(phase: str, argv, res: dict) -> None:
    log(f"[{phase}] serve {' '.join(argv)}: {json.dumps(res['summary'])}")
    from repro_torch.configs import get_arch
    cfg = get_arch(argv[1]).full
    per = launches_per_call(cfg)
    if cfg.family == "encdec":
        per = f"{per} per call and {launches_per_encode(cfg)} per encode"
    log(f"[{phase}] {res['model_calls']} model calls and "
        f"{res['encode_calls']} encodes, launches {res['launches']} (= "
        f"{per}); "
        f"max_memory_allocated {res['max_memory_allocated']} bytes; phase "
        f"wall {res['wall_s']:.1f} s (model init included); trace (steps, "
        f"lanes, regions) {res['trace_shape']}; CPU clock (name, tick s) "
        f"{res['cpu_clock']}")
    log_breakdown(phase, res["breakdown"])
    log_graph_parity(phase, res["graph_parity"])
    log(f"[{phase}] verdict, equal on the kernel and numpy lanes "
        f"({res['analysis_launches']} seed-row launches, by seed count k "
        f"{res['seed_counts']}; re-decided {res['decisions']}): "
        f"{json.dumps(res['verdict'], sort_keys=True)}")


# -- driver ----------------------------------------------------------------

def main() -> int:
    import torch
    t_start = time.perf_counter()
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
    with heap_frozen():
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
        padded = (f", v padded from {attention_case(name)['dv']} (bound of "
                  f"the padded call {t['padded_bound_ms']:.6f} ms)"
                  if "dv" in attention_case(name) else "")
        log(f"[6] attention {name} {attention_shape(name)} (B, Q, H, KV, "
            f"dh, K){padded}: paths f32 "
            f"{attention_plan_of(name, torch.float32).path}"
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
    log_graph_parity("8", served["graph_parity"])
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
    log_graph_parity("11", rserved["graph_parity"])
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
    with heap_frozen():
        chaos = chaos_phase("cuda")
    log(f"[14] {len(CHAOS_OUTCOMES)} chaos and fleet entries at seeds "
        f"{list(CHAOS_SEEDS)} pass on the kernel lane with the reference's "
        f"outcomes ({chaos['runs']} runs, {time.perf_counter() - t0:.1f} s;"
        f" {chaos['launches']} seed-row launches, by seed count k "
        f"{chaos['seed_counts']}; re-decided {chaos['decisions']})")
    log(f"[14] wall per run, s: {json.dumps(chaos['walls_s'])}")

    # 15. the training path's kernels with their gradients vs plain
    tr_rms, tr_attn = {}, {}
    for n, d in TRAIN_RMS_SHAPES:
        tr_rms[(n, d)] = r = {**check_train_rmsnorm(n, d, "cuda"),
                              **time_train_rmsnorm(n, d)}
        log(f"[15] rmsnorm ({n}, {d}) f32 with gradients: max error over "
            f"scale output {r['fwd']:.3g} (tolerance {F32_TOL}), dx "
            f"{r['dx']:.3g}, dw {r['dw']:.3g} (tolerance {GRAD_TOL}); "
            f"kernel forward {r['ms']:.6f} ms, backward formulas "
            f"{r['backward_ms']:.6f} ms, plain forward {r['plain_ms']:.6f} "
            f"ms, forward+backward {r['plain_fwd_bwd_ms']:.6f} ms, "
            f"F.rms_norm forward {r['library_ms']:.6f} ms, forward+backward "
            f"{r['library_fwd_bwd_ms']:.6f} ms, forward bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']})")
    for name, case in TRAIN_ATTN_CASES.items():
        tr_attn[name] = r = {**check_train_attention(name, "cuda"),
                             **time_train_attention(name)}
        lib = ("none (softcap)" if r["library_ms"] is None else
               f"{r['library_ms']:.6f} ms (device "
               f"{r['library_device_ms']:.6f} ms), forward+backward "
               f"{r['library_fwd_bwd_ms']:.6f} ms")
        log(f"[15] attention {name} {case} f32 with gradients, path "
            f"{r['plan']}: max error over scale output {r['fwd']:.3g} "
            f"(tolerance {F32_TOL}), dq {r['dq']:.3g}, dk {r['dk']:.3g}, "
            f"dv {r['dv']:.3g} (tolerance {GRAD_TOL}); kernel forward "
            f"{r['ms']:.6f} ms (device {r['device_ms']} ms), backward "
            f"formulas {r['backward_ms']:.6f} "
            f"ms, plain forward {r['plain_ms']:.6f} ms, forward+backward "
            f"{r['plain_fwd_bwd_ms']:.6f} ms, SDPA forward {lib}, "
            f"forward bound {r['bound_ms']:.6f} ms ({r['bound_by']})")

    # 16. training parity, card vs host
    t0 = time.perf_counter()
    tparity = train_parity_phase(parity_config("st-100m"), "cuda")
    log(f"[16] st-100m width, 2 layers, f32, one step card vs host: loss "
        f"{tparity['loss']} (tolerance {TRAIN_LOSS_RTOL} relative), worst "
        f"gradient over its scale {tparity['worst_grad']} (tolerance "
        f"{GRAD_TOL}); losses of {TRAIN_PARITY_STEPS} AdamW steps card "
        f"{tparity['losses'][0]}, host {tparity['losses'][1]} (tolerance "
        f"{TRAIN_TRAJ_RTOL} relative); card launches {tparity['launches']} "
        f"over {tparity['forwards']} forwards; "
        f"{time.perf_counter() - t0:.1f} s")

    # 17. training st-100m FULL, profiled, then a traced trainer
    from repro_torch.configs import get_arch
    trained = train_phase(TRAIN_ARGV, "cuda")
    st_full = get_arch("st-100m").full
    log(f"[17] train {' '.join(TRAIN_ARGV)} under remat_policy "
        f"{st_full.remat_policy!r}: losses "
        f"{json.dumps(trained['losses'])}; launches {trained['launches']} "
        f"(= {launches_per_call(st_full)} per forward and "
        f"{recompute_per_step(st_full)} per recompute, {trained['steps']} "
        f"steps); median "
        f"step {trained['median_step_s'] * 1e3:.4f} ms (step 0 excluded), "
        f"{trained['tokens_per_s']:.1f} tokens/s, peak memory "
        f"{trained['peak_memory_bytes']} bytes; wall {trained['wall_s']:.1f}"
        f" s")
    log_train_breakdown("17", trained["breakdown"])
    traced = traced_train_phase(get_arch("st-100m").full, "cuda")
    log(f"[17] traced trainer st-100m FULL, shards' fwd_bwd iterations "
        f"{list(TRACE_ITERS)}, {TRACE_STEPS} steps: "
        f"{json.dumps(traced['steps'])}; launches {traced['launches']} over "
        f"{traced['forwards']} forwards; cost_of (FLOPs, bytes) "
        f"{traced['costs']}; CUDA-event device s {traced['device_s']}; "
        f"peak memory {traced['max_memory_allocated']} bytes; wall "
        f"{traced['wall_s']:.1f} s")
    log(f"[17] verdict, equal on the kernel and numpy lanes "
        f"({traced['analysis_launches']} seed-row launches, by seed count k "
        f"{traced['seed_counts']}; re-decided {traced['decisions']}): "
        f"{json.dumps(traced['verdict'], sort_keys=True)}")

    # 18. the training and serving slice's corpus entries on the card
    t0 = time.perf_counter()
    with heap_frozen():
        newe = new_entries_phase("cuda")
    log(f"[18] {len(NEW_ENTRIES)} serving, train, recovery and checkpoint "
        f"entries at seeds {list(CHAOS_SEEDS)} pass on the kernel lane with "
        f"the reference's outcomes ({len(newe['runs'])} runs, "
        f"{time.perf_counter() - t0:.1f} s; launches {newe['launches']}, "
        f"seed-row launches by seed count k {newe['seed_counts']}; "
        f"re-decided {newe['decisions']})")
    log(f"[18] runs: {json.dumps(newe['runs'])}")

    # 19. MoE parity: deepseek-v2-lite-16b's width, 2 layers, card vs host
    t0 = time.perf_counter()
    mparity = moe_parity_phase(parity_config("deepseek-v2-lite-16b"), "cuda")
    log(f"[19] deepseek-v2-lite-16b width, 2 layers, f32: max|card-host| "
        f"logits {mparity['max_abs_err']:.6g} of scale "
        f"{mparity['logit_scale']:.6g} (tolerance {PARITY_RTOL} x scale); "
        f"greedy tokens equal {mparity['tokens']}; every token's expert ids "
        f"equal in both layers of all {mparity['calls']} calls; smallest "
        f"top-k margin (k-th minus (k+1)-th router probability, host) "
        f"{mparity['min_margin']:.6g}; card launches {mparity['launches']} "
        f"over {mparity['calls']} model calls; "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"[19] decode calls' expert ids (layer, choice): "
        f"{json.dumps([c for c in mparity['expert_ids'][1:]])}")

    # 20. serving deepseek-v2-lite-16b FULL on the card, then its trace
    # analyzed
    dserved = serve_phase(DSV2_SERVE_ARGV, "cuda")
    log(f"[20] serve {' '.join(DSV2_SERVE_ARGV)}: "
        f"{json.dumps(dserved['summary'])}")
    log(f"[20] {dserved['model_calls']} model calls, launches "
        f"{dserved['launches']} (= 55 and 27 per call); "
        f"max_memory_allocated {dserved['max_memory_allocated']} bytes; "
        f"phase wall {dserved['wall_s']:.1f} s (model init included); "
        f"trace (steps, lanes, regions) {dserved['trace_shape']}; CPU clock "
        f"(name, tick s) {dserved['cpu_clock']}")
    log_breakdown("20", dserved["breakdown"])
    log_graph_parity("20", dserved["graph_parity"])
    log(f"[20] verdict, equal on the kernel and numpy lanes "
        f"({dserved['analysis_launches']} seed-row launches, by seed count k"
        f" {dserved['seed_counts']}; re-decided {dserved['decisions']}): "
        f"{json.dumps(dserved['verdict'], sort_keys=True)}")

    # 21. MoE training: one step card vs host, then the MoE train entries
    mtrain = {}
    for arch in MOE_TRAIN_ARCHS:
        t0 = time.perf_counter()
        mtrain[arch] = r = train_parity_phase(
            get_arch(arch).smoke, "cuda", batch=2, seq=MOE_TRAIN_SEQ,
            steps=0)
        log(f"[21] {get_arch(arch).smoke.name} f32, one step card vs host at"
            f" 2 x {MOE_TRAIN_SEQ}: loss {r['loss']} (tolerance "
            f"{TRAIN_LOSS_RTOL} relative), worst gradient over its scale "
            f"{r['worst_grad']} (tolerance {GRAD_TOL}); card launches "
            f"{r['launches']} over {r['forwards']} forwards; "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with heap_frozen():
        moee = new_entries_phase("cuda", names=MOE_ENTRIES, phase="21")
    log(f"[21] {len(MOE_ENTRIES)} MoE train entries at seeds "
        f"{list(CHAOS_SEEDS)} pass on the kernel lane with the reference's "
        f"outcomes ({len(moee['runs'])} runs, {time.perf_counter() - t0:.1f}"
        f" s; launches {moee['launches']}, seed-row launches by seed count "
        f"k {moee['seed_counts']}; re-decided {moee['decisions']})")
    log(f"[21] runs: {json.dumps(moee['runs'])}")

    # 22. the vlm: phi-3-vision-4.2b's width cut card vs host, then FULL
    # served, then a FULL forward over the patch prefix
    t0 = time.perf_counter()
    vparity = family_parity_phase(parity_config(PHI3V), "cuda")
    log_family_parity("22", parity_config(PHI3V), vparity,
                      time.perf_counter() - t0)
    vserved = serve_phase(PHI3V_SERVE_ARGV, "cuda",
                          after=lambda b: prefixed_forward(b.model, 64))
    log_served("22", PHI3V_SERVE_ARGV, vserved)
    log(f"[22] phi-3-vision-4.2b FULL bf16 forward over its "
        f"{vserved['after']['shape'][1] - 64}-patch prefix and 64 tokens: "
        f"logits {vserved['after']['shape']} finite, max |logit| "
        f"{vserved['after']['scale']:.6g}")

    # 23. the hybrid: recurrentgemma-9b's width cut to one (rec, rec, attn)
    # block and a (rec, rec) tail, card vs host, then FULL served
    t0 = time.perf_counter()
    hcfg = parity_config(RGEMMA, n_layers=5)
    hparity = family_parity_phase(hcfg, "cuda")
    log_family_parity("23", hcfg, hparity, time.perf_counter() - t0)
    hserved = serve_phase(RGEMMA_SERVE_ARGV, "cuda")
    log_served("23", RGEMMA_SERVE_ARGV, hserved)

    # 24. the encdec: seamless-m4t-medium's width cut to 2 + 2 layers,
    # card vs host, then FULL served, each request encoding its frames
    t0 = time.perf_counter()
    eparity = family_parity_phase(parity_config(SEAMLESS), "cuda")
    log_family_parity("24", parity_config(SEAMLESS), eparity,
                      time.perf_counter() - t0)
    eserved = serve_phase(SEAMLESS_SERVE_ARGV, "cuda")
    log_served("24", SEAMLESS_SERVE_ARGV, eserved)

    # 25-28. ssm training and the remat policy
    ssm = ssm_training_phases()

    # 29-31. the torch lane, the command-line, benchmark and example twins
    lanes = lane_phases()

    # 32. multi-device and launch/
    multi = multi_device_phase("cuda")
    log_multi_device(multi)

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
                        "chaos": chaos["seed_counts"],
                        "train_trace": traced["seed_counts"],
                        "new_entries": newe["seed_counts"],
                        "serve_deepseek": dserved["seed_counts"],
                        "moe_entries": moee["seed_counts"],
                        "serve_phi3v": vserved["seed_counts"],
                        "serve_rgemma": hserved["seed_counts"],
                        "serve_seamless": eserved["seed_counts"]},
        "decisions": {"corpus": corpus["decisions"],
                      "fleet": fleet["decisions"],
                      "serve_gemma": served["decisions"],
                      "serve_rwkv": rserved["decisions"],
                      "runtime": runtime["decisions"],
                      "stream_fleet": stream["decisions"],
                      "live_rwkv": live["decisions"],
                      "chaos": chaos["decisions"],
                      "train_trace": traced["decisions"],
                      "new_entries": newe["decisions"],
                      "serve_deepseek": dserved["decisions"],
                      "moe_entries": moee["decisions"],
                      "serve_phi3v": vserved["decisions"],
                      "serve_rgemma": hserved["decisions"],
                      "serve_seamless": eserved["decisions"]},
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
    rms["launches_train"] = trained["launches"]["rmsnorm"]
    rms["train"] = {"shape": list(TRAIN_RMS_MAIN), "dtype": "float32",
                    **tr_rms[TRAIN_RMS_MAIN]}
    attn["launches_train"] = trained["launches"]["flash_attention"]
    attn["train"] = {"case": TRAIN_ATTN_MAIN, "dtype": "float32",
                     **TRAIN_ATTN_CASES[TRAIN_ATTN_MAIN],
                     **tr_attn[TRAIN_ATTN_MAIN]}
    attn["train_cases"] = {name: r for name, r in tr_attn.items()}
    attn["launches_deepseek_serve"] = dserved["launches"]["flash_attention"]
    attn["mla"] = {name: {"shape": attention_shape(name), "dv": 128,
                          **attn_t[name]} for name in ATTN_MLA}
    rms["launches_deepseek_serve"] = dserved["launches"]["rmsnorm"]
    rms["deepseek"] = {f"{n}x{d}": rms_t[(n, d)]
                       for n, d in (RMS_DSV2, RMS_DSV2_PREFILL)}
    rms["families"] = {f"{n}x{d}": rms_t[(n, d)] for n, d in RMS_FAMILIES}
    attn["families"] = {name: {"shape": attention_shape(name),
                               **attn_t[name]} for name in ATTN_FAMILIES}
    for tag, res in (("phi3v", vserved), ("rgemma", hserved),
                     ("seamless", eserved)):
        for kd in (rms, attn):
            kd[f"launches_{tag}_serve"] = res["launches"][kd["name"]]
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
        "launches_train": ssm["rtrained"]["launches"]["wkv6"],
        "train": {"shape": list(TRAIN_WKV_CASES[TRAIN_WKV_MAIN]),
                  "dtype": "bfloat16",
                  **ssm["train_wkv"][TRAIN_WKV_MAIN],
                  "cases": {n: r for n, r in ssm["train_wkv"].items()
                            if n != TRAIN_WKV_MAIN},
                  "step_shares": ssm["rtrained"]["shares"]},
    })
    rms["launches_train_rwkv6"] = ssm["rtrained"]["launches"]["rmsnorm"]
    for kd in (rms, attn):
        kd["launches_sharded_train"] = sum(
            step[kd["name"]] for step in multi["sharded"]["launches_per_step"])
    kernels[0]["library"] = "core/clustering.py::torch_seed_rows (addmm)"
    kernels[0]["torch_lane"] = {
        "rows": lanes["rows"], "corpus_decisions":
        lanes["corpus"]["decisions"],
        "fleet": {lane: {"wall_s": r["wall_s"], "launches": r["launches"],
                         "decisions": r["decisions"]}
                  for lane, r in lanes["fleet"].items()}}
    c = PROFILE_ROWS_COST
    log(f"chip_smoke: _profile_rows recorded {c['windows']} windows for "
        f"{c['calls']} calls ({c['windows'] - c['calls']} recorded again); "
        f"their pauses after the warm-up and before the close took "
        f"{c['pause_s']:.1f} s, reading their raw lists {c['check_s']:.1f} "
        f"s")
    log(f"chip_smoke: phases 1-32 passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
