"""Kernel micro-benchmarks of the port.

The twin of the reference's ``benchmarks/kernel_bench.py``, at its shapes:
attention at B 1, H 4, dh 64, S ∈ {256, 1024}, causal, float32; WKV-6 at
B 1, H 4, T 512, dh 64; ``train_step_smoke`` (st-100m smoke, 4 × 64).
Beside them RMSNorm at gemma-7b's bf16 decode row and prefill chunk,
(1, 3072) and (256, 3072), and the seed rows at the fleet shape (16384 ×
128) with 1 and 8 seeds — the main shapes of those kernels in the port.

Each kernel has up to three rows: ``<kernel>_kernel_<shape>`` (the
hand-written CUDA kernel through its wrapper; a row raises unless
``repro_torch.kernels.LAUNCHES`` grew while it ran), ``_plain_`` (its
plain PyTorch version) and ``_library_`` (one PyTorch call of the same
function, where there is one: ``F.scaled_dot_product_attention``,
``F.rms_norm``, and for the seed rows the torch lane's ``addmm``).  No
PyTorch call computes WKV-6.  The kernel rows exist on the card only: a
CPU tensor takes the plain version, which launches nothing.

Every row is the mean of back-to-back calls timed by CUDA events on the
card (the host clock with ``device="cpu"``), in microseconds; ``derived``
gives GFLOP/s (attention, seed rows), GB/s (RMSNorm) or tokens/s (WKV-6,
the training step).
"""
from __future__ import annotations

import time
from typing import Callable, List, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch import kernels as K
from repro_torch.core import resolve_device
from repro_torch.core.clustering import torch_seed_rows
from repro_torch.kernels.distance import seed_rows_work
from repro_torch.kernels.rmsnorm import rmsnorm_work

Row = Tuple[str, float, str]
ATTN_SEQS = (256, 1024)
ATTN_SHAPE = (1, 4, 64)               # B, H, dh
WKV_SHAPE = (1, 512, 4, 64)           # B, T, H, dh
RMS_SHAPES = ((1, 3072), (256, 3072))
RMS_EPS = 1e-6
SEED_ROWS = (16384, 128)
SEED_KS = (1, 8)
# The row names' first word, per kernel (the reference's "attn" and
# "wkv6"; "seedrows" as in the analyzer bench).
ROW_PREFIX = {"flash_attention": "attn", "wkv6": "wkv6",
              "rmsnorm": "rmsnorm", "multi_seed_rows": "seedrows"}


def per_call_us(fn: Callable[[], object], iters: int,
                device: torch.device) -> float:
    """Mean microseconds per call over ``iters`` back-to-back calls after
    three warmup calls: CUDA events on the card, the host clock
    elsewhere."""
    for _ in range(3):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def _normal(shape, gen: torch.Generator, device, dtype=torch.float32):
    return torch.randn(shape, generator=gen, dtype=torch.float32
                       ).to(device=device, dtype=dtype)


def _rows(kernel: str, shape: str, device: torch.device, fns: dict,
          iters: int, derived: Callable[[float], str]) -> List[Row]:
    """Rows ``{kernel}_{kind}_{shape}`` for each ``kind -> fn`` of
    ``fns``, timed per call; the ``"kernel"`` row runs on the card only and
    raises unless ``LAUNCHES[kernel]`` grew while it ran."""
    out = []
    for kind, fn in fns.items():
        if kind == "kernel" and device.type != "cuda":
            continue
        before = K.LAUNCHES[kernel]
        us = per_call_us(fn, iters, device)
        if kind == "kernel" and K.LAUNCHES[kernel] <= before:
            raise AssertionError(f"{kernel}_kernel_{shape}: the kernel "
                                 f"never launched")
        out.append((f"{ROW_PREFIX[kernel]}_{kind}_{shape}", us,
                    derived(us)))
    return out


def attention_paths(device: torch.device) -> List[Row]:
    rows = []
    B, H, dh = ATTN_SHAPE
    for S in ATTN_SEQS:
        gen = torch.Generator().manual_seed(S)
        q, k, v = (_normal((B, S, H, dh), gen, device) for _ in range(3))
        pos = torch.arange(S, dtype=torch.int32, device=device)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        flops = 4.0 * B * H * S * S * dh / 2     # causal
        rows += _rows("flash_attention", f"S{S}", device, {
            "kernel": lambda: K.flash_attention(q, k, v, pos, pos),
            "plain": lambda: K.flash_attention_ref(q, k, v, pos, pos),
            "library": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True),
        }, 20, lambda us: f"gflops={flops / us / 1e3:.2f}")
    return rows


def wkv_paths(device: torch.device) -> List[Row]:
    B, T, H, dh = WKV_SHAPE
    gen = torch.Generator().manual_seed(T)
    r, k, v = (_normal((B, T, H, dh), gen, device) for _ in range(3))
    w = (0.9 + 0.099 * torch.rand((B, T, H, dh), generator=gen)
         ).to(device)
    u = 0.3 * _normal((H, dh), gen, device)
    S = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=device)
    # the kernel carries S from call to call, as decoding does; the decays
    # keep it bounded
    return _rows("wkv6", f"T{T}", device, {
        "kernel": lambda: K.wkv6(r, k, v, w, u, S),
        "plain": lambda: K.wkv6_ref(r, k, v, w, u, S),
    }, 5, lambda us: f"tokens_per_s={B * T / us * 1e6:.0f}")


def rmsnorm_paths(device: torch.device) -> List[Row]:
    rows = []
    for n, d in RMS_SHAPES:
        gen = torch.Generator().manual_seed(n * d)
        x = (2.0 * _normal((n, d), gen, device) + 0.5).to(torch.bfloat16)
        w = (0.1 * _normal((d,), gen, device)).to(torch.bfloat16)
        w1 = (1.0 + w).to(torch.bfloat16)
        _, nbytes = rmsnorm_work(n, d, 2)
        rows += _rows("rmsnorm", f"{n}x{d}", device, {
            "kernel": lambda: K.rmsnorm(x, w, RMS_EPS),
            "plain": lambda: K.rmsnorm_ref(x, w, RMS_EPS),
            "library": lambda: F.rms_norm(x, (d,), w1, RMS_EPS),
        }, 100, lambda us: f"gbytes_per_s={nbytes / us / 1e3:.2f}")
    return rows


def seed_row_paths(device: torch.device) -> List[Row]:
    rows = []
    m, n = SEED_ROWS
    gen = torch.Generator().manual_seed(m + n)
    W = 100.0 + torch.rand((m, n), generator=gen, dtype=torch.float64)
    W[: m // 8] *= 5.0
    pts = W.float().to(device)
    sq = (W * W).sum(dim=1).float().to(device)
    for k in SEED_KS:
        idx = torch.arange(0, m, m // k, dtype=torch.int32,
                           device=device)[:k]
        flops, _ = seed_rows_work(m, n, k)
        rows += _rows("multi_seed_rows", f"m{m}_n{n}_k{k}", device, {
                          "kernel": lambda: K.multi_seed_rows(pts, sq, idx),
                          "plain": lambda: K.multi_seed_rows_ref(
                              pts, sq, idx),
                          "library": lambda: torch_seed_rows(pts, sq, idx),
                      }, 100, lambda us: f"gflops={flops / us / 1e3:.2f}")
    return rows


def train_step_bench(device: torch.device) -> List[Row]:
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, device_batch
    from repro_torch.models import family_module
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step
    cfg = get_arch("st-100m").smoke
    model = family_module(cfg).init(cfg, 0, device)
    params = {k: p.detach() for k, p in model.named_parameters()}
    del model
    state = [params, init_opt_state(params)]
    step = make_train_step(cfg, AdamWConfig())
    batch = device_batch(DataConfig(seq_len=64, global_batch=4,
                                    vocab=cfg.vocab), 0, device)

    def run():
        state[0], state[1], m = step(state[0], state[1], batch)
        return m["loss"]

    us = per_call_us(run, 5, device)
    toks = 4 * 64
    return [("train_step_smoke", us, f"tokens_per_s={toks / us * 1e6:.0f}")]


def all_rows(device: Union[None, str, torch.device] = None) -> List[Row]:
    """Every row on ``device`` (None: the card, which raises without
    one)."""
    dev = resolve_device(device)
    return (attention_paths(dev) + wkv_paths(dev) + rmsnorm_paths(dev)
            + seed_row_paths(dev) + train_step_bench(dev))
