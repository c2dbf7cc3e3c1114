"""Attention over explicitly positioned keys: the CUDA kernel and its plain
PyTorch version.

Both work in the model's layout — q (B, Q, H, dh), k/v (B, K, KV, dh) —
with head h reading kv head ``h // (H // KV)`` (no repeat of k and v), and
mask by explicit int32 positions ``q_pos`` (Q,) and ``k_pos`` (K,): causal
masks ``k_pos > q_pos``, a window masks ``k_pos <= q_pos - window``.
Masked scores are -1e30, so a fully masked row averages v uniformly, as
the reference's ``models/layers.py::naive_attention`` does.  An optional
logit softcap applies ``cap · tanh(s / cap)`` before the mask.

:func:`flash_attention` launches the hand-written kernels of
``csrc/flash_attention.cu`` (the port of the reference's Pallas kernel
``repro/kernels/flash_attention.py::flash_attention``; the source states
its bound and design) on CUDA tensors, or raises; only tensors on the CPU
take the plain version :func:`flash_attention_ref`, which materialises the
scores.  :func:`attention_plan` picks the kernel's path from the shapes
alone (no value of the positions is read on the host): split-K decode
(flash-decoding, a split kernel and a merge kernel) for at most
``DECODE_ROWS`` query rows per kv head, bf16 warpgroup tensor-core tiles
(``wgmma``) above that, and register-tiled CUDA-core tiles (``simt``: 64
packed query rows of a kv head a block, skipping key tiles by position as
``wgmma`` does) for float32 above it and the bf16 calls ``wgmma``
refuses.
All keep the softmax probabilities in float32 or, on the tensor cores, as
bf16 hi + lo parts; the reference's ``naive_attention`` rounds them to v's
dtype before P·V, so in bfloat16 the two differ by that rounding.

:class:`FlashAttentionFunction` is the differentiable call the model
uses: its forward is :func:`flash_attention` (the kernel on the card), its
backward the plain PyTorch formulas of :func:`flash_attention_backward` on
both devices (the reference has no backward kernel: its training
differentiates the jnp ``naive_attention`` / ``chunked_attention``).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import LAUNCHES, counted

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
DH_MAX = 256
NEG_INF = -1e30

# The plan's constants; DECODE_ROWS and MAX_SPLITS are also the bounds
# that csrc/flash_attention.cu's split launch checks.
SMS = 132                 # streaming multiprocessors of an H100 SXM
TARGET_BLOCKS = 2 * SMS   # split-K decode aims at two blocks per SM
DECODE_ROWS = 8           # query rows (Q * H / KV) the split path takes
MIN_SPLIT = 32            # keys per split, at least
SPLIT_ALIGN = 16          # a split's keys, a multiple of this
MAX_SPLITS = 256          # the merge kernel's bound
PATHS = {"simt": 0, "split": 1, "wgmma": 2}


class AttentionPlan(NamedTuple):
    """How one call runs on the card: what the wrapper passes to the
    kernel and allocates for it (the tiles inside each path are the CUDA
    source's).

    path : "split" (split-K decode and merge), "wgmma" (bf16 warpgroup
        tensor-core tiles) or "simt" (the CUDA-core kernel).
    split, n_splits : keys per split and the number of splits ("split").
    workspace : float32 elements of the partials' workspace (0 unless
        "split").
    """
    path: str
    split: int = 0
    n_splits: int = 0
    workspace: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def attention_plan(B: int, Q: int, H: int, KV: int, dh: int, K: int,
                   dtype: torch.dtype, aligned: bool = True) -> AttentionPlan:
    """The kernel path and splits of one call, from its shapes (and
    whether q, k, v, out and k_pos are 16-byte aligned) alone.

    At most ``DECODE_ROWS`` query rows per kv head (rows = Q * H / KV: the
    served decode call) take split-K decode: the keys are cut into
    ``n_splits`` splits of ``split`` keys (a multiple of ``SPLIT_ALIGN``, at
    least ``MIN_SPLIT``), so that ``B * KV * n_splits`` blocks reach
    ``TARGET_BLOCKS`` where K allows, and no split is empty.  More rows in
    bf16 with dh a multiple of 8 and aligned pointers take the tensor-core
    tiles; the rest the CUDA-core kernel.
    """
    rows = Q * (H // KV)
    if rows <= DECODE_ROWS:
        want = _cdiv(TARGET_BLOCKS, B * KV)
        split = max(MIN_SPLIT, _cdiv(K, want), _cdiv(K, MAX_SPLITS))
        split = _cdiv(split, SPLIT_ALIGN) * SPLIT_ALIGN
        n_splits = _cdiv(K, split)
        return AttentionPlan(
            "split", split=split, n_splits=n_splits,
            workspace=B * KV * n_splits * rows * (dh + 2))
    if dtype == torch.bfloat16 and dh % 8 == 0 and aligned:
        return AttentionPlan("wgmma")
    return AttentionPlan("simt")


def live_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
              window: Optional[int]) -> torch.Tensor:
    """(Q, K) bool: the (query, key) pairs the mask keeps."""
    qp, kp = q_pos[:, None], k_pos[None, :]
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version: float32 scores materialised per kv group."""
    B, Q, H, dh = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, Q, KV, H // KV, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(dh)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(live_mask(q_pos, k_pos, causal, window), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Q, H, dh).to(q.dtype)


def _check(q, k, v, q_pos, k_pos, window, softcap) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, Q, H, dh) and k, v (B, K, KV, dh); "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    B, Q, H, dh = q.shape
    K, KV = k.shape[1], k.shape[2]
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"k and v must be ({B}, K, KV, {dh}); got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} heads do not group over {KV} kv heads")
    if not 1 <= dh <= DH_MAX:
        raise ValueError(f"head dim {dh} outside [1, {DH_MAX}]")
    if q_pos.shape != (Q,) or k_pos.shape != (K,):
        raise ValueError(f"q_pos must be ({Q},) and k_pos ({K},); got "
                         f"{tuple(q_pos.shape)} and {tuple(k_pos.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one of float32, bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise TypeError(f"positions must be int32, got {q_pos.dtype} and "
                        f"{k_pos.dtype}")
    if len({t.device for t in (q, k, v, q_pos, k_pos)}) != 1:
        raise ValueError("q, k, v and the positions must share a device")
    if not all(t.is_contiguous() for t in (q, k, v, q_pos, k_pos)):
        raise ValueError("q, k, v and the positions must be contiguous")
    if B * H >= 2 ** 16 or max(Q, K) >= 2 ** 31:
        raise ValueError(f"B*H = {B * H} must be below 65536, Q and K "
                         f"below 2**31")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")


def _kernel_fn(dtype: torch.dtype):
    from .build import load_library
    lib = load_library("flash_attention").lib
    fn = getattr(lib, f"flash_attention_{DTYPES[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def needed_keys(live: torch.Tensor) -> int:
    """Keys whose k and v the function must read, from the (Q, K) mask of
    live pairs: those live for some query, or all K when a query has no
    live key (it averages v over every key)."""
    if not bool(live.any(dim=1).all()):
        return live.shape[1]
    return int(live.any(dim=0).sum())


def attention_work(B: int, Q: int, H: int, KV: int, dh: int, K: int,
                   itemsize: int, live_pairs: int, keys: int
                   ) -> Tuple[float, float]:
    """``(flops, bytes)`` of one call: q, the k and v of the ``keys`` the
    function needs and the positions read once, the output written once;
    4·dh operations (score and P·V) for every one of the ``live_pairs``
    unmasked (query, key) pairs of every head."""
    nbytes = itemsize * B * (2 * Q * H * dh + 2 * keys * KV * dh) \
        + 4 * (Q + K)
    return 4.0 * dh * H * B * live_pairs, float(nbytes)


def _work(q, k, v, q_pos, k_pos, *, causal=True, window=None, softcap=None
          ) -> Tuple[float, float]:
    """The work of one call.  Positions on ``meta`` have no values: the
    count then takes the queries as the last Q of K consecutive positions
    (a training or prefill call, or a decode call over a full cache)."""
    B, Q, H, dh = q.shape
    K = k.shape[1]
    if q_pos.device.type == "meta" or k_pos.device.type == "meta":
        pairs, keys = consecutive_live(Q, K, causal, window)
    else:
        live = live_mask(q_pos, k_pos, causal, window)
        pairs, keys = int(live.sum()), needed_keys(live)
    return attention_work(B, Q, H, k.shape[2], dh, K, q.element_size(),
                          pairs, keys)


def consecutive_live(Q: int, K: int, causal: bool, window: Optional[int]
                     ) -> Tuple[int, int]:
    """(live pairs, needed keys) of :func:`live_mask` for keys at 0..K-1
    and queries at the last Q of them (K-Q..K-1), without the (Q, K)
    mask: each query's live keys are one interval."""
    p = torch.arange(K - Q, K, dtype=torch.int64)
    lo = (p - window + 1).clamp(min=0) if window is not None \
        else torch.zeros_like(p)
    hi = p if causal else torch.full_like(p, K - 1)
    n = (hi - lo + 1).clamp(min=0)
    if not bool((n > 0).all()):
        return int(n.sum()), K
    return int(n.sum()), int(hi.max() - lo.min() + 1)


def unfused_attention_work(B: int, Q: int, H: int, KV: int, dh: int,
                           K: int, itemsize: int) -> Tuple[float, float]:
    """``(flops, bytes)`` of the attention computed unfused, as XLA
    compiles the reference's jnp attention: every (query, key) pair of
    every head scored and weighted, masked pairs too (4·dh FLOPs), six
    FLOPs a score for the scale, the mask and the softmax, and the
    float32 scores materialised between the two products, written four
    times (the product, the masked scores, the exponentials, the
    probabilities) and read six (by the mask, the max, the exponentials,
    the sum, the division and the second product); q, k and v read and
    the output written once."""
    pairs = B * H * Q * K
    nbytes = itemsize * B * (2 * Q * H * dh + 2 * K * KV * dh) \
        + 10 * 4 * pairs
    return 4.0 * dh * pairs + 6.0 * pairs, float(nbytes)


def _unfused_work(q, k, v, q_pos, k_pos, **_) -> Tuple[float, float]:
    B, Q, H, dh = q.shape
    return unfused_attention_work(B, Q, H, k.shape[2], dh, k.shape[1],
                                  q.element_size())


@counted(_work, unfused=_unfused_work)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Attention of q over k/v, masked by positions, scores scaled by
    1/sqrt(dh).

    q : (B, Q, H, dh); k, v : (B, K, KV, dh), H a multiple of KV,
        dh <= 256; all float32 or all bfloat16, contiguous.
    q_pos : (Q,) int32; k_pos : (K,) int32.
    Returns (B, Q, H, dh) in q's dtype.

    On CUDA one call of ``csrc/flash_attention.cu`` on the current stream,
    on the path :func:`attention_plan` picks (the split path launches its
    split kernel and its merge kernel, and allocates the partials'
    workspace); on the CPU :func:`flash_attention_ref`; on ``meta`` an
    output of the right shape (its work still counted).
    """
    _check(q, k, v, q_pos, k_pos, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_pos, k_pos, causal=causal,
                                   window=window, softcap=softcap)
    if q.device.type == "meta":     # shapes only, for a count (dry-run)
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, Q, H, dh = q.shape
    K, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B == 0 or Q == 0 or K == 0:
        return out
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v, k_pos, out))
    plan = attention_plan(B, Q, H, KV, dh, K, q.dtype, aligned)
    ws = (torch.empty(plan.workspace, dtype=torch.float32, device=q.device)
          if plan.workspace else None)
    fn = _kernel_fn(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    q_pos.data_ptr(), k_pos.data_ptr(), out.data_ptr(),
                    None if ws is None else ws.data_ptr(),
                    B, Q, H, K, KV, dh, int(causal),
                    0 if window is None else int(window),
                    0.0 if softcap is None else float(softcap),
                    1.0 / math.sqrt(dh), PATHS[plan.path], plan.split,
                    stream)
    if status != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {status} "
            f"(B={B}, Q={Q}, H={H}, K={K}, KV={KV}, dh={dh}, {q.dtype}, "
            f"{plan})")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, q_pos: torch.Tensor,
                             k_pos: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True,
                             window: Optional[int] = None,
                             softcap: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The gradients (dq, dk, dv) of :func:`flash_attention` for the
    output gradient ``do``, in float32 from q, k, v, the positions and the
    forward's output ``o``: the scores are recomputed per kv group with
    the forward's scale, softcap and mask (-1e30 fill), P = softmax, then

        dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P ⊙ (dP − rowsum(dO ⊙ O)),

    dS zeroed where masked (the fill is a constant), times the softcap's
    1 − tanh², and dQ = dS·K/√dh, dK = dSᵀ·Q/√dh.  dK and dV sum a kv
    group's query heads.  The (B, KV, g, Q, K) float32 tensors live only
    inside this call.  Returns each gradient in its input's dtype."""
    B, Q, H, dh = q.shape
    KV = k.shape[2]
    scale = 1.0 / math.sqrt(dh)
    qg = q.float().reshape(B, Q, KV, H // KV, dh)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) / math.sqrt(dh)
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    live = live_mask(q_pos, k_pos, causal, window)
    p = torch.softmax(torch.where(live, s, NEG_INF), dim=-1)
    del s
    dog = do.float().reshape(qg.shape)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vf)
    rows = (dog * o.float().reshape(qg.shape)).sum(dim=-1)   # (B, Q, KV, g)
    ds = p * (dp - rows.permute(0, 2, 3, 1)[..., None])
    del p, dp
    ds = torch.where(live, ds, 0.0)
    if softcap is not None:
        ds = ds * (1.0 - t * t)
    ds = ds * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(B, Q, H, dh)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFunction(torch.autograd.Function):
    """:func:`flash_attention` with a gradient for q, k and v:
    ``FlashAttentionFunction.apply(q, k, v, q_pos, k_pos, causal, window,
    softcap)``.  Saves the inputs and the output only: no (Q, K) tensor
    outlives the forward."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal: bool,
                window: Optional[int], softcap: Optional[float]):
        o = flash_attention(q, k, v, q_pos, k_pos, causal=causal,
                            window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, o)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, k_pos, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, q_pos, k_pos, o, do,
                                              **ctx.opts)
        return dq, dk, dv, None, None, None, None, None
