"""Attention over explicitly positioned keys: the CUDA kernel and its plain
PyTorch version.

Both work in the model's layout — q (B, Q, H, dh), k/v (B, K, KV, dh) —
with head h reading kv head ``h // (H // KV)`` (no repeat of k and v), and
mask by explicit int32 positions ``q_pos`` (Q,) and ``k_pos`` (K,): causal
masks ``k_pos > q_pos``, a window masks ``k_pos <= q_pos - window``.
Masked scores are -1e30, so a fully masked row averages v uniformly, as
the reference's ``models/layers.py::naive_attention`` does.  An optional
logit softcap applies ``cap · tanh(s / cap)`` before the mask.

:func:`flash_attention` launches the hand-written online-softmax kernel
``csrc/flash_attention.cu`` (the port of the reference's Pallas kernel
``repro/kernels/flash_attention.py::flash_attention``; the source states
its bound and design) on CUDA tensors, or raises; only tensors on the CPU
take the plain version :func:`flash_attention_ref`, which materialises the
scores.  Both keep the softmax probabilities in float32; the reference's
``naive_attention`` rounds them to v's dtype before P·V, so in bfloat16
the two differ by that rounding.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import LAUNCHES

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
DH_MAX = 256
NEG_INF = -1e30


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
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    mask = torch.ones((Q, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    s = torch.where(mask, s, NEG_INF)
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
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


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

    On CUDA one launch of ``csrc/flash_attention.cu`` on the current
    stream; on the CPU :func:`flash_attention_ref`.
    """
    _check(q, k, v, q_pos, k_pos, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_pos, k_pos, causal=causal,
                                   window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, Q, H, dh = q.shape
    K, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B == 0 or Q == 0 or K == 0:
        return out
    fn = _kernel_fn(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    q_pos.data_ptr(), k_pos.data_ptr(), out.data_ptr(),
                    B, Q, H, K, KV, dh, int(causal),
                    0 if window is None else int(window),
                    0.0 if softcap is None else float(softcap),
                    1.0 / math.sqrt(dh), stream)
    if status != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {status} "
            f"(B={B}, Q={Q}, H={H}, K={K}, KV={KV}, dh={dh}, {q.dtype})")
    LAUNCHES["flash_attention"] += 1
    return out
