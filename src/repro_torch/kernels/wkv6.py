"""The WKV-6 recurrence of RWKV-6 (Finch): the CUDA kernel and its plain
PyTorch version.

Per batch row b and head h, with the (dh x dh) float32 state S:

    out_t = r_t · (S + (u ⊙ k_t) v_tᵀ)
    S     ← diag(w_t) S + k_t v_tᵀ

:func:`wkv6` launches the hand-written kernel ``csrc/wkv6.cu`` (the port
of the reference's Pallas kernel ``repro/kernels/rwkv6_scan.py::wkv6``;
the source states its bound and design) on CUDA tensors, or raises; only
tensors on the CPU take the plain version :func:`wkv6_ref`.

Beyond the Pallas kernel, which starts from S = 0, takes T in multiples
of its chunk and returns no state, the model path needs: an initial state
that is updated in place (the decode state carries it from call to call),
any T >= 1, r/k/v in float32 or bfloat16 as the projections give them,
and a float32 output, as the reference's ``models/rwkv.py`` scan branch
returns.  From ``CHUNKED_T`` tokens on the reference runs its chunked
form instead, which rounds the output to r's dtype (``rwkv.py:119``) and
then widens it again (``:166``); the wrapper does the same.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import LAUNCHES

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# The reference's switch from its lax.scan to its chunked form
# (models/rwkv.py:158).
CHUNKED_T = 512
MAX_HEAD_DIM = 128


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             S0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: a sequential loop over t in float32, in the
    order of operations of the reference's ``kernels/ref.py::wkv6_ref``,
    in the model's layout.

    r, k, v, w : (B, T, H, dh); u : (H, dh); S0 : (B, H, dh, dh) or None
    (zeros).  Returns (out (B, T, H, dh) float32, S (B, H, dh, dh)
    float32); S0 is not modified.
    """
    B, T, H, dh = r.shape
    S = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
         if S0 is None else S0.float().clone())
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    outs = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]       # (B,H,dh,dh)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], S + uf * kv))
        S = wf[:, t, :, :, None] * S + kv
    return torch.stack(outs, dim=1), S


def _check(r, k, v, w, u, S) -> None:
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, dh), got {tuple(r.shape)}")
    B, T, H, dh = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} must be {tuple(r.shape)}, got "
                             f"{tuple(t.shape)}")
    if u.shape != (H, dh):
        raise ValueError(f"u must be ({H}, {dh}), got {tuple(u.shape)}")
    if S.shape != (B, H, dh, dh):
        raise ValueError(f"S must be ({B}, {H}, {dh}, {dh}), got "
                         f"{tuple(S.shape)}")
    if T < 1 or B < 1 or H < 1 or dh < 1:
        raise ValueError(f"empty input {tuple(r.shape)}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} above {MAX_HEAD_DIM}")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k and v must all be float32 or all bfloat16, "
                        f"got {r.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("w", w), ("u", u), ("S", S)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    tensors = (r, k, v, w, u, S)
    if any(t.device != r.device for t in tensors):
        raise ValueError("r, k, v, w, u and S must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("r, k, v, w, u and S must be contiguous")
    if r.numel() >= 2 ** 31 or S.numel() >= 2 ** 31:
        raise ValueError("inputs must hold fewer than 2**31 elements")


def _kernel_fn(dtype: torch.dtype):
    from .build import load_library
    fn = getattr(load_library("wkv6").lib, f"wkv6_{DTYPES[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """The WKV-6 recurrence over T tokens from the state ``S``.

    r, k, v : (B, T, H, dh), float32 or bfloat16 (one dtype), contiguous,
              any T >= 1, dh <= 128.
    w       : (B, T, H, dh) float32, the decays in (0, 1).
    u       : (H, dh) float32, the bonus.
    S       : (B, H, dh, dh) float32, updated in place to the state after
              the last token.
    Returns out (B, T, H, dh) float32; from CHUNKED_T tokens on, its
    values are rounded to r's dtype, as the reference's chunked form does.

    On CUDA one launch of ``csrc/wkv6.cu`` on the current stream; on the
    CPU :func:`wkv6_ref`.
    """
    _check(r, k, v, w, u, S)
    B, T, H, dh = r.shape
    round_out = T >= CHUNKED_T and r.dtype != torch.float32
    if r.device.type == "cpu":
        out, S_new = wkv6_ref(r, k, v, w, u, S)
        S.copy_(S_new)
        return out.to(r.dtype).float() if round_out else out
    if r.device.type != "cuda":
        raise ValueError(f"no kernel for device {r.device}")
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    fn = _kernel_fn(r.dtype)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), S.data_ptr(), out.data_ptr(), B, T, H, dh,
                    int(round_out), stream)
    if status != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {status} "
                           f"(B={B}, T={T}, H={H}, dh={dh}, {r.dtype})")
    LAUNCHES["wkv6"] += 1
    return out
