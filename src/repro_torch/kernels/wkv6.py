"""The WKV-6 recurrence of RWKV-6 (Finch): the CUDA kernel and its plain
PyTorch version.

Per batch row b and head h, with the (dh x dh) float32 state S:

    out_t = r_t · (S + (u ⊙ k_t) v_tᵀ)
    S     ← diag(w_t) S + k_t v_tᵀ

:func:`wkv6` launches the hand-written kernels of ``csrc/wkv6.cu`` (the
port of the reference's Pallas kernel ``repro/kernels/rwkv6_scan.py::wkv6``;
the source states its bound and design) on CUDA tensors, or raises; only
tensors on the CPU take the plain version :func:`wkv6_ref`.
:func:`wkv6_plan` picks the kernel from the shapes alone: at T = 1 (every
call of the served path) the decode kernel, which spreads the state over
(head, column tile) blocks and reads it in 16-byte words; above that the
sequential kernel, one block per head looping over the tokens.

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
from typing import NamedTuple, Optional, Tuple

import torch

from . import LAUNCHES, counted

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# The reference's switch from its lax.scan to its chunked form
# (models/rwkv.py:158).
CHUNKED_T = 512
MAX_HEAD_DIM = 128
# The decode kernel's partition (csrc/wkv6.cu): a block owns COL_TILE
# columns of one head's S, a thread ROWS_PER_THREAD rows of them.
COL_TILE = 16
ROWS_PER_THREAD = 4
PATHS = {"sequential": 0, "decode": 1}


class Wkv6Plan(NamedTuple):
    """How one call runs on the card, as the wrapper passes it to the
    kernel.

    path : "decode" (T = 1) or "sequential".
    vec : columns of S per decode thread: 4 (one float4) or 1 (the scalar
        column path); 0 for "sequential".
    tiles : column tiles per head, the decode grid's second axis (the
        sequential kernel runs one block per head: 1).
    threads : threads per block.
    """
    path: str
    vec: int
    tiles: int
    threads: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wkv6_plan(B: int, T: int, H: int, dh: int, dtype: torch.dtype,
              aligned: bool = True) -> Wkv6Plan:
    """The kernel of one call, from its shapes (and whether S is 16-byte
    aligned).

    T = 1 takes the decode kernel over B * H * ``tiles`` blocks of
    ``COL_TILE`` columns: (dh / ROWS_PER_THREAD) row slices times
    COL_TILE / vec column groups of threads, rounded up to whole warps,
    vec = 4 where dh is a multiple of 4 and S aligned, else 1.  Longer
    calls take the sequential kernel, one block per head of the smallest
    of 32, 64 and 128 threads that covers dh.  ``B``, ``H`` and ``dtype``
    do not change the choice.
    """
    if T == 1:
        vec = 4 if dh % 4 == 0 and aligned else 1
        slices = _cdiv(dh, ROWS_PER_THREAD)
        return Wkv6Plan("decode", vec, _cdiv(dh, COL_TILE),
                        _cdiv(COL_TILE // vec * slices, 32) * 32)
    threads = next(n for n in (32, 64, 128) if n >= dh)
    return Wkv6Plan("sequential", 0, 1, threads)


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
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def wkv6_work(B: int, T: int, H: int, dh: int, itemsize: int
              ) -> Tuple[float, float]:
    """``(flops, bytes)`` of one call: r, k, v (``itemsize``), w (float32)
    and u read once, the float32 state read and written once, the float32
    output written once; 5·dh² float32 operations per (token, head): r·S
    (2·dh²) and the state update w_i·S_ij + k_i·v_j (3·dh²); the bonus
    term is O(dh)."""
    n = B * T * H * dh
    nbytes = 3 * itemsize * n + 4 * n + 4 * H * dh + 8 * B * H * dh * dh \
        + 4 * n
    return 5.0 * B * H * T * dh * dh, float(nbytes)


def _work(r, k, v, w, u, S) -> Tuple[float, float]:
    return wkv6_work(*r.shape, r.element_size())


@counted(_work)
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

    On CUDA one launch of ``csrc/wkv6.cu`` on the current stream, of the
    kernel :func:`wkv6_plan` picks; on the CPU :func:`wkv6_ref`.
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
    plan = wkv6_plan(B, T, H, dh, r.dtype, S.data_ptr() % 16 == 0)
    _launch(r, k, v, w, u, S, out, round_out, plan)
    return out


def _launch(r, k, v, w, u, S, out, round_out: bool, plan: Wkv6Plan) -> None:
    """One launch of ``plan``'s kernel, updating ``S`` and writing
    ``out``."""
    B, T, H, dh = r.shape
    fn = _kernel_fn(r.dtype)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), S.data_ptr(), out.data_ptr(), B, T, H, dh,
                    int(round_out), PATHS[plan.path], plan.vec, plan.tiles,
                    plan.threads, stream)
    if status != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {status} "
                           f"(B={B}, T={T}, H={H}, dh={dh}, {r.dtype}, "
                           f"{plan})")
    LAUNCHES["wkv6"] += 1
