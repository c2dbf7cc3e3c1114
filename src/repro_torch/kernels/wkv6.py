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

Training goes through :class:`Wkv6Function`: its forward is one call of
:func:`wkv6` on a fresh copy of the initial state (the caller's tensors
are never written), its backward the plain formulas of
:func:`wkv6_backward` on either device.  The reference has no backward
kernel either: it differentiates its scan and its chunked form.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import LAUNCHES, counted

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# The reference's switch from its lax.scan to its chunked form
# (models/rwkv.py:158).
CHUNKED_T = 512
MAX_HEAD_DIM = 128
# The backward's chunk: the reference's chunked form runs chunks of 32
# tokens up to 8192 (models/rwkv.py:163).
BACKWARD_CHUNK = 32
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


def _chunked(t: torch.Tensor, C: int, fill: float = 0.0) -> torch.Tensor:
    """(B, T, H, dh) -> float32 (C, nc, B, H, dh): token c * C + i of
    batch row b at [i, c, b], T padded with ``fill`` to nc * C."""
    B, T, H, dh = t.shape
    nc = _cdiv(T, C)
    t = F.pad(t.float(), (0, 0, 0, 0, 0, nc * C - T), value=fill)
    return t.reshape(B, nc, C, H, dh).permute(2, 1, 0, 3, 4).contiguous()


def _unchunked(t: torch.Tensor, T: int) -> torch.Tensor:
    """The inverse of :func:`_chunked`, padding dropped."""
    C, nc, B, H, dh = t.shape
    return t.permute(2, 1, 0, 3, 4).reshape(B, nc * C, H, dh)[:, :T]


def wkv6_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, S0: torch.Tensor,
                  g_out: torch.Tensor, g_S: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, ...]:
    """Gradients ``(dr, dk, dv, dw, du, dS0)`` of the recurrence from the
    state ``S0`` (see :func:`wkv6`), given the output's gradient ``g_out``
    (B, T, H, dh) and the final state's ``g_S`` (None: zero), in float32
    (dr, dk, dv in r's dtype).  Plain PyTorch on either device.

    With S_t the state before token t and dS_{t+1} the gradient of the
    state after it, the sequential form's gradients are

        dS_t  = w_t ⊙ dS_{t+1} + r_t g_tᵀ          (rows scaled by w_t)
        dr_t  = S_t g_t + u ⊙ k_t (g_t·v_t)
        dk_t  = dS_{t+1} v_t + u ⊙ r_t (g_t·v_t)
        dv_t  = dS_{t+1}ᵀ k_t + (Σ r_t ⊙ u ⊙ k_t) g_t
        dw_t  = Σ_j dS_{t+1}[:, j] ⊙ S_t[:, j]
        du    = Σ_t r_t ⊙ k_t (g_t·v_t)

    computed in chunks of BACKWARD_CHUNK tokens: one pass over the chunks
    carries the state to each chunk's start, a second carries dS back to
    each chunk's end, each chunk's whole contribution a batched product;
    then the token recurrences run within every chunk at once, a chunk's
    length of steps over (chunks, B, H) batches of states.  Decays enter
    only as products of w over spans of a chunk (cumprod: each at most 1),
    never as a quotient or an exp(-cumsum), so decays near 0 stay finite.
    The within-chunk states of every token are held at once: B·T·H·dh²
    float32 values.
    """
    B, T, H, dh = r.shape
    C = min(BACKWARD_CHUNK, T)
    rc, kc, vc, gc = (_chunked(t, C) for t in (r, k, v, g_out))
    wc = _chunked(w, C, fill=1.0)             # padding: the state carries
    nc = wc.shape[1]
    N = nc * B * H
    uf = u.float()
    # Decay products within a chunk: before[i] = Π_{q<i} w_q, after[i] =
    # Π_{q>i} w_q, whole = Π_q w_q.
    incl = torch.cumprod(wc, dim=0)
    whole = incl[-1]
    ones = torch.ones_like(whole)[None]
    before = torch.cat([ones, incl[:-1]])
    after = torch.cat([torch.cumprod(wc.flip(0), dim=0).flip(0)[1:], ones])

    # Pass 1: the state at each chunk's start.
    Z = torch.einsum("cnbhi,cnbhj->nbhij", kc * after, vc)
    S = torch.empty((nc, B, H, dh, dh), dtype=torch.float32,
                    device=r.device)
    S[0] = S0
    for c in range(nc - 1):
        torch.addcmul(Z[c], whole[c, ..., None], S[c], out=S[c + 1])
    # Pass 2: the gradient of the state at each chunk's end.
    Y = torch.einsum("cnbhi,cnbhj->nbhij", rc * before, gc)
    G = torch.empty_like(S)
    if g_S is None:
        G[-1].zero_()
    else:
        G[-1] = g_S
    for c in range(nc - 1, 0, -1):
        torch.addcmul(Y[c], whole[c, ..., None], G[c], out=G[c - 1])
    del Z, Y

    # Within every chunk at once: states[i] = S before token i.
    rt, kt, vt, gt, wt = (t.reshape(C, N, dh) for t in (rc, kc, vc, gc, wc))
    states = torch.empty((C, N, dh, dh), dtype=torch.float32,
                         device=r.device)
    states[0] = S.reshape(N, dh, dh)
    for i in range(C - 1):
        torch.mul(states[i], wt[i, :, :, None], out=states[i + 1])
        states[i + 1].addcmul_(kt[i, :, :, None], vt[i, :, None, :])
    dr = torch.matmul(states, gt[..., None])[..., 0]
    dk, dv, dw = (torch.empty((C, N, dh), dtype=torch.float32,
                              device=r.device) for _ in range(3))
    dS = G.reshape(N, dh, dh).clone()         # the gradient after token i
    for i in range(C - 1, -1, -1):
        torch.bmm(dS, vt[i, :, :, None], out=dk[i, :, :, None])
        torch.bmm(dS.transpose(1, 2), kt[i, :, :, None],
                  out=dv[i, :, :, None])
        torch.bmm(dS.reshape(N * dh, 1, dh),
                  states[i].reshape(N * dh, dh, 1),
                  out=dw[i].reshape(N * dh, 1, 1))
        dS.mul_(wt[i, :, :, None]).addcmul_(rt[i, :, :, None],
                                            gt[i, :, None, :])
    del states
    dS0 = dS.reshape(nc, B, H, dh, dh)[0]
    dr, dk, dv, dw = (_unchunked(t.reshape(C, nc, B, H, dh), T)
                      for t in (dr, dk, dv, dw))
    # The bonus term, every token at once.
    rf, kf, vf, gf = (t.float() for t in (r, k, v, g_out))
    gv = (gf * vf).sum(-1, keepdim=True)
    dr = dr + uf * kf * gv
    dk = dk + uf * rf * gv
    dv = dv + (rf * uf * kf).sum(-1, keepdim=True) * gf
    du = (rf * kf * gv).sum((0, 1))
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du, dS0)


class Wkv6Function(torch.autograd.Function):
    """The recurrence with a gradient: ``Wkv6Function.apply(r, k, v, w,
    u, S0) -> (out, S)``, the arguments and ``out`` as :func:`wkv6`'s, S0
    (B, H, dh, dh) float32 read only and S the final state.  The forward
    is :func:`wkv6` on a copy of S0 (on CUDA one kernel launch); the
    backward :func:`wkv6_backward`, inside a profiler range of that name
    (a profile sums the device time of the kernels it launches).  From
    ``CHUNKED_T`` tokens on, bf16 inputs give an output rounded to bf16,
    and its gradient passes the rounding straight through, as the VJP of
    the reference's ``astype`` does."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, S0):
        S = S0.clone()
        out = wkv6(r, k, v, w, u, S)
        ctx.save_for_backward(r, k, v, w, u, S0)
        ctx.set_materialize_grads(False)
        return out, S

    @staticmethod
    def backward(ctx, g_out, g_S):
        r, k, v, w, u, S0 = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros(r.shape, dtype=torch.float32,
                                device=r.device)
        with torch.profiler.record_function("wkv6_backward"):
            grads = wkv6_backward(r, k, v, w, u, S0, g_out, g_S)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))
