"""RMSNorm with a Gemma-style ``(1 + w)`` scale: the CUDA kernel and its
plain PyTorch version.

    y = x · rsqrt(mean(x²) + eps) · (1 + w)

accumulated in float32 and rounded once to x's dtype, as the reference's
``models/layers.py::rms_norm`` does.  :func:`rmsnorm` launches the
hand-written kernels of ``csrc/rmsnorm.cu`` (the port of the reference's
Pallas kernel ``repro/kernels/rmsnorm.py::rmsnorm``; the source states its
bound and design) on a CUDA tensor, or raises; only tensors on the CPU
take the plain version :func:`rmsnorm_ref`.  :func:`rmsnorm_plan` picks
the kernel's path from the shapes and the pointers' alignment alone: a
block per row with 16-byte loads of x and w issued together, or a scalar
kernel for a d that is not a multiple of 16 bytes or an unaligned
pointer.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import LAUNCHES

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

# The plan's constants; MAX_THREADS and ITEMS are also the bounds that
# csrc/rmsnorm.cu's launch checks.
SMS = 132                 # streaming multiprocessors of an H100 SXM
VEC_BYTES = 16            # one load or store of a row-path thread
MAX_THREADS = 1024
ITEMS = (1, 2, 4)         # vectors of a row a thread may own
SCALAR_THREADS = 256
PATHS = {"scalar": 0, "row": 1}


class RmsnormPlan(NamedTuple):
    """How one call runs on the card, as the wrapper passes it to the
    kernel.

    path : "row" (a block per row, 16-byte vectors) or "scalar".
    threads : threads per block.
    items : 16-byte vectors of a row each thread owns, at vector indices
        thread + i * threads (0 on the scalar path, which strides).
    """
    path: str
    threads: int
    items: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def rmsnorm_plan(n: int, d: int, dtype: torch.dtype,
                 aligned: bool = True) -> RmsnormPlan:
    """The kernel path of one call, from its shapes and whether x, w and y
    are 16-byte aligned.

    A d that is a multiple of 16 bytes of elements, with aligned pointers,
    takes the row path: a block per row, each thread owning ``items``
    vectors, the fewest of ``ITEMS`` that keep a row within
    ``MAX_THREADS`` threads, and at least 2 above ``SMS`` rows, where
    more rows than SMs share the card (measured faster at 300 rows of
    3840, level at the 256-row prefill chunk); the block is d / 16 bytes
    / items threads, rounded up to a warp.
    Everything else, and rows longer than 4 * MAX_THREADS vectors, takes
    the scalar kernel.
    """
    nv = d * dtype.itemsize // VEC_BYTES
    if aligned and d * dtype.itemsize % VEC_BYTES == 0:
        for items in ITEMS:
            if _cdiv(nv, items) <= MAX_THREADS and (n <= SMS or items > 1):
                return RmsnormPlan("row", _cdiv(_cdiv(nv, items), 32) * 32,
                                   items)
    return RmsnormPlan("scalar", SCALAR_THREADS, 0)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain PyTorch version, in the reference's order of operations."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (N, d), got {tuple(x.shape)}")
    if w.shape != (x.shape[1],):
        raise ValueError(f"w must be ({x.shape[1]},), got {tuple(w.shape)}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be float32 or both bfloat16, "
                        f"got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x and w on different devices: {x.device}, "
                         f"{w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if max(x.shape) >= 2 ** 31:
        raise ValueError("N and d must each fit a 32-bit int")


def _kernel_fn(dtype: torch.dtype):
    from .build import load_library
    fn = getattr(load_library("rmsnorm").lib, f"rmsnorm_{DTYPES[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm of the rows of ``x``.

    x : (N, d) float32 or bfloat16, contiguous, any N.
    w : (d,) in x's dtype.
    Returns (N, d) in x's dtype.

    On CUDA one launch of ``csrc/rmsnorm.cu`` on the current stream, on
    the path :func:`rmsnorm_plan` picks; on the CPU :func:`rmsnorm_ref`.
    """
    _check(x, w)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    n, d = x.shape
    out = torch.empty_like(x)
    if n == 0 or d == 0:
        return out
    aligned = all(t.data_ptr() % VEC_BYTES == 0 for t in (x, w, out))
    _launch(x, w, out, eps, rmsnorm_plan(n, d, x.dtype, aligned))
    return out


def _launch(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, eps: float,
            plan: RmsnormPlan) -> None:
    """One launch of the kernel on ``plan``'s path into ``out``."""
    n, d = x.shape
    fn = _kernel_fn(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, d,
                    float(eps), PATHS[plan.path], plan.threads, plan.items,
                    stream)
    if status != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error "
                           f"{status} (N={n}, d={d}, {x.dtype}, {plan})")
    LAUNCHES["rmsnorm"] += 1
