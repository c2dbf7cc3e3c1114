"""RMSNorm with a Gemma-style ``(1 + w)`` scale: the CUDA kernel and its
plain PyTorch version.

    y = x · rsqrt(mean(x²) + eps) · (1 + w)

accumulated in float32 and rounded once to x's dtype, as the reference's
``models/layers.py::rms_norm`` does.  :func:`rmsnorm` launches the
hand-written kernel ``csrc/rmsnorm.cu`` (the port of the reference's
Pallas kernel ``repro/kernels/rmsnorm.py::rmsnorm``; the source states its
bound and design) on a CUDA tensor, or raises; only tensors on the CPU
take the plain version :func:`rmsnorm_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


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
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm of the rows of ``x``.

    x : (N, d) float32 or bfloat16, contiguous, any N.
    w : (d,) in x's dtype.
    Returns (N, d) in x's dtype.

    On CUDA one launch of ``csrc/rmsnorm.cu`` on the current stream; on
    the CPU :func:`rmsnorm_ref`.
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
    fn = _kernel_fn(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, d,
                    float(eps), stream)
    if status != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error "
                           f"{status} (N={n}, d={d}, {x.dtype})")
    LAUNCHES["rmsnorm"] += 1
    return out
