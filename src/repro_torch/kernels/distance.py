"""Batched seed rows of squared distances: the CUDA kernel and its plain
PyTorch version.

The analyzer's clustering core only ever needs squared Euclidean
distances from a handful of *seed* points to all m points, never the full
m×m matrix:

    D²[s, q] = max(|W_s|² + |W_q|² − 2·W_s·W_q, 0)

:func:`multi_seed_rows` computes the rows of a whole batch of seeds in one
launch of the hand-written kernel ``csrc/distance.cu`` (the port of the
reference's Pallas kernel ``repro/kernels/distance.py::multi_seed_rows``;
the source states its bound and design).  On a CUDA tensor it launches the
kernel or raises; only tensors on the CPU take the plain version
:func:`multi_seed_rows_ref`.

Both compute each row independently of the other seeds in the batch, so a
row is bitwise the same whether its seed was fetched alone or with others
— the analyzer's row cache depends on that.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES


def multi_seed_rows_ref(points: torch.Tensor, sq: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one matrix-vector product per seed (the twin
    of the reference's exact numpy lane), so each row is independent of
    the batch.  Returns (k, m) in ``points``' dtype, clamped at zero."""
    k, m = int(idx.shape[0]), int(points.shape[0])
    out = torch.empty((k, m), dtype=points.dtype, device=points.device)
    for i, p in enumerate(idx.tolist()):
        out[i] = sq[p] + sq - 2.0 * (points @ points[p])
    return out.clamp_min_(0.0)


def rounding_scale(sq: torch.Tensor, idx: torch.Tensor,
                   n: int) -> torch.Tensor:
    """Per-element scale of the float32 rounding error of seed rows,
    sqrt(n)·2⁻²⁴·(|W_s|² + |W_q|²), as (k, m) float64.

    The Gram identity cancels: an element's error grows with the norms it
    cancels, not with the distance it returns, so a check bounds each
    element by a small multiple of its own scale (the kernel's fixed-order
    ``fmaf`` chain stays within about 1.3 of it at the fleet shape).
    """
    sq64 = sq.double()
    return (max(n, 1) ** 0.5 * 2.0 ** -24) * (
        sq64[idx.long(), None] + sq64[None, :])


def _check(points: torch.Tensor, sq: torch.Tensor, idx: torch.Tensor) -> None:
    if points.dim() != 2:
        raise ValueError(f"points must be (m, n), got {tuple(points.shape)}")
    m = points.shape[0]
    if sq.shape != (m,):
        raise ValueError(f"sq must be ({m},), got {tuple(sq.shape)}")
    if idx.dim() != 1:
        raise ValueError(f"idx must be (k,), got {tuple(idx.shape)}")
    if points.dtype != torch.float32 or sq.dtype != torch.float32:
        raise TypeError(f"points and sq must be float32, got "
                        f"{points.dtype} and {sq.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if not (points.device == sq.device == idx.device):
        raise ValueError(f"points, sq and idx on different devices: "
                         f"{points.device}, {sq.device}, {idx.device}")
    if not (points.is_contiguous() and sq.is_contiguous()
            and idx.is_contiguous()):
        raise ValueError("points, sq and idx must be contiguous")
    if max(points.shape[0], points.shape[1], idx.shape[0]) >= 2 ** 31:
        raise ValueError("m, n and k must each fit a 32-bit int")


def _kernel_fn():
    from .build import load_library
    lib = load_library("distance").lib
    fn = lib.distance_multi_seed_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def multi_seed_rows(points: torch.Tensor, sq: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """Squared-distance rows of ``points[idx]`` against all points.

    points : (m, n) float32, contiguous.
    sq     : (m,) float32 row squared norms of ``points``.
    idx    : (k,) int32 seed indices, each in [0, m).
    Returns (k, m) float32, clamped at zero.

    On CUDA the rows come from one launch of ``csrc/distance.cu`` on the
    current stream (a seed index outside [0, m) yields a row of NaN: the
    kernel cannot raise); on the CPU from :func:`multi_seed_rows_ref`.
    """
    _check(points, sq, idx)
    if points.device.type == "cpu":
        return multi_seed_rows_ref(points, sq, idx)
    if points.device.type != "cuda":
        raise ValueError(f"no kernel for device {points.device}")
    m, n = points.shape
    k = int(idx.shape[0])
    out = torch.empty((k, m), dtype=torch.float32, device=points.device)
    if k == 0 or m == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(points.data_ptr(), sq.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), m, n, k, stream)
    if status != 0:
        raise RuntimeError(f"distance kernel launch failed: CUDA error "
                           f"{status} (m={m}, n={n}, k={k})")
    LAUNCHES["multi_seed_rows"] += 1
    return out
