"""Batched seed rows of squared distances: the CUDA kernel and its plain
PyTorch version.

The analyzer's clustering core only ever needs squared Euclidean
distances from a handful of *seed* points to all m points, never the full
m×m matrix:

    D²[s, q] = max(|W_s|² + |W_q|² − 2·W_s·W_q, 0)

:func:`multi_seed_rows` computes the rows of a whole batch of seeds in one
launch of the hand-written kernels of ``csrc/distance.cu`` (the port of
the reference's Pallas kernel ``repro/kernels/distance.py::multi_seed_rows``;
the source states its bound and design) on the path
:func:`seed_rows_plan` picks.  On a CUDA tensor it launches the kernel or
raises; only tensors on the CPU take the plain version
:func:`multi_seed_rows_ref`.

Both compute each row independently of the other seeds in the batch, so a
row is bitwise the same whether its seed was fetched alone or with others
— the analyzer's row caches depend on that.  On the card every path of
the plan sums an element in one order, fixed by (n, aligned) alone:
``LANES`` partial ``fmaf`` chains over interleaved column sets, merged by
one shuffle tree.

The kernel lane decides the analyzer's candidacies from these float32
rows; :func:`row_error_coef` bounds their error against the exact float64
lane, and ``core/clustering.py`` re-decides in float64 every decision the
bound cannot settle.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Tuple

import torch

from . import LAUNCHES, counted

# Launches of the seed-row kernel by seed count k (one per launch, beside
# LAUNCHES["multi_seed_rows"]; reset_launches() clears it): the k the
# analyzer's main paths fetch at.
SEED_COUNTS: Dict[int, int] = {}

# The plan's constants, as csrc/distance.cu's launch checks them.
LANES = 8                 # lanes summing one point's dot product
CHUNK = 128               # columns a lane group holds in registers at once
TILE_POINTS = 64          # points of one tile-path block (4 a lane group)
SEED_GROUP = 8            # seeds the tile path's shuffle tree merges at once
MAX_TILE_SEEDS = 64       # seeds of one tile-path block
TILE_BLOCKS = 4           # seed tiles a point range is cut into, at most
TILE_SMEM_BYTES = 48 * 1024   # staged seed rows, norms and flags a block
MAX_GRID_Y = 65535
PATHS = {"row": 0, "tile": 1}

# -- error of the float32 rows -----------------------------------------------
#
# Per-element tolerances of a float32 seed row, in units of its own
# rounding scale (rounding_scale): either float32 path, the CUDA kernel
# (chip_smoke.py phase 3, the gpu tests) or the plain version on the CPU
# (tests/test_torch_distance.py), against a float64 evaluation of the same
# float32 inputs; and the kernel against the plain version, which counts
# the plain version's own error as one scale more.
C_F64 = 3.0
C_PLAIN = 4.0
# The kernel lane's decisions bound a base row's error by ROW_ERR_C scales:
# the larger of the two tolerances, so it covers a row from either path
# with a scale to spare.  A kernel whose error grew past C_F64 fails
# phase 3 and the card tests before it can mis-decide.
ROW_ERR_C = C_PLAIN
U32 = 2.0 ** -24          # float32 unit roundoff
# The rows are computed from float32 copies of the float64 matrix and
# norms, while the exact lane reads the float64 ones: |sq32 - sq| <=
# u·sq and |W32_s·W32_q - W_s·W_q| <= (2u + u²)·(|W_s|² + |W_q|²)/2, so
# the inputs move an element by at most (3u + u²)·(|W_s|² + |W_q|²); the
# float64 lane's own rounding adds under u/2 of it for n < 2^28.  Four
# units of u cover both.
INPUT_ERR = 4.0


def row_error_coef(n: int) -> float:
    """e such that a float32 base row element differs from the exact
    lane's float64 one by at most e·(|W_s|² + |W_q|²): ROW_ERR_C rounding
    scales plus the inputs' float32 rounding (INPUT_ERR)."""
    return (ROW_ERR_C * math.sqrt(max(n, 1)) + INPUT_ERR) * U32


def rounding_scale(sq: torch.Tensor, idx: torch.Tensor,
                   n: int) -> torch.Tensor:
    """Per-element scale of the float32 rounding error of seed rows,
    sqrt(n)·2⁻²⁴·(|W_s|² + |W_q|²), as (k, m) float64.

    The Gram identity cancels: an element's error grows with the norms it
    cancels, not with the distance it returns, so a check bounds each
    element by a small multiple of its own scale (the kernel's fixed-order
    ``fmaf`` chains stay within about 1.3 of it at the fleet shape).
    """
    sq64 = sq.double()
    return (max(n, 1) ** 0.5 * U32) * (sq64[idx.long(), None]
                                       + sq64[None, :])


# -- the plan ----------------------------------------------------------------

class SeedRowsPlan(NamedTuple):
    """How one call runs on the card, as the wrapper passes it to the
    kernel.

    path : "row" (a block of 32 points per seed; every k = 1 call) or
        "tile" (k > 1: a block of 64 points and a tile of seeds, the seed
        rows staged in shared memory, each lane group's slice of 4 points
        kept in registers across them).
    vec : floats per load, 4 (16-byte loads of column quads: n a multiple
        of 4 and the matrix 16-byte aligned) or 1 (single columns).
    lanes : lanes per point; lane l's partial sum runs over column quads
        (vec 4) or columns (vec 1) l, l + lanes, l + 2·lanes, ... in
        ascending order, and the lanes' partials are merged by one fixed
        tree.  ``vec`` and ``lanes`` fix each element's arithmetic, and
        depend on (n, aligned) alone.
    tile_seeds : seeds of one tile-path block (0 on the row path).
    """
    path: str
    vec: int
    lanes: int
    tile_seeds: int


def seed_rows_plan(m: int, n: int, k: int,
                   aligned: bool = True) -> SeedRowsPlan:
    """The kernel path of one call, from its shapes and whether the point
    matrix is 16-byte aligned.

    k = 1 takes the row path.  k > 1 takes the tile path: k / TILE_BLOCKS
    seeds a block, rounded up to a multiple of ``SEED_GROUP``, at most
    ``MAX_TILE_SEEDS`` and as many as ``TILE_SMEM_BYTES`` hold at this n,
    so that a point range spreads over up to TILE_BLOCKS blocks.  An n too
    wide for ``SEED_GROUP`` staged rows (or more tiles than a grid holds)
    takes the row path, a block per (point range, seed).  ``m`` does not
    change the plan: ragged point ranges are masked in the kernel.
    """
    del m
    vec = 4 if aligned and n % 4 == 0 else 1
    fit = TILE_SMEM_BYTES // (4 * max(n, 1) + 8) // SEED_GROUP * SEED_GROUP
    want = -(-k // (TILE_BLOCKS * SEED_GROUP)) * SEED_GROUP
    tile = min(want, MAX_TILE_SEEDS, fit)
    if k <= 1 or tile < SEED_GROUP or -(-k // tile) > MAX_GRID_Y:
        return SeedRowsPlan("row", vec, LANES, 0)
    return SeedRowsPlan("tile", vec, LANES, tile)


# -- the plain version and the wrapper ---------------------------------------

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
    fn = load_library("distance").lib.distance_seed_rows
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def seed_rows_work(m: int, n: int, k: int) -> Tuple[float, float]:
    """``(flops, bytes)`` of one call: points, sq and idx read once, the
    (k, m) rows written once; 2n operations per output element for the
    dot product and 3 for the epilogue."""
    return float(k * m * (2 * n + 3)), float(4 * (m * n + m + k + k * m))


def _work(points, sq, idx) -> Tuple[float, float]:
    return seed_rows_work(points.shape[0], points.shape[1], idx.shape[0])


@counted(_work)
def multi_seed_rows(points: torch.Tensor, sq: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """Squared-distance rows of ``points[idx]`` against all points.

    points : (m, n) float32, contiguous.
    sq     : (m,) float32 row squared norms of ``points``.
    idx    : (k,) int32 seed indices, each in [0, m).
    Returns (k, m) float32, clamped at zero.

    On CUDA the rows come from one launch of ``csrc/distance.cu`` on the
    current stream, on the path :func:`seed_rows_plan` picks (a seed index
    outside [0, m) yields a row of NaN: the kernel cannot raise); on the
    CPU from :func:`multi_seed_rows_ref`; on ``meta`` an output of the
    right shape.  DTensor points are used whole on every rank
    (:func:`repro_torch.kernels.local.replicated`): the seed indices are
    global rows.
    """
    from .local import is_dtensor, replicated
    if is_dtensor(points):  # seed indices are global: the whole points
        return replicated(multi_seed_rows.__wrapped__, points, sq, idx)
    _check(points, sq, idx)
    if points.device.type == "cpu":
        return multi_seed_rows_ref(points, sq, idx)
    if points.device.type == "meta":    # shapes only, for a count
        return torch.empty((idx.shape[0], points.shape[0]),
                           dtype=points.dtype, device="meta")
    if points.device.type != "cuda":
        raise ValueError(f"no kernel for device {points.device}")
    m, n = points.shape
    k = int(idx.shape[0])
    out = torch.empty((k, m), dtype=torch.float32, device=points.device)
    if k == 0 or m == 0:
        return out
    aligned = points.data_ptr() % 16 == 0
    _launch(points, sq, idx, out, seed_rows_plan(m, n, k, aligned))
    return out


def _launch(points: torch.Tensor, sq: torch.Tensor, idx: torch.Tensor,
            out: torch.Tensor, plan: SeedRowsPlan) -> None:
    """One launch of the kernel on ``plan``'s path into ``out``."""
    m, n = points.shape
    k = int(idx.shape[0])
    fn = _kernel_fn()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(points.data_ptr(), sq.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), m, n, k, PATHS[plan.path], plan.vec,
                    plan.tile_seeds, stream)
    if status != 0:
        raise RuntimeError(f"distance kernel launch failed: CUDA error "
                           f"{status} (m={m}, n={n}, k={k}, {plan})")
    LAUNCHES["multi_seed_rows"] += 1
    SEED_COUNTS[k] = SEED_COUNTS.get(k, 0) + 1
