"""The seed-row kernel's plan and the arithmetic of its CUDA partition, on
the CPU.

``seed_rows_plan`` picks the kernel path from the shapes (and the matrix's
alignment) alone: the row path for k = 1 (every launch of the analyzer's
main paths), the tile path above.  What fixes each element's arithmetic
(``vec``, ``lanes``) depends only on (n, aligned), never on k, so a row is
bit for bit the same whether its seed came alone or in a batch.  The CUDA
kernel cannot run here, so its partition is mirrored in plain PyTorch (in
this file only): lane l of a point's 8 lanes sums the column quads (vec 4)
or columns (vec 1) l, l + 8, ... in ascending order, and the 8 partials
are merged by the tree that pairs lanes differing in bit 2, then bit 1,
then bit 0.  The mirror counts how often each column is summed (exactly
once) and is held within the kernel checks' tolerances of a float64
evaluation (C_F64 rounding scales) and of the plain version (C_PLAIN).
"""
import importlib

import numpy as np
import pytest
pytest.importorskip("torch")
import torch

D = importlib.import_module("repro_torch.kernels.distance")

KS = (1, 2, 3, 8, 17, 64, 256, 1000)


# -- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 3, 4, 6, 37, 128, 130, 300, 5000])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_arithmetic_never_depends_on_k(n, aligned):
    first = D.seed_rows_plan(16384, n, 1, aligned)
    for k in KS:
        plan = D.seed_rows_plan(16384, n, k, aligned)
        assert (plan.vec, plan.lanes) == (first.vec, first.lanes)
        assert plan.lanes == D.LANES
    assert first.vec == (4 if aligned and n % 4 == 0 else 1)


@pytest.mark.parametrize("m", [1, 40, 16384])
def test_plan_main_path_takes_the_row_path(m):
    assert D.seed_rows_plan(m, 128, 1) == D.SeedRowsPlan("row", 4, 8, 0)


@pytest.mark.parametrize("k,tile", [(2, 8), (8, 8), (9, 8), (33, 16),
                                    (64, 16), (256, 64), (1000, 64)])
def test_plan_batches_stage_seed_tiles(k, tile):
    assert D.seed_rows_plan(16384, 128, k) == D.SeedRowsPlan("tile", 4, 8,
                                                             tile)


@pytest.mark.parametrize("n", [1, 37, 128, 300, 1000, 1500])
@pytest.mark.parametrize("k", [2, 64, 256])
def test_plan_tiles_fit_shared_memory(n, k):
    """What csrc/distance.cu's launch checks: whole seed groups, staged
    rows with their norms and flags within TILE_SMEM_BYTES."""
    plan = D.seed_rows_plan(1000, n, k)
    assert plan.path == "tile"
    assert plan.tile_seeds % D.SEED_GROUP == 0
    assert 0 < plan.tile_seeds <= D.MAX_TILE_SEEDS
    assert plan.tile_seeds * (4 * n + 8) <= D.TILE_SMEM_BYTES
    assert plan.tile_seeds <= -(-k // D.SEED_GROUP) * D.SEED_GROUP
    # A point range spreads over at most TILE_BLOCKS blocks where the
    # seeds fit (and k = 64 and 256 at n = 128 use all of them).
    if plan.tile_seeds == min(D.MAX_TILE_SEEDS, -(-k // 32) * 8):
        assert -(-k // plan.tile_seeds) <= D.TILE_BLOCKS


def test_plan_rows_too_wide_to_stage_take_the_row_path():
    n = (D.TILE_SMEM_BYTES // D.SEED_GROUP - 8) // 4 + 1
    assert D.seed_rows_plan(100, n, 64).path == "row"
    assert D.seed_rows_plan(100, n - 1, 64).path == "tile"
    assert D.seed_rows_plan(100, 8, 65 * 2 ** 22).path == "row"


def test_unaligned_view_takes_single_columns():
    x = torch.zeros(40 * 128 + 1)[1:].view(40, 128)
    assert x.is_contiguous() and x.data_ptr() % 16
    assert D.seed_rows_plan(40, 128, 8, aligned=False).vec == 1


# -- the partition, mirrored -------------------------------------------------

def _lane_columns(n: int, plan) -> list:
    """The columns lane l sums, in its order."""
    if plan.vec == 4:
        return [[4 * v + c for v in range(l, n // 4, plan.lanes)
                 for c in range(4)] for l in range(plan.lanes)]
    return [list(range(l, n, plan.lanes)) for l in range(plan.lanes)]


def _tree(p):
    """The kernel's merge of 8 partials: lanes differing in bit 2, then
    bit 1, then bit 0 (the order of each pair does not change the bits)."""
    return ((p[0] + p[4]) + (p[2] + p[6])) + ((p[1] + p[5]) + (p[3] + p[7]))


def _mirror(points, sq, idx, plan):
    """float32 mirror of csrc/distance.cu: per element, 8 lane chains over
    the plan's column sets merged by the tree, then (sq_s + sq_q) - 2·dot
    clamped at 0.  Returns the rows and the count of lanes summing each
    column."""
    m, n = points.shape
    seeds = points[idx.long()]
    count = torch.zeros(n, dtype=torch.int64)
    parts = []
    for cols in _lane_columns(n, plan):
        acc = torch.zeros((len(idx), m), dtype=torch.float32)
        for j in cols:
            acc = acc + seeds[:, j, None] * points[None, :, j]
            count[j] += 1
        parts.append(acc)
    dot = _tree(parts)
    out = (sq[idx.long(), None] + sq[None, :]) - 2.0 * dot
    return out.clamp_min(0.0), count


def _inputs(m, n, k, seed=0):
    rng = np.random.default_rng(m * 31 + n * 7 + k + seed)
    W = 100.0 + rng.random((m, n))
    W[: max(1, m // 4)] *= 5.0
    W = W.astype(np.float32)
    sq = np.einsum("ij,ij->i", W.astype(np.float64),
                   W.astype(np.float64)).astype(np.float32)
    idx = rng.choice(m, size=k, replace=False).astype(np.int32)
    return torch.from_numpy(W), torch.from_numpy(sq), torch.from_numpy(idx)


@pytest.mark.parametrize("m,n,k", [(1000, 128, 3), (97, 37, 5),
                                   (64, 130, 7), (300, 300, 4), (40, 6, 5),
                                   (16, 1, 1)])
@pytest.mark.parametrize("aligned", [True, False])
def test_mirror_covers_each_column_once_within_tolerance(m, n, k, aligned):
    pts, sq, idx = _inputs(m, n, k)
    plan = D.seed_rows_plan(m, n, k, aligned)
    got, count = _mirror(pts, sq, idx, plan)
    assert torch.equal(count, torch.ones(n, dtype=torch.int64))
    scale = D.rounding_scale(sq, idx, n)
    exact = D.multi_seed_rows_ref(pts.double(), sq.double(), idx)
    plain = D.multi_seed_rows_ref(pts, sq, idx)
    assert ((got.double() - exact).abs() <= D.C_F64 * scale).all()
    assert ((got.double() - plain.double()).abs() <= D.C_PLAIN * scale).all()


def test_tree_gives_the_same_bits_on_every_lane():
    """The row path merges the partials as an all-reduce (every lane ends
    with the sum), the tile path as a reduce-scatter (lane l ends with seed
    l's): both are the same unordered tree, so the bits agree."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((8, 8, 500))
                         .astype(np.float32) * 1e3)  # [lane, seed, trial]
    lanes = torch.arange(8)
    # All-reduce on every lane L: v += shfl_xor(v, 4), then 2, then 1.
    v = a.clone()
    for off in (4, 2, 1):
        v = v + v[lanes ^ off]
    # Reduce-scatter: at each level keep the half of the seeds whose bit
    # matches the lane's and add the partner's partials of them.
    h = a.clone()
    for bit in (4, 2, 1):
        partner = h[lanes ^ bit]
        keep = ((torch.arange(8)[None, :] & bit) == (lanes[:, None] & bit))
        h = torch.where(keep[:, :, None], h + partner, h)
    for s in range(8):
        assert torch.equal(h[s, s], v[0, s])
        for L in range(8):
            assert torch.equal(v[L, s], v[0, s])
