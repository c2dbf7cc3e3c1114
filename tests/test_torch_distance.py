"""The seed-row kernel module of the port against the reference's Pallas
kernel.

On the CPU the wrapper runs the plain PyTorch version; it is held against
``repro.kernels.distance.multi_seed_rows`` in interpret mode (its own CPU
route) on ragged shapes, and both against a float64 evaluation, on
fleet-like inputs (values near 100, heavy cancellation) and on centred
ones (standard-normal features with the seeds' rows repeated, so every
row holds zero distances).
Tolerance, per element: the Gram identity in float32 cancels with an
error that grows with the norms it cancels, so each element may sit
C_F64 = 3 times its own rounding scale sqrt(n)·2⁻²⁴·(|W_s|²+|W_q|²)
(``distance.rounding_scale``) from float64, and C_PLAIN = 4 times from
the other float32 result; results are >= 0 and a seed's distance to
itself is within tolerance of 0.  Batched rows equal per-seed rows bit
for bit.  The tolerances are ``distance.C_F64`` and ``distance.C_PLAIN``,
the constants chip_smoke.py's phase 3 holds the kernel to and the kernel
lane's decision bound is built on.  Tests marked ``gpu`` hold the CUDA
kernel to the same bounds on the card, on every path of its plan, and
skip here.
"""
import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from repro_torch import kernels as K
from repro_torch.kernels import distance as D

SHAPES = [(16, 1, 1), (40, 6, 5), (130, 17, 9), (513, 3, 12), (64, 130, 7),
          (1000, 37, 3), (97, 5, 24)]
C_F64, C_PLAIN = D.C_F64, D.C_PLAIN


def _inputs(m, n, k, seed=0, centred=False):
    rng = np.random.default_rng(m * 31 + n * 7 + k + seed)
    k = min(k, m)
    if centred:
        W = rng.standard_normal((m, n))
        idx = rng.choice(m - k, size=k, replace=False).astype(np.int32)
        W[m - k:] = W[idx]
    else:
        W = 100.0 + rng.random((m, n))
        W[: max(1, m // 4)] *= 5.0
        idx = rng.choice(m, size=k, replace=False).astype(np.int32)
    W = W.astype(np.float32)
    sq = np.einsum("ij,ij->i", W.astype(np.float64),
                   W.astype(np.float64)).astype(np.float32)
    return W, sq, idx


def _f64_rows(W, idx):
    W = W.astype(np.float64)
    return ((W[idx][:, None, :] - W[None, :, :]) ** 2).sum(axis=2)


def _assert_rows(got, want, W, sq, idx, c):
    """Every element of ``got`` within c times its own rounding scale of
    ``want``; all >= 0; each seed's distance to itself within that of 0."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = D.rounding_scale(torch.from_numpy(sq), torch.from_numpy(idx),
                             W.shape[1]).numpy()
    err = np.abs(got - want)
    assert (err <= c * scale).all(), (
        f"{int((err > c * scale).sum())} elements off; worst "
        f"{float((err / np.maximum(scale, 1e-300)).max()):.3f}x the scale")
    assert (got >= 0).all()
    seeds = np.arange(len(idx))
    assert (got[seeds, idx] <= C_F64 * scale[seeds, idx]).all()


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_plain_matches_pallas_interpret(m, n, k):
    # the one test here that needs the reference (and so jax): the rest of
    # the file runs where jax is not installed, as in the CI twin's
    # torch-accelerated job
    ref_dist = pytest.importorskip("repro.kernels.distance")
    for centred in (False, True):
        W, sq, idx = _inputs(m, n, k, centred=centred)
        want = np.asarray(ref_dist.multi_seed_rows(W, sq, idx,
                                                   interpret=True))
        got = D.multi_seed_rows(torch.from_numpy(W), torch.from_numpy(sq),
                                torch.from_numpy(idx)).numpy()
        assert got.shape == want.shape == (len(idx), m)
        assert got.dtype == np.float32
        _assert_rows(got, want, W, sq, idx, C_PLAIN)
        _assert_rows(got, _f64_rows(W, idx), W, sq, idx, C_F64)
        _assert_rows(want, _f64_rows(W, idx), W, sq, idx, C_F64)


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_batched_equals_per_seed_bitwise(m, n, k):
    W, sq, idx = _inputs(m, n, k, seed=1)
    pts, sqt, ii = map(torch.from_numpy, (W, sq, idx))
    batched = D.multi_seed_rows(pts, sqt, ii)
    per = torch.cat([D.multi_seed_rows(pts, sqt, ii[i:i + 1])
                     for i in range(len(idx))])
    assert torch.equal(batched, per)


def test_cpu_path_launches_nothing():
    K.reset_launches()
    W, sq, idx = _inputs(40, 6, 5)
    D.multi_seed_rows(*map(torch.from_numpy, (W, sq, idx)))
    assert K.LAUNCHES["multi_seed_rows"] == 0


def test_reset_clears_the_seed_count_histogram():
    """SEED_COUNTS counts launches by k beside LAUNCHES: none on the CPU,
    and reset_launches() clears it."""
    D.SEED_COUNTS[3] = 1
    K.reset_launches()
    assert D.SEED_COUNTS == {} and K.SEED_COUNTS is D.SEED_COUNTS
    W, sq, idx = _inputs(40, 6, 5)
    D.multi_seed_rows(*map(torch.from_numpy, (W, sq, idx)))
    assert D.SEED_COUNTS == {}


def test_decision_bound_is_built_on_the_checked_tolerances():
    """The kernel lane's bound on a base row's error covers a row from
    either float32 path: ROW_ERR_C is the larger of the two tolerances the
    kernel checks enforce, plus the inputs' float32 rounding."""
    assert D.ROW_ERR_C == max(D.C_F64, D.C_PLAIN)
    assert D.row_error_coef(128) == pytest.approx(
        (D.ROW_ERR_C * 128 ** 0.5 + D.INPUT_ERR) * 2.0 ** -24)


def test_empty_shapes():
    pts = torch.zeros((5, 0))
    sq = torch.zeros(5)
    out = D.multi_seed_rows(pts, sq, torch.tensor([1, 4], dtype=torch.int32))
    assert torch.equal(out, torch.zeros((2, 5)))
    none = D.multi_seed_rows(pts, sq, torch.zeros(0, dtype=torch.int32))
    assert none.shape == (0, 5)


@pytest.mark.parametrize("bad", [
    dict(points=torch.zeros((4, 3), dtype=torch.float64)),
    dict(sq=torch.zeros(4, dtype=torch.float64)),
    dict(idx=torch.zeros(2, dtype=torch.int64)),
    dict(points=torch.zeros(4)),
    dict(sq=torch.zeros(3)),
    dict(idx=torch.zeros((2, 1), dtype=torch.int32)),
    dict(points=torch.zeros((3, 4)).T),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = dict(points=torch.zeros((4, 3)), sq=torch.zeros(4),
                idx=torch.zeros(2, dtype=torch.int32))
    args.update(bad)
    with pytest.raises((TypeError, ValueError)):
        D.multi_seed_rows(args["points"], args["sq"], args["idx"])


def test_build_is_keyed_by_source_hash():
    from repro_torch.kernels import build
    key = build._key(build.CSRC / "distance.cu")
    assert len(key) == 16 and key == build._key(build.CSRC / "distance.cu")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", SHAPES + [(16384, 128, 8),
                                            (300, 300, 20)])
def test_kernel_matches_plain_on_card(cuda, m, n, k):
    for centred in (False, True):
        W, sq, idx = _inputs(m, n, k, centred=centred)
        pts, sqt, ii = (torch.from_numpy(a).to(cuda) for a in (W, sq, idx))
        K.reset_launches()
        got = D.multi_seed_rows(pts, sqt, ii)
        plain = D.multi_seed_rows_ref(pts, sqt, ii)
        torch.cuda.synchronize()
        assert K.LAUNCHES["multi_seed_rows"] == 1
        got = got.cpu().numpy()
        _assert_rows(got, plain.cpu().numpy(), W, sq, idx, C_PLAIN)
        _assert_rows(got, _f64_rows(W, idx), W, sq, idx, C_F64)
        per = torch.cat([D.multi_seed_rows(pts, sqt, ii[i:i + 1])
                         for i in range(len(idx))])
        assert np.array_equal(got, per.cpu().numpy())


@pytest.mark.gpu
def test_kernel_out_of_range_seed_gives_nan_row(cuda):
    W, sq, _ = _inputs(70, 4, 1)
    pts, sqt = torch.from_numpy(W).to(cuda), torch.from_numpy(sq).to(cuda)
    out = D.multi_seed_rows(pts, sqt, torch.tensor([3, 70], device=cuda,
                                                   dtype=torch.int32))
    assert torch.isnan(out[1]).all() and not torch.isnan(out[0]).any()


# Every path of the plan, forced through ``_launch``: (path, vec), with n
# a multiple of 4 for vec 4.
FORCED = [("row", 4), ("row", 1), ("tile", 4), ("tile", 1)]
FORCED_SHAPES = [(1000, 128, 9), (97, 36, 5), (64, 132, 17), (300, 300, 20),
                 (16384, 128, 64), (40, 8, 3), (97, 37, 5), (64, 130, 17),
                 (40, 6, 3)]


def _forced(path, vec, m, n, k):
    tile = D.seed_rows_plan(m, n, max(k, 2)).tile_seeds if path == "tile" \
        else 0
    return D.SeedRowsPlan(path, vec, D.LANES, tile)


@pytest.mark.gpu
@pytest.mark.parametrize("path,vec", FORCED)
@pytest.mark.parametrize("m,n,k", FORCED_SHAPES)
def test_every_plan_path_matches_plain_on_card(cuda, path, vec, m, n, k):
    if vec == 4 and n % 4:
        vec = 1                      # single columns: the path n takes
    plan = _forced(path, vec, m, n, k)
    for centred in (False, True):
        W, sq, idx = _inputs(m, n, k, centred=centred)
        pts, sqt, ii = (torch.from_numpy(a).to(cuda) for a in (W, sq, idx))
        out = torch.empty((len(idx), m), device=cuda)
        D._launch(pts, sqt, ii, out, plan)
        got = out.cpu().numpy()
        _assert_rows(got, D.multi_seed_rows_ref(pts, sqt, ii).cpu().numpy(),
                     W, sq, idx, C_PLAIN)
        _assert_rows(got, _f64_rows(W, idx), W, sq, idx, C_F64)
        # Each element's arithmetic is fixed by (n, vec) alone: where the
        # plan takes the same vec, its own launch agrees bit for bit.
        if D.seed_rows_plan(m, n, k).vec == vec:
            assert np.array_equal(got, D.multi_seed_rows(pts, sqt, ii)
                                  .cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [128, 37, 130, 6, 300])
def test_batched_rows_bitwise_equal_per_seed_rows_on_card(cuda, n):
    """k = 1, 2, 3, 8, 17, 64 and 256 against per-seed launches (the row
    path); the k = 256 batch spans four 64-seed tiles and holds its first
    seed three times, in three of them."""
    m = 2000
    W, sq, _ = _inputs(m, n, 1, seed=2)
    pts, sqt = torch.from_numpy(W).to(cuda), torch.from_numpy(sq).to(cuda)
    rng = np.random.default_rng(n)
    for k in (1, 2, 3, 8, 17, 64, 256):
        idx = rng.choice(m, size=k, replace=False).astype(np.int32)
        if k == 256:
            idx[130] = idx[255] = idx[0]
        ii = torch.from_numpy(idx).to(cuda)
        K.reset_launches()
        batched = D.multi_seed_rows(pts, sqt, ii)
        assert K.LAUNCHES["multi_seed_rows"] == 1 and D.SEED_COUNTS == {k: 1}
        per = torch.cat([D.multi_seed_rows(pts, sqt, ii[i:i + 1])
                         for i in range(k)])
        assert torch.equal(batched, per), f"k={k}"


@pytest.mark.gpu
def test_unaligned_view_on_card(cuda):
    m, n, k = 300, 128, 9
    W, sq, idx = _inputs(m, n, k)
    buf = torch.zeros(m * n + 1, device=cuda)
    pts = buf[1:].view(m, n)
    pts.copy_(torch.from_numpy(W))
    assert pts.data_ptr() % 16 and pts.is_contiguous()
    sqt, ii = torch.from_numpy(sq).to(cuda), torch.from_numpy(idx).to(cuda)
    got = D.multi_seed_rows(pts, sqt, ii)
    _assert_rows(got.cpu().numpy(), _f64_rows(W, idx), W, sq, idx, C_F64)
    per = torch.cat([D.multi_seed_rows(pts, sqt, ii[i:i + 1])
                     for i in range(k)])
    assert torch.equal(got, per)
    with pytest.raises(RuntimeError, match="launch failed"):
        D._launch(pts, sqt, ii, torch.empty_like(got),
                  D.SeedRowsPlan("row", 4, D.LANES, 0))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 9])
def test_out_of_range_seeds_give_nan_rows_on_the_tile_path(cuda, k):
    W, sq, _ = _inputs(70, 8, 1)
    pts, sqt = torch.from_numpy(W).to(cuda), torch.from_numpy(sq).to(cuda)
    idx = torch.arange(k, dtype=torch.int32, device=cuda)
    idx[0], idx[-1] = -1, 70
    assert D.seed_rows_plan(70, 8, k).path == "tile"
    out = D.multi_seed_rows(pts, sqt, idx)
    assert torch.isnan(out[0]).all() and torch.isnan(out[-1]).all()
    assert not torch.isnan(out[1:-1]).any()


@pytest.mark.gpu
def test_fault_pin_on_card(cuda):
    """The 2 x 4 matrix whose composite trial split the lanes: on the card
    the kernel lane gives the exact lane's 2 clusters."""
    from repro_torch.core import IncrementalClusterState, clustering
    pin = np.array([
        [1.4126013409999993, 0.8884826409999995, 0.0,
         5.1191000056860503e-04],
        [0.67398050800000009, 0.48293688799999934, 0.0,
         2.7357000044503366e-04]])
    be = clustering.get_distance_backend("kernel", device="cuda")
    st = IncrementalClusterState(pin, backend=be)
    assert st.cluster_batch([([0, 1], 0.0)])[0].n_clusters == 2
    st.push([0, 1], 0.0)
    assert st.cluster().n_clusters == 2
    assert be.decisions["redecided"] >= 2
