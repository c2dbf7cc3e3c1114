"""The port's clustering core and device lockstep against the reference's
exact numpy lane.

* the ``"numpy"`` lane is the reference's code: labels, cluster counts and
  thresholds equal ``repro``'s bit for bit;
* the ``"kernel"`` lane on the CPU (the kernel's plain version, float32,
  the same torch code the card runs) gives the partitions of ``repro``'s
  numpy lane — for ``optics_cluster`` and for ``cluster_batch`` depth-1
  zero-toggle sweeps — and fetches each unique seed once per state;
* the float64 torch Lloyd loop gives ``repro``'s numpy ``kmeans_1d``
  labels for k = 1..5 (the twin of the reference's TestKmeansJax).

Partitions are compared exactly (same unlabelled partition, same cluster
count); the data keep clusters far apart relative to float32 roundoff.
"""
import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from repro.core import IncrementalClusterState as RefState
from repro.core import clustering as ref_cl
from repro_torch.core import IncrementalClusterState as PortState
from repro_torch.core import clustering as port_cl

CPU = torch.device("cpu")


def _workload(m=40, n=6, seed=0, factor=7.0):
    rng = np.random.default_rng(seed)
    W = 100.0 + rng.random((m, n))
    W[: max(1, m // 4)] *= factor           # well-separated straggler block
    return W


def _kernel():
    return port_cl.get_distance_backend("kernel", device="cpu")


# -- the exact lane is the reference's code ---------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_numpy_lane_labels_bitwise(seed):
    rng = np.random.default_rng(seed)
    W = _workload(m=int(rng.integers(8, 120)), n=int(rng.integers(1, 12)),
                  seed=seed)
    W[rng.random(W.shape) < 0.1] *= 3.0     # a few scattered outliers
    for frac in (0.05, 0.1, 0.3):
        a = ref_cl.optics_cluster(W, threshold_frac=frac)
        b = port_cl.optics_cluster(W, threshold_frac=frac)
        np.testing.assert_array_equal(a.labels, b.labels)
        assert (a.n_clusters, a.threshold) == (b.n_clusters, b.threshold)
    toggles = [([int(c)], 0.0) for c in range(W.shape[1])] + \
        [([0], W[:, 0] * 2.0)]
    for ra, rb in zip(RefState(W).cluster_batch(toggles),
                      PortState(W).cluster_batch(toggles)):
        np.testing.assert_array_equal(ra.labels, rb.labels)
        assert ra.threshold == rb.threshold


def test_numpy_lane_severities_bitwise():
    rng = np.random.default_rng(4)
    vals = np.concatenate([rng.normal(c, 0.05, 6) for c in (1, 5, 20, 80)])
    np.testing.assert_array_equal(port_cl.kmeans_severity(vals),
                                  ref_cl.kmeans_severity(vals))
    W = _workload(m=64, n=5, seed=4)
    res = ref_cl.optics_cluster(W)
    assert port_cl.dissimilarity_severity(res, W) == \
        ref_cl.dissimilarity_severity(res, W)


# -- the kernel lane (CPU: the kernel's plain version) ----------------------

@pytest.mark.parametrize("m,n,seed", [(17, 3, 0), (40, 6, 1), (64, 8, 2),
                                      (200, 5, 3), (33, 2, 4), (129, 16, 5)])
def test_kernel_lane_optics_partitions_match_reference(m, n, seed):
    W = _workload(m, n, seed)
    for frac in (0.1, 0.3):
        got = port_cl.optics_cluster(W, threshold_frac=frac,
                                     backend=_kernel())
        want = ref_cl.optics_cluster(W, threshold_frac=frac)
        assert got.n_clusters == want.n_clusters
        np.testing.assert_array_equal(got.canonical_labels,
                                      want.canonical_labels)


@pytest.mark.parametrize("m,n,seed", [(17, 3, 0), (40, 6, 1), (64, 8, 2),
                                      (200, 5, 3), (33, 2, 4), (129, 16, 5)])
def test_kernel_lane_cluster_batch_matches_reference(m, n, seed):
    """Toggle widths 0..n-1, the shape of Algorithm 2's per-region and
    composite trials (a toggle zeroing every column leaves a matrix of
    exact zeros whose partition is pure roundoff residue, as in the
    reference's own test, and is excluded)."""
    rng = np.random.default_rng(seed)
    W = 50.0 + rng.random((m, n))
    W[: max(1, m // 4)] *= 6.0
    toggles = [([], 0.0)] + \
        [([int(c) for c in rng.choice(n, size=rng.integers(1, n),
                                      replace=False)], 0.0)
         for _ in range(7)]
    dev = PortState(W, backend=_kernel())
    got = dev.cluster_batch(toggles)
    want = RefState(W).cluster_batch(toggles)
    assert dev._device_lockstep() is not None
    for g, w in zip(got, want):
        assert g.n_clusters == w.n_clusters
        assert g.same_partition(w)


def test_depth1_sweep_each_unique_seed_fetched_once():
    """The device row cache memo: repeated sweeps on one state re-fetch
    nothing, and every unique seed costs exactly one row."""
    W = _workload(m=60, n=5, seed=9)
    st = PortState(W, backend=_kernel())
    toggles = [([c], 0.0) for c in range(5)] * 3      # duplicate trials
    first = st.cluster_batch(toggles)
    stats = st.fetch_stats
    assert stats["rows"] == len(stats["per_seed"])
    assert set(stats["per_seed"].values()) == {1}
    assert stats["calls"] <= len(stats["per_seed"])
    rows_before = stats["rows"]
    again = st.cluster_batch(toggles)
    assert stats["rows"] == rows_before
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a.labels, b.labels)


def test_row_cache_capacity_doubles():
    W = _workload(m=80, n=4, seed=3)
    be = _kernel()
    st = PortState(W, backend=be)
    dl, h = st._device_lockstep(), st._handle
    dl._ensure_rows([0, 1, 2])
    assert dl._rcache.shape == (8, 80)
    dl._ensure_rows(list(range(3, 12)))
    assert dl._rcache.shape == (16, 80)
    rows = be.device_rows(h, list(range(12)))
    assert torch.equal(dl._rcache[:12], rows)


def test_pushed_and_nonzero_toggles_fall_back_to_host():
    W = _workload(seed=7)
    a, b = PortState(W, backend=_kernel()), RefState(W)
    a.push([2], 0.0)
    b.push([2], 0.0)
    assert a.cluster().same_partition(b.cluster())
    toggles = [([0], 1.5), ([1], 0.0)]
    for ra, rb in zip(a.cluster_batch(toggles), b.cluster_batch(toggles)):
        assert ra.same_partition(rb)


def test_kernel_backend_resolution():
    assert _kernel().device == CPU
    assert port_cl.get_distance_backend("numpy").name == "numpy"
    with pytest.raises(ValueError, match="unknown distance backend"):
        port_cl.get_distance_backend("pallas")
    be = _kernel()
    assert port_cl.get_distance_backend(be) is be


def test_card_requested_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cl.get_distance_backend("kernel")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cl.resolve_device(None)


# -- the float64 torch Lloyd loop -------------------------------------------

@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_torch_lloyd_matches_numpy_kmeans(seed, k):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.normal(loc, 0.05, size=rng.integers(3, 9))
                           for loc in (1.0, 5.0, 20.0, 80.0)])
    np.testing.assert_array_equal(
        port_cl.kmeans_1d(vals, k, backend=_kernel()),
        ref_cl.kmeans_1d(vals, k))


def test_torch_lloyd_degenerate_inputs():
    for vals in (np.array([3.0]), np.array([2.0, 2.0, 2.0]),
                 np.array([1.0, 9.0]), np.zeros(0)):
        np.testing.assert_array_equal(
            port_cl.kmeans_1d(vals, 3, backend=_kernel()),
            ref_cl.kmeans_1d(vals, 3))


def test_torch_lloyd_convergence_semantics():
    """Labels against the centroids entering the converging iteration and
    the converged centroids' old values — the numpy loop's contract."""
    x = np.array([0.0, 0.1, 0.2, 5.0, 5.1, 9.9, 10.0])
    cent0 = np.quantile(x, np.linspace(0, 1, 3))
    cent, lab = port_cl._kmeans_lloyd_torch(x, cent0, 100, CPU)
    c = cent0.copy()
    for _ in range(100):
        want_lab = np.argmin(np.abs(x[:, None] - c[None, :]), axis=1)
        counts = np.bincount(want_lab, minlength=3)
        new = np.where(counts > 0, np.bincount(want_lab, weights=x,
                                               minlength=3)
                       / np.maximum(counts, 1), c)
        if np.allclose(new, c):
            break
        c = new
    np.testing.assert_array_equal(lab, want_lab)
    np.testing.assert_allclose(cent, c, rtol=0, atol=1e-12)


# -- the kernel lane's certified decisions ----------------------------------

# A trace's (m, n) matrix on which the kernel lane split from the exact lane
# (a CPU-timed serving trace's IncrementalClusterState): zeroing columns 0
# and 1 together leaves an exact D² of 5.68e-8 against a squared radius of
# 2.62e-9, which float32 rows of base norm 0.71 computed as about 0.
PIN = np.array([
    [1.4126013409999993, 0.8884826409999995, 0.0, 5.1191000056860503e-04],
    [0.67398050800000009, 0.48293688799999934, 0.0,
     2.7357000044503366e-04]])


def test_fault_pin_kernel_lane_decides_as_the_exact_lane():
    want = RefState(PIN).cluster_batch([([0, 1], 0.0)])[0]
    assert want.n_clusters == 2
    st = PortState(PIN, backend=_kernel())
    got = st.cluster_batch([([0, 1], 0.0)])[0]
    assert st._device_lockstep() is not None
    assert got.n_clusters == 2 and got.same_partition(want)
    assert st.fetch_stats["flagged"] >= 1
    assert st.fetch_stats["redecided"] >= 1
    # push/cluster: the host greedy pass on float32 base rows.
    st = PortState(PIN, backend=_kernel())
    st.push([0, 1], 0.0)
    assert st.cluster().same_partition(want)
    assert st.fetch_stats["flagged"] >= 1
    zeroed = PIN.copy()
    zeroed[:, [0, 1]] = 0.0
    assert port_cl.optics_cluster(zeroed, backend=_kernel()).n_clusters == 2


def test_certified_lanes_count_into_the_backend():
    be = _kernel()
    for _ in range(2):
        PortState(PIN, backend=be).cluster_batch([([0, 1], 0.0)])
    assert be.decisions["redecided"] >= 2
    assert be.decisions["flagged"] >= be.decisions["redecided"]
    assert be.decisions["redecide_s"] >= 0.0
    np_state = PortState(PIN)
    np_state.cluster_batch([([0, 1], 0.0)])
    assert np_state.fetch_stats["flagged"] == 0


@pytest.mark.parametrize("seed", range(4))
def test_kernel_lane_toggle_of_every_column_matches_reference(seed):
    """Zeroing every column leaves exact zeros: every candidacy is float32
    residue, and every one is re-decided on the exact lane."""
    W = _workload(m=30, n=4, seed=seed)
    toggles = [([0, 1, 2, 3], 0.0), ([1, 2, 3], 0.0)]
    got = PortState(W, backend=_kernel()).cluster_batch(toggles)
    want = RefState(W).cluster_batch(toggles)
    for g, w in zip(got, want):
        assert g.n_clusters == w.n_clusters and g.same_partition(w)


def _cancelling(seed: int, m: int, n: int, n_tog: int):
    """Points whose first ``n_tog`` columns carry nearly all of each
    distance and norm (values near 1), the rest residuals of scale 1e-4
    to 1e-2, in clumps, so that zeroing the large columns leaves
    partitions decided by values ~1e-6 of the base norms."""
    rng = np.random.default_rng(seed)
    W = np.empty((m, n))
    W[:, :n_tog] = 0.5 + rng.random((m, n_tog))
    res = 10.0 ** rng.uniform(-4, -2)
    clumps = rng.integers(1, 4)
    centre = rng.random((clumps, n - n_tog))
    W[:, n_tog:] = res * (centre[rng.integers(0, clumps, m)]
                          + 0.05 * rng.random((m, n - n_tog)))
    return W


try:
    from hypothesis import given, settings, strategies as hst
except ImportError:                          # pragma: no cover
    hst = None


if hst is not None:
    @settings(max_examples=60, deadline=None, derandomize=True,
              database=None)
    @given(seed=hst.integers(0, 2 ** 31 - 1), m=hst.integers(2, 12),
           n=hst.integers(2, 6), frac=hst.sampled_from([0.02, 0.1, 0.3]))
    def test_property_cancelling_toggles_split_no_lane(seed, m, n, frac):
        """Random matrices whose toggled columns hold nearly all of each
        distance, random single and composite zero-toggles: the kernel
        lane's partitions equal the exact lane's through cluster_batch,
        push/cluster and Algorithm 2."""
        from repro.core.search import find_dissimilarity_bottlenecks as ref_f
        from repro_torch.core import RegionTree
        from repro_torch.core.search import find_dissimilarity_bottlenecks
        n_tog = 1 + seed % (n - 1)
        W = _cancelling(seed, m, n, n_tog)
        rng = np.random.default_rng(seed + 1)
        toggles = [(list(range(n_tog)), 0.0)] + \
            [([int(c) for c in rng.choice(n, size=rng.integers(1, n),
                                          replace=False)], 0.0)
             for _ in range(3)]
        got = PortState(W, threshold_frac=frac,
                        backend=_kernel()).cluster_batch(toggles)
        want = RefState(W, threshold_frac=frac).cluster_batch(toggles)
        for (cols, _), g, w in zip(toggles, got, want):
            assert g.n_clusters == w.n_clusters and g.same_partition(w)
            st = PortState(W, threshold_frac=frac, backend=_kernel())
            st.push(cols, 0.0)
            assert st.cluster().same_partition(w)
        tree = RegionTree("P")
        rids = [tree.add(f"r{j}").region_id for j in range(n)]
        a = find_dissimilarity_bottlenecks(tree, W, rids, threshold_frac=frac,
                                           backend=_kernel())
        b = ref_f(tree, W, rids, threshold_frac=frac)
        assert (a.exists, a.ccrs, a.cccrs) == (b.exists, b.ccrs, b.cccrs)
        assert a.baseline.same_partition(b.baseline)


def test_lloyd_loop_certified_or_redecided():
    """A value exactly halfway between two centroids: the device loop
    cannot certify its argmin and returns None; kmeans_1d re-decides on
    the numpy loop and counts it."""
    x = np.array([0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    cent0 = np.array([0.0, 2.0, 6.0])        # 1.0 is halfway from 0 and 2
    assert port_cl._kmeans_lloyd_torch(x, cent0, 100, CPU) is None
    be = _kernel()
    vals = np.array([0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0])
    np.testing.assert_array_equal(port_cl.kmeans_1d(vals, 5, backend=be),
                                  ref_cl.kmeans_1d(vals, 5))
    assert be.decisions["kmeans_redecided"] >= 1
