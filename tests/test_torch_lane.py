"""The analyzer's ``"torch"`` lane: seed rows from one PyTorch ``addmm``,
the twin of the reference's jax lane.

* its rows (``device="cpu"``) against the reference's
  ``get_distance_backend("jax").seed_rows`` and against float64, each
  element within the lane's own ``row_error_coef`` times its norms;
* that coefficient holds for any summation order of the row's terms
  (columns permuted, the sum split into partial sums, the addend folded
  in first or added last), while the kernel lane keeps its own,
  unchanged;
* the lane's verdicts: the 19 synthetic entries equal
  ``VERDICTS_synthetic.json``, a fleet-shaped trace's ``Verdict.doc()``
  equals the numpy lane's, batched and sequential trial evaluation give
  the same partitions, the fault pin decides as the exact lane;
* the caller's float32 matmul settings (TF32) are restored after a call.
"""
import json
import math
import pathlib

import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from repro.core import clustering as ref_cl
from repro_torch.core import AutoAnalyzer, IncrementalClusterState
from repro_torch.core import clustering as cl
from repro_torch.kernels import distance as D

ROOT = pathlib.Path(__file__).resolve().parents[1]
U = 2.0 ** -24


def _torch_lane():
    return cl.get_distance_backend("torch", device="cpu")


def _inputs(m, n, k, centred=False, seed=0):
    """Fleet-like points (times near 100, a straggler block 5x: the Gram
    identity cancels heavily) or centred normal ones, and k seeds."""
    rng = np.random.default_rng(1000 * m + 10 * n + k + int(centred) + seed)
    if centred:
        W = rng.standard_normal((m, n))
    else:
        W = 100.0 + rng.random((m, n))
        W[: m // 8] *= 5.0
    idx = rng.choice(m, size=k, replace=False)
    return W, np.einsum("ij,ij->i", W, W), idx


def _exact(W, sq, idx):
    return cl._NumpyDistanceBackend().seed_rows((W, sq), idx)


def _within_bound(got, want, coef, sq, idx, what):
    bound = coef * (sq[idx][:, None] + sq[None, :])
    err = np.abs(got - want)
    worst = float((err / bound).max())
    assert worst <= 1.0, f"{what}: error {worst:.3f} of the bound"
    return worst


SHAPES = [(257, 128, 1), (257, 128, 8), (1000, 37, 3), (64, 512, 5),
          (33, 1, 2)]


@pytest.mark.parametrize("centred", [False, True])
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_rows_within_the_lanes_bound_of_float64(m, n, k, centred):
    W, sq, idx = _inputs(m, n, k, centred)
    be = _torch_lane()
    got = be.seed_rows(be.prepare(W, sq), idx)
    assert got.dtype == np.float64 and got.shape == (k, m)
    assert (got >= 0).all()
    _within_bound(got, _exact(W, sq, idx), be.row_error_coef(n), sq, idx,
                  f"torch lane vs float64 at {(m, n, k)}")


@pytest.mark.parametrize("m,n,k", SHAPES[:3])
def test_rows_agree_with_the_references_jax_lane(m, n, k):
    """Both float32 lanes lie within the torch lane's (order-free) bound
    of the exact rows, so within twice it of each other."""
    W, sq, idx = _inputs(m, n, k)
    ref = ref_cl.get_distance_backend("jax")
    want = ref.seed_rows(ref.prepare(W, sq), idx)
    be = _torch_lane()
    got = be.seed_rows(be.prepare(W, sq), idx)
    coef = be.row_error_coef(n)
    _within_bound(want, _exact(W, sq, idx), coef, sq, idx, "jax lane")
    _within_bound(got, want, 2 * coef, sq, idx, "torch vs jax lane")


def _ordered_rows(W, sq, idx, order, splits, addend_first):
    """float32 rows with each dot product's terms -2·W_s,j·W_q,j summed
    over the columns in ``order``, cut into ``splits`` partial sums added
    at the end (a split-K product); the addend sq[s] + sq[q] added after
    them, or (``addend_first``) folded into the first partial sum."""
    W32, sq32 = W.astype(np.float32), sq.astype(np.float32)
    out = np.empty((len(idx), W.shape[0]), dtype=np.float32)
    for i, s in enumerate(idx):
        C = (sq32[s] + sq32).astype(np.float32)
        parts = []
        for c, chunk in enumerate(np.array_split(order, splits)):
            acc = C.copy() if addend_first and c == 0 else \
                np.zeros(W.shape[0], dtype=np.float32)
            for j in chunk:
                term = (np.float32(-2) * W32[:, j] * W32[s, j])
                acc = (acc + term.astype(np.float32)).astype(np.float32)
            parts.append(acc)
        row = parts[0]
        for p in parts[1:]:
            row = (row + p).astype(np.float32)
        if not addend_first:
            row = (C + row).astype(np.float32)
        out[i] = np.maximum(row, np.float32(0))
    return out.astype(np.float64)


@pytest.mark.parametrize("addend_first", [False, True])
@pytest.mark.parametrize("splits", [1, 2, 4, 16])
@pytest.mark.parametrize("order", ["forward", "reversed", "permuted"])
def test_bound_holds_for_any_summation_order(order, splits, addend_first):
    m, n, k = 400, 128, 3
    W, sq, idx = _inputs(m, n, k)
    cols = np.arange(n)
    if order == "reversed":
        cols = cols[::-1]
    elif order == "permuted":
        cols = np.random.default_rng(splits).permutation(n)
    got = _ordered_rows(W, sq, idx, cols, splits, addend_first)
    _within_bound(got, _exact(W, sq, idx), _torch_lane().row_error_coef(n),
                  sq, idx, f"{order} order in {splits} partial sums")


def test_coefficients_of_the_two_float32_lanes():
    torch_lane = _torch_lane()
    kernel_lane = cl.get_distance_backend("kernel", device="cpu")
    for n in (1, 16, 128, 512, 4096):
        # the kernel lane's bound, calibrated to its fixed-order chains,
        # is unchanged
        assert kernel_lane.row_error_coef(n) == D.row_error_coef(n) == \
            (4.0 * math.sqrt(n) + 4.0) * U
        ku = (n + 1) * U
        want = (2 + U) * ku / (1 - ku) + 5 * U
        assert torch_lane.row_error_coef(n) == pytest.approx(want, rel=1e-15)
    # about (2n + 7)·u: 5.3 times the kernel lane's at n = 128
    ratio = torch_lane.row_error_coef(128) / kernel_lane.row_error_coef(128)
    assert 5.3 < ratio < 5.4
    W, sq, _ = _inputs(50, 128, 1)
    for be in (torch_lane, kernel_lane):
        cert = cl._Certifier(be, W, sq, [])
        assert cert.coef == be.row_error_coef(128)


def test_lane_resolution(monkeypatch):
    assert cl.DISTANCE_BACKENDS == ("numpy", "kernel", "torch")
    be = _torch_lane()
    assert (be.name, be.supports_device, be.float32_rows) == \
        ("torch", True, True)
    assert be.device == torch.device("cpu")
    assert be.decisions == {"flagged": 0, "redecided": 0, "redecide_s": 0.0,
                            "kmeans_redecided": 0}
    assert cl._is_device_backend("torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cl.get_distance_backend("torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AutoAnalyzer(_one_region_tree(), distance_backend="torch")


def _one_region_tree():
    from repro_torch.core import RegionTree
    tree = RegionTree("t")
    tree.add("a")
    return tree


def _settings():
    """The float32 matmul settings a caller can read: the global ones and,
    where PyTorch has them, the per-backend ones."""
    b = torch.backends
    out = [torch.get_float32_matmul_precision(), b.cuda.matmul.allow_tf32]
    if hasattr(b.cuda.matmul, "fp32_precision"):
        out += [b.cuda.matmul.fp32_precision, b.mkldnn.matmul.fp32_precision]
    return out


def test_callers_matmul_settings_restored():
    prec = torch.get_float32_matmul_precision()
    be = _torch_lane()
    W, sq, idx = _inputs(64, 16, 4)
    try:
        for set_by_caller in (
                lambda: setattr(torch.backends.cuda.matmul, "allow_tf32",
                                True),
                lambda: torch.set_float32_matmul_precision("medium"),
                lambda: torch.set_float32_matmul_precision("highest")):
            set_by_caller()
            before = _settings()
            with cl.full_float32():
                inside = _settings()
            assert inside[:2] == ["highest", False]
            assert all(v == "ieee" for v in inside[2:])
            assert _settings() == before
            be.seed_rows(be.prepare(W, sq), idx)
            assert _settings() == before
            with pytest.raises(ZeroDivisionError):
                with cl.full_float32():
                    1 / 0
            assert _settings() == before
    finally:
        torch.set_float32_matmul_precision(prec)


# -- verdicts -----------------------------------------------------------------

def test_synthetic_verdicts_equal_the_committed_snapshot():
    from repro_torch.cli.snapshot_verdicts import drift, snapshot
    with open(ROOT / "VERDICTS_synthetic.json") as f:
        baseline = json.load(f)
    current = snapshot(0, "torch", "cpu")
    assert set(current) == set(baseline)
    assert drift(baseline, current) == []


def test_snapshot_cli_checks_the_torch_lane(capsys):
    from repro_torch.cli.snapshot_verdicts import main
    assert main(["--check", str(ROOT / "VERDICTS_synthetic.json"),
                 "--distance-backend", "torch", "--device", "cpu"]) == 0
    assert "torch lane" in capsys.readouterr().out


def test_fleet_shaped_trace_matches_the_numpy_lane(tmp_path):
    from tests.test_torch_analyzer import _chip_smoke
    from repro_torch.core import RegionTrace
    cs = _chip_smoke()
    _, col, planted = cs.fleet_collector(256, 32, 32)
    trace = RegionTrace.load(col.collect_trace().save(
        str(tmp_path / "fleet.npz")))
    want = AutoAnalyzer(trace.tree(), distance_backend="numpy"
                        ).analyze_trace(trace)
    an = AutoAnalyzer(trace.tree(), distance_backend="torch", device="cpu")
    got = an.analyze_trace(trace)
    assert got.verdict.doc() == want.verdict.doc()
    assert got.dissimilarity.severity == want.dissimilarity.severity
    assert set(an.decisions) == {"flagged", "redecided", "redecide_s",
                                 "kmeans_redecided"}


def _toggle_workload(seed):
    rng = np.random.default_rng(seed)
    W = 100.0 + rng.random((48, 6))
    W[:12] *= 7.0
    W[rng.random(W.shape) < 0.1] *= 3.0
    toggles = [([c], 0.0) for c in range(6)] + [([0, 1], 0.0),
                                                ([2], W[:, 2] * 2.0)]
    return W, toggles


@pytest.mark.parametrize("seed", range(4))
def test_batched_and_sequential_trials_give_equal_partitions(seed):
    """cuBLAS may sum a seed's row in another order when it is fetched
    with other seeds, so rows need not be equal bit for bit; the certified
    decisions are, and with them every partition."""
    W, toggles = _toggle_workload(seed)
    want = ref_cl.IncrementalClusterState(W).cluster_batch(toggles)
    batched = IncrementalClusterState(
        W, backend=_torch_lane()).cluster_batch(toggles)
    for t, w, b in zip(toggles, want, batched):
        one = IncrementalClusterState(
            W, backend=_torch_lane()).cluster_batch([t])[0]
        st = IncrementalClusterState(W, backend=_torch_lane())
        st.push(*t)
        pushed = st.cluster()
        for got in (b, one, pushed):
            assert got.n_clusters == w.n_clusters and got.same_partition(w)


@pytest.mark.parametrize("m,n", [(64, 16), (200, 24)])
def test_batched_and_sequential_searches_give_equal_verdicts(m, n):
    """Algorithm 2 on the torch lane, batched (the lockstep trials of
    ``cluster_batch``) and sequential (an opaque ``cluster_fn`` that
    clusters every trial matrix from scratch on the same lane), against
    the exact lane: equal reports."""
    from repro_torch.bench.analyzer_bench import algo2_workload
    from repro_torch.core import find_dissimilarity_bottlenecks
    tree, T, rids = algo2_workload(m, n)
    lane = _torch_lane()
    want = find_dissimilarity_bottlenecks(tree, T, rids)
    batched = find_dissimilarity_bottlenecks(tree, T, rids, backend=lane)
    sequential = find_dissimilarity_bottlenecks(
        tree, T, rids, cluster_fn=lambda v: cl.optics_cluster(v,
                                                              backend=lane))
    for got in (batched, sequential):
        assert (got.exists, got.ccrs, got.cccrs, got.severity,
                got.composite_s) == (want.exists, want.ccrs, want.cccrs,
                                     want.severity, want.composite_s)
        assert got.baseline.same_partition(want.baseline)
    assert want.exists


def test_fault_pin_decides_as_the_exact_lane():
    from tests.test_torch_clustering import PIN
    want = ref_cl.IncrementalClusterState(PIN).cluster_batch(
        [([0, 1], 0.0)])[0]
    st = IncrementalClusterState(PIN, backend=_torch_lane())
    got = st.cluster_batch([([0, 1], 0.0)])[0]
    assert got.n_clusters == want.n_clusters == 2
    assert got.same_partition(want)
    assert st.fetch_stats["flagged"] >= 1


def test_kmeans_on_the_lane_equals_numpy():
    rng = np.random.default_rng(3)
    vals = np.concatenate([rng.normal(c, 0.05, 6) for c in (1, 5, 20, 80)])
    for k in (2, 3, 5):
        np.testing.assert_array_equal(
            cl.kmeans_1d(vals, k, backend=_torch_lane()),
            ref_cl.kmeans_1d(vals, k))


# -- chip_smoke's phase 29, rehearsed on the host -----------------------------

def test_chip_smoke_lane_phase_rehearsed():
    from tests.test_torch_analyzer import _chip_smoke
    cs = _chip_smoke()
    rows = cs.torch_lane_rows_phase("cpu", 2048, 128, (1, 8))
    assert rows["coef_u"] == pytest.approx(
        _torch_lane().row_error_coef(128) / U)
    for r in rows["ks"].values():
        assert r["tf32_off"] <= 1.0 and r["tf32_on"] <= 1.0
    fleet = cs.lanes_fleet_phase(256, 32, 32, "cpu")
    assert set(fleet) == {"numpy", "kernel", "torch"}
    assert fleet["numpy"]["decisions"] is None
    assert fleet["torch"]["launches"] == 0
    corpus = cs.corpus_phase("cpu", lane="torch")
    assert corpus["entries"] == 19 and corpus["launches"] == 0
    # the library column of phase 3 times the lane's own function
    W, sq, idx = _inputs(300, 16, 4)
    pts = torch.as_tensor(W, dtype=torch.float32)
    sq32 = torch.as_tensor(sq, dtype=torch.float32)
    ii = torch.as_tensor(idx)
    assert torch.equal(cs.library_rows(pts, sq32, ii),
                       cl.torch_seed_rows(pts, sq32, ii))
