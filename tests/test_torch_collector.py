"""The port's runtime and static collectors and its cost counting against
the reference: ``TimedRegionRunner`` on the host (``device="cpu"``) keeps
the reference's trace contract (repeat axis, tick header, bit-identical
save/load/reduce, min-of-repeats and the CPU-tick snap); the two runtime
corpus entries name their straggling region; the static collector saves
the reference's bytes; ``roofline_terms`` is the reference's arithmetic;
``cost_of`` counts a matrix product by hand.  The card tests (``gpu``) hold
the runner's CUDA synchronisation and events."""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from repro.core import RegionTree as RefTree
from repro.core import hlo as ref_hlo
from repro.core import static_metrics_from_costs as ref_static_metrics
from repro.core import static_trace_from_costs as ref_static_trace
from repro_torch.core import (CPU_TIME, WALL_TIME, H100_SXM, HardwareSpec,
                              RegionTrace, RegionTree, TimedRegionRunner,
                              cost_of, costs_of, roofline_terms,
                              static_metrics_from_costs,
                              static_trace_from_costs)
from repro_torch.scenarios import faults as F
from repro_torch.scenarios.corpus import (CORPUS, RuntimeFaultCollector,
                                          corpus_entries, run_entry_robust)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RUNTIME = [e.name for e in corpus_entries(backend="runtime")]


def _assert_metrics_equal(a, b):
    assert a.region_ids == b.region_ids
    assert a.n_processes == b.n_processes
    for k in set(a.data) | set(b.data):
        np.testing.assert_array_equal(a.metric(k), b.metric(k), err_msg=k)


def _collect(name, device, seed=0):
    tree, coll = CORPUS[name].build(seed)
    coll.device = device
    coll.collect()
    return tree, coll


class TestRuntimeRoundTrip:
    @pytest.fixture(scope="class")
    def rt(self):
        return _collect("runtime/compute-straggler", "cpu")

    def test_repeat_axis_and_tick_header(self, rt):
        _, coll = rt
        trace = coll.last_trace
        assert trace.n_repeats == 5
        assert trace.meta["cpu_tick"] > 0
        assert trace.meta["derived"]
        assert trace.meta["collector"] == "runtime"
        assert trace.meta["cpu_clock"] in ("thread", "process")

    def test_save_load_reduce_bit_identical(self, rt, tmp_path):
        _, coll = rt
        path = str(tmp_path / "rt.npz")
        coll.last_trace.save(path)
        _assert_metrics_equal(coll.last_trace.reduce(),
                              RegionTrace.load(path).reduce())

    def test_reduce_applies_min_of_repeats_and_snap(self, rt):
        _, coll = rt
        trace = coll.last_trace
        rm = trace.reduce()
        wall = trace.data[WALL_TIME].min(axis=1).sum(axis=0)
        np.testing.assert_array_equal(rm.metric(WALL_TIME), wall)
        # every region here is collective-free, so any sub-tick cpu delta
        # must have been snapped to wall
        tick = trace.meta["cpu_tick"]
        cpu = rm.metric(CPU_TIME)
        snap = (wall < tick) | (np.abs(cpu - wall) < tick)
        assert np.array_equal(cpu[snap], wall[snap])

    def test_costs_counted_once_and_the_same_for_every_shard(self, rt):
        tree, coll = rt
        trace = coll.last_trace
        for metric in ("flops", "bytes", "comm_bytes"):
            col = trace.data[metric]
            assert (col == col[:1, :1, :1]).all(), metric
        solver = trace.col(tree.by_path("rt/solver").region_id)
        # one body of the solver's 96x96 product, whatever shard 0's
        # iterations (6), as the reference's compiled cost counts it
        assert trace.data["flops"][0, 0, 0, solver] == 2 * 96 ** 3
        assert (trace.data["comm_bytes"] == 0).all()
        assert coll.runner.device_s == {}     # no CUDA events on the host


@pytest.mark.parametrize("name", RUNTIME)
def test_runtime_entry_recovers_ground_truth(name):
    """Real execution: the designated shards genuinely run more iterations
    and the analysis names the culprit region.  run_entry_robust
    re-collects once on a miss — wall-clock collection on a loaded host can
    lose a run to a scheduler burst."""
    r = run_entry_robust(CORPUS[name], seed=0,
                         analyzer_overrides={"device": "cpu"})
    assert r.verdict.dissimilar
    assert r.recall == 1.0, (
        f"{name}: missed {sorted(r.missed)}; found {sorted(r.found)}")
    assert r.passed
    assert 1 <= len(r.attempt_walls) <= 2 and all(w > 0
                                                   for w in r.attempt_walls)


def test_runtime_entries_match_the_reference_registry():
    from repro.scenarios.corpus import CORPUS as REF
    assert RUNTIME == ["runtime/compute-straggler", "runtime/data-skew"]
    for name in RUNTIME:
        a, b = CORPUS[name], REF[name]
        assert (a.app, dataclasses.asdict(a.truth), a.analyzer_kw,
                a.min_precision) == \
            (b.app, dataclasses.asdict(b.truth), b.analyzer_kw,
             b.min_precision)
        tree, coll = a.build(3)
        ref_tree, ref_coll = b.build(3)
        assert [r.path for r in tree.regions()] == \
            [r.path for r in ref_tree.regions()]
        assert (coll.size, coll.iters, coll.seed, coll.repeats) == \
            (ref_coll.size, ref_coll.iters, ref_coll.seed, ref_coll.repeats)


def test_runtime_inputs_are_seeded_numpy_normals():
    tree, coll = CORPUS["runtime/data-skew"].build(2)
    coll.device = "cpu"
    coll.repeats = 1
    coll.collect()
    want = np.random.default_rng(2 * 131 + 3).standard_normal((96, 96))
    # shard 3's state after its regions ran from that start: embed, 64
    # solver iterations, reduce — replayed here
    data = np.random.default_rng(2 * 131 + 64 + 3).standard_normal((96, 96))
    s = torch.from_numpy(want.astype(np.float32))
    d = torch.from_numpy(data.astype(np.float32))
    s = s + d @ d.T * 1e-3
    for _ in range(64):
        s = torch.tanh(s @ s) * 0.5 + s * 0.5
    s = s + d.sum() * 1e-6
    assert torch.equal(coll.runner.final_states[3], s)


def test_iterated_work_runs_the_body_iters_times():
    calls = []
    body = F.iterated_work(lambda s, d: (calls.append(d), s + d)[1])
    assert body(1.0, (2.0, 3)) == 7.0 and calls == [2.0] * 3
    idx = F.iterated_work(lambda s, b: s + b[1], indexed=True)
    assert idx(0, ("data", 4)) == 0 + 1 + 2 + 3


def test_cost_of_counts_a_data_loop_body_once():
    """A loop whose trip count is data runs its body once under cost_of,
    as the reference's compiled cost counts a ``fori_loop`` body with a
    traced trip count once: an iterated region counts the same FLOPs on
    every shard (before, shard 0's 6 solver iterations counted 6 bodies
    where the reference counts one).  Outside the count every iteration
    still runs."""
    from repro_torch.core.hlo import cost_of

    def body(s, d):
        return torch.tanh(s @ s) * 0.5 + s * 0.5 + d.sum() * 1e-6

    s, d = torch.ones((16, 16)) * 0.01, torch.ones(4)
    once = cost_of(body, s, d)
    assert once[0] == 2 * 16 ** 3
    loop = F.iterated_work(body)
    for iters in (1, 6, 64):
        assert cost_of(loop, s, (d, iters)) == once
    want = s
    for _ in range(6):
        want = body(want, d)
    assert torch.equal(loop(s, (d, 6)), want)


def test_runner_defaults_to_the_card():
    tree = RegionTree("t")
    tree.add("r", fn=lambda s, d: s)
    if torch.cuda.is_available():
        assert TimedRegionRunner(tree).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TimedRegionRunner(tree)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RuntimeFaultCollector(tree, 8, (1, 2), 0).collect()


# -- static collector ---------------------------------------------------------


def _static_costs(tree_cls):
    tree = tree_cls("step")
    a = tree.add("embed")
    b = tree.add("mlp")
    costs = {a.region_id: {"wall_time": 0.2, "flops": 1e9, "bytes": 3e7},
             b.region_id: {"wall_time": 0.5, "flops": 8e9, "bytes": 9e7}}
    return tree, [a.region_id, b.region_id], costs


def test_runner_times_cpu_regions_on_the_calling_thread():
    """Fault 5's pin: on the CPU every timed call (and the warmup and the
    cost count) runs with PyTorch's intra-op pool at one thread, whose
    spinning workers otherwise charged a tiny region milliseconds of
    process CPU time; the caller's thread count comes back after."""
    from repro_torch.core import RegionTree, TimedRegionRunner
    seen = []
    tree = RegionTree("t")
    tree.add("r", fn=lambda s, d: seen.append(torch.get_num_threads()) or s)
    before = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        TimedRegionRunner(tree, warmup=1, repeats=2, device="cpu").run(
            [0.0, 0.0], [0.0, 0.0])
        assert seen and set(seen) == {1}
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(before)


def test_runner_takes_a_descheduled_cpu_sample_again():
    """Fault 8's pin: with one repeat, a take whose thread was off the CPU
    was the sample, and beside CPU-bound processes such a sample made an
    expert probe read hot, which broke the MoE recovery entry's persisting
    verdict.
    Here one take of shard 1 sleeps 50 ms, off the CPU as a preempted
    thread is: that take is taken again and the region's own time
    recorded (a loaded host may deschedule other takes too)."""
    import time
    calls = []
    x = torch.ones((64, 64))

    def region(s, d):
        calls.append(d)
        if d == 1 and calls.count(1) == 2:      # after the warmup call
            time.sleep(0.05)
        return s + float((x @ x).sum()) * 1e-9

    tree = RegionTree("t")
    tree.add("r", fn=region)
    runner = TimedRegionRunner(tree, warmup=1, repeats=1, device="cpu")
    trace = runner.run_trace([0.0, 0.0, 0.0], [0, 1, 2])
    wall = trace.metric(WALL_TIME)[0, 0, :, 0]
    assert wall[1] < 0.025, wall
    assert runner.retakes >= 1 and calls.count(1) >= 3
    assert trace.meta["retake"]["made"] == runner.retakes

    from repro_torch.core.collector import _descheduled
    assert _descheduled(0.05, 0.0, 1e-6)
    assert not _descheduled(0.05, 0.04, 1e-6)
    assert not _descheduled(0.015, 0.0, 0.01)   # within a coarse clock's
                                                # two ticks


def test_runner_header_states_the_retake_rule(tmp_path):
    """Every raw reading but a descheduled take's survives into the trace,
    so the header says how samples were chosen: the CPU's rule and the
    takes this call made again, through save and load."""
    tree = RegionTree("t")
    tree.add("r", fn=lambda s, d: s + d)
    runner = TimedRegionRunner(tree, warmup=1, repeats=2, device="cpu")
    trace = runner.run_trace([torch.zeros(4)] * 2, [torch.ones(4)] * 2)
    rule = trace.meta["retake"]
    assert rule["off_cpu_share"] == 0.25 and rule["most"] == 3
    assert rule["made"] == runner.retakes >= 0
    path = trace.save(str(tmp_path / "t.npz"))
    assert RegionTrace.load(path).meta["retake"] == rule


def test_cost_of_counts_the_collectives_it_issues():
    """``COMM_BYTES``' source: no process group, no collective; the
    reference's op names for what DTensor and torch.distributed issue."""
    from repro_torch.core.hlo import COLLECTIVE_OPS, collective_op, costs_of
    *_, coll = costs_of(lambda: torch.ones(4) @ torch.ones(4))
    assert coll.total_bytes == 0 and coll.summary() == "none"
    ops = torch.ops
    assert collective_op(ops._c10d_functional.all_gather_into_tensor
                         .default) == "all-gather"
    assert collective_op(ops._c10d_functional.reduce_scatter_tensor
                         .default) == "reduce-scatter"
    assert collective_op(ops._c10d_functional.all_reduce.default) == \
        "all-reduce"
    assert collective_op(ops._c10d_functional.all_to_all_single.default) \
        == "all-to-all"
    assert collective_op(ops.aten.mm.default) == ""
    assert set(COLLECTIVE_OPS) == set(ref_hlo.COLLECTIVE_OPS)


def test_static_trace_saves_the_reference_bytes(tmp_path):
    tree, rids, costs = _static_costs(RegionTree)
    ref_tree, _, _ = _static_costs(RefTree)
    trace = static_trace_from_costs(tree, rids, costs, n_processes=4)
    ref = ref_static_trace(ref_tree, rids, costs, n_processes=4)
    paths = [trace.save(str(tmp_path / "port.npz")),
             ref.save(str(tmp_path / "ref.npz"))]
    a, b = (pathlib.Path(p).read_bytes() for p in paths)
    assert a == b
    _assert_metrics_equal(trace.reduce(), RegionTrace.load(paths[0]).reduce())
    # the classic entry point is the same reduction, with and without a tree
    _assert_metrics_equal(
        trace.reduce(),
        static_metrics_from_costs(rids, costs, n_processes=4, tree=tree))
    flat = static_metrics_from_costs(rids, costs, n_processes=4)
    ref_flat = ref_static_metrics(rids, costs, n_processes=4)
    for k in ref_flat.data:
        np.testing.assert_array_equal(flat.metric(k), ref_flat.metric(k))


# -- roofline and costs ---------------------------------------------------------


@pytest.mark.parametrize("args", [
    (197e12, 0.0, 0.0, 1, {}),
    (1.0, 819e9, 0.0, 1, {}),
    (100.0, 0.0, 0.0, 1, {"model_flops": 60.0}),
    (3e12, 4e11, 2e9, 4, {"flops_already_per_chip": False}),
    (5e9, 7e8, 0.0, 1, {"model_flops": 1e9}),
])
def test_roofline_terms_equal_the_reference(args):
    """Same spec numbers in, same terms out — field for field."""
    flops, nbytes, comm, chips, kw = args
    spec = dataclasses.asdict(H100_SXM)
    ref_spec = ref_hlo.HardwareSpec(**spec)
    got = roofline_terms(flops, nbytes, comm, chips, hw=H100_SXM, **kw)
    want = ref_hlo.roofline_terms(flops, nbytes, comm, chips, hw=ref_spec,
                                  **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("dominant", "bound_s", "useful_flops_ratio",
                 "roofline_fraction"):
        assert getattr(got, prop) == getattr(want, prop), prop


def test_h100_spec_has_the_reference_fields():
    assert [f.name for f in dataclasses.fields(HardwareSpec)] == \
        [f.name for f in dataclasses.fields(ref_hlo.HardwareSpec)]
    assert (H100_SXM.peak_flops, H100_SXM.hbm_bandwidth,
            H100_SXM.ici_bandwidth, H100_SXM.hbm_bytes,
            H100_SXM.vmem_bytes) == (989e12, 3.35e12, 450e9, 80e9,
                                     228 * 1024)


def test_cost_of_counts_a_matmul_by_hand():
    """(8, 16) @ (16, 4) in float32: 2·8·16·4 FLOPs; bytes read 8·16 + 16·4
    elements and write 8·4, 4 bytes each.  A transpose is a view and moves
    nothing; tanh and the scalar products count no FLOPs but their bytes."""
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    assert cost_of(lambda x, y: x @ y, a, b) == \
        (2.0 * 8 * 16 * 4, 4.0 * (8 * 16 + 16 * 4 + 8 * 4))
    assert cost_of(lambda x, y: x.t() @ x, a, b) == \
        (2.0 * 16 * 8 * 16, 4.0 * (8 * 16 * 2 + 16 * 16))
    flops, nbytes = cost_of(lambda x: torch.tanh(x) * 0.5, a)
    assert flops == 0.0 and nbytes == 4.0 * 8 * 16 * 4
    # the solver body of the runtime entries, one iteration at 96 x 96
    s = torch.randn(96, 96)
    flops, _ = cost_of(lambda x: torch.tanh(x @ x) * 0.5 + x * 0.5, s)
    assert flops == 2.0 * 96 ** 3


def test_runtime_phase_rehearsed():
    """chip_smoke's phase 12 on the host."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    res = cs.runtime_phase("cpu")
    assert res["launches"] == 0            # the plain version on the host
    assert set(res["decisions"]) == {"flagged", "redecided", "redecide_s",
                                     "kmeans_redecided"}
    for name in cs.RUNTIME_ENTRIES:
        ent = res["entries"][name]
        assert "rt/solver" in ent["found"]
        regions = ent["regions"]
        assert list(regions) == ["rt/embed", "rt/solver", "rt/reduce"]
        solver = regions["rt/solver"]
        assert solver["device_s"] is None
        assert solver["flops"] == 2 * 96 ** 3   # one loop body
        assert solver["bound_s"] == max(solver["flops"] / 989e12,
                                        solver["bytes"] / 3.35e12)
        assert len(solver["wall_s"]) == 4


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the runner's events and "
                    "synchronisation run there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_runner_on_the_card_synchronises_and_records_events(cuda):
    """Every timed call ends in a synchronisation, so its wall covers the
    device time its events measured; a shard running 10x the iterations
    takes longer on the device."""
    _, coll = _collect("runtime/compute-straggler", cuda)
    runner, trace = coll.runner, coll.last_trace
    assert set(runner.device_s) == set(trace.region_ids)
    wall = trace.data[WALL_TIME][0]                  # (repeats, shards, n)
    for rid, dev in runner.device_s.items():
        assert dev.shape == (4, 5) and (dev > 0).all()
        assert (wall[:, :, trace.col(rid)].T >= dev * 0.99).all()
    solver = runner.tree.by_path("rt/solver").region_id
    dev = runner.device_s[solver].min(axis=1)
    assert dev[3] > 4 * dev[:3].max()
    assert all(s.device.type == "cuda" for s in runner.final_states)


@pytest.mark.gpu
@pytest.mark.parametrize("name", RUNTIME)
def test_runtime_entry_on_the_card(cuda, name):
    r = run_entry_robust(CORPUS[name], seed=0,
                         analyzer_overrides={"device": cuda})
    assert r.passed and "rt/solver" in r.found


# each function in jax and in torch, the same program op for op
XLA_CASES = {
    "scale of tanh": (lambda x: jnp.tanh(x) * 0.5,
                      lambda x: torch.tanh(x) * 0.5),
    "sigmoid": (jax.nn.sigmoid, torch.sigmoid),
    "silu": (jax.nn.silu, torch.nn.functional.silu),
    "tanh gelu": (jax.nn.gelu,
                  lambda x: torch.nn.functional.gelu(x, approximate="tanh")),
    "square": (jnp.square, torch.square),
    "cube": (lambda x: x ** 3, lambda x: x ** 3),
    "relu": (jax.nn.relu, torch.relu),
    "where": (lambda x: jnp.where(x > 0, x, 1.0),
              lambda x: torch.where(x > 0, x, 1.0)),
    "product and scale": (lambda x: (x @ x) * 2.0, lambda x: (x @ x) * 2.0),
}


@pytest.mark.parametrize("name", sorted(XLA_CASES))
def test_costs_of_counts_flops_as_xlas_cost_analysis(name):
    """``costs_of(xla=True)`` (the dry-run's and the static analyzer's
    convention) counts a program's FLOPs as the reference's compiled
    cost analysis counts the same program's: elementwise ops too,
    transcendentals apart, the ops XLA expands as it expands them."""
    x = np.random.default_rng(0).standard_normal((32, 32)).astype(np.float32)
    ref, port = XLA_CASES[name]
    want = ref_hlo.cost_analysis_of(jax.jit(ref).lower(jnp.asarray(x))
                                    .compile())[0]
    got = costs_of(port, torch.from_numpy(x), xla=True)[0]
    assert got == want, (name, got, want)
    # the default count is the products' alone
    assert cost_of(port, torch.from_numpy(x))[0] == \
        (2.0 * 32 ** 3 if "product" in name else 0.0)
