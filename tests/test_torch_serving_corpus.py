"""The port's serving cost model and serving corpus against the
reference's.

``CostModelBackend`` is numpy only, with the reference's salt, noise-draw
order and float arithmetic, so a served trace equals the reference's bit
for bit: every metric array, the header and the saved artifact's bytes.
The five ``serving/*`` entries at the gate seeds {0, 1, 7} give the
reference's ``Verdict.doc()``, completed requests and onset window (the
analyzers on the kernel lane's plain version, ``device="cpu"``, and on the
exact lane).  chip_smoke's phase 18 is rehearsed at seed 0."""
import dataclasses
import gc
import importlib.util
import pathlib

import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from repro.scenarios import traffic as ref_traffic
from repro.scenarios.corpus import CORPUS as REF_CORPUS
from repro.scenarios.corpus import run_entry as ref_run_entry
from repro.serve import CostModelBackend as RefBackend
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.scenarios import traffic
from repro_torch.scenarios.corpus import CORPUS, corpus_entries, run_entry
from repro_torch.serve import (CostModelBackend, ServeConfig, ServeEngine,
                               serving_analyzer_meta)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENTRIES = [e.name for e in corpus_entries(backend="serving")]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """PyTorch's CPU ops on one thread for this module: the corpus entries
    and trainers here time regions by the wall clock, and tests run in
    parallel workers, each of which would otherwise start a thread per
    core for every op."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TRAFFIC = {
    "saturated": lambda T: T.saturated_sessions(4, 4),
    "staggered-hot": lambda T: T.saturated_sessions(4, 3, stagger=1,
                                                    hot=True),
    "long-tail": lambda T: T.saturated_sessions(
        4, 4, tail_lane=3, tail_prompt_len=64, tail_gen_len=24),
    "generated": lambda T: T.generate_traffic(T.TrafficConfig(
        n_requests=12, hot_fraction=0.3, sessions=2), seed=5),
}


@pytest.mark.parametrize("experts", [0, 4])
@pytest.mark.parametrize("name", sorted(TRAFFIC))
@pytest.mark.parametrize("seed", [0, 7])
def test_cost_model_trace_is_the_references_bit_for_bit(tmp_path, name,
                                                        experts, seed):
    runs = []
    for Backend, Config, Engine, T, tag in (
            (CostModelBackend, ServeConfig, ServeEngine, traffic, "port"),
            (RefBackend, RefServeConfig, RefServeEngine, ref_traffic,
             "ref")):
        backend = Backend(lanes=4, moe_experts=experts, seed=seed)
        path = str(tmp_path / f"{tag}.npz")
        eng = Engine(Config(lanes=4, max_len=96, prefill_chunk=8,
                            max_steps=48, trace_path=path,
                            trace_meta=serving_analyzer_meta(
                                {"threshold_frac": 0.3})),
                     TRAFFIC[name](T), backend)
        eng.run()
        runs.append((eng, path))
    (port, ppath), (ref, rpath) = runs
    assert port.completed == ref.completed
    assert port.trace.meta == ref.trace.meta
    assert sorted(port.trace.data) == sorted(ref.trace.data)
    for k in ref.trace.data:
        np.testing.assert_array_equal(port.trace.data[k], ref.trace.data[k])
    assert pathlib.Path(ppath).read_bytes() == \
        pathlib.Path(rpath).read_bytes()


def test_the_serving_entries_are_the_references():
    assert ENTRIES == sorted(n for n in REF_CORPUS
                             if n.startswith("serving/"))
    for name in ENTRIES:
        e, ref = CORPUS[name], REF_CORPUS[name]
        assert (e.app, e.backend, dataclasses.asdict(e.truth),
                e.analyzer_kw, e.min_precision, e.expect_onset_window,
                e.onset_window_steps, e.onset_persist,
                dataclasses.asdict(e.serving)) == \
            (ref.app, ref.backend, dataclasses.asdict(ref.truth),
             ref.analyzer_kw, ref.min_precision, ref.expect_onset_window,
             ref.onset_window_steps, ref.onset_persist,
             dataclasses.asdict(ref.serving))


@pytest.mark.parametrize("seed", (0, 1, 7))
@pytest.mark.parametrize("name", ENTRIES)
def test_entry_gives_the_reference_verdict(name, seed):
    want = ref_run_entry(REF_CORPUS[name], seed=seed)
    for lane in ({"device": "cpu"}, {"distance_backend": "numpy"}):
        r = run_entry(CORPUS[name], seed=seed, analyzer_overrides=lane)
        assert r.passed, (name, seed, lane, sorted(r.found), r.completed)
        assert r.verdict.doc() == want.verdict.doc()
        assert (r.completed, r.onset_window, r.found, r.precision) == \
            (want.completed, want.onset_window, want.found, want.precision)
        assert r.completed == CORPUS[name].serving.min_completed


def test_new_entries_phase_rehearsed():
    """chip_smoke's phase 18 on the host at one seed: the nine entries of
    the slice, each with the reference's outcome."""
    cs = _chip_smoke()
    assert set(cs.NEW_ENTRIES) == set(ENTRIES) | {
        "train/fwdbwd-straggler-smoke", "train/straggler-remesh-recovery",
        "train/ckpt-stall-reschedule-recovery",
        "chaos/corrupt-latest-checkpoint"}
    res = cs.new_entries_phase("cpu", seeds=(0,))
    assert len(res["runs"]) == 9
    assert res["launches"]["rmsnorm"] == 0         # plain versions here
    assert res["runs"]["chaos/corrupt-latest-checkpoint@0"][
        "restored_step"] == 2
    assert res["runs"]["train/straggler-remesh-recovery@0"]["action"] == \
        "remesh"


def test_chip_smoke_freezes_the_heap_around_its_corpus_phases():
    """The corpus phases run with the earlier phases' objects frozen, so
    a full collection inside an entry scans only the entry's own (one
    over phase 17's objects, timed inside a healthy shard, read as a
    straggler there); after the block they can be collected again."""
    cs = _chip_smoke()
    with cs.heap_frozen():
        assert gc.get_freeze_count() > 0
    assert gc.get_freeze_count() == 0
