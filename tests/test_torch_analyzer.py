"""The port end to end against the reference: ``Verdict.doc()`` of the
port equals ``repro``'s on the paper's three scenarios and on a
fleet-shaped trace, on both lanes (the exact ``"numpy"`` lane and the
``"kernel"`` lane run on the CPU through the kernel's plain version); the
port's 19-entry synthetic snapshot equals the committed
``VERDICTS_synthetic.json`` on both lanes; the CLI twins agree with the
reference scripts; and chip_smoke's phases are rehearsed at a small size.
Verdicts are compared exactly."""
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro.core import AutoAnalyzer as RefAnalyzer
from repro.core import RegionTrace as RefTrace
from repro.scenarios import mpibzip2_scenario as ref_bzip
from repro.scenarios import npar1way_scenario as ref_npar
from repro.scenarios import st_scenario as ref_st
pytest.importorskip("torch")
from repro_torch.core import AutoAnalyzer, RegionTrace, render
from repro_torch.scenarios import (mpibzip2_scenario, npar1way_scenario,
                                   st_fine_scenario, st_scenario)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LANES = [dict(distance_backend="numpy"),
         dict(distance_backend="kernel", device="cpu")]
LANE_IDS = ["numpy", "kernel-cpu"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCENARIOS = {
    "st": (ref_st, st_scenario),
    "st-optimized": (lambda: ref_st(optimize_dissimilarity=True),
                     lambda: st_scenario(optimize_dissimilarity=True)),
    "npar1way": (ref_npar, npar1way_scenario),
    "mpibzip2": (ref_bzip, mpibzip2_scenario),
}


@pytest.mark.parametrize("lane", LANES, ids=LANE_IDS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_paper_scenario_verdicts_match_reference(name, lane):
    ref_build, port_build = SCENARIOS[name]
    ref_tree, ref_rm = ref_build()
    tree, rm = port_build()
    for k in ref_rm.data:
        np.testing.assert_array_equal(rm.data[k], ref_rm.data[k])
    want = RefAnalyzer(ref_tree).analyze(ref_rm)
    got = AutoAnalyzer(tree, **lane).analyze(rm)
    assert got.verdict.doc() == want.verdict.doc()
    assert got.dissimilarity.severity == want.dissimilarity.severity
    assert got.disparity.severities == want.disparity.severities
    assert got.verdict.fingerprint() == want.verdict.fingerprint()


def test_paper_st_results():
    """The paper's ST findings (Fig. 9/12, Tables 3/4) on the port."""
    tree, rm = st_scenario()
    res = AutoAnalyzer(tree, device="cpu").analyze(rm)
    assert res.dissimilarity.baseline.n_clusters == 5
    assert res.dissimilarity.cccrs == [11]
    assert res.dissimilarity_causes == [frozenset({"flops"})]
    assert sorted(res.disparity.cccrs) == [8, 11]
    assert res.disparity_causes == [frozenset({"hbm_intensity",
                                               "host_bytes"})]
    tree, rm = st_fine_scenario()
    res = AutoAnalyzer(tree, device="cpu").analyze(rm)
    assert res.dissimilarity.cccrs == [21]
    assert "cluster" in render(tree, res)


@pytest.mark.parametrize("lane", LANES, ids=LANE_IDS)
def test_fleet_shaped_trace_matches_reference(lane, tmp_path):
    """m=256 shards x n=32 regions with a 32-shard straggler and an I/O
    hotspot, saved by the port and analyzed by both packages."""
    cs = _chip_smoke()
    _, col, planted = cs.fleet_collector(256, 32, 32)
    path = col.collect_trace().save(str(tmp_path / "fleet.npz"))
    ref_trace = RefTrace.load(path)
    trace = RegionTrace.load(path)
    want = RefAnalyzer(ref_trace.tree()).analyze_trace(ref_trace)
    got = AutoAnalyzer(trace.tree(), **lane).analyze_trace(trace)
    assert got.verdict.doc() == want.verdict.doc()
    assert got.dissimilarity.severity == want.dissimilarity.severity
    named = set(want.verdict.dissimilarity_paths) | \
        set(want.verdict.disparity_paths)
    assert set(planted) <= named


def test_fleet_shaped_trace_flags_no_candidacy(tmp_path):
    """The kernel lane re-decides only candidacies its float32 error bound
    cannot settle; a fleet-shaped trace, whose clusters stand far apart,
    has none.  The paper's ST scenario has one clustering with 7 (its
    synthetic vectors sit on the radius)."""
    cs = _chip_smoke()
    _, col, _ = cs.fleet_collector(256, 32, 32)
    trace = col.collect_trace()
    an = AutoAnalyzer(trace.tree(), distance_backend="kernel", device="cpu")
    an.analyze_trace(trace)
    assert an.decisions == {"flagged": 0, "redecided": 0, "redecide_s": 0.0,
                            "kmeans_redecided": 0}
    tree, rm = st_scenario()
    an = AutoAnalyzer(tree, distance_backend="kernel", device="cpu")
    an.analyze(rm)
    assert (an.decisions["flagged"], an.decisions["redecided"]) == (7, 1)
    assert AutoAnalyzer(trace.tree(), distance_backend="numpy").decisions \
        is None


@pytest.mark.parametrize("lane", LANES, ids=LANE_IDS)
def test_synthetic_snapshot_equals_committed_verdicts(lane):
    from repro_torch.cli.snapshot_verdicts import drift, snapshot
    with open(ROOT / "VERDICTS_synthetic.json") as f:
        baseline = json.load(f)
    current = snapshot(0, lane["distance_backend"], lane.get("device"))
    assert set(current) == set(baseline)
    assert drift(baseline, current) == []


@pytest.mark.parametrize("lane", LANES, ids=LANE_IDS)
def test_corpus_entries_pass(lane):
    from repro_torch.scenarios import corpus_entries, run_entry
    results = [run_entry(e, seed=7, analyzer_overrides=lane)
               for e in corpus_entries(backend="synthetic")]
    assert len(results) == 19
    failed = [r.entry.name for r in results if not r.passed]
    assert not failed
    onset = [r for r in results if r.entry.expect_onset_window is not None]
    assert [r.onset_window for r in onset] == [2]


def test_default_analyzer_runs_on_the_card_or_raises():
    import torch
    from repro_torch.core import RegionTree
    tree = RegionTree("x")
    if torch.cuda.is_available():
        assert AutoAnalyzer(tree).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AutoAnalyzer(tree)
    assert AutoAnalyzer(tree, distance_backend="numpy").device is None


# -- command-line twins -----------------------------------------------------

def _main_json(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


def test_analyze_trace_cli_matches_reference_script(tmp_path, capsys):
    from repro.scenarios import CORPUS
    from repro_torch.cli import analyze_trace
    spec = importlib.util.spec_from_file_location(
        "ref_analyze_trace", ROOT / "scripts" / "analyze_trace.py")
    ref_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_cli)
    _, col = CORPUS["st/triple-straggler-thrash-stall"].build(1)
    trace = col.collect_trace()
    trace.meta["analyzer_kw"] = {"similarity_metric": "wall_time"}
    path = trace.save(str(tmp_path / "t.npz"))
    want = _main_json(ref_cli.main, [path, "--json"], capsys)
    for lane in (["--distance-backend", "numpy"], ["--device", "cpu"]):
        got = _main_json(analyze_trace.main, [path, "--json", *lane],
                         capsys)
        assert got == want
    assert analyze_trace.main([path, "--per-window", "1",
                               "--device", "cpu"]) == 0
    assert "Performance similarity" in capsys.readouterr().out
    assert analyze_trace.main([str(tmp_path / "absent.npz")]) == 3
    (tmp_path / "bad.npz").write_bytes(b"junk")
    assert analyze_trace.main([str(tmp_path / "bad.npz")]) == 4


def test_snapshot_cli_check_and_write(tmp_path, capsys):
    from repro_torch.cli import snapshot_verdicts
    baseline = str(ROOT / "VERDICTS_synthetic.json")
    assert snapshot_verdicts.main(["--check", baseline,
                                   "--distance-backend", "numpy"]) == 0
    assert "19 baseline entries bit-identical" in capsys.readouterr().out
    out = tmp_path / "snap.json"
    assert snapshot_verdicts.main([str(out), "--device", "cpu"]) == 0
    assert json.loads(out.read_text()) == \
        json.loads((ROOT / "VERDICTS_synthetic.json").read_text())


def test_cli_runs_as_a_module():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.cli.snapshot_verdicts", "--check",
                        str(ROOT / "VERDICTS_synthetic.json"),
                        "--device", "cpu"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


# -- chip_smoke rehearsal ----------------------------------------------------

def test_chip_smoke_phases_rehearsed_on_cpu():
    cs = _chip_smoke()
    err = cs.check_kernel(*cs.RAGGED, "cpu")
    assert err["max_ratio_f64"] <= cs.C_F64
    assert err["max_ratio_plain"] <= cs.C_PLAIN
    corpus = cs.corpus_phase("cpu")
    assert corpus["entries"] == 19
    # On the CPU the wrapper launches nothing: no seed counts.
    assert corpus["seed_counts"] == {}
    assert set(corpus["decisions"]) == {"flagged", "redecided",
                                        "redecide_s", "kmeans_redecided"}
    pin = cs.fault_pin_phase("cpu")
    assert pin["n_clusters"] == 2 and pin["redecided"] >= 1
    fleet = cs.fleet_phase(512, 32, 64, "cpu")
    assert fleet["planted_named"]
    assert fleet["dissimilarity_ccrs"] == [fleet["planted"][0]]
    assert fleet["decisions"]["redecided"] == 0
    ms, by = cs.bound_ms(16384, 128, 8)
    assert by == "bytes" and abs(ms - 8978464 / 3.35e12 * 1e3) < 1e-12
