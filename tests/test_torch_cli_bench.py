"""The port's command-line and benchmark twins against the reference's
scripts, on the CPU.

* ``repro_torch.cli.run_bench``: the five tests of
  ``tests/test_analyzer_bench.py`` mirrored at the smoke grid (entries
  positive, the JSON and its self-check, a regression flagged, unmet
  requirements skipped, missing entries rejected), the device rows with
  ``--device cpu`` and the ``meta`` of a run without a card;
* ``repro_torch.bench.analyzer_bench``'s workloads bit for bit the
  reference's;
* ``repro_torch.cli.run_corpus``: its table equals
  ``scripts/run_corpus.py``'s line for line, ``wall_s`` masked, on the
  numpy lane and the kernel lane (``--device cpu``); ``--jobs 2`` prints
  the table of ``--jobs 1``; its exit codes;
* ``repro_torch.bench.paper_tables``: every row's ``derived`` equals
  ``benchmarks/paper_tables.py``'s, on the numpy and kernel lanes;
* ``repro_torch.bench.kernel_bench``'s rows on the CPU (no kernel rows:
  a CPU tensor launches no kernel), and ``repro_torch.bench.run``'s CSV.
"""
import importlib.util
import json
import pathlib
import re
import sys

import numpy as np
import pytest
pytest.importorskip("torch")
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _ref_script(rel: str):
    """A reference script (``scripts/`` or ``benchmarks/``) as a module."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(
        "ref_" + rel.replace("/", "_")[:-3], ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_bench(capsys, *args):
    from repro_torch.cli.run_bench import main
    rc = main(list(args))
    out = capsys.readouterr()
    return rc, out.out, out.err


def _cli(capsys, *args):
    """``run_bench`` as chip_smoke's ``bench_self_check`` runs it."""
    rc, out, err = _run_bench(capsys, *args)
    return rc, out + err


# -- run_bench: the reference's five tests, mirrored -------------------------

def test_run_grid_smoke_entries_positive():
    from repro_torch.bench.analyzer_bench import run_grid
    entries = run_grid("smoke", repeat=1, device="cpu")
    assert entries
    for name, e in entries.items():
        assert e["seconds"] > 0, name
    kinds = {name.split("/")[0] for name in entries}
    assert kinds == {"cluster", "algo2", "disparity", "reducts"}
    device_rows = {n for n, e in entries.items() if "requires" in e}
    assert device_rows == {"algo2/m32/n16/kernel", "algo2/m32/n16/torch"}
    assert all(entries[n]["requires"] == "cuda" for n in device_rows)


def test_bench_writes_json_and_self_check_passes(tmp_path, capsys):
    out = tmp_path / "bench.json"
    rc, stdout, err = _run_bench(capsys, "--grid", "smoke", "--repeat", "2",
                                 "--out", str(out), "--device", "cpu")
    assert rc == 0, err
    doc = json.loads(out.read_text())
    assert doc["meta"]["grid"] == "smoke"
    assert doc["meta"]["device"] == "cpu"
    assert doc["meta"]["torch"] == torch.__version__
    assert doc["entries"]
    assert f"wrote {out}" in stdout
    # chip_smoke's phase-30 rule: a regression flagged against this
    # baseline is checked once more against a fresh one; the same row
    # regressing in both fails
    res = _chip_smoke().bench_self_check(
        lambda argv: _cli(capsys, *argv), str(out), ["--device", "cpu"])
    assert res["last"].startswith("check ok"), res
    assert set(res["checks"][-1]["ratios"]) == set(doc["entries"])


def test_check_flags_regression(tmp_path, capsys):
    out = tmp_path / "bench.json"
    rc, _, err = _run_bench(capsys, "--grid", "smoke", "--repeat", "2",
                            "--out", str(out))
    assert rc == 0, err
    doc = json.loads(out.read_text())
    for e in doc["entries"].values():
        e["seconds"] /= 100.0
    out.write_text(json.dumps(doc))
    rc, stdout, err = _run_bench(capsys, "--check", str(out),
                                 "--min-seconds", "0")
    assert rc == 1, stdout + err
    assert "REGRESSION" in stdout


def test_check_skips_entries_with_unmet_requirements(tmp_path, capsys):
    """A module that does not import, and (without a card) the device
    rows of a baseline made on one, are skipped rather than missing."""
    out = tmp_path / "bench.json"
    rc, _, err = _run_bench(capsys, "--grid", "smoke", "--repeat", "1",
                            "--out", str(out), "--device", "cpu")
    assert rc == 0, err
    doc = json.loads(out.read_text())
    doc["entries"]["seedrows/m8/n4/ghost"] = {
        "m": 8, "n": 4, "seconds": 1.0,
        "requires": "definitely_not_an_importable_module"}
    out.write_text(json.dumps(doc))
    rc, stdout, err = _run_bench(capsys, "--check", str(out))
    assert rc == 0, stdout + err
    assert "unmet requirements" in stdout
    if not torch.cuda.is_available():
        assert "algo2/m32/n16/torch" in stdout


def test_check_rejects_missing_entries(tmp_path, capsys):
    out = tmp_path / "bench.json"
    rc, _, err = _run_bench(capsys, "--grid", "smoke", "--repeat", "1",
                            "--out", str(out))
    assert rc == 0, err
    doc = json.loads(out.read_text())
    doc["entries"]["algo2/m999999/n1"] = {"m": 999999, "n": 1,
                                          "seconds": 1.0}
    out.write_text(json.dumps(doc))
    rc, _, _ = _run_bench(capsys, "--check", str(out))
    assert rc == 2


def test_meta_of_a_run_without_a_card(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "bench.json"
    rc, _, err = _run_bench(capsys, "--grid", "smoke", "--repeat", "1",
                            "--out", str(out))
    assert rc == 0, err
    meta = json.loads(out.read_text())["meta"]
    assert meta["device"] is None and meta["card"] is None
    assert meta["device_rows"].startswith("left out")
    assert not any("requires" in e for e in
                   json.loads(out.read_text())["entries"].values())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run_bench(capsys, "--grid", "smoke", "--device", "cuda")


def test_workloads_equal_the_references_bit_for_bit():
    ref = _ref_script("benchmarks/analyzer_bench.py")
    from repro_torch.bench import analyzer_bench as port
    for m, n in [(8, 16), (2048, 128), (100, 7)]:
        for seed in (0, 3):
            assert np.array_equal(port.cluster_workload(m, n, seed),
                                  ref.cluster_workload(m, n, seed))
            pt, pT, prids = port.algo2_workload(m, n, seed)
            rt, rT, rrids = ref.algo2_workload(m, n, seed)
            assert np.array_equal(pT, rT) and prids == rrids
            assert [r.path for r in pt.regions()] == \
                [r.path for r in rt.regions()]
    for n in (16, 512):
        pt, pv, prids = port.disparity_workload(n, 2)
        rt, rv, rrids = ref.disparity_workload(n, 2)
        assert np.array_equal(pv, rv) and prids == rrids
    for a in (5, 14):
        p = port.reducts_workload(a, seed=1)
        r = ref.reducts_workload(a, seed=1)
        assert (p.attributes, p.rows, p.decisions) == \
            (r.attributes, r.rows, r.decisions)
    assert port.GRIDS == ref.GRIDS


# -- run_corpus ---------------------------------------------------------------

WALL = re.compile(r" +\d+\.\d{3}  (ok|FAIL)$")


def _masked(text: str) -> list:
    return [WALL.sub(r" WALL  \1", line) for line in text.splitlines()]


@pytest.fixture(scope="module")
def ref_corpus_table():
    import contextlib
    import io
    ref = _ref_script("scripts/run_corpus.py")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ref.main(["--backend", "synthetic"])
    assert rc == 0
    return buf.getvalue()


@pytest.mark.parametrize("lane", [["--distance-backend", "numpy"],
                                  ["--device", "cpu"]],
                         ids=["numpy", "kernel-cpu"])
def test_run_corpus_table_equals_the_reference_scripts(
        lane, ref_corpus_table, capsys):
    from repro_torch.cli.run_corpus import main
    assert main(["--backend", "synthetic", *lane]) == 0
    got = capsys.readouterr().out
    assert _masked(got) == _masked(ref_corpus_table)
    assert "19/19 entries passed (seed 0)" in got


def test_run_corpus_jobs_print_the_sequential_table(capsys):
    from repro_torch.cli.run_corpus import main
    argv = ["--backend", "synthetic", "--distance-backend", "torch",
            "--device", "cpu"]
    assert main(argv) == 0
    one = capsys.readouterr().out
    assert main(argv + ["--jobs", "2"]) == 0
    two = capsys.readouterr().out
    assert _masked(one) == _masked(two)
    assert "19/19 entries passed" in two


def test_run_corpus_exit_codes(capsys):
    from repro_torch.cli.run_corpus import main
    assert main(["--entry", "no/such-entry"]) == 2
    assert main(["--jobs", "0"]) == 2
    assert main(["--list", "--backend", "synthetic"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 19
    with pytest.raises(SystemExit) as e:
        main(["--distance-backend", "pallas"])
    assert e.value.code == 2


# -- paper tables, kernel bench, the harness ----------------------------------

@pytest.fixture(scope="module")
def ref_paper_rows():
    return _ref_script("benchmarks/paper_tables.py").all_rows()


@pytest.mark.parametrize("lane,device", [("numpy", None), ("kernel", "cpu")])
def test_paper_tables_derive_the_references_results(lane, device,
                                                    ref_paper_rows):
    from repro_torch.bench import paper_tables
    got = paper_tables.all_rows(lane, device)
    assert [(n, d) for n, _, d in got] == \
        [(n, d) for n, _, d in ref_paper_rows]
    assert all(us > 0 for _, us, _ in got)


def test_kernel_bench_rows_on_the_cpu(monkeypatch):
    """On the CPU each kernel's plain and library rows (no kernel row: a
    CPU tensor launches no kernel), each function called once here."""
    from repro_torch.bench import kernel_bench as kb

    def once(fn, iters, device):
        assert device.type == "cpu" and iters >= 1
        fn()
        return 1.0

    monkeypatch.setattr(kb, "per_call_us", once)
    rows = kb.all_rows("cpu")
    assert [r[0] for r in rows] == [
        "attn_plain_S256", "attn_library_S256",
        "attn_plain_S1024", "attn_library_S1024",
        "wkv6_plain_T512",
        "rmsnorm_plain_1x3072", "rmsnorm_library_1x3072",
        "rmsnorm_plain_256x3072", "rmsnorm_library_256x3072",
        "seedrows_plain_m16384_n128_k1", "seedrows_library_m16384_n128_k1",
        "seedrows_plain_m16384_n128_k8", "seedrows_library_m16384_n128_k8",
        "train_step_smoke"]
    derived = dict((n, d) for n, _, d in rows)
    assert derived["attn_plain_S256"] == \
        f"gflops={4.0 * 4 * 256 * 256 * 64 / 2 / 1e3:.2f}"
    assert derived["train_step_smoke"] == f"tokens_per_s={256e6:.0f}"


def test_kernel_rows_raise_unless_the_kernel_launched(monkeypatch):
    """A kernel row (timed on a card, pretended here) whose function
    launched nothing raises; one that launched is kept."""
    from types import SimpleNamespace

    from repro_torch import kernels as K
    from repro_torch.bench import kernel_bench as kb
    monkeypatch.setattr(kb, "per_call_us",
                        lambda fn, iters, device: (fn(), 1.0)[1])
    monkeypatch.setitem(K.LAUNCHES, "rmsnorm", 0)
    card = SimpleNamespace(type="cuda")
    with pytest.raises(AssertionError, match="never launched"):
        kb._rows("rmsnorm", "1x8", card, {"kernel": lambda: None}, 1, str)

    def launch():
        K.LAUNCHES["rmsnorm"] += 1

    assert kb._rows("rmsnorm", "1x8", card, {"kernel": launch}, 1, str) \
        == [("rmsnorm_kernel_1x8", 1.0, "1.0")]


def test_bench_run_prints_csv(capsys):
    from repro_torch.bench.run import main
    assert main(["--only", "paper", "--lane", "torch", "--device", "cpu"]) \
        == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    names = [line.split(",", 2)[0] for line in lines[1:]]
    assert names[0] == "fig9_st_dissimilarity" and len(names) == 15
    for line in lines[1:]:
        assert float(line.split(",", 2)[1]) > 0
    with pytest.raises(SystemExit):
        main(["--only", "no-such-section"])
    assert main(["--only", "roofline", "--results",
                 "no-such-dir/*.json"]) == 0
    assert capsys.readouterr().out.splitlines()[1].startswith(
        "roofline_summary,0.0,no dry-run results found")
    with pytest.raises(SystemExit):
        main(["--help"])
    assert "roofline" in capsys.readouterr().out


# -- chip_smoke's phases 30 and 31, rehearsed on the host ---------------------

def test_chip_smoke_cli_phase_rehearsed():
    cs = _chip_smoke()
    res = cs.cli_twins_phase("cpu", grid="smoke", jobs=2)
    assert set(res["device_rows_ms"]) == {"algo2/m32/n16/kernel",
                                          "algo2/m32/n16/torch"}
    assert res["meta"]["device"] == "cpu"
    assert res["check"].startswith("check ok")


def _fake_check(base, tmp_path, rows):
    """A fake ``run_bench`` for ``bench_self_check``: a baseline run
    writes ``base``; the k-th ``--check`` writes its baseline's times
    scaled by ``rows[k]`` (row -> factor) and flags each row scaled above
    2 as the CLI does."""
    def write(path, times, meta=None):
        pathlib.Path(path).write_text(json.dumps(
            {"meta": meta or {}, "entries": {n: {"seconds": t}
                                             for n, t in times.items()}}))

    path = str(tmp_path / "bench.json")
    write(path, base, {"grid": "smoke", "repeat": 2})
    calls = []

    def run(argv):
        calls.append(argv)
        out = argv[argv.index("--out") + 1]
        if "--check" not in argv:
            write(out, base)
            return 0, f"wrote {out}\n"
        scale = rows[sum("--check" in c for c in calls) - 1]
        now = {n: t * scale.get(n, 1.0) for n, t in base.items()}
        write(out, now)
        flagged = [f"{n}: {base[n] * 1e3:.3f} ms -> {now[n] * 1e3:.3f} ms "
                   f"({now[n] / base[n]:.2f}x)  REGRESSION"
                   for n in sorted(base) if now[n] / base[n] > 2.0]
        if flagged:
            return 1, "\n".join(flagged) + "\n1 entries regressed\n"
        return 0, "check ok: no entry regressed more than 2.0x\n"

    return path, run, calls


def test_phase30_check_takes_a_regression_again(tmp_path):
    """Fault 9's pin: phase 30's ``--check`` read one host-bound row at
    2.05x on unchanged code.  A row flagged by one check and clean against
    a fresh baseline passes, every ratio of both checks kept; the same
    row flagged twice fails; a clean first check is not taken again."""
    cs = _chip_smoke()
    base = {"algo2/m32/n16": 0.01, "seedrows/m8/n4/numpy": 0.004}
    path, run, calls = _fake_check(
        base, tmp_path, [{"algo2/m32/n16": 2.05}, {}])
    res = cs.bench_self_check(run, path, ["--device", "cpu"])
    assert len(calls) == 3 and calls[0][:2] == ["--check", path]
    fresh = calls[1][calls[1].index("--out") + 1]
    assert calls[1][:4] == ["--grid", "smoke", "--repeat", "2"]
    assert calls[2][:2] == ["--check", fresh] and fresh != path
    assert all(c[-2:] == ["--device", "cpu"] for c in calls)
    assert [c["rc"] for c in res["checks"]] == [1, 0]
    assert res["checks"][0]["regressed"] == ["algo2/m32/n16"]
    assert res["checks"][0]["ratios"] == pytest.approx(
        {"algo2/m32/n16": 2.05, "seedrows/m8/n4/numpy": 1.0})
    assert res["checks"][1]["regressed"] == []
    assert res["last"].startswith("check ok")

    path, run, calls = _fake_check(
        base, tmp_path, [{"algo2/m32/n16": 2.05}, {"algo2/m32/n16": 2.4}])
    with pytest.raises(AssertionError, match="regressed in both"):
        cs.bench_self_check(run, path)

    path, run, calls = _fake_check(
        base, tmp_path, [{"algo2/m32/n16": 2.05},
                         {"seedrows/m8/n4/numpy": 3.0}])
    res = cs.bench_self_check(run, path)
    assert [c["regressed"] for c in res["checks"]] == \
        [["algo2/m32/n16"], ["seedrows/m8/n4/numpy"]]
    assert res["last"].startswith("check ok")

    path, run, calls = _fake_check(base, tmp_path, [{}])
    assert len(cs.bench_self_check(run, path)["checks"]) == 1
    assert len(calls) == 1


def test_chip_smoke_bench_phase_rehearsed():
    """Phase 31's paper tables on the three lanes, in process (the kernel
    bench and the examples have their own tests here)."""
    cs = _chip_smoke()
    res = cs.bench_examples_phase("cpu", kernels=False, examples=())
    assert set(res["paper_s"]) == {"numpy", "kernel", "torch"}
    assert res["derived"]["fig9_st_dissimilarity"] == \
        "clusters=5;CCCR=[11];severity=0.9752"


def test_chip_smoke_bench_parsers():
    cs = _chip_smoke()
    rows = cs.csv_rows("name,us_per_call,derived\n"
                       "fig12,12.5,very_high=[8, 11, 14];CCCR=[8, 11]\n"
                       "x,1.0,\n")
    assert rows == [("fig12", 12.5, "very_high=[8, 11, 14];CCCR=[8, 11]"),
                    ("x", 1.0, "")]
    with pytest.raises(AssertionError, match="no CSV header"):
        cs.csv_rows("oops\n")
    line = "st/io-hotspot-cr8   disparity   1.00   1.00   1.00       -" \
        "       -       -       -   0.006  ok"
    assert cs.corpus_table(line) == [line.replace("   0.006  ok",
                                                  " WALL  ok")]
    with pytest.raises(AssertionError, match="exited"):
        cs.child(["repro_torch.cli.run_corpus", "--jobs", "0"])
    with pytest.raises(AssertionError, match="returned 2"):
        cs.in_process("repro_torch.cli.run_corpus", ["--jobs", "0"])
    printed = cs.in_process("repro_torch.examples.st_scenario",
                            ["--device", "cpu"])
    assert printed.startswith("===== ST, original =====")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
