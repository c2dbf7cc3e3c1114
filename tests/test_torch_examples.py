"""The port's examples (``python -m repro_torch.examples.<name>``) at their
smallest sizes on the CPU: ``st_scenario`` and ``fault_corpus_demo``
print the reference scripts' reports (on the numpy, kernel and torch
lanes), ``quickstart``, ``train_100m`` and ``moe_imbalance`` run their
trainers and analyses; without a card every default fails."""
import contextlib
import importlib.util
import io
import json
import math
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
LANES = [["--distance-backend", "numpy"], ["--device", "cpu"],
         ["--distance-backend", "torch", "--device", "cpu"]]
LANE_IDS = ["numpy", "kernel-cpu", "torch-cpu"]


def _ref_output(name: str, run=lambda mod: mod.main()) -> str:
    """What the reference's ``examples/<name>.py`` prints when ``run``
    drives it."""
    spec = importlib.util.spec_from_file_location(
        f"ref_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(mod)
    return buf.getvalue()


@pytest.fixture(scope="module")
def ref_st():
    return _ref_output("st_scenario")


@pytest.mark.parametrize("lane", LANES, ids=LANE_IDS)
def test_st_scenario_prints_the_references_report(lane, ref_st, capsys):
    from repro_torch.examples.st_scenario import main
    main(lane)
    assert capsys.readouterr().out == ref_st


@pytest.mark.parametrize("lane", LANES[1:], ids=LANE_IDS[1:])
def test_fault_corpus_demo_prints_the_references_report(lane, capsys):
    from repro_torch.examples.fault_corpus_demo import main
    names = ["st/io-hotspot-cr8", "npar1way/compute-hotspot-cr3"]
    want = _ref_output("fault_corpus_demo",
                       lambda mod: [mod.show(n) for n in names])
    main([*names, *lane])
    assert capsys.readouterr().out == want
    with pytest.raises(SystemExit, match="unknown entry"):
        main(["no/such-entry", *lane])


def test_quickstart_trains_and_reports(capsys):
    from repro_torch.examples.quickstart import main
    main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("trained 30 steps: loss ")
    assert "=== Performance similarity ===" in out
    assert "=== Code-region disparity (k-means severity) ===" in out


def test_train_100m_smoke_resumes(tmp_path, capsys):
    from repro_torch.examples.train_100m import main
    argv = ["--smoke", "--steps", "4", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path / "ckpt"), "--device", "cpu"]
    main(argv)
    first = json.loads(capsys.readouterr().out.splitlines()[-1])
    from repro_torch.configs import get_arch
    from repro_torch.models import family_module
    cfg = get_arch("st-100m").smoke
    model = family_module(cfg).init(cfg, 0, "cpu")
    assert first["params"] == sum(p.numel() for p in model.parameters())
    main(argv)
    out = capsys.readouterr().out
    assert out.startswith("resumed from step 4")
    assert "step     4  loss" in out


def test_moe_imbalance_reports_expert_load(capsys):
    from repro_torch.examples.moe_imbalance import main, run
    main(["--steps", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "expert-load clusters (early steps): " in out
    assert out.count("load CV: start ") == 2
    rep, cv_start, cv_end, loss = run(0.0, steps=4, device="cpu")
    assert rep is not None and rep.baseline.n_clusters >= 1
    assert cv_start >= 0 and cv_end >= 0 and math.isfinite(loss)


@pytest.mark.parametrize("name,argv", [
    ("st_scenario", []), ("fault_corpus_demo", []), ("quickstart", []),
    ("train_100m", ["--smoke", "--steps", "1"]), ("moe_imbalance", [])])
def test_examples_need_the_card_by_default(name, argv, monkeypatch):
    """Without ``--device`` each example runs on the card, and on a
    machine without one it raises rather than fall back."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"repro_torch.examples.{name}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
