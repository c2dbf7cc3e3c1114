"""The port's five spool ``chaos/*`` corpus entries at the gate seeds {0,
1, 7}, every analyzer on the kernel lane's plain version
(``device="cpu"``): each entry passes, and its outcome — survival,
quarantine, adoption, degraded and shed windows, the stall, the clean-
vs-chaos window comparison and the flagged verdict — equals the one the
reference's own run of the same entry reports. (The sixth, the checkpoint
entry, is held to the reference in tests/test_torch_checkpoint.py.)"""
import dataclasses
import importlib.util
import pathlib

import pytest

from repro.scenarios.corpus import CORPUS as REF_CORPUS
from repro.scenarios.corpus import run_entry as ref_run_entry
from repro_torch.scenarios.corpus import CORPUS, corpus_entries, run_entry

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
ENTRIES = [e.name for e in corpus_entries(backend="chaos")
           if e.name != "chaos/corrupt-latest-checkpoint"]
OUTCOME = ("survived", "quarantined", "adopted", "degraded", "stalled",
           "shed", "matched", "comparable", "mismatched")


def test_the_chaos_entries():
    assert len(ENTRIES) == 5
    for name in ENTRIES:
        assert dataclasses.asdict(CORPUS[name].chaos) == \
            dataclasses.asdict(REF_CORPUS[name].chaos)


@pytest.mark.parametrize("seed", (0, 1, 7))
@pytest.mark.parametrize("name", ENTRIES)
def test_entry_passes_with_the_reference_outcome(name, seed):
    r = run_entry(CORPUS[name], seed=seed,
                  analyzer_overrides={"device": "cpu"})
    assert r.chaos_ok, f"{name}@{seed}: {r.chaos_failures}"
    assert r.passed, (f"{name}@{seed}: recall={r.recall} "
                      f"precision={r.precision} causes={r.cause_recall}")
    ref = ref_run_entry(REF_CORPUS[name], seed=seed)
    got, want = r.chaos_outcome, ref.chaos_outcome
    assert {k: getattr(got, k) for k in OUTCOME} == \
        {k: getattr(want, k) for k in OUTCOME}
    # chip_smoke's phase 14 holds the card's runs to this row
    assert tuple(getattr(want, k) for k in CS.CHAOS_FIELDS) == \
        CS.CHAOS_OUTCOMES[name]
    assert got.verdict.doc() == want.verdict.doc()
    assert (r.found, r.precision, r.recall, r.cause_recall) == \
        (ref.found, ref.precision, ref.recall, ref.cause_recall)


def test_chaos_phase_rehearsed():
    """chip_smoke's phase 14 on the host at one seed: every chaos and
    fleet entry with its outcome row."""
    res = CS.chaos_phase("cpu", seeds=(0,))
    assert res["runs"] == len(CS.CHAOS_OUTCOMES) == 8
    assert res["launches"] == 0            # the plain version on the host
    assert res["decisions"]["redecided"] >= 0
