"""The port's checkpoints against the reference's: the same files, names
and keys, so a checkpoint written by either package restores in the other
to equal arrays (bit for bit: both store the arrays as they are) and each
verifies the other's ``integrity.json``.  Also mirrors of the reference's
checkpoint tests (tests/test_train_and_ckpt.py::TestCheckpoint, the
checkpoint parts of tests/test_chaos.py) on the port, and the chaos entry
``chaos/corrupt-latest-checkpoint`` at the gate seeds {0, 1, 7} with the
reference's outcome (the same fallback step, the same skip record, the
fallback state restored exactly)."""
import json
import os
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import build as ref_build
from repro.optim import init_opt_state as ref_init_opt_state
from repro.scenarios.corpus import CORPUS as REF_CORPUS
from repro.scenarios.corpus import run_entry as ref_run_entry
from repro.train import checkpoint as ref_ckpt
from repro_torch.configs import get_arch
from repro_torch.core import faultpoints as FP
from repro_torch.core.faultpoints import InjectedCrash
from repro_torch.data import DataConfig
from repro_torch.models.convert import params_to_numpy
from repro_torch.optim import AdamWConfig
from repro_torch.scenarios.corpus import CORPUS, run_entry
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train import checkpoint as ckpt

CFG = get_arch("st-100m").smoke
CHAOS_ENTRY = "chaos/corrupt-latest-checkpoint"


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


def _trained(d, steps=2):
    t = Trainer(CFG, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
                DataConfig(seq_len=16, global_batch=2, vocab=CFG.vocab),
                TrainerConfig(steps=steps, ckpt_dir=d, ckpt_every=0),
                device="cpu")
    t.run()
    return t


def _ref_templates():
    params, _ = ref_build(ref_arch("st-100m").smoke).init(jax.random.key(1))
    return {"params": params, "opt_state": ref_init_opt_state(params)}


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    d = str(tmp_path)
    t = _trained(d)
    assert ref_ckpt.verify_step(d, 2) is None
    step, trees = ref_ckpt.restore(d, _ref_templates())
    assert step == 2
    for got, want in ((trees["params"], params_to_numpy(t.params, CFG)),
                      (trees["opt_state"]["m"],
                       params_to_numpy(t.opt_state["m"], CFG)),
                      (trees["opt_state"]["v"],
                       params_to_numpy(t.opt_state["v"], CFG))):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), b)
    assert int(trees["opt_state"]["step"]) == 2
    assert trees["opt_state"]["step"].dtype == jnp.int32


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    d = str(tmp_path)
    ref = _ref_templates()
    ref_ckpt.save(d, 5, ref, meta={"config": "st-smoke"})
    assert ckpt.verify_step(d, 5) is None
    t = Trainer(CFG, AdamWConfig(), DataConfig(vocab=CFG.vocab),
                TrainerConfig(steps=0, ckpt_dir=d), device="cpu")
    assert t.maybe_resume() and t.step == 5
    for a, b in zip(jax.tree.leaves(params_to_numpy(t.params, CFG)),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 ref["params"]))):
        np.testing.assert_array_equal(a, b)
    assert t.opt_state["step"].dtype == torch.int32


def test_the_same_files_and_keys(tmp_path):
    port, refd = str(tmp_path / "port"), str(tmp_path / "ref")
    _trained(port)
    ref_ckpt.save(refd, 2, _ref_templates(), meta={"config": "st-smoke"})
    sd = "step_0000000002"
    assert sorted(os.listdir(os.path.join(port, sd))) == \
        sorted(os.listdir(os.path.join(refd, sd))) == \
        ["integrity.json", "manifest.json", "opt_state.npz", "params.npz"]
    for name in ("params.npz", "opt_state.npz"):
        with np.load(os.path.join(port, sd, name)) as a, \
                np.load(os.path.join(refd, sd, name)) as b:
            assert a.files == b.files       # the same keys, in sorted order
            for k in b.files:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
    for d in (port, refd):
        with open(os.path.join(d, sd, "manifest.json")) as f:
            m = json.load(f)
        assert m["trees"] == ["opt_state", "params"]
        assert m["meta"] == {"config": "st-smoke"}


def test_bfloat16_goes_as_a_uint_view_both_ways(tmp_path):
    port, refd = str(tmp_path / "port"), str(tmp_path / "ref")
    x = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    ckpt.save(port, 1, {"params": {"a": torch.from_numpy(x),
                                   "b": {"c": torch.ones(4).bfloat16()}}})
    _, out = ref_ckpt.restore(port, {"params": {
        "a": jnp.zeros((2, 3)), "b": {"c": jnp.zeros((4,), jnp.bfloat16)}}})
    assert out["params"]["b"]["c"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(out["params"]["a"]), x)
    ref_ckpt.save(refd, 1, {"params": {
        "w": jnp.asarray(x).astype(jnp.bfloat16)}})
    _, back = ckpt.restore(refd, {"params": {
        "w": torch.empty((2, 3), dtype=torch.bfloat16, device="meta")}})
    assert back["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        back["params"]["w"].view(torch.uint16).numpy(),
        x.astype(ml_dtypes.bfloat16).view(np.uint16))


class TestCheckpoint:
    """Mirror of tests/test_train_and_ckpt.py::TestCheckpoint."""

    def test_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(6).reshape(2, 3).float(),
                "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
        ckpt.save(str(tmp_path), 3, {"params": tree})
        step, out = ckpt.restore(str(tmp_path), {"params": tree})
        assert step == 3
        assert torch.equal(out["params"]["a"], tree["a"])
        assert out["params"]["b"]["c"].dtype == torch.bfloat16

    def test_retention_gc(self, tmp_path):
        d = str(tmp_path)
        for s in range(6):
            ckpt.save(d, s, {"params": {"x": torch.zeros(2)}}, keep=3)
        assert len([x for x in os.listdir(d) if x.startswith("step_")]) == 3
        assert ckpt.latest_step(d) == 5

    def test_shape_mismatch_rejected(self, tmp_path):
        ckpt.save(str(tmp_path), 0, {"params": {"x": torch.zeros(2)}})
        with pytest.raises(ValueError):
            ckpt.restore(str(tmp_path), {"params": {"x": torch.zeros(3)}})


def _trees(step):
    rng = np.random.default_rng(step * 31)
    return {"params": {"w": rng.normal(size=(4, 4)).astype(np.float32)}}


class TestCheckpointIntegrity:
    """Mirror of tests/test_chaos.py::TestCheckpointIntegrity."""

    def test_sidecar_written_and_verifies(self, tmp_path):
        d = str(tmp_path)
        ckpt.save(d, 1, _trees(1))
        with open(os.path.join(d, "step_0000000001", "integrity.json")) as f:
            doc = json.load(f)
        assert doc["step"] == 1 and "params.npz" in doc["files"]
        assert ckpt.verify_step(d, 1) is None
        assert ref_ckpt.verify_step(d, 1) is None

    def test_corrupt_latest_falls_back_with_warning(self, tmp_path):
        d = str(tmp_path)
        ckpt.save(d, 1, _trees(1))
        ckpt.save(d, 2, _trees(2))
        with open(os.path.join(d, "step_0000000002", "params.npz"),
                  "rb+") as f:
            f.seek(30)
            f.write(b"\xff\xff\xff\xff")
        assert ckpt.verify_step(d, 2) == ref_ckpt.verify_step(d, 2) \
            is not None
        step, skipped = ckpt.latest_verified_step(d)
        assert (step, skipped) == ref_ckpt.latest_verified_step(d)
        assert step == 1 and [s["step"] for s in skipped] == [2]
        with pytest.warns(RuntimeWarning, match="fell back"):
            got_step, out = ckpt.restore(d, _trees(1))
        assert got_step == 1
        np.testing.assert_array_equal(out["params"]["w"].numpy(),
                                      _trees(1)["params"]["w"])

    def test_explicit_corrupt_step_raises(self, tmp_path):
        d = str(tmp_path)
        ckpt.save(d, 1, _trees(1))
        with open(os.path.join(d, "step_0000000001", "params.npz"),
                  "rb+") as f:
            f.truncate(20)
        with pytest.raises(ckpt.CheckpointCorruptError):
            ckpt.restore(d, _trees(1), step=1)

    def test_legacy_checkpoint_without_sidecar_restores(self, tmp_path):
        d = str(tmp_path)
        ckpt.save(d, 1, _trees(1))
        os.remove(os.path.join(d, "step_0000000001", "integrity.json"))
        assert ckpt.verify_step(d, 1) is None
        assert ckpt.restore(d, _trees(1))[0] == 1

    def test_stale_tmp_and_gc_dirs_reaped(self, tmp_path):
        d = str(tmp_path)
        os.makedirs(os.path.join(d, ".tmp_dead"))
        os.makedirs(os.path.join(d, ".gc_dead"))
        ckpt.save(d, 1, _trees(1))
        assert [f for f in os.listdir(d)
                if f.startswith((".tmp_", ".gc_"))] == []

    def test_every_boundary_old_or_new(self, tmp_path):
        """A crash at any fault point of a save leaves the old or the new
        state, verified, never a torn one (tests/test_chaos.py's sweep)."""
        d = str(tmp_path / "ckpt")
        ckpt.save(d, 1, _trees(1))
        with FP.hits() as schedule:
            ckpt.save(d, 2, _trees(2))
        points = sorted(k for k in schedule if k.startswith("ckpt."))
        assert points == ["ckpt.arrays_written", "ckpt.manifest_written",
                          "ckpt.pre_write", "ckpt.renamed",
                          "ckpt.sidecar_written"]
        outcomes = set()
        for point in points:
            for nth in range(1, schedule[point] + 1):
                sub = str(tmp_path / f"{point}-{nth}")
                ckpt.save(sub, 1, _trees(1))
                with FP.armed(point, nth=nth):
                    with pytest.raises(InjectedCrash):
                        ckpt.save(sub, 2, _trees(2))
                step, skipped = ckpt.latest_verified_step(sub)
                assert step in (1, 2) and skipped == []
                got_step, out = ckpt.restore(sub, _trees(1))
                assert got_step == step
                np.testing.assert_array_equal(out["params"]["w"].numpy(),
                                              _trees(step)["params"]["w"])
                outcomes.add(step)
        assert outcomes == {1, 2}


def test_the_chaos_entry_is_the_references():
    import dataclasses
    e, ref = CORPUS[CHAOS_ENTRY], REF_CORPUS[CHAOS_ENTRY]
    assert (e.backend, dataclasses.asdict(e.truth), e.min_precision,
            dataclasses.asdict(e.chaos)) == \
        (ref.backend, dataclasses.asdict(ref.truth), ref.min_precision,
         dataclasses.asdict(ref.chaos))


@pytest.mark.parametrize("seed", (0, 1, 7))
def test_chaos_entry_passes_with_the_reference_outcome(seed):
    r = run_entry(CORPUS[CHAOS_ENTRY], seed=seed,
                  analyzer_overrides={"device": "cpu"})
    assert r.chaos_ok, r.chaos_failures
    assert r.passed
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = ref_run_entry(REF_CORPUS[CHAOS_ENTRY], seed=seed).chaos_outcome
    got = r.chaos_outcome
    fields = ("survived", "quarantined", "matched", "comparable",
              "mismatched", "fallback_from", "restored_step")
    assert {k: getattr(got, k) for k in fields} == \
        {k: getattr(want, k) for k in fields}
    assert (got.restored_step, got.fallback_from) == (2, 3)
    assert got.detail["skipped"] == want.detail["skipped"]
    assert got.detail["corrupt_reason"] == want.detail["corrupt_reason"]
