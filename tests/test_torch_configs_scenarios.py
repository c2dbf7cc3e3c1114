"""Data copied into the port stays equal to the reference: every model
config (full and smoke), the fault archetypes' perturbations, the corpus
registry, and the region trees built from smoke configs."""
import dataclasses

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.scenarios import corpus as ref_corpus
from repro.scenarios import faults as ref_faults
pytest.importorskip("torch")
from repro_torch import configs as port_configs
from repro_torch.scenarios import corpus as port_corpus
from repro_torch.scenarios import faults as port_faults


TREE_ARCHS = ["mixtral-8x22b", "deepseek-v2-lite-16b", "gemma-7b",
              "chatglm3-6b"]
# Architectures the models and the serving launcher reach.
MODEL_ARCHS = ["st-100m", "mistral-nemo-12b", "h2o-danube-3-4b", "rwkv6-3b",
               "phi-3-vision-4.2b", "recurrentgemma-9b",
               "seamless-m4t-medium"]


@pytest.mark.parametrize("arch", TREE_ARCHS + MODEL_ARCHS)
def test_configs_equal_reference(arch):
    ref, port = ref_configs.get_arch(arch), port_configs.get_arch(arch)
    assert dataclasses.asdict(port.smoke) == dataclasses.asdict(ref.smoke)
    assert dataclasses.asdict(port.full) == dataclasses.asdict(ref.full)
    for a, b in ((port.smoke, ref.smoke), (port.full, ref.full)):
        assert a.param_count() == b.param_count()
        assert a.active_param_count() == b.active_param_count()
        assert (a.resolved_head_dim, a.attn_dim) == \
            (b.resolved_head_dim, b.attn_dim)
        assert str(a.activation_dtype()) == f"torch.{b.activation_dtype()}"
        assert str(a.parameter_dtype()) == f"torch.{b.parameter_dtype()}"


def test_same_arch_registry():
    """The port carries every architecture of the reference."""
    assert port_configs.list_archs() == sorted(TREE_ARCHS + MODEL_ARCHS)
    assert port_configs.list_archs() == ref_configs.list_archs()


def test_gemma_7b_full_size():
    """The served model: 8.54e9 parameters, 17.1 GB in bf16."""
    cfg = port_configs.get_arch("gemma-7b").full
    assert cfg.param_count() == 8537680896
    assert cfg.resolved_head_dim == 256 and cfg.attn_dim == 4096


@pytest.mark.parametrize("arch", TREE_ARCHS)
def test_model_region_trees_equal(arch):
    ref_tree, ref_b, _ = ref_corpus.model_region_tree(arch)
    tree, b, _ = port_corpus.model_region_tree(arch)
    assert [r.path for r in tree.regions()] == \
        [r.path for r in ref_tree.regions()]
    assert {k: dataclasses.asdict(v) for k, v in b.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_b.items()}


def test_corpus_registry_is_the_synthetic_one():
    ref = ref_corpus.corpus_entries(backend="synthetic")
    port = port_corpus.corpus_entries(backend="synthetic")
    assert [e.name for e in port] == [e.name for e in ref]
    for a, b in zip(port, ref):
        assert (a.app, dataclasses.asdict(a.truth), a.analyzer_kw,
                a.min_precision, a.expect_onset_window) == \
            (b.app, dataclasses.asdict(b.truth), b.analyzer_kw,
             b.min_precision, b.expect_onset_window)
    with pytest.raises(ValueError, match="unknown entries"):
        port_corpus.select_entries(names=["train/no-such-entry"])


ARCHETYPES = [
    ("ComputeStraggler", ("ST/cr5",), dict(procs=(1, 6), factor=5.0)),
    ("JitteredStraggler", ("ST/cr14/cr11",), dict(procs=(2,), factor=3.0)),
    ("DataSkew", ("ST/cr14/cr11",),
     dict(profile=(0.3, 0.8, 0.81, 1.2, 1.6, 2.0, 1.61, 2.01))),
    ("CommImbalance", ("ST/cr9",), dict(extra_bytes=3e9, procs=(0,))),
    ("CommImbalance", ("ST/cr9",), dict(extra_bytes=3e9)),
    ("CollectiveStraggler", (("ST/cr9", "ST/cr10"),), dict(straggler=4)),
    ("CheckpointStall", ("ST/cr10",), dict(proc=2)),
    ("CacheThrash", ("ST/cr14/cr11",), dict()),
    ("MemoryPressure", ("ST/cr9",), dict()),
    ("IOHotspot", ("ST/cr8",), dict()),
    ("ComputeHotspot", ("ST/cr3",), dict()),
    ("ThermalThrottleDrift", ("ST/cr5",), dict(procs=(1,), onset_step=2)),
]


@pytest.mark.parametrize("name,args,kw", ARCHETYPES,
                         ids=[a[0] for a in ARCHETYPES])
def test_fault_archetypes_perturb_identically(name, args, kw):
    ref_tree, ref_b = ref_corpus.baseline_st()
    tree, b = port_corpus.baseline_st()
    ref_tr = ref_corpus.SyntheticWorkload(ref_tree, ref_b, 8, seed=5) \
        .collect_trace(n_steps=4)
    port_tr = port_corpus.SyntheticWorkload(tree, b, 8, seed=5) \
        .collect_trace(n_steps=4)
    ref_faults.inject_trace(ref_tree, ref_tr,
                            [getattr(ref_faults, name)(*args, **kw)], seed=3)
    port_faults.inject_trace(tree, port_tr,
                             [getattr(port_faults, name)(*args, **kw)],
                             seed=3)
    assert sorted(port_tr.data) == sorted(ref_tr.data)
    for k in ref_tr.data:
        np.testing.assert_array_equal(port_tr.data[k], ref_tr.data[k])


def test_expert_load_imbalance_identical():
    ref_tree, ref_b, _ = ref_corpus.model_region_tree("mixtral-8x22b")
    tree, b, _ = port_corpus.model_region_tree("mixtral-8x22b")
    f = dict(layer="mixtral-smoke/layer_1", hot_expert=0, factor=4.0,
             congestion=4.0)
    ref_rm = ref_faults.inject(
        ref_tree, ref_corpus.SyntheticWorkload(ref_tree, ref_b, 8).collect(),
        [ref_faults.ExpertLoadImbalance(**f)])
    rm = port_faults.inject(
        tree, port_corpus.SyntheticWorkload(tree, b, 8).collect(),
        [port_faults.ExpertLoadImbalance(**f)])
    for k in ref_rm.data:
        np.testing.assert_array_equal(rm.data[k], ref_rm.data[k])
