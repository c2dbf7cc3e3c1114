"""The port's training path against the reference's, on the same numpy
inputs, and mirrors of tests/test_train_and_ckpt.py and
tests/test_mitigate.py on the port.

Tolerances, and why:

* ``host_batch``: bit for bit (the token stream is a copy).
* ``lr_at`` and ``apply_updates`` on identical params, grads and state:
  params, m and v within 1e-6 relative (both float32; the moments and the
  update differ only in the rounding of the same operations).
* ``loss_fn`` and its gradients on the smoke configs of st-100m,
  gemma-7b, mistral-nemo-12b and h2o-danube-3-4b, weights carried by
  ``params_from_numpy``: the loss within 1e-5 relative, every gradient
  leaf within 1e-4 of its largest element (float32 sums in another order
  through a 2-layer backward).
* A 5-step untraced trainer from carried weights: losses within 1e-3
  relative of the reference's.  AdamW's first step moves each parameter
  by lr times the sign of its gradient, so gradients that differ in
  rounding can part the two runs by 2·lr in a parameter; the losses
  stay within 1e-3.
* A traced step advances the params exactly once: equal bit for bit to
  one ``make_train_step`` call on shard 0's batch.

Every trainer here runs on ``device="cpu"`` (the kernels' plain
versions); the default, the card, raises without one.
"""
import dataclasses
import importlib.util
import pathlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.data import DataConfig as RefDataConfig
from repro.data import host_batch as ref_host_batch
from repro.models import build as ref_build
from repro.models import transformer as ref_transformer
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import apply_updates as ref_apply_updates
from repro.optim import lr_at as ref_lr_at
from repro.scenarios.corpus import CORPUS as REF_CORPUS
from repro.train import Trainer as RefTrainer
from repro.train import TrainerConfig as RefTrainerConfig
from repro_torch.configs import get_arch
from repro_torch.core.analyzer import Verdict
from repro_torch.data import DataConfig, host_batch, to_device
from repro_torch.models import transformer
from repro_torch.models.convert import (params_from_numpy, params_to_numpy,
                                        params_to_tree)
from repro_torch.optim import (AdamWConfig, apply_updates, init_opt_state,
                               lr_at)
from repro_torch.scenarios import CORPUS, run_entry_robust
from repro_torch.stream import WindowVerdict
from repro_torch.train import (MitigationPolicy, MitigationRestart,
                               StragglerMonitor, Trainer, TrainerConfig,
                               rebalance_expert_iters, remesh,
                               run_mitigated, run_with_restarts)
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.loop import make_train_step, value_and_grad
from repro_torch.train.mitigate import (REBALANCE_EXPERTS, REMESH,
                                        RESCHEDULE_CKPT)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = get_arch("st-100m").smoke
LOSS_RTOL, GRAD_TOL, OPT_RTOL, TRAJ_RTOL = 1e-5, 1e-4, 1e-6, 1e-3


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


def _tensors(tree):
    """A nested dict of numpy arrays as one of CPU tensors."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close_rel(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= rtol * np.abs(want) + 1e-30), \
        np.abs(got - want).max()


def _close_to_scale(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def make_trainer(d, steps=10, **kw):
    return Trainer(
        CFG, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50),
        DataConfig(seq_len=32, global_batch=4, vocab=CFG.vocab),
        TrainerConfig(steps=steps, ckpt_dir=d, ckpt_every=4, seed=0, **kw),
        device="cpu")


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("step,n_shards,shard,skew", [
    (0, 1, 0, None), (7, 4, 3, None), (123456, 2, 1, (0.0, 0.5)),
    (3, 8, 5, (0.1, 0.2, 0.3))])
def test_host_batch_is_the_references_bit_for_bit(step, n_shards, shard,
                                                  skew):
    kw = dict(seq_len=48, global_batch=16, vocab=1000, seed=99, skew=skew)
    got = host_batch(DataConfig(**kw), step, n_shards=n_shards, shard=shard)
    want = ref_host_batch(RefDataConfig(**kw), step, n_shards=n_shards,
                          shard=shard)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_device_batch_needs_the_card_or_a_named_device():
    from repro_torch.data import device_batch
    b = device_batch(DataConfig(seq_len=8, global_batch=2, vocab=50), 0,
                     "cpu")
    assert b["tokens"].dtype == torch.int64 and b["mask"].dtype == \
        torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_batch(DataConfig(seq_len=8, global_batch=2, vocab=50), 0)


# -- optimizer -----------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_the_reference(schedule):
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=100, schedule=schedule,
              min_lr_frac=0.1)
    for step in (0, 1, 5, 10, 11, 57, 100, 150):
        _close_rel(lr_at(AdamWConfig(**kw), step),
                   ref_lr_at(RefAdamWConfig(**kw), step), OPT_RTOL)


@pytest.mark.parametrize("clip_norm", [1.0, None, 1e3])
def test_apply_updates_matches_the_reference(clip_norm):
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 2, 4)}
    p, g, m = ({k: rng.standard_normal(s).astype(np.float32)
                for k, s in shapes.items()} for _ in range(3))
    v = {k: np.abs(rng.standard_normal(s)).astype(np.float32)
         for k, s in shapes.items()}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, clip_norm=clip_norm)
    rp, rs, rm = ref_apply_updates(
        RefAdamWConfig(**kw), {k: jnp.asarray(x) for k, x in p.items()},
        {k: jnp.asarray(x) for k, x in g.items()},
        {"m": {k: jnp.asarray(x) for k, x in m.items()},
         "v": {k: jnp.asarray(x) for k, x in v.items()},
         "step": jnp.int32(3)})
    tp, ts, tm = apply_updates(
        AdamWConfig(**kw), _tensors(p), _tensors(g),
        {"m": _tensors(m), "v": _tensors(v),
         "step": torch.tensor(3, dtype=torch.int32)})
    assert int(ts["step"]) == int(rs["step"]) == 4
    assert ts["step"].dtype == torch.int32
    for k in shapes:
        _close_rel(tp[k], rp[k], OPT_RTOL)
        _close_rel(ts["m"][k], rs["m"][k], OPT_RTOL)
        _close_rel(ts["v"][k], rs["v"][k], OPT_RTOL)
    _close_rel(tm["grad_norm"], rm["grad_norm"], OPT_RTOL)
    _close_rel(tm["lr"], rm["lr"], OPT_RTOL)


def test_apply_updates_of_bf16_params_rounds_as_the_reference():
    """bf16 parameters and gradients, float32 moments, a clipping step:
    the clipped gradient stays float32 (JAX promotes bf16 * float32 to
    float32), so the moments match the reference's within 4e-6 relative
    (they scale with the clip factor, v with its square, and the two
    packages sum the squared norm in different orders: 6.6e-7 apart
    here; a gradient rounded to bf16 after the scaling would be 2^-9 off)
    and each new bf16 parameter is the reference's or one rounding step
    from it."""
    rng = np.random.default_rng(8)
    shapes = {"a": (64, 32), "b": (32,)}
    p, g = ({k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()} for _ in range(2))
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=20, clip_norm=1.0)
    state = {"m": {k: np.zeros(s, np.float32) for k, s in shapes.items()},
             "v": {k: np.zeros(s, np.float32) for k, s in shapes.items()}}
    rp, rs, rm = ref_apply_updates(
        RefAdamWConfig(**kw),
        {k: jnp.asarray(x, jnp.bfloat16) for k, x in p.items()},
        {k: jnp.asarray(x, jnp.bfloat16) for k, x in g.items()},
        {"m": {k: jnp.asarray(x) for k, x in state["m"].items()},
         "v": {k: jnp.asarray(x) for k, x in state["v"].items()},
         "step": jnp.int32(0)})
    assert float(rm["grad_norm"]) > 1.0          # the step clips
    tp, ts, tm = apply_updates(
        AdamWConfig(**kw),
        {k: torch.from_numpy(x).bfloat16() for k, x in p.items()},
        {k: torch.from_numpy(x).bfloat16() for k, x in g.items()},
        {"m": _tensors(state["m"]), "v": _tensors(state["v"]),
         "step": torch.tensor(0, dtype=torch.int32)})
    for k in shapes:
        assert tp[k].dtype == torch.bfloat16 and ts["m"][k].dtype == \
            torch.float32
        _close_rel(ts["m"][k], rs["m"][k], 4e-6)
        _close_rel(ts["v"][k], rs["v"][k], 4e-6)
        got = tp[k].float().numpy()
        want = np.asarray(rp[k].astype(jnp.float32))
        assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want))


def test_apply_updates_is_pure():
    params = {"w": torch.ones(3)}
    state = init_opt_state(params)
    before = {k: t.clone() for k, t in state["m"].items()}
    apply_updates(AdamWConfig(), params, {"w": torch.ones(3)}, state)
    assert torch.equal(params["w"], torch.ones(3))
    assert torch.equal(state["m"]["w"], before["w"])
    assert int(state["step"]) == 0


# -- loss and gradients ---------------------------------------------------------

def _carried(arch, seed=0):
    """The reference's smoke params (JAX init) and the port's skeleton
    model with the same weights as a state dict."""
    rcfg, cfg = ref_arch(arch).smoke, get_arch(arch).smoke
    rparams, _ = ref_build(rcfg).init(jax.random.key(seed))
    tree = jax.tree.map(np.asarray, rparams)
    return rcfg, cfg, rparams, params_from_numpy(tree, cfg, "cpu")


@pytest.mark.parametrize("arch", ["st-100m", "gemma-7b", "mistral-nemo-12b",
                                  "h2o-danube-3-4b"])
def test_loss_and_grads_match_jax_value_and_grad(arch):
    rcfg, cfg, rparams, params = _carried(arch)
    B, S = 2, 24
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:, 19:] = 0.0
    (rtotal, rinfo), rgrads = jax.value_and_grad(
        ref_build(rcfg).loss_fn, has_aux=True)(
        rparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
                  "mask": jnp.asarray(mask)})
    model = transformer.Transformer(cfg, "meta", seed=None)
    total, info, grads = value_and_grad(
        model, params, to_device({"tokens": toks, "labels": toks,
                                  "mask": mask}, "cpu"))
    _close_rel(total, rtotal, LOSS_RTOL)
    _close_rel(info["loss"], rinfo["loss"], LOSS_RTOL)
    got = params_to_numpy(grads, cfg)
    want = jax.tree.map(np.asarray, rgrads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close_to_scale(a, b, GRAD_TOL)


def _hidden(cfg, params, toks):
    model = transformer.Transformer(cfg, "meta", seed=None)
    return transformer.functional_call(model, params, toks,
                                       return_hidden=True)[0]


@pytest.mark.parametrize("S,mask_from", [(40, None), (37, 30)])
def test_chunked_ce_matches_plain_and_the_reference(S, mask_from):
    """Mirror of tests/test_loss_paths.py: the chunked CE from the hidden
    states equals the plain CE of the logits (and the reference's chunked
    value), with a mask and a sequence not a multiple of the chunk."""
    from repro_torch.models.layers import cross_entropy, logits_from
    rcfg, cfg, rparams, params = _carried("st-100m")
    B = 2
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    mask = np.ones((B, S), np.float32)
    if mask_from is not None:
        mask[:, mask_from:] = 0.0
    t, m = torch.from_numpy(toks), torch.from_numpy(mask)
    x = _hidden(cfg, params, t)
    logits = logits_from(params["embed"], None, cfg, x)
    plain = cross_entropy(logits[:, :-1], t[:, 1:], m[:, 1:])
    chunked = transformer.chunked_ce_from_hidden(
        params, cfg, x[:, :-1], t[:, 1:], m[:, 1:], chunk=16)
    _close_rel(chunked, plain, 1e-5)
    rx, _ = ref_transformer.forward(rparams, rcfg, jnp.asarray(toks),
                                    return_hidden=True)
    want = ref_transformer.chunked_ce_from_hidden(
        rparams, rcfg, rx[:, :-1], jnp.asarray(toks)[:, 1:],
        jnp.asarray(mask)[:, 1:], chunk=16)
    _close_rel(chunked, want, LOSS_RTOL)


def test_loss_takes_the_chunked_path_above_two_to_the_26(monkeypatch):
    """The big-vocab branch is chosen by S·vocab > 2**26, as in the
    reference: a vocab that puts a 4-token batch over the line takes it."""
    cfg = get_arch("st-100m").smoke
    calls = []
    real = transformer.chunked_ce_from_hidden
    monkeypatch.setattr(transformer, "chunked_ce_from_hidden",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for vocab, want in ((2 ** 24, 0), (2 ** 24 + 1, 1)):
        big = cfg.with_(vocab=vocab, d_model=8, n_heads=1, n_kv_heads=1,
                        d_ff=8, n_layers=1)
        model = transformer.Transformer(big, "meta", seed=None)
        params = {k: torch.zeros(p.shape) for k, p in
                  model.named_parameters()}
        toks = torch.zeros((1, 4), dtype=torch.int64)
        calls.clear()
        total, _ = transformer.loss_fn(
            model, params, {"tokens": toks, "labels": toks})
        assert len(calls) == want
        _close_rel(total, np.log(vocab), 1e-5)   # zero logits: uniform


# -- trainers -----------------------------------------------------------------

def _five_steps_track_the_reference(arch):
    rcfg, cfg = ref_arch(arch).smoke, get_arch(arch).smoke
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=50)
    dkw = dict(seq_len=32, global_batch=4, vocab=cfg.vocab)
    rt = RefTrainer(rcfg, RefAdamWConfig(**kw), RefDataConfig(**dkw),
                    RefTrainerConfig(steps=5, ckpt_dir=None, ckpt_every=0,
                                     seed=0))
    init = jax.tree.map(np.asarray, rt.params)
    want = [h["loss"] for h in rt.run()]
    t = Trainer(cfg, AdamWConfig(**kw), DataConfig(**dkw),
                TrainerConfig(steps=5, ckpt_dir=None, ckpt_every=0),
                device="cpu")
    zeros = jax.tree.map(np.zeros_like, init)
    t.adopt_restore(0, {"params": _tensors(init), "opt_state": {
        "m": _tensors(zeros), "v": _tensors(zeros),
        "step": torch.tensor(0, dtype=torch.int32)}})
    got = [h["loss"] for h in t.run()]
    _close_rel(got, want, TRAJ_RTOL)


def test_five_steps_from_carried_weights_track_the_reference():
    _five_steps_track_the_reference("st-100m")


def test_five_rwkv_steps_from_carried_weights_track_the_reference():
    """The ssm family: the gradient through the WKV-6 Function, under the
    default remat policy."""
    _five_steps_track_the_reference("rwkv6-3b")


def test_traced_step_advances_the_params_exactly_once():
    """TimedRegionRunner calls each leaf for the cost count, the warmup
    and the timed repeats on the same input state and keeps the last
    output: shard 0 ends the step exactly where one train step on its
    batch lands."""
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    data = DataConfig(seq_len=16, global_batch=4, vocab=CFG.vocab)
    t = Trainer(CFG, opt, data,
                TrainerConfig(steps=1, ckpt_every=0, trace=True,
                              trace_shards=2, trace_repeats=3),
                device="cpu")
    p0 = dict(t.params)
    o0 = init_opt_state(p0)
    t.run()
    want_p, want_o, _ = make_train_step(CFG, opt)(
        p0, o0, to_device(host_batch(data, 0, n_shards=2, shard=0), "cpu"))
    assert int(t.opt_state["step"]) == 1
    for k in want_p:
        assert torch.equal(t.params[k], want_p[k]), k
        assert torch.equal(t.opt_state["m"][k], want_o["m"][k]), k


def test_trainer_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(CFG, AdamWConfig(), DataConfig(vocab=CFG.vocab),
                TrainerConfig(steps=1))


def test_ssm_training_waits_for_a_wkv6_gradient():
    """The wait is over: the ssm family trains through the WKV-6 kernel's
    autograd Function.  A Trainer of rwkv6-smoke takes two steps with
    finite losses, and one step of ``make_train_step`` moves every
    parameter, the decay's (``w0``, the lora) and the bonus ``u``
    among them."""
    cfg = get_arch("rwkv6-3b").smoke
    t = Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4),
                DataConfig(seq_len=16, global_batch=2, vocab=cfg.vocab),
                TrainerConfig(steps=2, ckpt_every=0), device="cpu")
    hist = t.run()
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    params = {k: p.detach() for k, p in
              transformer.init(cfg, 0, "cpu").named_parameters()}
    batch = to_device(host_batch(DataConfig(seq_len=16, global_batch=2,
                                            vocab=cfg.vocab), 0), "cpu")
    new, _, m = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1))(
        params, init_opt_state(params), batch)
    assert np.isfinite(float(m["loss"]))
    for name in ("blocks.0.block.u", "blocks.0.block.w0",
                 "blocks.1.block.w_lora_b", "blocks.1.block.wk"):
        assert not torch.equal(new[name], params[name]), name


def test_moe_training_waits_for_the_moe_family():
    """The MoE family trains; expert probes on a config without an MoE,
    or with a row per shard of the wrong length, raise the reference's
    ValueError."""
    moe_cfg = get_arch("mixtral-8x22b").smoke
    Trainer(moe_cfg, AdamWConfig(), DataConfig(vocab=moe_cfg.vocab),
            TrainerConfig(steps=1), device="cpu")
    with pytest.raises(ValueError, match="expert_probe needs an MoE config"):
        Trainer(CFG, AdamWConfig(), DataConfig(vocab=CFG.vocab),
                TrainerConfig(steps=1, trace_shards=1,
                              trace_expert_iters=((1, 1),)), device="cpu")
    with pytest.raises(ValueError, match=r"trace_expert_iters\[0\] has 2"):
        Trainer(moe_cfg, AdamWConfig(), DataConfig(vocab=moe_cfg.vocab),
                TrainerConfig(steps=1, trace_shards=1,
                              trace_expert_iters=((1, 1),)), device="cpu")
    # the reference raises the same errors
    rcfg = ref_arch("st-100m").smoke
    with pytest.raises(ValueError, match="expert_probe needs an MoE config"):
        RefTrainer(rcfg, RefAdamWConfig(), RefDataConfig(vocab=rcfg.vocab),
                   RefTrainerConfig(steps=1, trace_shards=1,
                                    trace_expert_iters=((1, 1),)))


class TestTraining:
    """Mirror of tests/test_train_and_ckpt.py::TestTraining."""

    def test_loss_decreases(self):
        with tempfile.TemporaryDirectory() as d:
            hist = make_trainer(d, steps=25).run()
            losses = [h["loss"] for h in hist]
            assert np.mean(losses[-5:]) < losses[0]

    def test_injected_failure_and_restart(self):
        with tempfile.TemporaryDirectory() as d:
            t = run_with_restarts(lambda: make_trainer(d, steps=12),
                                  steps=12, fail_at=7)
            assert t.step == 12

    def test_resume_continues_from_checkpoint(self):
        with tempfile.TemporaryDirectory() as d:
            make_trainer(d, steps=8).run()
            t2 = make_trainer(d, steps=8)
            assert t2.maybe_resume()
            assert t2.step == 8
            t2.run(4)
            assert t2.step == 12

    def test_resume_is_deterministic(self):
        with tempfile.TemporaryDirectory() as d1, \
                tempfile.TemporaryDirectory() as d2:
            a = make_trainer(d1, steps=10)
            a.run()
            make_trainer(d2, steps=6).run()
            c = make_trainer(d2, steps=0)
            c.maybe_resume()
            c.run(4)
            la = [h["loss"] for h in a.history][-3:]
            lc = [h["loss"] for h in c.history][-3:]
            np.testing.assert_allclose(la, lc, rtol=1e-4)

    def test_remesh_restores_replicated_and_refuses_a_mesh(self):
        with tempfile.TemporaryDirectory() as d:
            t = make_trainer(d, steps=1)
            t.run()
            step, trees = remesh(d, CFG, t.checkpoint_templates())
            assert step == 1
            want = params_to_tree(t.params, CFG)
            assert torch.equal(trees["params"]["layers"]["attn"]["wq"],
                               want["layers"]["attn"]["wq"])
            with pytest.raises(NotImplementedError, match="item 7"):
                remesh(d, CFG, t.checkpoint_templates(), new_mesh=object())


class TestStragglerMonitor:
    """Mirror of tests/test_train_and_ckpt.py::TestStragglerMonitor."""

    def test_slow_step_flagged(self):
        m = StragglerMonitor(threshold=1.5, window=16)
        for i in range(10):
            m.observe_step(i, 1.0)
        assert m.observe_step(10, 2.0)
        assert any(e["kind"] == "slow-step" for e in m.events)

    def test_shard_dissimilarity_flagged(self):
        m = StragglerMonitor()
        assert m.observe_step(0, 1.0,
                              per_shard=np.array([1.0, 1.01, 0.99, 3.0]))
        assert any(e["kind"] == "shard-dissimilarity" for e in m.events)

    def test_balanced_not_flagged(self):
        m = StragglerMonitor()
        assert not m.observe_step(0, 1.0,
                                  per_shard=np.array([1.0, 1.0, 1.0]))


class TestData:
    """Mirror of tests/test_train_and_ckpt.py::TestData."""

    def test_determinism(self):
        cfg = DataConfig(seq_len=16, global_batch=4, vocab=100)
        np.testing.assert_array_equal(host_batch(cfg, 7)["tokens"],
                                      host_batch(cfg, 7)["tokens"])

    def test_steps_differ(self):
        cfg = DataConfig(seq_len=16, global_batch=4, vocab=100)
        assert not np.array_equal(host_batch(cfg, 0)["tokens"],
                                  host_batch(cfg, 1)["tokens"])

    def test_shard_slicing(self):
        cfg = DataConfig(seq_len=16, global_batch=8, vocab=100)
        assert host_batch(cfg, 0, n_shards=4, shard=0)["tokens"].shape == \
            (2, 16)

    def test_skew_injection(self):
        cfg = DataConfig(seq_len=16, global_batch=4, vocab=100,
                         skew=[0.0, 0.5])
        b = host_batch(cfg, 0, n_shards=2, shard=1)
        assert (b["mask"][:, 8:] == 0).all()


class TestOptim:
    """Mirror of tests/test_train_and_ckpt.py::TestOptim (without the
    compressed all-reduce, which waits for multi-device)."""

    def test_adamw_minimizes_quadratic(self):
        params = {"w": torch.tensor([5.0, -3.0])}
        opt = init_opt_state(params)
        cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                          total_steps=200, schedule="constant")
        for _ in range(150):
            params, opt, _ = apply_updates(cfg, params,
                                           {"w": 2 * params["w"]}, opt)
        assert float(params["w"].abs().max()) < 0.1

    def test_lr_schedule_warmup_and_decay(self):
        cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          schedule="cosine", min_lr_frac=0.1)
        assert float(lr_at(cfg, 0)) == 0.0
        assert float(lr_at(cfg, 10)) == pytest.approx(1.0, rel=1e-3)
        assert float(lr_at(cfg, 100)) == pytest.approx(0.1, rel=1e-2)

    def test_grad_clipping(self):
        params = {"w": torch.zeros(3)}
        _, _, m = apply_updates(AdamWConfig(lr=0.0, clip_norm=1.0), params,
                                {"w": torch.full((3,), 100.0)},
                                init_opt_state(params))
        assert float(m["grad_norm"]) > 100.0   # reported pre-clip


# -- mitigation (mirror of tests/test_mitigate.py) ------------------------------

def _verdict(dissimilarity_paths=(), disparity_paths=(), causes=()):
    return Verdict(
        dissimilar=bool(dissimilarity_paths),
        dissimilarity_paths=tuple(dissimilarity_paths),
        dissimilarity_ccr_paths=tuple(dissimilarity_paths),
        disparity_paths=tuple(disparity_paths),
        disparity_ccr_paths=tuple(disparity_paths),
        cause_attributes=frozenset(causes),
        dissimilarity_cause_attributes=frozenset(causes),
        per_path_causes=tuple((p, tuple(sorted(causes)))
                              for p in disparity_paths))


def _wv(index, verdict):
    return WindowVerdict(index=index, start=index, stop=index + 1,
                         verdict=verdict)


class TestClassification:
    def test_straggler_maps_to_remesh(self):
        tcfg = TrainerConfig(trace=True, trace_shards=4)
        wv = _wv(0, _verdict(dissimilarity_paths=("train/fwd_bwd",)))
        a = MitigationPolicy().classify(tcfg, wv,
                                        np.array([1.0, 1.1, 0.9, 9.0]))
        assert a is not None and a.kind == REMESH
        assert a.detail["slow_shard"] == 3 and a.detail["new_shards"] == 3
        assert a.paths == ("train/fwd_bwd",)

    def test_no_remesh_without_isolated_slow_shard(self):
        tcfg = TrainerConfig(trace=True, trace_shards=4)
        wv = _wv(0, _verdict(dissimilarity_paths=("train/fwd_bwd",)))
        assert MitigationPolicy().classify(
            tcfg, wv, np.array([1.0, 1.1, 0.9, 1.2])) is None

    def test_host_bytes_with_saves_on_maps_to_reschedule(self):
        policy = MitigationPolicy()
        tcfg = TrainerConfig(trace=True, trace_shards=4, ckpt_every=2,
                             ckpt_dir="unused")
        wv = _wv(0, _verdict(dissimilarity_paths=("train/optimizer",),
                             causes=("host_bytes",)))
        a = policy.classify(tcfg, wv, np.array([1.0, 1.0, 1.0, 9.0]))
        assert a is not None and a.kind == RESCHEDULE_CKPT
        tcfg2 = TrainerConfig(trace=True, trace_shards=4, ckpt_every=0)
        a2 = policy.classify(tcfg2, wv, np.array([1.0, 1.0, 1.0, 9.0]))
        assert a2 is not None and a2.kind == REMESH

    def test_expert_disparity_gated_by_measurement(self):
        policy = MitigationPolicy()
        rows = tuple((4, 48, 4, 4) for _ in range(4))
        tcfg = TrainerConfig(trace=True, trace_shards=4,
                             trace_expert_iters=rows)
        all_flagged = _wv(0, _verdict(disparity_paths=tuple(
            f"train/moe/expert_{e}" for e in range(4))))
        assert policy.classify(tcfg, all_flagged, np.ones(4),
                               hot_expert_paths=()) is None
        a = policy.classify(tcfg, all_flagged, np.ones(4),
                            hot_expert_paths=("train/moe/expert_1",))
        assert a is not None and a.kind == REBALANCE_EXPERTS
        assert a.paths == ("train/moe/expert_1",)
        assert a.detail["hot_experts"] == [1]


def test_rebalance_preserves_totals():
    rows = ((4, 48, 4, 4), (10, 1, 1, 1))
    for before, after in zip(rows, rebalance_expert_iters(rows)):
        assert sum(after) == sum(before) and max(after) - min(after) <= 1


class _StubTrainer:
    def __init__(self, tree, tcfg):
        self.region_tree, self.tcfg = tree, tcfg
        self.step, self._last_step_trace, self.saved = 0, None, 0

    def save(self):
        self.saved += 1


def test_same_verdict_never_refires():
    tree, coll = CORPUS["st/compute-straggler-cr5"].build(0)
    trace = coll.collect_trace()
    stub = _StubTrainer(tree, TrainerConfig(trace=True, trace_shards=8))
    policy = MitigationPolicy(window_steps=1, persist=2,
                              straggler_ratio=1.25,
                              analyzer_kw={"device": "cpu"})
    stub.step, stub._last_step_trace = 1, trace
    assert policy.observe(stub) is None
    stub.step = 2
    with pytest.raises(MitigationRestart):
        policy.observe(stub)
    assert [a.kind for a in policy.actions] == [REMESH]
    assert stub.saved == 1
    for s in (3, 4):
        stub.step = s
        assert policy.observe(stub) is None
    assert len(policy.actions) == 1
    assert all(c is not None for c in policy.window_candidates)


class TestClosedLoop:
    KW = {"threshold_frac": 0.45, "device": "cpu"}

    def _smoke(self, tmp_path, iters, seed=0, steps=4):
        tcfg = TrainerConfig(steps=steps, ckpt_dir=str(tmp_path / "ckpt"),
                             ckpt_every=0, seed=seed, trace=True,
                             trace_shards=len(iters), trace_iters=iters,
                             trace_meta={"analyzer_kw":
                                         {"threshold_frac": 0.45}})
        return (CFG, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50),
                DataConfig(seq_len=32, global_batch=2 * len(iters),
                           vocab=CFG.vocab), tcfg)

    def test_remesh_roundtrip_through_checkpoint(self, tmp_path):
        cfg, opt, data, tcfg = self._smoke(tmp_path, (1, 1, 1, 12))
        policy = MitigationPolicy(window_steps=1, persist=2,
                                  analyzer_kw=self.KW)
        trainer = run_mitigated(cfg, opt, data, tcfg, policy, device="cpu")
        assert [a.kind for a in policy.actions] == [REMESH]
        assert trainer.tcfg.trace_shards == 3
        assert trainer.tcfg.trace_iters == (1, 1, 1)
        assert trainer.step == tcfg.steps
        step, trees = ckpt_mod.restore(tcfg.ckpt_dir,
                                       trainer.checkpoint_templates())
        assert step == trainer.step
        want = params_to_tree(trainer.params, cfg)
        for a, b in zip(jax.tree.leaves(trees["params"]),
                        jax.tree.leaves(want)):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("seed", [0, 7])
    def test_noop_on_clean_run(self, tmp_path, seed):
        cfg, opt, data, tcfg = self._smoke(tmp_path, (1, 1, 1, 1),
                                           seed=seed)
        policy = MitigationPolicy(window_steps=1, persist=2,
                                  analyzer_kw=self.KW)
        trainer = run_mitigated(cfg, opt, data, tcfg, policy, device="cpu")
        assert policy.actions == [] and not policy.remeshed
        assert trainer.tcfg.trace_shards == 4
        assert trainer.step == tcfg.steps

    def test_traced_resume_refreshes_shard_states(self, tmp_path):
        cfg, opt, data, tcfg = self._smoke(tmp_path, (1, 1), steps=2)
        Trainer(cfg, opt, data, tcfg, device="cpu").run()
        t2 = Trainer(cfg, opt, data, tcfg, device="cpu")
        assert t2.maybe_resume()
        assert t2.step == 2
        for s in t2._shard_states:
            for k in t2.params:
                assert torch.equal(s["params"][k], t2.params[k])


# -- the train and recovery corpus entries --------------------------------------

TRAIN_ENTRIES = ["train/fwdbwd-straggler-smoke",
                 "train/straggler-remesh-recovery",
                 "train/ckpt-stall-reschedule-recovery"]


@pytest.mark.parametrize("name", TRAIN_ENTRIES)
def test_train_entry_passes_with_the_references_outcome(name):
    """The entry is the reference's (truth, recovery truth, analyzer
    settings, floors) and passes at seed 0 with it: the reference's
    action, in time, and clean windows after."""
    e, ref = CORPUS[name], REF_CORPUS[name]
    assert (e.app, e.backend, dataclasses.asdict(e.truth), e.analyzer_kw,
            e.min_precision, e.expect_onset_window,
            e.recovery and dataclasses.asdict(e.recovery)) == \
        (ref.app, ref.backend, dataclasses.asdict(ref.truth),
         ref.analyzer_kw, ref.min_precision, ref.expect_onset_window,
         ref.recovery and dataclasses.asdict(ref.recovery))
    r = run_entry_robust(e, seed=0, analyzer_overrides={"device": "cpu"})
    assert r.passed, (r.recovery_kind, r.mitigation_window, r.clean_after,
                      sorted(r.found), sorted(r.missed))
    if e.recovery is not None:
        assert r.recovery_kind == e.recovery.kind


def test_train_entry_through_the_spool(tmp_path, monkeypatch):
    """With ``TRAIN_SPOOL_BASE`` set, a train entry collects through a
    trace spool (one step a segment) and still passes; the spool's
    finalized artifact is the trace the trainer analyzed, with the
    trainer's header meta."""
    from repro_torch.core import RegionTrace
    from repro_torch.scenarios import corpus
    from repro_torch.stream import SpooledTrace
    monkeypatch.setattr(corpus, "TRAIN_SPOOL_BASE", str(tmp_path))
    r = run_entry_robust(CORPUS["train/fwdbwd-straggler-smoke"], seed=0,
                         analyzer_overrides={"device": "cpu"})
    assert r.passed
    spool_dir = r.collector.trainer.spool.directory
    assert spool_dir.startswith(str(tmp_path))
    out = str(tmp_path / "final.npz")
    SpooledTrace(spool_dir).finalize(out)
    final, trace = RegionTrace.load(out), r.collector.last_trace
    assert final.meta == trace.meta
    assert final.meta["collector"] == "train"
    assert final.meta["analyzer_kw"] == {"threshold_frac": 0.45}
    for k in trace.data:
        np.testing.assert_array_equal(final.data[k], trace.data[k])


def test_the_moe_train_entries_wait():
    """The port's corpus is the reference's: all 40 entries, in its
    order (the two MoE train entries last to arrive)."""
    assert list(CORPUS) == list(REF_CORPUS)
    assert len(CORPUS) == 40


# -- the launcher and chip_smoke's phases 15-17, rehearsed on the host ----------

def test_launch_train_on_the_host(capsys):
    from repro_torch.launch import train
    assert train.main(["--arch", "st-100m", "--smoke", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert "tokens/s" in out[-3] and out[-2].startswith("peak device memory")
    import json
    final = json.loads(out[-1])
    assert list(final) == ["final_loss", "steps", "straggler_events"]
    assert final["steps"] == 3


def test_chip_smoke_training_phases_rehearsed():
    cs = _chip_smoke()
    r = cs.check_train_rmsnorm(300, 3840, "cpu")
    assert r["dx"] <= cs.GRAD_TOL and r["dw"] <= cs.GRAD_TOL
    r = cs.check_train_attention("danube-gqa-softcap", "cpu")
    assert max(r["dq"], r["dk"], r["dv"]) <= cs.GRAD_TOL
    p = cs.train_parity_phase(CFG, "cpu", batch=2, seq=16, steps=2)
    assert p["forwards"] == 4 and p["loss"][0] == p["loss"][1]
    t = cs.train_phase(("--arch", "st-100m", "--smoke", "--steps", "10",
                        "--batch", "4", "--seq", "32"), "cpu")
    assert t["steps"] == 10 and t["breakdown"] is None
    tr = cs.traced_train_phase(CFG, "cpu", batch=8, seq=16)
    assert tr["forwards"] == 2 * 2 * 7 + 1
    assert "train/fwd_bwd" in tr["verdict"]["dissimilarity_paths"]
    # the fwd_bwd leaf's cost count holds its attention FLOPs
    assert tr["costs"]["train/fwd_bwd"][0] > 0
