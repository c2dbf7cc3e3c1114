"""The port's MoE family against the reference's, on the same numpy inputs.

The reference's smoke models (mixtral-smoke: 4 experts top-2, GQA with a
16-slot window; dsv2-smoke: MLA with rank 16 and 8 rope dims, 4 routed
experts top-2 and one shared) are initialised in JAX and moved across as
numpy through ``params_from_numpy``.  Tolerances, and why (float32 both
sides; the two differ only in the order of float32 sums):

* ``moe_block``: outputs within 1e-5 of their scale, the aux loss within
  1e-6 relative, the expert counts and the dropped (token, expert) pairs
  exactly;
* ``mla_attention``: outputs and the latent cache within 1e-5 of their
  scale;
* ``loss_fn``: the loss within 1e-5 relative, every gradient within 1e-4
  of its largest element (a 2-layer backward);
* ``call_costs``: equal to ``FlopCounterMode``'s count of one call, flop
  for flop (both count the same matrix products).

Also the region tree of the expert probes, a mixtral-smoke checkpoint
across packages, the two MoE corpus entries at seed 0 and chip_smoke's
phases 19-21 rehearsed at the smoke size, all on ``device="cpu"``.
"""
import dataclasses
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_arch as ref_arch
from repro.models import build as ref_build
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import init_opt_state as ref_init_opt_state
from repro.scenarios.corpus import CORPUS as REF_CORPUS
from repro.train import checkpoint as ref_ckpt
from repro.train.loop import train_region_tree as ref_train_region_tree
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, to_device
from repro_torch.models import build, layers, moe, transformer
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.optim import AdamWConfig
from repro_torch.scenarios import CORPUS, run_entry_robust
from repro_torch.serve.runtime import TorchBackend, call_costs
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import train_region_tree, value_and_grad

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["mixtral-8x22b", "deepseek-v2-lite-16b"]
OUT_TOL, AUX_RTOL, LOSS_RTOL, GRAD_TOL = 1e-5, 1e-6, 1e-5, 1e-4
MOE_ENTRIES = ["train/moe-routing-collapse-smoke",
               "train/moe-collapse-rebalance-recovery"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """PyTorch's CPU ops on one thread for this module: the corpus entries
    time regions by the wall clock, and tests run in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _carried(arch, seed=0):
    """The reference's smoke params and config, the port's config and the
    same weights as the port's state dict."""
    rcfg, cfg = ref_arch(arch).smoke, get_arch(arch).smoke
    rparams, _ = ref_build(rcfg).init(jax.random.key(seed))
    state = params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, "cpu")
    return rcfg, cfg, rparams, state


def _layer0(rparams, state, group):
    """Layer 0's ``group`` params: the reference's slice, the port's."""
    rp = jax.tree.map(lambda a: a[0], rparams["layers"][group])
    pre = f"blocks.0.{group}."
    return rp, {k[len(pre):]: v for k, v in state.items()
                if k.startswith(pre)}


def _close_to_scale(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- moe_block ---------------------------------------------------------------

def _ref_dropped(rp, rcfg, x, capacity):
    """The reference's dropped (row, token, expert) triples, from its
    ``_dispatch_row`` over its own grouping."""
    mo = rcfg.moe
    B, S, D = x.shape
    G = math.gcd(B, 8) if S < 64 else 1
    xg = jnp.asarray(x).reshape(B // G, G * S, D)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", xg, rp["router"])
                           .astype(jnp.float32), axis=-1)
    out = set()
    for b in range(B // G):
        _, slot, st, _, keep, _ = ref_moe._dispatch_row(
            xg[b], probs[b], mo.top_k, capacity)
        se = np.asarray(slot) // capacity
        for t, e, kp in zip(np.asarray(st), se, np.asarray(keep)):
            if not kp:
                out.add((b, int(t), int(e)))
    return out


def _port_dropped(p, cfg, x, capacity):
    mo = cfg.moe
    B, S, D = x.shape
    G = moe.groups(B, S)
    xt = torch.from_numpy(x).reshape(B // G, G * S, D)
    _, gates, ids = moe.route(p, cfg, xt)
    _, slot, _, keep, _ = moe._dispatch(xt, gates, ids, mo.n_experts,
                                        capacity)
    k = mo.top_k
    return {(b, i // k, int(slot[b, i]) // capacity)
            for b in range(B // G) for i in range(G * S * k)
            if not bool(keep[b, i])}


def _dense_mixture(p, cfg, x):
    """Every token through its top-k experts, weighted by its gates, and
    the shared experts: the mixture with no capacity, in float64."""
    mo = cfg.moe
    xt = torch.from_numpy(x)
    _, gates, ids = moe.route(p, cfg, xt)
    x64 = xt.double()
    out = torch.zeros_like(x64)
    for j in range(mo.top_k):
        for e in range(mo.n_experts):
            sel = (ids[..., j] == e).double()[..., None] * \
                gates[..., j].double()[..., None]
            h = layers._act(x64 @ p["wg"][e].double(), cfg.activation) * \
                (x64 @ p["wi"][e].double())
            out += sel * (h @ p["wo"][e].double())
    if mo.n_shared:
        h = layers._act(x64 @ p["shared_wg"].double(), cfg.activation) * \
            (x64 @ p["shared_wi"].double())
        out += h @ p["shared_wo"].double()
    return out.numpy()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape,capacity", [
    ((2, 24), None),     # one group of 48 tokens at the config's capacity
    ((2, 24), 96),       # every pair kept: the dense mixture
    ((2, 24), 1),        # one slot an expert: most pairs dropped
    ((8, 1), None),      # decode: 8 rows grouped (gcd(8, 8))
    ((3, 1), 1),         # decode grouping of gcd(3, 8) = 1 row a group
    ((1, 70), None),     # 70 tokens: no grouping from S = 64 up
])
def test_moe_block_matches_reference(arch, shape, capacity):
    rcfg, cfg, rparams, state = _carried(arch)
    rp, p = _layer0(rparams, state, "moe")
    x = np.random.default_rng(sum(shape)).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)
    want, raux, rcounts = ref_moe.moe_block(rp, rcfg, jnp.asarray(x),
                                            capacity=capacity)
    got, aux, counts = moe.moe_block(p, cfg, torch.from_numpy(x), capacity)
    _close_to_scale(got, want, OUT_TOL)
    np.testing.assert_allclose(float(aux), float(raux), rtol=AUX_RTOL,
                               atol=0)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))
    B, S = shape
    cap = capacity or moe.capacity_of(cfg, moe.groups(B, S) * S)
    dropped = _port_dropped(p, cfg, x, cap)
    assert dropped == _ref_dropped(rp, rcfg, x, cap)
    if capacity == 1 and S > 1:
        assert len(dropped) > 0
    if capacity == 96:
        assert not dropped
        _close_to_scale(got, _dense_mixture(p, cfg, x), OUT_TOL)


def test_top_k_ties_go_to_the_lower_expert_id():
    """Equal router probabilities: the first k expert ids, as lax.top_k."""
    cfg = get_arch("deepseek-v2-lite-16b").smoke
    p = {"router": torch.zeros((cfg.d_model, cfg.moe.n_experts))}
    probs, gates, ids = moe.route(p, cfg, torch.ones((3, cfg.d_model)))
    assert ids.tolist() == [[0, 1]] * 3
    np.testing.assert_allclose(gates.numpy(), 0.5)
    _, rids = jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.moe.top_k)
    assert np.asarray(rids).tolist() == ids.tolist()


# -- MLA -------------------------------------------------------------------

def _mla_pair():
    rcfg, cfg, rparams, state = _carried("deepseek-v2-lite-16b")
    rp, p = _layer0(rparams, state, "attn")
    return rcfg, cfg, rp, p


def test_mla_attention_without_a_cache_matches_reference():
    rcfg, cfg, rp, p = _mla_pair()
    x = np.random.default_rng(5).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)
    want, _ = ref_layers.mla_attention(rp, rcfg, jnp.asarray(x),
                                       jnp.asarray(pos))
    tp = torch.from_numpy(pos)
    got = layers.mla_attention(p, cfg, torch.from_numpy(x), tp,
                               layers.mla_angles(cfg, tp),
                               layers.mla_rope_cfg(cfg))
    _close_to_scale(got, want, OUT_TOL)


@pytest.mark.parametrize("chunk", [4, 1])
def test_mla_attention_through_its_cache_matches_reference(chunk):
    """A 9-token prompt in chunks, then 3 single-token steps, into a
    16-slot latent cache: every call's output and the cache itself."""
    rcfg, cfg, rp, p = _mla_pair()
    rng = np.random.default_rng(chunk)
    xs = rng.standard_normal((1, 12, cfg.d_model)).astype(np.float32)
    rcache = ref_layers.init_mla_cache(rcfg, 1, 16, jnp.float32)
    cache = layers.init_mla_cache(cfg, 1, 16, torch.float32,
                                  torch.device("cpu"))
    rope_cfg = layers.mla_rope_cfg(cfg)
    a = 0
    while a < 12:
        k = min(chunk, 9 - a) if a < 9 else 1
        pos = np.arange(a, a + k, dtype=np.int32)
        want, rcache = ref_layers.mla_attention(
            rp, rcfg, jnp.asarray(xs[:, a:a + k]), jnp.asarray(pos),
            cache=rcache)
        tp = torch.from_numpy(pos)
        got = layers.mla_attention(p, cfg, torch.from_numpy(xs[:, a:a + k]),
                                   tp, layers.mla_angles(cfg, tp), rope_cfg,
                                   cache)
        _close_to_scale(got, want, OUT_TOL)
        a += k
        assert cache["idx"] == int(rcache["idx"]) == a
    for name in ("c_kv", "k_rope"):
        _close_to_scale(cache[name], rcache[name], OUT_TOL)


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_over_64_tokens_matches_reference(arch):
    """S = 64: the rows dispatch ungrouped; logits and the (L, E) counts."""
    rcfg, cfg, rparams, state = _carried(arch)
    model = transformer.Transformer(cfg, "cpu", seed=None)
    model.load_state_dict(state)
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 64),
                                             dtype=np.int32)
    want, rinfo = ref_build(rcfg).forward(rparams, jnp.asarray(toks))
    got, info = model(torch.from_numpy(toks))
    _close_to_scale(got, want, OUT_TOL)
    assert info["expert_counts"].shape == (cfg.n_layers, cfg.moe.n_experts)
    np.testing.assert_array_equal(info["expert_counts"].numpy(),
                                  np.asarray(rinfo["expert_counts"]))
    assert int(info["expert_counts"].sum()) == \
        cfg.n_layers * 2 * 64 * cfg.moe.top_k


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_value_and_grad(arch):
    rcfg, cfg, rparams, state = _carried(arch)
    B, S = 2, 24
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:, 19:] = 0.0
    (rtotal, rinfo), rgrads = jax.value_and_grad(
        ref_build(rcfg).loss_fn, has_aux=True)(
        rparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
                  "mask": jnp.asarray(mask)})
    skeleton = transformer.Transformer(cfg, "meta", seed=None)
    total, info, grads = value_and_grad(
        skeleton, state, to_device({"tokens": toks, "labels": toks,
                                    "mask": mask}, "cpu"))
    for a, b in ((total, rtotal), (info["loss"], rinfo["loss"])):
        np.testing.assert_allclose(float(a), float(b), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(info["aux"]), float(rinfo["aux"]),
                               rtol=AUX_RTOL)
    assert float(total) > float(info["loss"])    # the aux loss is added
    got = params_to_numpy(grads, cfg)
    want = jax.tree.map(np.asarray, rgrads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close_to_scale(a, b, GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tokens", [8, 1])
def test_call_costs_equal_the_flop_counter(arch, tokens):
    """One batch-1 call of ``tokens`` tokens over a 20-slot cache (16 for
    mixtral-smoke's window): the formula's FLOPs are the matrix products
    FlopCounterMode counts in the call; its bytes the weights, the cache
    read and written and the logits, counted here by hand."""
    cfg = get_arch(arch).smoke
    model = transformer.Transformer(cfg, "cpu", seed=0)
    backend = TorchBackend(cfg, build(cfg, "cpu"), model, lanes=1,
                           max_len=20, prefill_chunk=8)
    K = backend.cache_slots
    assert K == (16 if cfg.window else 20)
    state = model.init_decode_state(1, 20)
    toks = torch.zeros((1, tokens), dtype=torch.int32)
    pos = torch.arange(tokens, dtype=torch.int32) if tokens > 1 else 0
    with FlopCounterMode(display=False) as fc:
        model.decode_step(state, toks, pos)
    flops, nbytes = call_costs(cfg, tokens, K, backend.weight_bytes)
    assert flops == float(fc.get_total_flops())
    if cfg.mla is not None:
        m = cfg.mla
        cache = cfg.n_layers * (K + tokens) * (m.kv_lora_rank
                                               + m.rope_head_dim) * 4
    else:
        cache = 2 * cfg.n_layers * (K + tokens) * cfg.n_kv_heads \
            * cfg.resolved_head_dim * 4
    assert nbytes == float(backend.weight_bytes + cache
                           + 4 * tokens * cfg.vocab)
    # the trace's appended KV bytes keep the reference's formula
    assert backend.kv_bytes_per_token == 2 * cfg.n_layers * \
        cfg.n_kv_heads * cfg.resolved_head_dim * 4


# -- training ----------------------------------------------------------------

@pytest.mark.parametrize("iterated", [False, True])
def test_probe_region_tree_is_the_references(iterated):
    cfg, rcfg = get_arch("mixtral-8x22b").smoke, \
        ref_arch("mixtral-8x22b").smoke
    got = train_region_tree(cfg, AdamWConfig(), iterated=iterated,
                            expert_probe=True)
    want = ref_train_region_tree(rcfg, RefAdamWConfig(), iterated=iterated,
                                 expert_probe=True)
    assert [(r.region_id, r.path) for r in got.regions()] == \
        [(r.region_id, r.path) for r in want.regions()]
    assert "train/moe/expert_3" in [r.path for r in got.regions()]
    with pytest.raises(ValueError, match="needs an MoE config"):
        train_region_tree(get_arch("st-100m").smoke, AdamWConfig(),
                          expert_probe=True)


def test_traced_moe_trainer_runs_its_probes():
    """Expert e's region runs its FFN expert_iters[shard][e] times: the
    carried accumulator is the sum over those iterations of the rolled
    tile's FFN output; the per-step metrics carry the (L, E) counts."""
    cfg = get_arch("mixtral-8x22b").smoke
    iters = ((1, 3, 0, 2), (0, 0, 0, 1))
    t = Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
                DataConfig(seq_len=16, global_batch=4, vocab=cfg.vocab),
                TrainerConfig(steps=1, trace_shards=2,
                              trace_expert_iters=iters), device="cpu")
    params0 = dict(t.params)
    t.run()
    for shard, row in enumerate(iters):
        toks = t._probe_tokens[shard]
        want = torch.zeros(())
        for e, n in enumerate(row):
            wi, wg, wo = (params0[f"blocks.0.moe.{w}"][e]
                          for w in ("wi", "wg", "wo"))
            for i in range(n):
                x = torch.roll(toks, i, dims=0)
                want = want + (layers._act(x @ wg, cfg.activation)
                               * (x @ wi) @ wo).sum()
        # warmup=1 runs each region once more on the same input state
        np.testing.assert_allclose(float(t._shard_states[shard]["probe"]),
                                   float(want), rtol=1e-5)
    # every expert's region counts one FFN body, as the reference's
    # compiled cost does (its time per FLOP grows with its iterations)
    flops = {r.path: t.runner.costs[r.region_id][0]
             for r in t.region_tree.regions() if "/moe/expert_" in r.path}
    body = 3 * 2 * 64 * cfg.d_model * cfg.moe.d_ff
    assert set(flops.values()) == {float(body)}, flops
    step = t.train_step(t.params, t.opt_state, to_device(
        {"tokens": np.zeros((2, 16), np.int32),
         "labels": np.zeros((2, 16), np.int32)}, "cpu"))
    assert step[2]["expert_counts"].shape == (cfg.n_layers, 4)


def test_untraced_history_keeps_expert_counts():
    """An untraced step's history record carries the step's (L, E) expert
    counts as a host array, as the reference's ``Trainer.run`` copies
    them in: each layer routes every token to top_k experts (counted
    before the capacity drop)."""
    cfg = get_arch("mixtral-8x22b").smoke
    B, S = 2, 16
    t = Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
                DataConfig(seq_len=S, global_batch=B, vocab=cfg.vocab),
                TrainerConfig(steps=3), device="cpu")
    seen, step = [], t.train_step

    def spy(params, opt_state, batch):
        out = step(params, opt_state, batch)
        seen.append(out[2]["expert_counts"].clone())
        return out

    t.train_step = spy
    hist = t.run()
    assert len(hist) == len(seen) == 3
    for rec, want in zip(hist, seen):
        got = rec["expert_counts"]
        assert isinstance(got, np.ndarray)
        assert got.shape == (cfg.n_layers, cfg.moe.n_experts)
        np.testing.assert_array_equal(got.sum(axis=1),
                                      B * S * cfg.moe.top_k)
        np.testing.assert_array_equal(got, want.numpy())


def test_mixtral_checkpoint_restores_across_packages(tmp_path):
    cfg, rcfg = get_arch("mixtral-8x22b").smoke, \
        ref_arch("mixtral-8x22b").smoke
    d = str(tmp_path / "port")
    t = Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
                DataConfig(seq_len=16, global_batch=2, vocab=cfg.vocab),
                TrainerConfig(steps=2, ckpt_dir=d, ckpt_every=0),
                device="cpu")
    t.run()
    rparams, _ = ref_build(rcfg).init(jax.random.key(1))
    templates = {"params": rparams, "opt_state": ref_init_opt_state(rparams)}
    step, trees = ref_ckpt.restore(d, templates)
    assert step == 2 and "moe" in trees["params"]["layers"]
    for got, want in ((trees["params"], params_to_numpy(t.params, cfg)),
                      (trees["opt_state"]["v"],
                       params_to_numpy(t.opt_state["v"], cfg))):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), b)
    # and the reference's checkpoint restores in the port
    d = str(tmp_path / "ref")
    ref_ckpt.save(d, 5, templates, meta={"config": "mixtral-smoke"})
    t = Trainer(cfg, AdamWConfig(), DataConfig(vocab=cfg.vocab),
                TrainerConfig(steps=0, ckpt_dir=d), device="cpu")
    assert ckpt.verify_step(d, 5) is None
    assert t.maybe_resume() and t.step == 5
    for a, b in zip(jax.tree.leaves(params_to_numpy(t.params, cfg)),
                    jax.tree.leaves(jax.tree.map(np.asarray, rparams))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", MOE_ENTRIES)
def test_moe_entry_passes_with_the_references_outcome(name):
    e, ref = CORPUS[name], REF_CORPUS[name]
    assert (e.app, e.backend, dataclasses.asdict(e.truth), e.analyzer_kw,
            e.min_precision, e.recovery and dataclasses.asdict(e.recovery)) \
        == (ref.app, ref.backend, dataclasses.asdict(ref.truth),
            ref.analyzer_kw, ref.min_precision,
            ref.recovery and dataclasses.asdict(ref.recovery))
    r = run_entry_robust(e, seed=0, analyzer_overrides={"device": "cpu"})
    assert r.passed and "train/moe/expert_1" in r.found, \
        (sorted(r.found), r.recovery_kind, r.mitigation_window)
    if e.recovery is not None:
        assert (r.recovery_kind, r.mitigation_window) == \
            ("rebalance_experts", 1) and r.clean_after >= 3


# -- chip_smoke's phases 19-21, rehearsed on the host ----------------------

def test_chip_smoke_moe_phases_rehearsed():
    cs = _chip_smoke()
    cfg = get_arch("deepseek-v2-lite-16b").smoke
    assert cs.launches_per_call(get_arch("deepseek-v2-lite-16b").full) == \
        {"rmsnorm": 55, "flash_attention": 27}
    p = cs.moe_parity_phase(cfg, "cpu", chunk=16, steps=4)
    assert p["calls"] == 5 and p["max_abs_err"] == 0.0
    assert len(p["expert_ids"]) == 5 and p["min_margin"] >= 0.0
    t = cs.train_parity_phase(cfg, "cpu", batch=2, seq=16, steps=0)
    assert t["loss"][0] == t["loss"][1] and t["forwards"] == 2
    for name in cs.ATTN_MLA:
        assert cs.check_attention(name, "cpu")["f32"] == 0.0
        own, padded = (cs.attention_bound_ms(name, 2, padded=p)[0]
                       for p in (False, True))
        assert 0 < own < padded
    s = cs.serve_phase(("--arch", "deepseek-v2-lite-16b", "--smoke",
                        "--lanes", "2", "--requests", "3", "--prompt-len",
                        "16", "--chunk", "8", "--gen", "4"), "cpu")
    assert s["model_calls"] > 0 and s["verdict"] is not None


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_model_on_card_matches_reference(cuda, arch):
    """The smoke model on the card through the kernels (2L + 1 RMSNorms and
    L attentions a forward) against the host's plain path on the
    reference's weights (held to the reference by the tests above; JAX is
    not run here, as on a card it would compute float32 products in
    TF32): logits within 1e-5 of scale, the expert counts exact."""
    from repro_torch import kernels as K
    _, cfg, _, state = _carried(arch)
    host = transformer.Transformer(cfg, "cpu", seed=None)
    host.load_state_dict(state)
    card = transformer.Transformer(cfg, cuda, seed=None)
    card.load_state_dict(state)
    for shape in ((2, 24), (2, 64), (8, 1)):
        toks = torch.from_numpy(np.random.default_rng(9).integers(
            0, cfg.vocab, shape, dtype=np.int32))
        want, winfo = host(toks)
        K.reset_launches()
        got, info = card(toks.to(cuda))
        torch.cuda.synchronize()
        assert (K.LAUNCHES["rmsnorm"], K.LAUNCHES["flash_attention"]) == \
            (2 * cfg.n_layers + 1, cfg.n_layers)
        _close_to_scale(got.cpu(), want, OUT_TOL)
        assert torch.equal(info["expert_counts"].cpu(),
                           winfo["expert_counts"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_padded_v_on_card(cuda, dtype):
    """MLA's call of the attention kernel, q and k at nope + rope, v
    zero-padded: the kernel against its plain version, and the padded
    columns of the output exactly 0."""
    from repro_torch import kernels as K
    cfg = get_arch("deepseek-v2-lite-16b").smoke
    rng = np.random.default_rng(11)
    m = cfg.mla
    B, S, H = 2, 40, cfg.n_heads
    dh, dv = m.nope_head_dim + m.rope_head_dim, m.v_head_dim
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, dh)))
               .to(cuda, dtype) for _ in range(3))
    v[..., dv:] = 0
    pos = torch.arange(S, dtype=torch.int32, device=cuda)
    got = K.flash_attention(q, k, v, pos, pos)
    want = K.flash_attention_ref(q.float(), k.float(), v.float(), pos, pos)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert float((got.float() - want).abs().max()) <= \
        tol * (1 + float(want.abs().max()))
    assert not bool(got[..., dv:].any())
