"""The port's hybrid family (RG-LRU + local MQA) against the reference's,
on the same numpy inputs.

rgemma-smoke (3 layers: one (rec, rec, attn) block; MQA with head_dim 16
and a 16-slot window) and its 5-layer variant (a (rec, rec) tail after the
block) are initialised in JAX and moved across as numpy through
``params_from_numpy``.  Tolerances, and why (float32 both sides; the two
differ only in the order of float32 sums and the scan's tree):

* ``rglru_scan`` against the reference's ``rglru_scan`` (an associative
  scan) and ``rglru_scan_reference`` (sequential), with and without h0,
  the conv and the block: within 1e-5 of their scale;
* forward logits within 1e-5 of their scale; decode by token against the
  reference's decode and against the port's own forward;
* ``loss_fn``: the loss within 1e-5 relative, every gradient within 1e-4
  of its largest element;
* ``call_costs``: ``FlopCounterMode``'s count of one call plus the conv's
  and the recurrence's elementwise FLOPs, counted by hand;
* served greedy tokens equal to the reference's ``JitBackend``.

Also the reference behaviours the port keeps: ``param_count``'s short
count and ``kv_bytes_per_token`` over every layer.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_arch as ref_arch
from repro.configs import shapes_for as ref_shapes_for
from repro.models import build as ref_build
from repro.models import rglru as ref_rglru
from repro.scenarios import traffic as ref_traffic
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro.serve.runtime import JitBackend
from repro_torch.configs import get_arch, shapes_for
from repro_torch.data import to_device
from repro_torch.models import build, rglru, transformer
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.scenarios import traffic
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.runtime import TorchBackend, call_costs
from repro_torch.train.loop import value_and_grad

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "recurrentgemma-9b"
OUT_TOL, LOSS_RTOL, GRAD_TOL, SCAN_TOL = 1e-5, 1e-5, 1e-4, 1e-5
LAYERS = [3, 5]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """PyTorch's CPU ops on one thread for this module: tests run in
    parallel workers, beside corpus entries that time regions by the wall
    clock."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _carried(n_layers=3, seed=0):
    rcfg = ref_arch(ARCH).smoke.with_(n_layers=n_layers)
    cfg = get_arch(ARCH).smoke.with_(n_layers=n_layers)
    rparams, _ = ref_build(rcfg).init(jax.random.key(seed))
    state = params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, "cpu")
    model = transformer.Transformer(cfg, "cpu", seed=None)
    model.load_state_dict(state)
    return rcfg, cfg, rparams, model


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


# -- the RG-LRU block --------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("T", [1, 2, 37, 64])
def test_rglru_scan_matches_both_reference_scans(with_h0, T):
    rng = np.random.default_rng(T)
    a = rng.uniform(0.7, 0.999, (2, T, 24)).astype(np.float32)
    bx = rng.standard_normal((2, T, 24)).astype(np.float32)
    h0 = rng.standard_normal((2, 24)).astype(np.float32) if with_h0 \
        else None
    ta, tb = torch.from_numpy(a), torch.from_numpy(bx)
    th0 = None if h0 is None else torch.from_numpy(h0)
    ja, jb = jnp.asarray(a), jnp.asarray(bx)
    jh0 = None if h0 is None else jnp.asarray(h0)
    want_assoc = ref_rglru.rglru_scan(ja, jb, jh0)
    want_seq = ref_rglru.rglru_scan_reference(ja, jb, jh0)
    got = rglru.rglru_scan(ta, tb, th0)
    got_seq = rglru.rglru_scan_reference(ta, tb, th0)
    for g in (got, got_seq):
        _close_to_scale(g.numpy(), want_assoc, SCAN_TOL)
        _close_to_scale(g.numpy(), want_seq, SCAN_TOL)


def test_rglru_scan_is_differentiable_out_of_place():
    """Gradients through the doubling scan equal those through the
    sequential oracle."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.7, 0.99, (1, 19, 6))
                         .astype(np.float32))
    bx = torch.from_numpy(rng.standard_normal((1, 19, 6)).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((1, 6)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((1, 19, 6)).astype(np.float32))
    grads = []
    for fn in (rglru.rglru_scan, rglru.rglru_scan_reference):
        ins = [t.clone().requires_grad_() for t in (a, bx, h0)]
        (fn(*ins) * g).sum().backward()
        grads.append([t.grad for t in ins])
    for x, y in zip(*grads):
        _close_to_scale(x.numpy(), y.numpy(), SCAN_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state \
        else None
    want, want_st = ref_rglru._causal_conv1d(
        jnp.asarray(x), jnp.asarray(w), None if st is None
        else jnp.asarray(st))
    got, got_st = rglru.causal_conv1d(
        torch.from_numpy(x), torch.from_numpy(w),
        None if st is None else torch.from_numpy(st))
    _close_to_scale(got.numpy(), want, OUT_TOL)
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))


@pytest.mark.parametrize("T", [1, 9])
def test_rglru_block_matches_reference_from_a_state(T):
    """The block from a non-zero state: T = 1 takes the one-step path in
    both packages, T = 9 the scan from h0; outputs and the new state."""
    rcfg, cfg, rparams, model = _carried()
    rp = jax.tree.map(lambda a: a[0], rparams["blocks"]["sub0"]["mix"])
    p = model.blocks[0]["sub0"].mix
    rng = np.random.default_rng(T)
    w = rglru.width(cfg)
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((2, 3, w)).astype(np.float32)
    h = rng.standard_normal((2, w)).astype(np.float32)
    want, wst = ref_rglru.rglru_block(
        rp, rcfg, jnp.asarray(x), {"conv": jnp.asarray(conv),
                                   "h": jnp.asarray(h)})
    st = {"conv": torch.from_numpy(conv), "h": torch.from_numpy(h)}
    got = rglru.rglru_block(p, cfg, torch.from_numpy(x), st)
    _close_to_scale(got.detach().numpy(), want, OUT_TOL)
    _close_to_scale(st["h"].numpy(), wst["h"], OUT_TOL)
    np.testing.assert_array_equal(st["conv"].detach().numpy(),
                                  np.asarray(wst["conv"]))
    assert st["h"].dtype == torch.float32


def test_lam_draw_is_the_references_range():
    cfg = get_arch(ARCH).smoke
    lam = transformer.Transformer(cfg, "cpu", seed=3).blocks[0]["sub1"] \
        .mix["lam"]
    assert 3.0 <= float(lam.min()) and float(lam.max()) < 6.0


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("n_layers", LAYERS)
def test_forward_logits_match_reference(n_layers):
    """24 tokens: past the 16-slot window, so the local attention masks."""
    rcfg, cfg, rparams, model = _carried(n_layers)
    assert (model.tail is not None) == (n_layers == 5)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 24),
                                             dtype=np.int32)
    want, _ = ref_build(rcfg).forward(rparams, jnp.asarray(toks))
    got, info = model(torch.from_numpy(toks))
    assert got.shape == (2, 24, cfg.vocab) and float(info["aux"]) == 0.0
    _close_to_scale(got.numpy(), want, OUT_TOL)


@pytest.mark.parametrize("n_layers", LAYERS)
def test_decode_by_token_matches_reference_and_forward(n_layers):
    """tests/test_models_consistency.py's decode-vs-forward check, and the
    reference's own decode: 20 tokens fed one a call (the ring of 16
    slots wraps), every call's logits within 1e-5 of scale of both; the
    recurrent states (conv carry, float32 h) equal the reference's."""
    rcfg, cfg, rparams, model = _carried(n_layers)
    api = ref_build(rcfg)
    B, S = 2, 20
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (B, S),
                                             dtype=np.int32)
    full, _ = model(torch.from_numpy(toks))
    st_r = api.init_decode_state(B, S + 2)
    st = model.init_decode_state(B, S + 2)
    step = jax.jit(lambda p, s, t, pos: api.decode_step(p, s, t, pos))
    for pos in range(S):
        lr, st_r = step(rparams, st_r, jnp.asarray(toks[:, pos:pos + 1]),
                        jnp.int32(pos))
        lp, _ = model.decode_step(st, torch.from_numpy(toks[:, pos:pos + 1]),
                                  pos)
        _close_to_scale(lp.numpy(), lr, OUT_TOL)
        _close_to_scale(lp[:, 0].numpy(), full[:, pos].numpy(), OUT_TOL)
    for b, blk in enumerate(st["blocks"]):
        for name in ("sub0", "sub1"):
            for key in ("conv", "h"):
                _close_to_scale(blk[name][key].numpy(),
                                st_r["blocks"][name][key][b], OUT_TOL)
    assert st["blocks"][0]["sub0"]["h"].dtype == torch.float32
    assert st["blocks"][0]["sub2"]["idx"] == S
    np.testing.assert_array_equal(st["blocks"][0]["sub2"]["pos"].numpy(),
                                  np.asarray(st_r["blocks"]["sub2"]["pos"][0]))
    if n_layers == 5:
        for key in ("conv", "h"):
            _close_to_scale(st["tail"]["sub1"][key].numpy(),
                            st_r["tail"]["sub1"][key], OUT_TOL)


def test_bf16_state_keeps_h_in_float32():
    cfg = get_arch(ARCH).smoke.with_(dtype="bfloat16",
                                     param_dtype="bfloat16")
    model = transformer.Transformer(cfg, "cpu", seed=0)
    st = model.init_decode_state(1, 8)
    rec = st["blocks"][0]["sub0"]
    assert rec["conv"].dtype == torch.bfloat16
    logits, _ = model.decode_step(st, torch.zeros((1, 1), dtype=torch.int32),
                                  0)
    assert rec["h"].dtype == torch.float32 and bool(rec["h"].any())
    assert rec["conv"].dtype == torch.bfloat16
    assert logits.dtype == torch.float32


@pytest.mark.parametrize("n_layers", LAYERS)
def test_loss_and_grads_match_jax_value_and_grad(n_layers):
    rcfg, cfg, rparams, model = _carried(n_layers)
    B, S = 2, 24
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:, 20:] = 0.0
    (rtotal, rinfo), rgrads = jax.value_and_grad(
        ref_build(rcfg).loss_fn, has_aux=True)(
        rparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
                  "mask": jnp.asarray(mask)})
    skeleton = transformer.Transformer(cfg, "meta", seed=None)
    total, info, grads = value_and_grad(
        skeleton, dict(model.state_dict()),
        to_device({"tokens": toks, "labels": toks, "mask": mask}, "cpu"))
    for a, b in ((total, rtotal), (info["loss"], rinfo["loss"])):
        np.testing.assert_allclose(float(a), float(b), rtol=LOSS_RTOL)
    got = params_to_numpy(grads, cfg)
    want = jax.tree.map(np.asarray, rgrads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close_to_scale(a, b, GRAD_TOL)


def test_params_tree_round_trips():
    rcfg, cfg, rparams, model = _carried(5)
    tree = params_to_numpy(dict(model.state_dict()), cfg)
    want = jax.tree.map(np.asarray, rparams)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert "tail" in tree and "sub1" in tree["tail"]


def test_shapes_for_matches_reference():
    """The hybrid family takes long_500k, as the ssm family does."""
    for arch in ("recurrentgemma-9b", "rwkv6-3b", "gemma-7b",
                 "phi-3-vision-4.2b", "seamless-m4t-medium"):
        got = [vars(s) for s in shapes_for(get_arch(arch).full)]
        want = [vars(s) for s in ref_shapes_for(ref_arch(arch).full)]
        assert got == want
    names = [s.name for s in shapes_for(get_arch(ARCH).full)]
    assert names[-1] == "long_500k" and shapes_for(
        get_arch(ARCH).full)[-1].is_decode


# -- serving -----------------------------------------------------------------

@pytest.mark.parametrize("tokens", [1, 8])
def test_call_costs_equal_the_flop_counter(tokens):
    """One batch-1 call: the products FlopCounterMode counts plus the
    conv's (2·cw a channel) and the recurrence's (2 a channel) FLOPs of
    each recurrent sublayer; bytes by hand."""
    cfg = get_arch(ARCH).smoke.with_(n_layers=5)
    model = transformer.Transformer(cfg, "cpu", seed=0)
    backend = TorchBackend(cfg, build(cfg, "cpu"), model, lanes=1,
                           max_len=20, prefill_chunk=1)
    K = backend.cache_slots
    assert K == cfg.window == 16
    state = model.init_decode_state(1, 20)
    toks = torch.zeros((1, tokens), dtype=torch.int32)
    pos = torch.arange(tokens, dtype=torch.int32) if tokens > 1 else 0
    with FlopCounterMode(display=False) as fc:
        model.decode_step(state, toks, pos)
    flops, nbytes = call_costs(cfg, tokens, K, backend.weight_bytes)
    n_rec, n_att, w, cw = 4, 1, rglru.width(cfg), cfg.recurrent.conv_width
    assert flops == float(fc.get_total_flops()
                          + n_rec * tokens * w * (2 * cw + 2))
    dh, KV = cfg.resolved_head_dim, cfg.n_kv_heads
    cache = n_att * 2 * (K + tokens) * KV * dh * 4
    rec_state = n_rec * 2 * ((cw - 1) * w * 4 + 4 * w)
    assert backend.weight_bytes == 4 * sum(
        p.numel() for p in model.parameters())
    assert nbytes == float(backend.weight_bytes + cache + rec_state
                           + 4 * tokens * cfg.vocab)


def test_kv_bytes_per_token_counts_every_layer():
    """The reference's formula 2·L·KV·dh·a counts all L layers, though
    only the attention sublayers hold a cache (ROADMAP.md §3)."""
    rcfg, cfg = ref_arch(ARCH).full, get_arch(ARCH).full
    model = transformer.Transformer(cfg, "meta", seed=None)
    b = TorchBackend(cfg, build(cfg, "cpu"), model, lanes=1, max_len=81,
                     prefill_chunk=1)
    assert b.kv_bytes_per_token == 2 * 38 * 1 * 256 * 2 == 38912
    ref_b = JitBackend(rcfg, ref_build(rcfg), None, lanes=1, max_len=81,
                       prefill_chunk=1)
    assert ref_b.kv_bytes_per_token == b.kv_bytes_per_token
    caches = sum(isinstance(st, dict) and "k" in st
                 for blk in transformer.init_decode_state(
                     cfg, 1, 4, "meta")["blocks"] for st in blk.values())
    assert caches == 12


def test_param_count_is_the_references_short_count():
    """param_count gives 8,523,935,744; the model holds 8,959,881,216
    parameters (ROADMAP.md §3)."""
    cfg = get_arch(ARCH).full
    assert cfg.param_count() == ref_arch(ARCH).full.param_count() \
        == 8_523_935_744
    model = transformer.Transformer(cfg, "meta", seed=None)
    assert sum(p.numel() for p in model.parameters()) == 8_959_881_216


def test_served_tokens_equal_jit_backend():
    """Per-token prefill and decode through TorchBackend on the
    reference's weights: the greedy tokens of JitBackend."""
    rcfg, cfg, rparams, model = _carried()
    tkw = dict(n_requests=3, arrival_rate=2.0, length_buckets=(12,),
               length_mix=(1.0,), gen_len=5, vocab=cfg.vocab)
    max_len = 12 + 5 + 1
    ref_b = JitBackend(rcfg, ref_build(rcfg), rparams, lanes=2,
                       max_len=max_len, prefill_chunk=1)
    RefServeEngine(RefServeConfig(lanes=2, max_len=max_len, prefill_chunk=1),
                   ref_traffic.generate_traffic(
                       ref_traffic.TrafficConfig(**tkw), 0), ref_b).run()
    b = TorchBackend(cfg, build(cfg, "cpu"), model, lanes=2,
                     max_len=max_len, prefill_chunk=1)
    e = ServeEngine(ServeConfig(lanes=2, max_len=max_len, prefill_chunk=1),
                    traffic.generate_traffic(traffic.TrafficConfig(**tkw), 0),
                    b)
    e.run()
    assert b.outputs == ref_b.outputs and len(b.outputs) == 3
    assert b.model_calls == 1 + 3 * 12 + e.tokens_decode
    with pytest.raises(ValueError, match="per-token decode cache"):
        TorchBackend(cfg, build(cfg, "cpu"), model, lanes=1, max_len=8,
                     prefill_chunk=4)


# -- chip_smoke ----------------------------------------------------------------

def test_chip_smoke_hybrid_phase_rehearsed_on_cpu():
    """Phase 23 at the smoke size on the host: the 5-layer cut's parity
    and train step, then the served phase with its launch and symbol
    expectations."""
    cs = _chip_smoke()
    cfg = cs.parity_config(ARCH, n_layers=5)
    assert cfg.n_layers == 5 and cfg.d_model == 4096
    res = cs.family_parity_phase(get_arch(ARCH).smoke.with_(n_layers=5),
                                 "cpu")
    assert res["decode"]["max_abs_err"] == 0.0
    assert res["forward"]["max_abs_err"] == 0.0
    assert res["train"]["loss"][0] == res["train"]["loss"][1]
    assert cs.launches_per_call(get_arch(ARCH).full) == {
        "rmsnorm": 77, "flash_attention": 12}
    assert cs.decode_symbols(get_arch(ARCH).full, 81)["flash_attention"] \
        == "flash_attention_wgmma_kernel"
    argv = ("--arch", ARCH, "--smoke", "--lanes", "2", "--requests", "2",
            "--prompt-len", "6", "--gen", "3")
    served = cs.serve_phase(argv, "cpu")
    assert served["summary"]["requests_completed"] == 2
    assert served["model_calls"] == 1 + 2 * 6 + 2 * 3
    assert served["launches"] == {"rmsnorm": 0, "flash_attention": 0}


def test_chip_smoke_mqa_case_wraps_its_ring():
    """Phase 6's recurrentgemma-9b decode: one query at position 3000 over
    a wrapped 2048-slot ring, every slot live in the window; 16 query rows
    on one kv head take wgmma in bf16 and the CUDA-core kernel in
    float32."""
    cs = _chip_smoke()
    c = cs.attention_case("rgemma-decode")
    assert (c["H"], c["KV"], c["dh"], c["window"]) == (16, 1, 256, 2048)
    assert c["k_pos"][952] == 3000 and c["k_pos"][953] == 953
    assert c["k_pos"].min() == 953 and list(c["q_pos"]) == [3000]
    assert cs.attention_plan_of("rgemma-decode", torch.bfloat16).path == \
        "wgmma"
    assert cs.attention_plan_of("rgemma-decode", torch.float32).path == \
        "simt"
    ms, by = cs.attention_bound_ms("rgemma-decode", 2)
    nbytes = 2 * (2 * 16 * 256 + 2 * 2048 * 256) + 4 * (1 + 2048)
    assert by == "bytes" and abs(ms - nbytes / 3.35e12 * 1e3) < 1e-12
    errs = cs.check_attention("rgemma-decode", "cpu")
    assert errs["f32"] == 0.0


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_hybrid_on_card_matches_host(cuda):
    """The 5-layer smoke model through the kernels against the host's
    plain path on the reference's weights: a forward (2L + 1 RMSNorms and
    one attention a block), then 20 tokens decoded one a call from the
    carried state; logits within 1e-5 of scale."""
    from repro_torch import kernels as K
    _, cfg, _, host = _carried(5)
    card = transformer.Transformer(cfg, cuda, seed=None)
    card.load_state_dict(host.state_dict())
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (2, 20), dtype=np.int32))
    want, _ = host(toks)
    K.reset_launches()
    got, _ = card(toks.to(cuda))
    torch.cuda.synchronize()
    assert (K.LAUNCHES["rmsnorm"], K.LAUNCHES["flash_attention"]) == \
        (2 * cfg.n_layers + 1, 1)
    _close_to_scale(got.cpu(), want, OUT_TOL)
    st_h, st_c = host.init_decode_state(2, 22), card.init_decode_state(2, 22)
    for pos in range(20):
        lh, _ = host.decode_step(st_h, toks[:, pos:pos + 1], pos)
        lc, _ = card.decode_step(st_c, toks[:, pos:pos + 1].to(cuda), pos)
        _close_to_scale(lc.cpu(), lh, OUT_TOL)
