"""The port's encdec family against the reference's, on the same numpy
inputs.

seamless-smoke (2 encoder and 2 decoder layers, d 64, 16 stub frames) is
initialised in JAX and moved across as numpy through
``params_from_numpy``; frames and tokens are drawn with numpy from a seed
and given to both packages.  Tolerances, and why (float32 both sides; the
two differ only in the order of float32 sums):

* ``encode`` and the cross K/V of ``init_decode_state``: within 1e-5 of
  their scale;
* forward logits within 1e-5 of their scale; decode by token against the
  reference's decode and against the port's own forward;
* ``loss_fn``: the loss within 1e-5 relative, every gradient within 1e-4
  of its largest element (cross-attention's through the attention
  kernel's autograd Function at Q != K, non-causal);
* ``call_costs``: equal to ``FlopCounterMode``'s count of one decode
  call, the cross K/V read and not recomputed;
* served greedy tokens equal to the reference's ``JitBackend`` given the
  same frames.
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
from repro.models import build as ref_build
from repro.models import encdec as ref_encdec
from repro.scenarios import traffic as ref_traffic
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro.serve.runtime import JitBackend
from repro_torch.configs import get_arch
from repro_torch.models import build, encdec, layers
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.scenarios import traffic
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.runtime import (TorchBackend, call_costs,
                                       decode_weight_bytes)
from repro_torch.train.loop import value_and_grad

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "seamless-m4t-medium"
OUT_TOL, LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """PyTorch's CPU ops on one thread for this module: tests run in
    parallel workers, beside corpus entries that time regions by the wall
    clock."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _carried(seed=0):
    rcfg, cfg = ref_arch(ARCH).smoke, get_arch(ARCH).smoke
    rparams, _ = ref_build(rcfg).init(jax.random.key(seed))
    state = params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, "cpu")
    model = encdec.EncDec(cfg, "cpu", seed=None)
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


def _frames(cfg, B, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


def test_encode_and_cross_kv_match_reference():
    rcfg, cfg, rparams, model = _carried()
    frames = _frames(cfg, 2)
    want = ref_encdec.encode(rparams, rcfg, jnp.asarray(frames))
    got = model.encode(torch.from_numpy(frames))
    _close_to_scale(got.detach().numpy(), want, OUT_TOL)
    st_r = ref_build(rcfg).init_decode_state(2, 12, params=rparams,
                                             enc_out=want)
    st = model.init_decode_state(2, 12, enc_out=got)
    for i in range(cfg.n_layers):
        for key in ("cross_k", "cross_v"):
            _close_to_scale(st[key][i].numpy(), st_r[key][i], OUT_TOL)


def test_zero_cross_state_without_an_encoding():
    """Without enc_out the cross K/V are zeros of enc_len (default
    frontend_tokens) frames, as the reference's placeholder."""
    rcfg, cfg = ref_arch(ARCH).smoke, get_arch(ARCH).smoke
    for enc_len in (None, 5):
        st_r = ref_build(rcfg).init_decode_state(1, 8, enc_len=enc_len)
        st = build(cfg, "cpu").init_decode_state(1, 8, enc_len=enc_len)
        assert len(st["cross_k"]) == cfg.n_layers
        assert tuple(st["cross_k"][0].shape) == st_r["cross_k"].shape[1:]
        assert not bool(st["cross_v"][1].any())
        assert len(st["layers"]) == cfg.n_layers


def test_forward_logits_match_reference():
    rcfg, cfg, rparams, model = _carried()
    frames = _frames(cfg, 2)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 10),
                                             dtype=np.int32)
    want, _ = ref_build(rcfg).forward(rparams, jnp.asarray(toks),
                                      embeds=jnp.asarray(frames))
    got, info = model(torch.from_numpy(toks), embeds=torch.from_numpy(frames))
    assert got.shape == (2, 10, cfg.vocab) and float(info["aux"]) == 0.0
    _close_to_scale(got.detach().numpy(), want, OUT_TOL)


def test_cross_attention_is_unroped_and_non_causal():
    """A query at position 0 sees every frame, and neither q nor k is
    roped: the kernel's output equals plain softmax attention over the
    projections, whatever the decoder's positions and window."""
    rcfg, cfg, rparams, model = _carried()
    layer = model.dec_layers[0]
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((1, 3, cfg.d_model))
                         .astype(np.float32))
    enc = torch.from_numpy(rng.standard_normal((1, 7, cfg.d_model))
                           .astype(np.float32))
    k, v = layer.cross_kv(enc)
    kpos = torch.arange(7, dtype=torch.int32)
    wcfg = cfg.with_(window=1)     # ignored by cross-attention
    got = layers.attention(layer.cross_attn, wcfg, x,
                           torch.tensor([0, 5, 9], dtype=torch.int32), None,
                           kv_override=(k, v, kpos))
    q = layers._project(x, layer.cross_attn["wq"])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / cfg.resolved_head_dim ** 0.5
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    want = layers._out_project(o, layer.cross_attn["wo"])
    _close_to_scale(got.detach().numpy(), want.detach().numpy(), OUT_TOL)


def test_decode_by_token_matches_reference_and_forward():
    rcfg, cfg, rparams, model = _carried()
    api = ref_build(rcfg)
    frames = _frames(cfg, 1, seed=3)
    S = 9
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (1, S),
                                             dtype=np.int32)
    enc_r = ref_encdec.encode(rparams, rcfg, jnp.asarray(frames))
    st_r = api.init_decode_state(1, S + 1, params=rparams, enc_out=enc_r)
    full, _ = model(torch.from_numpy(toks), embeds=torch.from_numpy(frames))
    st = build(cfg, "cpu").init_decode_state(
        1, S + 1, model=model, enc_out=model.encode(torch.from_numpy(frames)))
    step = jax.jit(lambda p, s, t, pos: api.decode_step(p, s, t, pos))
    for pos in range(S):
        lr, st_r = step(rparams, st_r, jnp.asarray(toks[:, pos:pos + 1]),
                        jnp.int32(pos))
        lp, _ = model.decode_step(st, torch.from_numpy(toks[:, pos:pos + 1]),
                                  pos)
        _close_to_scale(lp.numpy(), lr, OUT_TOL)
        _close_to_scale(lp[:, 0].numpy(), full[:, pos].detach().numpy(),
                        OUT_TOL)
    assert st["layers"][0]["idx"] == S


def test_loss_and_grads_match_jax_value_and_grad():
    """The reference's encdec loss takes no mask: the batch's mask is not
    read."""
    rcfg, cfg, rparams, model = _carried()
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    mask = np.zeros((2, 12), np.float32)
    frames = _frames(cfg, 2, seed=5)
    batch = {"tokens": toks, "labels": toks, "mask": mask, "embeds": frames}
    (rtotal, rinfo), rgrads = jax.value_and_grad(
        ref_build(rcfg).loss_fn, has_aux=True)(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    skeleton = encdec.EncDec(cfg, "meta", seed=None)
    total, info, grads = value_and_grad(
        skeleton, dict(model.state_dict()),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for a, b in ((total, rtotal), (info["loss"], rinfo["loss"])):
        np.testing.assert_allclose(float(a), float(b), rtol=LOSS_RTOL)
    got = params_to_numpy(grads, cfg)
    want = jax.tree.map(np.asarray, rgrads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close_to_scale(a, b, GRAD_TOL)


def test_params_tree_round_trips():
    rcfg, cfg, rparams, model = _carried()
    tree = params_to_numpy(dict(model.state_dict()), cfg)
    want = jax.tree.map(np.asarray, rparams)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tokens", [1, 4])
def test_call_costs_equal_the_flop_counter(tokens):
    """One decode call against T_enc = 16 cached cross frames: its matrix
    products are the formula's; the weight bytes leave out the encoder
    and the cross wk/wv, read at the request's encode."""
    cfg = get_arch(ARCH).smoke
    model = encdec.EncDec(cfg, "cpu", seed=0)
    backend = TorchBackend(cfg, build(cfg, "cpu"), model, lanes=1,
                           max_len=20, prefill_chunk=1,
                           embeds_fn=lambda req: None)
    assert backend.enc_len == cfg.frontend_tokens == 16
    state = backend.fresh_state()
    toks = torch.zeros((1, tokens), dtype=torch.int32)
    pos = torch.arange(tokens, dtype=torch.int32) if tokens > 1 else 0
    with FlopCounterMode(display=False) as fc:
        model.decode_step(state, toks, pos)
    flops, nbytes = call_costs(cfg, tokens, 20, backend.weight_bytes,
                               backend.enc_len)
    assert flops == float(fc.get_total_flops())
    d, L = cfg.d_model, cfg.n_layers
    enc = sum(p.numel() for n, p in model.named_parameters()
              if n.startswith("enc_"))
    total = sum(p.numel() for p in model.parameters())
    assert backend.weight_bytes == decode_weight_bytes(cfg, model) == \
        4 * (total - enc - L * 2 * d * d)
    KV, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    assert nbytes == float(backend.weight_bytes
                           + L * 2 * (20 + tokens) * KV * dh * 4
                           + 2 * L * 16 * KV * dh * 4
                           + 4 * tokens * cfg.vocab)


def _np_frames(cfg, rid):
    return np.random.default_rng(131 + rid).standard_normal(
        (1, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


def test_served_tokens_equal_jit_backend():
    """Each request encoded from the same frames in both packages; its
    greedy tokens equal.  The port's warmup encodes zero frames once."""
    rcfg, cfg, rparams, model = _carried()
    tkw = dict(n_requests=3, arrival_rate=2.0, length_buckets=(8,),
               length_mix=(1.0,), gen_len=5, vocab=cfg.vocab)
    max_len = 8 + 5 + 1
    ref_b = JitBackend(rcfg, ref_build(rcfg), rparams, lanes=2,
                       max_len=max_len, prefill_chunk=1,
                       embeds_fn=lambda r: jnp.asarray(_np_frames(cfg,
                                                                  r.rid)))
    RefServeEngine(RefServeConfig(lanes=2, max_len=max_len, prefill_chunk=1),
                   ref_traffic.generate_traffic(
                       ref_traffic.TrafficConfig(**tkw), 0), ref_b).run()
    b = TorchBackend(cfg, build(cfg, "cpu"), model, lanes=2,
                     max_len=max_len, prefill_chunk=1,
                     embeds_fn=lambda r: torch.from_numpy(
                         _np_frames(cfg, r.rid)))
    e = ServeEngine(ServeConfig(lanes=2, max_len=max_len, prefill_chunk=1),
                    traffic.generate_traffic(traffic.TrafficConfig(**tkw), 0),
                    b)
    e.run()
    assert b.outputs == ref_b.outputs and len(b.outputs) == 3
    assert b.encode_calls == 1 + 3
    assert b.model_calls == 1 + 3 * 8 + e.tokens_decode
    with pytest.raises(ValueError, match="embeds_fn"):
        TorchBackend(cfg, build(cfg, "cpu"), model, lanes=1, max_len=8,
                     prefill_chunk=1)


def test_chip_smoke_encdec_phase_rehearsed_on_cpu():
    """Phase 24 at the smoke size on the host: encode, decode and a train
    step card against host, then the served phase counting its encodes."""
    cs = _chip_smoke()
    cfg = cs.parity_config(ARCH)
    assert (cfg.n_layers, cfg.n_encoder_layers, cfg.d_model) == (2, 2, 1024)
    res = cs.family_parity_phase(get_arch(ARCH).smoke, "cpu")
    assert res["forward"]["max_abs_err"] == 0.0
    assert res["forward"]["shape"] == [1, 16, 256]
    assert res["forward"]["encoder_err"] == 0.0
    assert len(res["decode"]["tokens"]) == 5
    assert cs.launches_per_call(get_arch(ARCH).full) == {
        "rmsnorm": 37, "flash_attention": 24}
    assert cs.launches_per_encode(get_arch(ARCH).full) == {
        "rmsnorm": 25, "flash_attention": 12}
    argv = ("--arch", ARCH, "--smoke", "--lanes", "2", "--requests", "2",
            "--prompt-len", "6", "--gen", "3")
    served = cs.serve_phase(argv, "cpu")
    assert served["summary"]["requests_completed"] == 2
    assert served["encode_calls"] == 1 + 2
    assert served["model_calls"] == 1 + 2 * 6 + 2 * 3


def test_chip_smoke_seamless_cases_are_non_causal():
    """Phase 6's seamless cases: every (query, key) pair live, so the
    bound counts all of them; the encoder takes wgmma, the cross decode
    split-K."""
    cs = _chip_smoke()
    for name, Q, path in (("seamless-encode", 1024, "wgmma"),
                          ("seamless-cross", 1, "split")):
        c = cs.attention_case(name)
        assert c["causal"] is False and c["window"] is None
        assert len(c["q_pos"]) == Q and len(c["k_pos"]) == 1024
        assert cs.attention_plan_of(name, torch.bfloat16).path == path
    ms, by = cs.attention_bound_ms("seamless-encode", 2)
    ops = 4 * 64 * 16 * 1024 * 1024
    assert by == "operations" and abs(ms - ops / 989e12 * 1e3) < 1e-12
    # the cross query at position 40 sees frames 41.. too
    errs = cs.check_attention("seamless-cross", "cpu")
    assert errs["f32"] == 0.0


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_encdec_on_card_matches_host(cuda):
    """The smoke model through the kernels against the host's plain path
    on the reference's weights: an encode (2·L_enc + 1 RMSNorms, L_enc
    attentions), a forward, 9 tokens decoded one a call; logits within
    1e-5 of scale; the loss within 1e-5 relative and every gradient within
    1e-4 of its scale."""
    from repro_torch import kernels as K
    _, cfg, _, host = _carried()
    card = encdec.EncDec(cfg, cuda, seed=None)
    card.load_state_dict(host.state_dict())
    frames = torch.from_numpy(_frames(cfg, 1, seed=9))
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (1, 9), dtype=np.int32))
    K.reset_launches()
    enc_c = card.encode(frames.to(cuda))
    torch.cuda.synchronize()
    assert (K.LAUNCHES["rmsnorm"], K.LAUNCHES["flash_attention"]) == \
        (2 * cfg.n_encoder_layers + 1, cfg.n_encoder_layers)
    enc_h = host.encode(frames)
    _close_to_scale(enc_c.detach().cpu(), enc_h.detach(), OUT_TOL)
    want, _ = host(toks, embeds=frames)
    got, _ = card(toks.to(cuda), embeds=frames.to(cuda))
    _close_to_scale(got.detach().cpu(), want.detach(), OUT_TOL)
    st_h = host.init_decode_state(1, 10, enc_out=enc_h)
    st_c = card.init_decode_state(1, 10, enc_out=enc_c)
    for pos in range(9):
        lh, _ = host.decode_step(st_h, toks[:, pos:pos + 1], pos)
        lc, _ = card.decode_step(st_c, toks[:, pos:pos + 1].to(cuda), pos)
        _close_to_scale(lc.cpu(), lh, OUT_TOL)
    batch = {"tokens": toks, "labels": toks, "embeds": frames}
    skeleton = encdec.EncDec(cfg, "meta", seed=None)
    h = value_and_grad(skeleton, dict(host.state_dict()), batch)
    c = value_and_grad(skeleton, dict(card.state_dict()),
                       {k: v.to(cuda) for k, v in batch.items()})
    np.testing.assert_allclose(float(c[0]), float(h[0]), rtol=LOSS_RTOL)
    for k in h[2]:
        _close_to_scale(c[2][k].cpu(), h[2][k], GRAD_TOL)
