"""The port's RWKV-6 model (ssm family) against the reference's, on the
same weights.

The reference's rwkv6-smoke parameters (2 layers, d 64, 4 heads of 16,
float32) are initialised in JAX; the parameters it starts at zero (the
token-shift mixes, w0, ln_x and the norms) are then set to seeded random
values, so that the token shift, the decay and the norms all matter; the
tree is moved across as numpy through ``params_from_numpy``, and both
packages run the same tokens.  Tolerance for float32 results: max |port −
reference| <= 1e-5 · max |reference| (the two differ only in the order of
float32 sums).  Six places where parity would break are pinned, each by
its own test: the group norm's population variance, its literal eps, the
gate in the activation dtype, the token-shift carries of the normed
input, channel-mix's unshifted receptance and its relu².  The serving
backend is held to the reference's ``JitBackend``, and chip_smoke.py's
phases 9–11 are rehearsed at a small size.
"""
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from repro.configs import get_arch as ref_arch
from repro.models import build as ref_build
from repro.models import rwkv as ref_rwkv
from repro.models.transformer import _rwkv_block
from repro.scenarios import traffic as ref_traffic
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro.serve.runtime import JitBackend
from repro_torch import kernels as K
from repro_torch.configs import get_arch
from repro_torch.core import BYTES, VMEM_PRESSURE
from repro_torch.models import build, rwkv, transformer
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models.layers import rms_norm
from repro_torch.scenarios import traffic
from repro_torch.serve import (ServeConfig, ServeEngine, TorchBackend,
                               call_costs)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "rwkv6-3b"
RTOL = 1e-5


def _randomized(params, seed=0):
    """The reference's tree as numpy, with its zero-initialised leaves set
    to seeded values: mixes uniform in (0, 1), w0, ln_x and the norms'
    weights 0.3·N(0, 1)."""
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    block = tree["layers"]["block"]
    for name in rwkv.ZERO_INIT:
        a = block[name]
        block[name] = (rng.uniform(0.0, 1.0, a.shape) if name.startswith("mu")
                       else 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
    for name in ("ln1", "ln2"):
        a = tree["layers"][name]
        tree["layers"][name] = (0.3 * rng.standard_normal(a.shape)
                                ).astype(a.dtype)
    tree["final_norm"] = (0.3 * rng.standard_normal(
        tree["final_norm"].shape)).astype(tree["final_norm"].dtype)
    return tree


def _pair(seed=0, **over):
    """(reference cfg, api, jnp params, port cfg, port model) on the same
    randomized smoke weights, with ``over`` applied to both configs."""
    rcfg = ref_arch(ARCH).smoke.with_(**over)
    cfg = get_arch(ARCH).smoke.with_(**over)
    api = ref_build(rcfg)
    params, _ = api.init(jax.random.key(seed))
    tree = _randomized(params, seed)
    model = transformer.Transformer(cfg, "cpu", seed=None)
    model.load_state_dict(params_from_numpy(tree, cfg, "cpu"))
    return rcfg, api, jax.tree.map(jnp.asarray, tree), cfg, model


def _layer(params, i=0):
    """Layer i of the reference's stacked tree."""
    return jax.tree.map(lambda a: a[i], params["layers"])


def _close(got, want, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def _state(cfg, seed, B=2):
    """A seeded decode state of one layer, as numpy."""
    H, dh = rwkv.heads(cfg)
    rng = np.random.default_rng(seed)
    return {"S": (0.3 * rng.standard_normal((B, H, dh, dh))
                  ).astype(np.float32),
            "last_tm": rng.standard_normal((B, cfg.d_model)
                                           ).astype(np.float32),
            "last_cm": rng.standard_normal((B, cfg.d_model)
                                           ).astype(np.float32)}


def _x(cfg, seed, B=2, T=7):
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)


# -- the mixes -----------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_matches_reference(with_state):
    rcfg, _, params, cfg, model = _pair()
    x = _x(cfg, 1)
    st = _state(cfg, 2) if with_state else None
    want, want_st = ref_rwkv.rwkv_time_mix(
        _layer(params)["block"], rcfg, jnp.asarray(x),
        None if st is None else jax.tree.map(jnp.asarray, st))
    tst = None if st is None else {k: torch.from_numpy(v.copy())
                                   for k, v in st.items()}
    got, got_st = rwkv.rwkv_time_mix(model.blocks[0].block, cfg,
                                     torch.from_numpy(x), tst)
    _close(got, want)
    _close(got_st["S"], want_st["S"])
    _close(got_st["last_tm"], want_st["last_tm"])
    if with_state:   # the kernel updated the caller's state in place
        assert got_st["S"] is tst["S"]


@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_reference(with_state):
    rcfg, _, params, cfg, model = _pair()
    x = _x(cfg, 3)
    st = _state(cfg, 4) if with_state else None
    want, want_st = ref_rwkv.rwkv_channel_mix(
        _layer(params)["block"], rcfg, jnp.asarray(x),
        None if st is None else jax.tree.map(jnp.asarray, st))
    got, got_st = rwkv.rwkv_channel_mix(
        model.blocks[0].block, cfg, torch.from_numpy(x),
        None if st is None else {k: torch.from_numpy(v)
                                 for k, v in st.items()})
    _close(got, want)
    _close(got_st["last_cm"], want_st["last_cm"])


def test_group_norm_population_variance_and_literal_eps(monkeypatch):
    """Over dh = 16 the unbiased variance is 16/15 of the population one,
    and the group norm's eps is a literal 1e-5 whatever cfg.norm_eps says.
    With v scaled to 1e-3 the WKV output's variance is about 1e-6, so an
    eps of cfg.norm_eps = 1e-2 would change the output by far more than
    the tolerance; the port matches the reference, and would not with
    cfg.norm_eps in place of the literal."""
    rcfg, _, params, cfg, model = _pair(norm_eps=1e-2)
    lp = dict(_layer(params)["block"])
    lp["wv"] = lp["wv"] * 1e-3
    p = dict(model.blocks[0].block)
    p["wv"] = p["wv"] * 1e-3
    x = _x(cfg, 5)
    want, _ = ref_rwkv.rwkv_time_mix(lp, rcfg, jnp.asarray(x))
    got, _ = rwkv.rwkv_time_mix(p, cfg, torch.from_numpy(x))
    _close(got, want)
    with monkeypatch.context() as m:
        m.setattr(rwkv, "GROUP_NORM_EPS", cfg.norm_eps)
        wrong, _ = rwkv.rwkv_time_mix(p, cfg, torch.from_numpy(x))
    with pytest.raises(AssertionError):
        _close(wrong, want)
    # The same pin fails with the unbiased variance (torch's default).
    var = torch.Tensor.var
    monkeypatch.setattr(torch.Tensor, "var", lambda t, *a, correction=0,
                        **kw: var(t, *a, correction=1, **kw))
    wrong, _ = rwkv.rwkv_time_mix(p, cfg, torch.from_numpy(x))
    with pytest.raises(AssertionError):
        _close(wrong, want)


def test_time_mix_gate_in_activation_dtype():
    """bf16: ``y.astype(x.dtype) * silu(g)`` multiplies in bf16, so the
    output is bf16 (a float32 gate would make the ``wo`` product fail on
    mixed dtypes) and agrees with the reference within the bf16
    tolerance of the repository's kernel tests, 3e-2 of its scale."""
    rcfg, _, params, cfg, model = _pair(dtype="bfloat16",
                                        param_dtype="bfloat16")
    x = _x(cfg, 6)
    xb = jnp.asarray(x, jnp.bfloat16)
    want, want_st = ref_rwkv.rwkv_time_mix(_layer(params)["block"], rcfg, xb)
    assert want.dtype == jnp.bfloat16
    got, got_st = rwkv.rwkv_time_mix(
        model.blocks[0].block, cfg,
        tensor_from_numpy(np.asarray(xb), "cpu"))
    assert got.dtype == torch.bfloat16
    assert got_st["S"].dtype == torch.float32
    _close(got, want.astype(jnp.float32), rtol=3e-2)


def test_token_shift_carries_store_the_normed_input():
    """The reference's _rwkv_block normalizes before either mix, so
    last_tm and last_cm hold the last row of the normed inputs (ln1 and
    ln2 are random here, so normed and raw rows differ)."""
    rcfg, _, params, cfg, model = _pair()
    x = _x(cfg, 7)
    st = _state(cfg, 8)
    want, want_st = _rwkv_block(rcfg, jnp.asarray(x), _layer(params),
                                state=jax.tree.map(jnp.asarray, st))
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    blk = model.blocks[0]
    xt = torch.from_numpy(x)
    got = blk(xt, tst)
    _close(got, want)
    for name in ("S", "last_tm", "last_cm"):
        _close(tst[name], want_st[name])
    normed = rms_norm(xt, blk.ln1, cfg.norm_eps)[:, -1]
    assert torch.equal(tst["last_tm"], normed)
    assert not torch.allclose(tst["last_tm"], xt[:, -1])


def test_channel_mix_receptance_unshifted_and_relu_squared():
    """Channel-mix feeds ``cr`` the unshifted x and squares a relu, even
    with cfg.activation set to silu: the port matches the reference, and
    a receptance of the shifted x would not."""
    rcfg, _, params, cfg, model = _pair(activation="silu")
    x = _x(cfg, 9)
    st = _state(cfg, 10)
    want, _ = ref_rwkv.rwkv_channel_mix(_layer(params)["block"], rcfg,
                                        jnp.asarray(x),
                                        jax.tree.map(jnp.asarray, st))
    p = model.blocks[0].block
    xt = torch.from_numpy(x)
    last = torch.from_numpy(st["last_cm"])
    got, _ = rwkv.rwkv_channel_mix(p, cfg, xt, {"last_cm": last})
    _close(got, want)
    xs = rwkv._shift(xt, last)
    xk = xt + (xs - xt) * p["mu_c"]
    k = torch.relu(xk @ p["ck"]) ** 2
    wrong = torch.sigmoid(xk @ p["cr"]) * (k @ p["cv"])
    with pytest.raises(AssertionError):
        _close(wrong, want)


# -- the model -----------------------------------------------------------------

def test_forward_logits_match_reference():
    _, api, params, cfg, model = _pair()
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (2, 24),
                                              dtype=np.int32)
    want, _ = api.forward(params, jnp.asarray(toks))
    got, info = model(torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 24, cfg.vocab)
    _close(got, want)
    assert float(info["aux"]) == 0.0


@pytest.mark.parametrize("prompt_len", [12, 1])
def test_multi_token_then_per_token_decode_matches_reference(prompt_len):
    """A prompt in one multi-token decode_step, then greedy per-token
    steps carrying the state; every call's logits and the final state
    compared, the greedy tokens required equal."""
    _, api, params, cfg, model = _pair()
    prompt = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab, (1, prompt_len), dtype=np.int32)
    st_r = api.init_decode_state(1, 32)
    st = model.init_decode_state(1, 32)
    lr, st_r = api.decode_step(params, st_r, jnp.asarray(prompt),
                               jnp.arange(prompt_len, dtype=jnp.int32))
    lt, st2 = model.decode_step(st, torch.from_numpy(prompt),
                                torch.arange(prompt_len))
    assert st2 is st
    _close(lt, lr)
    for g in range(4):
        tok = int(np.argmax(np.asarray(lr)[0, -1]))
        assert int(lt[0, -1].argmax()) == tok
        lr, st_r = api.decode_step(params, st_r,
                                   jnp.asarray([[tok]], jnp.int32),
                                   jnp.int32(prompt_len + g))
        lt, _ = model.decode_step(
            st, torch.tensor([[tok]], dtype=torch.int32), prompt_len + g)
        _close(lt, lr)
    for i, layer in enumerate(st["layers"]):
        for name in ("S", "last_tm", "last_cm"):
            _close(layer[name], st_r["layers"][name][i])


def test_decode_state_and_seeded_init_mirror_the_reference():
    """init_decode_state: per layer S (B, H, dh, dh) float32 and the two
    carries (B, d) in the activation dtype, all zero.  Seeded init:
    init_rwkv_block's zeros, u at scale 1, matrices at 1/sqrt(fan_in);
    the full model has 3,073,231,360 parameters (6,146,462,720 bytes in
    bf16), where cfg.param_count() keeps the reference's 2,648,312,320."""
    cfg = get_arch(ARCH).smoke.with_(d_model=256, d_ff=512)
    st = transformer.init_decode_state(cfg, 3, 10, "cpu")
    assert len(st["layers"]) == cfg.n_layers
    layer = st["layers"][0]
    assert layer["S"].shape == (3, 16, 16, 16)
    assert layer["S"].dtype == torch.float32
    assert layer["last_tm"].shape == layer["last_cm"].shape == (3, 256)
    assert all(float(t.abs().max()) == 0.0 for t in layer.values())
    m = transformer.Transformer(cfg, "cpu", seed=5)
    p = m.blocks[0].block
    for name in rwkv.ZERO_INIT:
        assert float(p[name].abs().max()) == 0.0
    for name, want in (("u", 1.0), ("wr", 256 ** -0.5), ("cv", 512 ** -0.5),
                       ("w_lora_b", 64 ** -0.5)):
        assert abs(float(p[name].std()) / want - 1.0) < 0.1
    full = get_arch(ARCH).full
    meta = transformer.Transformer(full, "meta", seed=None)
    assert sum(t.numel() for t in meta.parameters()) == 3073231360
    assert sum(t.numel() * t.element_size()
               for t in meta.parameters()) == 6146462720
    assert full.param_count() == 2648312320


def test_build_admits_ssm_and_defaults_to_the_card():
    cfg = get_arch(ARCH).smoke
    if torch.cuda.is_available():
        assert build(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(cfg)
    api = build(cfg, "cpu")
    model = api.init(0)
    state = api.init_decode_state(1, 8)
    logits, _ = api.decode_step(model, state,
                                torch.zeros((1, 1), dtype=torch.int32), 0)
    assert logits.shape == (1, 1, cfg.vocab)
    assert float(state["layers"][0]["S"].abs().max()) > 0.0


# -- serving ---------------------------------------------------------------------

def test_torch_backend_matches_jit_backend():
    """rwkv6-smoke served one token per call (chunk 1, as supports_chunk
    says for ssm) in both packages on the same weights and traffic: the
    same greedy tokens, steps, trace layout and kv_append quantities."""
    rcfg, api, params, cfg, model = _pair()
    lanes, requests, prompt_len, gen, seed = 2, 3, 6, 4, 0
    tkw = dict(n_requests=requests, arrival_rate=2.0,
               length_buckets=(prompt_len,), length_mix=(1.0,),
               gen_len=gen, vocab=cfg.vocab)
    max_len = prompt_len + gen + 1
    ref_b = JitBackend(rcfg, api, params, lanes=lanes, max_len=max_len,
                       prefill_chunk=1, seed=seed)
    ref_e = RefServeEngine(
        RefServeConfig(lanes=lanes, max_len=max_len, prefill_chunk=1),
        ref_traffic.generate_traffic(ref_traffic.TrafficConfig(**tkw), seed),
        ref_b)
    ref_e.run()
    b = TorchBackend(cfg, build(cfg, "cpu"), model, lanes=lanes,
                     max_len=max_len, prefill_chunk=1, seed=seed)
    e = ServeEngine(
        ServeConfig(lanes=lanes, max_len=max_len, prefill_chunk=1),
        traffic.generate_traffic(traffic.TrafficConfig(**tkw), seed), b)
    e.run()
    assert b.outputs == ref_b.outputs and len(b.outputs) == requests
    assert e.step_idx == ref_e.step_idx and e.completed == requests
    tr, ref_tr = e.trace, ref_e.trace
    assert tr.region_ids == ref_tr.region_ids
    assert list(tr.meta) == list(ref_tr.meta)
    assert tr.metric(BYTES).shape == ref_tr.metric(BYTES).shape
    j = tr.col(b.tree.by_path("serve/kv_append").region_id)
    for metric in (BYTES, VMEM_PRESSURE):
        np.testing.assert_array_equal(tr.metric(metric)[..., j],
                                      ref_tr.metric(metric)[..., j])
    # One warmup call, then one model call per prompt and decoded token.
    assert b.model_calls == 1 + requests * prompt_len + e.tokens_decode
    with pytest.raises(ValueError, match="prefill_chunk=1"):
        TorchBackend(cfg, build(cfg, "cpu"), model, lanes=1, max_len=8,
                     prefill_chunk=4)


def test_call_costs_ssm_branch():
    """rwkv6-3b FULL: one decode token and a 64-token call, counted by
    hand from the formula in call_costs' docstring, with the model's own
    6,146,462,720 weight bytes."""
    cfg = get_arch(ARCH).full
    L, d, ff, V, H, dh = 32, 2560, 8960, 65536, 40, 64
    wb = 6146462720
    for S in (1, 64):
        flops = (2 * S * L * (6 * d * d + 2 * 64 * d + 2 * d * ff)
                 + 7 * S * L * H * dh * dh + 2 * S * d * V)
        nbytes = wb + 2 * L * H * dh * dh * 4 + 4 * S * V
        assert call_costs(cfg, S, 81, wb) == (float(flops), float(nbytes))
    assert call_costs(cfg, 1, 81, wb) == (5845811200.0, 6188667904.0)


# -- chip_smoke rehearsal ----------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_wkv6_phase_rehearsed_on_cpu():
    cs = _chip_smoke()
    for name in ("decode", "ragged"):
        errs = cs.check_wkv6(name, "cpu")
        assert errs == {"f32": 0.0, "bf16": 0.0, "rel": 0.0}
    assert cs.WKV_CASES["t512"][1] == 512
    # Decode: the float32 state read and written is most of the bytes.
    ms, by = cs.wkv6_bound_ms(1, 1, 40, 64, 2)
    nbytes = 3 * 2 * 2560 + 4 * 2560 + 4 * 2560 + 8 * 40 * 64 * 64 \
        + 4 * 2560
    assert nbytes == 1356800
    assert by == "bytes" and abs(ms - nbytes / 3.35e12 * 1e3) < 1e-12
    ms, by = cs.wkv6_bound_ms(1, 512, 40, 64, 2)
    assert by == "operations"
    # r·S (2·dh²) and the state update (3·dh²) per (token, head): 5·dh².
    assert abs(ms - 5 * 40 * 512 * 64 * 64 / 67e12 * 1e3) < 1e-12
    r, k, v, w, u, S0 = cs.wkv6_inputs("decode", "model", torch.bfloat16,
                                       "cpu")
    assert r.dtype == torch.bfloat16 and w.dtype == torch.float32
    assert bool(((w > 0) & (w < 1)).all()) and float(S0.abs().max()) > 0


def test_chip_smoke_profile_held_to_launch_counter():
    """decode_breakdown's busy time is summed from the profiler's rows, so
    the ported kernels' profiled launches must equal the launch counter's
    over the same calls; a row that lost one event fails the phase."""
    cs = _chip_smoke()
    rms = "void (anonymous namespace)::rmsnorm_kernel<__nv_bfloat16>(...)"
    rows = [(2.0, 1792, "nvjet_tst_64x8_64x16_4x1_v_bz_NNT"),
            (1.0, 520, rms),
            (0.5, 256, "void (anonymous namespace)::wkv6_kernel<"
                       "__nv_bfloat16, 64>(...)")]
    launched = {"multi_seed_rows": 0, "rmsnorm": 520, "flash_attention": 0,
                "wkv6": 256}
    assert cs.profile_complete(rows, launched) == {"rmsnorm": 520,
                                                   "wkv6": 256}
    with pytest.raises(AssertionError, match="incomplete"):
        cs.profile_complete([rows[0], (1.0, 519, rms), rows[2]], launched)
    with pytest.raises(AssertionError, match="incomplete"):
        cs.profile_complete(rows[:2], launched)
    # gemma's decode calls: each attention call is one split kernel and
    # one merge kernel; a lost merge event fails as a lost split would.
    split = ("void (anonymous namespace)::flash_attention_split_kernel<"
             "__nv_bfloat16, 1>(...)")
    merge = ("void (anonymous namespace)::flash_attention_merge_kernel<"
             "__nv_bfloat16>(...)")
    attn = [(1.0, 456, rms), (0.4, 224, split), (0.1, 224, merge)]
    launched = {"multi_seed_rows": 0, "rmsnorm": 456, "flash_attention": 224,
                "wkv6": 0}
    assert cs.profile_complete(attn, launched) == {"rmsnorm": 456,
                                                   "flash_attention": 224}
    for bad in ([attn[0], attn[1], (0.1, 223, merge)], attn[:2],
                [attn[0], (0.4, 223, split), attn[2]]):
        with pytest.raises(AssertionError, match="incomplete"):
            cs.profile_complete(bad, launched)
    # The tensor-core and CUDA-core paths launch one kernel a call.
    wg = "void (anonymous namespace)::flash_attention_wgmma_kernel<256>(...)"
    simt = ("void (anonymous namespace)::flash_attention_simt_kernel<float, "
            "64>(...)")
    launched = {"multi_seed_rows": 0, "rmsnorm": 0, "flash_attention": 5,
                "wkv6": 0}
    assert cs.profile_complete([(2.0, 3, wg), (1.0, 2, simt)],
                               launched) == {"flash_attention": 5}
    sc = cs.symbol_counts([(2.0, 3, wg), *attn])
    assert sc["counts"] == {"flash_attention_wgmma_kernel": 3,
                            "rmsnorm_kernel": 456,
                            "flash_attention_split_kernel": 224,
                            "flash_attention_merge_kernel": 224}


def test_chip_smoke_decode_calls_held_to_their_entry_kernels():
    """A served decode call is one token: its RMSNorms must run the
    row-per-block kernel and its WKV-6s the decode kernel, every launch;
    a call that fell to the scalar or sequential kernel fails."""
    cs = _chip_smoke()
    row = "void (anonymous namespace)::rmsnorm_row_kernel<__nv_bfloat16, 1>"
    dec = "void (anonymous namespace)::wkv6_decode_kernel<__nv_bfloat16, 4>"
    seq = "void (anonymous namespace)::wkv6_kernel<__nv_bfloat16, 64>(...)"
    scalar = "void (anonymous namespace)::rmsnorm_kernel<__nv_bfloat16>"
    launched = {"multi_seed_rows": 0, "rmsnorm": 520, "flash_attention": 0,
                "wkv6": 256}
    rows = [(1.0, 520, row + "(...)"), (0.5, 256, dec + "(...)")]
    counts = cs.symbol_counts(rows)["counts"]
    assert counts == {"rmsnorm_row_kernel": 520, "wkv6_decode_kernel": 256}
    assert cs.profile_complete(rows, launched) == {"rmsnorm": 520,
                                                   "wkv6": 256}
    cs.check_decode_symbols(counts, launched)
    for bad in ([(1.0, 519, row + "(...)"), (0.1, 1, scalar + "(...)"),
                 rows[1]],
                [rows[0], (0.5, 255, dec + "(...)"), (0.1, 1, seq)]):
        bad_counts = cs.symbol_counts(bad)["counts"]
        # The launches add up; only the kernel they ran is wrong.
        assert cs.profile_complete(bad, launched)
        with pytest.raises(AssertionError, match="launches ran"):
            cs.check_decode_symbols(bad_counts, launched)


def test_chip_smoke_wkv6_cases_take_their_kernels():
    """Phase 9: the decode case runs the decode kernel, every other case
    the sequential one."""
    cs = _chip_smoke()
    paths = {n: cs.wkv6_plan_of(n, torch.bfloat16).path
             for n in cs.WKV_CASES}
    assert paths == {"decode": "decode", "t64": "sequential",
                     "t512": "sequential", "ragged": "sequential"}
    assert cs.WKV_MAIN == "decode"


def test_chip_smoke_rwkv_model_phases_rehearsed_on_cpu():
    cs = _chip_smoke()
    cfg = cs.parity_config("rwkv6-3b")
    assert (cfg.n_layers, cfg.d_model, cfg.dtype) == (2, 2560, "float32")
    assert cs.launches_per_call(cfg) == {"rmsnorm": 5, "wkv6": 2}
    assert cs.launches_per_call(get_arch(ARCH).full) == {"rmsnorm": 65,
                                                          "wkv6": 32}
    parity = cs.model_parity_phase(get_arch(ARCH).smoke, "cpu", chunk=8)
    assert parity["max_abs_err"] == 0.0 and len(parity["tokens"]) == 5
    argv = ("--arch", ARCH, "--smoke", "--lanes", "2", "--requests", "3",
            "--prompt-len", "8", "--gen", "4")
    served = cs.serve_phase(argv, "cpu")
    assert served["summary"]["requests_completed"] == 3
    # chunk 1: a request holds a lane for 8 + 4 steps.
    assert served["trace_shape"] == [24, 2, 4]
    assert served["model_calls"] == 1 + 3 * 8 + 12
    assert served["launches"] == {"rmsnorm": 0, "wkv6": 0}
    json.dumps(served["verdict"])
    assert "--chunk" not in cs.RWKV_SERVE_ARGV
    assert K.LAUNCHES["wkv6"] == 0
