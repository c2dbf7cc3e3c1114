"""The port's dense model against the reference's, on the same weights.

The reference's smoke models (gemma: MHA with head_dim 16 and a sqrt(d)
embedding scale; mistral-nemo: GQA with an untied head; h2o-danube: GQA
with a sliding window of 16 slots) are initialised in JAX, moved across
as numpy through ``params_from_numpy``, and both packages run the same
tokens, made with numpy from a seed.  Tolerance for float32 logits: max
|port − reference| <= 1e-5 · max |reference| (the two differ only in the
order of float32 sums, about 1e-7 of the logits' scale).  Three places
where parity would break are pinned against the reference, each with its
own tolerance: the tanh-approximate GELU, the rounding of the embedding
scale to the activation dtype, and the clamped cache write of a chunked
prefill past a window.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from repro.configs import get_arch as ref_arch
from repro.models import build as ref_build
from repro.models import layers as ref_layers
from repro_torch.configs import get_arch, list_archs
from repro_torch.models import build, layers, transformer
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy

ARCHS = ["gemma-7b", "mistral-nemo-12b", "h2o-danube-3-4b", "mixtral-8x22b",
         "deepseek-v2-lite-16b"]
LOGIT_RTOL = 1e-5


def _pair(arch, **over):
    """Reference params and api, and the port's module on the same
    weights, for the arch's smoke config with ``over`` applied."""
    rcfg = ref_arch(arch).smoke.with_(**over)
    cfg = get_arch(arch).smoke.with_(**over)
    api = ref_build(rcfg)
    params, _ = api.init(jax.random.key(0))
    model = transformer.Transformer(cfg, "cpu", seed=None)
    model.load_state_dict(params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, "cpu"))
    return api, params, model, cfg


def _assert_logits(got, want):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= LOGIT_RTOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    api, params, model, cfg = _pair(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 24),
                                             dtype=np.int32)
    want, rinfo = api.forward(params, jnp.asarray(toks))
    got, info = model(torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 24, cfg.vocab)
    _assert_logits(got, want)
    # the MoE aux loss (0 for a dense config) and the (L, E) expert loads
    np.testing.assert_allclose(float(info["aux"]), float(rinfo["aux"]),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(info["expert_counts"].numpy(),
                                  np.asarray(rinfo["expert_counts"]))


def _prefill_then_decode(api, params, model, cfg, prompt, chunk, gen):
    """Chunked prefill then greedy decode in both packages; every call's
    logits compared, the greedy tokens required equal.  Returns the two
    decode states."""
    max_len = prompt.shape[1] + gen + 1
    st_r = api.init_decode_state(1, max_len)
    st = model.init_decode_state(1, max_len)
    for a in range(0, prompt.shape[1], chunk):
        k = min(chunk, prompt.shape[1] - a)
        toks = prompt[:, a:a + k]
        pos = np.arange(a, a + k, dtype=np.int32)
        lr, st_r = api.decode_step(params, st_r, jnp.asarray(toks),
                                   jnp.asarray(pos) if k > 1
                                   else jnp.int32(a))
        lt, st = model.decode_step(st, torch.from_numpy(toks),
                                   torch.from_numpy(pos) if k > 1 else a)
        _assert_logits(lt, lr)
    for g in range(gen):
        tok = int(np.argmax(np.asarray(lr)[0, -1]))
        assert int(lt[0, -1].argmax()) == tok
        p = prompt.shape[1] + g
        lr, st_r = api.decode_step(params, st_r,
                                   jnp.asarray([[tok]], jnp.int32),
                                   jnp.int32(p))
        lt, st = model.decode_step(
            st, torch.tensor([[tok]], dtype=torch.int32), p)
        _assert_logits(lt, lr)
    return st_r, st


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("prompt_len,chunk", [(16, 8), (13, 4), (5, 1)])
def test_chunked_prefill_then_decode_matches_reference(arch, prompt_len,
                                                       chunk):
    api, params, model, cfg = _pair(arch)
    prompt = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab, (1, prompt_len), dtype=np.int32)
    st_r, st = _prefill_then_decode(api, params, model, cfg, prompt, chunk,
                                    gen=4)
    for i, cache in enumerate(st["layers"]):
        assert cache["idx"] == int(st_r["layers"]["idx"][i])
        if cfg.mla is None:
            np.testing.assert_array_equal(
                cache["pos"].numpy(), np.asarray(st_r["layers"]["pos"][i]))
            continue
        # the MLA cache holds the latent and the rope key, slot i at
        # position i
        for name in ("c_kv", "k_rope"):
            np.testing.assert_allclose(
                cache[name].numpy(), np.asarray(st_r["layers"][name][i]),
                atol=1e-5, rtol=1e-5)


def test_window_clamped_chunk_write_matches_reference():
    """danube smoke: a 32-token prompt in chunks of 8 into a 16-slot
    window cache.  The reference's dynamic_update_slice clamps a chunk's
    start into [0, 16 - 8], so chunks 3 and 4 both land in slots 8..15:
    after prefill, slots 0..7 hold positions 0..7 and slots 8..15 hold
    24..31.  The port matches the cache and the logits (reference
    behaviour, logged in ROADMAP.md queue 3)."""
    api, params, model, cfg = _pair("h2o-danube-3-4b")
    assert cfg.window == 16
    prompt = np.random.default_rng(32).integers(0, cfg.vocab, (1, 32),
                                                dtype=np.int32)
    st_r, st = _prefill_then_decode(api, params, model, cfg, prompt, 8,
                                    gen=0)
    want = np.r_[np.arange(8), np.arange(24, 32)]
    for i, cache in enumerate(st["layers"]):
        assert cache["k"].shape[1] == 16
        np.testing.assert_array_equal(cache["pos"].numpy(), want)
        np.testing.assert_array_equal(np.asarray(st_r["layers"]["pos"][i]),
                                      want)
        np.testing.assert_allclose(cache["k"].numpy(),
                                   np.asarray(st_r["layers"]["k"][i]),
                                   atol=1e-5, rtol=1e-5)
    assert layers.cache_write_slot(24, 8, 16) == 8
    assert layers.cache_write_slot(17, 1, 16) == 1


@pytest.mark.parametrize("style,frac", [("interleaved", 1.0),
                                        ("partial", 0.5)])
def test_rope_styles_match_reference(style, frac):
    api, params, model, cfg = _pair("st-100m", rope_style=style,
                                    rope_fraction=frac)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (1, 12),
                                             dtype=np.int32)
    want, _ = api.forward(params, jnp.asarray(toks))
    got, _ = model(torch.from_numpy(toks))
    _assert_logits(got, want)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to the tanh form: at x = 1 it gives 0.841192,
    the exact (erf) GELU 0.841345.  Port and reference agree to 1e-6."""
    x = np.linspace(-6, 6, 241).astype(np.float32)
    want = np.asarray(ref_layers._act(jnp.asarray(x), "gelu"))
    got = layers._act(torch.from_numpy(x), "gelu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    one = float(layers._act(torch.tensor([1.0]), "gelu"))
    assert abs(one - 0.841192) < 1e-6
    assert abs(one - float(torch.nn.functional.gelu(torch.tensor(1.0)))) \
        > 1e-4


def test_embedding_scale_rounded_to_activation_dtype():
    """gemma-7b in bf16: sqrt(3072) = 55.4256 is rounded to 55.5 before it
    multiplies, as in the reference; the embeddings agree bit for bit,
    and differ from a product with the unrounded scale."""
    cfg = get_arch("gemma-7b").full.with_(vocab=16)
    rcfg = ref_arch("gemma-7b").full.with_(vocab=16)
    rng = np.random.default_rng(4)
    table = rng.standard_normal((16, 3072)).astype(np.float32)
    toks = rng.integers(0, 16, (1, 5), dtype=np.int32)
    want = np.asarray(ref_layers.embed(
        {"tokens": jnp.asarray(table, jnp.bfloat16)}, rcfg,
        jnp.asarray(toks)))
    tb = torch.from_numpy(table).to(torch.bfloat16)
    got = layers.embed(tb, cfg, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    unrounded = (tb[torch.from_numpy(toks)].float() * 3072 ** 0.5
                 ).to(torch.bfloat16)
    assert not torch.equal(got, unrounded)


def test_bfloat16_params_cross_bit_for_bit():
    """bf16 leaves go across as their uint16 bits."""
    rcfg = ref_arch("gemma-7b").smoke.with_(dtype="bfloat16",
                                            param_dtype="bfloat16")
    cfg = get_arch("gemma-7b").smoke.with_(dtype="bfloat16",
                                           param_dtype="bfloat16")
    params, _ = ref_build(rcfg).init(jax.random.key(3))
    tree = jax.tree.map(np.asarray, params)
    state = params_from_numpy(tree, cfg, "cpu")
    assert state["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        state["embed"].view(torch.int16).numpy().view(np.uint16),
        tree["embed"]["tokens"].view(np.uint16))
    model = transformer.Transformer(cfg, "cpu", seed=None)
    model.load_state_dict(state)
    toks = np.arange(6, dtype=np.int32)[None]
    want, _ = ref_build(rcfg).forward(params, jnp.asarray(toks))
    got, _ = model(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=0.1 * np.abs(np.asarray(want)).max())
    assert tensor_from_numpy(np.zeros(3, np.float32), "cpu").dtype == \
        torch.float32


def test_seeded_init_mirrors_dense_init():
    """Normal x 1/sqrt(shape[0]) (wo of (H, dh, d) by 1/sqrt(H)), the
    embedding at scale 1, norms at 0; the same seed gives the same
    weights."""
    cfg = get_arch("gemma-7b").smoke.with_(d_model=256, d_ff=512)
    a = transformer.Transformer(cfg, "cpu", seed=5)
    b = transformer.Transformer(cfg, "cpu", seed=5)
    for (na, ta), (nb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb and torch.equal(ta, tb)
    blk = a.blocks[0]
    assert float(blk.ln1.abs().max()) == 0.0 == float(a.final_norm.abs().max())
    for w, fan_in in ((a.embed, None), (blk.attn["wq"], 256),
                      (blk.attn["wo"], cfg.n_heads), (blk.mlp["wo"], 512)):
        want = 1.0 if fan_in is None else fan_in ** -0.5
        assert abs(float(w.std()) / want - 1.0) < 0.1


def test_other_families_raise_naming_the_queue():
    """Every family of the reference builds and trains; a family it does
    not know raises ValueError in both packages."""
    from repro_torch.train.loop import check_trainable
    cfg = get_arch("gemma-7b").smoke.with_(family="diffusion")
    with pytest.raises(ValueError, match="unknown model family"):
        transformer.Transformer(cfg, "cpu")
    with pytest.raises(ValueError, match="unknown model family"):
        build(cfg, "cpu")
    with pytest.raises(ValueError):
        ref_build(ref_arch("gemma-7b").smoke.with_(family="diffusion")
                  ).init(jax.random.key(0))
    with pytest.raises(ValueError, match="unknown model family"):
        check_trainable(cfg)
    for arch in ("rwkv6-3b", "phi-3-vision-4.2b", "recurrentgemma-9b",
                 "seamless-m4t-medium"):
        check_trainable(get_arch(arch).smoke)
        assert build(get_arch(arch).smoke, "cpu").init(0) is not None
    families = set()
    for name in list_archs():
        check_trainable(get_arch(name).full)
        families.add(get_arch(name).full.family)
    assert families >= set(transformer.FAMILIES) - {"audio"}


def test_build_defaults_to_the_card():
    cfg = get_arch("gemma-7b").smoke
    if torch.cuda.is_available():
        assert build(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(cfg)
    api = build(cfg, "cpu")
    model = api.init(0)
    state = api.init_decode_state(1, 8)
    logits, _ = api.decode_step(model, state, torch.zeros((1, 1),
                                                          dtype=torch.int32),
                                0)
    assert logits.shape == (1, 1, cfg.vocab)
    assert state["layers"][0]["idx"] == 1
