"""The port's vlm family against the reference's, on the same numpy inputs.

phi3v-smoke (2 dense layers, d 64, an 8-patch stub frontend projected by
``vis_proj``) is initialised in JAX and moved across as numpy through
``params_from_numpy``; patch embeddings and tokens are drawn with numpy
from a seed and given to both packages.  Tolerances, and why (float32
both sides; the two differ only in the order of float32 sums):

* forward logits, with and without the patch prefix: within 1e-5 of
  their scale;
* ``loss_fn``: the loss within 1e-5 relative and every gradient within
  1e-4 of its largest element, ``vis_proj``'s included, on the plain and
  on the chunked cross-entropy path (S·vocab above 2**26), each dropping
  exactly the P prefix positions;
* ``batch_for_model``: tokens, labels and mask bit-equal; the embeds'
  shape and dtype equal (the port draws them from a ``torch.Generator``,
  the reference from ``jax.random``);
* ``call_costs``: equal to ``FlopCounterMode``'s count of one call;
* served greedy tokens equal to the reference's ``JitBackend``.

Also the reference behaviours the port keeps: ``param_count`` leaves out
``vis_proj``, and serving gives a vlm no images.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_arch as ref_arch
from repro.data import batch_for_model as ref_batch_for_model
from repro.models import build as ref_build
from repro.scenarios import traffic as ref_traffic
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro.serve.runtime import JitBackend
from repro_torch.configs import SHAPES, get_arch
from repro_torch.data import batch_for_model
from repro_torch.models import build, transformer
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.scenarios import traffic
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.runtime import TorchBackend, call_costs
from repro_torch.train.loop import make_train_step, value_and_grad
from repro_torch.optim import AdamWConfig, init_opt_state

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "phi-3-vision-4.2b"
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


def _carried(seed=0, **over):
    rcfg = ref_arch(ARCH).smoke.with_(**over)
    cfg = get_arch(ARCH).smoke.with_(**over)
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


def _inputs(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    embeds = rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model)
                                 ).astype(np.float32)
    return toks, embeds


@pytest.mark.parametrize("with_embeds", [True, False])
def test_forward_logits_match_reference(with_embeds):
    rcfg, cfg, rparams, model = _carried()
    toks, embeds = _inputs(cfg, 2, 12)
    kw_r = {"embeds": jnp.asarray(embeds)} if with_embeds else {}
    kw = {"embeds": torch.from_numpy(embeds)} if with_embeds else {}
    want, _ = ref_build(rcfg).forward(rparams, jnp.asarray(toks), **kw_r)
    got, info = model(torch.from_numpy(toks), **kw)
    P = cfg.frontend_tokens if with_embeds else 0
    assert got.shape == (2, P + 12, cfg.vocab)
    _close_to_scale(got.numpy(), want, OUT_TOL)
    assert info["expert_counts"].shape == (cfg.n_layers, 1)


def test_decode_is_the_dense_path():
    """A vlm decodes text only, through the dense blocks: chunked prefill
    and greedy decode equal to the reference's, every call within 1e-5
    of scale."""
    rcfg, cfg, rparams, model = _carried()
    api = ref_build(rcfg)
    prompt, _ = _inputs(cfg, 1, 10, seed=2)
    st_r, st = api.init_decode_state(1, 16), model.init_decode_state(1, 16)
    lr, st_r = api.decode_step(rparams, st_r, jnp.asarray(prompt),
                               jnp.arange(10, dtype=jnp.int32))
    lp, _ = model.decode_step(st, torch.from_numpy(prompt),
                              torch.arange(10, dtype=torch.int32))
    _close_to_scale(lp.numpy(), lr, OUT_TOL)
    for i in range(4):
        tok = int(lp[0, -1].argmax())
        assert tok == int(jnp.argmax(lr[0, -1]))
        lr, st_r = api.decode_step(rparams, st_r, jnp.asarray([[tok]],
                                                              jnp.int32),
                                   jnp.int32(10 + i))
        lp, _ = model.decode_step(st, torch.tensor([[tok]], dtype=torch.int32),
                                  10 + i)
        _close_to_scale(lp.numpy(), lr, OUT_TOL)


@pytest.mark.parametrize("chunked", [False, True])
def test_loss_and_grads_match_jax_value_and_grad(chunked):
    """Both CE paths drop the P prefix positions: chunked at vocab 2**18
    and 257 text tokens (S·vocab just above 2**26)."""
    over = {"vocab": 2 ** 18} if chunked else {}
    rcfg, cfg, rparams, model = _carried(**over)
    B, S = (1, 257) if chunked else (2, 16)
    assert (S * cfg.vocab > 2 ** 26) == chunked
    toks, embeds = _inputs(cfg, B, S, seed=3)
    mask = np.ones((B, S), np.float32)
    mask[:, S - 3:] = 0.0
    batch = {"tokens": toks, "labels": toks, "mask": mask, "embeds": embeds}
    (rtotal, rinfo), rgrads = jax.value_and_grad(
        ref_build(rcfg).loss_fn, has_aux=True)(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    skeleton = transformer.Transformer(cfg, "meta", seed=None)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, info, grads = value_and_grad(skeleton, dict(model.state_dict()),
                                        tb)
    for a, b in ((total, rtotal), (info["loss"], rinfo["loss"])):
        np.testing.assert_allclose(float(a), float(b), rtol=LOSS_RTOL)
    got = params_to_numpy(grads, cfg)
    want = jax.tree.map(np.asarray, rgrads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert float(np.abs(got["vis_proj"]).max()) > 0.0
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close_to_scale(a, b, GRAD_TOL)
    # the prefix's logits carry no loss: the text-only loss of the same
    # logits' tail is the loss
    logits, _ = model(tb["tokens"], embeds=tb["embeds"])
    text = logits[:, cfg.frontend_tokens:]
    nll = torch.logsumexp(text[:, :-1], -1) - torch.gather(
        text[:, :-1], -1, tb["labels"][:, 1:, None].long())[..., 0]
    m = tb["mask"][:, 1:]
    np.testing.assert_allclose(float(info["loss"]),
                               float((nll * m).sum() / m.sum()), rtol=1e-5)


def test_train_step_moves_vis_proj():
    cfg = get_arch(ARCH).smoke
    model = transformer.Transformer(cfg, "cpu", seed=0)
    params = {k: p.detach() for k, p in model.named_parameters()}
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=10))
    batch = batch_for_model(cfg, SHAPES["train_4k"], batch_override=2,
                            seq_override=24, device="cpu")
    new, _, metrics = step(params, init_opt_state(params), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert not torch.equal(new["vis_proj"], params["vis_proj"])


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "seamless-m4t-medium",
                                  "recurrentgemma-9b", "gemma-7b"])
@pytest.mark.parametrize("shape,batch,seq", [
    ("train_4k", 2, 40), ("prefill_32k", 1, 10), ("decode_32k", 3, 5)])
def test_batch_for_model_matches_reference(arch, shape, batch, seq):
    """Tokens, labels and mask bit for bit; a vlm's text cut to max(S -
    P, 2); the embeds' shapes and dtypes (their values come from each
    package's own generator)."""
    rcfg, cfg = ref_arch(arch).smoke, get_arch(arch).smoke
    for step in (0, 3):
        want = ref_batch_for_model(rcfg, REF_SHAPES[shape],
                                   batch_override=batch, seq_override=seq,
                                   step=step)
        got = batch_for_model(cfg, SHAPES[shape], batch_override=batch,
                              seq_override=seq, step=step, device="cpu")
        assert sorted(got) == sorted(want)
        for k in ("tokens", "labels", "mask"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        if "embeds" in want:
            assert tuple(got["embeds"].shape) == want["embeds"].shape
            assert str(got["embeds"].dtype) == \
                f"torch.{want['embeds'].dtype}"
            again = batch_for_model(cfg, SHAPES[shape], batch_override=batch,
                                    seq_override=seq, step=step,
                                    device="cpu")
            assert torch.equal(got["embeds"], again["embeds"])
    if cfg.family == "vlm":
        assert got["tokens"].shape[1] == max(seq - cfg.frontend_tokens, 2)


@pytest.mark.parametrize("tokens", [8, 1])
def test_call_costs_equal_the_flop_counter(tokens):
    """The dense path's formula; weight bytes without vis_proj, which a
    decode call does not read."""
    cfg = get_arch(ARCH).smoke
    model = transformer.Transformer(cfg, "cpu", seed=0)
    backend = TorchBackend(cfg, build(cfg, "cpu"), model, lanes=1,
                           max_len=20, prefill_chunk=8)
    state = model.init_decode_state(1, 20)
    toks = torch.zeros((1, tokens), dtype=torch.int32)
    pos = torch.arange(tokens, dtype=torch.int32) if tokens > 1 else 0
    with FlopCounterMode(display=False) as fc:
        model.decode_step(state, toks, pos)
    flops, nbytes = call_costs(cfg, tokens, 20, backend.weight_bytes)
    assert flops == float(fc.get_total_flops())
    assert backend.weight_bytes == 4 * (sum(
        p.numel() for p in model.parameters()) - cfg.d_model ** 2)
    cache = 2 * cfg.n_layers * (20 + tokens) * cfg.n_kv_heads \
        * cfg.resolved_head_dim * 4
    assert nbytes == float(backend.weight_bytes + cache
                           + 4 * tokens * cfg.vocab)


def test_param_count_leaves_out_vis_proj():
    """The reference's param_count (3,821,079,552 for phi-3-vision-4.2b)
    has no vis_proj; the model holds d² more (ROADMAP.md §3)."""
    cfg = get_arch(ARCH).full
    assert cfg.param_count() == ref_arch(ARCH).full.param_count() \
        == 3_821_079_552
    model = transformer.Transformer(cfg, "meta", seed=None)
    assert sum(p.numel() for p in model.parameters()) == \
        3_830_516_736 == cfg.param_count() + cfg.d_model ** 2


def _never(req):
    raise AssertionError(f"request {req.rid}: a vlm is served no images")


def test_served_tokens_equal_jit_backend_and_take_no_images():
    """Chunked prefill and decode through TorchBackend on the reference's
    weights give JitBackend's greedy tokens; neither backend asks a vlm's
    embeds_fn for a request's images (ROADMAP.md §3)."""
    rcfg, cfg, rparams, model = _carried()
    tkw = dict(n_requests=3, arrival_rate=2.0, length_buckets=(16,),
               length_mix=(1.0,), gen_len=4, vocab=cfg.vocab)
    max_len = 16 + 4 + 1
    ref_b = JitBackend(rcfg, ref_build(rcfg), rparams, lanes=2,
                       max_len=max_len, prefill_chunk=8, embeds_fn=_never)
    RefServeEngine(RefServeConfig(lanes=2, max_len=max_len, prefill_chunk=8),
                   ref_traffic.generate_traffic(
                       ref_traffic.TrafficConfig(**tkw), 0), ref_b).run()
    b = TorchBackend(cfg, build(cfg, "cpu"), model, lanes=2,
                     max_len=max_len, prefill_chunk=8, embeds_fn=_never)
    ServeEngine(ServeConfig(lanes=2, max_len=max_len, prefill_chunk=8),
                traffic.generate_traffic(traffic.TrafficConfig(**tkw), 0),
                b).run()
    assert b.outputs == ref_b.outputs and len(b.outputs) == 3
    assert b.encode_calls == 0


def test_chip_smoke_vlm_phase_rehearsed_on_cpu():
    """Phase 22 at the smoke size on the host: parity with the patch
    prefix, decode and a train step, the served phase and the prefixed
    forward of the served model."""
    cs = _chip_smoke()
    cfg = cs.parity_config(ARCH)
    assert cfg.n_layers == 2 and cfg.d_model == 3072
    assert cfg.resolved_head_dim == 96
    res = cs.family_parity_phase(get_arch(ARCH).smoke, "cpu")
    assert res["forward"]["max_abs_err"] == 0.0
    assert res["forward"]["shape"] == [1, get_arch(ARCH).smoke
                                       .frontend_tokens + 64, 256]
    assert res["decode"]["tokens"] and res["train"]["worst_grad"][1] == 0.0
    assert cs.launches_per_call(get_arch(ARCH).full) == {
        "rmsnorm": 65, "flash_attention": 32}
    argv = ("--arch", ARCH, "--smoke", "--lanes", "2", "--requests", "2",
            "--prompt-len", "8", "--chunk", "4", "--gen", "3")
    served = cs.serve_phase(
        argv, "cpu", after=lambda b: cs.prefixed_forward(b.model, 64))
    assert served["summary"]["requests_completed"] == 2
    out = served["after"]
    assert out["finite"] and out["shape"][1] == \
        get_arch(ARCH).smoke.frontend_tokens + 64


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_vlm_on_card_matches_host(cuda):
    """The smoke model through the kernels (2L + 1 RMSNorms and L
    attentions a forward, the patch prefix included) against the host's
    plain path on the reference's weights: logits within 1e-5 of scale,
    the loss within 1e-5 relative and every gradient within 1e-4 of its
    scale."""
    from repro_torch import kernels as K
    _, cfg, _, host = _carried()
    card = transformer.Transformer(cfg, cuda, seed=None)
    card.load_state_dict(host.state_dict())
    toks, embeds = _inputs(cfg, 2, 24, seed=7)
    batch = {"tokens": torch.from_numpy(toks), "labels":
             torch.from_numpy(toks), "embeds": torch.from_numpy(embeds)}
    want, _ = host(batch["tokens"], embeds=batch["embeds"])
    K.reset_launches()
    got, _ = card(batch["tokens"].to(cuda), embeds=batch["embeds"].to(cuda))
    torch.cuda.synchronize()
    assert (K.LAUNCHES["rmsnorm"], K.LAUNCHES["flash_attention"]) == \
        (2 * cfg.n_layers + 1, cfg.n_layers)
    _close_to_scale(got.cpu(), want, OUT_TOL)
    skeleton = transformer.Transformer(cfg, "meta", seed=None)
    h = value_and_grad(skeleton, dict(host.state_dict()), batch)
    c = value_and_grad(skeleton, dict(card.state_dict()),
                       {k: v.to(cuda) for k, v in batch.items()})
    np.testing.assert_allclose(float(c[0]), float(h[0]), rtol=LOSS_RTOL)
    for k in h[2]:
        _close_to_scale(c[2][k].cpu(), h[2][k], GRAD_TOL)
