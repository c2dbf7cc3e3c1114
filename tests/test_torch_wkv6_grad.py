"""The gradient of the port's WKV-6 recurrence, and ssm training against
the reference.

``kernels/wkv6.py::wkv6_backward`` (plain PyTorch, float32) is held to
autograd through the sequential recurrence in float64 (the loop of
``wkv6_ref``, in float64): every gradient within 1e-5 of its scale, with
and without the final state's gradient, from a non-zero state, at T on
either side of the backward's 32-token chunk, and at decays down to 1e-6
and 0, where a form with exp(-cumsum(log w)) overflows float32.
``Wkv6Function`` is held to autograd through ``wkv6_ref`` itself, and to
``jax.grad`` of the reference's sequential scan (T < 512) and of its
chunked form at chunk 32 (T >= 512), within 1e-4 of scale.  rwkv6-smoke's
loss and every gradient are held to ``jax.value_and_grad`` of the
reference's ``loss_fn`` on both paths (1e-5 relative, 1e-4 of scale), and
one AdamW step to the reference's ``make_train_step``.  chip_smoke.py's
phases 25 and 26 (A and B) are rehearsed at a small size on the host.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.data import DataConfig as RefDataConfig
from repro.data import host_batch as ref_host_batch
from repro.models import build as ref_build
from repro.models import rwkv as ref_rwkv
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import init_opt_state as ref_init_opt_state
from repro.train.loop import make_train_step as ref_make_train_step
from repro_torch import kernels as K
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, host_batch, to_device
from repro_torch.kernels.wkv6 import BACKWARD_CHUNK, CHUNKED_T
from repro_torch.models import rwkv, transformer
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train.loop import make_train_step, value_and_grad

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "rwkv6-3b"
F64_TOL, JAX_TOL, LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4, 1e-5, 1e-4


def _close_to_scale(got, want, tol):
    got = np.asarray(torch.as_tensor(got).double() if isinstance(
        got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.all(np.isfinite(got))
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), \
        (np.abs(got - want).max(), np.abs(want).max())


def _inputs(B, T, H, dh, seed, decay="model", state=True):
    """Seeded float64 r, k, v (normal), w (the model's exp(-exp(N)),
    uniform(0.5, 0.999), or "strong": 10^U(-6, 0) with every 7th value
    0), u, S0 (0.1 N, or zeros) and the gradients of out and of the final
    state."""
    rng = np.random.default_rng(seed)
    shape = (B, T, H, dh)
    r, k, v, g = (rng.standard_normal(shape) for _ in range(4))
    if decay == "model":
        w = np.exp(-np.exp(rng.standard_normal(shape)))
    elif decay == "long":
        w = rng.uniform(0.5, 0.999, shape)
    else:
        w = 10.0 ** rng.uniform(-6.0, 0.0, shape)
        w.reshape(-1)[::7] = 0.0
    u = 0.5 * rng.standard_normal((H, dh))
    S0 = 0.1 * rng.standard_normal((B, H, dh, dh)) if state else \
        np.zeros((B, H, dh, dh))
    gS = rng.standard_normal((B, H, dh, dh))
    return [torch.from_numpy(a) for a in (r, k, v, w, u, S0, g, gS)]


def _recurrence_f64(r, k, v, w, u, S0):
    """``wkv6_ref``'s loop in float64, for autograd."""
    T = r.shape[1]
    S, outs = S0, []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 S + u[None, :, :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(outs, dim=1), S


def _oracle(ins, g, gS):
    leaves = [t.clone().requires_grad_() for t in ins]
    out, S = _recurrence_f64(*leaves)
    loss = (out * g).sum() + ((S * gS).sum() if gS is not None else 0.0)
    # w of the last token reaches only the final state
    return torch.autograd.grad(loss, leaves, materialize_grads=True)


# -- wkv6_backward against float64 autograd -----------------------------------

@pytest.mark.parametrize("T", [1, 31, 32, 33, 100])
@pytest.mark.parametrize("final_grad", [True, False])
def test_backward_matches_float64_autograd(T, final_grad):
    *ins, g, gS = _inputs(2, T, 3, 8, seed=T)
    gS = gS if final_grad else None
    want = _oracle(ins, g, gS)
    got = K.wkv6_backward(*(t.float() for t in ins), g.float(),
                          None if gS is None else gS.float())
    assert [t.dtype for t in got] == [torch.float32] * 6
    for a, b in zip(got, want):
        _close_to_scale(a, b, F64_TOL)


@pytest.mark.parametrize("T", [33, 100])
def test_strong_decay_stays_finite(T):
    """Decays down to 1e-6 and exact zeros: the gradients are finite and
    match, where exp(-cumsum(log w)) over one chunk overflows float32."""
    *ins, g, gS = _inputs(1, T, 2, 8, seed=7, decay="strong")
    w = ins[3][:, :BACKWARD_CHUNK].float()
    with np.errstate(divide="ignore"):
        cum = np.cumsum(np.log(w.numpy()), axis=1)
    assert not np.all(np.isfinite(np.exp(-cum).astype(np.float32)))
    want = _oracle(ins, g, gS)
    got = K.wkv6_backward(*(t.float() for t in ins), g.float(), gS.float())
    for a, b in zip(got, want):
        _close_to_scale(a, b, F64_TOL)


# -- the autograd Function ----------------------------------------------------

@pytest.mark.parametrize("dtype,T", [(torch.float32, 40),
                                     (torch.bfloat16, 40),
                                     (torch.bfloat16, CHUNKED_T + 3)])
def test_function_matches_autograd_through_the_plain_version(dtype, T):
    """Forward (out and final state) equal to ``wkv6``'s; gradients of r,
    k, v (in their dtype), w, u and S0 against autograd through
    ``wkv6_ref``: within 1e-4 of scale, plus one bf16 ulp (2^-7 of the
    value) where the gradient is bf16 (both sides round to bf16).  From
    CHUNKED_T tokens the bf16 output is rounded and the rounding passed
    straight through."""
    *ins, g, gS = _inputs(1, T, 2, 8, seed=11)
    r, k, v = (t.to(dtype) for t in ins[:3])
    w, u, S0 = (t.float() for t in ins[3:])
    args = (r, k, v, w, u, S0)
    leaves = [t.clone().requires_grad_() for t in args]
    out, S = K.Wkv6Function.apply(*leaves)
    assert torch.equal(leaves[5].detach(), S0)     # the state is not written
    S_want = S0.clone()
    assert torch.equal(out, K.wkv6(*args[:5], S_want))
    assert torch.equal(S, S_want)
    got = torch.autograd.grad((out * g.float()).sum() + (S * gS.float()).sum(),
                              leaves)
    leaves = [t.clone().requires_grad_() for t in args]
    o2, S2 = K.wkv6_ref(*leaves)
    want = torch.autograd.grad((o2 * g.float()).sum()
                               + (S2 * gS.float()).sum(), leaves)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        rounded = a.dtype == torch.bfloat16
        a, b = a.double(), b.double()
        tol = GRAD_TOL * b.abs().max() + (2.0 ** -7 * b.abs() if rounded
                                          else 0.0)
        assert bool(((a - b).abs() <= tol).all())


def test_function_without_a_state_gradient_and_launch_free_on_the_host():
    """The final state unused (the model's training call): no gradient
    reaches it, S0's is still right; on the host nothing is launched."""
    *ins, g, _ = _inputs(2, 20, 2, 4, seed=5)
    args = [t.float().requires_grad_() for t in ins]
    K.reset_launches()
    out, _ = K.Wkv6Function.apply(*args)
    got = torch.autograd.grad((out * g.float()).sum(), args)
    assert K.LAUNCHES["wkv6"] == 0
    want = _oracle(ins, g, None)
    for a, b in zip(got, want):
        _close_to_scale(a, b, F64_TOL)


@pytest.mark.parametrize("T", [24, 520])
def test_function_matches_jax_grad_of_the_reference(T):
    """T < 512: ``jax.grad`` of the reference's sequential scan (from S
    = 0, as its model's scan branch); T >= 512: of ``wkv6_chunked`` at
    chunk 32 from a non-zero state, the model's path there."""
    *ins, g, _ = _inputs(1, T, 2, 8, seed=T, decay="long",
                         state=T >= CHUNKED_T)
    f32 = [t.float() for t in ins]
    n_args = 6 if T >= CHUNKED_T else 5

    def ref(*a):
        if T >= CHUNKED_T:
            out, _ = ref_rwkv.wkv6_chunked(*a, chunk=32)
        else:
            out, _ = ref_rwkv.wkv6_reference(*a)
        return jnp.sum(out * jnp.asarray(g.numpy(), jnp.float32))
    want = jax.grad(ref, argnums=tuple(range(n_args)))(
        *(jnp.asarray(t.numpy()) for t in f32[:n_args]))
    leaves = [t.clone().requires_grad_() for t in f32]
    out, _ = K.Wkv6Function.apply(*leaves)
    got = torch.autograd.grad((out * g.float()).sum(), leaves)
    for a, b in zip(got[:n_args], want):
        _close_to_scale(a, np.asarray(b), JAX_TOL)


# -- the model -----------------------------------------------------------------

def _randomized_pair(seed=0, w0=-2.0):
    """The reference's rwkv6-smoke params with their zero-initialised
    leaves (the mixes, w0, ln_x and the norms) set to seeded values, and
    the port's parameter dict of the same weights.  ``w0`` shifts the
    base decay: at -2 the decays are near exp(-exp(-2)) = 0.87, a long
    memory, for which the reference's chunked form (which forms
    exp(-cumsum(log w)) over a chunk) stays finite; at 0 some chunks
    overflow it."""
    rcfg, cfg = ref_arch(ARCH).smoke, get_arch(ARCH).smoke
    params, _ = ref_build(rcfg).init(jax.random.key(seed))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    block = tree["layers"]["block"]
    for name in rwkv.ZERO_INIT:
        a = block[name]
        block[name] = (rng.uniform(0.0, 1.0, a.shape) if name.startswith("mu")
                       else 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
    block["w0"] += np.float32(w0)
    for name in ("ln1", "ln2"):
        a = tree["layers"][name]
        tree["layers"][name] = (0.3 * rng.standard_normal(a.shape)
                                ).astype(a.dtype)
    return (rcfg, cfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, cfg, "cpu"))


@pytest.mark.parametrize("S", [24, 520])
def test_rwkv_loss_and_grads_match_jax_value_and_grad(S):
    """S = 24 runs the reference's scan, S = 520 its chunked form (and the
    port's rounding of a long call's output, here a float32 no-op)."""
    rcfg, cfg, rparams, params = _randomized_pair()
    B = 2
    rng = np.random.default_rng(S)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:, S - 5:] = 0.0
    (rtotal, rinfo), rgrads = jax.value_and_grad(
        ref_build(rcfg).loss_fn, has_aux=True)(
        rparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
                  "mask": jnp.asarray(mask)})
    model = transformer.Transformer(cfg, "meta", seed=None)
    total, info, grads = value_and_grad(
        model, params, to_device({"tokens": toks, "labels": toks,
                                  "mask": mask}, "cpu"))
    np.testing.assert_allclose(float(total), float(rtotal), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(info["loss"]), float(rinfo["loss"]),
                               rtol=LOSS_RTOL)
    got = params_to_numpy(grads, cfg)
    want = jax.tree.map(np.asarray, rgrads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close_to_scale(a, b, GRAD_TOL)


def test_strong_decays_overflow_the_references_chunked_form_not_the_port():
    """At S = 520 with decays near exp(-exp(0)) = 0.37 the reference's
    chunked form overflows (its loss is NaN); the port's loss and
    gradients are finite."""
    rcfg, cfg, rparams, params = _randomized_pair(w0=0.0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 520)
                                             ).astype(np.int32)
    rtotal, _ = ref_build(rcfg).loss_fn(
        rparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    assert not np.isfinite(float(rtotal))
    model = transformer.Transformer(cfg, "meta", seed=None)
    total, _, grads = value_and_grad(
        model, params, to_device({"tokens": toks, "labels": toks}, "cpu"))
    assert np.isfinite(float(total))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


def test_one_adamw_step_matches_the_references():
    """One ``make_train_step`` call on both sides: loss, grad norm and lr
    within 1e-5 relative; m within 1e-4 of its scale; each new parameter
    within 1e-6 where its gradient is at least 1e-3 of the leaf's scale
    (AdamW's first step moves it by lr times the gradient's sign), and
    within 2 lr elsewhere (a sign that rounding may flip)."""
    rcfg, cfg, rparams, params = _randomized_pair(1)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    dkw = dict(seq_len=24, global_batch=2, vocab=cfg.vocab)
    rbatch = {k: jnp.asarray(a) for k, a in
              ref_host_batch(RefDataConfig(**dkw), 0).items()}
    rp, ropt, rm = ref_make_train_step(rcfg, RefAdamWConfig(**kw))(
        rparams, ref_init_opt_state(rparams), rbatch)
    p, opt, m = make_train_step(cfg, AdamWConfig(**kw))(
        params, init_opt_state(params),
        to_device(host_batch(DataConfig(**dkw), 0), "cpu"))
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(rm[key]),
                                   rtol=LOSS_RTOL)
    for a, b in zip(jax.tree.leaves(params_to_numpy(opt["m"], cfg)),
                    jax.tree.leaves(ropt["m"])):
        _close_to_scale(a, np.asarray(b), GRAD_TOL)
    got = jax.tree.leaves(params_to_numpy(p, cfg))
    grads = jax.tree.leaves(ropt["m"])
    for a, b, gm in zip(got, jax.tree.leaves(rp), grads):
        b, gm = np.asarray(b, np.float64), np.abs(np.asarray(gm))
        certain = gm >= 1e-3 * gm.max()
        tol = np.where(certain, 1e-6, 2 * kw["lr"] + 1e-6)
        assert np.all(np.abs(np.asarray(a, np.float64) - b) <= tol)


@pytest.mark.parametrize("policy", ["full", "nothing"])
def test_training_step_profiles_one_backward_range_a_layer(policy):
    """chip_smoke.py's phase 27 reads the WKV-6 backward's device time from
    the profiler range ``wkv6_backward``: a training step records it once
    per layer, recompute or not, with the backward's operations in it."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_arch(ARCH).smoke.with_(remat_policy=policy)
    params = {k: p.detach() for k, p in
              transformer.init(cfg, 0, "cpu").named_parameters()}
    batch = to_device(host_batch(DataConfig(seq_len=16, global_batch=1,
                                            vocab=cfg.vocab), 0), "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        value_and_grad(transformer.init(cfg, None, "meta"), params, batch)
    hits = [e for e in prof.events() if e.name == "wkv6_backward"]
    assert len(hits) == cfg.n_layers
    assert all(e.cpu_children for e in hits)


# -- chip_smoke's phases A and B, rehearsed ------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_wkv6_training_phase_rehearsed():
    cs = _chip_smoke()
    r = cs.check_train_wkv6("ragged", "cpu")
    assert r["fwd"] <= cs.WKV_TOL
    assert max(r[g] for g in cs.WKV_GRADS) <= cs.GRAD_TOL
    assert r["bf16_share"] <= 1.0


def test_chip_smoke_rwkv_grad_parity_rehearsed():
    cs = _chip_smoke()
    cfg = get_arch(ARCH).smoke
    r = cs.rwkv_grad_phase(cfg, "cpu", seqs=(16, CHUNKED_T + 8), batch=1)
    assert set(r) == {f"{p}/{s}" for p in cs.REMAT_POLICIES
                      for s in (16, CHUNKED_T + 8)}
    for res in r.values():
        assert res["loss"][0] == res["loss"][1]


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,T", [(torch.float32, 100),
                                     (torch.bfloat16, 33),
                                     (torch.bfloat16, CHUNKED_T + 3)])
def test_function_on_card(cuda, dtype, T):
    """One kernel launch a forward, the caller's state untouched; the
    gradients (the plain backward on the card) against autograd through
    ``wkv6_ref`` on the card, within 1e-4 of scale plus one bf16 ulp
    where a gradient is bf16."""
    *ins, g, _ = _inputs(2, T, 4, 16, seed=T + 1)
    args = [t.to(cuda, dtype if i < 3 else torch.float32)
            for i, t in enumerate(ins)]
    g = g.to(cuda, torch.float32)
    S0 = args[5].clone()
    leaves = [t.clone().requires_grad_() for t in args]
    K.reset_launches()
    out, _ = K.Wkv6Function.apply(*leaves)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert K.LAUNCHES["wkv6"] == 1
    assert torch.equal(leaves[5].detach(), S0)
    plain = [t.clone().requires_grad_() for t in args]
    want = torch.autograd.grad(K.wkv6_ref(*plain)[0], plain, g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        rounded = a.dtype == torch.bfloat16
        a, b = a.double().cpu(), b.double().cpu()
        tol = GRAD_TOL * b.abs().max() + (2.0 ** -7 * b.abs() if rounded
                                          else 0.0)
        assert bool(((a - b).abs() <= tol).all())
