"""Gradients through the port's two training kernels, and the kernels'
work as ``cost_of`` counts it.

The reference has no backward Pallas kernel: its training differentiates
the jnp twins ``models/layers.py::rms_norm`` and ``::naive_attention``.
The port's ``RmsnormFunction`` and ``FlashAttentionFunction`` take the
kernel forward and the plain backward formulas of ``rmsnorm_backward`` /
``flash_attention_backward``; here those formulas are held against
``jax.vjp`` of the reference's functions on the same numpy inputs and
output gradients (causal, window, softcap, GQA and a fully masked row),
each gradient within 1e-5 of its largest element: both sides compute in
float32 and differ only in summation order (einsum against XLA's dots),
a few ulps of the largest term.  On the CPU the Functions' forward is the
plain version, so ``torch.autograd.grad`` through them exercises the
formulas exactly as a training step does.

``cost_of`` counts each wrapper call as its kernel's analytic FLOPs and
bytes (the counts chip_smoke's bounds use), on the CPU in place of the
plain version's aten ops: checked by hand at smoke size, alone and inside
a train step's fwd_bwd leaf.  Tests marked ``gpu`` force each Function's
kernel forward on the card and skip here.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro_torch import kernels as K
from repro_torch.core.hlo import cost_of

GRAD_TOL = 1e-5
UNWRITTEN = 2 ** 30


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close_to_scale(got, want, tol=GRAD_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, \
        (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("n,d", [(1, 64), (7, 96), (33, 768)])
def test_rmsnorm_backward_matches_jax_vjp(n, d):
    rng = _rng(f"rms{n}x{d}")
    x = 2.0 * _normal(rng, (n, d)) + 0.5
    w = 0.1 * _normal(rng, (d,))
    g = _normal(rng, (n, d))
    _, vjp = jax.vjp(lambda a, b: ref_layers.rms_norm(a, b, 1e-6),
                     jnp.asarray(x), jnp.asarray(w))
    rdx, rdw = vjp(jnp.asarray(g))
    dx, dw = K.rmsnorm_backward(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(g), 1e-6)
    _close_to_scale(dx, rdx)
    _close_to_scale(dw, rdw)


def test_rmsnorm_function_grads_are_the_backward_formulas():
    rng = _rng("rmsfn")
    x, w, g = (torch.from_numpy(a) for a in (
        _normal(rng, (5, 32)), _normal(rng, (32,)), _normal(rng, (5, 32))))
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = K.RmsnormFunction.apply(xl, wl, 1e-6)
    assert torch.equal(y, K.rmsnorm(x, w, 1e-6))
    dx, dw = torch.autograd.grad(y, (xl, wl), g)
    want = K.rmsnorm_backward(x, w, g, 1e-6)
    assert torch.equal(dx, want[0]) and torch.equal(dw, want[1])


# (B, Q, H, KV, dh, K, causal, window, softcap, q_pos, k_pos): positions
# None mean 0..Q-1 / 0..K-1.
ATTN_CASES = {
    "causal": (2, 24, 4, 4, 16, 24, True, None, None, None, None),
    "window": (1, 40, 4, 4, 8, 40, True, 7, None, None, None),
    "softcap": (2, 20, 2, 2, 16, 20, True, None, 5.0, None, None),
    "gqa": (2, 17, 8, 2, 16, 17, True, None, None, None, None),
    "gqa-window-softcap": (1, 32, 4, 2, 16, 32, True, 16, 30.0, None,
                           None),
    "noncausal": (1, 9, 2, 1, 8, 13, False, None, None, None, None),
    # query 0 sees no key (all keys later or unwritten): its row averages
    # v uniformly, and its scores get no gradient
    "fully-masked-row": (1, 6, 2, 1, 8, 10, True, None, None,
                         [0, 3, 4, 5, 6, 7],
                         [1, 2, 3, 4, 5, 6, 7, UNWRITTEN, UNWRITTEN,
                          UNWRITTEN]),
}


def _attention_inputs(name):
    (B, Q, H, KV, dh, K_, causal, window, softcap, q_pos,
     k_pos) = ATTN_CASES[name]
    rng = _rng(name)
    q, k, v = (_normal(rng, s) for s in
               ((B, Q, H, dh), (B, K_, KV, dh), (B, K_, KV, dh)))
    g = _normal(rng, (B, Q, H, dh))
    q_pos = np.arange(Q) if q_pos is None else np.array(q_pos)
    k_pos = np.arange(K_) if k_pos is None else np.array(k_pos)
    return (q, k, v, g, q_pos.astype(np.int32), k_pos.astype(np.int32),
            dict(causal=causal, window=window, softcap=softcap))


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_attention_backward_matches_jax_vjp(name):
    q, k, v, g, q_pos, k_pos, opts = _attention_inputs(name)

    def ref(a, b, c):
        return ref_layers.naive_attention(
            a, b, c, causal=opts["causal"], window=opts["window"],
            q_positions=jnp.asarray(q_pos), k_positions=jnp.asarray(k_pos),
            softcap=opts["softcap"])
    ro, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    rdq, rdk, rdv = vjp(jnp.asarray(g))
    t = [torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)]
    o = K.flash_attention(*t, **opts)
    _close_to_scale(o, ro)
    dq, dk, dv = K.flash_attention_backward(*t, o, torch.from_numpy(g),
                                            **opts)
    _close_to_scale(dq, rdq)
    _close_to_scale(dk, rdk)
    _close_to_scale(dv, rdv)


def test_attention_function_grads_are_the_backward_formulas():
    q, k, v, g, q_pos, k_pos, opts = _attention_inputs("gqa-window-softcap")
    t = [torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)]
    leaves = [a.clone().requires_grad_() for a in t[:3]]
    o = K.FlashAttentionFunction.apply(*leaves, *t[3:], opts["causal"],
                                       opts["window"], opts["softcap"])
    assert torch.equal(o, K.flash_attention(*t, **opts))
    got = torch.autograd.grad(o, leaves, torch.from_numpy(g))
    want = K.flash_attention_backward(*t, o.detach(), torch.from_numpy(g),
                                      **opts)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_layers_take_the_functions_only_under_autograd():
    """models/layers.py goes through the Functions where a gradient is
    needed (the same code on both devices) and straight to the wrappers
    otherwise (serving keeps its per-call cost)."""
    from repro_torch.models import layers
    x = torch.randn(3, 16)
    w = torch.zeros(16, requires_grad=True)
    y = layers.rms_norm(x, w, 1e-6)             # (3, 16): a view's grad_fn
    (node, _), = y.grad_fn.next_functions
    assert type(node).__name__ == "RmsnormFunctionBackward"
    with torch.no_grad():
        assert layers.rms_norm(x, w, 1e-6).grad_fn is None


# -- cost_of counts the kernels' work ------------------------------------------

def test_cost_of_counts_a_rmsnorm_call_by_hand():
    x, w = torch.randn(5, 16), torch.randn(16)
    flops, nbytes = cost_of(K.rmsnorm, x, w, 1e-6)
    assert flops == 4 * 5 * 16                    # 4 operations an element
    assert nbytes == (2 * 5 * 16 + 16) * 4        # x, w read; y written


def test_cost_of_counts_an_attention_call_by_hand():
    B, Q, H, KV, dh = 2, 9, 4, 2, 8
    q, k, v = torch.randn(B, Q, H, dh), torch.randn(B, Q, KV, dh), \
        torch.randn(B, Q, KV, dh)
    pos = torch.arange(Q, dtype=torch.int32)
    flops, nbytes = cost_of(
        lambda *a: K.flash_attention(*a, causal=True), q, k, v, pos, pos)
    live = Q * (Q + 1) // 2                       # causal pairs
    assert flops == 4 * dh * H * B * live
    assert nbytes == 4 * B * (2 * Q * H * dh + 2 * Q * KV * dh) + 4 * 2 * Q
    # a window of 3 keeps 3 keys a query (fewer for the first two)
    flops_w, _ = cost_of(
        lambda *a: K.flash_attention(*a, causal=True, window=3),
        q, k, v, pos, pos)
    assert flops_w == 4 * dh * H * B * (3 * Q - 3)


def test_cost_of_is_the_kernels_count_not_the_plain_versions():
    """The plain version's einsums are hidden from the aten counters
    while a count is active: the attention call counts its analytic
    FLOPs only, and the wrapper's result is the plain version's."""
    q = k = v = torch.randn(1, 4, 1, 8)
    pos = torch.arange(4, dtype=torch.int32)
    with K.counting_costs() as counts:
        out = K.flash_attention(q, k, v, pos, pos)
    assert counts == [4 * 8 * 1 * 1 * 10, 4 * (2 * 32 + 2 * 32) + 4 * 8]
    assert torch.equal(out, K.flash_attention_ref(q, k, v, pos, pos))


def test_train_leaf_flops_include_attention():
    """The fwd_bwd leaf of a smoke train step: its FLOPs are the matrix
    products FlopCounterMode sees (forward, backward, the backward
    formulas' einsums, the blocks' recompute) plus each kernel call's
    analytic count — attention's 4·dh·H·B·(causal pairs) per layer among
    them."""
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, host_batch, to_device
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train.loop import train_region_tree
    cfg = get_arch("st-100m").smoke
    tree = train_region_tree(cfg, AdamWConfig())
    leaf = tree.by_path("train/fwd_bwd").fn
    from repro_torch.models import transformer
    params = {k: p.detach() for k, p in
              transformer.init(cfg, 0, "cpu").named_parameters()}
    B, S = 2, 16
    batch = to_device(host_batch(DataConfig(seq_len=S, global_batch=B,
                                            vocab=cfg.vocab), 0), "cpu")
    state = {"params": params, "opt_state": init_opt_state(params),
             "grads": {k: torch.zeros_like(p) for k, p in params.items()},
             "loss": torch.zeros(())}
    flops, _ = cost_of(leaf, state, batch)
    d, H, ff, V, L = cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab, \
        cfg.n_layers
    dh, T = cfg.resolved_head_dim, B * S
    # matmuls: q/k/v/o projections (4·d·H·dh) and the MLP (3·d·ff) per
    # token and layer, and the tied head (d·V), 2 FLOPs each forward, 4
    # backward (grads of input and weight) ...
    mm = T * (L * (4 * d * H * dh + 3 * d * ff) + d * V)
    # ... the attention backward's four einsums (scores, dP, dQ, dK) and
    # dV, each 2·B·H·S²·dh over the full (unmasked) score matrix ...
    attn_bwd = L * 5 * 2 * B * H * S * S * dh
    # ... and the kernels: attention forward over the causal pairs, and
    # 2L + 1 RMSNorm calls of 4 operations an element
    attn_fwd = L * 4 * dh * H * B * (S * (S + 1) // 2)
    rms = (2 * L + 1) * 4 * T * d
    # ... and, under the config's remat_policy "nothing", every block's
    # forward once more in the backward: its two RMSNorms, its attention
    # and its products up to the last one whose output the backward reads
    # (the MLP's down projection is not, only its inputs are, so the
    # recompute stops before it, as XLA drops it from the reference's)
    assert cfg.remat_policy == "nothing"
    recompute = 2 * T * L * (4 * d * H * dh + 2 * d * ff) + attn_fwd \
        + 2 * L * 4 * T * d
    assert flops == 6 * mm + attn_bwd + attn_fwd + rms + recompute


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", [(8192, 768), (300, 3840), (7, 96)])
def test_rmsnorm_function_on_card(cuda, n, d):
    rng = _rng(f"card{n}x{d}")
    x, w, g = (torch.from_numpy(a).to(cuda) for a in (
        2.0 * _normal(rng, (n, d)), 0.1 * _normal(rng, (d,)),
        _normal(rng, (n, d))))
    leaves = [x.clone().requires_grad_(), w.clone().requires_grad_()]
    K.reset_launches()
    y = K.RmsnormFunction.apply(*leaves, 1e-6)
    got = torch.autograd.grad(y, leaves, g)
    torch.cuda.synchronize()
    assert K.LAUNCHES["rmsnorm"] == 1
    plain = [x.clone().requires_grad_(), w.clone().requires_grad_()]
    want = torch.autograd.grad(K.rmsnorm_ref(*plain, 1e-6), plain, g)
    for a, b in zip(got, want):
        _close_to_scale(a.cpu(), b.cpu(), 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_attention_function_on_card(cuda, name):
    q, k, v, g, q_pos, k_pos, opts = _attention_inputs(name)
    t = [torch.from_numpy(a).to(cuda) for a in (q, k, v, q_pos, k_pos)]
    leaves = [a.clone().requires_grad_() for a in t[:3]]
    K.reset_launches()
    o = K.FlashAttentionFunction.apply(*leaves, *t[3:], opts["causal"],
                                       opts["window"], opts["softcap"])
    got = torch.autograd.grad(o, leaves, torch.from_numpy(g).to(cuda))
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_attention"] == 1
    plain = [a.clone().requires_grad_() for a in t[:3]]
    want = torch.autograd.grad(
        K.flash_attention_ref(*plain, *t[3:], **opts), plain,
        torch.from_numpy(g).to(cuda))
    for a, b in zip(got, want):
        _close_to_scale(a.cpu(), b.cpu(), 1e-4)
