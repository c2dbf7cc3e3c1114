"""The port's RMSNorm and attention kernel modules against the reference.

On the CPU each wrapper runs its plain PyTorch version; it is held against
the reference's oracles (``repro.kernels.ref``), its Pallas kernels in
interpret mode (as tests/test_kernels.py runs them) and its model-layer
attention (``repro.models.layers.naive_attention``) on inputs made with
numpy from a seed.  Tolerances: float32 at the reference kernel tests'
atol = rtol = 2e-5; bfloat16 at their 3e-2 (the port keeps the softmax
probabilities in float32 where naive_attention rounds them to v's dtype
before P·V).  Tests marked ``gpu`` hold the CUDA kernels to the plain
versions on the card and skip here.
"""
import importlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from repro.kernels import ref as ref_kernels
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.models import layers as ref_layers
from repro_torch import kernels as K

# The module (the package's ``rmsnorm`` attribute is its function).
RN = importlib.import_module("repro_torch.kernels.rmsnorm")

F32_TOL, BF16_TOL = 2e-5, 3e-2
UNWRITTEN = 2 ** 30


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- RMSNorm -----------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(1, 64), (7, 96), (256, 128), (300, 48)])
def test_rmsnorm_matches_reference_oracle(n, d):
    rng = np.random.default_rng(n * 1000 + d)
    x = 2.0 * _normal(rng, (n, d)) + 0.5
    w = 0.1 * _normal(rng, (d,))
    want = np.asarray(ref_kernels.rmsnorm_ref(x, w, eps=1e-6))
    got = K.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("n,d,row_block", [(8, 64, 8), (64, 128, 16)])
def test_rmsnorm_matches_pallas_interpret(n, d, row_block):
    rng = np.random.default_rng(n + d)
    x, w = _normal(rng, (n, d)), 0.1 * _normal(rng, (d,))
    want = np.asarray(pallas_rmsnorm(x, w, eps=1e-5, row_block=row_block,
                                     interpret=True))
    got = K.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


def test_rmsnorm_bfloat16_matches_reference():
    rng = np.random.default_rng(3)
    x = _normal(rng, (5, 3072))
    w = 0.1 * _normal(rng, (3072,))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    want = ref_kernels.rmsnorm_ref(jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(w, jnp.bfloat16))
    got = K.rmsnorm(xb, wb, 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


def test_model_rms_norm_matches_reference_layer():
    """The model layer flattens leading dims into the kernel's rows."""
    from repro_torch.models import layers
    rng = np.random.default_rng(5)
    x, w = _normal(rng, (2, 7, 32)), 0.1 * _normal(rng, (32,))
    want = np.asarray(ref_layers.rms_norm(x, w, 1e-6))
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("bad", ["dtype", "w_dtype", "rank", "w_shape",
                                 "strided"])
def test_rmsnorm_refuses_what_it_does_not_take(bad):
    x, w = torch.ones(4, 8), torch.zeros(8)
    if bad == "dtype":
        x, w = x.half(), w.half()
    elif bad == "w_dtype":
        w = w.to(torch.bfloat16)
    elif bad == "rank":
        x = x[None]
    elif bad == "w_shape":
        w = torch.zeros(9)
    else:
        x = torch.ones(8, 4).T
    with pytest.raises((TypeError, ValueError)):
        K.rmsnorm(x, w, 1e-6)


# -- attention ---------------------------------------------------------------

def _implicit(Q, K_):
    """The Pallas kernel's implicit positions: queries are the last Q."""
    return (torch.arange(K_ - Q, K_, dtype=torch.int32),
            torch.arange(K_, dtype=torch.int32))


def _mha_to_model(a):
    """(B, H, S, dh) numpy -> (B, S, H, dh) contiguous tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, 1, 2)))


@pytest.mark.parametrize("B,H,Q,K_,dh,causal,window", [
    (1, 1, 128, 128, 64, True, None),
    (2, 2, 64, 256, 32, True, None),
    (1, 2, 256, 256, 16, True, 64),
    (1, 2, 96, 200, 24, True, 50),
    (2, 2, 128, 128, 64, False, None),
])
def test_attention_matches_reference_oracle(B, H, Q, K_, dh, causal, window):
    rng = np.random.default_rng(B + H + Q + K_ + dh)
    q, k, v = (_normal(rng, (B, H, s, dh)) for s in (Q, K_, K_))
    want = np.asarray(ref_kernels.flash_attention_ref(
        q, k, v, causal=causal, window=window))
    qp, kp = _implicit(Q, K_)
    got = K.flash_attention(_mha_to_model(q), _mha_to_model(k),
                            _mha_to_model(v), qp, kp, causal=causal,
                            window=window)
    np.testing.assert_allclose(got.numpy(), np.swapaxes(want, 1, 2),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None)])
def test_attention_matches_pallas_interpret(causal, window):
    rng = np.random.default_rng(11)
    q, k, v = (_normal(rng, (1, 2, 128, 32)) for _ in range(3))
    want = np.asarray(pallas_flash(q, k, v, causal=causal, window=window,
                                   q_block=64, k_block=64, interpret=True))
    qp, kp = _implicit(128, 128)
    got = K.flash_attention(_mha_to_model(q), _mha_to_model(k),
                            _mha_to_model(v), qp, kp, causal=causal,
                            window=window)
    np.testing.assert_allclose(got.numpy(), np.swapaxes(want, 1, 2),
                               atol=F32_TOL, rtol=F32_TOL)


def _ring_positions(rng, slots, written, last):
    """Ring-buffer slot positions: ``written`` slots hold positions
    ending at ``last`` in wrapped order, the rest are unwritten."""
    pos = np.full(slots, UNWRITTEN, np.int32)
    held = np.arange(last - written + 1, last + 1)
    pos[held % slots] = held
    return pos


ATTN_LAYER_CASES = {
    # name: (B, Q, H, KV, dh, K, causal, window, softcap, q_pos, k_pos)
    "gqa-by-index": (2, 6, 4, 2, 16, 6, True, None, None,
                     np.arange(6), np.arange(6)),
    "ring-buffer": (1, 1, 4, 1, 16, 16, True, None, None,
                    np.array([40]), "ring"),
    "ring-window": (1, 3, 4, 2, 8, 16, True, 10, None,
                    np.array([38, 39, 40]), "ring"),
    "softcap": (1, 5, 2, 2, 16, 9, True, None, 2.0,
                np.arange(4, 9), np.arange(9)),
    "non-causal": (1, 4, 2, 1, 8, 7, False, None, None,
                   np.arange(4), np.arange(7)),
    "fully-masked-row": (1, 3, 2, 2, 8, 5, True, None, None,
                         np.array([0, 1, 2]), np.arange(3, 8)),
    "unwritten-slots": (1, 2, 4, 4, 16, 12, True, None, None,
                        np.array([4, 5]), np.r_[np.arange(6),
                                                np.full(6, UNWRITTEN)]),
}


@pytest.mark.parametrize("name", sorted(ATTN_LAYER_CASES))
def test_attention_matches_naive_attention(name):
    (B, Q, H, KV, dh, K_, causal, window, softcap, q_pos,
     k_pos) = ATTN_LAYER_CASES[name]
    rng = _rng(name)
    if isinstance(k_pos, str):
        k_pos = _ring_positions(rng, K_, 13, int(q_pos[-1]))
    q = _normal(rng, (B, Q, H, dh))
    k, v = (_normal(rng, (B, K_, KV, dh)) for _ in range(2))
    q_pos, k_pos = q_pos.astype(np.int32), k_pos.astype(np.int32)
    want = np.asarray(ref_layers.naive_attention(
        q, k, v, causal=causal, window=window, q_positions=q_pos,
        k_positions=k_pos, softcap=softcap))
    got = K.flash_attention(*map(torch.from_numpy, (q, k, v, q_pos, k_pos)),
                            causal=causal, window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    if name == "fully-masked-row":
        # Every score is -1e30: the row averages v uniformly.
        np.testing.assert_allclose(got.numpy()[0, 0], v[0].mean(axis=0),
                                   atol=F32_TOL)


def test_attention_bfloat16_within_probability_rounding():
    """bf16 in and out; naive_attention rounds P to bf16 before P·V, the
    port keeps it in float32: equal within the bf16 tolerance."""
    rng = np.random.default_rng(21)
    q = _normal(rng, (1, 8, 4, 32))
    k, v = (_normal(rng, (1, 24, 2, 32)) for _ in range(2))
    q_pos = np.arange(16, 24, dtype=np.int32)
    k_pos = np.arange(24, dtype=np.int32)
    want = ref_layers.naive_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True,
        window=None, q_positions=q_pos, k_positions=k_pos)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = K.flash_attention(*bf, torch.from_numpy(q_pos),
                            torch.from_numpy(k_pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


def _attn_args():
    q = torch.zeros(1, 2, 4, 16)
    k = torch.zeros(1, 3, 2, 16)
    return [q, k, k.clone(), torch.arange(2, dtype=torch.int32),
            torch.arange(3, dtype=torch.int32)]


@pytest.mark.parametrize("bad", ["half", "mixed", "int64_pos", "groups",
                                 "head_dim", "pos_len", "strided",
                                 "window"])
def test_attention_refuses_what_it_does_not_take(bad):
    a, kw = _attn_args(), {}
    if bad == "half":
        a[:3] = [t.half() for t in a[:3]]
    elif bad == "mixed":
        a[1] = a[1].to(torch.bfloat16)
    elif bad == "int64_pos":
        a[3] = a[3].long()
    elif bad == "groups":
        a[1] = a[2] = torch.zeros(1, 3, 3, 16)
    elif bad == "head_dim":
        a[0] = torch.zeros(1, 2, 4, 272)
        a[1] = a[2] = torch.zeros(1, 3, 2, 272)
    elif bad == "pos_len":
        a[4] = torch.arange(4, dtype=torch.int32)
    elif bad == "strided":
        a[0] = torch.zeros(1, 4, 2, 16).transpose(1, 2)
    else:
        kw["window"] = 0
    with pytest.raises((TypeError, ValueError)):
        K.flash_attention(*a, **kw)


def test_cpu_path_launches_nothing():
    K.reset_launches()
    K.flash_attention(*_attn_args())
    K.rmsnorm(torch.ones(3, 8), torch.zeros(8), 1e-6)
    assert K.LAUNCHES == {"multi_seed_rows": 0, "rmsnorm": 0,
                          "flash_attention": 0, "wkv6": 0}


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", [(1, 3072), (7, 96), (300, 3840)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain_on_card(cuda, n, d, dtype):
    rng = np.random.default_rng(n + d)
    x = torch.from_numpy(2.0 * _normal(rng, (n, d))).to(cuda, dtype)
    w = torch.from_numpy(0.1 * _normal(rng, (d,))).to(cuda, dtype)
    K.reset_launches()
    got = K.rmsnorm(x, w, 1e-6)
    torch.cuda.synchronize()
    assert K.LAUNCHES["rmsnorm"] == 1
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    want = K.rmsnorm_ref(x.float(), w.float(), 1e-6)
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ATTN_LAYER_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain_on_card(cuda, name, dtype):
    (B, Q, H, KV, dh, K_, causal, window, softcap, q_pos,
     k_pos) = ATTN_LAYER_CASES[name]
    rng = _rng(name)
    if isinstance(k_pos, str):
        k_pos = _ring_positions(rng, K_, 13, int(q_pos[-1]))
    q = torch.from_numpy(_normal(rng, (B, Q, H, dh))).to(cuda, dtype)
    k, v = (torch.from_numpy(_normal(rng, (B, K_, KV, dh))).to(cuda, dtype)
            for _ in range(2))
    qp, kp = (torch.from_numpy(p.astype(np.int32)).to(cuda)
              for p in (q_pos, k_pos))
    K.reset_launches()
    got = K.flash_attention(q, k, v, qp, kp, causal=causal, window=window,
                            softcap=softcap)
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_attention"] == 1
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    want = K.flash_attention_ref(q.float(), k.float(), v.float(), qp, kp,
                                 causal=causal, window=window,
                                 softcap=softcap)
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


# Every path of the attention kernel (split-K decode up to 8 query rows per
# kv head, bf16 tensor-core tiles and the float32 CUDA-core kernel above),
# against the plain version on the same inputs.  Implicit positions
# (q_pos = K - Q + arange(Q), k_pos = arange(K)), so K < Q holds rows with
# no live key.  float32 at 2e-5; bf16 at 3e-2 and within its output
# rounding, 2^-8 |want| + 1e-3.
ATTN_Q = (1, 2, 15, 16, 17, 64, 65, 256)
ATTN_K = (1, 63, 545)
ATTN_DH = (8, 64, 120, 128, 256)
ATTN_G = (1, 4, 8)


def _card_inputs(cuda, dtype, seed, B, Q, H, KV, dh, K_, q_pos, k_pos):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(_normal(rng, (B, Q, H, dh))).to(cuda, dtype)
    k, v = (torch.from_numpy(_normal(rng, (B, K_, KV, dh))).to(cuda, dtype)
            for _ in range(2))
    qp, kp = (torch.from_numpy(np.asarray(p, np.int32)).to(cuda)
              for p in (q_pos, k_pos))
    return q, k, v, qp, kp


def _card_attention(q, k, v, qp, kp, **kw):
    """One kernel call, held to one launch and to the plain version."""
    K.reset_launches()
    got = K.flash_attention(q, k, v, qp, kp, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_attention"] == 1
    assert got.dtype == q.dtype and got.shape == q.shape
    want = K.flash_attention_ref(q.float(), k.float(), v.float(), qp, kp,
                                 **kw)
    tol = F32_TOL if q.dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
    if q.dtype == torch.bfloat16:
        err = (got.float() - want).abs()
        assert bool((err <= 2.0 ** -8 * want.abs() + 1e-3).all())
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("g", ATTN_G)
@pytest.mark.parametrize("dh", ATTN_DH)
@pytest.mark.parametrize("K_", ATTN_K)
@pytest.mark.parametrize("Q", ATTN_Q)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_paths_match_plain_on_card(cuda, dtype, Q, K_, dh, g):
    KV = 2
    q, k, v, qp, kp = _card_inputs(cuda, dtype, Q * 1000 + K_ + dh + g, 1,
                                   Q, g * KV, KV, dh, K_,
                                   np.arange(K_ - Q, K_), np.arange(K_))
    _card_attention(q, k, v, qp, kp)


ATTN_FEATURES = ("softcap", "window", "wrapped-ring", "masked-row-in-tile",
                 "fully-masked-call")


@pytest.mark.gpu
@pytest.mark.parametrize("Q", [1, 2, 3, 80])
@pytest.mark.parametrize("feature", ATTN_FEATURES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_features_match_plain_on_card(cuda, dtype, feature, Q):
    """Q 1-2 at g = 4 take split-K decode, 3 and 80 the tiles (bf16) or
    the CUDA-core kernel (float32)."""
    B, H, KV, dh, K_ = 2, 8, 2, 64, 300
    kw = {}
    q_pos, k_pos = np.arange(K_ - Q, K_), np.arange(K_)
    if feature == "softcap":
        kw["softcap"] = 2.0
    elif feature == "window":
        kw["window"] = 50
    elif feature == "wrapped-ring":
        last = 1000
        held = np.arange(last - K_ + 1, last + 1)
        k_pos = np.empty(K_, np.int64)
        k_pos[held % K_] = held
        q_pos = np.arange(last - Q + 1, last + 1)
        kw["window"] = 200
    elif feature == "masked-row-in-tile":
        # The first query precedes every key: no live key, beside rows of
        # the same tile that have them.
        q_pos = np.r_[-1, np.arange(K_ - Q + 1, K_)]
    else:
        k_pos = np.arange(K_) + 10 ** 6
    q, k, v, qp, kp = _card_inputs(cuda, dtype, len(feature) + Q, B, Q, H,
                                   KV, dh, K_, q_pos, k_pos)
    got = _card_attention(q, k, v, qp, kp, **kw)
    if feature in ("masked-row-in-tile", "fully-masked-call"):
        # Every score of query 0 is -1e30: it averages v over all K keys.
        uniform = v.float().mean(dim=1).repeat_interleave(H // KV, dim=1)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        torch.testing.assert_close(got[:, 0].float(), uniform, atol=tol,
                                   rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("Q", [1, 80])
@pytest.mark.parametrize("dh", [12, 36])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_unpadded_head_dims_on_card(cuda, dtype, dh, Q):
    """dh not a multiple of 8: split-K decode's element-wise loads (Q 1)
    and the CUDA-core kernel, which takes such bf16 calls (Q 80)."""
    B, H, KV, K_ = 1, 8, 2, 545
    q_pos = np.r_[-1, np.arange(K_ - Q + 1, K_)]
    q, k, v, qp, kp = _card_inputs(cuda, dtype, dh + Q, B, Q, H, KV, dh, K_,
                                   q_pos, np.arange(K_))
    _card_attention(q, k, v, qp, kp, window=300)


def _at_odd_offset(t):
    """A contiguous copy of ``t`` one element past an allocation's start:
    not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("Q", [1, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_unaligned_views_on_card(cuda, dtype, Q):
    """q, k and v at an odd element offset: split-K decode loads them
    element-wise (Q 1); the tensor-core tiles refuse them, so bf16 at Q 80
    takes the CUDA-core kernel."""
    B, H, KV, dh, K_ = 1, 8, 2, 64, 300
    q, k, v, qp, kp = _card_inputs(cuda, dtype, 7 + Q, B, Q, H, KV, dh, K_,
                                   np.arange(K_ - Q, K_), np.arange(K_))
    q, k, v = (_at_odd_offset(t) for t in (q, k, v))
    assert all(t.is_contiguous() and t.data_ptr() % 16 for t in (q, k, v))
    _card_attention(q, k, v, qp, kp, softcap=2.0)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("Q", [1, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_non_causal_on_card(cuda, dtype, Q, window):
    """causal=False on every path (bf16 at Q 80 on the tensor-core tiles):
    keys after a query stay live, a window still masks the old ones, and
    the ragged last tile's keys past K still weigh 0."""
    B, H, KV, dh, K_ = 2, 8, 2, 128, 545
    q, k, v, qp, kp = _card_inputs(cuda, dtype, 11 + Q, B, Q, H, KV, dh, K_,
                                   np.arange(200, 200 + Q), np.arange(K_))
    _card_attention(q, k, v, qp, kp, causal=False, window=window)


# The CUDA-core path (flash_attention_simt_kernel: 64 packed rows a block,
# BN-key tiles of 64, or 32 where dh pads to 128 or 256), which takes every
# float32 call above 8 query rows per kv head and the bf16 calls the
# tensor-core tiles refuse; against the plain version at the same
# tolerances.
FA = importlib.import_module("repro_torch.kernels.flash_attention")
SIMT_TRAIN_CASES = {
    # chip_smoke.py's phase-15 training calls: (B, S, H, KV, dh, window,
    # softcap), causal over positions 0..S-1.
    "st-100m": (2, 1024, 12, 12, 64, None, None),
    "danube-gqa-softcap": (2, 256, 4, 2, 16, 16, 30.0)}


def _simt_attention(q, k, v, qp, kp, **kw):
    B, Q, H, dh = q.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v, kp))
    assert FA.attention_plan(B, Q, H, k.shape[2], dh, k.shape[1], q.dtype,
                             aligned).path == "simt"
    return _card_attention(q, k, v, qp, kp, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SIMT_TRAIN_CASES))
def test_simt_kernel_at_training_calls_on_card(cuda, name):
    B, S, H, KV, dh, window, softcap = SIMT_TRAIN_CASES[name]
    pos = np.arange(S)
    q, k, v, qp, kp = _card_inputs(cuda, torch.float32, len(name), B, S, H,
                                   KV, dh, S, pos, pos)
    _simt_attention(q, k, v, qp, kp, window=window, softcap=softcap)


@pytest.mark.gpu
@pytest.mark.parametrize("Q,K_", [(64, 256), (100, 300), (130, 77)])
@pytest.mark.parametrize("dh", [16, 64, 120, 256])
def test_simt_kernel_head_dims_and_ragged_tiles_on_card(cuda, dh, Q, K_):
    """Each padded head dim (64, 128, 256); Q not a multiple of the 64-row
    block and K not a multiple of the key tile (300 and 77 keys), GQA 4
    over 2 with a window; at K < Q the first rows have no live key."""
    B, H, KV = 2, 8, 2
    q, k, v, qp, kp = _card_inputs(cuda, torch.float32, dh + Q + K_, B, Q,
                                   H, KV, dh, K_, np.arange(K_ - Q, K_),
                                   np.arange(K_))
    _simt_attention(q, k, v, qp, kp, window=200)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["unaligned-dh64", "unaligned-dh120",
                                  "dh12", "dh20", "dh36"])
def test_simt_kernel_takes_bf16_calls_wgmma_refuses_on_card(cuda, case):
    """bf16 with q, k, v at an odd element offset, or with dh not a
    multiple of 8: the tensor-core tiles refuse them, the CUDA-core kernel
    converts them as it stages them."""
    B, Q, H, KV, K_ = 1, 100, 8, 2, 300
    dh = int(case.rsplit("dh", 1)[1])
    q, k, v, qp, kp = _card_inputs(cuda, torch.bfloat16, dh + 3, B, Q, H,
                                   KV, dh, K_, np.arange(K_ - Q, K_),
                                   np.arange(K_))
    if case.startswith("unaligned"):
        q, k, v = (_at_odd_offset(t) for t in (q, k, v))
    _simt_attention(q, k, v, qp, kp, softcap=2.0)


# Every path of the RMSNorm kernel (rmsnorm_plan: a block per row, several
# rows per block, the scalar kernel), forced through the private launcher
# and chosen by the wrapper, against the plain version on the same inputs:
# float32 at 2e-5; bf16 at 3e-2 and within its output rounding, 2^-8 |want|
# + 1e-3 (both sides compute in float32).
RMS_PATH_SHAPES = ((1, 2560), (1, 3072), (3, 3072), (256, 3072), (5, 16384),
                   (2, 32768), (9, 40))


def _rms_path_cases():
    """(dtype, n, d, plan) for every path that covers (n, d): the scalar
    kernel always; the row path with each thread owning 1, 2 or 4 vectors,
    where the row fits a block."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for n, d in RMS_PATH_SHAPES:
            nv = d * dtype.itemsize // RN.VEC_BYTES
            plans = [RN.RmsnormPlan("scalar", RN.SCALAR_THREADS, 0)]
            plans += [RN.RmsnormPlan("row", -(-nv // (32 * i)) * 32, i)
                      for i in RN.ITEMS if -(-nv // i) <= RN.MAX_THREADS]
            cases += [pytest.param(dtype, n, d, p, id=f"{str(dtype)[6:]}-"
                                   f"{n}x{d}-{p.path}x{p.items}")
                      for p in plans]
    return cases


def _rms_card_inputs(cuda, dtype, n, d, offset=0):
    rng = np.random.default_rng(31 * n + d + offset)
    x = torch.from_numpy(2.0 * _normal(rng, (n * d + offset,)) + 0.5).to(
        cuda, dtype)[offset:].view(n, d)
    w = torch.from_numpy(0.1 * _normal(rng, (d,))).to(cuda, dtype)
    return x, w


def _rms_close(got, x, w):
    want = K.rmsnorm_ref(x.float(), w.float(), 1e-6)
    err = (got.float() - want).abs()
    tol = F32_TOL if got.dtype == torch.float32 else BF16_TOL
    assert bool((err <= tol + tol * want.abs()).all())
    if got.dtype == torch.bfloat16:
        assert bool((err <= 2.0 ** -8 * want.abs() + 1e-3).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n,d,p", _rms_path_cases())
def test_rmsnorm_paths_match_plain_on_card(cuda, dtype, n, d, p):
    """Each path on every shape it can cover; threads past the row's last
    vector load nothing and store nothing."""
    x, w = _rms_card_inputs(cuda, dtype, n, d)
    out = torch.empty_like(x)
    K.reset_launches()
    RN._launch(x, w, out, 1e-6, p)
    torch.cuda.synchronize()
    assert K.LAUNCHES["rmsnorm"] == 1
    _rms_close(out, x, w)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,offset,path", [
    (1, 2560, 0, "row"), (1, 3072, 0, "row"), (256, 3072, 0, "row"),
    (300, 3840, 0, "row"), (3, 3004, 0, None), (2, 2999, 0, "scalar"),
    (4, 2560, 1, "scalar"), (3, 3072, 1, "scalar")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_wrapper_paths_on_card(cuda, n, d, offset, path, dtype):
    """The wrapper's own choice: served shapes on the vector paths; a d of
    3004 (a multiple of 4, not of 8) on the scalar path in bf16 only; odd
    d and views at one element's offset (unaligned) on the scalar path."""
    x, w = _rms_card_inputs(cuda, dtype, n, d, offset)
    aligned = x.data_ptr() % 16 == 0
    assert aligned == (offset == 0)
    plan = RN.rmsnorm_plan(n, d, dtype, aligned)
    if path is None:
        path = "scalar" if dtype == torch.bfloat16 else "row"
    assert plan.path == path
    K.reset_launches()
    got = K.rmsnorm(x, w, 1e-6)
    torch.cuda.synchronize()
    assert K.LAUNCHES["rmsnorm"] == 1 and got.dtype == dtype
    _rms_close(got, x, w)
