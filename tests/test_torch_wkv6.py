"""The port's WKV-6 kernel module against the reference.

On the CPU the wrapper runs its plain PyTorch version, which is held
against the reference's oracle (``repro.kernels.ref.wkv6_ref``: output
and state within 1e-5 of their scale, the two differing only in the order
of float32 sums), its Pallas kernel in interpret mode (within the
reference kernel test's own 1e-4 of scale: the chunked identity's
exp(-cum) loses digits) and its jnp chunked form from a non-zero state
(within tests/test_models_consistency.py's atol 5e-4, rtol 1e-3).  Inputs
are made with numpy from a seed; the port's layout is the model's
(B, T, H, dh), the reference kernels' (B, H, T, dh).  Tests marked ``gpu``
hold the CUDA kernel to the plain version on the card and skip here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_kernels
from repro.kernels.rwkv6_scan import wkv6 as pallas_wkv6
from repro.models.rwkv import wkv6_chunked
from repro_torch import kernels as K
from repro_torch.kernels.wkv6 import CHUNKED_T

KERNEL_SHAPES = [(1, 1, 64, 32, 16), (2, 2, 128, 64, 32), (1, 3, 96, 16, 32)]
ORACLE_TOL, PALLAS_TOL = 1e-5, 1e-4
ON_CARD_TOL = 2e-5


def _inputs(seed, B, T, H, dh, w_lo=0.75, w_hi=0.999, u_scale=0.5):
    """r, k, v normal, w uniform(w_lo, w_hi), u u_scale·normal, float32
    numpy arrays in the model's layout (B, T, H, dh)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, dh)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(w_lo, w_hi, (B, T, H, dh)).astype(np.float32)
    u = (u_scale * rng.standard_normal((H, dh))).astype(np.float32)
    return r, k, v, w, u


def _heads_first(a):
    return jnp.asarray(np.moveaxis(a, 1, 2))   # (B,T,H,dh) -> (B,H,T,dh)


def _assert_scaled(got, want, tol):
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=tol)


@pytest.mark.parametrize("B,H,T,dh,chunk", KERNEL_SHAPES)
def test_plain_matches_reference_oracle(B, H, T, dh, chunk):
    r, k, v, w, u = _inputs(B * 100 + T + dh, B, T, H, dh)
    want, S_want = ref_kernels.wkv6_ref(*map(_heads_first, (r, k, v, w)),
                                        jnp.asarray(u))
    got, S = K.wkv6_ref(*map(torch.from_numpy, (r, k, v, w, u)))
    assert got.dtype == S.dtype == torch.float32
    _assert_scaled(got.numpy(), np.moveaxis(np.asarray(want), 2, 1),
                   ORACLE_TOL)
    _assert_scaled(S.numpy(), S_want, ORACLE_TOL)


@pytest.mark.parametrize("B,H,T,dh,chunk", KERNEL_SHAPES)
def test_plain_matches_pallas_interpret(B, H, T, dh, chunk):
    r, k, v, w, u = _inputs(B * 100 + T + dh + 1, B, T, H, dh)
    want = pallas_wkv6(*map(_heads_first, (r, k, v, w)), jnp.asarray(u),
                       chunk=chunk, interpret=True)
    got, _ = K.wkv6_ref(*map(torch.from_numpy, (r, k, v, w, u)))
    _assert_scaled(got.numpy(), np.moveaxis(np.asarray(want), 2, 1),
                   PALLAS_TOL)


@pytest.mark.parametrize("T,chunk", [(80, 16), (37, 16), (1, 16)])
def test_wrapper_from_state_matches_chunked_form(T, chunk):
    """The model path's function: from a non-zero state, the state updated
    in place, against the reference's wkv6_chunked (any T: it pads)."""
    B, H, dh = 2, 3, 8
    r, k, v, w, u = _inputs(T, B, T, H, dh, 0.8, 0.999, 0.3)
    S0 = (0.5 * np.random.default_rng(T + 1).standard_normal(
        (B, H, dh, dh))).astype(np.float32)
    want, S_want = wkv6_chunked(*map(jnp.asarray, (r, k, v, w, u, S0)),
                                chunk=chunk)
    S = torch.from_numpy(S0.copy())
    K.reset_launches()
    got = K.wkv6(*map(torch.from_numpy, (r, k, v, w, u)), S)
    assert K.LAUNCHES["wkv6"] == 0          # the CPU runs the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_want), atol=5e-4,
                               rtol=1e-3)
    plain, S_plain = K.wkv6_ref(*map(torch.from_numpy, (r, k, v, w, u, S0)))
    assert torch.equal(got, plain) and torch.equal(S, S_plain)


def test_state_carries_across_calls():
    """Two calls carrying the state equal one call over both spans."""
    r, k, v, w, u = map(torch.from_numpy, _inputs(5, 1, 20, 2, 16))
    S_one = torch.zeros(1, 2, 16, 16)
    whole = K.wkv6(r, k, v, w, u, S_one)
    S_two = torch.zeros(1, 2, 16, 16)
    parts = [K.wkv6(*(t[:, a:b].contiguous() for t in (r, k, v, w)), u,
                    S_two) for a, b in ((0, 13), (13, 20))]
    torch.testing.assert_close(torch.cat(parts, dim=1), whole, atol=1e-6,
                               rtol=1e-6)
    torch.testing.assert_close(S_two, S_one, atol=1e-6, rtol=1e-6)


def test_wrapper_rounds_output_from_the_chunked_threshold():
    """From CHUNKED_T = 512 tokens on, the reference runs wkv6_chunked,
    which returns r's dtype (models/rwkv.py:119); its time-mix widens that
    to float32 again (:166).  The wrapper's float32 output is then
    bf16-representable for bf16 r/k/v, and agrees with the chunked form to
    its rounding; below the threshold, and for float32 inputs, it is not
    rounded."""
    assert CHUNKED_T == 512
    B, H, dh = 1, 2, 8
    r, k, v, w, u = _inputs(512, B, 512, H, dh)
    rb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (r, k, v))
    wt, ut = torch.from_numpy(w), torch.from_numpy(u)
    got = K.wkv6(rb, kb, vb, wt, ut, torch.zeros(B, H, dh, dh))
    assert got.dtype == torch.float32
    assert torch.equal(got, got.bfloat16().float())
    plain, _ = K.wkv6_ref(rb, kb, vb, wt, ut)
    assert torch.equal(got, plain.bfloat16().float())
    assert not torch.equal(plain, plain.bfloat16().float())
    want, _ = wkv6_chunked(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                             for t in (rb, kb, vb)),
                           jnp.asarray(w), jnp.asarray(u),
                           jnp.zeros((B, H, dh, dh)), chunk=32)
    want = np.asarray(want.astype(jnp.float32))
    scale = np.abs(want).max()
    # One bf16 ulp (2^-7 of a value) where the two round a value near a
    # rounding boundary apart, over the chunked form's own 5e-4.
    assert (np.abs(got.numpy() - want)
            <= 2.0 ** -7 * np.abs(want) + 5e-4 * scale).all()
    short = K.wkv6(*(t[:, :511].contiguous() for t in (rb, kb, vb)),
                   wt[:, :511].contiguous(), ut, torch.zeros(B, H, dh, dh))
    assert not torch.equal(short, short.bfloat16().float())
    f32 = K.wkv6(*map(torch.from_numpy, (r, k, v, w, u)),
                 torch.zeros(B, H, dh, dh))
    assert not torch.equal(f32, f32.bfloat16().float())


def _args(**over):
    B, T, H, dh = 1, 3, 2, 8
    a = dict(r=torch.zeros(B, T, H, dh), k=torch.zeros(B, T, H, dh),
             v=torch.zeros(B, T, H, dh), w=torch.ones(B, T, H, dh),
             u=torch.zeros(H, dh), S=torch.zeros(B, H, dh, dh))
    a.update(over)
    return a


@pytest.mark.parametrize("bad", [
    "k_shape", "u_shape", "S_shape", "empty_T", "dh_too_big", "r_dim",
    "float16", "mixed_rkv", "w_bf16", "S_f64", "noncontig", "device"])
def test_wrapper_refuses_what_it_does_not_take(bad):
    z = torch.zeros
    over = {
        "k_shape": dict(k=z(1, 3, 2, 7)),
        "u_shape": dict(u=z(2, 7)),
        "S_shape": dict(S=z(1, 2, 8, 7)),
        "empty_T": dict(r=z(1, 0, 2, 8), k=z(1, 0, 2, 8), v=z(1, 0, 2, 8),
                        w=z(1, 0, 2, 8)),
        "dh_too_big": dict(r=z(1, 1, 1, 130), k=z(1, 1, 1, 130),
                           v=z(1, 1, 1, 130), w=z(1, 1, 1, 130),
                           u=z(1, 130), S=z(1, 1, 130, 130)),
        "r_dim": dict(r=z(3, 2, 8)),
        "float16": {n: z(1, 3, 2, 8, dtype=torch.float16)
                    for n in ("r", "k", "v")},
        "mixed_rkv": dict(k=z(1, 3, 2, 8, dtype=torch.bfloat16)),
        "w_bf16": dict(w=z(1, 3, 2, 8, dtype=torch.bfloat16)),
        "S_f64": dict(S=z(1, 2, 8, 8, dtype=torch.float64)),
        "noncontig": dict(r=z(1, 2, 3, 8).transpose(1, 2)),
        "device": dict(u=z(2, 8, device="meta")),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        K.wkv6(**_args(**over))


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,dh", [(1, 1, 40, 64), (1, 64, 40, 64),
                                      (1, 512, 40, 64), (2, 100, 4, 16),
                                      (1, 7, 3, 120)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_matches_plain_on_card(cuda, B, T, H, dh, dtype):
    r, k, v, w, u = _inputs(B + T + H + dh, B, T, H, dh)
    S0 = torch.from_numpy((0.1 * np.random.default_rng(T).standard_normal(
        (B, H, dh, dh))).astype(np.float32)).to(cuda)
    rkv = [torch.from_numpy(a).to(cuda, dtype) for a in (r, k, v)]
    wt, ut = torch.from_numpy(w).to(cuda), torch.from_numpy(u).to(cuda)
    S = S0.clone()
    K.reset_launches()
    got = K.wkv6(*rkv, wt, ut, S)
    torch.cuda.synchronize()
    assert K.LAUNCHES["wkv6"] == 1
    want, S_want = K.wkv6_ref(*rkv, wt, ut, S0)
    rounded = dtype == torch.bfloat16 and T >= CHUNKED_T
    scale = float(want.abs().max())
    tol = ON_CARD_TOL * scale + (2.0 ** -8 * want.abs() if rounded else 0.0)
    assert bool(((got - want).abs() <= tol).all())
    s_scale = float(S_want.abs().max())
    assert float((S - S_want).abs().max()) <= ON_CARD_TOL * s_scale
