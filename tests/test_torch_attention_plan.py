"""The attention kernel's plan and the arithmetic of its two CUDA paths, on
the CPU.

``attention_plan`` chooses the path and splits of a call from its
shapes alone; these tests pin that it fills the H100's 132 SMs at the
serving path's decode shapes and never makes an empty split.  The CUDA
kernels cannot run here, so their arithmetic is mirrored in plain
PyTorch (in this file only) and held against ``flash_attention_ref`` and
the reference's ``naive_attention``:

* split-K decode: per-split online-softmax partials (m, l, acc) merged
  as ``flash_attention_merge_kernel`` merges them, with the convention
  that a split that saw no key holds m = -inf, l = 0, acc = 0;
* tile skipping: the tensor-core path's per-tile (min, max) liveness
  rule, its walk of the live tiles and, when a row of the block has no
  live key, of the dead ones; keys past K weigh 0;
* the CUDA-core path (``flash_attention_simt_kernel``): its walk of
  packed 64-row blocks over BN-key tiles with "live" and "full" bits, the
  per-tile online-softmax rescale in log2 units, p = 0 without an exp for
  a masked key of a row that already holds a live score, and the second
  pass for a block holding a row without a live key.

Tolerances: float64 mirrors against the float32 plain version at the
reference kernel tests' 2e-5.
"""
import importlib
import math

import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers

FA = importlib.import_module("repro_torch.kernels.flash_attention")

F32_TOL = 2e-5
UNWRITTEN = 2 ** 30
SMS = 132
# The tensor-core path's block: 64 packed query rows (BM of
# csrc/flash_attention.cu).
TILE_ROWS = 64


def key_tile(dh):
    """Keys per tile of the tensor-core path (BN of csrc/flash_attention.cu):
    64, or 32 where dh pads to 256."""
    return 32 if dh > 128 else 64

# (B, Q, H, KV, dh, K) of chip_smoke.py's phase-6 attention cases.
PHASE6 = {"gemma-decode": (1, 1, 16, 16, 256, 545),
          "gemma-prefill": (1, 256, 16, 16, 256, 545),
          "gemma-prefill-first": (1, 256, 16, 16, 256, 545),
          "danube-decode": (1, 1, 32, 8, 120, 4096),
          "danube-prefill": (1, 256, 32, 8, 120, 4096)}


# -- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PHASE6))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_paths_at_phase6_shapes(name, dtype):
    B, Q, H, KV, dh, K = PHASE6[name]
    plan = FA.attention_plan(B, Q, H, KV, dh, K, dtype)
    if Q == 1:
        assert plan.path == "split"
        # Fills the card: at least one block per SM.
        assert B * KV * plan.n_splits >= SMS
        assert plan.workspace == B * KV * plan.n_splits * (H // KV) * (dh + 2)
    elif dtype == torch.bfloat16:
        assert plan.path == "wgmma" and plan.workspace == 0
    else:
        assert plan.path == "simt"


def test_plan_decode_splits_at_served_shapes():
    """gemma: 16 kv heads x 12 splits of 48 keys; danube: 8 x 32 of 128."""
    g = FA.attention_plan(1, 1, 16, 16, 256, 545, torch.bfloat16)
    assert (g.split, g.n_splits) == (48, 12)
    d = FA.attention_plan(1, 1, 32, 8, 120, 4096, torch.bfloat16)
    assert (d.split, d.n_splits) == (128, 32)
    assert min(16 * g.n_splits, 8 * d.n_splits) >= SMS


@pytest.mark.parametrize("K", [1, 2, 31, 32, 33, 63, 545, 4096, 70000])
@pytest.mark.parametrize("B,KV", [(1, 1), (1, 8), (4, 8), (64, 16)])
def test_plan_never_makes_an_empty_split(K, B, KV):
    plan = FA.attention_plan(B, 1, 4 * KV, KV, 64, K, torch.bfloat16)
    assert plan.path == "split"
    assert plan.split % FA.SPLIT_ALIGN == 0 and plan.split >= FA.MIN_SPLIT
    assert 1 <= plan.n_splits <= FA.MAX_SPLITS
    # Every split starts below K; together they cover it.
    assert (plan.n_splits - 1) * plan.split < K <= plan.n_splits * plan.split
    if B * KV * math.ceil(K / FA.MIN_SPLIT) >= FA.TARGET_BLOCKS:
        assert B * KV * plan.n_splits >= SMS


@pytest.mark.parametrize("Q,g,dh,dtype,aligned,path", [
    (1, 8, 64, torch.bfloat16, True, "split"),
    (2, 4, 64, torch.float32, True, "split"),
    (2, 8, 64, torch.bfloat16, True, "wgmma"),
    (9, 1, 8, torch.bfloat16, True, "wgmma"),
    (9, 1, 12, torch.bfloat16, True, "simt"),
    (64, 1, 64, torch.bfloat16, False, "simt"),
    (64, 1, 64, torch.float32, True, "simt"),
])
def test_plan_routes_by_rows_dtype_and_alignment(Q, g, dh, dtype, aligned,
                                                 path):
    plan = FA.attention_plan(1, Q, 2 * g, 2, dh, 100, dtype, aligned)
    assert plan.path == path


# -- mirrors of the kernels' arithmetic ---------------------------------------

def _scores(q, k, qp, kp, causal, window, softcap):
    """float64 scores (B, KV, g, Q, K) and the live mask (Q, K)."""
    B, Q, H, dh = q.shape
    KV = k.shape[2]
    qg = q.double().reshape(B, Q, KV, H // KV, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.double()) / math.sqrt(dh)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    live = torch.ones((Q, k.shape[1]), dtype=torch.bool)
    if causal:
        live &= kp[None, :] <= qp[:, None]
    if window is not None:
        live &= kp[None, :] > qp[:, None] - window
    return torch.where(live, s, FA.NEG_INF), live


def _partial(s, v, keys):
    """Online-softmax state (m, l, acc) of the scores over ``keys`` (a
    list of key indices, maybe empty): m = -inf, l = 0, acc = 0 when
    empty."""
    B, KV, g, Q, _ = s.shape
    dh = v.shape[-1]
    if not keys:
        return (torch.full((B, KV, g, Q), -math.inf, dtype=torch.float64),
                torch.zeros((B, KV, g, Q), dtype=torch.float64),
                torch.zeros((B, KV, g, Q, dh), dtype=torch.float64))
    idx = torch.as_tensor(keys)
    sk = s[..., idx]
    m = sk.max(dim=-1).values
    p = torch.exp(sk - m[..., None])
    vk = v.double()[:, idx].permute(0, 2, 1, 3)  # (B, KV, keys, dh)
    return m, p.sum(-1), torch.einsum("bkgqs,bksd->bkgqd", p, vk)


def _merge(parts):
    """flash_attention_merge_kernel: M = max m; c = exp(m - M), 0 where m
    is -inf; out = sum c acc / max(sum c l, 1e-30)."""
    M = torch.stack([m for m, _, _ in parts]).max(dim=0).values
    L = 0.0
    acc = 0.0
    for m, l, a in parts:
        c = torch.where(m == -math.inf, torch.zeros_like(m), torch.exp(m - M))
        L = L + c * l
        acc = acc + c[..., None] * a
    return acc / torch.clamp(L, min=1e-30)[..., None]


def _model_layout(o, B, Q, H, dh):
    """(B, KV, g, Q, dh) -> (B, Q, H, dh)."""
    return o.permute(0, 3, 1, 2, 4).reshape(B, Q, H, dh)


def split_k_mirror(q, k, v, qp, kp, *, causal=True, window=None,
                   softcap=None, extra_empty=0):
    """Split-K decode as the plan cuts it, plus ``extra_empty`` splits
    that saw no key."""
    B, Q, H, dh = q.shape
    K, KV = k.shape[1], k.shape[2]
    plan = FA.attention_plan(B, Q, H, KV, dh, K, q.dtype)
    s, _ = _scores(q, k, qp, kp, causal, window, softcap)
    parts = [_partial(s, v, list(range(i * plan.split,
                                       min(K, (i + 1) * plan.split))))
             for i in range(plan.n_splits)]
    parts += [_partial(s, v, [])] * extra_empty
    return _model_layout(_merge(parts), B, Q, H, dh), plan


def tile_liveness(q_rows, kp, K, tile, causal, window):
    """The tensor-core path's rule for one block: tile t is dead when
    every key follows every query (causal: min k_pos > max q_pos) or
    precedes every window (max k_pos <= min q_pos - window); positions of
    keys past K are not read."""
    qmin, qmax = int(q_rows.min()), int(q_rows.max())
    live = []
    for t in range(math.ceil(K / tile)):
        ks = kp[t * tile:min(K, (t + 1) * tile)]
        dead = ((causal and int(ks.min()) > qmax)
                or (window is not None and int(ks.max()) <= qmin - window))
        live.append(not dead)
    return live


def tile_walk_mirror(q, k, v, qp, kp, *, causal=True, window=None,
                     softcap=None, tile=None, rows_per_block=TILE_ROWS):
    """The tensor-core path: each block of packed rows (query r // g, head
    r % g) walks its live key tiles, then its dead ones if a row has no
    live key; a ragged last tile's keys past K weigh 0.  Returns the
    output and, per (b, kv head, block), (live tiles, walked a second
    time?)."""
    B, Q, H, dh = q.shape
    K, KV = k.shape[1], k.shape[2]
    g = H // KV
    if tile is None:
        tile = key_tile(dh)
    n_tiles = math.ceil(K / tile)
    s, live_mask = _scores(q, k, qp, kp, causal, window, softcap)
    # Pad the keys to whole tiles: padded keys score -inf.
    pad = n_tiles * tile - K
    s = torch.cat([s, torch.full((*s.shape[:-1], pad), -math.inf,
                                 dtype=s.dtype)], dim=-1)
    vp = torch.cat([v.double(), torch.zeros((B, pad, KV, dh),
                                            dtype=torch.float64)], dim=1)
    out = torch.zeros((B, KV, g, Q, dh), dtype=torch.float64)
    walks = {}
    rows = Q * g
    for r0 in range(0, rows, rows_per_block):
        r = torch.arange(r0, min(rows, r0 + rows_per_block))
        qi, hg = r // g, r % g
        live = tile_liveness(qp[qi], kp, K, tile, causal, window)
        order = [t for t in range(n_tiles) if live[t]]
        keys = [j for t in order for j in range(t * tile, (t + 1) * tile)]
        sb = s[:, :, hg, qi]  # (B, KV, rows in block, K padded)
        m = (sb[..., keys].max(-1).values if keys
             else torch.full(sb.shape[:-1], -math.inf, dtype=s.dtype))
        second = bool((m <= FA.NEG_INF).any())
        if second:
            order += [t for t in range(n_tiles) if not live[t]]
        keys = [j for t in order for j in range(t * tile, (t + 1) * tile)]
        part = _partial(sb[:, :, None], vp, keys)
        o = _merge([part])[:, :, 0]  # (B, KV, rows in block, dh)
        out[:, :, hg, qi] = o
        for b in range(B):
            for kvh in range(KV):
                walks[(b, kvh, r0)] = (live, second)
        # The rule skips only tiles in which every row of the block is
        # masked (brute force over the mask).
        for t in range(n_tiles):
            if not live[t]:
                cols = slice(t * tile, min(K, (t + 1) * tile))
                assert not bool(live_mask[qi][:, cols].any())
    return _model_layout(out, B, Q, H, dh), walks


def _inputs(seed, B, Q, H, KV, dh, K):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, Q, H, dh)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, K, KV, dh))
                             .astype(np.float32)) for _ in range(2))
    return q, k, v


def _ring(slots, last):
    """danube's wrapped ring: slot i holds i + slots for i <= last - slots."""
    i = np.arange(slots)
    return torch.as_tensor(np.where(i <= last - slots, i + slots, i),
                           dtype=torch.int32)


# -- split-K merge --------------------------------------------------------------

SPLIT_CASES = {
    # name: (B, Q, H, KV, dh, K, q_pos, k_pos, window, softcap)
    "gemma-like": (1, 1, 4, 4, 32, 545, [272],
                   np.r_[np.arange(273), np.full(272, UNWRITTEN)], None,
                   None),
    "gqa-window-ring": (1, 1, 8, 2, 24, 300, None, "ring", 64, None),
    "two-queries-softcap": (2, 2, 4, 1, 16, 97, [95, 96], None, None, 3.0),
    "fully-masked-row": (1, 2, 4, 2, 16, 130, [-1, 129], None, None, None),
    "fully-masked-call": (1, 1, 4, 2, 16, 70, [5], np.arange(100, 170),
                          None, None),
    "one-key": (1, 1, 2, 1, 8, 1, [0], [0], None, None),
}


def _case_positions(Q, K, q_pos, k_pos):
    if isinstance(k_pos, str):
        kp = _ring(K, K + 50)
        qp = torch.tensor([K + 50], dtype=torch.int32)
        return qp, kp
    kp = torch.as_tensor(np.arange(K) if k_pos is None else k_pos,
                         dtype=torch.int32)
    qp = torch.as_tensor(q_pos, dtype=torch.int32)
    return qp, kp


@pytest.mark.parametrize("extra_empty", [0, 3])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_k_merge_mirror_matches_plain(name, extra_empty):
    B, Q, H, KV, dh, K, q_pos, k_pos, window, softcap = SPLIT_CASES[name]
    q, k, v = _inputs(len(name), B, Q, H, KV, dh, K)
    qp, kp = _case_positions(Q, K, q_pos, k_pos)
    got, plan = split_k_mirror(q, k, v, qp, kp, window=window,
                               softcap=softcap, extra_empty=extra_empty)
    assert plan.path == "split"
    want = FA.flash_attention_ref(q, k, v, qp, kp, window=window,
                                  softcap=softcap)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               atol=F32_TOL, rtol=F32_TOL)
    if name == "fully-masked-call":
        # Every score is -1e30: each head averages v over all K keys.
        uniform = v[0].mean(dim=0).repeat_interleave(H // KV, dim=0)
        np.testing.assert_allclose(got[0, 0].float().numpy(),
                                   uniform.numpy(), atol=F32_TOL)


def test_split_k_mirror_matches_naive_attention():
    """The merge against the reference's model-layer attention."""
    B, Q, H, KV, dh, K = 1, 1, 8, 2, 16, 200
    q, k, v = _inputs(5, B, Q, H, KV, dh, K)
    qp, kp = torch.tensor([250], dtype=torch.int32), _ring(K, 250)
    got, _ = split_k_mirror(q, k, v, qp, kp, window=120)
    want = np.asarray(ref_layers.naive_attention(
        q.numpy(), k.numpy(), v.numpy(), causal=True, window=120,
        q_positions=qp.numpy(), k_positions=kp.numpy()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=F32_TOL,
                               rtol=F32_TOL)


# -- tile skipping ----------------------------------------------------------

TILE_CASES = {
    # name: (B, Q, H, KV, dh, K, q_pos, k_pos, window, softcap, causal)
    "first-chunk": (1, 96, 2, 2, 16, 200, np.arange(96),
                    np.r_[np.arange(96), np.full(104, UNWRITTEN)], None,
                    None, True),
    "second-chunk": (1, 96, 2, 2, 16, 200, np.arange(96, 192),
                     np.r_[np.arange(192), np.full(8, UNWRITTEN)], None,
                     None, True),
    "gqa-ring-window": (1, 40, 8, 2, 24, 256, np.arange(261, 301), "ring",
                        100, None, True),
    "ragged-last-tile": (2, 70, 4, 2, 16, 75, np.arange(5, 75), None, None,
                         2.0, True),
    "masked-row-in-live-tile": (1, 70, 2, 1, 16, 130, np.arange(-6, 64),
                                None, None, None, True),
    "fully-masked-call": (1, 70, 2, 1, 16, 130, np.arange(70),
                          np.arange(500, 630), None, None, True),
    "non-causal": (1, 70, 2, 2, 16, 130, np.arange(70), None, None, None,
                   False),
}


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("name", sorted(TILE_CASES))
def test_tile_walk_mirror_matches_plain(name, tile):
    (B, Q, H, KV, dh, K, q_pos, k_pos, window, softcap,
     causal) = TILE_CASES[name]
    q, k, v = _inputs(len(name) + tile, B, Q, H, KV, dh, K)
    if isinstance(k_pos, str):
        kp = _ring(K, int(q_pos[-1]))
    else:
        kp = torch.as_tensor(np.arange(K) if k_pos is None else k_pos,
                             dtype=torch.int32)
    qp = torch.as_tensor(q_pos, dtype=torch.int32)
    got, walks = tile_walk_mirror(q, k, v, qp, kp, causal=causal,
                                  window=window, softcap=softcap, tile=tile)
    want = FA.flash_attention_ref(q, k, v, qp, kp, causal=causal,
                                  window=window, softcap=softcap)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               atol=F32_TOL, rtol=F32_TOL)
    skipped = sum(not t for live, _ in walks.values() for t in live)
    second = any(s for _, s in walks.values())
    if name in ("first-chunk", "second-chunk", "gqa-ring-window"):
        assert skipped > 0 and not second
    if name in ("masked-row-in-live-tile", "fully-masked-call"):
        # A block holding a row without a live key walks every tile.
        assert second
    if name == "fully-masked-call":
        np.testing.assert_allclose(got[0, 3].float().numpy(),
                                   v[0].mean(dim=0).repeat_interleave(
                                       H // KV, dim=0).numpy(),
                                   atol=F32_TOL)
    if name == "non-causal":
        assert skipped == 0


def test_tile_walk_mirror_at_gemma_first_chunk():
    """gemma's first prefill chunk at full width but 2 heads: positions
    0..255 over the 545-slot cache; more than half the (block, tile)
    pairs are dead."""
    B, Q, H, KV, dh, K = 1, 256, 2, 2, 256, 545
    q, k, v = _inputs(3, B, Q, H, KV, dh, K)
    qp = torch.arange(256, dtype=torch.int32)
    kp = torch.as_tensor(np.r_[np.arange(256), np.full(289, UNWRITTEN)],
                         dtype=torch.int32)
    got, walks = tile_walk_mirror(q, k, v, qp, kp)
    want = FA.flash_attention_ref(q, k, v, qp, kp)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               atol=F32_TOL, rtol=F32_TOL)
    pairs = [t for live, _ in walks.values() for t in live]
    assert sum(not t for t in pairs) > len(pairs) / 2


# -- the CUDA-core path's walk ----------------------------------------------

LOG2E = 1.4426950408889634
MASKED2 = FA.NEG_INF * LOG2E


def simt_tile(dh):
    """(DHP, BN) of the CUDA-core path: dh zero-padded to 64, 128 or 256;
    64 keys a tile, 32 where dh pads to 128 or 256 (simt_key_tile of
    csrc/flash_attention.cu)."""
    dhp = 64 if dh <= 64 else 128 if dh <= 128 else 256
    return dhp, 64 if dhp == 64 else 32


def simt_walk_mirror(q, k, v, qp, kp, *, causal=True, window=None,
                     softcap=None):
    """``flash_attention_simt_kernel``'s walk in float64: per block of 64
    packed rows (query r // g, head r % g) of a kv head, the key tiles'
    liveness and "full" bits from their (min, max) k_pos against the
    block's (min, max) q_pos; the live tiles in order, each folded into the
    rows' (m, l, O) in log2 units (masked scores -1e30 log2e, keys past K
    -inf; a masked key of a row whose maximum is live weighs 0 without an
    exp); then the dead tiles only if a valid row has no live key.  Returns
    the output and, per block start r0, (live bits, full bits, second pass,
    tiles walked)."""
    B, Q, H, dh = q.shape
    K, KV = k.shape[1], k.shape[2]
    g = H // KV
    rows = Q * g
    _, bn = simt_tile(dh)
    n_tiles = math.ceil(K / bn)
    qg = q.double().reshape(B, Q, KV, g, dh)
    raw = torch.einsum("bqkgd,bskd->bkgqs", qg, k.double()) / math.sqrt(dh)
    if softcap is not None:
        raw = softcap * torch.tanh(raw / softcap)
    raw = raw * LOG2E
    vd = v.double().permute(0, 2, 1, 3)                   # (B, KV, K, dh)
    out = torch.zeros((B, KV, g, Q, dh), dtype=torch.float64)
    walks = {}
    # The grid runs the row tiles in reverse; each block is independent.
    for r0 in reversed(range(0, rows, TILE_ROWS)):
        r = torch.arange(r0, min(rows, r0 + TILE_ROWS))
        qi, hg = r // g, r % g
        qpos = qp[qi].long()
        qmin, qmax = int(qpos.min()), int(qpos.max())
        live, full = [], []
        for t in range(n_tiles):
            ks = kp[t * bn:min(K, (t + 1) * bn)].long()
            lo, hi = int(ks.min()), int(ks.max())
            dead = ((causal and lo > qmax)
                    or (window is not None and hi <= qmin - window))
            live.append(not dead)
            full.append((t + 1) * bn <= K and (not causal or hi <= qmin)
                        and (window is None or lo > qmax - window))
        s = raw[:, :, hg, qi]                          # (B, KV, rows, K)
        m = torch.full(s.shape[:-1], -math.inf, dtype=torch.float64)
        lsum = torch.zeros_like(m)
        o = torch.zeros((*m.shape, dh), dtype=torch.float64)
        walked = []
        second = False
        for pass_ in (0, 1):
            if pass_ == 1:
                second = bool((m <= MASKED2).any())
                if not second:
                    break
            for t in range(n_tiles):
                if live[t] != (pass_ == 0):
                    continue
                walked.append(t)
                j = torch.arange(t * bn, (t + 1) * bn)
                inside = j < K
                jc = torch.clamp(j, max=K - 1)
                x = s[..., jc]
                if not full[t]:
                    kpt = kp[jc].long()
                    ok = torch.ones((len(r), bn), dtype=torch.bool)
                    if causal:
                        ok &= kpt[None, :] <= qpos[:, None]
                    if window is not None:
                        ok &= kpt[None, :] > qpos[:, None] - window
                    x = torch.where(ok, x, MASKED2)
                    x = torch.where(inside, x, -math.inf)
                else:
                    assert bool(inside.all())
                mn = torch.maximum(m, x.max(dim=-1).values)
                alpha = torch.where(m == -math.inf, torch.zeros_like(m),
                                    torch.exp2(m - mn))
                no_exp = (x <= MASKED2) & (mn > MASKED2)[..., None]
                p = torch.where(no_exp, torch.zeros_like(x),
                                torch.exp2(x - mn[..., None]))
                vt = torch.where(inside[:, None], vd[:, :, jc],
                                 torch.zeros((), dtype=torch.float64))
                lsum = lsum * alpha + p.sum(-1)
                o = o * alpha[..., None] + torch.einsum("bkrs,bksd->bkrd",
                                                        p, vt)
                m = mn
        out[:, :, hg, qi] = o / torch.clamp(lsum, min=1e-30)[..., None]
        walks[r0] = (live, full, second, walked)
    return _model_layout(out, B, Q, H, dh), walks


SIMT_CASES = {
    # name: (B, Q, H, KV, dh, K, q_pos, k_pos, window, softcap, causal)
    "st-100m-heads-s256": (1, 256, 12, 12, 64, 256, np.arange(256), None,
                           None, None, True),
    "danube-smoke-gqa-window-softcap": (2, 256, 4, 2, 16, 256,
                                        np.arange(256), None, 16, 30.0,
                                        True),
    "phase6-ring-window-dh120": (1, 64, 4, 1, 120, 4096,
                                 np.arange(4937, 5001), "ring", 4096, None,
                                 True),
    "gemma-first-chunk-dh256": (1, 256, 2, 2, 256, 545, np.arange(256),
                                np.r_[np.arange(256),
                                      np.full(289, UNWRITTEN)],
                                None, None, True),
    "ragged-last-tile": (2, 70, 4, 2, 16, 75, np.arange(5, 75), None, None,
                         2.0, True),
    "fully-masked-call": (1, 70, 2, 1, 16, 130, np.arange(70),
                          np.arange(500, 630), None, None, True),
    "masked-row-in-live-tile": (1, 70, 2, 1, 16, 130, np.arange(-6, 64),
                                None, None, None, True),
}


def _simt_case(name):
    (B, Q, H, KV, dh, K, q_pos, k_pos, window, softcap,
     causal) = SIMT_CASES[name]
    q, k, v = _inputs(100 + len(name), B, Q, H, KV, dh, K)
    if isinstance(k_pos, str):
        kp = _ring(K, int(q_pos[-1]))
    else:
        kp = torch.as_tensor(np.arange(K) if k_pos is None else k_pos,
                             dtype=torch.int32)
    qp = torch.as_tensor(q_pos, dtype=torch.int32)
    return q, k, v, qp, kp, dict(causal=causal, window=window,
                                 softcap=softcap)


@pytest.mark.parametrize("name", sorted(SIMT_CASES))
def test_simt_walk_mirror_matches_plain(name):
    q, k, v, qp, kp, kw = _simt_case(name)
    B, Q, H, dh = q.shape
    assert FA.attention_plan(B, Q, H, k.shape[2], dh, k.shape[1],
                             torch.float32).path == "simt"
    got, walks = simt_walk_mirror(q, k, v, qp, kp, **kw)
    want = FA.flash_attention_ref(q, k, v, qp, kp, **kw)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               atol=F32_TOL, rtol=F32_TOL)
    # Only a block holding a valid row without a live key takes the
    # second pass (brute force over the mask).
    live = FA.live_mask(qp, kp, kw["causal"], kw["window"])
    g = H // k.shape[2]
    for r0, (_, _, second, walked) in walks.items():
        qi = torch.arange(r0, min(Q * g, r0 + TILE_ROWS)) // g
        keyless = bool((~live[qi].any(dim=1)).any())
        assert second == keyless
        if not second:
            assert len(walked) == len(set(walked))
    if name == "fully-masked-call":
        np.testing.assert_allclose(got[0, 3].float().numpy(),
                                   v[0].mean(dim=0).repeat_interleave(
                                       g, dim=0).numpy(), atol=F32_TOL)
        assert all(s for _, _, s, _ in walks.values())
    if name == "masked-row-in-live-tile":
        # Rows of query 0..5 see no key; the block holding them walks every
        # tile, the others only their live ones.
        assert walks[0][2] and sorted(walks[0][3]) == [0, 1, 2]
        assert not any(s for r0, (_, _, s, _) in walks.items() if r0)


@pytest.mark.parametrize("name", sorted(SIMT_CASES))
def test_simt_walk_mirror_matches_naive_attention(name):
    q, k, v, qp, kp, kw = _simt_case(name)
    got, _ = simt_walk_mirror(q, k, v, qp, kp, **kw)
    want = np.asarray(ref_layers.naive_attention(
        q.numpy(), k.numpy(), v.numpy(), causal=kw["causal"],
        window=kw["window"], q_positions=qp.numpy(),
        k_positions=kp.numpy(), softcap=kw["softcap"]))
    np.testing.assert_allclose(got.float().numpy(), want, atol=F32_TOL,
                               rtol=F32_TOL)


def test_simt_walk_skips_causal_tiles_at_st100m():
    """st-100m's heads at S = 256: block r0 walks its (r0 / 64 + 1) live
    tiles, the last of them the diagonal (not full), and skips the rest;
    no block needs a second pass."""
    q, k, v, qp, kp, kw = _simt_case("st-100m-heads-s256")
    _, walks = simt_walk_mirror(q, k, v, qp, kp, **kw)
    for r0, (live, full, second, walked) in walks.items():
        n = r0 // TILE_ROWS + 1
        assert walked == list(range(n)) and not second
        assert live == [t < n for t in range(4)]
        assert full == [t < n - 1 for t in range(4)]
    # The gemma first chunk skips the unwritten slots' tiles.
    q, k, v, qp, kp, kw = _simt_case("gemma-first-chunk-dh256")
    _, walks = simt_walk_mirror(q, k, v, qp, kp, **kw)
    assert all(len(w) < math.ceil(545 / 32) for _, _, _, w in walks.values())


def test_simt_walk_ragged_last_tile():
    """K = 75 over 64-key tiles: the last tile is never full, the block of
    the last rows walks it (keys past K weigh 0), the first block skips
    it."""
    q, k, v, qp, kp, kw = _simt_case("ragged-last-tile")
    _, bn = simt_tile(q.shape[-1])
    assert k.shape[1] % bn
    got, walks = simt_walk_mirror(q, k, v, qp, kp, **kw)
    assert not any(full[-1] for _, full, _, _ in walks.values())
    assert walks[64][3] == [0, 1] and walks[0][3] == [0]
    want = FA.flash_attention_ref(q, k, v, qp, kp, **kw)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               atol=F32_TOL, rtol=F32_TOL)
