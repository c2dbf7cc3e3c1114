"""The RMSNorm and WKV-6 kernels' plans and the arithmetic of their CUDA
partitions, on the CPU.

``rmsnorm_plan`` and ``wkv6_plan`` choose a kernel path from the shapes
(and the pointers' alignment) alone; these tests pin the choice at the
served shapes and at the edges: odd d and dh, unaligned views, T > 1.
The CUDA kernels cannot run here, so their partitions are mirrored in
plain PyTorch (in this file only):

* RMSNorm's row path: thread t of a block owns the 16-byte vectors
  t + i * threads of its row; its sum of squares goes through the warp's
  xor shuffle tree, and the warps' partials are added in warp order.  The
  scalar path strides over 256 threads and reduces the 8 warps' partials
  with a second tree in warp 0.
* WKV-6's decode kernel: block (b·H + h, column tile of 16), thread (row
  slice of 4 rows, column group of ``vec`` columns); each thread's
  partial output sum_i r_i S_ij + (sum_i r_i u_i k_i) v_j over its rows,
  a warp's slices merged by the xor shuffle tree, the warps' sums added
  in warp order; the state update w_i S_ij + k_i v_j.

Each mirror also counts how often each element of x (or of S) is touched:
exactly once.  The mirrors compute in float32 and are held against
``rmsnorm_ref`` and ``wkv6_ref`` at the reference kernel tests' 2e-5 (of
the values' scale for WKV-6): they differ only in the order of float32
sums.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from repro.kernels import ref as ref_kernels

RN = importlib.import_module("repro_torch.kernels.rmsnorm")
WK = importlib.import_module("repro_torch.kernels.wkv6")

TOL = 2e-5
SMS = 132
EPS = 1e-6


# -- RMSNorm's plan ----------------------------------------------------------

@pytest.mark.parametrize("n,d,threads", [(1, 3072, 384), (1, 2560, 320),
                                         (7, 3072, 384), (132, 2560, 320)])
def test_rmsnorm_plan_decode_rows_take_a_block_each(n, d, threads):
    """The served decode rows: one 16-byte vector a thread (8 bf16), the
    block d / 8 threads: 384 at gemma-7b's d, 320 at rwkv6-3b's."""
    assert RN.rmsnorm_plan(n, d, torch.bfloat16) == RN.RmsnormPlan(
        "row", threads, 1)
    # float32: 4 elements a vector, so twice the threads.
    assert RN.rmsnorm_plan(n, d, torch.float32) == RN.RmsnormPlan(
        "row", 2 * threads, 1)


@pytest.mark.parametrize("n", [133, 256, 300, 4096])
def test_rmsnorm_plan_many_rows_take_two_vectors_a_thread(n):
    """Above SMS rows (the 256-row prefill chunk) each thread owns two
    vectors of its row, half the threads of a decode row."""
    assert RN.rmsnorm_plan(n, 3072, torch.bfloat16) == RN.RmsnormPlan(
        "row", 192, 2)
    assert RN.rmsnorm_plan(n, 3840, torch.bfloat16) == RN.RmsnormPlan(
        "row", 256, 2)


@pytest.mark.parametrize("d,dtype,path", [
    (3004, torch.bfloat16, "scalar"),   # a multiple of 4, not of 8
    (3004, torch.float32, "row"),       # 4 float32 fill 16 bytes
    (2999, torch.bfloat16, "scalar"),
    (2999, torch.float32, "scalar"),
    (40, torch.bfloat16, "row"),
    (6, torch.float32, "scalar")])
def test_rmsnorm_plan_odd_d(d, dtype, path):
    assert RN.rmsnorm_plan(3, d, dtype).path == path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_plan_unaligned_views_take_the_scalar_path(dtype):
    """A view one element into its buffer is not 16-byte aligned: the
    wrapper passes aligned=False and the plan takes the scalar kernel."""
    x = torch.zeros(4 * 2560 + 1, dtype=dtype)[1:].view(4, 2560)
    assert x.is_contiguous() and x.data_ptr() % 16
    assert RN.rmsnorm_plan(4, 2560, dtype, aligned=False).path == "scalar"
    assert RN.rmsnorm_plan(4, 2560, dtype).path == "row"


@pytest.mark.parametrize("d,n,want", [
    (8192, 1, ("row", 1024, 1)), (8200, 1, ("row", 544, 2)),
    (16384, 1, ("row", 1024, 2)), (32768, 1, ("row", 1024, 4)),
    (32776, 1, ("scalar", 256, 0)), (8192, 200, ("row", 512, 2))])
def test_rmsnorm_plan_long_rows(d, n, want):
    """A row of more than 1024 vectors takes 2, then 4 vectors a thread;
    beyond 4096 vectors the scalar kernel strides over it."""
    assert tuple(RN.rmsnorm_plan(n, d, torch.bfloat16)) == want


@pytest.mark.parametrize("n,d", [(1, 3072), (256, 3072), (3, 3004),
                                 (9, 40), (2, 32768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_plan_covers_the_row(n, d, dtype):
    """What csrc/rmsnorm.cu's launch checks: whole warps, at most 1024
    threads, and threads * items vectors covering d."""
    plan = RN.rmsnorm_plan(n, d, dtype)
    if plan.path == "row":
        vec = RN.VEC_BYTES // dtype.itemsize
        assert plan.threads % 32 == 0 and plan.threads <= RN.MAX_THREADS
        assert plan.items in RN.ITEMS and d % vec == 0
        assert plan.threads * plan.items * vec >= d
        # No warp is idle: the last warp owns a vector.
        assert (plan.threads - 32) * plan.items * vec < d


# -- RMSNorm's partitions, mirrored ------------------------------------------

def _warp_tree(vals):
    """The xor shuffle tree of 32 lanes along the last axis, offsets 16 to
    1, as __shfl_xor_sync adds them; returns lane 0's sum."""
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        vals = vals + vals[..., lanes ^ off]
    return vals[..., 0]


def _mirror_row_path(x, w, plan):
    """Per-row float32 mirror of rmsnorm_row_kernel: thread t owns vectors
    t + i * threads; returns y and the count of owners of each element."""
    n, d = x.shape
    vec = RN.VEC_BYTES // 4 if x.dtype == torch.float32 else 8
    T, items = plan.threads, plan.items
    span = T * items * vec
    # Thread t's item i is vector v = t + i * T, elements v * vec + e.
    t, i, e = torch.meshgrid(torch.arange(T), torch.arange(items),
                             torch.arange(vec), indexing="ij")
    elem = ((t + i * T) * vec + e).flatten()
    count = torch.zeros(d, dtype=torch.int64)
    live = elem < d
    count.index_add_(0, elem[live], torch.ones(int(live.sum()),
                                               dtype=torch.int64))
    xp = torch.zeros((n, span))
    xp[:, :d] = x.float()
    # (n, item, thread, element of the vector), summed in the kernel's
    # order: items, then the vector's elements.
    xv = xp.view(n, items, T, vec)
    ss = torch.zeros((n, T))
    for i in range(items):
        for e in range(vec):
            ss = ss + xv[:, i, :, e] * xv[:, i, :, e]
    partial = _warp_tree(ss.view(n, T // 32, 32))      # (n, warps)
    tot = torch.zeros(n)
    for q in range(T // 32):
        tot = tot + partial[:, q]
    rs = torch.rsqrt(tot / d + EPS)
    y = (x.float() * rs[:, None]) * (1.0 + w.float())
    return y.to(x.dtype), count


def _mirror_scalar_path(x, w):
    """Float32 mirror of rmsnorm_kernel: thread t strides j = t + 256 k;
    warp trees, then a second tree over the 8 warps' partials."""
    n, d = x.shape
    T = RN.SCALAR_THREADS
    span = -(-d // T) * T
    # Thread t's k-th element is j = t + k * T.
    t, kk = torch.meshgrid(torch.arange(T), torch.arange(span // T),
                           indexing="ij")
    j = (t + kk * T).flatten()
    count = torch.zeros(d, dtype=torch.int64)
    count.index_add_(0, j[j < d], torch.ones(int((j < d).sum()),
                                             dtype=torch.int64))
    xp = torch.zeros((n, span))
    xp[:, :d] = x.float()
    xs = xp.view(n, span // T, T)
    ss = torch.zeros((n, T))
    for k in range(span // T):
        ss = ss + xs[:, k] * xs[:, k]
    partial = _warp_tree(ss.view(n, T // 32, 32))       # (n, 8)
    lanes = torch.zeros((n, 32))
    lanes[:, :T // 32] = partial
    rs = torch.rsqrt(_warp_tree(lanes) / d + EPS)
    y = (x.float() * rs[:, None]) * (1.0 + w.float())
    return y.to(x.dtype), count


def _rms_inputs(n, d, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((n, d)) + 0.5).astype(np.float32)
    w = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)


@pytest.mark.parametrize("d", [2560, 3072, 2999])
@pytest.mark.parametrize("n", [1, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_partition_mirror_matches_plain(d, n, dtype):
    """The plan's partition of each row covers every element exactly once
    and, summed in the kernel's order, gives the plain version's rows
    (and the reference oracle's, for float32)."""
    x, w = _rms_inputs(n, d, dtype, n * 7 + d)
    plan = RN.rmsnorm_plan(n, d, dtype)
    if plan.path == "row":
        got, count = _mirror_row_path(x, w, plan)
    else:
        got, count = _mirror_scalar_path(x, w)
    assert bool((count == 1).all())
    want = RN.rmsnorm_ref(x, w, EPS)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
        oracle = np.asarray(ref_kernels.rmsnorm_ref(x.numpy(), w.numpy(),
                                                    eps=EPS))
        np.testing.assert_allclose(got.numpy(), oracle, atol=TOL, rtol=TOL)
    else:
        # Both round one float32 value to bf16: at most one bf16 step apart.
        err = (got.float() - want.float()).abs()
        assert bool((err <= 2.0 ** -7 * want.float().abs() + 1e-6).all())


@pytest.mark.parametrize("items", [1, 2, 4])
def test_rmsnorm_every_items_count_covers_the_row_once(items):
    """Every vector count a thread can own tiles a row exactly once."""
    d = 3072
    threads = -(-(d // 4) // (32 * items)) * 32   # float32: 4 a vector
    x, w = _rms_inputs(3, d, torch.float32, items)
    got, count = _mirror_row_path(x, w, RN.RmsnormPlan("row", threads, items))
    assert bool((count == 1).all()) and threads * items * 4 >= d
    torch.testing.assert_close(got, RN.rmsnorm_ref(x, w, EPS), atol=TOL,
                               rtol=TOL)


# -- WKV-6's plan ------------------------------------------------------------

def test_wkv6_plan_at_the_served_decode_shape():
    """rwkv6-3b, one token: 40 heads x 4 tiles of 16 columns = 160 blocks
    over the 132 SMs, 16 row slices x 4 float4 groups = 64 threads."""
    plan = WK.wkv6_plan(1, 1, 40, 64, torch.bfloat16)
    assert plan == WK.Wkv6Plan("decode", 4, 4, 64)
    assert 40 * plan.tiles == 160 >= SMS


@pytest.mark.parametrize("T", [2, 64, 100, 512])
@pytest.mark.parametrize("dh,threads", [(16, 32), (33, 64), (64, 64),
                                        (120, 128), (128, 128)])
def test_wkv6_plan_longer_calls_take_the_sequential_kernel(T, dh, threads):
    assert WK.wkv6_plan(2, T, 4, dh, torch.float32) == WK.Wkv6Plan(
        "sequential", 0, 1, threads)


@pytest.mark.parametrize("dh,vec,tiles,threads", [
    (16, 4, 1, 32), (24, 4, 2, 32), (32, 4, 2, 32), (64, 4, 4, 64),
    (120, 4, 8, 128), (128, 4, 8, 128), (7, 1, 1, 32), (3, 1, 1, 32),
    (126, 1, 8, 512)])
def test_wkv6_plan_decode_geometry(dh, vec, tiles, threads):
    """float4 columns where dh is a multiple of 4, one column a thread
    elsewhere; the block rounded up to whole warps, at most 512 threads."""
    plan = WK.wkv6_plan(3, 1, 5, dh, torch.bfloat16)
    assert plan == WK.Wkv6Plan("decode", vec, tiles, threads)
    groups = WK.COL_TILE // vec
    assert threads % 32 == 0 and threads <= 512
    assert threads // groups * WK.ROWS_PER_THREAD >= dh
    assert tiles * WK.COL_TILE >= dh > (tiles - 1) * WK.COL_TILE


def test_wkv6_plan_unaligned_state_takes_the_scalar_columns():
    assert WK.wkv6_plan(1, 1, 40, 64, torch.bfloat16,
                        aligned=False) == WK.Wkv6Plan("decode", 1, 4, 256)


# -- WKV-6's decode partition, mirrored --------------------------------------

def _mirror_decode(r, k, v, w, u, S0, plan):
    """Float32 mirror of wkv6_decode_kernel at T = 1.  r, k, v, w (B, H,
    dh); u (H, dh); S0 (B, H, dh, dh).  Returns out (B, H, dh), the new S
    and the number of threads that own each element of S."""
    B, H, dh = r.shape
    vec, tiles, threads = plan.vec, plan.tiles, plan.threads
    groups = WK.COL_TILE // vec
    slices = threads // groups
    rows, cols = slices * WK.ROWS_PER_THREAD, tiles * WK.COL_TILE
    warps, per_warp = threads // 32, 32 // groups

    def pad_rows(a):
        out = torch.zeros(a.shape[:-1] + (rows,))
        out[..., :dh] = a
        return out.view(a.shape[:-1] + (slices, WK.ROWS_PER_THREAD))
    rr, kk, ww = (pad_rows(a.float()) for a in (r, k, w))
    uu = pad_rows(u.float())[None]                       # (1, H, sl, 4)
    vp = torch.zeros((B, H, cols))
    vp[..., :dh] = v.float()
    vv = vp.view(B, H, tiles, groups, vec)
    Sp = torch.zeros((B, H, rows, cols))
    Sp[..., :dh, :dh] = S0
    # (B, H, slice, row of the slice, tile, group, column of the group)
    S = Sp.view(B, H, slices, WK.ROWS_PER_THREAD, tiles, groups, vec).clone()
    owners = torch.zeros((rows, cols), dtype=torch.int64)
    for s_ in range(slices):
        for g in range(groups):
            for t in range(tiles):
                c0 = t * WK.COL_TILE + g * vec
                owners[s_ * 4:s_ * 4 + 4, c0:c0 + vec] += 1

    p = torch.zeros((B, H, slices, tiles, groups, vec))
    bonus = torch.zeros((B, H, slices))
    for a in range(WK.ROWS_PER_THREAD):
        ra, ka, wa = (t[..., a] for t in (rr, kk, ww))   # (B, H, slices)
        bonus = bonus + (ra * uu[..., a]) * ka
        kv = ka[..., None, None, None] * vv[:, :, None]
        sa = S[:, :, :, a]
        p = p + ra[..., None, None, None] * sa
        S[:, :, :, a] = wa[..., None, None, None] * sa + kv
    o = bonus[..., None, None, None] * vv[:, :, None] + p
    # A warp's slices through the xor tree (offsets groups .. 16 are the
    # slice-in-warp bits), then the warps in order.
    o = o.view(B, H, warps, per_warp, tiles, groups, vec)
    sl = torch.arange(per_warp)
    bit = 1
    while bit < per_warp:
        o = o + o[:, :, :, sl ^ bit]
        bit *= 2
    out = torch.zeros((B, H, tiles, groups, vec))
    for q in range(warps):
        out = out + o[:, :, q, 0]
    out = out.reshape(B, H, cols)[..., :dh]
    S_new = S.view(B, H, rows, cols)[..., :dh, :dh]
    return out, S_new, owners[:dh, :dh]


@pytest.mark.parametrize("dh", [16, 24, 32, 64, 128, 7, 126])
@pytest.mark.parametrize("aligned", [True, False])
def test_wkv6_decode_partition_mirror_matches_plain(dh, aligned):
    """Every element of S is owned by exactly one thread, and the
    partition's sums, in the kernel's order, give wkv6_ref's output and
    state from a non-zero state, and the reference oracle's from S = 0."""
    B, H = 2, 3
    rng = np.random.default_rng(dh + 1000 * aligned)
    r, k, v = (torch.from_numpy(rng.standard_normal((B, H, dh))
                                .astype(np.float32)) for _ in range(3))
    w = torch.from_numpy(np.exp(-np.exp(rng.standard_normal((B, H, dh))))
                         .astype(np.float32))
    u = torch.from_numpy((0.5 * rng.standard_normal((H, dh)))
                         .astype(np.float32))
    S0 = torch.from_numpy((0.1 * rng.standard_normal((B, H, dh, dh)))
                          .astype(np.float32))
    plan = WK.wkv6_plan(B, 1, H, dh, torch.float32, aligned)
    out, S, owners = _mirror_decode(r, k, v, w, u, S0, plan)
    assert bool((owners == 1).all())
    want, S_want = WK.wkv6_ref(*(t[:, None] for t in (r, k, v, w)), u, S0)
    scale, s_scale = float(want.abs().max()), float(S_want.abs().max())
    assert float((out - want[:, 0]).abs().max()) <= TOL * scale
    assert float((S - S_want).abs().max()) <= TOL * s_scale
    # The reference's oracle (heads first) starts from S = 0.
    out0, S1, _ = _mirror_decode(r, k, v, w, u, torch.zeros_like(S0), plan)
    o_ref, s_ref = ref_kernels.wkv6_ref(
        *(jnp.asarray(t.numpy()[:, :, None]) for t in (r, k, v, w)),
        jnp.asarray(u.numpy()))
    o_ref, s_ref = np.asarray(o_ref)[:, :, 0], np.asarray(s_ref)
    assert float(np.abs(out0.numpy() - o_ref).max()) <= \
        TOL * float(np.abs(o_ref).max())
    assert float(np.abs(S1.numpy() - s_ref).max()) <= \
        TOL * float(np.abs(s_ref).max())
