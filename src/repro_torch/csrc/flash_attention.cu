// Attention with an online softmax over explicitly positioned keys, in the
// model's layout.
//
//   out[b, i, h, :] = sum_j softmax_j(s_ij) * v[b, j, h / g, :]
//   s_ij = softcap(scale * q[b, i, h, :] . k[b, j, h / g, :]),  g = H / KV
//
// with s_ij = -1e30 where key j is masked for query i: causal masks
// k_pos[j] > q_pos[i], a window masks k_pos[j] <= q_pos[i] - window.
// q is (B, Q, H, dh); k and v are (B, K, KV, dh); q_pos (Q,) and k_pos (K,)
// are int32; out is (B, Q, H, dh) in q's dtype.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, pallas_call at line 100; wrappers kernels/ops.py:26
// fold_gqa and :40), whose jnp twins models/layers.py:161 naive_attention
// and :189 chunked_attention are what the reference's transformer runs,
// once per block per model call.  What it computes is that function, not
// its block layout:
//  * positions are explicit, so a ring-buffer KV cache (whose slots hold
//    positions out of order, unwritten ones at 2**30) is attended as it
//    lies; the Pallas kernel's implicit positions are the special case
//    q_pos = K - Q + arange(Q), k_pos = arange(K);
//  * head h reads kv head h / (H / KV): the grouping of layers.py:171,
//    in place of fold_gqa's repeat of k and v;
//  * masked scores are -1e30, not -inf, so a fully masked row averages v
//    uniformly over all K keys, as naive_attention does;
//  * an optional logit softcap (one tanh, before the mask) and any Q, K
//    and dh <= 256.
//
// Bound.  q, the k and v of the keys some query attends (all K when a
// query attends none) and the positions are read once, the output written
// once.  At the serving path's decode call (gemma-7b: Q = 1, H = KV = 16,
// dh = 256, a 545-slot cache, bf16, positions 512..543) k and v of the
// written slots are 8.4-8.9 MB, about 2.6 us at 3.35 TB/s: bound by bytes.
// At the second 256-token prefill chunk (512 written slots) q, k, v and out
// are about 12.6 MB, about 3.8 us, and the first chunk (256) about 8.4 MB;
// the live pairs' 4*dh flops take about 1.6 us at the bf16 tensor-core
// rate of 989 TFLOP/s.  danube's 256-query chunk (H 32, KV 8, dh 120,
// about 4,000 live keys a query) is 16 GFLOP, bound by operations.
//
// Design.  The wrapper (kernels/flash_attention.py::attention_plan) picks
// one of three paths from the shapes alone; positions stay on the card.
//  * split (rows = Q * g <= 8, any dtype): flash-decoding.  The grid is
//    (key split, b * KV); a block of 4 warps serves all g query heads (and
//    all Q queries) of its kv head, so each K/V byte is read once per
//    call.  A key row is read by L = pow2ceil(dh / 8) lanes, 8 elements a
//    lane (one 16-byte load in bf16), so a warp walks 32 / L keys a step;
//    the loads of 4 or 8 steps are issued before any is converted, so they
//    are in flight together.  Scores reduce over the L lanes by shuffles;
//    each lane keeps (m, l, acc) per row in float32.  The block merges its
//    key groups and warps and writes one float32 partial (m, l, acc) per
//    (split, row); flash_attention_merge_kernel combines the splits.  A
//    split that saw no key holds m = -inf, l = 0, acc = 0 and weighs 0 in
//    the merge; the plan never makes one.
//  * wgmma (bf16, rows > 8, dh % 8 == 0, 16-byte aligned): a block owns 64
//    packed query rows (row r is query r / g of head r % g of the kv head,
//    so one K/V tile serves the g heads) and two warpgroups, one per key
//    group: they walk alternate key tiles on their own double-buffered
//    shared-memory rings (cp.async, one named barrier per group) and merge
//    their softmax states at the end.  S = Q.K^T and O += P.V are Hopper
//    warpgroup products (wgmma.mma_async, bf16 in, float32 accumulate):
//    Q and K from shared memory (K-major), P from registers, V from shared
//    memory as an MN-major operand; the tiles are stored 128-byte
//    swizzled, as the descriptors say.  dh is zero-padded to DHP (64, 128
//    or 256); keys come in tiles of BN (64; 32 at DHP 256).  The online
//    softmax stays in registers (exp2 of log2e-scaled scores).  P is split
//    into bf16 hi + lo parts, two products per tile, so P.V carries
//    float32-like probabilities.
//    Key tiles are skipped from the positions: before the walk each
//    thread reduces one tile's k_pos to (min, max); a tile is dead for the
//    block if every key follows every query (causal) or precedes every
//    window, and full if no key is masked for any row (its scores skip the
//    mask).  Live tiles are walked first; if a row of the block then has
//    no live key (its running max is still the masked score), the dead
//    tiles are walked as well, so that row averages v over all K keys.
//    Keys past K (a ragged last tile) are zero-filled and scored -inf:
//    weight 0, never among the -1e30 keys.
//  * simt (float32 with rows > 8, and the bf16 calls wgmma refuses: dh %
//    8 != 0 or unaligned pointers): register-tiled CUDA-core tiles in IEEE
//    float32 FMAs (TF32 stays off, so float32 has no tensor-core path).
//    Bound at st-100m's training call (B 2, S 1024, H 12, dh 64, causal):
//    3.22 GFLOP of live pairs, 0.048 ms at 67 TFLOP/s, by operations.  A
//    block of 256 threads owns 64 packed query rows of one kv head, as
//    wgmma does; the grid's row tiles run in reverse, so causal blocks with
//    the most live keys start first.  The Q tile stays in shared memory;
//    K and V come in tiles of BN keys (64; 32 where dh pads to 128 or 256),
//    staged once per block per tile (16-byte cp.async for aligned float32
//    rows of a multiple of 4, converting loads otherwise), double-buffered
//    so that tile t + 1 loads while tile t computes; rows padded by 16 bytes
//    so that the warps' reads have no bank conflicts.  Each thread holds 4
//    rows x BN / 16 keys of S = Q.K^T and 4 rows x DHP / 16 columns of O,
//    and computes both as SGEMM-style outer products of 16-byte words
//    (each K or V word serves 4 rows, each Q word BN / 16 keys and each P
//    word DHP / 16 columns); no shuffle per score.  The online softmax
//    (exp2 of log2e-scaled scores) stays in registers; a row's maximum
//    reduces over the 16 threads that share it; P goes to shared memory
//    (transposed) for the P.V products, the rescale staying in the threads
//    that own the rows.  Key tiles are skipped by position with the wgmma
//    path's rule (live tiles first, dead tiles only for a block holding a
//    row without a live key, "full" tiles unmasked); a masked key of a row
//    that already holds a live score weighs 0 without an exp.
//
// Plain C interface for ctypes; each launch function returns
// cudaGetLastError() so that a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int DH_MAX = 256;
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool live_key(int kp, int qp, int causal,
                                         int window) {
  bool live = true;
  if (causal) live = kp <= qp;
  if (window > 0) live = live && kp > qp - window;
  return live;
}

// ---------------------------------------------------------------------------
// split: flash-decoding for rows = Q * g <= 8
// ---------------------------------------------------------------------------

constexpr int SPLIT_WARPS = 4;
constexpr int SPLIT_THREADS = SPLIT_WARPS * 32;
constexpr int MAX_SPLITS = 256;
constexpr int MERGE_THREADS = 128;
constexpr int MERGE_BATCH = 16;  // splits whose partials are loaded together

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Elements d0 .. d0 + 7 of a row as loaded (zero past dh): one 16-byte word
// in bf16, two in float32.  A step issues the loads of all its keys before
// it converts any, so that they are in flight together.  ``vec``: dh is a
// multiple of 8 and the tensors are 16-byte aligned.
struct Raw8 {
  uint4 a, b;
};

__device__ __forceinline__ Raw8 raw8(const bf16* row, int d0, int dh,
                                     bool vec) {
  Raw8 r;
  r.a = r.b = make_uint4(0u, 0u, 0u, 0u);
  if (d0 >= dh) return r;
  if (vec) {
    r.a = *reinterpret_cast<const uint4*>(row + d0);
    return r;
  }
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = d0 + 2 * i;
    const uint32_t lo = d < dh ? __bfloat16_as_ushort(row[d]) : 0u;
    const uint32_t hi = d + 1 < dh ? __bfloat16_as_ushort(row[d + 1]) : 0u;
    w[i] = lo | (hi << 16);
  }
  r.a = make_uint4(w[0], w[1], w[2], w[3]);
  return r;
}

__device__ __forceinline__ Raw8 raw8(const float* row, int d0, int dh,
                                     bool vec) {
  Raw8 r;
  r.a = r.b = make_uint4(0u, 0u, 0u, 0u);
  if (d0 >= dh) return r;
  if (vec) {
    r.a = *reinterpret_cast<const uint4*>(row + d0);
    r.b = *reinterpret_cast<const uint4*>(row + d0 + 4);
    return r;
  }
  uint32_t w[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    w[e] = d0 + e < dh ? __float_as_uint(row[d0 + e]) : 0u;
  }
  r.a = make_uint4(w[0], w[1], w[2], w[3]);
  r.b = make_uint4(w[4], w[5], w[6], w[7]);
  return r;
}

// The vector load alone: no branch, so a step's loads issue back to back.
__device__ __forceinline__ Raw8 raw8_vec(const bf16* p) {
  Raw8 r;
  r.a = *reinterpret_cast<const uint4*>(p);
  r.b = make_uint4(0u, 0u, 0u, 0u);
  return r;
}

__device__ __forceinline__ Raw8 raw8_vec(const float* p) {
  Raw8 r;
  r.a = *reinterpret_cast<const uint4*>(p);
  r.b = *reinterpret_cast<const uint4*>(p + 4);
  return r;
}

template <typename T>
__device__ __forceinline__ void unpack8(const Raw8& r, float (&x)[8]);

template <>
__device__ __forceinline__ void unpack8<bf16>(const Raw8& r, float (&x)[8]) {
  const uint32_t w[4] = {r.a.x, r.a.y, r.a.z, r.a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void unpack8<float>(const Raw8& r, float (&x)[8]) {
  const uint32_t w[8] = {r.a.x, r.a.y, r.a.z, r.a.w,
                         r.b.x, r.b.y, r.b.z, r.b.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = __uint_as_float(w[e]);
}

// Two online-softmax states of one row (m in log2 units) merged into the
// first.
template <int N>
__device__ __forceinline__ void merge_state(float& m, float& l,
                                            float (&acc)[N], float m_o,
                                            float l_o,
                                            const float (&acc_o)[N]) {
  const float M = fmaxf(m, m_o);
  if (M == -INFINITY) return;  // neither saw a key
  const float c = exp2f(m - M);
  const float c_o = exp2f(m_o - M);
  l = l * c + l_o * c_o;
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = acc[e] * c + acc_o[e] * c_o;
  m = M;
}

template <typename T, int R>
__global__ void __launch_bounds__(SPLIT_THREADS)
flash_attention_split_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const int32_t* __restrict__ q_pos,
                             const int32_t* __restrict__ k_pos,
                             float* __restrict__ ws_acc,
                             float* __restrict__ ws_m,
                             float* __restrict__ ws_l, int Q, int H, int K,
                             int KV, int dh, int causal, int window,
                             float softcap, float scale, int split,
                             int lanes_log2) {
  constexpr int U = R <= 2 ? 8 : 4;  // key steps whose loads fly together
  __shared__ float sm_m[SPLIT_WARPS][R];
  __shared__ float sm_l[SPLIT_WARPS][R];
  __shared__ float sm_acc[SPLIT_WARPS][R][DH_MAX];

  const int s = blockIdx.x;
  const int n_splits = gridDim.x;
  const int bk = blockIdx.y;  // b * KV + kv head
  const int b = bk / KV;
  const int kvh = bk - b * KV;
  const int g = H / KV;
  const int rows = Q * g;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int L = 1 << lanes_log2;       // lanes per key row
  const int kpw = 32 >> lanes_log2;    // keys per warp step
  const int sub = lane >> lanes_log2;  // this lane's key in the step
  const int d0 = (lane & (L - 1)) * 8;
  const bool vec = (dh & 7) == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v);

  float qv[R][8];
  int qp[R];
  {
    // Rows past Q * g load a clamped row and are zeroed after every load
    // is issued (their results are never written).
    Raw8 qr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int rc = min(r, rows - 1);
      const int qi = rc / g;
      const int hg = rc - qi * g;
      const T* row =
          q + ((static_cast<size_t>(b) * Q + qi) * H + kvh * g + hg) * dh;
      qr[r] = vec ? raw8_vec(row + (d0 < dh ? d0 : 0)) : raw8(row, d0, dh, false);
      qp[r] = q_pos[qi];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      unpack8<T>(qr[r], qv[r]);
      const bool zero = r >= rows || d0 >= dh;  // padding rows and columns
#pragma unroll
      for (int e = 0; e < 8; ++e) qv[r][e] = zero ? 0.0f : qv[r][e] * scale;
    }
  }

  float m[R], l[R], acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.0f;
  }

  const int j_end = min(K, (s + 1) * split);
  const int step = SPLIT_WARPS * kpw;  // keys per block step
  // The loop bound is the same for the whole warp (shuffles inside).
  for (int jw = s * split + warp * kpw; jw < j_end; jw += step * U) {
    float kx[U][8], vx[U][8];
    int kp[U];
    bool in[U];
    {
      // Every lane loads, from a clamped key and column, so that no load
      // sits in a branch whose result a select would wait for: keys past
      // the split score -inf below, and columns past dh meet zeros in q
      // and are never written.
      Raw8 kr[U], vr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = jw + u * step + sub;
        in[u] = j < j_end;
        const int jc = min(j, j_end - 1);
        const size_t off =
            ((static_cast<size_t>(b) * K + jc) * KV + kvh) * dh;
        if (vec) {
          const int dc = d0 < dh ? d0 : 0;
          kr[u] = raw8_vec(k + off + dc);
          vr[u] = raw8_vec(v + off + dc);
        } else {
          kr[u] = raw8(k + off, d0, dh, false);
          vr[u] = raw8(v + off, d0, dh, false);
        }
        kp[u] = k_pos[jc];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        unpack8<T>(kr[u], kx[u]);
        unpack8<T>(vr[u], vx[u]);
      }
    }
    // Scores: lane partials, then the L-lane sums in rounds over all of
    // the step's (key, row) pairs at once, so the shuffles overlap.
    float sc[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float part = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) part = fmaf(qv[r][e], kx[u][e], part);
        sc[u][r] = part;
      }
    }
    for (int off = L >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          sc[u][r] += __shfl_xor_sync(FULL, sc[u][r], off);
        }
      }
    }
    // Softcap, mask, and log2 units (exp2 below; all rows' masked scores
    // stay equal, so a fully masked row still averages uniformly).
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float x = sc[u][r];
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        if (!live_key(kp[u], qp[r], causal, window)) x = MASKED;
        sc[u][r] = in[u] ? x * LOG2E : -INFINITY;  // past the split: 0
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[u][r]);
      if (mx == -INFINITY) continue;  // no key yet
      const float alpha = exp2f(m[r] - mx);  // 0 while m is -inf
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = exp2f(sc[u][r] - mx);
        l[r] += p;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(p, vx[u][e], acc[r][e]);
      }
      m[r] = mx;
    }
  }

  // Merge the warp's key groups (lanes d0-equal, sub different).
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float acc_o[8];
      const float m_o = __shfl_xor_sync(FULL, m[r], off);
      const float l_o = __shfl_xor_sync(FULL, l[r], off);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        acc_o[e] = __shfl_xor_sync(FULL, acc[r][e], off);
      }
      merge_state<8>(m[r], l[r], acc[r], m_o, l_o, acc_o);
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (d0 == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (d0 + e < dh) sm_acc[warp][r][d0 + e] = acc[r][e];
      }
    }
  }
  __syncthreads();

  // Merge the warps; write this split's partial (m, l, acc) per row.
  const int rr = min(R, rows);
  for (int i = threadIdx.x; i < rr * dh; i += SPLIT_THREADS) {
    const int r = i / dh;
    const int d = i - r * dh;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < SPLIT_WARPS; ++w) M = fmaxf(M, sm_m[w][r]);
    float o = 0.0f, lsum = 0.0f;
#pragma unroll
    for (int w = 0; w < SPLIT_WARPS; ++w) {
      const float mw = sm_m[w][r];
      const float c = mw == -INFINITY ? 0.0f : exp2f(mw - M);
      o = fmaf(sm_acc[w][r][d], c, o);
      lsum = fmaf(sm_l[w][r], c, lsum);
    }
    const size_t row = (static_cast<size_t>(bk) * n_splits + s) * rows + r;
    ws_acc[row * dh + d] = o;
    if (d == 0) {
      ws_m[row] = M;
      ws_l[row] = lsum;
    }
  }
}

// One block per output row (b, query, head): the splits' partials merged.
template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
flash_attention_merge_kernel(const float* __restrict__ ws_acc,
                             const float* __restrict__ ws_m,
                             const float* __restrict__ ws_l,
                             T* __restrict__ out, int Q, int H, int KV,
                             int dh, int n_splits) {
  __shared__ float cs[MAX_SPLITS];
  __shared__ float inv_l;
  const int g = H / KV;
  const int rows = Q * g;
  const int bk = blockIdx.x / rows;
  const int r = blockIdx.x - bk * rows;
  const size_t row0 = static_cast<size_t>(bk) * n_splits * rows + r;
  if (threadIdx.x < 32) {
    // Loads from clamped splits, all issued before any is used.
    float ms[MAX_SPLITS / 32], ls[MAX_SPLITS / 32];
#pragma unroll
    for (int i = 0; i < MAX_SPLITS / 32; ++i) {
      const int s = min(threadIdx.x + 32 * i, n_splits - 1);
      const size_t at = row0 + static_cast<size_t>(s) * rows;
      ms[i] = ws_m[at];
      ls[i] = ws_l[at];
    }
#pragma unroll
    for (int i = 0; i < MAX_SPLITS / 32; ++i) {
      if (threadIdx.x + 32 * i >= n_splits) {
        ms[i] = -INFINITY;
        ls[i] = 0.0f;
      }
    }
    float M = -INFINITY;
#pragma unroll
    for (int i = 0; i < MAX_SPLITS / 32; ++i) M = fmaxf(M, ms[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      M = fmaxf(M, __shfl_xor_sync(FULL, M, off));
    }
    float lsum = 0.0f;
#pragma unroll
    for (int i = 0; i < MAX_SPLITS / 32; ++i) {
      // A split that saw no key holds m = -inf, l = 0, acc = 0.
      const float c = ms[i] == -INFINITY ? 0.0f : exp2f(ms[i] - M);
      cs[threadIdx.x + 32 * i] = c;  // 0 past n_splits
      lsum = fmaf(ls[i], c, lsum);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lsum += __shfl_xor_sync(FULL, lsum, off);
    }
    if (threadIdx.x == 0) inv_l = 1.0f / fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  const int b = bk / KV;
  const int kvh = bk - b * KV;
  const int qi = r / g;
  const int h = kvh * g + (r - qi * g);
  T* orow = out + ((static_cast<size_t>(b) * Q + qi) * H + h) * dh;
  for (int d = threadIdx.x; d < dh; d += MERGE_THREADS) {
    float o = 0.0f;
    for (int s0 = 0; s0 < n_splits; s0 += MERGE_BATCH) {
      float a[MERGE_BATCH];
#pragma unroll
      for (int u = 0; u < MERGE_BATCH; ++u) {
        const int s = min(s0 + u, n_splits - 1);  // weighs cs = 0 past n
        a[u] = ws_acc[(row0 + static_cast<size_t>(s) * rows) * dh + d];
      }
#pragma unroll
      for (int u = 0; u < MERGE_BATCH; ++u) {
        if (s0 + u < MAX_SPLITS) o = fmaf(a[u], cs[s0 + u], o);
      }
    }
    orow[d] = from_f<T>(o * inv_l);
  }
}

// ---------------------------------------------------------------------------
// wgmma: bf16 warpgroup tiles for rows = Q * g > 8
// ---------------------------------------------------------------------------

constexpr int BM = 64;            // packed query rows per block
constexpr int GROUP_THREADS = 128;  // a warpgroup: 4 warps of 16 rows
constexpr int MAXT = 1024;        // key tiles with liveness bits; later ones
                                  // are walked as live and masked

__host__ __device__ constexpr int key_tile(int dhp) {
  return dhp == 256 ? 32 : 64;
}

// Key groups, one warpgroup each, walking alternate key tiles: three where
// registers (up to 168 a thread) and shared memory allow, else two.
__host__ __device__ constexpr int key_groups(int dhp) {
  return dhp == 256 ? 2 : 3;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !full (src unread).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  const int n = full ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The barrier of one key group's 128 threads (ids 1 and 2; 0 is
// __syncthreads).
__device__ __forceinline__ void group_sync(int kg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + kg), "n"(GROUP_THREADS)
               : "memory");
}

// (x0, x1) as bf16 hi parts and the bf16 remainders x - hi.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// The first tile after t whose liveness bit equals ``want`` (tiles from
// MAXT on count as live), or n_tiles.
__device__ __forceinline__ int next_tile(const unsigned* live, int t,
                                         int n_tiles, bool want) {
  int u = t + 1;
  while (u < n_tiles) {
    if (u >= MAXT) return want ? u : n_tiles;
    unsigned w = live[u >> 5];
    if (!want) w = ~w;
    w &= FULL << (u & 31);
    if (w) {
      const int c = (u & ~31) + __ffs(w) - 1;
      return c < n_tiles ? c : n_tiles;
    }
    u = (u & ~31) + 32;
  }
  return n_tiles;
}

// 2^x on the special-function unit (flushes results below 2^-126 to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Orders this thread's shared writes (cp.async) before the tensor cores'
// reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 32) (+)= A (64 x 16, shared, K-major) . B (32 x 16, shared,
// K-major); ``accumulate`` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4],
                                             uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) (+)= A (64 x 16, shared, K-major) . B (64 x 16, shared,
// K-major); ``accumulate`` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4],
                                             uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16 in registers: each warp's 16 rows as for
// mma.sync) . B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += A (64 x 16 in registers: each warp's 16 rows as for
// mma.sync) . B (16 x 128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256) += A (64 x 16 in registers: each warp's 16 rows as for
// mma.sync) . B (16 x 256, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[32][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// A tile of R rows x DHP bf16 columns in shared memory, 128-byte swizzled
// as wgmma reads it: DHP / 64 panels of R rows x 128 bytes, 16-byte chunk
// c of row r at ((c ^ (r % 8)) * 16) within its row.  Byte offset of
// chunk ``ch`` (8 columns) of row ``r``.
__device__ __forceinline__ uint32_t swz(int r, int ch, int R) {
  return (ch >> 3) * R * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

// A shared-memory matrix descriptor with 128-byte swizzling.
__device__ __forceinline__ uint64_t gdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The block's query positions (Qp[r] for its BM packed rows, 0 past
// Q * g) and their range over its valid rows, in every warp.
__device__ __forceinline__ void block_positions(const int32_t* q_pos,
                                                int* Qp, int r0, int rows,
                                                int g, int tid, int& qmin,
                                                int& qmax) {
  const int lane = tid & 31;
  qmin = INT_MAX;
  qmax = INT_MIN;
  for (int r = lane; r < BM; r += 32) {
    const int R = r0 + r;
    const int p = R < rows ? q_pos[R / g] : 0;
    if (tid < 32) Qp[r] = p;
    if (R < rows) {
      qmin = min(qmin, p);
      qmax = max(qmax, p);
    }
  }
  qmin = __reduce_min_sync(FULL, qmin);
  qmax = __reduce_max_sync(FULL, qmax);
}

// Tile liveness from each tile's (min, max) k_pos: ``live`` unless every
// key follows every query (causal) or precedes every window; ``full`` when
// no key of the tile is masked for any row of the block (and none lies
// past K).  Bits of the first MAXT tiles of BN keys; ``pos_vec``: k_pos is
// 16-byte aligned.  All ``nth`` threads of the block take part.
template <int BN>
__device__ __forceinline__ void mark_tiles(const int32_t* __restrict__ k_pos,
                                           int K, int n_tiles, int qmin,
                                           int qmax, int causal, int window,
                                           bool pos_vec, unsigned* live,
                                           unsigned* full, int tid, int nth) {
  const int lane = tid & 31;
  const int n_bits = min(n_tiles, MAXT);
  for (int t0 = 0; t0 < n_bits; t0 += nth) {
    const int tt = t0 + tid;
    bool lv = false, fl = false;
    if (tt < n_bits) {
      int kmin = INT_MAX, kmax = INT_MIN;
      const int j0 = tt * BN;
      if (pos_vec && j0 + BN <= K) {
        const int4* p4 = reinterpret_cast<const int4*>(k_pos + j0);
#pragma unroll
        for (int e = 0; e < BN / 4; ++e) {
          const int4 x = p4[e];
          kmin = min(kmin, min(min(x.x, x.y), min(x.z, x.w)));
          kmax = max(kmax, max(max(x.x, x.y), max(x.z, x.w)));
        }
      } else {
        for (int j = j0; j < min(K, j0 + BN); ++j) {
          kmin = min(kmin, k_pos[j]);
          kmax = max(kmax, k_pos[j]);
        }
      }
      const long long lo = kmin, hi = kmax;
      const bool dead =
          (causal && lo > qmax) ||
          (window > 0 && hi <= static_cast<long long>(qmin) - window);
      lv = !dead;
      fl = j0 + BN <= K && (!causal || hi <= qmin) &&
           (window <= 0 || lo > static_cast<long long>(qmax) - window);
    }
    const unsigned wl = __ballot_sync(FULL, lv);
    const unsigned wf = __ballot_sync(FULL, fl);
    const int word = (t0 >> 5) + (tid >> 5);
    if (lane == 0 && word < MAXT / 32) {
      live[word] = wl;
      full[word] = wf;
    }
  }
}

// Q tile, the key groups' double-buffered K/V rings and their positions,
// the two liveness bitmasks, the rows' positions and per-group row maxima,
// and 1 KB of slack to align the tiles to 1 KB.
__host__ __device__ constexpr size_t wgmma_smem_bytes(int dhp) {
  return 1024 +
         (static_cast<size_t>(BM) + key_groups(dhp) * 4 * key_tile(dhp)) *
             dhp * 2 +
         key_groups(dhp) * 2 * key_tile(dhp) * 4 + 2 * (MAXT / 32) * 4 +
         BM * 4 + key_groups(dhp) * BM * 4;
}

template <int DHP, int BN>
__device__ __forceinline__ void load_kv_tile_sw(
    const bf16* __restrict__ kh, const bf16* __restrict__ vh,
    const int32_t* __restrict__ k_pos, bf16* Ks, bf16* Vs, int* Kp, int j0,
    int K, size_t stride, int dh, int t) {
  constexpr int CH = DHP / 8;  // 16-byte chunks per row
  unsigned char* ks = reinterpret_cast<unsigned char*>(Ks);
  unsigned char* vs = reinterpret_cast<unsigned char*>(Vs);
#pragma unroll
  for (int i = 0; i < BN * CH / GROUP_THREADS; ++i) {
    const int c = t + i * GROUP_THREADS;
    const int kk = c / CH;
    const int ch = c - kk * CH;
    const bool ok = j0 + kk < K && ch * 8 < dh;
    const size_t off = ok ? (j0 + kk) * stride + ch * 8 : 0;
    const uint32_t o = swz(kk, ch, BN);
    cp_async16(smem_u32(ks + o), kh + off, ok);
    cp_async16(smem_u32(vs + o), vh + off, ok);
  }
  if (t < BN) {
    const int j = j0 + t;
    cp_async4(smem_u32(Kp + t), k_pos + (j < K ? j : 0), j < K);
  }
}

template <int DHP>
__global__ void __launch_bounds__(key_groups(DHP) * GROUP_THREADS)
flash_attention_wgmma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const int32_t* __restrict__ q_pos,
                             const int32_t* __restrict__ k_pos,
                             bf16* __restrict__ out, int Q, int H, int K,
                             int KV, int dh, int causal, int window,
                             float softcap, float scale) {
  constexpr int BN = key_tile(DHP);
  constexpr int KG = key_groups(DHP);
  constexpr int NTH = KG * GROUP_THREADS;
  constexpr int NT = BN / 8;    // score n-tiles per warp
  constexpr int DT = DHP / 8;   // output n-tiles per warp
  constexpr int CH = DHP / 8;
  constexpr int TILE = BN * DHP;     // elements of one K or V tile
  constexpr int RING = 4 * TILE;     // one group's K and V slots
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KVs = Qs + BM * DHP;                            // [KG][RING]
  int* Kp = reinterpret_cast<int*>(KVs + KG * RING);    // [KG][2][BN]
  unsigned* live = reinterpret_cast<unsigned*>(Kp + KG * 2 * BN);
  unsigned* full = live + MAXT / 32;                    // [MAXT / 32] each
  int* Qp = reinterpret_cast<int*>(full + MAXT / 32);  // [BM]
  float* Mx = reinterpret_cast<float*>(Qp + BM);        // [KG][BM]

  const int tid = threadIdx.x;
  const int kg = tid / GROUP_THREADS;  // key group: one warpgroup
  const int t = tid - kg * GROUP_THREADS;
  const int warp = t >> 5;             // rows warp*16 .. +15
  const int lane = tid & 31;
  const int g = H / KV;
  const int rows = Q * g;
  const int r0 = blockIdx.x * BM;
  const int bk = blockIdx.y;
  const int b = bk / KV;
  const int kvh = bk - b * KV;
  const int n_tiles = (K + BN - 1) / BN;
  bf16* Ks = KVs + kg * RING;  // [2][TILE]
  bf16* Vs = Ks + 2 * TILE;
  int* kpos = Kp + kg * 2 * BN;
  const size_t stride = static_cast<size_t>(KV) * dh;  // key to key
  const bf16* kh = k + (static_cast<size_t>(b) * K * KV + kvh) * dh;
  const bf16* vh = v + (static_cast<size_t>(b) * K * KV + kvh) * dh;
  // Descriptor strides.  Q and K are K-major: 8-row groups 1 KB apart
  // (SBO; LBO is unused inside a 128-byte swizzle atom).  V is MN-major:
  // its 64-column panels BN * 128 bytes apart (LBO), 8-key groups 1 KB
  // apart (SBO).
  constexpr uint32_t k_lbo = 16, k_sbo = 1024;
  constexpr uint32_t v_lbo = BN * 128, v_sbo = 1024;

  // 1. The query tile (zero rows past Q * g, zero columns past dh).
  for (int c = tid; c < BM * CH; c += NTH) {
    const int r = c / CH;
    const int ch = c - r * CH;
    const int R = r0 + r;
    const bool ok = R < rows && ch * 8 < dh;
    const bf16* src = q;
    if (ok) {
      const int qi = R / g;
      src = q +
            ((static_cast<size_t>(b) * Q + qi) * H + kvh * g + (R - qi * g)) *
                dh +
            ch * 8;
    }
    cp_async16(smem_u32(smem + swz(r, ch, BM)), src, ok);
  }
  cp_async_commit();

  // 2. The block's query positions and their range; 3. the key tiles'
  // liveness and "full" bits.
  int qmin, qmax;
  block_positions(q_pos, Qp, r0, rows, g, tid, qmin, qmax);
  mark_tiles<BN>(k_pos, K, n_tiles, qmin, qmax, causal, window, true, live,
                 full, tid, NTH);
  cp_async_wait<0>();  // the query tile, loaded by both groups
  fence_proxy_async();
  __syncthreads();

  // Each thread holds rows rA and rB = rA + 8 of its warp's 16.
  const int rA = warp * 16 + (lane >> 2);
  const int rB = rA + 8;
  const int qpA = Qp[rA], qpB = Qp[rB];
  const bool validA = r0 + rA < rows, validB = r0 + rB < rows;
  const float sl2 = scale * LOG2E;
  const float masked2 = MASKED * LOG2E;
  const uint32_t q_addr = smem_u32(Qs);

  float O[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) O[i][0] = O[i][1] = O[i][2] = O[i][3] = 0.0f;
  float mA = -INFINITY, mB = -INFINITY, lA = 0.0f, lB = 0.0f;

  // Pass 0 walks the live tiles; pass 1 the dead ones, only when a row has
  // no live key (it must average v over all K keys).  Key group kg takes
  // every other tile of the walk, on its own ring and barrier.
  for (int pass = 0; pass < 2; ++pass) {
    const bool want = pass == 0;
    if (pass == 1) {
      if ((lane & 3) == 0) {
        Mx[kg * BM + rA] = mA;
        Mx[kg * BM + rB] = mB;
      }
      __syncthreads();
      float xA = -INFINITY, xB = -INFINITY;
#pragma unroll
      for (int i = 0; i < KG; ++i) {
        xA = fmaxf(xA, Mx[i * BM + rA]);
        xB = fmaxf(xB, Mx[i * BM + rB]);
      }
      const bool need = (validA && xA <= masked2) || (validB && xB <= masked2);
      if (!__syncthreads_or(need)) break;
    }
    int cur = next_tile(live, -1, n_tiles, want);
    for (int i = 0; i < kg; ++i) cur = next_tile(live, cur, n_tiles, want);
    int buf = 0;
    if (cur < n_tiles) {
      load_kv_tile_sw<DHP, BN>(kh, vh, k_pos, Ks, Vs, kpos, cur * BN, K,
                               stride, dh, t);
    }
    cp_async_commit();
    while (cur < n_tiles) {
      int nxt = cur;
#pragma unroll
      for (int i = 0; i < KG; ++i) nxt = next_tile(live, nxt, n_tiles, want);
      if (nxt < n_tiles) {
        load_kv_tile_sw<DHP, BN>(kh, vh, k_pos, Ks + (buf ^ 1) * TILE,
                                 Vs + (buf ^ 1) * TILE, kpos + (buf ^ 1) * BN,
                                 nxt * BN, K, stride, dh, t);
      }
      cp_async_commit();
      cp_async_wait<1>();  // tile ``cur`` has landed
      fence_proxy_async();
      group_sync(kg);

      const uint32_t k_addr = smem_u32(Ks + buf * TILE);
      const uint32_t v_addr = smem_u32(Vs + buf * TILE);
      const int* kp = kpos + buf * BN;
      const bool tile_full =
          cur < MAXT && ((full[cur >> 5] >> (cur & 31)) & 1u);

      // S = Q . K^T for the warpgroup's 64 rows and the tile's BN keys:
      // k-step kst reads 32 bytes at (kst % 4) * 32 of panel kst / 4.
      float S[NT][4];
      wgmma_fence();
#pragma unroll
      for (int kst = 0; kst < DHP / 16; ++kst) {
        const uint32_t at = (kst & 3) << 5;
        const uint64_t da =
            gdesc(q_addr + (kst >> 2) * BM * 128 + at, k_lbo, k_sbo);
        const uint64_t db =
            gdesc(k_addr + (kst >> 2) * BN * 128 + at, k_lbo, k_sbo);
        if constexpr (BN == 64) {
          wgmma_ss_n64(S, da, db, kst > 0);
        } else {
          wgmma_ss_n32(S, da, db, kst > 0);
        }
      }
      wgmma_commit_wait();

      // Scale, softcap, mask (log2 domain); the tile's row maxima.
      float mxA = -INFINITY, mxB = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x;
          if (softcap > 0.0f) {
            x = softcap * tanhf(S[nt][e] * scale / softcap) * LOG2E;
          } else {
            x = S[nt][e] * sl2;
          }
          if (!tile_full) {
            const int key = nt * 8 + (lane & 3) * 2 + (e & 1);
            const int qp = e < 2 ? qpA : qpB;
            if (!live_key(kp[key], qp, causal, window)) x = masked2;
            if (cur * BN + key >= K) x = -INFINITY;  // keys past K weigh 0
          }
          S[nt][e] = x;
          if (e < 2) {
            mxA = fmaxf(mxA, x);
          } else {
            mxB = fmaxf(mxB, x);
          }
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mxA = fmaxf(mxA, __shfl_xor_sync(FULL, mxA, off));
        mxB = fmaxf(mxB, __shfl_xor_sync(FULL, mxB, off));
      }
      // The tile holds a key below K, so each maximum is finite.
      const float mnA = fmaxf(mA, mxA), mnB = fmaxf(mB, mxB);
      // The accumulators are rescaled only when a row's maximum grew
      // somewhere in the warp (once the maxima settle, seldom).
      if (__any_sync(FULL, mnA != mA || mnB != mB)) {
        const float alphaA = ex2(mA - mnA), alphaB = ex2(mB - mnB);
        lA *= alphaA;
        lB *= alphaB;
#pragma unroll
        for (int i = 0; i < DT; ++i) {
          O[i][0] *= alphaA;
          O[i][1] *= alphaA;
          O[i][2] *= alphaB;
          O[i][3] *= alphaB;
        }
      }
      mA = mnA;
      mB = mnB;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        S[nt][0] = ex2(S[nt][0] - mA);
        S[nt][1] = ex2(S[nt][1] - mA);
        S[nt][2] = ex2(S[nt][2] - mB);
        S[nt][3] = ex2(S[nt][3] - mB);
        lA += S[nt][0] + S[nt][1];
        lB += S[nt][2] + S[nt][3];
      }


      // O += P . V, P as bf16 hi + lo parts: k-step kk reads keys
      // 16 kk .. 16 kk + 15, two 8-row groups at 1 KB each.
      uint32_t ph[BN / 16][4], pl[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        split_bf16(S[2 * kk][0], S[2 * kk][1], ph[kk][0], pl[kk][0]);
        split_bf16(S[2 * kk][2], S[2 * kk][3], ph[kk][1], pl[kk][1]);
        split_bf16(S[2 * kk + 1][0], S[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
        split_bf16(S[2 * kk + 1][2], S[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t dv = gdesc(v_addr + kk * 2048, v_lbo, v_sbo);
        if constexpr (DHP == 256) {
          wgmma_rs_n256(O, ph[kk], dv);
          wgmma_rs_n256(O, pl[kk], dv);
        } else if constexpr (DHP == 128) {
          wgmma_rs_n128(O, ph[kk], dv);
          wgmma_rs_n128(O, pl[kk], dv);
        } else {
          wgmma_rs_n64(O, ph[kk], dv);
          wgmma_rs_n64(O, pl[kk], dv);
        }
      }
      wgmma_commit_wait();
      group_sync(kg);  // this slot's readers are done before it refills
      cur = nxt;
      buf ^= 1;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is idle: it holds the groups' exchange

  // Key groups 1 .. KG - 1 hand their (m, l, O) to group 0, which merges
  // them and writes.
  constexpr int EX = (DT * 4 + 4) * GROUP_THREADS;  // floats per group
  if (kg > 0) {
    float* ex = reinterpret_cast<float*>(KVs) + (kg - 1) * EX;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ex[(i * 4 + e) * GROUP_THREADS + t] = O[i][e];
    }
    float* exs = ex + DT * 4 * GROUP_THREADS;
    exs[t] = mA;
    exs[GROUP_THREADS + t] = mB;
    exs[2 * GROUP_THREADS + t] = lA;
    exs[3 * GROUP_THREADS + t] = lB;
  }
  __syncthreads();
  if (kg > 0) return;
  for (int o = 0; o < KG - 1; ++o) {
    const float* eo = reinterpret_cast<const float*>(KVs) + o * EX;
    const float* es = eo + DT * 4 * GROUP_THREADS;
    const float m1A = es[t], m1B = es[GROUP_THREADS + t];
    const float MA = fmaxf(mA, m1A), MB = fmaxf(mB, m1B);
    const float cA0 = MA == -INFINITY ? 0.0f : exp2f(mA - MA);
    const float cA1 = MA == -INFINITY ? 0.0f : exp2f(m1A - MA);
    const float cB0 = MB == -INFINITY ? 0.0f : exp2f(mB - MB);
    const float cB1 = MB == -INFINITY ? 0.0f : exp2f(m1B - MB);
    lA = lA * cA0 + es[2 * GROUP_THREADS + t] * cA1;
    lB = lB * cB0 + es[3 * GROUP_THREADS + t] * cB1;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      O[i][0] = O[i][0] * cA0 + eo[(i * 4 + 0) * GROUP_THREADS + t] * cA1;
      O[i][1] = O[i][1] * cA0 + eo[(i * 4 + 1) * GROUP_THREADS + t] * cA1;
      O[i][2] = O[i][2] * cB0 + eo[(i * 4 + 2) * GROUP_THREADS + t] * cB1;
      O[i][3] = O[i][3] * cB0 + eo[(i * 4 + 3) * GROUP_THREADS + t] * cB1;
    }
    mA = MA;
    mB = MB;
  }

  // Row sums over the quad, then out = O / l.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    lA += __shfl_xor_sync(FULL, lA, off);
    lB += __shfl_xor_sync(FULL, lB, off);
  }
  const float invA = 1.0f / fmaxf(lA, 1e-30f);
  const float invB = 1.0f / fmaxf(lB, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int R = r0 + (half ? rB : rA);
    if (R >= rows) continue;
    const int qi = R / g;
    bf16* orow =
        out +
        ((static_cast<size_t>(b) * Q + qi) * H + kvh * g + (R - qi * g)) * dh;
    const float inv = half ? invB : invA;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const int d = i * 8 + (lane & 3) * 2;
      if (d < dh) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            O[i][2 * half] * inv, O[i][2 * half + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// simt: register-tiled CUDA-core tiles (float32 above the split path's rows,
// and the bf16 calls the wgmma path refuses)
// ---------------------------------------------------------------------------

constexpr int RPT = 4;  // packed rows per thread: one 16-byte word of P^T
constexpr int SIMT_THREADS = BM / RPT * 16;  // row groups x 16 key groups
constexpr int P_LD = BM + 4;  // row stride (floats) of the P^T tile

// Keys per tile: 64, or 32 where dh pads to 128 or 256 (shared memory).
__host__ __device__ constexpr int simt_key_tile(int dhp) {
  return dhp == 64 ? 64 : 32;
}

// Row stride (floats) of the Q, K and V tiles.  The 4 floats of padding put
// the 16-byte word (key j, columns d .. d + 3) in bank quad (j + d / 4) % 8,
// so the 16 keys one warp reads at a column fill two wavefronts.
__host__ __device__ constexpr int simt_ld(int dhp) { return dhp + 4; }

// Q, the double-buffered K and V tiles, P^T, the two key-position slots,
// the two liveness bitmasks and the rows' positions.
__host__ __device__ constexpr size_t simt_smem_bytes(int dhp) {
  return (static_cast<size_t>(BM) + 4 * simt_key_tile(dhp)) * simt_ld(dhp) *
             4 +
         static_cast<size_t>(simt_key_tile(dhp)) * P_LD * 4 +
         2 * simt_key_tile(dhp) * 4 + 2 * (MAXT / 32) * 4 + BM * 4;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four elements d .. d + 3 of a row into shared memory as float32, zero
// where !ok or past dh: one 16-byte cp.async when ``vec`` (float32, dh % 4
// == 0, 16-byte aligned rows), else converting loads.
template <typename T>
__device__ __forceinline__ void stage4(float* dst, const T* src, bool ok,
                                       int left, bool vec) {
  if (sizeof(T) == 4 && vec) {
    cp_async16(smem_u32(dst), src, ok);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = ok && e < left ? to_f(src[e]) : 0.0f;
}

// Keys j0 .. j0 + BN - 1 of one kv head's k and v (zero past K and past
// dh) and their positions.
template <typename T, int DHP, int BN>
__device__ __forceinline__ void stage_kv(const T* __restrict__ kh,
                                         const T* __restrict__ vh,
                                         const int32_t* __restrict__ k_pos,
                                         float* Kt, float* Vt, int* kp,
                                         int j0, int K, size_t stride, int dh,
                                         bool vec, int tid) {
  constexpr int W = DHP / 4;  // 16-byte words per row
  constexpr int LD = simt_ld(DHP);
#pragma unroll
  for (int i = 0; i < BN * W / SIMT_THREADS; ++i) {
    const int c = tid + i * SIMT_THREADS;
    const int kk = c / W;
    const int d = (c - kk * W) * 4;
    const bool ok = j0 + kk < K && d < dh;
    const size_t off = ok ? (j0 + kk) * stride + d : 0;
    stage4(Kt + kk * LD + d, kh + off, ok, dh - d, vec);
    stage4(Vt + kk * LD + d, vh + off, ok, dh - d, vec);
  }
  if (tid < BN) {
    const int j = j0 + tid;
    cp_async4(smem_u32(kp + tid), k_pos + (j < K ? j : 0), j < K);
  }
}

template <typename T, int DHP>
__global__ void __launch_bounds__(SIMT_THREADS, DHP == 256 ? 1 : 2)
flash_attention_simt_kernel(const T* __restrict__ q,
                            const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int32_t* __restrict__ q_pos,
                            const int32_t* __restrict__ k_pos,
                            T* __restrict__ out, int Q, int H, int K, int KV,
                            int dh, int causal, int window, float softcap,
                            float scale, int vec, int vec_out) {
  constexpr int BN = simt_key_tile(DHP);
  constexpr int KPT = BN / 16;   // keys per thread: tc + 16 u
  constexpr int CW = DHP / 64;   // output words per thread: 64 c + 4 tc
  constexpr int LD = simt_ld(DHP);
  constexpr int TILE = BN * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);      // [BM][LD]
  float* Ks = Qs + BM * LD;                            // [2][BN][LD]
  float* Vs = Ks + 2 * TILE;                           // [2][BN][LD]
  float* Ps = Vs + 2 * TILE;                           // [BN][P_LD]
  int* Kp = reinterpret_cast<int*>(Ps + BN * P_LD);    // [2][BN]
  unsigned* live = reinterpret_cast<unsigned*>(Kp + 2 * BN);
  unsigned* full = live + MAXT / 32;                   // [MAXT / 32] each
  int* Qp = reinterpret_cast<int*>(full + MAXT / 32);  // [BM]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tr = (tid >> 5) * 2 + (lane >> 4);  // rows RPT tr .. + RPT - 1
  const int tc = lane & 15;  // keys tc + 16 u; output words 64 c + 4 tc
  const int g = H / KV;
  const int rows = Q * g;
  // Row tiles in reverse across the whole grid: under a causal mask the
  // last rows hold the most live keys, and they start first.
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  const int r0 = (gridDim.x - 1 - lin / gridDim.y) * BM;
  const int bk = lin % gridDim.y;
  const int b = bk / KV;
  const int kvh = bk - b * KV;
  const int n_tiles = (K + BN - 1) / BN;
  const size_t stride = static_cast<size_t>(KV) * dh;  // key to key
  const T* kh = k + (static_cast<size_t>(b) * K * KV + kvh) * dh;
  const T* vh = v + (static_cast<size_t>(b) * K * KV + kvh) * dh;
  const int dh16 = (dh + 15) & ~15;  // columns the scores read (zero past dh)

  // The query tile (zero rows past Q * g, zero columns past dh).
#pragma unroll
  for (int i = 0; i < BM * (DHP / 4) / SIMT_THREADS; ++i) {
    const int c = tid + i * SIMT_THREADS;
    const int r = c / (DHP / 4);
    const int d = (c - r * (DHP / 4)) * 4;
    const int R = r0 + r;
    const T* src = q;
    if (R < rows) {
      const int qi = R / g;
      src = q +
            ((static_cast<size_t>(b) * Q + qi) * H + kvh * g + (R - qi * g)) *
                dh +
            d;
    }
    stage4(Qs + r * LD + d, src, R < rows && d < dh, dh - d, vec);
  }
  cp_async_commit();

  int qmin, qmax;
  block_positions(q_pos, Qp, r0, rows, g, tid, qmin, qmax);
  mark_tiles<BN>(k_pos, K, n_tiles, qmin, qmax, causal, window,
                 aligned16(k_pos), live, full, tid, SIMT_THREADS);
  cp_async_wait<0>();
  __syncthreads();

  int qp[RPT];
  bool valid[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    qp[i] = Qp[RPT * tr + i];
    valid[i] = r0 + RPT * tr + i < rows;
  }
  const float sl2 = scale * LOG2E;
  const float masked2 = MASKED * LOG2E;

  float O[RPT][4 * CW];
  float m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * CW; ++c) O[i][c] = 0.0f;
  }

  // Pass 0 walks the live tiles; pass 1 the dead ones, only when a row has
  // no live key (it must average v over all K keys).  Tile t + 1 is staged
  // while tile t is computed.
  for (int pass = 0; pass < 2; ++pass) {
    const bool want = pass == 0;
    if (pass == 1) {
      bool need = false;
#pragma unroll
      for (int i = 0; i < RPT; ++i) need |= valid[i] && m[i] <= masked2;
      // Also the barrier after the last tile's readers.
      if (!__syncthreads_or(need)) break;
    }
    int cur = next_tile(live, -1, n_tiles, want);
    if (cur < n_tiles) {
      stage_kv<T, DHP, BN>(kh, vh, k_pos, Ks, Vs, Kp, cur * BN, K, stride,
                           dh, vec, tid);
    }
    cp_async_commit();
    int buf = 0;
    while (cur < n_tiles) {
      cp_async_wait<0>();
      __syncthreads();  // tile ``cur`` has landed; the other slot and P^T
                        // are free
      const int nxt = next_tile(live, cur, n_tiles, want);
      if (nxt < n_tiles) {
        stage_kv<T, DHP, BN>(kh, vh, k_pos, Ks + (buf ^ 1) * TILE,
                             Vs + (buf ^ 1) * TILE, Kp + (buf ^ 1) * BN,
                             nxt * BN, K, stride, dh, vec, tid);
      }
      cp_async_commit();
      const float* Kt = Ks + buf * TILE;
      const float* Vt = Vs + buf * TILE;
      const int* kp = Kp + buf * BN;
      const bool tile_full =
          cur < MAXT && ((full[cur >> 5] >> (cur & 31)) & 1u);

      // S = Q . K^T: each thread's RPT rows x KPT keys, in 16-byte words
      // along the head dim (each K word serves RPT rows, each Q word KPT
      // keys).
      float s[RPT][KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
#pragma unroll
        for (int u = 0; u < KPT; ++u) s[i][u] = 0.0f;
      }
#pragma unroll
      for (int d0 = 0; d0 < DHP; d0 += 16) {
        if (d0 < dh16) {
#pragma unroll
          for (int d = d0; d < d0 + 16; d += 4) {
            float4 a[RPT], kw[KPT];
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              a[i] = lds4(Qs + (RPT * tr + i) * LD + d);
            }
#pragma unroll
            for (int u = 0; u < KPT; ++u) {
              kw[u] = lds4(Kt + (tc + 16 * u) * LD + d);
            }
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
#pragma unroll
              for (int u = 0; u < KPT; ++u) {
                float x = s[i][u];
                x = fmaf(a[i].x, kw[u].x, x);
                x = fmaf(a[i].y, kw[u].y, x);
                x = fmaf(a[i].z, kw[u].z, x);
                s[i][u] = fmaf(a[i].w, kw[u].w, x);
              }
            }
          }
        }
      }

      // Scale, softcap, mask (log2 domain); the rows' maxima over the 16
      // threads that share them.
      float mx[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        mx[i] = -INFINITY;
#pragma unroll
        for (int u = 0; u < KPT; ++u) {
          float x;
          if (softcap > 0.0f) {
            x = softcap * tanhf(s[i][u] * scale / softcap) * LOG2E;
          } else {
            x = s[i][u] * sl2;
          }
          if (!tile_full) {
            const int key = tc + 16 * u;
            if (cur * BN + key >= K) {
              x = -INFINITY;  // keys past K weigh 0
            } else if (!live_key(kp[key], qp[i], causal, window)) {
              x = masked2;
            }
          }
          s[i][u] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], off));
        }
      }
      // The tile holds a key below K, so each maximum is finite.
      float alpha[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float mn = fmaxf(m[i], mx[i]);
        alpha[i] = ex2(m[i] - mn);  // 0 while m is -inf
        m[i] = mn;
        l[i] *= alpha[i];
      }
      // P^T to shared memory: a masked key of a row that holds a live score
      // weighs 0 without an exp (a row with none yet weighs its masked keys
      // equally).
#pragma unroll
      for (int u = 0; u < KPT; ++u) {
        float p[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float x = s[i][u];
          p[i] = x <= masked2 && m[i] > masked2 ? 0.0f : ex2(x - m[i]);
          l[i] += p[i];
        }
        *reinterpret_cast<float4*>(Ps + (tc + 16 * u) * P_LD + RPT * tr) =
            make_float4(p[0], p[1], p[2], p[3]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
#pragma unroll
        for (int c = 0; c < 4 * CW; ++c) O[i][c] *= alpha[i];
      }
      __syncthreads();  // P^T is complete

      // O += P . V: each thread's RPT rows x 4 CW columns, one key at a
      // time (each V word serves RPT rows, each P word 4 CW columns).
#pragma unroll 8
      for (int j = 0; j < BN; ++j) {
        const float4 p = lds4(Ps + j * P_LD + RPT * tr);
        const float pr[RPT] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const float4 w = lds4(Vt + j * LD + 64 * c + 4 * tc);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            O[i][4 * c + 0] = fmaf(pr[i], w.x, O[i][4 * c + 0]);
            O[i][4 * c + 1] = fmaf(pr[i], w.y, O[i][4 * c + 1]);
            O[i][4 * c + 2] = fmaf(pr[i], w.z, O[i][4 * c + 2]);
            O[i][4 * c + 3] = fmaf(pr[i], w.w, O[i][4 * c + 3]);
          }
        }
      }
      cur = nxt;
      buf ^= 1;
    }
  }

  // Row sums over the 16 threads of a row, then out = O / l.
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) l[i] += __shfl_xor_sync(FULL, l[i], off);
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int R = r0 + RPT * tr + i;
    if (R >= rows) continue;
    const int qi = R / g;
    T* orow =
        out +
        ((static_cast<size_t>(b) * Q + qi) * H + kvh * g + (R - qi * g)) * dh;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int d = 64 * c + 4 * tc;
      if (d >= dh) continue;
      if constexpr (sizeof(T) == 4) {
        if (vec_out) {
          *reinterpret_cast<float4*>(orow + d) =
              make_float4(O[i][4 * c] * inv, O[i][4 * c + 1] * inv,
                          O[i][4 * c + 2] * inv, O[i][4 * c + 3] * inv);
          continue;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (d + e < dh) orow[d + e] = from_f<T>(O[i][4 * c + e] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum Path { SIMT = 0, SPLIT = 1, WGMMA = 2 };

template <typename T, int DHP>
int launch_simt_dhp(const T* q, const T* k, const T* v, const int32_t* q_pos,
                    const int32_t* k_pos, T* out, int B, int Q, int H, int K,
                    int KV, int dh, int causal, int window, float softcap,
                    float scale, cudaStream_t stream) {
  constexpr size_t smem = simt_smem_bytes(DHP);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_simt_kernel<T, DHP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // 16-byte staging: float32 rows of a multiple of 4 elements, aligned.
  const bool f32 = sizeof(T) == 4 && dh % 4 == 0;
  const int vec = f32 && aligned16(q) && aligned16(k) && aligned16(v);
  const int vec_out = f32 && aligned16(out);
  const int rows = Q * (H / KV);
  const dim3 grid((rows + BM - 1) / BM, B * KV);
  flash_attention_simt_kernel<T, DHP>
      <<<grid, SIMT_THREADS, smem, stream>>>(
      q, k, v, q_pos, k_pos, out, Q, H, K, KV, dh, causal, window, softcap,
      scale, vec, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_simt(const T* q, const T* k, const T* v, const int32_t* q_pos,
                const int32_t* k_pos, T* out, int B, int Q, int H, int K,
                int KV, int dh, int causal, int window, float softcap,
                float scale, cudaStream_t stream) {
  if (dh <= 64) {
    return launch_simt_dhp<T, 64>(q, k, v, q_pos, k_pos, out, B, Q, H, K, KV,
                                  dh, causal, window, softcap, scale, stream);
  }
  if (dh <= 128) {
    return launch_simt_dhp<T, 128>(q, k, v, q_pos, k_pos, out, B, Q, H, K,
                                   KV, dh, causal, window, softcap, scale,
                                   stream);
  }
  return launch_simt_dhp<T, 256>(q, k, v, q_pos, k_pos, out, B, Q, H, K, KV,
                                 dh, causal, window, softcap, scale, stream);
}

template <typename T, int R>
void launch_split_r(const T* q, const T* k, const T* v, const int32_t* q_pos,
                    const int32_t* k_pos, float* ws_acc, float* ws_m,
                    float* ws_l, int B, int Q, int H, int K, int KV, int dh,
                    int causal, int window, float softcap, float scale,
                    int split, int n_splits, int lanes_log2,
                    cudaStream_t stream) {
  const dim3 grid(n_splits, B * KV);
  flash_attention_split_kernel<T, R><<<grid, SPLIT_THREADS, 0, stream>>>(
      q, k, v, q_pos, k_pos, ws_acc, ws_m, ws_l, Q, H, K, KV, dh, causal,
      window, softcap, scale, split, lanes_log2);
}

template <typename T>
int launch_split(const T* q, const T* k, const T* v, const int32_t* q_pos,
                 const int32_t* k_pos, T* out, float* ws, int B, int Q, int H,
                 int K, int KV, int dh, int causal, int window, float softcap,
                 float scale, int split, cudaStream_t stream) {
  const int rows = Q * (H / KV);
  if (ws == nullptr || split <= 0 || rows > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_splits = (K + split - 1) / split;
  if (n_splits > MAX_SPLITS) return static_cast<int>(cudaErrorInvalidValue);
  int lanes_log2 = 0;  // lanes per key row: pow2ceil(ceil(dh / 8))
  while ((8 << lanes_log2) < dh) ++lanes_log2;
  const size_t n_rows = static_cast<size_t>(B) * KV * n_splits * rows;
  float* ws_acc = ws;
  float* ws_m = ws + n_rows * dh;
  float* ws_l = ws_m + n_rows;
  if (rows == 1) {
    launch_split_r<T, 1>(q, k, v, q_pos, k_pos, ws_acc, ws_m, ws_l, B, Q, H,
                         K, KV, dh, causal, window, softcap, scale, split,
                         n_splits, lanes_log2, stream);
  } else if (rows == 2) {
    launch_split_r<T, 2>(q, k, v, q_pos, k_pos, ws_acc, ws_m, ws_l, B, Q, H,
                         K, KV, dh, causal, window, softcap, scale, split,
                         n_splits, lanes_log2, stream);
  } else if (rows <= 4) {
    launch_split_r<T, 4>(q, k, v, q_pos, k_pos, ws_acc, ws_m, ws_l, B, Q, H,
                         K, KV, dh, causal, window, softcap, scale, split,
                         n_splits, lanes_log2, stream);
  } else {
    launch_split_r<T, 8>(q, k, v, q_pos, k_pos, ws_acc, ws_m, ws_l, B, Q, H,
                         K, KV, dh, causal, window, softcap, scale, split,
                         n_splits, lanes_log2, stream);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  flash_attention_merge_kernel<T><<<B * KV * rows, MERGE_THREADS, 0, stream>>>(
      ws_acc, ws_m, ws_l, out, Q, H, KV, dh, n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <int DHP>
int launch_wgmma_dhp(const bf16* q, const bf16* k, const bf16* v,
                     const int32_t* q_pos, const int32_t* k_pos, bf16* out,
                     int B, int Q, int H, int K, int KV, int dh, int causal,
                     int window, float softcap, float scale,
                     cudaStream_t stream) {
  constexpr size_t smem = wgmma_smem_bytes(DHP);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<DHP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = Q * (H / KV);
  const dim3 grid((rows + BM - 1) / BM, B * KV);
  flash_attention_wgmma_kernel<DHP>
      <<<grid, key_groups(DHP) * GROUP_THREADS, smem, stream>>>(
      q, k, v, q_pos, k_pos, out, Q, H, K, KV, dh, causal, window, softcap,
      scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgmma(const bf16* q, const bf16* k, const bf16* v,
                 const int32_t* q_pos, const int32_t* k_pos, bf16* out, int B,
                 int Q, int H, int K, int KV, int dh, int causal, int window,
                 float softcap, float scale, cudaStream_t stream) {
  if (dh % 8 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(k_pos) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dh <= 64) {
    return launch_wgmma_dhp<64>(q, k, v, q_pos, k_pos, out, B, Q, H, K, KV,
                                dh, causal, window, softcap, scale, stream);
  }
  if (dh <= 128) {
    return launch_wgmma_dhp<128>(q, k, v, q_pos, k_pos, out, B, Q, H, K, KV,
                                 dh, causal, window, softcap, scale, stream);
  }
  return launch_wgmma_dhp<256>(q, k, v, q_pos, k_pos, out, B, Q, H, K, KV, dh,
                               causal, window, softcap, scale, stream);
}

bool bad_shape(int B, int Q, int H, int K, int KV, int dh) {
  return B <= 0 || Q <= 0 || K <= 0 || dh <= 0 || dh > DH_MAX || KV <= 0 ||
         H % KV != 0;
}

}  // namespace

extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, const int32_t* q_pos,
                                   const int32_t* k_pos, float* out,
                                   float* ws, int B, int Q, int H, int K,
                                   int KV, int dh, int causal, int window,
                                   float softcap, float scale, int path,
                                   int split, void* stream) {
  if (bad_shape(B, Q, H, K, KV, dh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == SPLIT) {
    return launch_split<float>(q, k, v, q_pos, k_pos, out, ws, B, Q, H, K,
                               KV, dh, causal, window, softcap, scale, split,
                               st);
  }
  if (path != SIMT) return static_cast<int>(cudaErrorInvalidValue);
  return launch_simt<float>(q, k, v, q_pos, k_pos, out, B, Q, H, K, KV, dh,
                            causal, window, softcap, scale, st);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, const int32_t* q_pos,
                                    const int32_t* k_pos, void* out,
                                    float* ws, int B, int Q, int H, int K,
                                    int KV, int dh, int causal, int window,
                                    float softcap, float scale, int path,
                                    int split, void* stream) {
  if (bad_shape(B, Q, H, K, KV, dh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (path) {
    case SPLIT:
      return launch_split<bf16>(qb, kb, vb, q_pos, k_pos, ob, ws, B, Q, H, K,
                                KV, dh, causal, window, softcap, scale, split,
                                st);
    case WGMMA:
      return launch_wgmma(qb, kb, vb, q_pos, k_pos, ob, B, Q, H, K, KV, dh,
                          causal, window, softcap, scale, st);
    case SIMT:
      return launch_simt<bf16>(qb, kb, vb, q_pos, k_pos, ob, B, Q, H, K, KV,
                               dh, causal, window, softcap, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
