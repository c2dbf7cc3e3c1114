// The WKV-6 recurrence of RWKV-6 (Finch).
//
//   out[b, t, h, j] = sum_i r_i * (S_ij + u_i * k_i * v_j)
//   S_ij           <- w_i * S_ij + k_i * v_j
//
// with r_i, k_i, w_i = r/k/w[b, t, h, i], v_j = v[b, t, h, j] and u_i =
// u[h, i], for t = 0 .. T-1 in order.  r, k and v are (B, T, H, dh) in
// float32 or bf16, w is (B, T, H, dh) float32, u is (H, dh) float32, S is
// the (B, H, dh, dh) float32 state, read at the start and written back
// after the last token (in place), and out is (B, T, H, dh) float32, each
// value rounded to bf16 first when round_out is set (the reference's
// chunked form, from T = 512 on, returns r's dtype).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py (wkv6,
// pallas_call at line 79; wrapper kernels/ops.py:53), whose jnp twins in
// models/rwkv.py (the lax.scan at :168 below 512 tokens, wkv6_chunked at
// :76 from 512 on) are what the reference's rwkv6-3b runs, once per layer
// per model call.  It computes that function, not the Pallas kernel's
// block layout: the Pallas kernel unrolls chunks of 32 tokens into matrix
// products through cumulative log decays, starts from S = 0, needs T to be
// a multiple of the chunk and returns no state.  These kernels take any
// T >= 1, an initial state that they update, and the model's layout; on
// the serving path T is 1 (the ssm family decodes and prefills per token),
// and there no chunking is possible.
//
// Bound.  Each input is read once, the state read and written once, the
// output written once.  At rwkv6-3b's decode call (B = 1, T = 1, H = 40,
// dh = 64, bf16 r/k/v) that is 1,356,800 bytes, almost all of it the state
// (2 * 40 * 64 * 64 * 4 bytes), about 0.41 us at 3.35 TB/s.  The function
// needs 5 * dh^2 flops per (token, head): r.S is dh^2 fused multiply-adds
// and the update w_i * S_ij + k_i * v_j three flops per element, while the
// bonus term factors as (sum_i r_i u_i k_i) v_j, O(dh).  At decode that is
// 0.8 MFLOP, bound by bytes.  At T = 512 the bytes are about 19.7 MB (5.87
// us) and the flops 419 MFLOP (6.26 us at the float32 rate of 67 TFLOP/s
// outside the tensor cores): bound by operations.
//
// Two kernels, chosen on the host from the shapes (kernels/wkv6.py::
// wkv6_plan):
//
// wkv6_decode_kernel, T = 1 (every call of the served path).  The state
// is the bytes, so it is spread over the card and read in 16-byte words:
//  * Grid (b * H + h, column tile of COL_TILE = 16 columns of S): at
//    rwkv6-3b 40 heads x 4 tiles = 160 blocks on 132 SMs.
//  * Thread (row slice, column group): a slice is ROWS_PER_THREAD = 4
//    consecutive rows i of S, a group VEC = 4 columns j (one float4), or
//    one column where dh is not a multiple of 4 or S is not 16-byte
//    aligned (the scalar column path, VEC = 1).  dh = 64: 16 slices x 4
//    groups = 64 threads.  Each element of S belongs to one thread; the
//    block is rounded up to whole warps with slices past dh (all zeros).
//  * Every S load is issued before any arithmetic, then the head's r_i,
//    k_i, w_i, u_i of the thread's rows and v_j of its columns (threads of
//    one slice share those addresses, so each is fetched once a block).
//  * The thread's partial output over its rows is sum_i r_i S_ij +
//    (sum_i r_i u_i k_i) v_j: the bonus factored, 5 dh^2 flops in all.  A
//    warp's slices are added by a fixed xor tree of shuffles, the warps'
//    sums meet in shared memory and one thread per column adds them in
//    warp order, so the output is the same from run to run.
//  * The state update is the sequential kernel's kv = k_i * v_j;
//    S_ij = fmaf(w_i, S_ij, kv), so the new state equals its state at
//    T = 1 bit for bit; it is stored as the float4 it was loaded as.
//
// wkv6_kernel, T > 1 (the parity phase's 64-token call, the T = 512
// check).  The layout of the public RWKV-6 CUDA forward kernel
// (wkv6_cuda.cu in BlinkDL's RWKV-LM):
//  * One block per (b, h) of N = 32, 64 or 128 threads, the smallest that
//    covers dh (so dh <= 128; lanes j >= dh only stage and synchronise).
//    Thread j keeps column j of S (S_0j .. S_{dh-1}j) in registers, so the
//    state never leaves the SM between tokens, and reads and writes it
//    coalesced (neighbouring threads on neighbouring elements of a row).
//  * For each token the block stages (r_i, k_i, w_i, u_i) as one float4
//    per i in shared memory, so the inner loop over i reads one broadcast
//    16-byte word per step; thread j reads its own v_j.  bf16 inputs are
//    widened to float32 when staged.
//  * The staging is double-buffered with one __syncthreads per token:
//    token t+1's elements are loaded into registers at the top of step t,
//    while step t computes from buffer t & 1, and stored into the other
//    buffer at its end, which nobody reads until after the barrier.
//  * out_j and S_ij are float32 fmaf chains over i in order (the bonus not
//    factored: 7 dh^2 flops a token).
// What is left (later work): the loop over tokens is serial, so T = 512
// runs far above its bound; a chunked tensor-core form for long T and the
// fused group norm are the next steps.
//
// Plain C interface for ctypes; each launch function returns
// cudaGetLastError() so that a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COL_TILE = 16;         // columns of S per decode block
constexpr int ROWS_PER_THREAD = 4;   // rows of S per decode thread
constexpr int MAX_DH = 128;
constexpr int MAX_SLICES = MAX_DH / ROWS_PER_THREAD;
constexpr int DECODE_MAX_THREADS = (COL_TILE / 1) * MAX_SLICES;
constexpr int DECODE_MAX_WARPS = DECODE_MAX_THREADS / 32;
// Paths, as kernels/wkv6.py::PATHS numbers them.
constexpr int PATH_SEQUENTIAL = 0, PATH_DECODE = 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename E, int N>
__global__ void __launch_bounds__(N)
wkv6_kernel(const E* __restrict__ r, const E* __restrict__ k,
            const E* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ S,
            float* __restrict__ out, int T, int H, int dh, int round_out) {
  __shared__ float4 staged[2][N];  // (r_i, k_i, w_i, u_i) of one token
  const int j = threadIdx.x;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const bool live = j < dh;
  const size_t row = static_cast<size_t>(H) * dh;  // one token's stride
  const size_t base = static_cast<size_t>(b) * T * row +
                      static_cast<size_t>(h) * dh;  // (b, 0, h, 0)
  float* Sbh = S + static_cast<size_t>(bh) * dh * dh;

  float s[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = (live && i < dh) ? Sbh[static_cast<size_t>(i) * dh + j] : 0.0f;
  }
  const float uj = live ? u[static_cast<size_t>(h) * dh + j] : 0.0f;
  E nr{}, nk{}, nv{};
  float nw = 0.0f;
  if (live) {
    nr = r[base + j];
    nk = k[base + j];
    nv = v[base + j];
    nw = w[base + j];
    staged[0][j] = make_float4(to_f(nr), to_f(nk), nw, uj);
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    const size_t off = base + static_cast<size_t>(t) * row;
    const float vj = to_f(nv);
    const bool more = live && t + 1 < T;
    if (more) {  // token t+1 into registers; stored after the compute
      const size_t nxt = off + row + j;
      nr = r[nxt];
      nk = k[nxt];
      nv = v[nxt];
      nw = w[nxt];
    }
    if (live) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (i < dh) {
          const float4 e = staged[cur][i];  // (r_i, k_i, w_i, u_i)
          const float kv = __fmul_rn(e.y, vj);
          acc = fmaf(e.x, s[i] + e.w * kv, acc);
          s[i] = fmaf(e.z, s[i], kv);
        }
      }
      if (round_out) acc = __bfloat162float(__float2bfloat16_rn(acc));
      out[off + j] = acc;
    }
    if (more) staged[cur ^ 1][j] = make_float4(to_f(nr), to_f(nk), nw, uj);
    __syncthreads();
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < dh) Sbh[static_cast<size_t>(i) * dh + j] = s[i];
    }
  }
}

template <typename E, int VEC>
__global__ void __launch_bounds__(DECODE_MAX_THREADS)
wkv6_decode_kernel(const E* __restrict__ r, const E* __restrict__ k,
                   const E* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, float* __restrict__ S,
                   float* __restrict__ out, int H, int dh) {
  constexpr int GROUPS = COL_TILE / VEC;  // column groups of a tile
  __shared__ float part[DECODE_MAX_WARPS][COL_TILE];
  const int group = threadIdx.x % GROUPS;
  const int slice = threadIdx.x / GROUPS;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int bh = blockIdx.x;  // b * H + h
  const int h = bh % H;
  const int j0 = blockIdx.y * COL_TILE + group * VEC;
  const int i0 = slice * ROWS_PER_THREAD;
  const bool cols = j0 < dh;  // VEC = 4 only for dh % 4 == 0
  const size_t base = static_cast<size_t>(bh) * dh;  // (b, 0, h, 0)
  float* Sbh = S + base * dh;

  // The state first: every S load in flight before any arithmetic.
  float s[ROWS_PER_THREAD][VEC];
#pragma unroll
  for (int a = 0; a < ROWS_PER_THREAD; ++a) {
    const int i = i0 + a;
    const bool live = cols && i < dh;
    const float* src = Sbh + static_cast<size_t>(i) * dh + j0;
    if constexpr (VEC == 4) {
      const float4 t = live ? *reinterpret_cast<const float4*>(src)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      s[a][0] = t.x;
      s[a][1] = t.y;
      s[a][2] = t.z;
      s[a][3] = t.w;
    } else {
      s[a][0] = live ? *src : 0.0f;
    }
  }
  float rr[ROWS_PER_THREAD], kk[ROWS_PER_THREAD], ww[ROWS_PER_THREAD],
      uu[ROWS_PER_THREAD], vv[VEC];
#pragma unroll
  for (int a = 0; a < ROWS_PER_THREAD; ++a) {
    const int i = i0 + a;
    const bool live = i < dh;
    rr[a] = live ? to_f(r[base + i]) : 0.0f;
    kk[a] = live ? to_f(k[base + i]) : 0.0f;
    ww[a] = live ? w[base + i] : 0.0f;
    uu[a] = live ? u[static_cast<size_t>(h) * dh + i] : 0.0f;
  }
#pragma unroll
  for (int c = 0; c < VEC; ++c) {
    vv[c] = j0 + c < dh ? to_f(v[base + j0 + c]) : 0.0f;
  }

  float p[VEC], bonus = 0.0f;
#pragma unroll
  for (int c = 0; c < VEC; ++c) p[c] = 0.0f;
#pragma unroll
  for (int a = 0; a < ROWS_PER_THREAD; ++a) {
    bonus = fmaf(rr[a] * uu[a], kk[a], bonus);
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      const float kv = __fmul_rn(kk[a], vv[c]);
      p[c] = fmaf(rr[a], s[a][c], p[c]);
      s[a][c] = fmaf(ww[a], s[a][c], kv);
    }
  }

#pragma unroll
  for (int a = 0; a < ROWS_PER_THREAD; ++a) {
    const int i = i0 + a;
    if (cols && i < dh) {
      float* q = Sbh + static_cast<size_t>(i) * dh + j0;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(q) =
            make_float4(s[a][0], s[a][1], s[a][2], s[a][3]);
      } else {
        *q = s[a][0];
      }
    }
  }
  // The slices' partials: lanes l and l ^ (GROUPS << m) of a warp hold
  // the same columns of other slices, so a fixed xor tree adds a warp's
  // slices; its first GROUPS lanes (slice 0 of the warp) hand the sums
  // over, and one thread per column adds the warps in order.
  float o[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) o[c] = fmaf(bonus, vv[c], p[c]);
#pragma unroll
  for (int off = GROUPS; off < 32; off <<= 1) {
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      o[c] += __shfl_xor_sync(0xffffffffu, o[c], off);
    }
  }
  if (lane < GROUPS) {
#pragma unroll
    for (int c = 0; c < VEC; ++c) part[threadIdx.x >> 5][lane * VEC + c] =
        o[c];
  }
  __syncthreads();
  const int j = blockIdx.y * COL_TILE + threadIdx.x;
  if (threadIdx.x < COL_TILE && j < dh) {
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < DECODE_MAX_WARPS; ++q) {
      if (q < warps) acc += part[q][threadIdx.x];
    }
    out[base + j] = acc;
  }
}

// path, vec, tiles and threads come from the host's plan; they are checked
// here against what the kernels can cover.
template <typename E>
int launch(const E* r, const E* k, const E* v, const float* w,
           const float* u, float* S, float* out, int B, int T, int H,
           int dh, int round_out, int path, int vec, int tiles, int threads,
           void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || dh <= 0 || dh > MAX_DH) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == PATH_DECODE) {
    const int groups = vec > 0 ? COL_TILE / vec : 0;
    if (T != 1 || round_out || (vec != 1 && vec != 4) ||
        (vec == 4 && dh % 4 != 0) || tiles * COL_TILE < dh ||
        threads <= 0 || threads > DECODE_MAX_THREADS || threads % 32 != 0 ||
        threads / groups * ROWS_PER_THREAD < dh) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid(B * H, tiles);
    if (vec == 4) {
      wkv6_decode_kernel<E, 4><<<grid, threads, 0, st>>>(r, k, v, w, u, S,
                                                         out, H, dh);
    } else {
      wkv6_decode_kernel<E, 1><<<grid, threads, 0, st>>>(r, k, v, w, u, S,
                                                         out, H, dh);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (path != PATH_SEQUENTIAL || threads < dh ||
      (threads != 32 && threads != 64 && threads != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = B * H;
  if (threads == 32) {
    wkv6_kernel<E, 32><<<blocks, 32, 0, st>>>(r, k, v, w, u, S, out, T, H,
                                              dh, round_out);
  } else if (threads == 64) {
    wkv6_kernel<E, 64><<<blocks, 64, 0, st>>>(r, k, v, w, u, S, out, T, H,
                                              dh, round_out);
  } else {
    wkv6_kernel<E, 128><<<blocks, 128, 0, st>>>(r, k, v, w, u, S, out, T,
                                                H, dh, round_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int wkv6_f32(const float* r, const float* k, const float* v,
                        const float* w, const float* u, float* S, float* out,
                        int B, int T, int H, int dh, int round_out,
                        int path, int vec, int tiles, int threads,
                        void* stream) {
  return launch<float>(r, k, v, w, u, S, out, B, T, H, dh, round_out, path,
                       vec, tiles, threads, stream);
}

extern "C" int wkv6_bf16(const void* r, const void* k, const void* v,
                         const float* w, const float* u, float* S,
                         float* out, int B, int T, int H, int dh,
                         int round_out, int path, int vec, int tiles,
                         int threads, void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(r),
                               static_cast<const __nv_bfloat16*>(k),
                               static_cast<const __nv_bfloat16*>(v), w, u,
                               S, out, B, T, H, dh, round_out, path, vec,
                               tiles, threads, stream);
}
