// The WKV-6 recurrence of RWKV-6 (Finch), one block per (batch row, head).
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
// a multiple of the chunk and returns no state.  This kernel takes any
// T >= 1, an initial state that it updates, and the model's layout; on the
// serving path T is 1 (the ssm family decodes and prefills per token), and
// there no chunking is possible.
//
// Bound.  Each input is read once, the state read and written once, the
// output written once.  At rwkv6-3b's decode call (B = 1, T = 1, H = 40,
// dh = 64, bf16 r/k/v) that is 1,356,800 bytes, almost all of it the state
// (2 * 40 * 64 * 64 * 4 bytes), about 0.41 us at 3.35 TB/s.  The function
// needs 5 * dh^2 flops per (token, head): r.S is dh^2 fused multiply-adds
// and the update w_i * S_ij + k_i * v_j three flops per element, while the
// bonus term factors as (sum_i r_i u_i k_i) v_j, O(dh).  (The loop below
// spends 7 * dh^2, not factoring it.)  At decode that is 0.8 MFLOP, bound
// by bytes.  At T = 512 the bytes are about 19.7 MB (5.87 us) and the
// flops 419 MFLOP (6.26 us at the float32 rate of 67 TFLOP/s outside the
// tensor cores): bound by operations.
//
// Design (simple and right first).  The layout is that of the public
// RWKV-6 CUDA forward kernel (wkv6_cuda.cu in BlinkDL's RWKV-LM):
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
//  * out_j and S_ij are float32 fmaf chains over i in order.
// What it leaves on the table (later work): at decode only B * H = 40
// blocks of two warps run on 132 SMs, and at T = 512 the loop over tokens
// is serial; a chunked tensor-core form for long T, several heads per
// block and the fused group norm are the next steps.
//
// Plain C interface for ctypes; each launch function returns
// cudaGetLastError() so that a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
          const float kv = e.y * vj;
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

template <typename E>
int launch(const E* r, const E* k, const E* v, const float* w,
           const float* u, float* S, float* out, int B, int T, int H,
           int dh, int round_out, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || dh <= 0 || dh > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = B * H;
  if (dh <= 32) {
    wkv6_kernel<E, 32><<<blocks, 32, 0, st>>>(r, k, v, w, u, S, out, T, H,
                                              dh, round_out);
  } else if (dh <= 64) {
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
                        void* stream) {
  return launch<float>(r, k, v, w, u, S, out, B, T, H, dh, round_out,
                       stream);
}

extern "C" int wkv6_bf16(const void* r, const void* k, const void* v,
                         const float* w, const float* u, float* S,
                         float* out, int B, int T, int H, int dh,
                         int round_out, void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(r),
                               static_cast<const __nv_bfloat16*>(k),
                               static_cast<const __nv_bfloat16*>(v), w, u,
                               S, out, B, T, H, dh, round_out, stream);
}
