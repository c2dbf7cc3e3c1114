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
//    uniformly, as naive_attention does;
//  * an optional logit softcap (one tanh) and any Q, K and dh <= 256.
//
// Bound.  Each input is read once and the output written once.  At the
// serving path's decode call (gemma-7b: Q = 1, H = KV = 16, dh = 256, a
// 545-slot cache, bf16) k and v are 8,929,280 bytes, about 2.7 us at
// 3.35 TB/s, and the 4*dh flops per (query, key, head) are 8.9 MFLOP: bound
// by bytes.  At the 256-token prefill chunk q, k, v and out are about
// 13.1 MB, about 3.9 us, and the unmasked pairs' flops (about 1.6 GFLOP
// for the second chunk, whose 256 queries see 257..512 keys each) take
// about 1.6 us at the bf16 tensor-core rate of 989 TFLOP/s.
//
// Design (simple and right first; wgmma, TMA and split-K decode are later
// work).
//  * A block is 8 warps and owns one (b, h) and up to 8 queries.  Each
//    query has 8 / (queries in the block) warps, which split the keys
//    among them: a decode call (Q = 1) runs one block per (b, h) whose 8
//    warps each take every 8th key; a prefill chunk runs one warp per
//    query.  Each warp keeps an online softmax (m, l, acc) in float32
//    registers; at the end the warps of a query merge theirs through
//    shared memory.
//  * Keys come in tiles of 16, staged into shared memory as float32 by
//    the whole block (neighbouring threads on neighbouring elements of a
//    row) together with their positions, so the warps of the block share
//    every load.  Lane t holds elements t, t+32, ... of the query and the
//    accumulator (dh <= 256: 8 registers each), so reads of a staged row
//    are free of bank conflicts; a score is the lane-partial fmaf chain
//    summed by warp shuffles.
//  * No key block is skipped: with explicit positions nothing says which
//    tiles are fully masked, and masked keys cost their score only.
//  * Templated on the element type: bf16 for the served model, float32
//    for the tests and the model-parity check.  The probabilities stay in
//    float32 (the reference's naive_attention rounds them to v's dtype
//    before P.V).
//
// Plain C interface for ctypes; each launch function returns
// cudaGetLastError() so that a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int DH_MAX = 256;
constexpr int NI = DH_MAX / 32;  // head-vector elements per lane
constexpr int KT = 16;           // keys staged per tile
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int32_t* __restrict__ q_pos,
                       const int32_t* __restrict__ k_pos,
                       T* __restrict__ out, int Q, int H, int K, int KV,
                       int dh, int causal, int window, float softcap,
                       float scale, int ksplit) {
  __shared__ float Ks[KT][DH_MAX];
  __shared__ float Vs[KT][DH_MAX];
  __shared__ int Ps[KT];
  __shared__ float Ms[WARPS];
  __shared__ float Ls[WARPS];
  __shared__ float Acc[WARPS][DH_MAX];

  const int qpb = WARPS / ksplit;  // queries per block
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * qpb + warp / ksplit;
  const int split = warp - (warp / ksplit) * ksplit;
  const bool active = qi < Q;  // the same for the whole warp

  float qv[NI];
  float acc[NI];
  int qp = 0;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    qv[i] = 0.0f;
    acc[i] = 0.0f;
  }
  if (active) {
    const T* qrow = q + ((static_cast<size_t>(b) * Q + qi) * H + h) * dh;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) qv[i] = to_f(qrow[d]);
    }
    qp = q_pos[qi];
  }
  float m = -INFINITY;
  float l = 0.0f;

  for (int k0 = 0; k0 < K; k0 += KT) {
    const int kt = min(KT, K - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int e = threadIdx.x; e < kt * dh; e += THREADS) {
      const int j = e / dh;
      const int d = e - j * dh;
      const size_t off =
          ((static_cast<size_t>(b) * K + k0 + j) * KV + kvh) * dh + d;
      Ks[j][d] = to_f(k[off]);
      Vs[j][d] = to_f(v[off]);
    }
    if (threadIdx.x < kt) Ps[threadIdx.x] = k_pos[k0 + threadIdx.x];
    __syncthreads();
    if (!active) continue;
    for (int j = split; j < kt; j += ksplit) {
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = lane + 32 * i;
        if (d < dh) part = fmaf(qv[i], Ks[j][d], part);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, off);
      }
      float s = part * scale;
      if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
      const int kp = Ps[j];
      bool live = true;
      if (causal) live = kp <= qp;
      if (window > 0) live = live && kp > qp - window;
      if (!live) s = MASKED;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);  // 0 while m is -inf
      const float p = expf(s - m_new);
      l = l * alpha + p;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = lane + 32 * i;
        if (d < dh) acc[i] = fmaf(p, Vs[j][d], acc[i] * alpha);
      }
      m = m_new;
    }
  }

  // Merge the partial softmaxes of each query's warps.
  if (lane == 0) {
    Ms[warp] = m;
    Ls[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int d = lane + 32 * i;
    if (d < dh) Acc[warp][d] = acc[i];
  }
  __syncthreads();
  if (!active || split != 0) return;
  float M = -INFINITY;
  for (int s = 0; s < ksplit; ++s) M = fmaxf(M, Ms[warp + s]);
  float L = 0.0f;
  float o[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) o[i] = 0.0f;
  for (int s = 0; s < ksplit; ++s) {
    const float ms = Ms[warp + s];
    // A warp that saw no key (K < ksplit) holds m = -inf, l = 0, acc = 0.
    const float c = ms == -INFINITY ? 0.0f : expf(ms - M);
    L += Ls[warp + s] * c;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) o[i] = fmaf(Acc[warp + s][d], c, o[i]);
    }
  }
  L = fmaxf(L, 1e-30f);
  T* orow = out + ((static_cast<size_t>(b) * Q + qi) * H + h) * dh;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int d = lane + 32 * i;
    if (d < dh) orow[d] = from_f<T>(o[i] / L);
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const int32_t* q_pos,
           const int32_t* k_pos, T* out, int B, int Q, int H, int K, int KV,
           int dh, int causal, int window, float softcap, float scale,
           void* stream) {
  if (B <= 0 || Q <= 0 || K <= 0) return 0;
  if (dh <= 0 || dh > DH_MAX || KV <= 0 || H % KV != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int qpb = 1;  // queries per block: the power of two that holds min(Q, 8)
  while (qpb < Q && qpb < WARPS) qpb *= 2;
  const int ksplit = WARPS / qpb;
  const dim3 grid((Q + qpb - 1) / qpb, B * H);
  flash_attention_kernel<T><<<grid, THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      q, k, v, q_pos, k_pos, out, Q, H, K, KV, dh, causal, window, softcap,
      scale, ksplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, const int32_t* q_pos,
                                   const int32_t* k_pos, float* out, int B,
                                   int Q, int H, int K, int KV, int dh,
                                   int causal, int window, float softcap,
                                   float scale, void* stream) {
  return launch<float>(q, k, v, q_pos, k_pos, out, B, Q, H, K, KV, dh,
                       causal, window, softcap, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, const int32_t* q_pos,
                                    const int32_t* k_pos, void* out, int B,
                                    int Q, int H, int K, int KV, int dh,
                                    int causal, int window, float softcap,
                                    float scale, void* stream) {
  using bf = __nv_bfloat16;
  return launch<bf>(static_cast<const bf*>(q), static_cast<const bf*>(k),
                    static_cast<const bf*>(v), q_pos, k_pos,
                    static_cast<bf*>(out), B, Q, H, K, KV, dh, causal,
                    window, softcap, scale, stream);
}
