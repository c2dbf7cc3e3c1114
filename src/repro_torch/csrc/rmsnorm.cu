// RMSNorm with a Gemma-style (1 + w) scale.
//
//   y[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * (1 + w)
//
// for x (N, d) and w (d,), accumulated in float32, each element computed
// as (x * r) * (1 + w) and rounded once to x's dtype, as the reference's
// models/layers.py::rms_norm does.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm,
// pallas_call at line 31; wrapper kernels/ops.py:58), whose jnp twin
// models/layers.py:88 rms_norm is what the reference's transformer runs:
// 2L + 1 times per model call (two per block, one final).  Any N is taken:
// the TPU kernel's rows-per-block tiling, and the halving of row_block
// until it divides N (ops.py:58-66), are gone.
//
// Bound.  The call reads x and w once and writes y once: at the serving
// path's prefill chunk (N = 256, d = 3072, bf16) that is
// 2*256*3072*2 + 3072*2 = 3,151,872 bytes, about 0.94 us at 3.35 TB/s; the
// 4 flops per element are nothing beside it.  It is bound by bytes, and at
// the decode shapes (N = 1, d = 3072 for gemma-7b, 2560 for rwkv6-3b: 12
// and 10 KB) by the latency of the launch and of one trip to memory.
//
// Design: two paths, chosen on the host from the shapes and the pointers'
// alignment alone (kernels/rmsnorm.py::rmsnorm_plan).
//  * Row per block (rmsnorm_row_kernel): one block per row.  Each thread
//    owns ITEMS 16-byte vectors of the row (VEC = 8 elements in bf16, 4 in
//    float32), at vector indices tid + i * blockDim.x, and the block is
//    d / VEC / ITEMS threads rounded up to a warp: at the decode rows
//    (N = 1) ITEMS = 1, 384 threads at d = 3072 and 320 at d = 2560; above
//    132 rows ITEMS = 2, so that twice the rows are in flight on an SM.
//    Each thread issues its loads of w and of x before any arithmetic, so
//    a row costs one trip to memory, not the two of a norm that reads w
//    after the reduction; x stays in registers and is not read again.
//    The squares are reduced by warp shuffles, one shared-memory step and
//    one barrier; every thread then reads the warps' partials as float4
//    words, all at once, and adds them in warp order (the same fixed order
//    in every thread), then writes its 16-byte vectors.
//  * Scalar (rmsnorm_kernel, the first design of this kernel): d not a
//    multiple of VEC, a pointer not 16-byte aligned, or a row longer than
//    4 * 1024 vectors.
//    One block of 256 threads per row striding over the row, then a second
//    pass that reads the row again (from L1/L2) with w.
// A rows-per-block path (several rows a block, w staged once per block in
// shared memory) was built and measured slower than a block per row at
// both row counts above 132 that were timed (PERF.md), and removed.
// What holds the vector path above its bound: every block waits on its
// loads, then on the reduction, before it stores; at the prefill chunk it
// takes about 1.5 times a plain PyTorch copy of the same bytes.
// Templated on the element type: bf16 for the served model, float32 for
// the tests and the model-parity check.  w has x's type.
//
// Plain C interface for ctypes; the launch function returns
// cudaGetLastError() so that a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // the scalar path's block
constexpr int WARPS = THREADS / 32;
constexpr int MAX_THREADS = 1024;
// Paths, as kernels/rmsnorm.py::PATHS numbers them.
constexpr int PATH_SCALAR = 0, PATH_ROW = 1;

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

// 16 bytes of elements, unpacked to float32 and packed back.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float2 t = __bfloat1622float2(h[p]);
      f[2 * p] = t.x;
      f[2 * p + 1] = t.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int p = 0; p < 4; ++p) h[p] = __floats2bfloat162_rn(f[2 * p],
                                                            f[2 * p + 1]);
    return u;
  }
};

// The row path: one row a block, ITEMS vectors of it a thread.
template <typename T, int ITEMS>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_row_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, int d, float eps) {
  using V = Vec<T>;
  __shared__ __align__(16) float partial[MAX_THREADS / 32];
  const int nv = d / V::N;  // vectors in a row
  const int t = threadIdx.x;
  const int P = blockDim.x;  // a multiple of 32
  const size_t row = blockIdx.x;
  const int lane = t & 31;
  const int warps = P >> 5;
  const uint4* w4 = reinterpret_cast<const uint4*>(w);
  const uint4* x4 = reinterpret_cast<const uint4*>(x) + row * nv;

  // Every load before any arithmetic: one trip to memory.
  uint4 xv[ITEMS], wv[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int v = t + i * P;
    xv[i] = v < nv ? x4[v] : make_uint4(0, 0, 0, 0);
    wv[i] = v < nv ? w4[v] : make_uint4(0, 0, 0, 0);
  }

  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    float f[V::N];
    V::unpack(xv[i], f);
#pragma unroll
    for (int e = 0; e < V::N; ++e) ss = fmaf(f[e], f[e], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  if (lane == 0) partial[t >> 5] = ss;
  __syncthreads();

  // The warps' partials as float4 words, all read at once, then added in
  // warp order.
  float4 pw[MAX_THREADS / 128];
#pragma unroll
  for (int q = 0; q < MAX_THREADS / 128; ++q) {
    if (4 * q < warps) {
      pw[q] = *reinterpret_cast<const float4*>(&partial[4 * q]);
    }
  }
  float tot = 0.0f;
#pragma unroll
  for (int q = 0; q < MAX_THREADS / 128; ++q) {
    if (4 * q < warps) tot += pw[q].x;
    if (4 * q + 1 < warps) tot += pw[q].y;
    if (4 * q + 2 < warps) tot += pw[q].z;
    if (4 * q + 3 < warps) tot += pw[q].w;
  }
  const float rs = rsqrtf(tot / static_cast<float>(d) + eps);
  uint4* y4 = reinterpret_cast<uint4*>(y) + row * nv;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int v = t + i * P;
    if (v < nv) {
      float f[V::N], g[V::N];
      V::unpack(xv[i], f);
      V::unpack(wv[i], g);
#pragma unroll
      for (int e = 0; e < V::N; ++e) f[e] = (f[e] * rs) * (1.0f + g[e]);
      y4[v] = V::pack(f);
    }
  }
}

// The scalar path: any d, any alignment.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, int d, float eps) {
  __shared__ float partial[WARPS];
  __shared__ float rstd;
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float ss = 0.0f;
  for (int j = threadIdx.x; j < d; j += THREADS) {
    const float v = to_f(xr[j]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < WARPS ? partial[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    if (lane == 0) rstd = rsqrtf(v / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = rstd;
  for (int j = threadIdx.x; j < d; j += THREADS) {
    yr[j] = from_f<T>((to_f(xr[j]) * r) * (1.0f + to_f(w[j])));
  }
}

// path, threads and items come from the host's plan; they are checked
// here against what the row kernel can cover.
template <typename T>
int launch(const T* x, const T* w, T* y, int n, int d, float eps, int path,
           int threads, int items, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == PATH_SCALAR) {
    rmsnorm_kernel<T><<<n, THREADS, 0, st>>>(x, w, y, d, eps);
    return static_cast<int>(cudaGetLastError());
  }
  const int vec = Vec<T>::N;
  if (path != PATH_ROW || d % vec != 0 || threads % 32 != 0 ||
      threads <= 0 || threads > MAX_THREADS ||
      (items != 1 && items != 2 && items != 4) ||
      static_cast<long long>(threads) * items * vec < d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (items == 1) {
    rmsnorm_row_kernel<T, 1><<<n, threads, 0, st>>>(x, w, y, d, eps);
  } else if (items == 2) {
    rmsnorm_row_kernel<T, 2><<<n, threads, 0, st>>>(x, w, y, d, eps);
  } else {
    rmsnorm_row_kernel<T, 4><<<n, threads, 0, st>>>(x, w, y, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rmsnorm_f32(const float* x, const float* w, float* y, int n,
                           int d, float eps, int path, int threads,
                           int items, void* stream) {
  return launch<float>(x, w, y, n, d, eps, path, threads, items, stream);
}

extern "C" int rmsnorm_bf16(const void* x, const void* w, void* y, int n,
                            int d, float eps, int path, int threads,
                            int items, void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x),
                               static_cast<const __nv_bfloat16*>(w),
                               static_cast<__nv_bfloat16*>(y), n, d, eps,
                               path, threads, items, stream);
}
