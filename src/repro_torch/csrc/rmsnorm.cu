// RMSNorm with a Gemma-style (1 + w) scale, one row per block.
//
//   y[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * (1 + w)
//
// for x (N, d) and w (d,), accumulated in float32 and rounded once to x's
// dtype, as the reference's models/layers.py::rms_norm does.
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
// the decode shape (N = 1) by the launch itself.
//
// Design.
//  * One block of 256 threads per row.  Each thread strides over the row
//    with neighbouring threads on neighbouring elements (coalesced), sums
//    x^2 in float32 with fmaf, and the block reduces the partial sums
//    with warp shuffles and one shared-memory step.
//  * The second pass reads the row again (it is in L1/L2 after the first)
//    and writes (x * r) * (1 + w), the reference's order of operations.
//  * Templated on the element type: bf16 for the served model, float32
//    for the tests and the model-parity check.  w has x's type.
//
// Plain C interface for ctypes; each launch function returns
// cudaGetLastError() so that a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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

template <typename T>
int launch(const T* x, const T* w, T* y, int n, int d, float eps,
           void* stream) {
  if (n <= 0 || d <= 0) return 0;
  rmsnorm_kernel<T><<<n, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, y, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rmsnorm_f32(const float* x, const float* w, float* y, int n,
                           int d, float eps, void* stream) {
  return launch<float>(x, w, y, n, d, eps, stream);
}

extern "C" int rmsnorm_bf16(const void* x, const void* w, void* y, int n,
                            int d, float eps, void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x),
                               static_cast<const __nv_bfloat16*>(w),
                               static_cast<__nv_bfloat16*>(y), n, d, eps,
                               stream);
}
