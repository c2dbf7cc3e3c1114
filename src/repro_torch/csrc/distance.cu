// Seed rows of squared Euclidean distances, for the analyzer's clustering.
//
//   out[s, q] = max(sq[idx[s]] + sq[q] - 2 * dot(points[idx[s]], points[q]), 0)
//
// for k seed indices idx into an (m, n) float32 point matrix; out is (k, m).
//
// Replaces the Pallas TPU kernel src/repro/kernels/distance.py
// (multi_seed_rows, pallas_call at line 87), which the reference reaches
// from clustering.py::_PallasDistanceBackend.device_rows and
// lockstep.py::DeviceLockstep._ensure_rows.  What it computes is that
// kernel's function, not its block layout: no input is padded, any m, n and
// k are taken, and the ragged edges are masked here.
//
// Bound.  At the fleet shape the analyzer's main path runs (m = 16384
// shards, n = 128 regions, k = 8 seeds) the call must move
// m*n*4 + m*4 + k*4 + k*m*4 = 8,978,464 bytes, about 2.7 us at the H100's
// 3.35 TB/s, while its 2*k*m*n = 33.5 MFLOP take about 0.5 us at 67 TFLOP/s
// of float32 outside the tensor cores.  It is bound by bytes, and at this
// size the launch itself (a few us) dominates both.
//
// Design.
//  * One block owns BM = 64 consecutive points, one point per thread, and
//    walks every seed of the call, so each point row is read from global
//    memory once whatever k is.  The rows of a block are contiguous in
//    memory, so staging them into shared memory is a coalesced copy.
//  * Columns are staged NC = 128 at a time (the main path's n = 128 is one
//    chunk), transposed with one padding column, so the copy-in and the
//    per-thread reads are both free of bank conflicts.
//  * Seeds come in tiles of BK rows gathered into shared memory (all
//    threads read the same seed word: a broadcast).  BK is a template
//    parameter, the smallest of 1, 2, 4, 8, 16 that holds min(k, 16): the
//    main path fetches one seed per call, and a fixed 16-wide tile would
//    spend 15 of every 16 FMAs on slots no seed fills.  Slots of a partly
//    filled last tile are zeroed, so no thread reads unwritten memory.
//  * Every output element is one thread-owned dot product over n, in a
//    fixed order (j = 0, 1, ..., n-1) with fmaf in float32: no tensor cores,
//    no TF32.  A row therefore does not depend on which other seeds share
//    the launch, bit for bit, which the analyzer's row cache relies on.
//    When n spans several chunks, the partial sum of an element is parked
//    in its own output slot between chunks (a float32 store and load are
//    exact, so the fmaf chain is unchanged).
//  * Rows of out-of-range seed indices are written as NaN (the kernel
//    cannot raise); the Python wrapper documents this.
//
// Plain C interface for ctypes; the launch function returns
// cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // points per block == threads per block
constexpr int NC = 128;  // columns staged per chunk

template <int BK>        // seeds per shared-memory tile
__global__ void __launch_bounds__(BM)
multi_seed_rows_kernel(const float* __restrict__ points,
                       const float* __restrict__ sq,
                       const int32_t* __restrict__ idx,
                       float* __restrict__ out,
                       int m, int n, int k) {
  __shared__ float P[NC * (BM + 1)];  // point chunk, transposed: P[j][t]
  __shared__ float S[BK * NC];        // seed chunk: S[s][j]
  __shared__ int seed_row[BK];

  const int t = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int q = m0 + t;
  const int rows_here = min(BM, m - m0);
  const int nchunks = n > 0 ? (n + NC - 1) / NC : 1;
  const float sq_q = q < m ? sq[q] : 0.0f;

  for (int c = 0; c < nchunks; ++c) {
    const int c0 = c * NC;
    const int nc = min(NC, n - c0);
    const bool last = c == nchunks - 1;
    __syncthreads();  // the previous chunk's readers are done with P
    // Coalesced copy of rows m0 .. m0+rows_here-1, columns c0 .. c0+nc-1.
    for (int e = t; e < rows_here * nc; e += BM) {
      const int r = e / nc;
      const int j = e - r * nc;
      P[j * (BM + 1) + r] = points[(size_t)(m0 + r) * n + c0 + j];
    }
    for (int s0 = 0; s0 < k; s0 += BK) {
      const int bk = min(BK, k - s0);
      __syncthreads();  // the previous seed tile's readers are done with S
      if (t < bk) {
        const int p = idx[s0 + t];
        seed_row[t] = (p >= 0 && p < m) ? p : -1;
      }
      __syncthreads();
      for (int e = t; e < BK * nc; e += BM) {
        const int s = e / nc;
        const int j = e - s * nc;
        const int p = s < bk ? seed_row[s] : -1;
        S[s * NC + j] = p >= 0 ? points[(size_t)p * n + c0 + j] : 0.0f;
      }
      __syncthreads();
      if (q < m) {
        float acc[BK];
#pragma unroll
        for (int s = 0; s < BK; ++s) {
          acc[s] = (c == 0 || s >= bk) ? 0.0f : out[(size_t)(s0 + s) * m + q];
        }
        for (int j = 0; j < nc; ++j) {
          const float pj = P[j * (BM + 1) + t];
#pragma unroll
          for (int s = 0; s < BK; ++s) acc[s] = fmaf(S[s * NC + j], pj, acc[s]);
        }
#pragma unroll
        for (int s = 0; s < BK; ++s) {
          if (s >= bk) break;
          float v = acc[s];
          if (last) {
            const int p = seed_row[s];
            if (p < 0) {
              v = nanf("");
            } else {
              const float d = (sq[p] + sq_q) - 2.0f * v;
              v = d < 0.0f ? 0.0f : d;  // clamp, keeping a NaN a NaN
            }
          }
          out[(size_t)(s0 + s) * m + q] = v;
        }
      }
    }
  }
}

}  // namespace

extern "C" int distance_multi_seed_rows(const float* points, const float* sq,
                                        const int32_t* idx, float* out, int m,
                                        int n, int k, void* stream) {
  if (m <= 0 || k <= 0) return 0;
  const dim3 grid((m + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 1) {
    multi_seed_rows_kernel<1><<<grid, BM, 0, st>>>(points, sq, idx, out, m, n, k);
  } else if (k == 2) {
    multi_seed_rows_kernel<2><<<grid, BM, 0, st>>>(points, sq, idx, out, m, n, k);
  } else if (k <= 4) {
    multi_seed_rows_kernel<4><<<grid, BM, 0, st>>>(points, sq, idx, out, m, n, k);
  } else if (k <= 8) {
    multi_seed_rows_kernel<8><<<grid, BM, 0, st>>>(points, sq, idx, out, m, n, k);
  } else {
    multi_seed_rows_kernel<16><<<grid, BM, 0, st>>>(points, sq, idx, out, m, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}
