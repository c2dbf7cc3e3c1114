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
// Bound, at the fleet shape (m = 16384 shards, n = 128 regions) and the k
// that chip_smoke.py times (KERNEL_KS): each input read once, the output
// written once, 2n + 3 float32 operations an element at 67 TFLOP/s outside
// the tensor cores, 3.35 TB/s of HBM:
//   k = 1    8.52 MB, 4.2 MFLOP   -> 0.00254 ms, bytes
//   k = 8    8.98 MB, 34 MFLOP    -> 0.00268 ms, bytes
//   k = 64   12.6 MB, 272 MFLOP   -> 0.00405 ms, operations
//   k = 256  25.2 MB, 1.09 GFLOP  -> 0.0162 ms, operations
// Every launch of the analyzer's main paths has k = 1.
//
// What held the first design (one thread a point, 64-thread blocks, the
// point tile copied into shared memory transposed, one 4-byte load and an
// integer divide per element, then a 128-long dependent fmaf chain a
// thread, no register tiling) at 4.8x its k = 1 bound and behind one
// PyTorch addmm at k >= 8 was instructions and latency on that copy, not
// bytes.  This design:
//  * splits each point's dot product over LANES = 8 lanes.  Lane l owns the
//    column quads l, l + 8, l + 16, ... (16-byte loads, n a multiple of 4
//    and an aligned matrix: vec 4) or the columns l, l + 8, ... (vec 1),
//    and runs one fmaf chain over them in ascending order, CHUNK = 128
//    columns of the lane group at a time held in registers; a fixed tree
//    merges the 8 partials: lanes differing in bit 2, then bit 1, then
//    bit 0.  Float addition is commutative, so the tree gives the same
//    bits on whichever lane it ends, and the per-element arithmetic
//    depends only on (n, vec): a row is bit for bit the same whether its
//    seed came alone (row path) or in a batch (tile path), which the
//    analyzer's row caches need.  No tensor cores, no TF32;
//  * k = 1, the row path (seed_row_kernel): a warp holds 4 points, a
//    block 32, so m = 16384 is 4096 warps over the 132 SMs.  Each lane
//    issues its 16-byte loads of x before any arithmetic and before the
//    seed index arrives; x stays in registers, with no shared memory and
//    no transposition.  The seed's slice is the same for every warp (a
//    broadcast from L1/L2).  The merged sums land on lane 0 of each group:
//    the 4 outputs of a warp are one coalesced 16-byte store;
//  * k > 1, the tile path (seed_tile_kernel): a block of 4 warps owns 64
//    points and a tile of kt seeds (grid.y walks the tiles; kt at most 64,
//    about k / 4, so that k = 64 and 256 give 4 blocks a point range).  It
//    stages its seed rows (kt·n·4 bytes, under 48 KB) in shared memory and
//    keeps each lane group's x slice of 4 points in registers across all
//    of them, so x comes from HBM once and from L2 once a tile.  One
//    16-byte shared read of a seed feeds 16 fmafs (4 points x 4 columns);
//    a warp's read is 8 distinct addresses, the same for its 4 groups.
//    Eight seeds at a time are merged by the same tree run as a
//    reduce-scatter (7 shuffles for 8 seeds instead of 24): lane l ends
//    with seed l's sums of its 4 points and stores them as one 16-byte
//    word, so a warp's store covers 8 rows x 64 bytes.  (A first version
//    with 2 points a group, 8 warps and every seed in one block ran k = 64
//    and 256 at 4.8x and 4.2x their bounds: 8 fmafs a shared read, and 16
//    resident warps an SM at 128 registers);
//  * the epilogue (sq_s + sq_q) - 2·dot is written with _rn intrinsics,
//    which the compiler does not contract, so both paths round it alike;
//  * rows of out-of-range seed indices are written as NaN (the kernel
//    cannot raise); the Python wrapper documents this.
//
// Plain C interface for ctypes; the launch function returns
// cudaGetLastError() (or cudaErrorInvalidValue for a plan it does not
// take) so that a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LANES = 8;                       // lanes summing one point
constexpr int GROUPS = 32 / LANES;             // points a warp holds at once
constexpr int CHUNK = 128;                     // columns of a lane group
constexpr int ROW_THREADS = 256;
constexpr int ROW_POINTS = ROW_THREADS / LANES;
constexpr int TILE_THREADS = 128;
constexpr int TILE_PPG = 4;                    // points a lane group holds
constexpr int TILE_POINTS = TILE_THREADS / LANES * TILE_PPG;
constexpr int SEED_GROUP = LANES;              // seeds merged together
constexpr int MAX_GRID_Y = 65535;
constexpr int MAX_SMEM = 48 * 1024;            // static launch limit
// Paths, as kernels/distance.py::PATHS numbers them.
constexpr int PATH_ROW = 0, PATH_TILE = 1;

// One lane's slice of one row for one chunk of CHUNK columns.
template <int VEC> struct Slice;
template <> struct Slice<4> {                   // quads l + 8 (4c + i)
  static constexpr int STEPS = 4;
  float4 v[4];
};
template <> struct Slice<1> {                   // columns l + 8 (16c + i)
  static constexpr int STEPS = 16;
  float v[16];
};

template <bool SMEM>
__device__ __forceinline__ void load_slice(Slice<4>& s, const float* row,
                                           int c, int l, int n) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const int nv = n >> 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = l + LANES * (4 * c + i);
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    s.v[i] = v < nv ? (SMEM ? r4[v] : __ldg(r4 + v)) : z;
  }
}

template <bool SMEM>
__device__ __forceinline__ void load_slice(Slice<1>& s, const float* row,
                                           int c, int l, int n) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int j = l + LANES * (16 * c + i);
    s.v[i] = j < n ? (SMEM ? row[j] : __ldg(row + j)) : 0.0f;
  }
}

// Step i of a lane's slice of a shared-memory row (the tile path reads a
// seed one step at a time): a column quad (vec 4) or a column (vec 1).
template <int VEC> struct Step;
template <> struct Step<4> {
  static __device__ __forceinline__ float4 load(const float* row, int c,
                                                int i, int l, int n) {
    const int v = l + LANES * (4 * c + i);
    return v < (n >> 2) ? reinterpret_cast<const float4*>(row)[v]
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
};
template <> struct Step<1> {
  static __device__ __forceinline__ float load(const float* row, int c,
                                               int i, int l, int n) {
    const int j = l + LANES * (16 * c + i);
    return j < n ? row[j] : 0.0f;
  }
};

// One step of a lane's fmaf chain, columns in ascending order.
__device__ __forceinline__ float fma_step(float acc, const float4& x,
                                          const float4& s) {
  acc = fmaf(x.x, s.x, acc);
  acc = fmaf(x.y, s.y, acc);
  acc = fmaf(x.z, s.z, acc);
  return fmaf(x.w, s.w, acc);
}

__device__ __forceinline__ float fma_step(float acc, float x, float s) {
  return fmaf(x, s, acc);
}

// The lane's fmaf chain over one chunk: its steps in ascending order.
template <int VEC>
__device__ __forceinline__ float chain(float acc, const Slice<VEC>& x,
                                       const Slice<VEC>& s) {
#pragma unroll
  for (int i = 0; i < Slice<VEC>::STEPS; ++i) {
    acc = fma_step(acc, x.v[i], s.v[i]);
  }
  return acc;
}

// The tree over a lane group, all lanes ending with the sum.
__device__ __forceinline__ float group_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(FULL, v, 4));
  v = __fadd_rn(v, __shfl_xor_sync(FULL, v, 2));
  v = __fadd_rn(v, __shfl_xor_sync(FULL, v, 1));
  return v;
}

// The same tree as a reduce-scatter over SEED_GROUP seeds: a[j] is this
// lane's partial of seed j; lane l ends with seed l's sum.  At each level
// a lane keeps the half of its seeds whose index bit matches its own lane
// bit and adds its partner's partials of them.
__device__ __forceinline__ float group_scatter_sum(const float (&a)[8],
                                                   int l) {
  const bool b2 = l & 4, b1 = l & 2, b0 = l & 1;
  float h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float keep = b2 ? a[j + 4] : a[j];
    const float send = b2 ? a[j] : a[j + 4];
    h[j] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, 4));
  }
  float g[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float keep = b1 ? h[j + 2] : h[j];
    const float send = b1 ? h[j] : h[j + 2];
    g[j] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, 2));
  }
  const float keep = b0 ? g[1] : g[0];
  const float send = b0 ? g[0] : g[1];
  return __fadd_rn(keep, __shfl_xor_sync(FULL, send, 1));
}

__device__ __forceinline__ float finish(float sq_s, float sq_q, float dot) {
  const float d = __fsub_rn(__fadd_rn(sq_s, sq_q), __fmul_rn(2.0f, dot));
  return d < 0.0f ? 0.0f : d;  // clamp, keeping a NaN a NaN
}

// Row path: block (32-point range, seed); grid.y strides over the seeds.
template <int VEC>
__global__ void __launch_bounds__(ROW_THREADS)
seed_row_kernel(const float* __restrict__ points,
                const float* __restrict__ sq,
                const int32_t* __restrict__ idx, float* __restrict__ out,
                int m, int n, int k) {
  const int l = threadIdx.x & (LANES - 1);
  const int q = blockIdx.x * ROW_POINTS + threadIdx.x / LANES;
  const int qr = min(q, m - 1);
  const float* xrow = points + (size_t)qr * n;
  const int nchunks = max(1, (n + CHUNK - 1) / CHUNK);
  for (int s = blockIdx.y; s < k; s += gridDim.y) {
    // x's loads first: they do not wait for the seed index.
    Slice<VEC> x;
    load_slice<false>(x, xrow, 0, l, n);
    const float sq_q = __ldg(sq + qr);
    const int p = __ldg(idx + s);
    const bool ok = p >= 0 && p < m;
    const float* srow = points + (size_t)(ok ? p : 0) * n;
    const float sq_s = __ldg(sq + (ok ? p : 0));
    float acc = 0.0f;
    for (int c = 0;;) {
      Slice<VEC> sd;
      load_slice<false>(sd, srow, c, l, n);
      acc = chain(acc, x, sd);
      if (++c == nchunks) break;
      load_slice<false>(x, xrow, c, l, n);
    }
    acc = group_sum(acc);
    if (l == 0 && q < m) {
      out[(size_t)s * m + q] = ok ? finish(sq_s, sq_q, acc) : nanf("");
    }
  }
}

// Tile path: block (TILE_POINTS points, kt seeds).  Shared memory: the kt
// seed rows of n floats, then kt norms and kt flags.
template <int VEC, bool ONE_CHUNK>
__global__ void __launch_bounds__(TILE_THREADS, 4)
seed_tile_kernel(const float* __restrict__ points,
                 const float* __restrict__ sq,
                 const int32_t* __restrict__ idx, float* __restrict__ out,
                 int m, int n, int k, int kt, int quad_store) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  float* S_sq = S + (size_t)kt * n;
  int* S_ok = reinterpret_cast<int*>(S_sq + kt);
  const int tid = threadIdx.x;
  const int lane = tid & 31, l = lane & (LANES - 1), warp = tid >> 5;
  const int q0 = blockIdx.x * TILE_POINTS +
                 (warp * GROUPS + lane / LANES) * TILE_PPG;
  const int t0 = blockIdx.y * kt;
  const int kt_here = min(kt, k - t0);
  const int nchunks = max(1, (n + CHUNK - 1) / CHUNK);
  const float* xrow[TILE_PPG];
  float sq_q[TILE_PPG];
  Slice<VEC> x[TILE_PPG];
#pragma unroll
  for (int j = 0; j < TILE_PPG; ++j) {
    const int qr = min(q0 + j, m - 1);
    xrow[j] = points + (size_t)qr * n;
    if (ONE_CHUNK) load_slice<false>(x[j], xrow[j], 0, l, n);
    sq_q[j] = __ldg(sq + qr);
  }
  // Stage this block's seeds: warp w copies seeds w, w + 4, ...
  for (int s = warp; s < kt; s += TILE_THREADS / 32) {
    const int p = s < kt_here ? __ldg(idx + t0 + s) : -1;
    const bool ok = p >= 0 && p < m;
    const float* src = points + (size_t)(ok ? p : 0) * n;
    float* dst = S + (size_t)s * n;
    if (VEC == 4) {
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int v = lane; v < n / 4; v += 32) {
        reinterpret_cast<float4*>(dst)[v] =
            ok ? __ldg(reinterpret_cast<const float4*>(src) + v) : z;
      }
    } else {
      for (int j = lane; j < n; j += 32) dst[j] = ok ? __ldg(src + j) : 0.0f;
    }
    if (lane == 0) {
      S_sq[s] = ok ? __ldg(sq + p) : 0.0f;
      S_ok[s] = ok;
    }
  }
  __syncthreads();
  for (int s0 = 0; s0 < kt_here; s0 += SEED_GROUP) {
    float acc[TILE_PPG][SEED_GROUP];
#pragma unroll
    for (int j = 0; j < TILE_PPG; ++j) {
#pragma unroll
      for (int s = 0; s < SEED_GROUP; ++s) acc[j][s] = 0.0f;
    }
    for (int c = 0; c < nchunks; ++c) {
      if (!ONE_CHUNK) {
#pragma unroll
        for (int j = 0; j < TILE_PPG; ++j) {
          load_slice<false>(x[j], xrow[j], c, l, n);
        }
      }
#pragma unroll
      for (int s = 0; s < SEED_GROUP; ++s) {
        const float* srow = S + (size_t)(s0 + s) * n;
        // One shared read of a step of the seed feeds all TILE_PPG points;
        // each (point, seed) chain still runs over the columns in order.
#pragma unroll
        for (int i = 0; i < Slice<VEC>::STEPS; ++i) {
          const auto sd = Step<VEC>::load(srow, c, i, l, n);
#pragma unroll
          for (int j = 0; j < TILE_PPG; ++j) {
            acc[j][s] = fma_step(acc[j][s], x[j].v[i], sd);
          }
        }
      }
    }
    float r[TILE_PPG];
#pragma unroll
    for (int j = 0; j < TILE_PPG; ++j) r[j] = group_scatter_sum(acc[j], l);
    const int s = s0 + l;
    if (s < kt_here && q0 < m) {
      float v[TILE_PPG];
#pragma unroll
      for (int j = 0; j < TILE_PPG; ++j) {
        v[j] = S_ok[s] ? finish(S_sq[s], sq_q[j], r[j]) : nanf("");
      }
      float* o = out + (size_t)(t0 + s) * m + q0;
      if (quad_store && q0 + TILE_PPG <= m) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < TILE_PPG; ++j) {
          if (q0 + j < m) o[j] = v[j];
        }
      }
    }
  }
}

template <int VEC, bool ONE_CHUNK>
int launch_tile(const float* points, const float* sq, const int32_t* idx,
                float* out, int m, int n, int k, int kt, int quad_store,
                cudaStream_t st) {
  const size_t smem = (size_t)kt * n * sizeof(float) + 8 * (size_t)kt;
  const dim3 grid((m + TILE_POINTS - 1) / TILE_POINTS, (k + kt - 1) / kt);
  seed_tile_kernel<VEC, ONE_CHUNK><<<grid, TILE_THREADS, smem, st>>>(
      points, sq, idx, out, m, n, k, kt, quad_store);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int distance_seed_rows(const float* points, const float* sq,
                                  const int32_t* idx, float* out, int m,
                                  int n, int k, int path, int vec, int kt,
                                  void* stream) {
  if (m <= 0 || k <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec != 1 && vec != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4 && (n % 4 != 0 ||
                   reinterpret_cast<uintptr_t>(points) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (path == PATH_ROW) {
    const dim3 grid((m + ROW_POINTS - 1) / ROW_POINTS, min(k, MAX_GRID_Y));
    if (vec == 4) {
      seed_row_kernel<4><<<grid, ROW_THREADS, 0, st>>>(points, sq, idx, out,
                                                       m, n, k);
    } else {
      seed_row_kernel<1><<<grid, ROW_THREADS, 0, st>>>(points, sq, idx, out,
                                                       m, n, k);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (path != PATH_TILE || kt <= 0 || kt % SEED_GROUP != 0 ||
      (size_t)kt * n * sizeof(float) + 8 * (size_t)kt > MAX_SMEM ||
      (k + kt - 1) / kt > MAX_GRID_Y) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int quad_store = m % 4 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool one = n <= CHUNK;
  if (vec == 4) {
    return one ? launch_tile<4, true>(points, sq, idx, out, m, n, k, kt,
                                      quad_store, st)
               : launch_tile<4, false>(points, sq, idx, out, m, n, k, kt,
                                       quad_store, st);
  }
  return one ? launch_tile<1, true>(points, sq, idx, out, m, n, k, kt,
                                    quad_store, st)
             : launch_tile<1, false>(points, sq, idx, out, m, n, k, kt,
                                     quad_store, st);
}
