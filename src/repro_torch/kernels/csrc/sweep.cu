// Hand-written Hopper (sm_90a) kernels for the dense Approx-DPC path.
//
// Two kernels, each with a plain C entry point bound through ctypes
// (kernels/build.py) and a plain PyTorch version beside it
// (kernels/sweep.py) that does the same operations in the same order:
//
//   repro_fused_count_topk  per query row, the count of y rows within d_cut
//                           and the 8 nearest (d2, index) pairs
//   repro_masked_nn         per query row, the nearest strictly denser y row
//
// Launch contract: each entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError().  Ragged edges are
// masked here (i >= n, j >= m); inputs are never padded.
//
// Arithmetic: d2 = (x0-y0)^2, then + (xk-yk)^2 for k = 1..d-1 in order,
// with __fsub_rn / __fmul_rn / __fadd_rn so that nvcc cannot contract the
// sum into FMAs.  The plain PyTorch versions round the same operations in
// the same order, so kernel and plain version agree bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr int kRows = 128;          // query rows per block, one per thread
constexpr int kTileFloats = 8192;   // y coordinates staged per tile (32 KB)
constexpr int kMaxTileCols = 2048;  // columns per tile (K2 keys: 8 KB)
constexpr int kTopK = 8;            // FUSED_TOPK in kernels/sweep.py

__device__ __forceinline__ int tile_cols(int d) {
  const int c = kTileFloats / d;
  return c < kMaxTileCols ? c : kMaxTileCols;
}

// Squared distance of one pair.  D > 0: the query row sits in registers
// (xi is a local array, fully unrolled); D == 0: any d, xi in global memory.
template <int D>
__device__ __forceinline__ float pair_d2(const float* xi, const float* yc,
                                         int d) {
  float diff = __fsub_rn(xi[0], yc[0]);
  float acc = __fmul_rn(diff, diff);
  if constexpr (D > 0) {
#pragma unroll
    for (int k = 1; k < D; ++k) {
      diff = __fsub_rn(xi[k], yc[k]);
      acc = __fadd_rn(acc, __fmul_rn(diff, diff));
    }
  } else {
    for (int k = 1; k < d; ++k) {
      diff = __fsub_rn(xi[k], yc[k]);
      acc = __fadd_rn(acc, __fmul_rn(diff, diff));
    }
  }
  return acc;
}

// Insert (v, j) into the row's kept list, sorted lexicographically by
// (d2, index).  Fully unrolled, so the list lives in registers.
__device__ __forceinline__ void keep(float (&tv)[kTopK], int (&ti)[kTopK],
                                     float v, int j) {
#pragma unroll
  for (int s = 0; s < kTopK; ++s) {
    const bool lt = v < tv[s] || (v == tv[s] && j < ti[s]);
    const float ov = tv[s];
    const int oj = ti[s];
    tv[s] = lt ? v : ov;
    ti[s] = lt ? j : oj;
    v = lt ? ov : v;
    j = lt ? oj : j;
  }
}

// Stage y[j0 : j0+cols) (row-major, d floats each) into shared memory.
__device__ __forceinline__ void stage(float* tile, const float* y, int j0,
                                      int cols, int d) {
  const float* src = y + static_cast<size_t>(j0) * d;
  for (int t = threadIdx.x; t < cols * d; t += kRows) tile[t] = src[t];
}

// K1 — replaces the reference's ops.fused_sweep, i.e. sweep.tile_sweep with
// SweepSpec(count=True, nn="topk", k=8) (repro/kernels/sweep.py:432, body
// _make_sweep_kernel at :208).
//
// Bound: f32 CUDA-core issue.  Each pair costs about 3d+1 operations (d
// subtractions, d products, d-1 sums, the compare) and moves almost no
// memory: a block reads each y tile once from L2 into shared memory and
// every thread then reads it as a broadcast.  The design keeps the query
// row, the count and the sorted kept list in registers, so the inner loop
// is the distance, one compare for the count and one compare against the
// worst kept entry; the insertion runs only when a pair beats it, which
// after the first columns is rare.  One block owns 128 rows and loops over
// all column tiles, which replaces the TPU's sequential grid and its
// `first` flag: nothing is carried between blocks.
template <int D>
__global__ void __launch_bounds__(kRows)
    fused_count_topk_kernel(const float* __restrict__ x,
                            const float* __restrict__ y, int n, int m, int d,
                            float d2cut, int* __restrict__ count,
                            float* __restrict__ topv, int* __restrict__ topi) {
  __shared__ float tile[kTileFloats];
  if constexpr (D > 0) d = D;
  const int per_tile = tile_cols(d);
  const int i = blockIdx.x * kRows + threadIdx.x;
  const bool live = i < n;
  const int row = live ? i : n - 1;  // dead lanes compute, never write

  float xr[D > 0 ? D : 1];
  const float* xg = x + static_cast<size_t>(row) * d;
  if constexpr (D > 0) {
#pragma unroll
    for (int k = 0; k < D; ++k) xr[k] = xg[k];
  }

  float tv[kTopK];
  int ti[kTopK];
#pragma unroll
  for (int s = 0; s < kTopK; ++s) {
    tv[s] = CUDART_INF_F;
    ti[s] = INT_MAX;
  }
  int cnt = 0;

  for (int j0 = 0; j0 < m; j0 += per_tile) {
    const int cols = min(per_tile, m - j0);
    __syncthreads();
    stage(tile, y, j0, cols, d);
    __syncthreads();
    for (int c = 0; c < cols; ++c) {
      float d2;
      if constexpr (D > 0) {
        d2 = pair_d2<D>(xr, tile + c * D, D);
      } else {
        d2 = pair_d2<0>(xg, tile + c * d, d);
      }
      cnt += d2 < d2cut;
      if (d2 < tv[kTopK - 1]) keep(tv, ti, d2, j0 + c);
    }
  }

  if (!live) return;
  count[i] = cnt;
  const size_t o = static_cast<size_t>(i) * kTopK;
#pragma unroll
  for (int s = 0; s < kTopK; ++s) {
    topv[o + s] = tv[s];
    topi[o + s] = ti[s] == INT_MAX ? -1 : ti[s];
  }
}

// K2 — replaces the reference's dependent.masked_min_dist, i.e.
// sweep.tile_sweep with SweepSpec(nn="best1", key=True)
// (repro/kernels/dependent.py:42, lexicographic update at sweep.py:299-311).
//
// Bound: f32 CUDA-core issue, as K1: about 3d+1 operations for each pair
// whose column key is larger, and almost no memory traffic.  The design
// stages coordinates and keys of a column tile in shared memory, tests the
// key first and computes the distance only for denser columns, and keeps
// (best d2, index) in registers.  Columns are visited in ascending order
// and the update is a strict `<`, so among equal distances the lowest
// index wins: the reference's lexicographic (d2, col) rule.  Distances are
// direct differences on every pair, so the reference's top-4 re-rank,
// which only repaired the expanded form, has no counterpart.
template <int D>
__global__ void __launch_bounds__(kRows)
    masked_nn_kernel(const float* __restrict__ x,
                     const float* __restrict__ x_key,
                     const float* __restrict__ y,
                     const float* __restrict__ y_key, int n, int m, int d,
                     float* __restrict__ best_out, int* __restrict__ arg_out) {
  __shared__ float tile[kTileFloats];
  __shared__ float ktile[kMaxTileCols];
  if constexpr (D > 0) d = D;
  const int per_tile = tile_cols(d);
  const int i = blockIdx.x * kRows + threadIdx.x;
  const bool live = i < n;
  const int row = live ? i : n - 1;

  float xr[D > 0 ? D : 1];
  const float* xg = x + static_cast<size_t>(row) * d;
  if constexpr (D > 0) {
#pragma unroll
    for (int k = 0; k < D; ++k) xr[k] = xg[k];
  }
  const float key = x_key[row];

  float best = CUDART_INF_F;
  int arg = -1;
  for (int j0 = 0; j0 < m; j0 += per_tile) {
    const int cols = min(per_tile, m - j0);
    __syncthreads();
    stage(tile, y, j0, cols, d);
    for (int t = threadIdx.x; t < cols; t += kRows) ktile[t] = y_key[j0 + t];
    __syncthreads();
    for (int c = 0; c < cols; ++c) {
      if (!(ktile[c] > key)) continue;
      float d2;
      if constexpr (D > 0) {
        d2 = pair_d2<D>(xr, tile + c * D, D);
      } else {
        d2 = pair_d2<0>(xg, tile + c * d, d);
      }
      if (d2 < best) {
        best = d2;
        arg = j0 + c;
      }
    }
  }

  if (!live) return;
  best_out[i] = best;
  arg_out[i] = arg;
}

}  // namespace

// d = 1..8 get a register-resident query row; any other d takes the
// generic instantiation.
#define REPRO_DISPATCH_D(d, LAUNCH) \
  switch (d) {                      \
    case 1: LAUNCH(1); break;       \
    case 2: LAUNCH(2); break;       \
    case 3: LAUNCH(3); break;       \
    case 4: LAUNCH(4); break;       \
    case 5: LAUNCH(5); break;       \
    case 6: LAUNCH(6); break;       \
    case 7: LAUNCH(7); break;       \
    case 8: LAUNCH(8); break;       \
    default: LAUNCH(0); break;      \
  }

extern "C" int repro_fused_count_topk(const float* x, const float* y, int n,
                                      int m, int d, float d2cut, int* count,
                                      float* topv, int* topi, void* stream) {
  if (n > 0) {
    const dim3 grid((n + kRows - 1) / kRows);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(D)                                                  \
  fused_count_topk_kernel<D><<<grid, kRows, 0, s>>>(x, y, n, m, d, d2cut, \
                                                    count, topv, topi)
    REPRO_DISPATCH_D(d, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_masked_nn(const float* x, const float* x_key,
                               const float* y, const float* y_key, int n,
                               int m, int d, float* best, int* arg,
                               void* stream) {
  if (n > 0) {
    const dim3 grid((n + kRows - 1) / kRows);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(D)                                                   \
  masked_nn_kernel<D><<<grid, kRows, 0, s>>>(x, x_key, y, y_key, n, m, d, \
                                             best, arg)
    REPRO_DISPATCH_D(d, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
