// Hand-written Hopper (sm_90a) kernels for the Approx-DPC, Ex-DPC, Scan and
// S-Approx-DPC paths, dense and block-sparse, for the sliding-window stream
// and for the distributed Ex-DPC shard phases.
//
// Eleven kernels, each with a plain C entry point bound through ctypes
// (kernels/build.py) and a plain PyTorch version beside it
// (kernels/sweep.py) that does the same operations in the same order:
//
//   repro_fused_count_topk     per query row, the count of y rows within
//                              d_cut and the 8 nearest (d2, index) pairs,
//                              optionally among the selected columns only
//   repro_worklist_count_topk  the same, over the tile pairs of a worklist
//                              (kernels/blocksparse.py)
//   repro_masked_nn            per query row, the nearest strictly denser
//                              y row
//   repro_range_count          per query row, the count of y rows within
//                              d_cut (the stream's fresh counts)
//   repro_range_count_signed   per query row, the sum of the signs of the
//                              y rows within d_cut (the stream's rho repair)
//   repro_gather_masked_nn     per slot, the nearest strictly denser table
//                              row to table[slot] (the stream's maxima)
//   repro_prefix_nn            per row of a table sorted by descending
//                              key, the nearest earlier row
//   repro_worklist_range_count per query row, the count within d_cut over
//                              the in-d_cut pairs of a count-only worklist
//   repro_worklist_masked_nn   per query row, the nearest strictly denser
//                              y row, walking a best-1 ring worklist
//   repro_halo_range_count     per query row, the count within d_cut of the
//                              window rows inside its [start, end) spans
//   repro_halo_masked_nn       per query row, the nearest strictly denser
//                              window row within d_cut inside its spans
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
constexpr int kWlRows = 256;        // K3 rows per row tile: BLOCK_N in
                                    // kernels/blocksparse.py
constexpr int kWlCols = 512;        // K3 columns per column tile: BLOCK_M
constexpr int kSplitBlocks = 2048;  // K4/K6 split the columns until about
                                    // this many blocks fill the card

__host__ __device__ __forceinline__ int tile_cols(int d) {
  const int c = kTileFloats / d;
  return c < kMaxTileCols ? c : kMaxTileCols;
}

// Columns per block of a column-split grid (K4, K6): a whole number of
// staged tiles, few enough that rows x column chunks make about
// kSplitBlocks blocks, so a few thousand query rows still fill 132 SMs.
int split_chunk(int rows, int m, int d) {
  const int per_tile = tile_cols(d);
  const int tiles = (m + per_tile - 1) / per_tile;
  const int row_blocks = (rows + kRows - 1) / kRows;
  int chunks = (kSplitBlocks + row_blocks - 1) / row_blocks;
  if (chunks > tiles) chunks = tiles;
  if (chunks < 1) chunks = 1;
  return (tiles + chunks - 1) / chunks * per_tile;
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

// Stage y[j0 : j0+cols) (row-major, d floats each) into shared memory,
// every thread of the block taking a share.
__device__ __forceinline__ void stage(float* tile, const float* y, int j0,
                                      int cols, int d) {
  const float* src = y + static_cast<size_t>(j0) * d;
  for (int t = threadIdx.x; t < cols * d; t += blockDim.x) tile[t] = src[t];
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
//
// kSel (S-Approx-DPC's nn_sel gate, repro/kernels/sweep.py:296-297): a
// column whose sel byte is 0 never enters the kept 8; the count ignores the
// gate.  The gate's bytes are staged with each tile and tested before the
// insertion; without it (kSel false) the kernel is the ungated code.
template <int D, bool kSel>
__global__ void __launch_bounds__(kRows)
    fused_count_topk_kernel(const float* __restrict__ x,
                            const float* __restrict__ y, int n, int m, int d,
                            float d2cut,
                            const unsigned char* __restrict__ sel,
                            int* __restrict__ count,
                            float* __restrict__ topv, int* __restrict__ topi) {
  __shared__ float tile[kTileFloats];
  __shared__ unsigned char stile[kSel ? kMaxTileCols : 1];
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
    if constexpr (kSel) {
      for (int t = threadIdx.x; t < cols; t += kRows) stile[t] = sel[j0 + t];
    }
    __syncthreads();
    for (int c = 0; c < cols; ++c) {
      float d2;
      if constexpr (D > 0) {
        d2 = pair_d2<D>(xr, tile + c * D, D);
      } else {
        d2 = pair_d2<0>(xg, tile + c * d, d);
      }
      cnt += d2 < d2cut;
      if constexpr (kSel) {
        if (stile[c] && d2 < tv[kTopK - 1]) keep(tv, ti, d2, j0 + c);
      } else {
        if (d2 < tv[kTopK - 1]) keep(tv, ti, d2, j0 + c);
      }
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

// K3 — replaces the reference's ops.fused_sweep on a worklist, i.e.
// sweep.tile_sweep with SweepSpec(count=True, nn="topk", k=8) over the
// PrefetchScalarGridSpec worklist grid (repro/kernels/sweep.py:432, body
// _make_sweep_kernel at :208, liveness at :250-258).
//
// Bound: f32 CUDA-core issue on the *live* pairs, about 3d+1 operations each,
// as K1; the worklist and the tiles it stages are small next to that.  Most
// kept entries are dead by the time a row tile reaches them, so the design
// decides liveness per entry before any staging: the block walks its CSR
// segment row_ptr[t] .. row_ptr[t+1] in the stored order (ascending lb),
// reading (column tile, in_cut, lb) from a shared-memory copy of 256 entries
// at a time, and each thread votes whether the entry can still change its
// row: the count if in_cut, the kept-k if lb <= the row's worst kept d2.
// Only if some thread votes yes (__syncthreads_or) does the block stage the
// 512-column tile (in chunks of kTileFloats floats, so the 48 KB static limit
// holds for any d) and compute.  The skip is exact: a pair's d2 >= lb, so
// with lb > the row's worst kept d2 it cannot enter the row's kept set; an
// entry that is not in_cut holds no pair within d_cut.  The per-row vote is
// at least as tight as the reference's tile-wide lb <= max(topv).
//
// Column tiles arrive in ring order, not index order, so an equal-d2 pair of
// a lower index can come later: the insertion guard is lexicographic on
// (d2, index), and the kept set equals K1's.  The count adds integers, so
// its order does not matter.  One block owns one row tile and its whole
// segment, which replaces the TPU's 1-D worklist grid and its `first` flag.
// `live` (optional) gets the number of entries each block computed.
//
// kSel gates the kept 8 as in K1.  The per-row vote stays exact: a gated
// column never enters, so lb <= tv[7] still bounds what can change a row,
// and until a row has seen 8 selected columns its tv[7] is +inf and every
// entry stays live for it (the worklist's k-NN ring is built on the
// selected columns' counts, kernels/blocksparse.py).
template <int D, bool kSel>
__global__ void __launch_bounds__(kWlRows)
    worklist_count_topk_kernel(const float* __restrict__ x,
                               const float* __restrict__ y, int n, int m,
                               int d, float d2cut,
                               const unsigned char* __restrict__ sel,
                               const int* __restrict__ row_ptr,
                               const int* __restrict__ col_tile,
                               const unsigned char* __restrict__ in_cut,
                               const float* __restrict__ lb,
                               int* __restrict__ count,
                               float* __restrict__ topv,
                               int* __restrict__ topi,
                               int* __restrict__ live_out) {
  __shared__ float tile[kTileFloats];
  __shared__ unsigned char stile[kSel ? kWlCols : 1];
  __shared__ int s_col[kWlRows];
  __shared__ float s_lb[kWlRows];
  __shared__ int s_cut[kWlRows];
  if constexpr (D > 0) d = D;
  const int per_chunk = min(kWlCols, kTileFloats / d);
  const int t = blockIdx.x;
  const int i = t * kWlRows + threadIdx.x;
  const bool live = i < n;
  const int row = live ? i : n - 1;  // dead lanes compute, never vote

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
  int visited = 0;

  const int e0 = row_ptr[t];
  const int e1 = row_ptr[t + 1];
  for (int base = e0; base < e1; base += kWlRows) {
    const int ne = min(kWlRows, e1 - base);
    __syncthreads();
    if (threadIdx.x < ne) {
      s_col[threadIdx.x] = col_tile[base + threadIdx.x];
      s_lb[threadIdx.x] = lb[base + threadIdx.x];
      s_cut[threadIdx.x] = in_cut[base + threadIdx.x];
    }
    __syncthreads();
    for (int e = 0; e < ne; ++e) {
      const int cut = s_cut[e];
      const bool nn_live = live && s_lb[e] <= tv[kTopK - 1];
      if (!__syncthreads_or(cut || nn_live)) continue;
      ++visited;
      const int j0 = s_col[e] * kWlCols;
      const int j1 = min(j0 + kWlCols, m);
      for (int c0 = j0; c0 < j1; c0 += per_chunk) {
        const int cols = min(per_chunk, j1 - c0);
        if (c0 != j0) __syncthreads();
        stage(tile, y, c0, cols, d);
        if constexpr (kSel) {
          for (int t = threadIdx.x; t < cols; t += kWlRows)
            stile[t] = sel[c0 + t];
        }
        __syncthreads();
        for (int c = 0; c < cols; ++c) {
          float d2;
          if constexpr (D > 0) {
            d2 = pair_d2<D>(xr, tile + c * D, D);
          } else {
            d2 = pair_d2<0>(xg, tile + c * d, d);
          }
          cnt += cut & (d2 < d2cut);
          const int j = c0 + c;
          const bool better = d2 < tv[kTopK - 1] ||
                              (d2 == tv[kTopK - 1] && j < ti[kTopK - 1]);
          if constexpr (kSel) {
            if (stile[c] && better) keep(tv, ti, d2, j);
          } else {
            if (better) keep(tv, ti, d2, j);
          }
        }
      }
    }
  }

  if (live_out != nullptr && threadIdx.x == 0) live_out[t] = visited;
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

// K4 — replaces the reference's density.range_count, i.e. sweep.tile_sweep
// with SweepSpec(count=True) (repro/kernels/density.py:27, pallas_call at
// repro/kernels/sweep.py:432), reached through ops.local_density_xy.
//
// Bound: f32 CUDA-core issue, about 3d+1 operations per pair; the stream
// calls it with a few thousand inserted rows against the whole window, so
// a one-block-per-128-rows grid would hold 32 blocks on 132 SMs.  The
// design splits the columns too (split_chunk): each block owns 128 rows
// and one column chunk, stages it tile by tile in shared memory, counts in
// a register and adds its partial count with one integer atomicAdd, which
// is exact and independent of the order in which blocks finish.
template <int D>
__global__ void __launch_bounds__(kRows)
    range_count_kernel(const float* __restrict__ x,
                       const float* __restrict__ y, int n, int m, int d,
                       float d2cut, int chunk, int* __restrict__ count) {
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

  const int c_begin = blockIdx.y * chunk;
  const int c_end = min(c_begin + chunk, m);
  int cnt = 0;
  for (int j0 = c_begin; j0 < c_end; j0 += per_tile) {
    const int cols = min(per_tile, c_end - j0);
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
    }
  }
  if (live && cnt) atomicAdd(count + i, cnt);
}

// K5 — replaces the reference's density.range_count_signed, i.e.
// sweep.tile_sweep with SweepSpec(count=True, signed=True)
// (repro/kernels/density.py:46, pallas_call at repro/kernels/sweep.py:432),
// reached through ops.local_density_delta.
//
// Bound: f32 CUDA-core issue, about 3d+1 operations per pair.  The stream
// calls it with the whole window as rows (2^20) against the insert/evict
// batch (a few thousand columns with their signs), so one thread per row
// already fills the card: no column split.  Each block stages a tile of the
// batch and its signs in shared memory and adds sign_j to a register sum
// for each column within d_cut, in column order.  The signs are +1, -1 or
// 0, so every partial sum is an integer below 2^24 and exact in f32: the
// order of the sum does not change its bits.
template <int D>
__global__ void __launch_bounds__(kRows)
    range_count_signed_kernel(const float* __restrict__ x,
                              const float* __restrict__ y,
                              const float* __restrict__ signs, int n, int m,
                              int d, float d2cut, float* __restrict__ out) {
  __shared__ float tile[kTileFloats];
  __shared__ float stile[kMaxTileCols];
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

  float acc = 0.0f;
  for (int j0 = 0; j0 < m; j0 += per_tile) {
    const int cols = min(per_tile, m - j0);
    __syncthreads();
    stage(tile, y, j0, cols, d);
    for (int t = threadIdx.x; t < cols; t += kRows) stile[t] = signs[j0 + t];
    __syncthreads();
    for (int c = 0; c < cols; ++c) {
      float d2;
      if constexpr (D > 0) {
        d2 = pair_d2<D>(xr, tile + c * D, D);
      } else {
        d2 = pair_d2<0>(xg, tile + c * d, d);
      }
      if (d2 < d2cut) acc = __fadd_rn(acc, stile[c]);
    }
  }
  if (live) out[i] = acc;
}

// K6 — replaces the reference's sweep.gather_nn (repro/kernels/sweep.py:491,
// pallas_call at :510), reached through ops.dependent_masked_gather.
//
// Bound: f32 CUDA-core issue, as K2: a key test per pair and about 3d+1
// operations for each pair whose column is denser.  The stream calls it
// with the dirty cell maxima as rows (a few hundred to a few hundred
// thousand) against the whole window.  The TPU kernel gathers its query
// rows with one-hot matrix products on a doubled column grid; here each
// thread loads table[slot] and keys[slot] directly.  Since a few hundred
// rows fill only a few blocks, the columns are split across blocks
// (split_chunk), and each block's per-row (best d2, index) merges with one
// 64-bit atomicMin on (d2's bits << 32 | index).  A d2 is a sum of squares,
// never negative, and non-negative floats order as their bits do, so the
// merge takes the lexicographic (d2, index) minimum: inside a chunk the
// update is a strict `<` over ascending columns, so the lowest index wins
// among equal distances, and across chunks the atomic keeps the lowest
// (d2, index) in any order.  Slots outside [0, m) are padding: their key is
// +inf, so no column is denser, and they decode to (inf, -1).
template <int D>
__global__ void __launch_bounds__(kRows)
    gather_masked_nn_kernel(const float* __restrict__ table,
                            const float* __restrict__ keys,
                            const int* __restrict__ slots, int q, int m,
                            int d, int chunk,
                            unsigned long long* __restrict__ packed) {
  __shared__ float tile[kTileFloats];
  __shared__ float ktile[kMaxTileCols];
  if constexpr (D > 0) d = D;
  const int per_tile = tile_cols(d);
  const int i = blockIdx.x * kRows + threadIdx.x;
  const int slot = i < q ? slots[i] : -1;
  const bool live = slot >= 0 && slot < m;
  const int row = live ? slot : 0;

  float xr[D > 0 ? D : 1];
  const float* xg = table + static_cast<size_t>(row) * d;
  if constexpr (D > 0) {
#pragma unroll
    for (int k = 0; k < D; ++k) xr[k] = xg[k];
  }
  const float key = live ? keys[row] : CUDART_INF_F;

  const int c_begin = blockIdx.y * chunk;
  const int c_end = min(c_begin + chunk, m);
  float best = CUDART_INF_F;
  int arg = -1;
  for (int j0 = c_begin; j0 < c_end; j0 += per_tile) {
    const int cols = min(per_tile, c_end - j0);
    __syncthreads();
    stage(tile, table, j0, cols, d);
    for (int t = threadIdx.x; t < cols; t += kRows) ktile[t] = keys[j0 + t];
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
  if (arg >= 0) {
    const unsigned long long p =
        (static_cast<unsigned long long>(__float_as_uint(best)) << 32) |
        static_cast<unsigned int>(arg);
    atomicMin(packed + i, p);
  }
}

// K6's epilogue: (d2 bits << 32 | index) -> (best d2, index); the all-ones
// initial value (no denser row, or a padding slot) -> (inf, -1).
__global__ void gather_nn_decode_kernel(
    const unsigned long long* __restrict__ packed, int q,
    float* __restrict__ best, int* __restrict__ arg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const unsigned long long p = packed[i];
  if (p == ~0ULL) {
    best[i] = CUDART_INF_F;
    arg[i] = -1;
  } else {
    best[i] = __uint_as_float(static_cast<unsigned int>(p >> 32));
    arg[i] = static_cast<int>(p & 0xffffffffULL);
  }
}

// K7 — replaces the reference's dependent.prefix_min_dist, i.e.
// sweep.tile_sweep with SweepSpec(nn="best1", prefix=True)
// (repro/kernels/dependent.py:28, the j < i mask at sweep.py:288-291, the
// triangular worklist at sweep.py:324-339), reached through
// ops.dependent_prefix.
//
// Per row i of a table sorted by descending key, the nearest row j < i: Def. 2
// with "denser" read as "earlier".  Bound: f32 CUDA-core issue, about 3d+1
// operations for each of the n(n-1)/2 pairs, and almost no memory traffic.
// The design is K2's without the key: one thread per row, kRows rows per
// block, the columns staged tile by tile in shared memory, (best d2, index)
// in registers, ascending columns and a strict `<`, so the lowest index
// wins among equal distances.  A block stops at the columns before its last
// row, so the work is the triangle; the blocks are scheduled heaviest first
// (a reversed blockIdx), so the last wave is not one long tail block.  Only
// the diagonal tile diverges (each thread stops at its own row).  The delta
// is the correctly rounded square root, as torch.sqrt computes it.
template <int D>
__global__ void __launch_bounds__(kRows)
    prefix_nn_kernel(const float* __restrict__ x, int n, int d,
                     float* __restrict__ delta_out, int* __restrict__ arg_out) {
  __shared__ float tile[kTileFloats];
  if constexpr (D > 0) d = D;
  const int per_tile = tile_cols(d);
  const int b = gridDim.x - 1 - blockIdx.x;  // heaviest blocks first
  const int i = b * kRows + threadIdx.x;
  const bool live = i < n;
  const int row = live ? i : n - 1;  // dead lanes compute, never write

  float xr[D > 0 ? D : 1];
  const float* xg = x + static_cast<size_t>(row) * d;
  if constexpr (D > 0) {
#pragma unroll
    for (int k = 0; k < D; ++k) xr[k] = xg[k];
  }

  // columns before the block's last row: min(n, (b + 1) * kRows) - 1
  const int m = min(n, (b + 1) * kRows) - 1;
  float best = CUDART_INF_F;
  int arg = -1;
  for (int j0 = 0; j0 < m; j0 += per_tile) {
    const int cols = min(per_tile, m - j0);
    __syncthreads();
    stage(tile, x, j0, cols, d);
    __syncthreads();
    const int lim = min(cols, row - j0);  // this row's columns j < row
    for (int c = 0; c < lim; ++c) {
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
  delta_out[i] = __fsqrt_rn(best);
  arg_out[i] = arg;
}

// K8 — replaces the reference's density.range_count on a worklist, i.e.
// sweep.tile_sweep with SweepSpec(count=True) over a count-only FlatWorklist
// (PallasBackend.range_count(layout="block-sparse"),
// repro/kernels/backend.py:616-626; pallas_call at sweep.py:432), reached
// through ops.local_density_xy(worklist=...): the distributed gather
// strategy's block-sparse rho phase, shard rows against the gathered table.
//
// Bound: f32 CUDA-core issue, about 3d+1 operations for each pair of an
// in-d_cut entry, and little memory: the worklist and one staging of each
// kept column tile per row tile.  The design is K3's CSR walk with the
// kept-k taken out: one block per 256-row tile walks its segment, stages the
// 512-column tile of every in_cut entry in shared memory and counts in a
// register; an entry that is not in_cut (the force-kept least-lb pair of a
// tile with none in d_cut) holds no pair within d_cut and is skipped
// whole.  Nothing is voted, so the walk is the worklist itself.
template <int D>
__global__ void __launch_bounds__(kWlRows)
    worklist_range_count_kernel(const float* __restrict__ x,
                                const float* __restrict__ y, int n, int m,
                                int d, float d2cut,
                                const int* __restrict__ row_ptr,
                                const int* __restrict__ col_tile,
                                const unsigned char* __restrict__ in_cut,
                                int* __restrict__ count) {
  __shared__ float tile[kTileFloats];
  __shared__ int s_col[kWlRows];
  __shared__ int s_cut[kWlRows];
  if constexpr (D > 0) d = D;
  const int per_chunk = min(kWlCols, kTileFloats / d);
  const int t = blockIdx.x;
  const int i = t * kWlRows + threadIdx.x;
  const bool live = i < n;
  const int row = live ? i : n - 1;  // dead lanes compute, never write

  float xr[D > 0 ? D : 1];
  const float* xg = x + static_cast<size_t>(row) * d;
  if constexpr (D > 0) {
#pragma unroll
    for (int k = 0; k < D; ++k) xr[k] = xg[k];
  }

  int cnt = 0;
  const int e0 = row_ptr[t];
  const int e1 = row_ptr[t + 1];
  for (int base = e0; base < e1; base += kWlRows) {
    const int ne = min(kWlRows, e1 - base);
    __syncthreads();
    if (threadIdx.x < ne) {
      s_col[threadIdx.x] = col_tile[base + threadIdx.x];
      s_cut[threadIdx.x] = in_cut[base + threadIdx.x];
    }
    __syncthreads();
    for (int e = 0; e < ne; ++e) {
      if (!s_cut[e]) continue;        // the same for every thread
      const int j0 = s_col[e] * kWlCols;
      const int j1 = min(j0 + kWlCols, m);
      for (int c0 = j0; c0 < j1; c0 += per_chunk) {
        const int cols = min(per_chunk, j1 - c0);
        __syncthreads();
        stage(tile, y, c0, cols, d);
        __syncthreads();
        for (int c = 0; c < cols; ++c) {
          float d2;
          if constexpr (D > 0) {
            d2 = pair_d2<D>(xr, tile + c * D, D);
          } else {
            d2 = pair_d2<0>(xg, tile + c * d, d);
          }
          cnt += d2 < d2cut;
        }
      }
    }
  }
  if (live) count[i] = cnt;
}

// K9 — replaces the reference's dependent.masked_min_dist on a worklist,
// i.e. sweep.tile_sweep with SweepSpec(nn="best1", key=True) over the best-1
// ring (PallasBackend.denser_nn(layout="block-sparse"),
// repro/kernels/backend.py:639-647; liveness at sweep.py:250-258, the
// lexicographic update at :303-311), reached through
// ops.dependent_masked(worklist=...): the distributed gather strategy's
// block-sparse delta phase and the unresolved-row fallback of both
// strategies on a block-sparse plan.
//
// Bound: f32 CUDA-core issue: a key test for each pair of an entry the walk
// computes and about 3d+1 operations for each denser one.  The ring keeps
// every tile pair, so what bounds the work is where the walk stops.  The
// design: one block per 256-row tile walks its ring in the stored order
// (ascending lb, 256 entries at a time through shared memory); each thread
// keeps (best d2, index) in registers and votes whether the entry can still
// change its row (lb <= best, since a pair's d2 >= lb and an equal d2 of a
// lower index may still win).  The first entry no thread votes for ends the
// walk: every later entry has a larger lb and no best can grow.  Until a row
// has a candidate its best is +inf, so a tile holding a density peak walks
// its whole ring; a row keyed +inf (padding) has no denser column and never
// votes.  A voted entry's 512 columns and keys are staged in shared memory;
// the key is tested before the distance.  Columns arrive in ring order, so
// the update is the lexicographic (d2, index) minimum, which equals K2's
// ascending strict `<`.  `live` (optional) gets the entries each block
// computed.
template <int D>
__global__ void __launch_bounds__(kWlRows)
    worklist_masked_nn_kernel(const float* __restrict__ x,
                              const float* __restrict__ x_key,
                              const float* __restrict__ y,
                              const float* __restrict__ y_key, int n, int m,
                              int d, const int* __restrict__ row_ptr,
                              const int* __restrict__ col_tile,
                              const float* __restrict__ lb,
                              float* __restrict__ best_out,
                              int* __restrict__ arg_out,
                              int* __restrict__ live_out) {
  __shared__ float tile[kTileFloats];
  __shared__ float ktile[kWlCols];
  __shared__ int s_col[kWlRows];
  __shared__ float s_lb[kWlRows];
  if constexpr (D > 0) d = D;
  const int per_chunk = min(kWlCols, kTileFloats / d);
  const int t = blockIdx.x;
  const int i = t * kWlRows + threadIdx.x;
  const bool live = i < n;
  const int row = live ? i : n - 1;

  float xr[D > 0 ? D : 1];
  const float* xg = x + static_cast<size_t>(row) * d;
  if constexpr (D > 0) {
#pragma unroll
    for (int k = 0; k < D; ++k) xr[k] = xg[k];
  }
  const float key = x_key[row];
  const bool seeks = live && key < CUDART_INF_F;

  float best = CUDART_INF_F;
  int arg = INT_MAX;
  int visited = 0;
  bool done = false;
  const int e0 = row_ptr[t];
  const int e1 = row_ptr[t + 1];
  for (int base = e0; base < e1 && !done; base += kWlRows) {
    const int ne = min(kWlRows, e1 - base);
    __syncthreads();
    if (threadIdx.x < ne) {
      s_col[threadIdx.x] = col_tile[base + threadIdx.x];
      s_lb[threadIdx.x] = lb[base + threadIdx.x];
    }
    __syncthreads();
    for (int e = 0; e < ne; ++e) {
      if (!__syncthreads_or(seeks && s_lb[e] <= best)) {
        done = true;                  // the same for every thread
        break;
      }
      ++visited;
      const int j0 = s_col[e] * kWlCols;
      const int j1 = min(j0 + kWlCols, m);
      for (int c0 = j0; c0 < j1; c0 += per_chunk) {
        const int cols = min(per_chunk, j1 - c0);
        __syncthreads();
        stage(tile, y, c0, cols, d);
        for (int c = threadIdx.x; c < cols; c += kWlRows)
          ktile[c] = y_key[c0 + c];
        __syncthreads();
        for (int c = 0; c < cols; ++c) {
          if (!(ktile[c] > key)) continue;
          float d2;
          if constexpr (D > 0) {
            d2 = pair_d2<D>(xr, tile + c * D, D);
          } else {
            d2 = pair_d2<0>(xg, tile + c * d, d);
          }
          const int j = c0 + c;
          if (d2 < best || (d2 == best && j < arg)) {
            best = d2;
            arg = j;
          }
        }
      }
    }
  }

  if (live_out != nullptr && threadIdx.x == 0) live_out[t] = visited;
  if (!live) return;
  const bool found = best < CUDART_INF_F;
  best_out[i] = best;
  arg_out[i] = found ? arg : -1;
}

// K10 — replaces the reference's density.range_count_halo, i.e.
// sweep.tile_sweep with SweepSpec(count=True, span=True)
// (repro/kernels/density.py:68, the span mask at sweep.py:199-205,
// pallas_call at :432), reached through ops.halo_density: the distributed
// halo strategy's rho phase, each shard row against its window.
//
// Bound: f32 CUDA-core issue, about 3d+1 operations for each column inside
// a row's spans, and the window columns read once where neighbouring rows
// share them.  A TPU tile cannot gather, so the TPU kernel masks dense
// (row tile x window tile) blocks with the spans: rows x W pairs, quadratic
// in the shard.  Here each thread owns one row and walks its S spans
// [start, end) directly (clipped to [0, W): empty and negative spans count
// nothing), reading the window rows from global memory: the work is the
// spans' lengths.  Rows are grid-sorted, so a warp's rows mostly share one
// cell and its spans, and the reads coalesce into broadcasts.  The spans of
// a row are disjoint (distinct candidate-cell prefixes), so the count is the
// span mask's.
template <int D>
__global__ void __launch_bounds__(kRows)
    halo_range_count_kernel(const float* __restrict__ x,
                            const float* __restrict__ win,
                            const int* __restrict__ starts,
                            const int* __restrict__ ends, int n, int w,
                            int d, int s, float d2cut,
                            int* __restrict__ count) {
  const int i = blockIdx.x * kRows + threadIdx.x;
  if (i >= n) return;
  if constexpr (D > 0) d = D;
  float xr[D > 0 ? D : 1];
  const float* xg = x + static_cast<size_t>(i) * d;
  if constexpr (D > 0) {
#pragma unroll
    for (int k = 0; k < D; ++k) xr[k] = xg[k];
  }
  int cnt = 0;
  for (int k = 0; k < s; ++k) {
    const int a = max(starts[static_cast<size_t>(i) * s + k], 0);
    const int b = min(ends[static_cast<size_t>(i) * s + k], w);
    for (int j = a; j < b; ++j) {
      const float* yc = win + static_cast<size_t>(j) * d;
      float d2;
      if constexpr (D > 0) {
        d2 = pair_d2<D>(xr, yc, D);
      } else {
        d2 = pair_d2<0>(xg, yc, d);
      }
      cnt += d2 < d2cut;
    }
  }
  count[i] = cnt;
}

// K11 — replaces the reference's dependent.masked_min_dist_halo, i.e.
// sweep.tile_sweep with SweepSpec(nn="best1", key=True, span=True,
// nn_dcut=True) (repro/kernels/dependent.py:56, the d_cut mask at
// sweep.py:294-295, pallas_call at :432), reached through
// ops.halo_dependent: the distributed halo strategy's delta phase.
//
// Bound: f32 CUDA-core issue, a key test for each column inside a row's
// spans and about 3d+1 operations for each denser one.  The design is K10's
// span walk with three conditions: the window key strictly above the row's,
// d2 < d_cut^2 (stencil semantics: a row with no such column is left to the
// caller's global fallback), and the lexicographic (d2, window index)
// minimum.  It writes delta = __fsqrt_rn(best d2) (torch.sqrt's rounding),
// the window-local parent (-1 where none) and found.
template <int D>
__global__ void __launch_bounds__(kRows)
    halo_masked_nn_kernel(const float* __restrict__ x,
                          const float* __restrict__ x_key,
                          const float* __restrict__ win,
                          const float* __restrict__ w_key,
                          const int* __restrict__ starts,
                          const int* __restrict__ ends, int n, int w, int d,
                          int s, float d2cut, float* __restrict__ delta_out,
                          int* __restrict__ arg_out,
                          unsigned char* __restrict__ found_out) {
  const int i = blockIdx.x * kRows + threadIdx.x;
  if (i >= n) return;
  if constexpr (D > 0) d = D;
  float xr[D > 0 ? D : 1];
  const float* xg = x + static_cast<size_t>(i) * d;
  if constexpr (D > 0) {
#pragma unroll
    for (int k = 0; k < D; ++k) xr[k] = xg[k];
  }
  const float key = x_key[i];
  float best = CUDART_INF_F;
  int arg = INT_MAX;
  for (int k = 0; k < s; ++k) {
    const int a = max(starts[static_cast<size_t>(i) * s + k], 0);
    const int b = min(ends[static_cast<size_t>(i) * s + k], w);
    for (int j = a; j < b; ++j) {
      if (!(w_key[j] > key)) continue;
      const float* yc = win + static_cast<size_t>(j) * d;
      float d2;
      if constexpr (D > 0) {
        d2 = pair_d2<D>(xr, yc, D);
      } else {
        d2 = pair_d2<0>(xg, yc, d);
      }
      if (d2 < d2cut && (d2 < best || (d2 == best && j < arg))) {
        best = d2;
        arg = j;
      }
    }
  }
  const bool found = best < CUDART_INF_F;
  delta_out[i] = __fsqrt_rn(best);
  arg_out[i] = found ? arg : -1;
  found_out[i] = found;
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

// sel: null for the ungated sweep, else m bytes, nonzero where a column
// may enter the kept 8 (K1 and K3).
extern "C" int repro_fused_count_topk(const float* x, const float* y, int n,
                                      int m, int d, float d2cut,
                                      const unsigned char* sel, int* count,
                                      float* topv, int* topi, void* stream) {
  if (n > 0) {
    const dim3 grid((n + kRows - 1) / kRows);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(D)                                                    \
  if (sel != nullptr)                                                      \
    fused_count_topk_kernel<D, true><<<grid, kRows, 0, s>>>(               \
        x, y, n, m, d, d2cut, sel, count, topv, topi);                     \
  else                                                                     \
    fused_count_topk_kernel<D, false><<<grid, kRows, 0, s>>>(              \
        x, y, n, m, d, d2cut, sel, count, topv, topi)
    REPRO_DISPATCH_D(d, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_worklist_count_topk(
    const float* x, const float* y, int n, int m, int d, float d2cut,
    const unsigned char* sel, const int* row_ptr, const int* col_tile,
    const unsigned char* in_cut, const float* lb, int* count, float* topv,
    int* topi, int* live, void* stream) {
  if (n > 0) {
    const dim3 grid((n + kWlRows - 1) / kWlRows);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(D)                                                    \
  if (sel != nullptr)                                                      \
    worklist_count_topk_kernel<D, true><<<grid, kWlRows, 0, s>>>(          \
        x, y, n, m, d, d2cut, sel, row_ptr, col_tile, in_cut, lb, count,   \
        topv, topi, live);                                                 \
  else                                                                     \
    worklist_count_topk_kernel<D, false><<<grid, kWlRows, 0, s>>>(         \
        x, y, n, m, d, d2cut, sel, row_ptr, col_tile, in_cut, lb, count,   \
        topv, topi, live)
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

extern "C" int repro_range_count(const float* x, const float* y, int n, int m,
                                 int d, float d2cut, int* count,
                                 void* stream) {
  if (n > 0 && m > 0) {
    const int chunk = split_chunk(n, m, d);
    const dim3 grid((n + kRows - 1) / kRows, (m + chunk - 1) / chunk);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(D)                                                 \
  range_count_kernel<D><<<grid, kRows, 0, s>>>(x, y, n, m, d, d2cut, chunk, \
                                               count)
    REPRO_DISPATCH_D(d, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_range_count_signed(const float* x, const float* y,
                                        const float* signs, int n, int m,
                                        int d, float d2cut, float* out,
                                        void* stream) {
  if (n > 0) {
    const dim3 grid((n + kRows - 1) / kRows);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(D)                                                   \
  range_count_signed_kernel<D><<<grid, kRows, 0, s>>>(x, y, signs, n, m, d, \
                                                      d2cut, out)
    REPRO_DISPATCH_D(d, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_gather_masked_nn(const float* table, const float* keys,
                                      const int* slots, int q, int m, int d,
                                      unsigned long long* packed, float* best,
                                      int* arg, void* stream) {
  if (q > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t set = cudaMemsetAsync(
        packed, 0xFF, static_cast<size_t>(q) * sizeof(*packed), s);
    if (set != cudaSuccess) return static_cast<int>(set);
    if (m > 0) {
      const int chunk = split_chunk(q, m, d);
      const dim3 grid((q + kRows - 1) / kRows, (m + chunk - 1) / chunk);
#define REPRO_LAUNCH(D)                                                 \
  gather_masked_nn_kernel<D><<<grid, kRows, 0, s>>>(table, keys, slots, q, \
                                                    m, d, chunk, packed)
      REPRO_DISPATCH_D(d, REPRO_LAUNCH)
#undef REPRO_LAUNCH
    }
    gather_nn_decode_kernel<<<(q + 255) / 256, 256, 0, s>>>(packed, q, best,
                                                            arg);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_prefix_nn(const float* x, int n, int d, float* delta,
                               int* arg, void* stream) {
  if (n > 0) {
    const dim3 grid((n + kRows - 1) / kRows);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(D) \
  prefix_nn_kernel<D><<<grid, kRows, 0, s>>>(x, n, d, delta, arg)
    REPRO_DISPATCH_D(d, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_worklist_range_count(const float* x, const float* y,
                                          int n, int m, int d, float d2cut,
                                          const int* row_ptr,
                                          const int* col_tile,
                                          const unsigned char* in_cut,
                                          int* count, void* stream) {
  if (n > 0) {
    const dim3 grid((n + kWlRows - 1) / kWlRows);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(D)                                                    \
  worklist_range_count_kernel<D><<<grid, kWlRows, 0, s>>>(                 \
      x, y, n, m, d, d2cut, row_ptr, col_tile, in_cut, count)
    REPRO_DISPATCH_D(d, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_worklist_masked_nn(const float* x, const float* x_key,
                                        const float* y, const float* y_key,
                                        int n, int m, int d,
                                        const int* row_ptr,
                                        const int* col_tile, const float* lb,
                                        float* best, int* arg, int* live,
                                        void* stream) {
  if (n > 0) {
    const dim3 grid((n + kWlRows - 1) / kWlRows);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(D)                                                    \
  worklist_masked_nn_kernel<D><<<grid, kWlRows, 0, s>>>(                   \
      x, x_key, y, y_key, n, m, d, row_ptr, col_tile, lb, best, arg, live)
    REPRO_DISPATCH_D(d, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

// starts, ends: (n, s) int32, row-major, window-local [start, end) spans.
extern "C" int repro_halo_range_count(const float* x, const float* win,
                                      const int* starts, const int* ends,
                                      int n, int w, int d, int s,
                                      float d2cut, int* count, void* stream) {
  if (n > 0) {
    const dim3 grid((n + kRows - 1) / kRows);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(D)                                                    \
  halo_range_count_kernel<D><<<grid, kRows, 0, st>>>(x, win, starts, ends, \
                                                     n, w, d, s, d2cut, count)
    REPRO_DISPATCH_D(d, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_halo_masked_nn(const float* x, const float* x_key,
                                    const float* win, const float* w_key,
                                    const int* starts, const int* ends, int n,
                                    int w, int d, int s, float d2cut,
                                    float* delta, int* arg,
                                    unsigned char* found, void* stream) {
  if (n > 0) {
    const dim3 grid((n + kRows - 1) / kRows);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(D)                                                   \
  halo_masked_nn_kernel<D><<<grid, kRows, 0, st>>>(                       \
      x, x_key, win, w_key, starts, ends, n, w, d, s, d2cut, delta, arg,  \
      found)
    REPRO_DISPATCH_D(d, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
