// Hand-written Hopper (sm_90a) kernels for the Approx-DPC, Ex-DPC, Scan and
// S-Approx-DPC paths, dense and block-sparse, for the sliding-window stream
// and for the distributed Ex-DPC shard phases.
//
// Sixteen kernels, each with a plain C entry point bound through ctypes
// (kernels/build.py) and a plain PyTorch version beside it
// (kernels/sweep.py) that does the same operations in the same order:
//
//   repro_fused_count_topk     per query row, the count of y rows within
//                              d_cut and the 8 nearest (d2, index) pairs,
//                              optionally among the selected columns only
//                              (over packed records, kernels/packing.py)
//   repro_worklist_count_topk  the same, over the tile pairs of a worklist
//                              (kernels/blocksparse.py), in two phases
//                              over packed records (kernels/packing.py)
//   repro_masked_nn            per query row, the nearest strictly denser
//                              y row (over a key-sorted prefix of packed
//                              records and a chunk work list)
//   repro_range_count          per query row, the count of y rows within
//                              d_cut (the stream's fresh counts)
//   repro_range_count_signed   per query row, the sum of the signs of the
//                              y rows within d_cut (the stream's rho repair)
//   repro_gather_masked_nn     per slot, the nearest strictly denser table
//                              row to table[slot] (the stream's maxima):
//                              K2's loop on unsorted columns with the key
//                              in the record, for few slots (many take
//                              repro_masked_nn on the gathered rows)
//   repro_prefix_nn            per row of a table sorted by descending
//                              key, the nearest earlier row
//   repro_worklist_range_count per query row, the count within d_cut over
//                              the in-d_cut pairs of a count-only worklist
//   repro_worklist_masked_nn   per query row, the nearest strictly denser
//                              y row, walking a best-1 ring worklist, a
//                              warp a row (over packed records with the
//                              key in the slot, kernels/packing.py)
//   repro_halo_range_count     per query row, the count within d_cut of the
//                              window rows inside its [start, end) spans,
//                              a warp a piece of rows sharing their spans
//                              (over packed records and pieces with no
//                              key, kernels/packing.py)
//   repro_halo_masked_nn       per query row, the nearest strictly denser
//                              window row within d_cut inside its spans, a
//                              warp a piece of rows sharing their spans
//                              (over packed records with the key in the
//                              slot and rows by piece, kernels/packing.py)
//   repro_fused_count_topk_bf16    K1's function on the expanded form with
//                              a bf16 cross term on the tensor cores (over
//                              bf16 column records, kernels/packing.py)
//   repro_worklist_count_topk_bf16 the same over a worklist (the same
//                              records), with the reference's NN-liveness
//   repro_worklist_range_count_signed  per query row, the sum of the signs
//                              of the y rows within d_cut over the in-d_cut
//                              pairs of a count-only worklist
//   repro_worklist_halo_range_count    K10's count over the in-d_cut pairs
//                              of a span count worklist (K10's body on
//                              each piece's in_cut entries)
//   repro_worklist_halo_masked_nn      K11's NN walking a halo ring
//                              worklist (the pairs within d_cut a span
//                              reaches), each piece of rows stopping where
//                              none of its rows can improve (K11's body)
//
// and one more entry point with a plain version in kernels/packing.py:
//
//   repro_halo_layout          the pieces K10/K11/K15/K16 read (rows of
//                              one run by piece, pieces by work, splits)
//                              and the window's records, built on the card
//
// Launch contract: each entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError().  Ragged edges are
// masked here (i >= n, j >= m); inputs are never padded.
//
// Arithmetic: d2 = (x0-y0)^2, then + (xk-yk)^2 for k = 1..d-1 in order,
// with __fsub_rn / __fmul_rn / __fadd_rn so that nvcc cannot contract the
// sum into FMAs.  The plain PyTorch versions round the same operations in
// the same order, so kernel and plain version agree bit for bit.  The bf16
// kernels (K12, K13) are the exception: their cross term is a tensor-core
// sum, exact only where every partial sum is (see K12).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cub/cub.cuh>

#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kRows = 128;          // query rows per block, one per thread
constexpr int kTileFloats = 8192;   // y coordinates staged per tile (32 KB)
constexpr int kMaxTileCols = 2048;  // columns per tile (K5's signs: 8 KB)
constexpr int kTopK = 8;            // FUSED_TOPK in kernels/sweep.py
constexpr int kWlRows = 256;        // K3 rows per row tile: BLOCK_N in
                                    // kernels/blocksparse.py
constexpr int kWlCols = 512;        // K3 columns per column tile: BLOCK_M
constexpr int kSplitBlocks = 2048;  // K4 splits the columns until about
                                    // this many blocks fill the card
constexpr int kBfPad = 8;           // bf16 pad of a staged row (16 bytes):
                                    // fragment loads hit 32 distinct banks
constexpr int kBfMaxD = 224;        // BF16_MAX_D in kernels/ops.py: K12's
                                    // and K13's staged rows and ring fit
                                    // 227 KB of shared memory
constexpr int kAuxThreads = 256;    // threads per block of the decoders,
                                    // the fill and the halo layout's kernels
constexpr int kAuxWarps = kAuxThreads / 32;  // halo_tmax: a warp a tile
constexpr int kCutThreads = 128;    // threads per count_cut_kernel block
constexpr int kMetaThreads = 1;     // halo_meta_kernel: one thread

__host__ __device__ __forceinline__ int tile_cols(int d) {
  const int c = kTileFloats / d;
  return c < kMaxTileCols ? c : kMaxTileCols;
}

// Columns per block of K4's column-split grid: a whole number of
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

// K1, K2 and K3 read the columns as packed records (kernels/packing.py):
// the d coordinates, one 32-bit slot (K1: the kept-k gate; K2: the
// column's original index; K3: either) and zeros up to a whole number of
// float4s, one float4 for d <= 3.  A block of kNnThreads threads owns R
// rows per thread (register blocking: one 16-byte shared load per column
// feeds R distances) and streams the records through a two-stage ring of
// tiles in dynamic shared memory, filled by 16-byte cp.async: tile t+1 is
// in flight while tile t is computed, and the one barrier per tile both
// publishes tile t and retires the buffer of tile t-1.
// Rows per thread, measured at R = 2 and 4 on an H100 (PERF.md): K1 keeps
// 16 registers of kept list per row, so at R = 4 it needs 128 registers
// and an SM holds 4 blocks; R = 2 (68 registers, 7 blocks) is faster.
// K2 holds 3 per row and is faster at R = 4.
constexpr int kNnThreads = 128;     // threads per K1/K2/K3 block
constexpr int kK1R = 2;             // K1 rows per thread
constexpr int kK2R = 4;             // K2 rows per thread
constexpr int kStageVecs = 1024;    // float4s per ring stage (16 KB)
// K1 blocks an SM must hold: lets ptxas use 128 registers a thread at
// R = 4, where by itself it stopped at 96 and spilled the query rows
constexpr int kK1MinBlocks = 4;

// float4s per packed record of d coordinates and the slot
__host__ __device__ constexpr int rec_vecs(int d) { return (d + 4) / 4; }

__host__ __device__ inline int ring_cols(int w4) {
  const int c = kStageVecs / w4;
  return c > 1 ? c : 1;
}

// dynamic shared memory of a two-stage ring of w4-float4 records
inline size_t ring_bytes(int w4) {
  return 2 * static_cast<size_t>(ring_cols(w4)) * w4 * sizeof(float4);
}

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Issue (and commit as one group) the copy of records [c0, c0 + cols).
__device__ __forceinline__ void stage_async(float4* buf, const float4* rec,
                                            int c0, int cols, int w4) {
  const float4* src = rec + static_cast<size_t>(c0) * w4;
  for (int t = threadIdx.x; t < cols * w4; t += blockDim.x)
    cp_async16(buf + t, src + t);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One column's record in registers (D > 0); D == 0 reads it in place.
template <int D>
struct Record {
  float v[D > 0 ? 4 * rec_vecs(D) : 1];
  const float* g;
  __device__ __forceinline__ explicit Record(const float4* rc)
      : g(reinterpret_cast<const float*>(rc)) {
    if constexpr (D > 0) {
#pragma unroll
      for (int q = 0; q < rec_vecs(D); ++q) {
        const float4 f = rc[q];
        v[4 * q] = f.x;
        v[4 * q + 1] = f.y;
        v[4 * q + 2] = f.z;
        v[4 * q + 3] = f.w;
      }
    }
  }
  __device__ __forceinline__ const float* coords() const {
    if constexpr (D > 0) {
      return v;
    } else {
      return g;
    }
  }
  __device__ __forceinline__ int slot(int d) const {
    if constexpr (D > 0) {
      return __float_as_int(v[D]);
    } else {
      return __float_as_int(g[d]);
    }
  }
};

// cnt += d2 < cut as a compare and a predicated add: left to itself, nvcc
// selects between cnt and cnt + 1 and moves the result, four instructions.
__device__ __forceinline__ void count_below(int& cnt, float d2, float cut) {
  asm("{\n\t.reg .pred p;\n\tsetp.lt.f32 p, %1, %2;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(cnt)
      : "f"(d2), "f"(cut));
}

// d2 of one register-blocked row: D > 0 from its registers, D == 0 from x.
template <int D>
__device__ __forceinline__ float row_d2(const float (&xr)[D > 0 ? D : 1],
                                        const float* xg, const float* yc,
                                        int d) {
  if constexpr (D > 0) {
    return pair_d2<D>(xr, yc, D);
  } else {
    return pair_d2<0>(xg, yc, d);
  }
}

// K1 — replaces the reference's ops.fused_sweep, i.e. sweep.tile_sweep with
// SweepSpec(count=True, nn="topk", k=8) (repro/kernels/sweep.py:432, body
// _make_sweep_kernel at :208).
//
// Bound: f32 CUDA-core issue.  Each pair costs 3d-1 operations of distance
// (d subtractions, d products, d-1 sums, none of them contracted) and two
// of count (a compare and a predicated add), and moves almost no memory:
// a block reads each record tile once from L2 and every thread then reads
// it as a broadcast.  The floor is pairs x (3d+1) at the card's f32 lane
// rate (132 SMs x 128 lanes x its clock; no FMA to count twice).  The
// design keeps each thread's R query rows, counts and sorted kept lists in
// registers (R x 16 of them for the lists), so the inner loop is one
// 16-byte shared load per column, R distances, R counts and one guard
// `d2 <= tv[7]` over the R rows, voted into one warp-uniform branch; the
// unrolled insertion runs only when some lane's guard passes (under 1 %
// of a warp's columns on the dense 2^20 fit, so no column order seeds
// the lists).  Columns arrive in index order, so keep's lexicographic
// insertion drops an equal d2 of a higher index, as the reference's
// stable order does.  One block owns R x 128 rows and loops over all
// column tiles, which replaces the TPU's sequential grid and its `first`
// flag: nothing is carried between blocks.
//
// kSel (S-Approx-DPC's nn_sel gate, repro/kernels/sweep.py:296-297): a
// column whose record slot is 0 never enters the kept 8; the count ignores
// the gate.  The gate rides in the record's spare slot, so it costs no
// load of its own, and it is the column's, the same in every lane.
template <int D, bool kSel>
__global__ void __launch_bounds__(kNnThreads, kK1MinBlocks)
    fused_count_topk_kernel(const float* __restrict__ x,
                            const float4* __restrict__ rec, int w4, int n,
                            int m, int d, float d2cut,
                            int* __restrict__ count,
                            float* __restrict__ topv, int* __restrict__ topi) {
  extern __shared__ float4 ring[];
  if constexpr (D > 0) {
    d = D;
    w4 = rec_vecs(D);
  }
  const int base = blockIdx.x * (kK1R * kNnThreads) + threadIdx.x;

  float xr[kK1R][D > 0 ? D : 1];
  const float* xg[kK1R];
  float tv[kK1R][kTopK];
  int ti[kK1R][kTopK];
  int cnt[kK1R];
#pragma unroll
  for (int r = 0; r < kK1R; ++r) {
    const int i = base + r * kNnThreads;
    xg[r] = x + static_cast<size_t>(i < n ? i : n - 1) * d;  // dead rows
    if constexpr (D > 0) {                                  // never write
#pragma unroll
      for (int k = 0; k < D; ++k) xr[r][k] = xg[r][k];
    }
#pragma unroll
    for (int s = 0; s < kTopK; ++s) {
      tv[r][s] = CUDART_INF_F;
      ti[r][s] = INT_MAX;
    }
    cnt[r] = 0;
  }

  const int per_tile = ring_cols(w4);
  float4* const buf0 = ring;
  float4* const buf1 = ring + per_tile * w4;
  const int ntile = (m + per_tile - 1) / per_tile;
  if (ntile > 0) stage_async(buf0, rec, 0, min(per_tile, m), w4);
  for (int t = 0; t < ntile; ++t) {
    const int j0 = t * per_tile;
    const int cols = min(per_tile, m - j0);
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < ntile)
      stage_async((t & 1) ? buf0 : buf1, rec, j0 + per_tile,
                  min(per_tile, m - j0 - per_tile), w4);
    const float4* tile = (t & 1) ? buf1 : buf0;
#pragma unroll 2
    for (int c = 0; c < cols; ++c) {
      const Record<D> y(tile + c * w4);
      float d2[kK1R];
      bool any = false;
#pragma unroll
      for (int r = 0; r < kK1R; ++r) {
        d2[r] = row_d2<D>(xr[r], xg[r], y.coords(), d);
        count_below(cnt[r], d2[r], d2cut);
        any |= d2[r] <= tv[r][kTopK - 1];
      }
      if constexpr (kSel) any &= y.slot(d) != 0;
      if (__any_sync(0xffffffffu, any)) {  // a uniform branch
#pragma unroll
        for (int r = 0; r < kK1R; ++r)
          if (d2[r] <= tv[r][kTopK - 1]) keep(tv[r], ti[r], d2[r], j0 + c);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kK1R; ++r) {
    const int i = base + r * kNnThreads;
    if (i >= n) continue;
    count[i] = cnt[r];
    const size_t o = static_cast<size_t>(i) * kTopK;
#pragma unroll
    for (int s = 0; s < kTopK; ++s) {
      topv[o + s] = tv[r][s];
      topi[o + s] = ti[r][s] == INT_MAX ? -1 : ti[r][s];
    }
  }
}

// K3 — replaces the reference's ops.fused_sweep on a worklist, i.e.
// sweep.tile_sweep with SweepSpec(count=True, nn="topk", k=8) over the
// PrefetchScalarGridSpec worklist grid (repro/kernels/sweep.py:432, body
// _make_sweep_kernel at :208, liveness at :250-258).
//
// Bound: f32 operations on the CUDA cores for the pairs the data needs,
// 3d+1 each, as K1: every pair of an in-d_cut entry (the count) and, per
// row, the pairs of the entries whose lb is at most its final 8th d2.  One
// block of kNnThreads threads owns one 256-row tile, K1's register
// blocking (kK3R rows a thread, one 16-byte shared load per column), and
// walks its CSR segment row_ptr[t] .. row_ptr[t+1] (ascending lb) as
// chunks of packed records streamed through a two-stage cp.async ring,
// one barrier per chunk, in two phases (kernels/packing.py builds both
// record sets, the split and the tile order):
//
//   phase 1, entries [row_ptr[t], split[t]): up to the last in-d_cut
//   entry, which in_cut = lb <= d_cut^2 over ascending lb makes a prefix.
//   Every row needs every such pair for its count, so there is no vote:
//   K1's column step, the count by a predicated add (an entry that is not
//   in d_cut counts against -1), the kept-8 guard d2 <= tv[7] voted into
//   one warp-uniform branch.  Entries arrive in lb order, not index
//   order, so keep's insertion is lexicographic on (d2, index).
//
//   phase 2, entries [split[t], row_ptr[t+1]): the kept-8 alone, which
//   few rows still need (on Airline's 5.8M, 21 of a tile's 256 on
//   average, none in 55 % of the tiles), each for its own number of
//   entries, so the unit of work is a row, not a block of rows.  A row
//   whose tv[7] is below the first phase-2 lb is done (every later pair
//   has d2 >= lb); the rest move, in slot order, to shared memory (kept
//   list, row id, coordinates).  At each chunk's barrier the warps
//   publish their rows' loosest tv[7]: the block's maximum decides,
//   exactly and fresh, whether an entry's first chunk is computed; lb
//   ascends and tv only falls, so the first entry that fails ends the
//   walk.  The next chunk is staged on the same (by then stale, so
//   larger) maximum while the current one computes.  Warp w takes rows
//   w, w + 4, ..., each only if its own tv[7] reaches the entry's lb, its
//   32 lanes a column each: a lane whose d2 reaches tv[7] holds a
//   candidate, and the candidates enter the row's list one at a time
//   (k3_row_chunk).  Phase 2 reads its own records whose slot holds the
//   column index: the wrapper's packed y (ungated), or the selected
//   columns alone, grouped by column tile (kSel: `koff` gives each
//   tile's range), since it counts nothing.
//
// Row tiles are launched in `order`, the longest phase 1 first: in index
// order the densest tiles, each a block's work for over 70 ms at 5.8M,
// start late and end the kernel a third later (PERF.md).  `live` (optional)
// gets the entries each row tile computed, `ran` (optional, zeroed by the
// caller) the pairs each of its phases ran (phase 2: per row taking a
// chunk, its columns).
//
// kSel gates the kept 8 as in K1 (the record slot of phase 1).  The vote
// stays exact: a gated column never enters, so lb <= tv[7] still bounds
// what can change a row, and until a row has seen 8 selected columns its
// tv[7] is +inf and every entry stays live for it.
constexpr int kK3R = kWlRows / kNnThreads;  // K3 rows per thread
constexpr int kWarps = kNnThreads / 32;

// columns per K3 chunk: an entry's 512, or fewer where a record is wide
__host__ __device__ inline int k3_chunk_cols(int w4) {
  const int c = ring_cols(w4);
  return c < kWlCols ? c : kWlCols;
}

// K3's dynamic shared memory: the ring, then phase 2's rows (kept lists,
// row ids and, for d <= 8, the coordinates)
inline size_t k3_smem_bytes(int w4, int d) {
  return 2 * static_cast<size_t>(k3_chunk_cols(w4)) * w4 * sizeof(float4) +
         static_cast<size_t>(kWlRows) * (2 * kTopK + 1 + (d <= 8 ? d : 0)) *
             sizeof(float);
}

// A thread's kK3R rows: coordinates, counts, kept lists, global row ids
// (-1: no row, never written).
template <int D>
struct K3Rows {
  float xr[kK3R][D > 0 ? D : 1];
  const float* xg[kK3R];
  float tv[kK3R][kTopK];
  int ti[kK3R][kTopK];
  int cnt[kK3R];
  int row[kK3R];

  __device__ __forceinline__ void load(int r, const float* x, int i, int d) {
    xg[r] = x + static_cast<size_t>(i) * d;
    if constexpr (D > 0) {
#pragma unroll
      for (int k = 0; k < D; ++k) xr[r][k] = xg[r][k];
    }
  }

  __device__ __forceinline__ void write(int r, float* topv, int* topi) const {
    const size_t o = static_cast<size_t>(row[r]) * kTopK;
#pragma unroll
    for (int s = 0; s < kTopK; ++s) {
      topv[o + s] = tv[r][s];
      topi[o + s] = ti[r][s] == INT_MAX ? -1 : ti[r][s];
    }
  }
};

// Phase 1's column j: counts below thr and the kept-8.
template <int D, bool kSel>
__device__ __forceinline__ void k3_count_column(const float4* rc, int j, int d,
                                                float thr, K3Rows<D>& s) {
  const Record<D> y(rc);
  float d2[kK3R];
  bool any = false;
#pragma unroll
  for (int r = 0; r < kK3R; ++r) {
    d2[r] = row_d2<D>(s.xr[r], s.xg[r], y.coords(), d);
    count_below(s.cnt[r], d2[r], thr);
    any |= d2[r] <= s.tv[r][kTopK - 1];
  }
  if constexpr (kSel) any &= y.slot(d) != 0;
  if (__any_sync(0xffffffffu, any)) {  // a uniform branch
#pragma unroll
    for (int r = 0; r < kK3R; ++r)
      if (d2[r] <= s.tv[r][kTopK - 1]) keep(s.tv[r], s.ti[r], d2[r], j);
  }
}

// Phase 2's step for one row and one chunk: the warp's lanes take the
// columns, a lane whose d2 reaches the row's 8th holds a candidate, and
// every lane inserts the candidates one at a time into its copy of the
// row's kept list, which lives in shared memory between steps.  A
// record's slot is its column index.
template <int D>
__device__ __forceinline__ void k3_row_chunk(const float4* tile, int cols,
                                             int w4, int d, const float* xq,
                                             float* rv, int* ri, int lane) {
  float xr[D > 0 ? D : 1];
  if constexpr (D > 0) {
#pragma unroll
    for (int q = 0; q < D; ++q) xr[q] = xq[q];
  }
  float tv[kTopK];
  int ti[kTopK];
#pragma unroll
  for (int q = 0; q < kTopK; ++q) {
    tv[q] = rv[q];
    ti[q] = ri[q];
  }
  bool dirty = false;
#pragma unroll 2
  for (int c0 = 0; c0 < cols; c0 += 32) {
    const int c = c0 + lane;
    float d2 = CUDART_INF_F;
    int j = 0;
    if (c < cols) {
      const Record<D> y(tile + c * w4);
      if constexpr (D > 0) {
        d2 = pair_d2<D>(xr, y.coords(), D);
      } else {
        d2 = pair_d2<0>(xq, y.coords(), d);
      }
      j = y.slot(d);
    }
    unsigned cand =
        __ballot_sync(0xffffffffu, c < cols && d2 <= tv[kTopK - 1]);
    while (cand != 0) {  // a uniform loop
      const int src = __ffs(cand) - 1;
      cand &= cand - 1;
      keep(tv, ti, __shfl_sync(0xffffffffu, d2, src),
           __shfl_sync(0xffffffffu, j, src));
      dirty = true;
    }
  }
  if (dirty) {
#pragma unroll
    for (int q = 0; q < kTopK; ++q) {
      if (lane == q) {
        rv[q] = tv[q];
        ri[q] = ti[q];
      }
    }
    __syncwarp();  // the warp's other lanes read the list next
  }
}

template <int D, bool kSel>
__global__ void __launch_bounds__(kNnThreads, kK1MinBlocks)
    worklist_count_topk_kernel(
        const float* __restrict__ x, const float4* __restrict__ rec,
        const float4* __restrict__ krec, const int* __restrict__ koff,
        int w4, int n, int m, int d, float d2cut,
        const int* __restrict__ order, const int* __restrict__ row_ptr,
        const int* __restrict__ split, const int* __restrict__ col_tile,
        const unsigned char* __restrict__ in_cut,
        const float* __restrict__ lb, int* __restrict__ count,
        float* __restrict__ topv, int* __restrict__ topi,
        int* __restrict__ live_out, unsigned long long* __restrict__ ran_out) {
  extern __shared__ float4 ring[];
  __shared__ float s_tau[2][kWarps];
  __shared__ int s_need[kK3R * kWarps];
  if constexpr (D > 0) {
    d = D;
    w4 = rec_vecs(D);
  }
  const int t = order[blockIdx.x];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cap = k3_chunk_cols(w4);
  const int stage = cap * w4;  // float4s of one ring stage

  K3Rows<D> s;
#pragma unroll
  for (int r = 0; r < kK3R; ++r) {
    const int i = t * kWlRows + r * kNnThreads + threadIdx.x;
    s.row[r] = i < n ? i : -1;
    s.load(r, x, i < n ? i : n - 1, d);  // dead rows compute, never vote
#pragma unroll
    for (int q = 0; q < kTopK; ++q) {
      s.tv[r][q] = CUDART_INF_F;
      s.ti[r][q] = INT_MAX;
    }
    s.cnt[r] = 0;
  }
  const int e0 = row_ptr[t];
  const int p1 = split[t];
  const int e1 = row_ptr[t + 1];

  // phase 1: [e0, p1), every chunk by every warp
  unsigned long long cols1 = 0;
  {
    int ce = e0, cj = 0, cend = 0;  // the chunk cursor: entry, columns
    if (ce < p1) {
      cj = col_tile[ce] * kWlCols;
      cend = min(cj + kWlCols, m);
      stage_async(ring, rec, cj, min(cap, cend - cj), w4);
    }
    int b = 0;
    while (ce < p1) {
      const int j0 = cj;
      const int cols = min(cap, cend - cj);
      const float thr = in_cut[ce] ? d2cut : -1.0f;
      cj += cols;
      if (cj >= cend && ++ce < p1) {
        cj = col_tile[ce] * kWlCols;
        cend = min(cj + kWlCols, m);
      }
      cp_async_wait_all();
      __syncthreads();
      if (ce < p1) stage_async(ring + (b ^ 1) * stage, rec, cj,
                               min(cap, cend - cj), w4);
      const float4* tile = ring + b * stage;
#pragma unroll 2
      for (int c = 0; c < cols; ++c)
        k3_count_column<D, kSel>(tile + c * w4, j0 + c, d, thr, s);
      b ^= 1;
      cols1 += cols;
    }
  }

  // the counts are final; rows that phase 2 cannot change are done
  const float lb2 = p1 < e1 ? lb[p1] : 0.0f;
  bool need[kK3R];
#pragma unroll
  for (int r = 0; r < kK3R; ++r) {
    if (s.row[r] >= 0) count[s.row[r]] = s.cnt[r];
    need[r] = p1 < e1 && s.row[r] >= 0 && s.tv[r][kTopK - 1] >= lb2;
    if (s.row[r] >= 0 && !need[r]) s.write(r, topv, topi);
  }

  // the rows that need phase 2, compacted in slot order (r, thread) into
  // shared memory past the ring: kept lists, row ids, coordinates
  float* const sv = reinterpret_cast<float*>(ring + 2 * stage);
  int* const si = reinterpret_cast<int*>(sv + kWlRows * kTopK);
  int* const sid = si + kWlRows * kTopK;
  float* const sx = reinterpret_cast<float*>(sid + kWlRows);
  unsigned bal[kK3R];
#pragma unroll
  for (int r = 0; r < kK3R; ++r) {
    bal[r] = __ballot_sync(0xffffffffu, need[r]);
    if (lane == 0) s_need[r * kWarps + warp] = __popc(bal[r]);
  }
  __syncthreads();
  int live_rows = 0;
  int k[kK3R];
#pragma unroll
  for (int g = 0; g < kK3R * kWarps; ++g) {
#pragma unroll
    for (int r = 0; r < kK3R; ++r)
      if (g == r * kWarps + warp)
        k[r] = live_rows + __popc(bal[r] & ((1u << lane) - 1u));
    live_rows += s_need[g];
  }
  int visited = p1 - e0;
  unsigned long long cols2 = 0;
  if (live_rows > 0) {
#pragma unroll
    for (int r = 0; r < kK3R; ++r) {
      if (!need[r]) continue;
#pragma unroll
      for (int q = 0; q < kTopK; ++q) {
        sv[k[r] * kTopK + q] = s.tv[r][q];
        si[k[r] * kTopK + q] = s.ti[r][q];
      }
      sid[k[r]] = s.row[r];
      if constexpr (D > 0) {
#pragma unroll
        for (int q = 0; q < D; ++q) sx[k[r] * D + q] = s.xr[r][q];
      }
    }
    __syncthreads();

    // phase 2: [p1, e1) while live, kept-8 only, from krec; warp w takes
    // rows w, w + 4, ..., a row at a time, its lanes the chunk's columns
    auto range = [&](int e, int& lo, int& hi) {
      const int ct = col_tile[e];
      if (koff != nullptr) {
        lo = koff[ct];
        hi = koff[ct + 1];
      } else {
        lo = ct * kWlCols;
        hi = min(lo + kWlCols, m);
      }
    };
    int ce = p1, cj = 0, cend = 0;
    for (; ce < e1; ++ce) {  // entry p1 is live: some row needs it
      range(ce, cj, cend);
      if (cj < cend) break;  // (a gated tile may hold no column)
    }
    if (ce < e1) stage_async(ring, krec, cj, min(cap, cend - cj), w4);
    int b = 0;
    int par = 0;
    bool head = true;  // the staged chunk is its entry's first
    while (ce < e1) {
      const int cols = min(cap, cend - cj);
      const float lbe = lb[ce];
      const bool first = head;
      cj += cols;
      head = cj >= cend;
      float wt = -CUDART_INF_F;  // the loosest of the warp's rows
      for (int q = warp + kWarps * lane; q < live_rows; q += kNnThreads)
        wt = fmaxf(wt, sv[q * kTopK + kTopK - 1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        wt = fmaxf(wt, __shfl_xor_sync(0xffffffffu, wt, o));
      if (lane == 0) s_tau[par][warp] = wt;
      cp_async_wait_all();
      __syncthreads();
      float tau = s_tau[par][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) tau = fmaxf(tau, s_tau[par][w]);
      par ^= 1;
      if (first && lbe > tau) break;  // this entry and all later are dead
      visited += first;
      if (head) {  // the next live entry, on this (soon stale) maximum
        for (++ce; ce < e1; ++ce) {
          if (lb[ce] > tau) {
            ce = e1;
            break;
          }
          range(ce, cj, cend);
          if (cj < cend) break;
        }
      }
      if (ce < e1)
        stage_async(ring + (b ^ 1) * stage, krec, cj, min(cap, cend - cj), w4);
      const float4* tile = ring + b * stage;
      for (int q = warp; q < live_rows; q += kWarps) {
        if (lbe > sv[q * kTopK + kTopK - 1]) continue;  // the row is done
        const float* xq = D > 0 ? sx + q * D
                                : x + static_cast<size_t>(sid[q]) * d;
        k3_row_chunk<D>(tile, cols, w4, d, xq, sv + q * kTopK,
                        si + q * kTopK, lane);
        cols2 += cols;
      }
      b ^= 1;
    }
    for (int q = warp; q < live_rows; q += kWarps) {
      if (lane < kTopK) {
        const size_t o = static_cast<size_t>(sid[q]) * kTopK + lane;
        const int j = si[q * kTopK + lane];
        topv[o] = sv[q * kTopK + lane];
        topi[o] = j == INT_MAX ? -1 : j;
      }
    }
  }
  if (ran_out != nullptr && lane == 0) {
    // audit-merge: integer sums of the pairs each phase ran, a row tile's
    // warps adding into its two 64-bit counters; integer addition is
    // associative, so no order of arrival changes them
    if (warp == 0)
      atomicAdd(ran_out + 2 * t, cols1 * static_cast<unsigned>(kWlRows));
    atomicAdd(ran_out + 2 * t + 1, cols2);
  }
  if (live_out != nullptr && threadIdx.x == 0) live_out[t] = visited;
}

// One column of K2, or of K6's key form, for a thread's R rows.  The hot
// compare is `d2 <= best` per row, voted into one warp-uniform branch;
// equal d2 are settled inside it on the column's index.  kMask: the rows
// do not all take the column.  K2 (kKey false) masks by position: past the
// least end of the block's rows, a row skips the columns at or past its
// own end, lim[r]; the column's index is in the record's slot.  K6's key
// form (kKey true) masks by key: a row takes a column whose key, in the
// record's slot, is strictly above its own, lim[r] (a NaN on either side
// takes nothing); the column's index is its position.
template <int D, bool kKey, bool kMask, typename Lim>
__device__ __forceinline__ void nn_column(
    const Record<D>& y, int pos, int d,
    const float (&xr)[kK2R][D > 0 ? D : 1], const float* const (&xg)[kK2R],
    const Lim (&lim)[kK2R], float (&best)[kK2R], int (&arg)[kK2R]) {
  float yk = 0.0f;
  if constexpr (kKey) yk = __int_as_float(y.slot(d));
  float d2[kK2R];
  bool in[kK2R];
  bool any = false;
#pragma unroll
  for (int r = 0; r < kK2R; ++r) {
    if constexpr (!kMask) {
      in[r] = true;
    } else if constexpr (kKey) {
      in[r] = yk > lim[r];
    } else {
      in[r] = pos < lim[r];
    }
    d2[r] = row_d2<D>(xr[r], xg[r], y.coords(), d);
    any |= in[r] && d2[r] <= best[r];
  }
  if (__any_sync(0xffffffffu, any)) {  // a uniform branch
    const int j = kKey ? pos : y.slot(d);
#pragma unroll
    for (int r = 0; r < kK2R; ++r) {
      if (in[r] && (d2[r] < best[r] || (d2[r] == best[r] && j < arg[r]))) {
        best[r] = d2[r];
        arg[r] = j;
      }
    }
  }
}

// K2 — replaces the reference's dependent.masked_min_dist, i.e.
// sweep.tile_sweep with SweepSpec(nn="best1", key=True)
// (repro/kernels/dependent.py:42, lexicographic update at sweep.py:299-311).
//
// Bound: f32 CUDA-core issue on the strictly denser pairs, 3d+1 operations
// each (3d-1 of distance, the compare and its share of the branch), plus
// the wrapper's sort and pack of the columns, a few bytes per column.  The
// design makes the key mask a prefix (kernels/packing.py): the wrapper
// sorts the columns by key, descending, into packed records carrying their
// original index, and the rows by the length of their prefix, ends[i] =
// #{j : y_key[j] > x_key[i]}.  A block of R x 128 consecutive sorted rows
// then scans only [0, its largest end): no key is loaded or tested, and
// below the least end of its rows (ends[first], the rows being sorted)
// every lane takes every column, so the loop is K7's without the
// divergence, register-blocked; past it a row masks by position.  The hot
// compare is one `d2 <= best` per row, voted over the R rows and the warp
// into one uniform branch; inside it the rare equal d2 is settled on the
// original index, since sorted order is not index order.  Work items (row block, chunk
// start, chunk end), heaviest first, cut each block's prefix into chunks
// so a few thousand rows still fill the card; each item merges its rows'
// (best d2, index) with a 64-bit atomicMin on (d2 bits << 32 | index),
// which is the lexicographic order since d2 >= 0, into the row's original
// slot.  A row whose best stays +inf (none denser, or every d2 overflows)
// never merges and decodes to (inf, -1), as the plain version gives.
// Distances are direct differences on every pair, so the reference's top-4
// re-rank, which only repaired the expanded form, has no counterpart.
//
// kKey: K6's key form (see K6 below), the same loop over unsorted columns.
// The rows are sorted by key, ascending, and lim holds their keys (+inf
// for a padding slot or a NaN key); the records carry each column's key in
// the slot; block (b, c) takes row block b and columns [c chunk, (c + 1)
// chunk).  A column whose key is not above the block's least row key is
// skipped by the whole block, one above its greatest is taken by every row
// unmasked, and one between is masked by key: each test is on the block's
// two bounds, so the branch is uniform.
template <int D, bool kKey>
__global__ void __launch_bounds__(kNnThreads)
    masked_nn_kernel(const float* __restrict__ x,
                     const int* __restrict__ row_id,
                     const std::conditional_t<kKey, float, int>* __restrict__
                         row_lim,
                     const float4* __restrict__ rec, int w4,
                     const int4* __restrict__ items, int n, int m, int chunk,
                     int d, unsigned long long* __restrict__ packed) {
  using Lim = std::conditional_t<kKey, float, int>;
  extern __shared__ float4 ring[];
  if constexpr (D > 0) {
    d = D;
    w4 = rec_vecs(D);
  }
  int first, c_begin, c_end;
  if constexpr (kKey) {
    first = blockIdx.x * (kK2R * kNnThreads);
    c_begin = blockIdx.y * chunk;
    c_end = min(c_begin + chunk, m);
  } else {
    const int4 item = items[blockIdx.x];
    first = item.x * (kK2R * kNnThreads);
    c_begin = item.y;
    c_end = item.z;
  }
  // K2: every row of the block takes [0, lo).  K6: the block's least and
  // greatest row key.
  const Lim lo = row_lim[first];
  [[maybe_unused]] const Lim hi =
      row_lim[min(first + kK2R * kNnThreads, n) - 1];

  float xr[kK2R][D > 0 ? D : 1];
  const float* xg[kK2R];
  Lim e[kK2R];
  float best[kK2R];
  int arg[kK2R];
#pragma unroll
  for (int r = 0; r < kK2R; ++r) {
    const int i = first + r * kNnThreads + threadIdx.x;
    xg[r] = x + static_cast<size_t>(i < n ? i : n - 1) * d;
    if constexpr (D > 0) {
#pragma unroll
      for (int k = 0; k < D; ++k) xr[r][k] = xg[r][k];
    }
    if constexpr (kKey) {
      e[r] = i < n ? row_lim[i] : CUDART_INF_F;
    } else {
      e[r] = i < n ? row_lim[i] : 0;
    }
    best[r] = CUDART_INF_F;
    arg[r] = INT_MAX;
  }

  const int per_tile = ring_cols(w4);
  float4* const buf0 = ring;
  float4* const buf1 = ring + per_tile * w4;
  const int ntile = (c_end - c_begin + per_tile - 1) / per_tile;
  if (ntile > 0)
    stage_async(buf0, rec, c_begin, min(per_tile, c_end - c_begin), w4);
  for (int t = 0; t < ntile; ++t) {
    const int j0 = c_begin + t * per_tile;
    const int cols = min(per_tile, c_end - j0);
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < ntile)
      stage_async((t & 1) ? buf0 : buf1, rec, j0 + per_tile,
                  min(per_tile, c_end - j0 - per_tile), w4);
    const float4* tile = (t & 1) ? buf1 : buf0;
    if constexpr (kKey) {
      for (int c = 0; c < cols; ++c) {
        const Record<D> y(tile + c * w4);
        const float yk = __int_as_float(y.slot(d));
        if (!(yk > lo)) continue;  // no row of the block is below it
        if (yk > hi) {
          nn_column<D, true, false>(y, j0 + c, d, xr, xg, e, best, arg);
        } else {
          nn_column<D, true, true>(y, j0 + c, d, xr, xg, e, best, arg);
        }
      }
    } else {
      const int open = min(cols, max(0, lo - j0));  // uniform in the block
      for (int c = 0; c < open; ++c)
        nn_column<D, false, false>(Record<D>(tile + c * w4), j0 + c, d, xr,
                                   xg, e, best, arg);
      for (int c = open; c < cols; ++c)
        nn_column<D, false, true>(Record<D>(tile + c * w4), j0 + c, d, xr,
                                  xg, e, best, arg);
    }
  }

#pragma unroll
  for (int r = 0; r < kK2R; ++r) {
    const int i = first + r * kNnThreads + threadIdx.x;
    // audit-merge: 64-bit atomicMin on (d2 bits << 32 | index): a
    // lexicographic minimum over a total order, so the chunks' bests merge
    // to the same word whatever order they land in
    if (i < n && best[r] < CUDART_INF_F)
      atomicMin(packed + row_id[i],
                (static_cast<unsigned long long>(__float_as_uint(best[r]))
                 << 32) |
                    static_cast<unsigned int>(arg[r]));
  }
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
  // audit-merge: integer range counts of the column chunks, added into
  // the zeroed counts; integer addition is exact in any order
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
// Per slot s, the nearest table row with a key strictly above keys[s]:
// K2's function on the rows table[slots].  The stream calls it with the
// dirty cell maxima as rows (1,342 on the mixture, about 489,000 on the
// Airline proxy) against its whole 2^20-row window, and the keys change
// every tick.  Bound: f32 CUDA-core issue, 3d+1 operations for each
// strictly denser pair, plus the bytes of K2's sort and pack.  The TPU
// kernel gathers its rows with one-hot products on a doubled column grid
// and tests a key for every pair.  Here a key test per pair, a thread a
// row in slot order, would make each warp pay for every pair: its lanes'
// keys are unrelated, so some lane needs almost every column.  The
// wrapper (ops.py) gathers the rows (a padding slot, and a NaN key, keyed
// +inf: neither has a denser row) and takes one of two forms by the slot
// count alone (ops.gather_form, crossing at 8,192 slots on an H100):
//   - the prefix form, for many rows: K2 itself, on the gathered rows
//     (the columns sorted by key and packed, the rows sorted by prefix
//     length, heaviest-first work items; repro_masked_nn), so the pairs
//     it computes are the strictly denser ones;
//   - the key form, for few rows, where sorting and packing 2^20
//     columns costs more than the pairs it saves: K2's loop on unsorted
//     columns, masked_nn_kernel<D, true> (above), launched below.  The
//     rows are sorted by key, ascending, so a block's rows hold a narrow
//     key band and its tests against the band's bounds are uniform; the
//     records carry each column's key (pack_records, no sort); the grid
//     is row blocks x column chunks, as many chunks as make kK6Waves
//     waves of the blocks the card holds at once.
// Both merge each row's (best d2, index) into the slot's place with the
// 64-bit atomicMin on (d2 bits << 32 | index) and decode as K2 does, so
// either gives the lexicographic (d2, index) minimum over the strictly
// denser rows, bit for bit the plain version's: (inf, -1) for a slot with
// none (padding, the peak, a NaN key, or every d2 overflowing).
constexpr int kK6Waves = 4;

template <int D>
int launch_gather_nn(const float* x, const float* x_key, const int* row_id,
                     const float4* rec, int w4, int n, int m, int d,
                     unsigned long long* packed, cudaStream_t s) {
  const auto kernel = masked_nn_kernel<D, true>;
  const size_t bytes = ring_bytes(w4);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kNnThreads, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int row_blocks = (n + kK2R * kNnThreads - 1) / (kK2R * kNnThreads);
  // chunks a row block: kK6Waves waves of the blocks in flight, at most m
  long long chunks = static_cast<long long>(kK6Waves) * sms *
                     (per_sm > 0 ? per_sm : 1) / row_blocks;
  chunks = chunks < 1 ? 1 : (chunks > m ? m : chunks);
  const int chunk = static_cast<int>((m + chunks - 1) / chunks);
  const dim3 grid(row_blocks,
                  static_cast<int>((static_cast<long long>(m) + chunk - 1) /
                                   chunk));
  kernel<<<grid, kNnThreads, bytes, s>>>(x, row_id, x_key, rec, w4, nullptr,
                                         n, m, chunk, d, packed);
  return static_cast<int>(cudaGetLastError());
}

// K2's and K6's epilogue: (d2 bits << 32 | index) -> (best d2, index);
// the all-ones initial value (no denser row, or a padding slot) -> (inf, -1).
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
// The design is a masked NN without the key: one thread per row, kRows
// rows per block, the columns staged tile by tile in shared memory, (best
// d2, index) in registers, ascending columns and a strict `<`, so the
// lowest index wins among equal distances.  A block stops at the columns
// before its last row, so the work is the triangle; the blocks are
// scheduled heaviest first (a reversed blockIdx), so the last wave is not
// one long tail block.  Only the diagonal tile diverges (each thread stops
// at its own row).  The delta is the correctly rounded square root, as
// torch.sqrt computes it.
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
//
// K14 (kSigned) — replaces the reference's density.range_count_signed on a
// worklist, i.e. sweep.tile_sweep with SweepSpec(count=True, signed=True)
// over a count-only FlatWorklist (PallasBackend.range_count_delta(
// layout="block-sparse"), repro/kernels/backend.py:627-637; pallas_call at
// sweep.py:432), reached through ops.local_density_delta(worklist=...).
// K8's walk with K5's sum: the signs of each staged chunk go to shared
// memory beside its columns, and each row adds sign_j for each column within
// d_cut.  Bound: as K8, plus one add per in-d_cut pair.  The signs are +1,
// -1 or 0, so every partial sum is an integer below 2^24 and exact in f32:
// the result equals K5's bit for bit in any order of the walk.
template <int D, bool kSigned>
__global__ void __launch_bounds__(kWlRows)
    worklist_range_count_kernel(const float* __restrict__ x,
                                const float* __restrict__ y,
                                const float* __restrict__ signs, int n, int m,
                                int d, float d2cut,
                                const int* __restrict__ row_ptr,
                                const int* __restrict__ col_tile,
                                const unsigned char* __restrict__ in_cut,
                                int* __restrict__ count,
                                float* __restrict__ sum_out) {
  __shared__ float tile[kTileFloats];
  __shared__ float stile[kSigned ? kWlCols : 1];
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
  float acc = 0.0f;
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
        if constexpr (kSigned) {
          for (int c = threadIdx.x; c < cols; c += kWlRows)
            stile[c] = signs[c0 + c];
        }
        __syncthreads();
        for (int c = 0; c < cols; ++c) {
          float d2;
          if constexpr (D > 0) {
            d2 = pair_d2<D>(xr, tile + c * D, D);
          } else {
            d2 = pair_d2<0>(xg, tile + c * d, d);
          }
          if constexpr (kSigned) {
            if (d2 < d2cut) acc = __fadd_rn(acc, stile[c]);
          } else {
            cnt += d2 < d2cut;
          }
        }
      }
    }
  }
  if (!live) return;
  if constexpr (kSigned) {
    sum_out[i] = acc;
  } else {
    count[i] = cnt;
  }
}

// K9 — replaces the reference's dependent.masked_min_dist on a worklist,
// i.e. sweep.tile_sweep with SweepSpec(nn="best1", key=True) over the best-1
// ring (PallasBackend.denser_nn(layout="block-sparse"),
// repro/kernels/backend.py:639-647; liveness at sweep.py:250-258, the
// lexicographic update at :303-311), reached through
// ops.dependent_masked(worklist=...): the distributed gather strategy's
// block-sparse delta phase, the unresolved-row fallback of both
// strategies, and the unresolved rows of a block-sparse fit's rho_delta.
//
// Bound: f32 CUDA-core issue: a key test for each pair of the entries a row
// needs (lb at most its final best, and the column tile holding a key
// above the row's) and about 3d+1 operations for each denser one.  The
// ring keeps every tile pair, so what bounds the work is where each row's
// walk stops.  The parent kernel, one block per 256-row tile walking until
// no row of it could improve, ran as long as its longest tile: the global
// density peak's tile walked the whole ring (11,349 entries at 5.8M
// points), and a tile of scattered local maxima computed all 256 rows for
// the few that needed an entry (PERF.md).
//
// The design: a warp a row.  Persistent warps take the rows in index
// order from a counter, so the rows of a tile run at about the same time
// and share its records in L1.  A warp walks its row's ring: its lanes
// test 32 entries at a time by ballot, open (lb at most the row's best)
// and needed (open, and the column tile's largest key above the row's);
// it computes the needed entries in ring order, each after a fresh test of
// lb against the row's best, the lanes taking the entry's columns l, l +
// 32, ... from the packed records (the d coordinates and the column's key
// in the slot, kernels/packing.py) and each keeping its own lexicographic
// minimum; after an entry the lanes' least d2 is the row's new best.  The
// walk ends at the first entry the row is not open for.  Each row thus
// computes exactly the entries it needs, and the longest walk is one
// warp's.  Two forms, by how many rows the card gets: with few (under
// kK9BulkRows a SM: a fit's unresolved rows, the halo fallback) the time is
// the longest walks', and kBatch loads an entry's columns 16 float4 at a
// time, every load issued before any distance, so a lone warp waits one
// round trip an entry (104 registers); with many (the gather's shards) the
// card is full and the plain loop (40 registers, more warps an SM) is
// faster (PERF.md).
//
// Exactness.  (1) Every pair of entry e has d2 >= lb[e] (LB_SHRINK), and a
// pair changes a row's answer, the lexicographic minimum of (d2, index)
// over its strictly denser columns, only if d2 <= best; best only falls and
// lb ascends, so once lb[e] > best the row needs no later entry.  (2) The
// skip by key: tmax[c] is the largest key of column tile c (NaN keys left
// out: a NaN is never denser).  No column of e is denser than a row whose
// key is at least tmax[col_tile[e]], so e cannot change that row and is
// passed over; it is not taken as the end.  This ends the walk of the
// global density peak, which has no denser column at all, and skips the
// column tiles that hold no representative under S-Approx-DPC (keys -inf
// off them).  (3) The ballot's best may be stale by the entries computed
// since (larger, so it opens a superset); each entry is tested again on
// the fresh best before it is computed.  (4) The lanes' minima merge by
// shuffle, and the lexicographic minimum is order-free.  A row with no
// denser column keeps (+inf, -1); a row keyed +inf or NaN (padding) needs
// nothing.  `live` (optional, (row tiles, 2)) gets the entries the rows of
// each tile computed and the longest walk among them.
constexpr int kK9Warps = 4;        // warps a block
constexpr int kK9Blocks = 16;      // persistent blocks an SM
constexpr int kK9BulkRows = 4096;  // rows an SM from which the card is full
constexpr int kK9Batch = 16;       // float4s a lane loads at once (kBatch)

// One entry's columns for a lane (D > 0), kK9Batch float4s at a time, all
// of a batch loaded before any distance.
template <int D>
__device__ __forceinline__ void k9_entry_batched(
    const float4* tile, int cols, int j0, const float (&xr)[D > 0 ? D : 1],
    float key, int lane, float& v, int& a) {
  constexpr int V = rec_vecs(D > 0 ? D : 1);
  constexpr int B = kK9Batch / V > 0 ? kK9Batch / V : 1;  // columns a batch
  constexpr int K = kWlCols / 32;                         // a lane's columns
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += B) {
    float r[B][4 * V];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int c = lane + 32 * (k0 + b);
      const float4* src = tile + static_cast<size_t>(c < cols ? c : 0) * V;
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float4 f = k0 + b < K ? src[q] : make_float4(0, 0, 0, 0);
        r[b][4 * q] = f.x;
        r[b][4 * q + 1] = f.y;
        r[b][4 * q + 2] = f.z;
        r[b][4 * q + 3] = f.w;
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int c = lane + 32 * (k0 + b);
      if (k0 + b < K && c < cols) {
        const float d2 = pair_d2<D>(xr, r[b], D);
        const int j = j0 + c;
        if (r[b][D] > key && (d2 < v || (d2 == v && j < a))) {
          v = d2;
          a = j;
        }
      }
    }
  }
}

template <int D, bool kBatch>
__global__ void __launch_bounds__(32 * kK9Warps)
    worklist_masked_nn_kernel(const float* __restrict__ x,
                              const float* __restrict__ x_key,
                              const float4* __restrict__ rec, int w4, int n,
                              int m, int d, const int* __restrict__ row_ptr,
                              const int* __restrict__ col_tile,
                              const float* __restrict__ lb,
                              const float* __restrict__ tmax,
                              int* __restrict__ next_row,
                              float* __restrict__ best_out,
                              int* __restrict__ arg_out,
                              int* __restrict__ live_out) {
  if constexpr (D > 0) {
    d = D;
    w4 = rec_vecs(D);
  }
  const int lane = threadIdx.x & 31;
  for (;;) {
    int i = 0;
    // audit-merge: a work-queue cursor that hands each warp its next row;
    // it schedules rows and holds no data, and every row is computed by
    // one warp whatever order they are taken in
    if (lane == 0) i = atomicAdd(next_row, 1);
    i = __shfl_sync(0xffffffffu, i, 0);
    if (i >= n) return;
    const float* xg = x + static_cast<size_t>(i) * d;
    float xr[D > 0 ? D : 1];
    if constexpr (D > 0) {
#pragma unroll
      for (int k = 0; k < D; ++k) xr[k] = xg[k];
    }
    const float key = x_key[i];
    float v = CUDART_INF_F;   // the lane's minimum
    int a = INT_MAX;
    float rb = CUDART_INF_F;  // the row's best: the lanes' least v
    const int t = i / kWlRows;
    const int e1 = row_ptr[t + 1];
    int walked = 0;
    bool done = !(key < CUDART_INF_F);  // +inf or NaN: nothing is denser
    for (int e = row_ptr[t]; e < e1 && !done; e += 32) {
      const int j = e + lane;
      const float l = j < e1 ? lb[j] : CUDART_INF_F;
      const bool open = j < e1 && l <= rb;
      const int ct = open ? col_tile[j] : 0;
      unsigned todo = __ballot_sync(0xffffffffu, open && tmax[ct] > key);
      done = __ballot_sync(0xffffffffu, !open) != 0;  // open lanes first
      while (todo != 0) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        if (!(__shfl_sync(0xffffffffu, l, src) <= rb)) {  // fresh: the end
          done = true;
          break;
        }
        const int j0 = __shfl_sync(0xffffffffu, ct, src) * kWlCols;
        const int cols = min(kWlCols, m - j0);
        const float4* tile = rec + static_cast<size_t>(j0) * w4;
        if constexpr (kBatch && D > 0) {
          k9_entry_batched<D>(tile, cols, j0, xr, key, lane, v, a);
        } else {
#pragma unroll 4
          for (int c = lane; c < cols; c += 32) {
            const Record<D> y(tile + static_cast<size_t>(c) * w4);
            const float d2 = row_d2<D>(xr, xg, y.coords(), d);
            const int jc = j0 + c;
            if (__int_as_float(y.slot(d)) > key &&
                (d2 < v || (d2 == v && jc < a))) {
              v = d2;
              a = jc;
            }
          }
        }
        float mv = v;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mv = fminf(mv, __shfl_xor_sync(0xffffffffu, mv, o));
        rb = mv;
        ++walked;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oa = __shfl_xor_sync(0xffffffffu, a, o);
      if (ov < v || (ov == v && oa < a)) {
        v = ov;
        a = oa;
      }
    }
    if (lane == 0) {
      best_out[i] = v;
      arg_out[i] = v < CUDART_INF_F ? a : -1;
      if (live_out != nullptr) {
        // audit-merge: integer walk statistics of a row tile (a sum and a
        // maximum of entry counts), order-free, and read only as counts
        atomicAdd(live_out + 2 * t, walked);
        atomicMax(live_out + 2 * t + 1, walked);
      }
    }
  }
}

// K11 and K16 — replace the reference's dependent.masked_min_dist_halo,
// i.e. sweep.tile_sweep with SweepSpec(nn="best1", key=True, span=True,
// nn_dcut=True) (repro/kernels/dependent.py:56-77, the span mask at
// sweep.py:199-205, the d_cut mask at :294-295, the lexicographic update at
// :303-311, pallas_call at :432), reached through ops.halo_dependent: the
// distributed halo strategy's delta phase (K11), and on the halo ring
// (PallasBackend.denser_nn_halo(layout="block-sparse"),
// repro/kernels/backend.py:742-758; blocksparse.build_flat_worklist(
// count=False, nn="best1", nn_dcut=True, starts=, ends=)) through
// ops.halo_dependent(worklist=...) (K16).
//
// Per query row: the nearest window row inside its [start, end) spans
// (clipped to [0, W)) whose key is strictly above the row's and whose d2
// is below d_cut^2 (stencil semantics: a row with none is left to the
// caller's global fallback), the lexicographic (d2, window index) minimum.
// It writes delta = __fsqrt_rn(best d2) (torch.sqrt's rounding), the
// window-local parent (-1 where none) and found.
//
// Bound: f32 CUDA-core issue, a key test for each span column (in a column
// tile holding a key above the row's) and about 3d+1 operations for each
// denser one; K16 counts only the ring entries a row needs (lb at most its
// final best).  The parent kernels ran a thread a row (K11), each reading
// its span columns from global memory once per row with a dependent load
// chain a column, its lanes' walks of different lengths; and a block a
// 256-row tile (K16), whose vote on every ring entry kept all its rows
// walking as long as its slowest row.
//
// The design.  The rows of one candidate cell are contiguous in a
// grid-sorted shard and share its spans, so the wrapper groups the rows
// whose spans clip to the same columns into runs, sorts each run's rows
// by key and cuts it into pieces of at most kHaloPiece rows, each
// piece's length stored at its first position, the pieces ordered by
// their work, most first, and the heaviest cut into splits
// (kernels/packing.py::halo_layout, built on the card by
// repro_halo_layout; K16's runs are cut at its ring's row tiles too).  A
// warp takes the splits in that order from a counter, so the longest
// start first and none outlasts the rest, two rows a lane (one where a
// piece has at most 32), streaming each column once for all of a piece's
// rows: its lanes load
// 32 consecutive records (the d coordinates and the key in the slot) a
// chunk, the next chunk's load issued before the current one is
// computed, and a ballot on the keys keeps the columns above the piece's
// least key, the rest passed over by the whole warp; the kept records go
// through a per-warp shared buffer and every lane reads each one by
// broadcast.  A column tile whose largest key (kernels/packing.py::
// tile_max_key) is not above the piece's least key is not loaded at all.
// Sorted by key, a piece's keys lie in a narrow band, so these skips pass
// over most columns no row of it needs.  K11 walks the piece's spans;
// K16 walks its row tile's ring in ascending lb, the lanes testing 32
// entries a ballot (open: lb at most the piece's largest best d2, with
// d_cut^2 standing in for a row with none; needed: open, the tile's
// largest key above the piece's least and a span reaching it), and
// computes each needed entry's span columns after a fresh test of lb; the
// walk ends at the first entry that is not open, so each piece ends on
// its own and not at its tile's slowest row.
//
// Exactness.  Each row keeps (d2, index) as one 64-bit key, d2's bits
// above the index: d2 >= +0 or NaN, whose bits lie above +inf's, so the
// keys order as (d2, index) do, and a NaN d2 is never kept.  It starts at
// d_cut^2's bits with index 0 (0 where d_cut^2 is NaN), so a column is
// kept iff its key is above the row's, d2 < d_cut^2 and (d2, index) below
// the row's best: the lexicographic minimum in any visiting order, so K16
// equals K11 bit for bit.  Every pair of
// ring entry e has d2 >= lb[e] (LB_SHRINK) and lb ascends, so a piece
// whose rows' bests are all below lb[e] needs no later entry.  A row
// keyed +inf or NaN (padding) seeks nothing and never changes its best.
// `live` (optional, (row tiles, 2)) gets the entries each row tile's
// pieces computed and the longest walk among them.
constexpr int kHaloWarps = 4;   // warps a block
constexpr int kHaloPiece = 64;  // rows a piece at most (HALO_PIECE in
                                // kernels/packing.py): two a lane

struct HaloArgs {
  const float* x;          // (n, d) query rows
  const float* x_key;      // (n,) their keys
  const float4* rec;       // w records of w4 float4s, key in the slot
  const float* tmax;       // each 512-column tile's largest key
  const int* starts;       // (n, s) spans, window-local
  const int* ends;
  const int* row_id;       // the rows, piece after piece
  int w4, w, d, s;
  unsigned long long init; // (d_cut^2, 0) as a best key
  unsigned long long* best;  // (n,) each row's best key
  const int* row_ptr;      // K16's ring
  const int* col_tile;
  const float* lb;
  int* live;               // K16, optional
};

// A lane's rows: coordinates, key (+inf: seeks nothing) and best key.
template <int D, int R>
struct HaloRows {
  float xr[R][D > 0 ? D : 1];
  const float* xg[R];
  float key[R];
  unsigned long long best[R];
};

__device__ __forceinline__ unsigned long long halo_key(float d2, int j) {
  return (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) |
         static_cast<unsigned>(j);
}

__device__ __forceinline__ float halo_d2(unsigned long long best) {
  return __uint_as_float(static_cast<unsigned>(best >> 32));
}

// The piece's rows against window columns [a, b), 32 a chunk.
template <int D, int R>
__device__ __forceinline__ void halo_cols(const HaloArgs& g, int a, int b,
                                          float kmin, float4* buf, int lane,
                                          HaloRows<D, R>& h) {
  constexpr int V = rec_vecs(D > 0 ? D : 1);
  const float* recf = reinterpret_cast<const float*>(g.rec);
  float4 nx[V];
  auto fetch = [&](int c0) {
    const int j = c0 + lane < b ? c0 + lane : a;
    if constexpr (D > 0) {
#pragma unroll
      for (int q = 0; q < V; ++q)
        nx[q] = g.rec[static_cast<size_t>(j) * V + q];
    } else {
      nx[0].x = recf[static_cast<size_t>(j) * 4 * g.w4 + g.d];
    }
  };
  fetch(a);
  for (int c0 = a; c0 < b; c0 += 32) {
    float4 cu[V];
#pragma unroll
    for (int q = 0; q < V; ++q) cu[q] = nx[q];
    if (c0 + 32 < b) fetch(c0 + 32);
    constexpr int kc = (D > 0 ? D : 0) % 4;  // the slot's place: D here
    const float4 kv = cu[(D > 0 ? D : 0) / 4];
    const float ck = kc == 0 ? kv.x : kc == 1 ? kv.y : kc == 2 ? kv.z : kv.w;
    unsigned todo = __ballot_sync(0xffffffffu, c0 + lane < b && ck > kmin);
    if (todo == 0) continue;
    if constexpr (D > 0) {
      __syncwarp();                   // the previous chunk's reads are done
#pragma unroll
      for (int q = 0; q < V; ++q) buf[lane * V + q] = cu[q];
      __syncwarp();
    }
#pragma unroll
    for (int c = 0; c < 32; ++c) {    // unrolled: constant buffer offsets
      if (!((todo >> c) & 1u)) continue;
      const int j = c0 + c;
      float y[4 * V];
      const float* yg = recf + static_cast<size_t>(j) * 4 * g.w4;
      if constexpr (D > 0) {
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const float4 f = buf[c * V + q];
          y[4 * q] = f.x;
          y[4 * q + 1] = f.y;
          y[4 * q + 2] = f.z;
          y[4 * q + 3] = f.w;
        }
      }
      float yk;
      if constexpr (D > 0) {
        yk = y[D];
      } else {
        yk = yg[g.d];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float d2;
        if constexpr (D > 0) {
          d2 = pair_d2<D>(h.xr[r], y, D);
        } else {
          d2 = pair_d2<0>(h.xg[r], yg, g.d);
        }
        const unsigned long long cand = halo_key(d2, j);
        if (yk > h.key[r] && cand < h.best[r]) h.best[r] = cand;
      }
    }
  }
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One piece's split (pc: first position in row_id, rows, the row whose
// spans it walks, its row tile; split `part` of `parts`), R rows a lane:
// K11 takes the part-th of `parts` equal slices of the piece's span
// columns, K16 every parts-th entry of its ring from the part-th.  The
// rows' bests merge by atomicMin into `best` (halo_decode_kernel).
template <int D, int R, bool kRing>
__device__ __forceinline__ void halo_piece(const HaloArgs& g, int4 pc,
                                           int part, int parts,
                                           float4* buf, int lane) {
  HaloRows<D, R> h;
  int row[R];
  float kmin = CUDART_INF_F;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = lane + 32 * r;
    row[r] = p < pc.y ? g.row_id[pc.x + p] : -1;
    h.xg[r] = g.x + static_cast<size_t>(row[r] >= 0 ? row[r] : 0) * g.d;
    if constexpr (D > 0) {
#pragma unroll
      for (int k = 0; k < D; ++k) h.xr[r][k] = h.xg[r][k];
    }
    const float k = row[r] >= 0 ? g.x_key[row[r]] : CUDART_INF_F;
    h.key[r] = k < CUDART_INF_F ? k : CUDART_INF_F;    // NaN: +inf
    h.best[r] = g.init;
    kmin = fminf(kmin, h.key[r]);
  }
  kmin = warp_min(kmin);
  if (!(kmin < CUDART_INF_F)) return;  // no row of the piece seeks
  const int* st = g.starts + static_cast<size_t>(pc.z) * g.s;
  const int* en = g.ends + static_cast<size_t>(pc.z) * g.s;
  if constexpr (!kRing) {
    // K11: the slice [c0, c1) of the spans' columns laid end to end, a
    // column tile passed over where its largest key is not above kmin
    long long cols = 0;
    for (int k = 0; k < g.s; ++k)
      cols += max(min(__ldg(en + k), g.w) - max(__ldg(st + k), 0), 0);
    const long long c0 = cols * part / parts;
    const long long c1 = cols * (part + 1) / parts;
    long long off = 0;
    for (int k = 0; k < g.s && off < c1; ++k) {
      const int a0 = max(__ldg(st + k), 0);
      const int b0 = min(__ldg(en + k), g.w);
      if (a0 >= b0) continue;
      const int a = a0 + static_cast<int>(max(c0 - off, 0LL));
      const int b = a0 + static_cast<int>(min(c1 - off,
                                              static_cast<long long>(b0 - a0)));
      off += b0 - a0;
      int ra = a;
      while (ra < b) {
        while (ra < b && !(__ldg(g.tmax + ra / kWlCols) > kmin))
          ra = (ra / kWlCols + 1) * kWlCols;
        int rb = ra;
        while (rb < b && __ldg(g.tmax + rb / kWlCols) > kmin)
          rb = min(b, (rb / kWlCols + 1) * kWlCols);
        if (ra < rb) halo_cols<D, R>(g, ra, rb, kmin, buf, lane, h);
        ra = rb;
      }
    }
  } else {
    // K16: the row tile's ring, ascending lb, every parts-th entry
    auto bests = [&]() {
      float v = -CUDART_INF_F;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (h.key[r] < CUDART_INF_F) v = fmaxf(v, halo_d2(h.best[r]));
      return warp_max(v);
    };
    float bmax = bests();
    const int e0 = g.row_ptr[pc.w];
    const int ne = (g.row_ptr[pc.w + 1] - e0 - part + parts - 1) / parts;
    int walked = 0;
    bool done = false;
    for (int m = 0; m < ne && !done; m += 32) {
      const int j = e0 + part + (m + lane) * parts;
      const float l = m + lane < ne ? g.lb[j] : CUDART_INF_F;
      const bool open = m + lane < ne && l <= bmax;
      int ct = 0;
      bool need = false;
      if (open) {
        ct = g.col_tile[j];
        if (g.tmax[ct] > kmin) {
          const int j0 = ct * kWlCols;
          const int j1 = min(j0 + kWlCols, g.w);
          for (int k = 0; k < g.s && !need; ++k)
            need = max(__ldg(st + k), j0) < min(__ldg(en + k), j1);
        }
      }
      unsigned todo = __ballot_sync(0xffffffffu, need);
      done = __ballot_sync(0xffffffffu, !open) != 0;  // open lanes first
      while (todo != 0) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        if (!(__shfl_sync(0xffffffffu, l, src) <= bmax)) {  // fresh: end
          done = true;
          break;
        }
        const int j0 = __shfl_sync(0xffffffffu, ct, src) * kWlCols;
        const int j1 = min(j0 + kWlCols, g.w);
        for (int k = 0; k < g.s; ++k) {
          const int a = max(__ldg(st + k), j0);
          const int b = min(__ldg(en + k), j1);
          if (a < b) halo_cols<D, R>(g, a, b, kmin, buf, lane, h);
        }
        bmax = bests();
        ++walked;
      }
    }
    if (g.live != nullptr && lane == 0) {
      // audit-merge: integer walk statistics of a row tile (a sum and a
      // maximum of entry counts), order-free, and read only as counts
      atomicAdd(g.live + 2 * pc.w, walked);
      atomicMax(g.live + 2 * pc.w + 1, walked);
    }
  }
  // audit-merge: 64-bit atomicMin on (d2 bits << 32 | window index): the
  // splits of a piece merge by a lexicographic minimum over a total order,
  // the same word in any order of arrival
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (row[r] >= 0 && h.best[r] < g.init) atomicMin(g.best + row[r],
                                                     h.best[r]);
}

// Persistent warps taking the pieces' splits from a counter in their
// order (kernels/packing.py::halo_layout: order, the positions, pieces'
// first ones first, most work first; plen, a piece's rows at its first
// position, else 0; item_end, the splits' running count along order;
// meta, the splits and the pieces in all).  halo_next hands a warp its
// next split i and the order slot lo of its piece: the first slot q with
// item_end[q] > i, where q <= i and q >= i - (splits - pieces), found by
// a 32-way search; false when none is left.
__device__ __forceinline__ bool halo_next(int* next_item,
                                          const int* __restrict__ item_end,
                                          const int* __restrict__ meta,
                                          int lane, int& i, int& lo) {
  const int items = meta[0];
  const int pieces = meta[1];
  i = 0;
  // audit-merge: a work-queue cursor that hands each warp its next split;
  // it schedules work and holds no data, and every split is computed by
  // one warp whatever order they are taken in
  if (lane == 0) i = atomicAdd(next_item, 1);
  i = __shfl_sync(0xffffffffu, i, 0);
  if (i >= items) return false;
  lo = max(0, i - (items - pieces));
  int hi = min(i, pieces - 1);
  while (lo < hi) {                   // the first q in [lo, hi] past i
    const int step = (hi - lo + 30) / 31;  // lane 31 reaches hi
    const int q = min(lo + lane * step, hi);
    const unsigned past = __ballot_sync(0xffffffffu, item_end[q] > i);
    const int f = __ffs(past) - 1;    // item_end[hi] > i: lane 31 is
    hi = min(lo + f * step, hi);
    if (f > 0) lo = lo + (f - 1) * step + 1;
  }
  return true;
}

template <int D, bool kRing>
__global__ void __launch_bounds__(32 * kHaloWarps)
    halo_nn_kernel(HaloArgs g, const int* __restrict__ plen,
                   const int* __restrict__ order,
                   const int* __restrict__ item_end,
                   const int* __restrict__ meta,
                   int* __restrict__ next_item) {
  constexpr int V = rec_vecs(D > 0 ? D : 1);
  __shared__ float4 bufs[kHaloWarps][D > 0 ? 32 * V : 1];
  if constexpr (D > 0) {
    g.d = D;
    g.w4 = V;
  }
  const int lane = threadIdx.x & 31;
  float4* buf = bufs[threadIdx.x >> 5];
  int i, lo;
  while (halo_next(next_item, item_end, meta, lane, i, lo)) {
    const int base = lo > 0 ? item_end[lo - 1] : 0;
    const int at = order[lo];
    const int rows = plen[at];
    const int src = g.row_id[at];
    const int4 pc = make_int4(at, rows, src, src / kWlRows);
    if (rows > 32) {
      halo_piece<D, 2, kRing>(g, pc, i - base, item_end[lo] - base, buf,
                              lane);
    } else {
      halo_piece<D, 1, kRing>(g, pc, i - base, item_end[lo] - base, buf,
                              lane);
    }
  }
}

// Every row's best key to the starting one.
__global__ void halo_fill_kernel(unsigned long long* __restrict__ best,
                                 int n, unsigned long long init) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) best[i] = init;
}

// (delta, window index, found) from each row's best key.
__global__ void halo_decode_kernel(
    const unsigned long long* __restrict__ best, int n,
    unsigned long long init, float* __restrict__ delta,
    int* __restrict__ arg, unsigned char* __restrict__ found) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long b = best[i];
  const bool f = b < init;
  delta[i] = f ? __fsqrt_rn(halo_d2(b)) : CUDART_INF_F;
  arg[i] = f ? static_cast<int>(b & 0xffffffffu) : -1;
  found[i] = f;
}

// K10 and K15 — replace the reference's density.range_count_halo, i.e.
// sweep.tile_sweep with SweepSpec(count=True, span=True)
// (repro/kernels/density.py:68-87, the span mask at sweep.py:199-205,
// pallas_call at :432), reached through ops.halo_density: the distributed
// halo strategy's rho phase, each shard row against its window (K10), and
// the same count over a span count worklist
// (PallasBackend.range_count_halo(layout="block-sparse"),
// repro/kernels/backend.py:729-740; blocksparse.build_flat_worklist(
// nn=None, starts=, ends=)) through ops.halo_density(worklist=...) (K15).
//
// Per query row: the count of the window rows inside its [start, end)
// spans (clipped to [0, W): empty, negative and reversed spans count
// nothing) with d2 < d_cut^2; K15 counts only the columns of its row
// tile's in_cut entries.  The spans of a row are disjoint (distinct
// candidate-cell prefixes), so the count is the span mask's.  A NaN
// coordinate makes d2 NaN, which is never below d_cut^2.
//
// Bound: f32 CUDA-core issue, 3d+1 operations for each column inside a
// row's spans (K15: inside its in_cut entries).  The parent kernels ran a
// thread a row (K10), each reading its span columns from global memory
// once per row, its lanes' walks of different lengths, and a block a
// 256-row tile (K15), staging each in_cut entry's 512 columns behind two
// barriers while each thread re-read its spans for every staged chunk.
//
// The design is K11's (halo_nn_kernel) without the key.  The wrapper
// groups the rows whose spans clip to the same columns into runs, the rows
// in position order, cut into pieces of at most kHaloPiece rows, ordered
// by their work, most first, the heaviest cut into splits
// (kernels/packing.py::halo_layout with no key, built on the card by
// repro_halo_layout; K15's runs are cut at its worklist's row tiles too).
// Persistent warps take the splits from a counter and stream each span
// column once for all of a piece's rows, in one of two forms:
//   * a row a lane (pieces of more than kCountBallot rows; two rows a
//     lane above 32): the lanes load 32 consecutive window records a
//     chunk, the next chunk's load issued before the current one is
//     computed, into a per-warp shared buffer that every lane reads by
//     broadcast, each row's count in a register;
//   * a column a lane (pieces of at most kCountBallot rows, d <= 8): each
//     lane holds one column of the chunk in registers, the piece's rows
//     sit in the warp's buffer, and for each row the warp counts its
//     columns within d_cut by __popc(__ballot_sync(...)) into the row's
//     lane, so no lane idles on a short piece.
// A split takes the part-th of `parts` equal slices of the piece's span
// columns; K15 computes only their stretches in the column tiles of its
// row tile's in_cut entries, read from a bit set its entry point builds
// first (count_cut_kernel; walking the entries instead, every parts-th
// one a split, cuts each span at every tile and measured slower, PERF.md
// §6).  A piece of one split stores its rows' counts; splits add theirs
// by atomicAdd into the zeroed counts, exact in any order, so K15 equals
// K10 bit for bit: every pair within d_cut lies in an in_cut entry, since
// its tile pair's lb is at most its d2 and a span reaches it.
constexpr int kCountBallot = 16;  // rows of a column-a-lane piece at most
                                  // (COUNT_BALLOT_ROWS in
                                  // kernels/packing.py)

struct CountArgs {
  const float* x;          // (n, d) query rows
  const float4* rec;       // w records of w4 float4s (the slot unread)
  const int* starts;       // (n, s) spans, window-local
  const int* ends;
  int w4, w, d, s;
  float d2cut;
  int* count;              // (n,) zeroed
  const unsigned* cut;     // K15: per row tile, cut_words words of bits,
  int cut_words;           // the column tiles of its in_cut entries
};

// A lane's rows (a row a lane): coordinates and counts.
template <int D, int R>
struct CountRows {
  float xr[R][D > 0 ? D : 1];
  const float* xg[R];
  int cnt[R];
};

// A row a lane: the piece's rows against window columns [a, b), a < b.
template <int D, int R>
__device__ __forceinline__ void count_rows(const CountArgs& g, int a, int b,
                                           float4* buf, int lane,
                                           CountRows<D, R>& h) {
  if constexpr (D > 0) {
    constexpr int V = rec_vecs(D);
    float4 nx[V];
    auto fetch = [&](int c0) {
      const int j = c0 + lane < b ? c0 + lane : a;
#pragma unroll
      for (int q = 0; q < V; ++q)
        nx[q] = g.rec[static_cast<size_t>(j) * V + q];
    };
    auto col = [&](int c) {
      float y[4 * V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float4 f = buf[c * V + q];
        y[4 * q] = f.x;
        y[4 * q + 1] = f.y;
        y[4 * q + 2] = f.z;
        y[4 * q + 3] = f.w;
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        h.cnt[r] += pair_d2<D>(h.xr[r], y, D) < g.d2cut;
    };
    fetch(a);
    for (int c0 = a; c0 < b; c0 += 32) {
      __syncwarp();                   // the previous chunk's reads are done
#pragma unroll
      for (int q = 0; q < V; ++q) buf[lane * V + q] = nx[q];
      __syncwarp();
      if (c0 + 32 < b) fetch(c0 + 32);
      if (b - c0 >= 32) {
#pragma unroll
        for (int c = 0; c < 32; ++c) col(c);  // constant buffer offsets
      } else {
        for (int c = 0; c < b - c0; ++c) col(c);
      }
    }
  } else {
    const float* recf = reinterpret_cast<const float*>(g.rec);
    for (int j = a; j < b; ++j) {
      const float* yg = recf + static_cast<size_t>(j) * 4 * g.w4;
#pragma unroll
      for (int r = 0; r < R; ++r)
        h.cnt[r] += pair_d2<0>(h.xg[r], yg, g.d) < g.d2cut;
    }
  }
}

// A column a lane: the piece's `rows` rows (in buf, V float4s a row)
// against window columns [a, b), a < b; lane r adds row r's count.
template <int D>
__device__ __forceinline__ void count_cols(const CountArgs& g, int a, int b,
                                           const float4* buf, int rows,
                                           int lane, int& cnt) {
  constexpr int V = rec_vecs(D);
  float4 nx[V];
  auto fetch = [&](int c0) {
    const int j = c0 + lane < b ? c0 + lane : a;
#pragma unroll
    for (int q = 0; q < V; ++q)
      nx[q] = g.rec[static_cast<size_t>(j) * V + q];
  };
  fetch(a);
  for (int c0 = a; c0 < b; c0 += 32) {
    float y[4 * V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      y[4 * q] = nx[q].x;
      y[4 * q + 1] = nx[q].y;
      y[4 * q + 2] = nx[q].z;
      y[4 * q + 3] = nx[q].w;
    }
    if (c0 + lane >= b) y[0] = CUDART_NAN_F;  // past b: d2 NaN, uncounted
    if (c0 + 32 < b) fetch(c0 + 32);
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      float xr[4 * V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float4 f = buf[r * V + q];
        xr[4 * q] = f.x;
        xr[4 * q + 1] = f.y;
        xr[4 * q + 2] = f.z;
        xr[4 * q + 3] = f.w;
      }
      const unsigned in =
          __ballot_sync(0xffffffffu, pair_d2<D>(xr, y, D) < g.d2cut);
      if (lane == r) cnt += __popc(in);
    }
  }
}

// The columns of split `part` of `parts` of the piece whose first position
// is p0 (its rows' spans are row p0's), as ranges [a, b) handed to visit:
// the part-th slice of the spans' columns laid end to end, and for K15
// only its stretches in the column tiles of the row tile's in_cut entries.
template <bool kWl, typename Visit>
__device__ __forceinline__ void count_ranges(const CountArgs& g, int p0,
                                             int part, int parts,
                                             Visit&& visit) {
  const int* st = g.starts + static_cast<size_t>(p0) * g.s;
  const int* en = g.ends + static_cast<size_t>(p0) * g.s;
  const unsigned* cut =
      g.cut + static_cast<size_t>(kWl ? p0 / kWlRows : 0) * g.cut_words;
  auto in_cut = [&](int j) {
    const int c = j / kWlCols;
    return ((__ldg(cut + (c >> 5)) >> (c & 31)) & 1u) != 0;
  };
  long long cols = 0;
  for (int k = 0; k < g.s; ++k)
    cols += max(min(__ldg(en + k), g.w) - max(__ldg(st + k), 0), 0);
  const long long c0 = cols * part / parts;
  const long long c1 = cols * (part + 1) / parts;
  long long off = 0;
  for (int k = 0; k < g.s && off < c1; ++k) {
    const int a0 = max(__ldg(st + k), 0);
    const int b0 = min(__ldg(en + k), g.w);
    if (a0 >= b0) continue;
    const long long len = b0 - a0;
    const int a = a0 + static_cast<int>(max(c0 - off, 0LL));
    const int b = a0 + static_cast<int>(min(c1 - off, len));
    off += len;
    if constexpr (!kWl) {
      if (a < b) visit(a, b);
    } else {
      int ra = a;
      while (ra < b) {
        while (ra < b && !in_cut(ra)) ra = (ra / kWlCols + 1) * kWlCols;
        int rb = ra;
        while (rb < b && in_cut(rb)) rb = min(b, (rb / kWlCols + 1) * kWlCols);
        if (ra < rb) visit(ra, rb);
        ra = rb;
      }
    }
  }
}

// A row's count from one split: stored where the piece has one split,
// else added.
__device__ __forceinline__ void count_out(const CountArgs& g, int row,
                                          int cnt, int parts) {
  if (parts == 1) {
    g.count[row] = cnt;
  } else if (cnt != 0) {
    // audit-merge: integer counts of a piece's splits, added into the
    // zeroed counts; integer addition is exact in any order
    atomicAdd(g.count + row, cnt);
  }
}

template <int D, int R, bool kWl>
__device__ __forceinline__ void count_piece_rows(const CountArgs& g, int p0,
                                                 int rows, int part,
                                                 int parts, float4* buf,
                                                 int lane) {
  CountRows<D, R> h;
  int row[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = lane + 32 * r;
    row[r] = p < rows ? p0 + p : -1;
    h.xg[r] = g.x + static_cast<size_t>(row[r] >= 0 ? row[r] : p0) * g.d;
    if constexpr (D > 0) {
#pragma unroll
      for (int k = 0; k < D; ++k) h.xr[r][k] = h.xg[r][k];
    }
    h.cnt[r] = 0;
  }
  count_ranges<kWl>(g, p0, part, parts, [&](int a, int b) {
    count_rows<D, R>(g, a, b, buf, lane, h);
  });
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (row[r] >= 0) count_out(g, row[r], h.cnt[r], parts);
}

template <int D, bool kWl>
__device__ __forceinline__ void count_piece_cols(const CountArgs& g, int p0,
                                                 int rows, int part,
                                                 int parts, float4* buf,
                                                 int lane) {
  constexpr int V = rec_vecs(D);
  __syncwarp();                       // the previous piece's reads are done
  if (lane < rows) {
    float v[4 * V] = {};
    const float* xg = g.x + static_cast<size_t>(p0 + lane) * D;
#pragma unroll
    for (int k = 0; k < D; ++k) v[k] = xg[k];
#pragma unroll
    for (int q = 0; q < V; ++q)
      buf[lane * V + q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
  __syncwarp();
  int cnt = 0;
  count_ranges<kWl>(g, p0, part, parts, [&](int a, int b) {
    count_cols<D>(g, a, b, buf, rows, lane, cnt);
  });
  if (lane < rows) count_out(g, p0 + lane, cnt, parts);
}

// Persistent warps taking the pieces' splits as halo_nn_kernel does.
template <int D, bool kWl>
__global__ void __launch_bounds__(32 * kHaloWarps)
    halo_count_kernel(CountArgs g, const int* __restrict__ plen,
                      const int* __restrict__ order,
                      const int* __restrict__ item_end,
                      const int* __restrict__ meta,
                      int* __restrict__ next_item) {
  constexpr int V = rec_vecs(D > 0 ? D : 1);
  __shared__ float4 bufs[kHaloWarps][D > 0 ? 32 * V : 1];
  if constexpr (D > 0) {
    g.d = D;
    g.w4 = V;
  }
  const int lane = threadIdx.x & 31;
  float4* buf = bufs[threadIdx.x >> 5];
  int i, lo;
  while (halo_next(next_item, item_end, meta, lane, i, lo)) {
    const int base = lo > 0 ? item_end[lo - 1] : 0;
    const int p0 = order[lo];
    const int rows = plen[p0];
    const int part = i - base;
    const int parts = item_end[lo] - base;
    if (rows > 32) {
      count_piece_rows<D, 2, kWl>(g, p0, rows, part, parts, buf, lane);
      continue;
    }
    if constexpr (D > 0) {
      if (rows <= kCountBallot) {
        count_piece_cols<D, kWl>(g, p0, rows, part, parts, buf, lane);
        continue;
      }
    }
    count_piece_rows<D, 1, kWl>(g, p0, rows, part, parts, buf, lane);
  }
}

// K15's in_cut column tiles as bits, a block a row tile (cut zeroed).
__global__ void count_cut_kernel(const int* __restrict__ row_ptr,
                                 const int* __restrict__ col_tile,
                                 const unsigned char* __restrict__ in_cut,
                                 int words, unsigned* __restrict__ cut) {
  const int t = blockIdx.x;
  for (int e = row_ptr[t] + threadIdx.x; e < row_ptr[t + 1];
       e += blockDim.x) {
    if (!in_cut[e]) continue;
    const int c = col_tile[e];
    // audit-merge: bitwise OR of one column tile's bit; OR is associative
    // and idempotent, so the bitmap does not depend on the order
    atomicOr(cut + static_cast<size_t>(t) * words + (c >> 5), 1u << (c & 31));
  }
}

// The layouts of K11/K16 and, with no key, of K10/K15 on the card, the
// arrays of kernels/packing.py::halo_layout (its plain version) built by a
// few kernels and cub's sorts, scans and sum, with no host round trip: the
// torch version's eighty-odd small launches left the card waiting on the
// host.  With no key the rows keep their positions: no sort by key.

// A span clipped to [0, w), an empty one as [0, 0).
__device__ __forceinline__ void halo_clip(int a, int b, int w, int& ca,
                                          int& cb) {
  ca = min(max(a, 0), w);
  cb = min(max(b, 0), w);
  if (cb <= ca) ca = cb = 0;
}

// Per row: whether it starts a run (the first row, a tile's first where
// tile_rows > 0, clipped spans unlike the previous row's), its span
// columns, and, where there are keys, its key's bits ordered as the keys
// (NaN as +inf).
__global__ void halo_rows_kernel(const int* __restrict__ starts,
                                 const int* __restrict__ ends,
                                 const float* __restrict__ x_key, int n,
                                 int s, int w, int tile_rows,
                                 int* __restrict__ newf,
                                 long long* __restrict__ cols,
                                 unsigned* __restrict__ korder) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool nw = i == 0 || (tile_rows > 0 && i % tile_rows == 0);
  long long c = 0;
  const size_t o = static_cast<size_t>(i) * s;
  for (int k = 0; k < s; ++k) {
    int a, b;
    halo_clip(starts[o + k], ends[o + k], w, a, b);
    c += b - a;
    if (!nw) {
      int pa, pb;
      halo_clip(starts[o - s + k], ends[o - s + k], w, pa, pb);
      nw = a != pa || b != pb;
    }
  }
  newf[i] = nw;
  cols[i] = c;
  if (x_key == nullptr) return;
  const float key = x_key[i];
  const unsigned bits = __float_as_uint(isnan(key) ? CUDART_INF_F : key);
  korder[i] = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

// Each run's first row, and the sort keys (run, key order) where there
// are keys (vals: the positions).
__global__ void halo_keys_kernel(const int* __restrict__ run,
                                 const int* __restrict__ newf,
                                 const unsigned* __restrict__ korder, int n,
                                 unsigned long long* __restrict__ keys,
                                 int* __restrict__ vals,
                                 int* __restrict__ rstart) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = run[i] - 1;
  if (korder != nullptr)
    keys[i] = (static_cast<unsigned long long>(r) << 32) | korder[i];
  vals[i] = i;
  if (newf[i]) rstart[r] = i;
}

// Per position (a run keeps its positions): its piece's rows where one
// starts there, else 0, and the piece's work (-1 where none starts): its
// span columns times their cost, K11/K16's a lane's rows (1 or 2), the
// count's (keyless) in 32nds of a row-a-lane chunk: 64, 32, or 2 a row
// for a column-a-lane piece (halo_count_kernel).
__global__ void halo_plen_kernel(const int* __restrict__ run,
                                 const int* __restrict__ rstart,
                                 const long long* __restrict__ cols, int n,
                                 int keyless, int* __restrict__ plen,
                                 int* __restrict__ work,
                                 int* __restrict__ vals) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = run[i] - 1;
  const int first = rstart[r];
  const int end = r + 1 < run[n - 1] ? rstart[r + 1] : n;
  const int len = (i - first) % kHaloPiece == 0 ? min(end - i, kHaloPiece)
                                                : 0;
  plen[i] = len;
  const int cost = !keyless ? (len > 32 ? 2 : 1)
                            : (len > 32 ? 64
                                        : len > kCountBallot ? 32 : 2 * len);
  const long long wk = cols[i] * cost;
  work[i] = len > 0 ? static_cast<int>(min(wk, static_cast<long long>(
                                                   INT_MAX)))
                    : -1;
  vals[i] = i;
}

__global__ void halo_w64_kernel(const int* __restrict__ work, int n,
                                long long* __restrict__ w64) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) w64[i] = max(work[i], 0);
}

// Splits of the piece at each order slot: its work over 1/splits of all.
__global__ void halo_split_kernel(const long long* __restrict__ w64,
                                  const int* __restrict__ plen,
                                  const int* __restrict__ order,
                                  const long long* __restrict__ total,
                                  long long splits, int n,
                                  int* __restrict__ nsplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long cap = max((*total + splits - 1) / splits, 1LL);
  nsplit[i] = plen[order[i]] > 0
                  ? static_cast<int>(max((w64[i] + cap - 1) / cap, 1LL))
                  : 0;
}

// meta: the splits, and the pieces (the order slots of work >= 0).
__global__ void halo_meta_kernel(const int* __restrict__ item_end,
                                 const int* __restrict__ work, int n,
                                 int* __restrict__ meta) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (work[mid] >= 0) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  meta[0] = item_end[n - 1];
  meta[1] = lo;
}

// The window's records: coordinates, the key's bits (0 with no key),
// zeros.
__global__ void halo_pack_kernel(const float* __restrict__ win,
                                 const float* __restrict__ w_key, int w,
                                 int d, int wf, float* __restrict__ rec) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(w) * wf) return;
  const int j = static_cast<int>(t / wf);
  const int k = static_cast<int>(t % wf);
  rec[t] = k < d ? win[static_cast<size_t>(j) * d + k]
                 : (k == d && w_key != nullptr ? w_key[j] : 0.0f);
}

// Each column tile's largest key, NaN left out, -inf where none: a warp
// a tile.
__global__ void halo_tmax_kernel(const float* __restrict__ w_key, int w,
                                 int tiles, float* __restrict__ tmax) {
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (t >= tiles) return;
  float v = -CUDART_INF_F;
  for (int j = t * kWlCols + lane; j < min((t + 1) * kWlCols, w); j += 32) {
    const float k = w_key[j];
    if (!isnan(k)) v = fmaxf(v, k);
  }
  v = warp_max(v);
  if (lane == 0) tmax[t] = v;
}

// ---------------------------------------------------------------- bf16
// The bf16 fused sweep (K12, K13) keeps the reference's arithmetic: the
// expanded form d2 = (|x|^2 + |y|^2) - 2 x.y of tile_d2(precision="bf16")
// (repro/kernels/sweep.py:104-119).  The norms are f32, summed over dims in
// order with __fmul_rn/__fadd_rn; x and y are rounded to bf16
// (__float2bfloat16_rn, jnp's astype; the columns by the wrapper, the
// same rounding), zero-padded to the MMA's k of 16, and their product runs
// on the tensor cores, mma.sync m16n8k16 bf16 x bf16 -> f32, k-step after
// k-step.  Each bf16 product is exact in f32, but the tensor cores' sum of
// 16 of them is not an in-order IEEE sum: the plain version
// (kernels/sweep.py, expanded_d2_bf16) sums in order, so the two agree bit
// for bit where every partial sum is exact (integer coordinates times a
// power of two) and within a few ulps of sum_k |x_k y_k| elsewhere.  A d2
// may be negative.
//
__host__ __device__ __forceinline__ int bf_kp(int d) {
  return (d + 15) / 16 * 16;
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// K12 — replaces the reference's ops.fused_sweep with precision="bf16", i.e.
// sweep.tile_sweep with SweepSpec(count=True, nn="topk", k=8, precision="bf16")
// (repro/kernels/sweep.py:432, distances tile_d2 at :104-119), gated by kSel as
// K1 is.
//
// Bound: the tensor-core work (2 * 16 * ceil(d/16) operations per pair at the
// bf16 rate) and the CUDA-core test each pair needs (an add and a compare at
// the f32 rate, the larger for every d <= 64); the exact epilogue runs on the
// few pairs that can be counted or kept.  The design spends on that test alone:
// the accumulators never leave the registers.
//
// The wrapper packs the columns once per call (kernels/packing.py,
// bf16_records): y in bf16, zero past d (8 values a column for d <= 8, else
// 16 * ceil(d/16)), the f32 norms y2 (sq_norms: in order, no FMA, the bits
// bf16_stage_cols computes), the test's halves y2 * (1/2 - 2^-21) and, gated,
// the gate bytes, all padded to a whole number of kK12Group columns (norm NaN:
// a padding column fails every test).  A block of kK12Warps warps (half as many
// where full blocks would not fill the SMs twice: the check shapes) owns 32
// rows a warp and streams the records through a two-stage cp.async ring, one
// barrier per stage of k12_stage_cols(d) columns, padded kBfPad apart past 8
// values so that the ldmatrix rows fall on distinct banks.  For d <= 16 each
// warp holds its A fragments (two m16 tiles of query rows) in registers for the
// whole sweep; larger d reads them per k-step from the block's staged rows.
// Each warp takes 16 columns at a time (two n8 tiles): mma.sync m16n8k16,
// k-step after k-step from zero, as the earlier kernel summed; lane (g, q) then
// holds rows g and g+8 at columns 2q and 2q+1 of each n8 tile in its C
// fragments.
//
// The epilogue on those registers has two levels.  A pair can matter only if
// its d2 = (x2 + y2) - 2 xy is below d2cut (the count) or at most its row's
// filter `cut` (the kept 8), so at most T = max(d2cut, cut).  Each value is
// first tested as xy >= lim + half (k12_lim: one add and one compare), which
// every pair with d2 <= T passes, for T of either sign: d2 rounds (x2 +
// y2) - 2 xy once and x2 + y2 once, within 2^-24 of each, and the test,
// with T moved up by |T| 2^-20, gives away 2^-21 of x2 + y2 + |T|, with
// 2^-100 for subnormals (a NaN or infinite norm fails it, and such a d2 is
// never counted or kept here).  The test is voted into one
// warp-uniform branch per 16 columns; inside it the exact epilogue, in the
// reference's order: (x2 + y2) - 2 xy with __fadd_rn/__fmul_rn/__fsub_rn, the
// count by a predicated add, and the filter d2 < cut (and, under kSel, the
// gate), voted again.  A group after one that the warp counted or filtered
// in skips the test and goes straight to the exact epilogue: where most
// groups hold a pair in the count, as on domain-1e5 data whose bf16 error
// dwarfs d_cut^2, the test would only add its two instructions (measured
// against a rule per ring stage, PERF.md).
//
// The kept 8 of a row live in one lane, its owner: lane (g, q) keeps row
// g + 8q of the warp (rows g and g+8 of m16 tile q >> 1 as its C fragments
// number them), 16 registers a lane.  Where the filter vote is taken, the
// lanes write the group's 16 x 32 d2 to the warp's queue in shared memory,
// column-major (kK12QLd apart, so that both the writes and the owners'
// reads fall on 32 distinct banks), and each owner reads its row's 16
// values in index order and inserts those below its 8th value (gated: whose
// gate is set), one warp vote a column.  Columns arrive in index order, so
// the strict `<` keeps the lexicographic (d2, index) rule and an insertion
// needs no index compare (k12_keep).  The filter `cut` of each of a lane's
// 4 rows is then its owner's 8th value, by shuffle, and the test's lim
// follows it.  At the end the 4 lanes of a row sum its count.  count, topv
// and topi equal the earlier kernel's bit for bit: the same MMAs on the same
// operands, the same f32 epilogue on every pair that can be counted or
// kept, and the lexicographic 8 least of the admissible columns.  A private
// kept-8 per lane for each of its 4 rows, merged by shuffle at the end,
// held 64 registers a lane and ran slower at 2^20 rows (PERF.md); with 16,
// ptxas fits the kernel in 80 registers, and 3 blocks share an SM.

// warps per K12 block (half as many where full blocks would not fill the
// SMs twice) and rows per full block: 2 m16 tiles a warp
constexpr int kK12Warps = 8;
constexpr int kK12Rows = 32 * kK12Warps;
constexpr int kK12Group = 16;               // columns per vote: 2 n8 tiles;
                                            // BF16_GROUP in kernels/packing.py
constexpr int kK12QLd = 36;                 // floats per queue column
constexpr int kK12StageBytes = 16384;       // bf16 records per ring stage

// bf16 values per packed column record and per staged one
__host__ __device__ inline int k12_rec(int d) { return d <= 8 ? 8 : bf_kp(d); }
__host__ __device__ inline int k12_ld(int d) {
  return d <= 8 ? 8 : bf_kp(d) + kBfPad;
}

// columns per ring stage: a whole number of vote groups
__host__ __device__ inline int k12_stage_cols(int d) {
  const int c = kK12StageBytes / (2 * k12_ld(d)) / kK12Group * kK12Group;
  return c > kK12Group ? c : kK12Group;
}

// bytes of one stage: records, norms, halves and (gated) gate bytes
__host__ __device__ inline int k12_stage_bytes(int d, bool sel) {
  return k12_stage_cols(d) * (2 * k12_ld(d) + 8 + (sel ? 1 : 0));
}

// dynamic shared memory: two stages, for d > 16 the staged rows, and the
// warps' queues
inline size_t k12_smem_bytes(int d, bool sel) {
  size_t b = 2 * static_cast<size_t>(k12_stage_bytes(d, sel));
  if (d > 16) b += sizeof(__nv_bfloat16) * kK12Rows * (bf_kp(d) + kBfPad);
  return b + sizeof(float) * kK12Warps * kK12Group * kK12QLd;
}

// Issue (and commit as one group) the copy of padded columns [j0, j0+cols)
// into stage st: records 16 bytes at a time, norms, halves and gate bytes
// (norms: 2 x m16, the norms then the halves).
__device__ __forceinline__ void k12_stage(unsigned char* st,
                                          const __nv_bfloat16* rec,
                                          const float* norms, int m16,
                                          const unsigned char* gate, int j0,
                                          int cols, int per_stage, int kr,
                                          int ld) {
  const int kc = kr / 8;                    // 16-byte chunks per record
  __nv_bfloat16* srec = reinterpret_cast<__nv_bfloat16*>(st);
  for (int t = threadIdx.x; t < cols * kc; t += blockDim.x) {
    const int c = t / kc;
    const int h = t - c * kc;
    cp_async16(reinterpret_cast<float4*>(srec + c * ld + h * 8),
               reinterpret_cast<const float4*>(
                   rec + (static_cast<size_t>(j0) + c) * kr + h * 8));
  }
  float* sy2 = reinterpret_cast<float*>(st + 2 * per_stage * ld);
  for (int t = threadIdx.x; t < cols / 2; t += blockDim.x) {
    const int h = t >= cols / 4;            // norms, then halves
    const int c = 4 * (t - h * (cols / 4));
    cp_async16(reinterpret_cast<float4*>(sy2 + h * per_stage + c),
               reinterpret_cast<const float4*>(norms + h * m16 + j0 + c));
  }
  if (gate != nullptr) {
    unsigned char* sg = st + per_stage * (2 * ld + 8);
    for (int t = threadIdx.x; t < cols / 16; t += blockDim.x)
      cp_async16(reinterpret_cast<float4*>(sg + 16 * t),
                 reinterpret_cast<const float4*>(gate + j0 + 16 * t));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(s));
}

// x[k], x[k+1] (zero at or past d) as bf16, k in the low half
__device__ __forceinline__ uint32_t bf16x2_at(const float* xr, int k, int d) {
  const uint32_t lo =
      __bfloat16_as_ushort(__float2bfloat16_rn(k < d ? xr[k] : 0.0f));
  const uint32_t hi =
      __bfloat16_as_ushort(__float2bfloat16_rn(k + 1 < d ? xr[k + 1] : 0.0f));
  return lo | (hi << 16);
}

// Insert (v, j) into a kept list sorted lexicographically by (d2, index),
// where (v, j) lies below its last entry: the entries before it stay, the
// rest move down one slot.  kIndex false: every index in the list is below
// j (K12's owner reads its row's columns in index order), so d2 alone
// orders; true: K13's columns arrive in lb order, and an equal d2 is
// settled on the index, as keep does.
template <bool kIndex>
__device__ __forceinline__ void k12_keep(float (&tv)[kTopK], int (&ti)[kTopK],
                                         float v, int j) {
  bool lt[kTopK];
#pragma unroll
  for (int s = 0; s < kTopK; ++s)
    lt[s] = v < tv[s] || (kIndex && v == tv[s] && j < ti[s]);
#pragma unroll
  for (int s = kTopK - 1; s > 0; --s) {
    tv[s] = lt[s] ? (lt[s - 1] ? tv[s - 1] : v) : tv[s];
    ti[s] = lt[s] ? (lt[s - 1] ? ti[s - 1] : j) : ti[s];
  }
  tv[0] = lt[0] ? v : tv[0];
  ti[0] = lt[0] ? j : ti[0];
}

// The row's share of the cheap test: xy >= k12_lim(x2, T) + y2 * (1/2 -
// 2^-21) holds for every pair with d2 <= T (see K12's note).  T is moved
// up by |T| 2^-20: K12's T is at least 0, K13's may be below it.
__device__ __forceinline__ float k12_lim(float x2, float t) {
  return 0.5f * (x2 * (1.0f - 0x1p-20f) - (t + fabsf(t) * 0x1p-20f)) -
         0x1p-100f;
}

// A warp's rows g + 16 mt + 8 h from row0 (past n: computed as row n-1):
// their f32 norms, in order, and for KC != 0 their A fragments (x as bf16,
// zero past d: k = 2q, 2q+1 and 2q+8, 2q+9).
template <int KC>
__device__ __forceinline__ void k12_rows(const float* __restrict__ x, int n,
                                         int d, int row0, int q,
                                         float (&x2)[2][2],
                                         uint32_t (&a)[2][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + mt * 16 + h * 8;
      const float* xr = x + static_cast<size_t>(i < n ? i : n - 1) * d;
      float s = __fmul_rn(xr[0], xr[0]);
      for (int k = 1; k < d; ++k) s = __fadd_rn(s, __fmul_rn(xr[k], xr[k]));
      x2[mt][h] = s;
      if constexpr (KC != 0) {
        a[mt][h] = bf16x2_at(xr, 2 * q, d);
        a[mt][h + 2] = bf16x2_at(xr, 2 * q + 8, d);
      }
    }
  }
}

// KC == 0: this thread's row i of the block (past n: row n-1) as bf16, zero
// past d, into row threadIdx.x of the staged rows.
template <int KC>
__device__ __forceinline__ void k12_stage_row(__nv_bfloat16* xs,
                                              const float* __restrict__ x,
                                              int n, int d, int kp, int i) {
  if constexpr (KC == 0) {
    const float* xr = x + static_cast<size_t>(i < n ? i : n - 1) * d;
    for (int k = 0; k < kp; ++k)
      xs[threadIdx.x * (kp + kBfPad) + k] =
          __float2bfloat16_rn(k < d ? xr[k] : 0.0f);
  }
}

// x.y of the warp's 32 rows and 16 staged columns, from zero, k-step after
// k-step: acc[mt][nt] is the C fragment of m16 tile mt and n8 tile nt.  bp
// is this lane's ldmatrix row address of B in the group (KC == 1: k-chunk 0
// of 16 columns; else chunks 0 and 1 of 8 columns twice), xa (KC == 0) its
// address of A in the staged rows, kp + kBfPad apart.
template <int KC>
__device__ __forceinline__ void k12_mma(float (&acc)[2][2][4],
                                        const uint32_t (&a)[2][4],
                                        const __nv_bfloat16* bp,
                                        const __nv_bfloat16* xa, int kp) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  if constexpr (KC == 1) {
    uint32_t b[2][2] = {{0u, 0u}, {0u, 0u}};
    ldmatrix_x2(b[0][0], b[1][0], bp);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      mma_bf16_16816(acc[0][nt], a[0], b[nt]);
      mma_bf16_16816(acc[1][nt], a[1], b[nt]);
    }
  } else if constexpr (KC == 2) {
    uint32_t b4[4];
    ldmatrix_x4(b4, bp);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const uint32_t b[2] = {b4[2 * nt], b4[2 * nt + 1]};
      mma_bf16_16816(acc[0][nt], a[0], b);
      mma_bf16_16816(acc[1][nt], a[1], b);
    }
  } else {
    for (int k0 = 0; k0 < kp; k0 += 16) {
      uint32_t b4[4];
      ldmatrix_x4(b4, bp + k0);
      uint32_t ak[2][4];
      ldmatrix_x4(ak[0], xa + k0);
      ldmatrix_x4(ak[1], xa + 16 * (kp + kBfPad) + k0);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint32_t b[2] = {b4[2 * nt], b4[2 * nt + 1]};
        mma_bf16_16816(acc[0][nt], ak[0], b);
        mma_bf16_16816(acc[1][nt], ak[1], b);
      }
    }
  }
}

// The 4 lanes of a row sum its counts; lane q, the owner of row i = row0 +
// 8q, writes it and its kept list (past n: nothing).
__device__ __forceinline__ void k12_write(int (&cnt)[2][2],
                                          const float (&tv)[kTopK],
                                          const int (&ti)[kTopK], int i,
                                          int q, int n, int* count,
                                          float* topv, int* topi) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      cnt[mt][h] += __shfl_xor_sync(0xffffffffu, cnt[mt][h], 1);
      cnt[mt][h] += __shfl_xor_sync(0xffffffffu, cnt[mt][h], 2);
    }
  if (i >= n) return;
  count[i] = q == 0 ? cnt[0][0] : q == 1 ? cnt[0][1] : q == 2 ? cnt[1][0]
                                                             : cnt[1][1];
  float4* ov = reinterpret_cast<float4*>(topv + static_cast<size_t>(i) * kTopK);
  int4* oi = reinterpret_cast<int4*>(topi + static_cast<size_t>(i) * kTopK);
  int o[kTopK];
#pragma unroll
  for (int s = 0; s < kTopK; ++s) o[s] = ti[s] == INT_MAX ? -1 : ti[s];
  ov[0] = make_float4(tv[0], tv[1], tv[2], tv[3]);
  ov[1] = make_float4(tv[4], tv[5], tv[6], tv[7]);
  oi[0] = make_int4(o[0], o[1], o[2], o[3]);
  oi[1] = make_int4(o[4], o[5], o[6], o[7]);
}

// KC: 1 for d <= 8 (one 16-byte chunk a column, the upper k-half zero), 2
// for d <= 16, 0 for any d (A per k-step from the staged rows).  inserted
// (optional, n, zeroed): each row's kept-list insertions.
template <int KC, bool kSel>
__global__ void __launch_bounds__(kK12Rows, 3)
    fused_count_topk_bf16_kernel(const float* __restrict__ x,
                                 const __nv_bfloat16* __restrict__ rec,
                                 const float* __restrict__ norms,
                                 const unsigned char* __restrict__ gate,
                                 int n, int m, int d, float d2cut,
                                 int* __restrict__ count,
                                 float* __restrict__ topv,
                                 int* __restrict__ topi,
                                 int* __restrict__ inserted) {
  extern __shared__ __align__(16) unsigned char k12_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int kp = bf_kp(d);
  const int kr = KC == 1 ? 8 : kp;
  const int ld = KC == 1 ? 8 : kp + kBfPad;
  const int per_stage = k12_stage_cols(d);
  const int stage = k12_stage_bytes(d, kSel);
  const int m16 = (m + kK12Group - 1) / kK12Group * kK12Group;

  // row g + 8h of m16 tile mt (past n: computes as row n-1, never
  // writes), its f32 norm, count, filter and test bound; this lane owns
  // the kept list of row g + 8q (mt = q >> 1, h = q & 1)
  const int row0 = blockIdx.x * blockDim.x + warp * 32 + g;
  float x2[2][2];
  int cnt[2][2];
  float cut[2][2];
  float lim[2][2];
  float tv[kTopK];
  int ti[kTopK];
  uint32_t a[2][4];
#pragma unroll
  for (int s2 = 0; s2 < kTopK; ++s2) {
    tv[s2] = CUDART_INF_F;
    ti[s2] = INT_MAX;
  }
  k12_rows<KC>(x, n, d, row0, q, x2, a);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      cnt[mt][h] = 0;
      cut[mt][h] = CUDART_INF_F;
      lim[mt][h] = k12_lim(x2[mt][h], CUDART_INF_F);
    }
  }
  // any d: the block's rows as bf16 (zero past d) after the ring
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(k12_raw + 2 * stage);
  k12_stage_row<KC>(xs, x, n, d, kp, blockIdx.x * blockDim.x + threadIdx.x);
  // the warp's queue: a group's candidate d2 of its 32 rows, column-major
  // (kK12QLd apart: the writes and the owners' reads hit distinct banks)
  float* queue = reinterpret_cast<float*>(
                     k12_raw + 2 * stage +
                     (KC == 0 ? sizeof(__nv_bfloat16) * kK12Rows *
                                    (kp + kBfPad)
                              : 0)) +
                 warp * kK12Group * kK12QLd;
  const int own = g + 8 * q;              // the row whose list this lane holds

  // this lane's ldmatrix row addresses: B of two n8 tiles and, for any d,
  // A of the warp's two m16 tiles
  const int b_off = KC == 1 ? (lane & 15) * ld
                            : ((lane & 7) + (lane >> 4) * 8) * ld +
                                  ((lane >> 3) & 1) * 8;
  const int a_off = (warp * 32 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                        (kp + kBfPad) + (lane >> 4) * 8;

  bool exact = true;   // the warp's last group counted or filtered in
  const int ntile = (m16 + per_stage - 1) / per_stage;
  if (ntile > 0)
    k12_stage(k12_raw, rec, norms, m16, kSel ? gate : nullptr, 0,
              min(per_stage, m16), per_stage, kr, ld);
  for (int t = 0; t < ntile; ++t) {
    const int j0 = t * per_stage;
    const int cols = min(per_stage, m16 - j0);
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < ntile)
      k12_stage(k12_raw + ((t + 1) & 1) * stage, rec, norms, m16,
                kSel ? gate : nullptr, j0 + per_stage,
                min(per_stage, m16 - j0 - per_stage), per_stage, kr, ld);
    const unsigned char* st = k12_raw + (t & 1) * stage;
    const __nv_bfloat16* srec = reinterpret_cast<const __nv_bfloat16*>(st);
    const float* sy2 = reinterpret_cast<const float*>(st + 2 * per_stage * ld);
    const float* shalf = sy2 + per_stage;
    const unsigned char* sg = st + per_stage * (2 * ld + 8);
    for (int c0 = 0; c0 < cols; c0 += kK12Group) {
      float acc[2][2][4];                  // [mt][nt][C fragment]
      k12_mma<KC>(acc, a, srec + c0 * ld + b_off, xs + a_off, kp);
      // the cheap test, an add and a compare a value
      if (!exact) {
        bool any[2][2] = {{false, false}, {false, false}};  // short chains
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float2 hy =
              *reinterpret_cast<const float2*>(shalf + c0 + nt * 8 + 2 * q);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              any[mt][nt] |= acc[mt][nt][e] >=
                             lim[mt][e >> 1] + ((e & 1) ? hy.y : hy.x);
        }
        exact = __any_sync(0xffffffffu, (any[0][0] || any[0][1]) ||
                                            (any[1][0] || any[1][1]));
        if (!exact) continue;              // a uniform branch
      }
      // the exact epilogue in place: acc becomes d2, in the reference's order
      const int counted = cnt[0][0] + cnt[0][1] + cnt[1][0] + cnt[1][1];
      bool keep_any[2][2] = {{false, false}, {false, false}};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 y2 =
            *reinterpret_cast<const float2*>(sy2 + c0 + nt * 8 + 2 * q);
        bool gt[2] = {true, true};
        if constexpr (kSel) {
          const unsigned short gb = *reinterpret_cast<const unsigned short*>(
              sg + c0 + nt * 8 + 2 * q);
          gt[0] = (gb & 0xffu) != 0;
          gt[1] = (gb >> 8) != 0;
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const float d2 = __fsub_rn(
                __fadd_rn(x2[mt][h], (e & 1) ? y2.y : y2.x),
                __fmul_rn(2.0f, acc[mt][nt][e]));
            acc[mt][nt][e] = d2;
            count_below(cnt[mt][h], d2, d2cut);
            keep_any[mt][nt] |= gt[e & 1] && d2 < cut[mt][h];
          }
      }
      const bool kept = __any_sync(0xffffffffu,
                                   (keep_any[0][0] || keep_any[0][1]) ||
                                       (keep_any[1][0] || keep_any[1][1]));
      exact = kept || __any_sync(0xffffffffu,
                                 cnt[0][0] + cnt[0][1] + cnt[1][0] +
                                         cnt[1][1] != counted);
      if (!kept) continue;
      // the group's values into the queue, then each row's owner takes
      // them in index order
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            queue[(nt * 8 + 2 * q + (e & 1)) * kK12QLd + g + 8 * (e >> 1) +
                  16 * mt] = acc[mt][nt][e];
      __syncwarp();
#pragma unroll 4
      for (int s = 0; s < kK12Group; ++s) {
        const float v = queue[s * kK12QLd + own];
        bool take = v < tv[kTopK - 1];
        if constexpr (kSel) take = take && sg[c0 + s] != 0;
        if (__any_sync(0xffffffffu, take)) {
          if (take) {
            k12_keep<false>(tv, ti, v, j0 + c0 + s);
            // audit-merge: an integer count of a row's kept-list
            // insertions, summed over its lanes; exact in any order
            if (inserted != nullptr && row0 + 8 * q < n)
              atomicAdd(inserted + row0 + 8 * q, 1);
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          cut[mt][h] = __shfl_sync(0xffffffffu, tv[kTopK - 1],
                                   (lane & ~3) | (2 * mt + h));
          lim[mt][h] = k12_lim(x2[mt][h], fmaxf(d2cut, cut[mt][h]));
        }
    }
  }
  k12_write(cnt, tv, ti, row0 + 8 * q, q, n, count, topv, topi);
}

// K13 — replaces the reference's ops.fused_sweep with precision="bf16" on a
// worklist, i.e. sweep.tile_sweep with SweepSpec(count=True, nn="topk",
// k=8, precision="bf16") over the PrefetchScalarGridSpec worklist grid
// (repro/kernels/sweep.py:432, liveness at :250-260, the masked kept-k at
// :300-316), gated by kSel.
//
// Bound: K12's per pair (the tensor-core cross term and the superset
// test's two f32 operations) on the pairs of the entries it computes.  The
// design is K12's body on K3's walk.  One block of kK12Warps warps (32
// rows a warp, as K12) owns one 256-row tile and walks its CSR segment
// row_ptr[t] .. row_ptr[t+1] in the stored order (ascending lb), reading
// K12's bf16 records (kernels/packing.py, bf16_records, packed once per
// call): each computed entry's columns (512; in the last column tile up to
// m rounded up to kK12Group, whose padding columns have NaN norms) stream
// through a two-stage cp.async ring in chunks of k13_stage_cols(d), one
// barrier per chunk.  The ring is filled in walk order ahead of the votes,
// so the next chunk is in flight while one is computed; a chunk of an
// entry the vote skips is dropped.  Row tiles launch in `order`, the
// longest in-d_cut prefix first, as K3's do (kernels/packing.py,
// heaviest_first).  Measured on an H100 (PERF.md): a third stage, 2 blocks
// an SM without spills, and the test without K12's carry were each no
// faster; 80 registers at 3 blocks spill 36-116 bytes.
//
// The liveness rule is the reference's.  At an entry's first chunk one
// block vote on fresh kept lists (__syncthreads_or over the owner lanes of
// the tile's real rows, after the previous entry's insertions): the entry
// is NN-live when its lb is at most some row's 8th kept d2.  A bf16 d2 may
// lie below the lb of its pair, even below 0, so every row inserts from
// every NN-live entry whatever its own 8th; only an NN-live entry enters
// the kept 8, only an in_cut entry counts, and an entry that is neither is
// skipped.  Past `split` (one past the tile's last in_cut entry,
// kernels/packing.py, phase_split) nothing counts, lb ascends and each 8th
// d2 only falls, so the first entry that fails the vote ends the walk.
//
// The epilogue is K12's on the C fragments in registers, the entry's kind
// in its test bound: T = max(d2cut, cut) for an in_cut, NN-live entry,
// d2cut for an in_cut one (no filter), cut for an NN-live one (no count;
// the cut may be below 0, which k12_lim allows).  While some row of the
// warp has T = +inf (fewer than 8 kept: an infinite d2 may still enter)
// the warp skips the test.  The count is a predicated add below d2cut
// (below -inf in an entry that does not count).  Columns arrive in lb
// order, not index order, so a later entry may hold a lower index at an
// equal d2: the lanes' filter is d2 <= cut, and each row's owner inserts
// its queued values lexicographically on (d2, index) (k12_keep<true>)
// where they lie below its last kept pair (gated: where the gate is set).
// count, topv, topi and live equal the earlier K13's (a 64-column x.y
// tile through shared memory and the full epilogue on every pair) bit for
// bit: the same MMAs on the same operands, the same f32 epilogue on every
// pair that can be counted or kept, the same votes.  Padding rows
// (past n) compute as row n-1, never vote and never write.  `live`
// (optional) gets the number of entries each row tile computed: its first
// `live` entries, where its in_cut entries lead.

// columns per K13 ring stage: K12's stage cut to a power of two that
// divides an entry's kWlCols
__host__ __device__ inline int k13_stage_cols(int d) {
  int c = kWlCols;
  while (c > kK12Group && c > k12_stage_cols(d)) c >>= 1;
  return c;
}

// bytes of one K13 stage: records, norms, halves and (gated) gate bytes
__host__ __device__ inline int k13_stage_bytes(int d, bool sel) {
  return k13_stage_cols(d) * (2 * k12_ld(d) + 8 + (sel ? 1 : 0));
}

// K13's dynamic shared memory: the ring, then K12's staged rows (d > 16)
// and queues
inline size_t k13_smem_bytes(int d, bool sel) {
  size_t b = 2 * static_cast<size_t>(k13_stage_bytes(d, sel));
  if (d > 16) b += sizeof(__nv_bfloat16) * kK12Rows * (bf_kp(d) + kBfPad);
  return b + sizeof(float) * kK12Warps * kK12Group * kK12QLd;
}

static_assert(kK12Rows == kWlRows, "a K13 block owns one row tile");

template <int KC, bool kSel>
__global__ void __launch_bounds__(kK12Rows, 3)
    worklist_count_topk_bf16_kernel(
        const float* __restrict__ x, const __nv_bfloat16* __restrict__ rec,
        const float* __restrict__ norms,
        const unsigned char* __restrict__ gate, int n, int m, int d,
        float d2cut, const int* __restrict__ order,
        const int* __restrict__ row_ptr, const int* __restrict__ split,
        const int* __restrict__ col_tile,
        const unsigned char* __restrict__ in_cut,
        const float* __restrict__ lb, int* __restrict__ count,
        float* __restrict__ topv, int* __restrict__ topi,
        int* __restrict__ live_out) {
  extern __shared__ __align__(16) unsigned char k13_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int kp = bf_kp(d);
  const int kr = KC == 1 ? 8 : kp;
  const int ld = KC == 1 ? 8 : kp + kBfPad;
  const int per_stage = k13_stage_cols(d);
  const int stage = k13_stage_bytes(d, kSel);
  const int m16 = (m + kK12Group - 1) / kK12Group * kK12Group;
  const int t = order[blockIdx.x];

  // as K12: rows g + 16 mt + 8 h of the warp, this lane the owner of row
  // g + 8q, which votes only if it is real
  const int row0 = t * kWlRows + warp * 32 + g;
  const bool real = row0 + 8 * q < n;
  float x2[2][2];
  int cnt[2][2];
  float cut[2][2];
  float lim[2][2];
  float tv[kTopK];
  int ti[kTopK];
  uint32_t a[2][4];
#pragma unroll
  for (int s2 = 0; s2 < kTopK; ++s2) {
    tv[s2] = CUDART_INF_F;
    ti[s2] = INT_MAX;
  }
  k12_rows<KC>(x, n, d, row0, q, x2, a);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      cnt[mt][h] = 0;
      cut[mt][h] = CUDART_INF_F;
    }
  }
  unsigned char* const tail = k13_raw + 2 * stage;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(tail);
  k12_stage_row<KC>(xs, x, n, d, kp, t * kWlRows + threadIdx.x);
  float* queue = reinterpret_cast<float*>(
                     tail + (KC == 0 ? sizeof(__nv_bfloat16) * kK12Rows *
                                           (kp + kBfPad)
                                     : 0)) +
                 warp * kK12Group * kK12QLd;
  const int own = g + 8 * q;
  const int b_off = KC == 1 ? (lane & 15) * ld
                            : ((lane & 7) + (lane >> 4) * 8) * ld +
                                  ((lane >> 3) & 1) * 8;
  const int a_off = (warp * 32 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                        (kp + kBfPad) + (lane >> 4) * 8;

  bool ecut = false;   // the entry counts
  bool elive = false;  // the entry is NN-live
  float thr = -CUDART_INF_F;  // the count's bound: d2cut, or -inf
  bool open = true;    // some row of the warp has T = +inf: no test
  // the test bound of each row from the entry's kind and its cut
  auto bounds = [&]() {
    bool inf = false;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float tb = fmaxf(ecut ? d2cut : -CUDART_INF_F,
                               elive ? cut[mt][h] : -CUDART_INF_F);
        lim[mt][h] = k12_lim(x2[mt][h], tb);
        inf |= tb == CUDART_INF_F;
      }
    open = __any_sync(0xffffffffu, inf);
  };

  const int e0 = row_ptr[t];
  const int p1 = split[t];
  const int e1 = row_ptr[t + 1];
  // the ring is filled in walk order: pe, pj the next chunk to stage
  int pe = e0, pj = 0, pend = 0;
  if (pe < e1) {
    pj = col_tile[pe] * kWlCols;
    pend = min(pj + kWlCols, m16);
  }
  auto issue = [&](int buf) {
    if (pe >= e1) return;
    const int cols = min(per_stage, pend - pj);
    k12_stage(k13_raw + buf * stage, rec, norms, m16, kSel ? gate : nullptr,
              pj, cols, per_stage, kr, ld);
    pj += cols;
    if (pj >= pend && ++pe < e1) {
      pj = col_tile[pe] * kWlCols;
      pend = min(pj + kWlCols, m16);
    }
  };
  issue(0);
  int ce = e0, cj = 0, cend = 0;  // the chunk to compute
  if (ce < e1) {
    cj = col_tile[ce] * kWlCols;
    cend = min(cj + kWlCols, m16);
  }
  int b = 0;
  bool head = true;    // it is its entry's first
  bool skip = false;   // its entry is skipped
  bool exact = true;   // the warp's last group counted or filtered in
  int visited = 0;
  while (ce < e1) {
    const int j0 = cj;
    const int cols = min(per_stage, cend - cj);
    cp_async_wait_all();
    if (head) {
      ecut = in_cut[ce] != 0;
      elive = __syncthreads_or(real && lb[ce] <= tv[kTopK - 1]) != 0;
      skip = !ecut && !elive;       // the same for every thread
      if (skip && ce >= p1) break;  // this entry and all later are dead
      if (!skip) {
        ++visited;
        thr = ecut ? d2cut : -CUDART_INF_F;
        bounds();
      }
    } else {
      __syncthreads();
    }
    issue(b ^ 1);                  // the buffer computed last
    cj += cols;
    head = cj >= cend;
    if (head && ++ce < e1) {
      cj = col_tile[ce] * kWlCols;
      cend = min(cj + kWlCols, m16);
    }
    const unsigned char* st = k13_raw + b * stage;
    b ^= 1;
    if (skip) continue;
    const __nv_bfloat16* srec = reinterpret_cast<const __nv_bfloat16*>(st);
    const float* sy2 = reinterpret_cast<const float*>(st + 2 * per_stage * ld);
    const float* shalf = sy2 + per_stage;
    const unsigned char* sg = st + per_stage * (2 * ld + 8);
    for (int c0 = 0; c0 < cols; c0 += kK12Group) {
      float acc[2][2][4];                  // [mt][nt][C fragment]
      k12_mma<KC>(acc, a, srec + c0 * ld + b_off, xs + a_off, kp);
      if (!exact && !open) {               // K12's cheap test
        bool any[2][2] = {{false, false}, {false, false}};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float2 hy =
              *reinterpret_cast<const float2*>(shalf + c0 + nt * 8 + 2 * q);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              any[mt][nt] |= acc[mt][nt][e] >=
                             lim[mt][e >> 1] + ((e & 1) ? hy.y : hy.x);
        }
        exact = __any_sync(0xffffffffu, (any[0][0] || any[0][1]) ||
                                            (any[1][0] || any[1][1]));
        if (!exact) continue;              // a uniform branch
      }
      const int counted = cnt[0][0] + cnt[0][1] + cnt[1][0] + cnt[1][1];
      bool keep_any[2][2] = {{false, false}, {false, false}};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 y2 =
            *reinterpret_cast<const float2*>(sy2 + c0 + nt * 8 + 2 * q);
        bool gt[2] = {true, true};
        if constexpr (kSel) {
          const unsigned short gb = *reinterpret_cast<const unsigned short*>(
              sg + c0 + nt * 8 + 2 * q);
          gt[0] = (gb & 0xffu) != 0;
          gt[1] = (gb >> 8) != 0;
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const float d2 = __fsub_rn(
                __fadd_rn(x2[mt][h], (e & 1) ? y2.y : y2.x),
                __fmul_rn(2.0f, acc[mt][nt][e]));
            acc[mt][nt][e] = d2;
            count_below(cnt[mt][h], d2, thr);
            keep_any[mt][nt] |= gt[e & 1] && d2 <= cut[mt][h];
          }
      }
      const bool kept =
          elive && __any_sync(0xffffffffu,
                              (keep_any[0][0] || keep_any[0][1]) ||
                                  (keep_any[1][0] || keep_any[1][1]));
      exact = kept || __any_sync(0xffffffffu,
                                 cnt[0][0] + cnt[0][1] + cnt[1][0] +
                                         cnt[1][1] != counted);
      if (!kept) continue;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            queue[(nt * 8 + 2 * q + (e & 1)) * kK12QLd + g + 8 * (e >> 1) +
                  16 * mt] = acc[mt][nt][e];
      __syncwarp();
#pragma unroll 4
      for (int s = 0; s < kK12Group; ++s) {
        const float v = queue[s * kK12QLd + own];
        const int j = j0 + c0 + s;
        bool take = v < tv[kTopK - 1] ||
                    (v == tv[kTopK - 1] && j < ti[kTopK - 1]);
        if constexpr (kSel) take = take && sg[c0 + s] != 0;
        if (__any_sync(0xffffffffu, take)) {
          if (take) k12_keep<true>(tv, ti, v, j);
        }
      }
      __syncwarp();
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          cut[mt][h] = __shfl_sync(0xffffffffu, tv[kTopK - 1],
                                   (lane & ~3) | (2 * mt + h));
      bounds();
    }
  }
  // nothing is in flight here: the walk ends at a chunk's wait
  if (live_out != nullptr && threadIdx.x == 0) live_out[t] = visited;
  k12_write(cnt, tv, ti, row0 + 8 * q, q, n, count, topv, topi);
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

// Launch a kernel with `bytes` of dynamic shared memory, above the 48 KB
// default where d needs it (K1, K2, K3, K12, K13).
template <typename Kernel, typename... Args>
int smem_launch(Kernel kernel, dim3 grid, int threads, size_t bytes,
                cudaStream_t s, Args... args) {
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<grid, threads, bytes, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// K1.  rec: m packed records of w floats (kernels/packing.py), the slot
// holding the gate when sel is nonzero (a column with slot 0 never enters
// the kept 8).
extern "C" int repro_fused_count_topk(const float* x, const float* rec, int w,
                                      int n, int m, int d, float d2cut,
                                      int sel, int* count, float* topv,
                                      int* topi, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (w != 4 * rec_vecs(d)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kK1R * kNnThreads - 1) / (kK1R * kNnThreads));
  const size_t bytes = ring_bytes(w / 4);
  const float4* r4 = reinterpret_cast<const float4*>(rec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code = 0;
#define REPRO_LAUNCH(D)                                                    \
  code = sel ? smem_launch(fused_count_topk_kernel<D, true>, grid,         \
                           kNnThreads, bytes, s, x, r4, w / 4, n, m, d,    \
                           d2cut, count, topv, topi)                       \
             : smem_launch(fused_count_topk_kernel<D, false>, grid,        \
                           kNnThreads, bytes, s, x, r4, w / 4, n, m, d,    \
                           d2cut, count, topv, topi)
  REPRO_DISPATCH_D(d, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  return code;
}

// K3.  rec: m packed records of w floats (kernels/packing.py), the slot
// holding the gate when sel is nonzero; krec: phase 2's records, the slot
// holding the column index, grouped by column tile, tile c at [koff[c],
// koff[c+1]) (koff null: krec is y's records in order, tile c at columns
// [512c, 512c+512)); split: each row tile's end of phase 1; order: the row
// tiles in launch order.  live (optional): entries each row tile computed;
// ran (optional, (row tiles, 2), zeroed): the pairs each phase ran.
extern "C" int repro_worklist_count_topk(
    const float* x, const float* rec, const float* krec, const int* koff,
    int w, int n, int m, int d, float d2cut, int sel, const int* order,
    const int* row_ptr, const int* split, const int* col_tile,
    const unsigned char* in_cut, const float* lb, int* count, float* topv,
    int* topi, int* live, unsigned long long* ran, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (w != 4 * rec_vecs(d)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kWlRows - 1) / kWlRows);
  const size_t bytes = k3_smem_bytes(w / 4, d);
  const float4* r4 = reinterpret_cast<const float4*>(rec);
  const float4* k4 = reinterpret_cast<const float4*>(krec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code = 0;
#define REPRO_LAUNCH(D)                                                    \
  code = sel ? smem_launch(worklist_count_topk_kernel<D, true>, grid,      \
                           kNnThreads, bytes, s, x, r4, k4, koff, w / 4,   \
                           n, m, d, d2cut, order, row_ptr, split,          \
                           col_tile, in_cut, lb, count, topv, topi, live,  \
                           ran)                                            \
             : smem_launch(worklist_count_topk_kernel<D, false>, grid,     \
                           kNnThreads, bytes, s, x, r4, k4, koff, w / 4,   \
                           n, m, d, d2cut, order, row_ptr, split,          \
                           col_tile, in_cut, lb, count, topv, topi, live,  \
                           ran)
  REPRO_DISPATCH_D(d, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  return code;
}

// K2's rows per block: the work list's row blocks (kernels/packing.py).
extern "C" int repro_masked_nn_block_rows() { return kK2R * kNnThreads; }

// K2.  x: the n query rows sorted by ends (ascending); row_id: each sorted
// row's original slot; rec: the columns' packed records (w floats, the
// slot holding the original index) sorted by key, descending; items:
// n_items (row block, chunk start, chunk end, 0).  packed (n, scratch)
// gets the merged (d2 bits << 32 | index); best and arg (n) the decoded
// (d2, index) in the original row order, (inf, -1) where none is denser.
extern "C" int repro_masked_nn(const float* x, const int* row_id,
                               const int* ends, const float* rec, int w,
                               const int* items, int n_items, int n, int d,
                               unsigned long long* packed, float* best,
                               int* arg, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (w != 4 * rec_vecs(d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t set = cudaMemsetAsync(
      packed, 0xFF, static_cast<size_t>(n) * sizeof(*packed), s);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n_items > 0) {
    const size_t bytes = ring_bytes(w / 4);
    const float4* r4 = reinterpret_cast<const float4*>(rec);
    const int4* it = reinterpret_cast<const int4*>(items);
    int code = 0;
#define REPRO_LAUNCH(D)                                                    \
  code = smem_launch(masked_nn_kernel<D, false>, dim3(n_items), kNnThreads, \
                     bytes, s, x, row_id, ends, r4, w / 4, it, n, 0, 0, d,   \
                     packed)
    REPRO_DISPATCH_D(d, REPRO_LAUNCH)
#undef REPRO_LAUNCH
    if (code != 0) return code;
  }
  gather_nn_decode_kernel<<<(n + kAuxThreads - 1) / kAuxThreads,
                            kAuxThreads, 0, s>>>(packed, n, best, arg);
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

// K6's key form (its prefix form is repro_masked_nn on the gathered rows).
// x: the n gathered rows sorted by x_key (ascending; +inf for a padding
// slot or a NaN key); row_id: each sorted row's slot position; rec: the m
// table rows as packed records (w floats), the slot holding the row's key
// bits, in index order.  packed (n, scratch) gets the merged (d2 bits << 32
// | index); best and arg (n) the decoded (d2, index) in slot order, (inf,
// -1) where none is denser.  m == 0 runs only the decode.
extern "C" int repro_gather_masked_nn(const float* x, const float* x_key,
                                      const int* row_id, const float* rec,
                                      int w, int n, int m, int d,
                                      unsigned long long* packed, float* best,
                                      int* arg, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (w != 4 * rec_vecs(d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t set = cudaMemsetAsync(
      packed, 0xFF, static_cast<size_t>(n) * sizeof(*packed), s);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (m > 0) {
    const float4* r4 = reinterpret_cast<const float4*>(rec);
    int code = 0;
#define REPRO_LAUNCH(D) \
  code = launch_gather_nn<D>(x, x_key, row_id, r4, w / 4, n, m, d, packed, s)
    REPRO_DISPATCH_D(d, REPRO_LAUNCH)
#undef REPRO_LAUNCH
    if (code != 0) return code;
  }
  gather_nn_decode_kernel<<<(n + kAuxThreads - 1) / kAuxThreads,
                            kAuxThreads, 0, s>>>(packed, n, best, arg);
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
  worklist_range_count_kernel<D, false><<<grid, kWlRows, 0, s>>>(          \
      x, y, nullptr, n, m, d, d2cut, row_ptr, col_tile, in_cut, count,     \
      nullptr)
    REPRO_DISPATCH_D(d, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

// K9.  rec: y's packed records of w floats (kernels/packing.py), the slot
// holding the column's key; tmax: each column tile's largest key, NaN keys
// left out; next_row: one int32 of scratch.  live (optional, (row tiles,
// 2) int32): the entries each row tile's rows computed and the longest
// walk among them.
extern "C" int repro_worklist_masked_nn(
    const float* x, const float* x_key, const float* rec, int w, int n,
    int m, int d, const int* row_ptr, const int* col_tile, const float* lb,
    const float* tmax, int* next_row, float* best, int* arg, int* live,
    void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (w != 4 * rec_vecs(d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(next_row, 0, sizeof(int), s);
  if (err == cudaSuccess && live != nullptr)
    err = cudaMemsetAsync(
        live, 0, 2 * sizeof(int) * ((n + kWlRows - 1) / kWlRows), s);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float4* r4 = reinterpret_cast<const float4*>(rec);
  const dim3 grid(min((n + kK9Warps - 1) / kK9Warps, sms * kK9Blocks));
  const bool bulk = n >= sms * kK9BulkRows;
#define REPRO_LAUNCH(D)                                                   \
  if (bulk) {                                                             \
    worklist_masked_nn_kernel<D, false><<<grid, 32 * kK9Warps, 0, s>>>(   \
        x, x_key, r4, w / 4, n, m, d, row_ptr, col_tile, lb, tmax,        \
        next_row, best, arg, live);                                       \
  } else {                                                                \
    worklist_masked_nn_kernel<D, true><<<grid, 32 * kK9Warps, 0, s>>>(    \
        x, x_key, r4, w / 4, n, m, d, row_ptr, col_tile, lb, tmax,        \
        next_row, best, arg, live);                                       \
  }
  REPRO_DISPATCH_D(d, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// K10 and K15: the halo count over packed window records
// (kernels/packing.py: rec w floats a record; plen, order, item_end and
// meta from halo_layout with no key, K15's runs cut at its worklist's row
// tiles; starts, ends: (n, s) int32, row-major, window-local [start, end)
// spans); scratch: next_item, one int32.  count is zeroed here.
template <bool kWl>
int launch_halo_count(CountArgs g, const int* plen, const int* order,
                      const int* item_end, const int* meta, int n,
                      int* next_item, cudaStream_t s) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (g.w4 != rec_vecs(g.d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(next_item, 0, sizeof(int), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(g.count, 0, sizeof(int) * static_cast<size_t>(n),
                          s);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // at most one piece a row, mostly fewer: a warp for every 32 rows
  const int want = (n + 32 * kHaloWarps - 1) / (32 * kHaloWarps);
#define REPRO_LAUNCH(D)                                                    \
  {                                                                        \
    int per_sm = 0;                                                        \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                   \
        &per_sm, halo_count_kernel<D, kWl>, 32 * kHaloWarps, 0);           \
    if (err != cudaSuccess) return static_cast<int>(err);                  \
    const dim3 grid(min(want, sms * max(per_sm, 1)));                      \
    halo_count_kernel<D, kWl><<<grid, 32 * kHaloWarps, 0, s>>>(            \
        g, plen, order, item_end, meta, next_item);                        \
  }
  REPRO_DISPATCH_D(g.d, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_halo_range_count(
    const float* x, const float* rec, int w, const int* starts,
    const int* ends, const int* plen, const int* order, const int* item_end,
    const int* meta, int n, int m, int d, int s, float d2cut, int* next_item,
    int* count, void* stream) {
  const CountArgs g{x, reinterpret_cast<const float4*>(rec), starts, ends,
                    w / 4, m, d, s, d2cut, count, nullptr, 0};
  return launch_halo_count<false>(g, plen, order, item_end, meta, n,
                                  next_item,
                                  static_cast<cudaStream_t>(stream));
}

// K15: K10's count over the in_cut entries of a span count worklist; cut:
// scratch of ceil(n / kWlRows) x ceil(ceil(m / kWlCols) / 32) words.
extern "C" int repro_worklist_halo_range_count(
    const float* x, const float* rec, int w, const int* starts,
    const int* ends, const int* plen, const int* order, const int* item_end,
    const int* meta, int n, int m, int d, int s, float d2cut,
    const int* row_ptr, const int* col_tile, const unsigned char* in_cut,
    unsigned* cut, int* next_item, int* count, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kWlRows - 1) / kWlRows;
  const int words = ((m + kWlCols - 1) / kWlCols + 31) / 32;
  const cudaError_t err = cudaMemsetAsync(
      cut, 0, sizeof(unsigned) * static_cast<size_t>(tiles) * words, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  count_cut_kernel<<<tiles, kCutThreads, 0, st>>>(row_ptr, col_tile, in_cut,
                                                  words, cut);
  const CountArgs g{x, reinterpret_cast<const float4*>(rec), starts, ends,
                    w / 4, m, d, s, d2cut, count, cut, words};
  return launch_halo_count<true>(g, plen, order, item_end, meta, n,
                                 next_item, st);
}

// The halo layouts (kernels/packing.py::halo_layout; x_key and w_key null:
// the count's, with no key): scratch of
// repro_halo_layout_scratch(n) bytes, the outputs sized as there (tmax
// unwritten with no key).
namespace {

struct HaloScratch {
  int* newf;
  int* run;
  long long* cols;
  unsigned* korder;
  unsigned long long* keys;
  unsigned long long* keys_out;
  int* vals;
  int* rstart;
  int* work;
  int* work_sorted;
  long long* w64;
  int* nsplit;
  long long* total;
  void* temp;
  size_t temp_bytes;
  size_t bytes;
};

HaloScratch halo_scratch(char* base, int n) {
  HaloScratch h{};
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base == nullptr ? nullptr : base + off;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  const size_t m = static_cast<size_t>(n);
  h.newf = reinterpret_cast<int*>(take(4 * m));
  h.run = reinterpret_cast<int*>(take(4 * m));
  h.cols = reinterpret_cast<long long*>(take(8 * m));
  h.korder = reinterpret_cast<unsigned*>(take(4 * m));
  h.keys = reinterpret_cast<unsigned long long*>(take(8 * m));
  h.keys_out = reinterpret_cast<unsigned long long*>(take(8 * m));
  h.vals = reinterpret_cast<int*>(take(4 * m));
  h.rstart = reinterpret_cast<int*>(take(4 * m));
  h.work = reinterpret_cast<int*>(take(4 * m));
  h.work_sorted = reinterpret_cast<int*>(take(4 * m));
  h.w64 = reinterpret_cast<long long*>(take(8 * m));
  h.nsplit = reinterpret_cast<int*>(take(4 * m));
  h.total = reinterpret_cast<long long*>(take(8));
  size_t t = 0, b = 0;
  cub::DeviceScan::InclusiveSum(nullptr, b, static_cast<int*>(nullptr),
                                static_cast<int*>(nullptr), n);
  t = b > t ? b : t;
  cub::DeviceRadixSort::SortPairs(
      nullptr, b, static_cast<unsigned long long*>(nullptr),
      static_cast<unsigned long long*>(nullptr), static_cast<int*>(nullptr),
      static_cast<int*>(nullptr), n);
  t = b > t ? b : t;
  cub::DeviceRadixSort::SortPairsDescending(
      nullptr, b, static_cast<int*>(nullptr), static_cast<int*>(nullptr),
      static_cast<int*>(nullptr), static_cast<int*>(nullptr), n);
  t = b > t ? b : t;
  cub::DeviceReduce::Sum(nullptr, b, static_cast<long long*>(nullptr),
                         static_cast<long long*>(nullptr), n);
  t = b > t ? b : t;
  h.temp = take(t);
  h.temp_bytes = t;
  h.bytes = off;
  return h;
}

}  // namespace

extern "C" long long repro_halo_layout_scratch(int n) {
  return static_cast<long long>(halo_scratch(nullptr, n).bytes);
}

extern "C" int repro_halo_layout(const int* starts, const int* ends,
                                 const float* x_key, const float* win,
                                 const float* w_key, int n, int w, int d,
                                 int s, int ring, long long splits,
                                 void* scratch, long long scratch_bytes,
                                 float* rec, float* tmax, int* row_id,
                                 int* plen, int* order, int* item_end,
                                 int* meta, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  HaloScratch h = halo_scratch(static_cast<char*>(scratch), n);
  if (static_cast<long long>(h.bytes) > scratch_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = (n + kAuxThreads - 1) / kAuxThreads;
  size_t tb = h.temp_bytes;
  halo_rows_kernel<<<g, kAuxThreads, 0, st>>>(starts, ends, x_key, n, s, w,
                                              ring ? kWlRows : 0, h.newf,
                                              h.cols, h.korder);
  cudaError_t err = cub::DeviceScan::InclusiveSum(h.temp, tb, h.newf, h.run,
                                                  n, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool keyless = x_key == nullptr;
  halo_keys_kernel<<<g, kAuxThreads, 0, st>>>(h.run, h.newf,
                                              keyless ? nullptr : h.korder, n,
                                              h.keys,
                                              keyless ? row_id : h.vals,
                                              h.rstart);
  if (!keyless) {
    tb = h.temp_bytes;
    err = cub::DeviceRadixSort::SortPairs(h.temp, tb, h.keys, h.keys_out,
                                          h.vals, row_id, n, 0, 64, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  halo_plen_kernel<<<g, kAuxThreads, 0, st>>>(h.run, h.rstart, h.cols, n,
                                              keyless, plen, h.work, h.vals);
  tb = h.temp_bytes;
  err = cub::DeviceRadixSort::SortPairsDescending(
      h.temp, tb, h.work, h.work_sorted, h.vals, order, n, 0, 32, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  halo_w64_kernel<<<g, kAuxThreads, 0, st>>>(h.work_sorted, n, h.w64);
  tb = h.temp_bytes;
  err = cub::DeviceReduce::Sum(h.temp, tb, h.w64, h.total, n, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  halo_split_kernel<<<g, kAuxThreads, 0, st>>>(h.w64, plen, order, h.total,
                                               max(splits, 1LL), n,
                                               h.nsplit);
  tb = h.temp_bytes;
  err = cub::DeviceScan::InclusiveSum(h.temp, tb, h.nsplit, item_end, n, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  halo_meta_kernel<<<1, kMetaThreads, 0, st>>>(item_end, h.work_sorted, n,
                                               meta);
  if (w > 0) {
    const int wf = 4 * rec_vecs(d);
    const long long total = static_cast<long long>(w) * wf;
    halo_pack_kernel<<<static_cast<int>((total + kAuxThreads - 1) /
                                         kAuxThreads),
                        kAuxThreads, 0, st>>>(
        win, w_key, w, d, wf, rec);
    const int tiles = (w + kWlCols - 1) / kWlCols;
    if (!keyless)
      halo_tmax_kernel<<<(tiles + kAuxWarps - 1) / kAuxWarps, kAuxThreads, 0,
                         st>>>(w_key, w, tiles, tmax);
  }
  return static_cast<int>(cudaGetLastError());
}

// K11 and K16: the halo NN over packed window records (kernels/packing.py:
// rec w floats a record, the key's bits in the slot; tmax each column
// tile's largest key; row_id, plen, order, item_end and meta from
// halo_layout); scratch: best, n 64-bit keys, and next_item, one int32.
template <bool kRing>
int launch_halo_nn(HaloArgs g, const int* plen, const int* order,
                   const int* item_end, const int* meta, int n, float d2cut,
                   int* next_item, float* delta, int* arg,
                   unsigned char* found, cudaStream_t s) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (g.w4 != rec_vecs(g.d)) return static_cast<int>(cudaErrorInvalidValue);
  unsigned bits = 0;                                   // NaN: none
  if (d2cut > 0.0f) std::memcpy(&bits, &d2cut, sizeof(bits));
  g.init = static_cast<unsigned long long>(bits) << 32;
  cudaError_t err = cudaMemsetAsync(next_item, 0, sizeof(int), s);
  if (err == cudaSuccess && g.live != nullptr)
    err = cudaMemsetAsync(
        g.live, 0, 2 * sizeof(int) * ((n + kWlRows - 1) / kWlRows), s);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  halo_fill_kernel<<<(n + kAuxThreads - 1) / kAuxThreads, kAuxThreads, 0,
                     s>>>(g.best, n, g.init);
  // at most one piece a row, mostly fewer: a warp for every 32 rows
  const int want = (n + 32 * kHaloWarps - 1) / (32 * kHaloWarps);
#define REPRO_LAUNCH(D)                                                    \
  {                                                                        \
    int per_sm = 0;                                                        \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                   \
        &per_sm, halo_nn_kernel<D, kRing>, 32 * kHaloWarps, 0);            \
    if (err != cudaSuccess) return static_cast<int>(err);                  \
    const dim3 grid(min(want, sms * max(per_sm, 1)));                      \
    halo_nn_kernel<D, kRing><<<grid, 32 * kHaloWarps, 0, s>>>(             \
        g, plen, order, item_end, meta, next_item);                        \
  }
  REPRO_DISPATCH_D(g.d, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  halo_decode_kernel<<<(n + kAuxThreads - 1) / kAuxThreads, kAuxThreads,
                       0, s>>>(g.best, n, g.init, delta, arg, found);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_halo_masked_nn(
    const float* x, const float* x_key, const float* rec, int w,
    const float* tmax, const int* starts, const int* ends,
    const int* row_id, const int* plen, const int* order,
    const int* item_end, const int* meta, int n, int m, int d, int s,
    float d2cut, void* best, int* next_item, float* delta, int* arg,
    unsigned char* found, void* stream) {
  const HaloArgs g{x, x_key, reinterpret_cast<const float4*>(rec), tmax,
                   starts, ends, row_id, w / 4, m, d, s, 0,
                   static_cast<unsigned long long*>(best), nullptr, nullptr,
                   nullptr, nullptr};
  return launch_halo_nn<false>(g, plen, order, item_end, meta, n, d2cut,
                               next_item, delta, arg, found,
                               static_cast<cudaStream_t>(stream));
}

// live (optional, (row tiles, 2) int32): the entries each row tile's
// pieces computed and the longest walk among their splits.
extern "C" int repro_worklist_halo_masked_nn(
    const float* x, const float* x_key, const float* rec, int w,
    const float* tmax, const int* starts, const int* ends,
    const int* row_id, const int* plen, const int* order,
    const int* item_end, const int* meta, int n, int m, int d, int s,
    float d2cut, const int* row_ptr, const int* col_tile, const float* lb,
    void* best, int* next_item, float* delta, int* arg,
    unsigned char* found, int* live, void* stream) {
  const HaloArgs g{x, x_key, reinterpret_cast<const float4*>(rec), tmax,
                   starts, ends, row_id, w / 4, m, d, s, 0,
                   static_cast<unsigned long long*>(best), row_ptr,
                   col_tile, lb, live};
  return launch_halo_nn<true>(g, plen, order, item_end, meta, n, d2cut,
                              next_item, delta, arg, found,
                              static_cast<cudaStream_t>(stream));
}

// K14: K8's walk summing the f32 signs of the batch rows within d_cut.
extern "C" int repro_worklist_range_count_signed(
    const float* x, const float* y, const float* signs, int n, int m, int d,
    float d2cut, const int* row_ptr, const int* col_tile,
    const unsigned char* in_cut, float* out, void* stream) {
  if (n > 0) {
    const dim3 grid((n + kWlRows - 1) / kWlRows);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(D)                                                    \
  worklist_range_count_kernel<D, true><<<grid, kWlRows, 0, s>>>(           \
      x, y, signs, n, m, d, d2cut, row_ptr, col_tile, in_cut, nullptr, out)
    REPRO_DISPATCH_D(d, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

// K12.  rec: the columns' bf16 records, w = k12_rec(d) values each; norms:
// 2 x m16 floats, their f32 norms then the test's halves; gate (null: the
// ungated sweep) their gate bytes; m16 = m rounded up to kK12Group
// (kernels/packing.py, bf16_records: norms NaN and gate 0 past m).
// inserted (optional, n, zeroed): each row's kept-list insertions.  d must
// be at most kBfMaxD.
extern "C" int repro_fused_count_topk_bf16(const float* x, const void* rec,
                                           const float* norms,
                                           const unsigned char* gate, int w,
                                           int n, int m, int d, float d2cut,
                                           int* count, float* topv,
                                           int* topi, int* inserted,
                                           void* stream) {
  if (d < 1 || d > kBfMaxD || w != k12_rec(d))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  // blocks of half the warps where full ones would not fill the SMs twice
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int rows = (n + kK12Rows - 1) / kK12Rows < 2 * sms ? kK12Rows / 2
                                                           : kK12Rows;
  const dim3 grid((n + rows - 1) / rows);
  const size_t bytes = k12_smem_bytes(d, gate != nullptr);
  const __nv_bfloat16* r = static_cast<const __nv_bfloat16*>(rec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code = 0;
#define REPRO_LAUNCH(KC)                                                   \
  code = gate != nullptr                                                   \
             ? smem_launch(fused_count_topk_bf16_kernel<KC, true>, grid,   \
                           rows, bytes, s, x, r, norms, gate, n, m, d,     \
                           d2cut, count, topv, topi, inserted)             \
             : smem_launch(fused_count_topk_bf16_kernel<KC, false>, grid,  \
                           rows, bytes, s, x, r, norms, gate, n, m, d,     \
                           d2cut, count, topv, topi, inserted)
  if (d <= 8) {
    REPRO_LAUNCH(1);
  } else if (d <= 16) {
    REPRO_LAUNCH(2);
  } else {
    REPRO_LAUNCH(0);
  }
#undef REPRO_LAUNCH
  return code;
}

// K13.  rec, norms, gate, w: K12's column records (kernels/packing.py,
// bf16_records); order: the row tiles in launch order; split: each row
// tile's end of its in_cut entries (kernels/packing.py).  live (optional):
// the entries each row tile computed.  d must be at most kBfMaxD.
extern "C" int repro_worklist_count_topk_bf16(
    const float* x, const void* rec, const float* norms,
    const unsigned char* gate, int w, int n, int m, int d, float d2cut,
    const int* order, const int* row_ptr, const int* split,
    const int* col_tile, const unsigned char* in_cut, const float* lb,
    int* count, float* topv, int* topi, int* live, void* stream) {
  if (d < 1 || d > kBfMaxD || w != k12_rec(d))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((n + kWlRows - 1) / kWlRows);
  const size_t bytes = k13_smem_bytes(d, gate != nullptr);
  const __nv_bfloat16* r = static_cast<const __nv_bfloat16*>(rec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code = 0;
#define REPRO_LAUNCH(KC)                                                   \
  code = gate != nullptr                                                   \
             ? smem_launch(worklist_count_topk_bf16_kernel<KC, true>,      \
                           grid, kK12Rows, bytes, s, x, r, norms, gate, n, \
                           m, d, d2cut, order, row_ptr, split, col_tile,   \
                           in_cut, lb, count, topv, topi, live)            \
             : smem_launch(worklist_count_topk_bf16_kernel<KC, false>,     \
                           grid, kK12Rows, bytes, s, x, r, norms, gate, n, \
                           m, d, d2cut, order, row_ptr, split, col_tile,   \
                           in_cut, lb, count, topv, topi, live)
  if (d <= 8) {
    REPRO_LAUNCH(1);
  } else if (d <= 16) {
    REPRO_LAUNCH(2);
  } else {
    REPRO_LAUNCH(0);
  }
#undef REPRO_LAUNCH
  return code;
}

// The kernel attribute table: one row for each __global__ instantiation
// that the entry points above can launch, read by the static analyzer
// (repro_torch/analysis: R4's launch legality and R9's budgets).  It
// launches nothing.  Each row gives the launch-count names of the wrappers
// (kernels/ops.py) whose entry points launch it, the dimensions d its
// dispatch routes to it, the threads a block of its launches has (K12's
// largest), the query rows a block covers along grid x (0: its grid does
// not follow the query rows; K12's smallest block), the most blocks its
// grid takes along y, and the dynamic shared memory its launches ask for
// at the dimension `d` given, clamped into its range; then
// cudaFuncGetAttributes and the blocks an SM holds at that block and
// shared memory (the opt-in set first, as smem_launch does).  The block
// sizes are the constants the launch sites read.  Returns the number of
// rows (filling at most `cap`), or a negative CUDA error.
struct ReproKernelAttr {
  long long dyn_smem;
  char name[64];
  char launch[128];
  int d_lo;
  int d_hi;
  int threads;
  int rows_per_block;
  int grid_y_max;
  int num_regs;
  int static_smem;
  int local_bytes;
  int max_threads;
  int max_dyn_smem;
  int occupancy;
  int error;
};

namespace {

struct AttrTable {
  ReproKernelAttr* out;
  int cap;
  int count;
  int d;
  int sms;
};

int clamp_d(int d, int lo, int hi) { return d < lo ? lo : (d > hi ? hi : d); }

// the dims REPRO_DISPATCH_D routes to instantiation D (0: the generic one)
int d_lo_of(int D) { return D > 0 ? D : 9; }
int d_hi_of(int D) { return D > 0 ? D : INT_MAX; }

// K12 and K13's: KC = 1 up to 8, 2 up to 16, 0 above
int kc_lo(int KC) { return KC == 1 ? 1 : (KC == 2 ? 9 : 17); }
int kc_hi(int KC) { return KC == 1 ? 8 : (KC == 2 ? 16 : kBfMaxD); }

// grid_y_max below 0: K6's, -grid_y_max waves of the blocks the card holds
template <typename Kernel>
void attr_row(AttrTable& t, Kernel kernel, const char* name,
              const char* launch, int d_lo, int d_hi, int threads,
              int rows_per_block, int grid_y_max, size_t dyn) {
  const int at = t.count++;
  if (at >= t.cap) return;
  ReproKernelAttr& r = t.out[at];
  std::memset(&r, 0, sizeof(r));
  std::snprintf(r.name, sizeof(r.name), "%s", name);
  std::snprintf(r.launch, sizeof(r.launch), "%s", launch);
  r.d_lo = d_lo;
  r.d_hi = d_hi;
  r.threads = threads;
  r.rows_per_block = rows_per_block;
  r.dyn_smem = static_cast<long long>(dyn);
  cudaError_t e = cudaSuccess;
  if (dyn > 0)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dyn));
  cudaFuncAttributes a{};
  const cudaError_t ea = cudaFuncGetAttributes(&a, kernel);
  if (ea == cudaSuccess) {
    r.num_regs = a.numRegs;
    r.static_smem = static_cast<int>(a.sharedSizeBytes);
    r.local_bytes = static_cast<int>(a.localSizeBytes);
    r.max_threads = a.maxThreadsPerBlock;
    r.max_dyn_smem = a.maxDynamicSharedSizeBytes;
  } else if (e == cudaSuccess) {
    e = ea;
  }
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, dyn);
  r.occupancy = e == cudaSuccess ? per_sm : 0;
  r.grid_y_max = grid_y_max >= 0
                     ? grid_y_max
                     : -grid_y_max * t.sms * (per_sm > 0 ? per_sm : 1);
  r.error = static_cast<int>(e);
}

template <int D>
void attr_rows_d(AttrTable& t) {
  const int lo = d_lo_of(D), hi = d_hi_of(D);
  const int dd = clamp_d(t.d, lo, hi);
  const int w4 = rec_vecs(dd);
  char name[64];
  std::snprintf(name, sizeof(name), "fused_count_topk_kernel<%d,false>", D);
  attr_row(t, fused_count_topk_kernel<D, false>, name, "fused_count_topk",
           lo, hi, kNnThreads, kK1R * kNnThreads, 1, ring_bytes(w4));
  std::snprintf(name, sizeof(name), "fused_count_topk_kernel<%d,true>", D);
  attr_row(t, fused_count_topk_kernel<D, true>, name, "fused_count_topk_sel",
           lo, hi, kNnThreads, kK1R * kNnThreads, 1, ring_bytes(w4));
  std::snprintf(name, sizeof(name), "worklist_count_topk_kernel<%d,false>",
                D);
  attr_row(t, worklist_count_topk_kernel<D, false>, name,
           "worklist_count_topk", lo, hi, kNnThreads, kWlRows, 1,
           k3_smem_bytes(w4, dd));
  std::snprintf(name, sizeof(name), "worklist_count_topk_kernel<%d,true>",
                D);
  attr_row(t, worklist_count_topk_kernel<D, true>, name,
           "worklist_count_topk_sel", lo, hi, kNnThreads, kWlRows, 1,
           k3_smem_bytes(w4, dd));
  std::snprintf(name, sizeof(name), "masked_nn_kernel<%d,false>", D);
  attr_row(t, masked_nn_kernel<D, false>, name, "masked_nn,gather_masked_nn",
           lo, hi, kNnThreads, kK2R * kNnThreads, 1, ring_bytes(w4));
  std::snprintf(name, sizeof(name), "masked_nn_kernel<%d,true>", D);
  attr_row(t, masked_nn_kernel<D, true>, name, "gather_masked_nn", lo, hi,
           kNnThreads, kK2R * kNnThreads, -kK6Waves, ring_bytes(w4));
  std::snprintf(name, sizeof(name), "range_count_kernel<%d>", D);
  attr_row(t, range_count_kernel<D>, name, "range_count", lo, hi, kRows,
           kRows, kSplitBlocks, 0);
  std::snprintf(name, sizeof(name), "range_count_signed_kernel<%d>", D);
  attr_row(t, range_count_signed_kernel<D>, name, "range_count_signed", lo,
           hi, kRows, kRows, 1, 0);
  std::snprintf(name, sizeof(name), "prefix_nn_kernel<%d>", D);
  attr_row(t, prefix_nn_kernel<D>, name, "prefix_nn", lo, hi, kRows, kRows,
           1, 0);
  std::snprintf(name, sizeof(name), "worklist_range_count_kernel<%d,false>",
                D);
  attr_row(t, worklist_range_count_kernel<D, false>, name,
           "worklist_range_count", lo, hi, kWlRows, kWlRows, 1, 0);
  std::snprintf(name, sizeof(name), "worklist_range_count_kernel<%d,true>",
                D);
  attr_row(t, worklist_range_count_kernel<D, true>, name,
           "worklist_range_count_signed", lo, hi, kWlRows, kWlRows, 1, 0);
  std::snprintf(name, sizeof(name), "worklist_masked_nn_kernel<%d,false>", D);
  attr_row(t, worklist_masked_nn_kernel<D, false>, name,
           "worklist_masked_nn", lo, hi, 32 * kK9Warps, kK9Warps, 1, 0);
  std::snprintf(name, sizeof(name), "worklist_masked_nn_kernel<%d,true>", D);
  attr_row(t, worklist_masked_nn_kernel<D, true>, name, "worklist_masked_nn",
           lo, hi, 32 * kK9Warps, kK9Warps, 1, 0);
  std::snprintf(name, sizeof(name), "halo_count_kernel<%d,false>", D);
  attr_row(t, halo_count_kernel<D, false>, name, "halo_range_count", lo, hi,
           32 * kHaloWarps, 32 * kHaloWarps, 1, 0);
  std::snprintf(name, sizeof(name), "halo_count_kernel<%d,true>", D);
  attr_row(t, halo_count_kernel<D, true>, name, "worklist_halo_range_count",
           lo, hi, 32 * kHaloWarps, 32 * kHaloWarps, 1, 0);
  std::snprintf(name, sizeof(name), "halo_nn_kernel<%d,false>", D);
  attr_row(t, halo_nn_kernel<D, false>, name, "halo_masked_nn", lo, hi,
           32 * kHaloWarps, 32 * kHaloWarps, 1, 0);
  std::snprintf(name, sizeof(name), "halo_nn_kernel<%d,true>", D);
  attr_row(t, halo_nn_kernel<D, true>, name, "worklist_halo_masked_nn", lo,
           hi, 32 * kHaloWarps, 32 * kHaloWarps, 1, 0);
}

template <int KC>
void attr_rows_kc(AttrTable& t) {
  const int lo = kc_lo(KC), hi = kc_hi(KC);
  const int dd = clamp_d(t.d, lo, hi);
  char name[64];
  std::snprintf(name, sizeof(name), "fused_count_topk_bf16_kernel<%d,false>",
                KC);
  attr_row(t, fused_count_topk_bf16_kernel<KC, false>, name,
           "fused_count_topk_bf16", lo, hi, kK12Rows, kK12Rows / 2, 1,
           k12_smem_bytes(dd, false));
  std::snprintf(name, sizeof(name), "fused_count_topk_bf16_kernel<%d,true>",
                KC);
  attr_row(t, fused_count_topk_bf16_kernel<KC, true>, name,
           "fused_count_topk_bf16_sel", lo, hi, kK12Rows, kK12Rows / 2, 1,
           k12_smem_bytes(dd, true));
  std::snprintf(name, sizeof(name),
                "worklist_count_topk_bf16_kernel<%d,false>", KC);
  attr_row(t, worklist_count_topk_bf16_kernel<KC, false>, name,
           "worklist_count_topk_bf16", lo, hi, kK12Rows, kWlRows, 1,
           k13_smem_bytes(dd, false));
  std::snprintf(name, sizeof(name),
                "worklist_count_topk_bf16_kernel<%d,true>", KC);
  attr_row(t, worklist_count_topk_bf16_kernel<KC, true>, name,
           "worklist_count_topk_bf16_sel", lo, hi, kK12Rows, kWlRows, 1,
           k13_smem_bytes(dd, true));
}

}  // namespace

extern "C" int repro_kernel_attrs(int d, ReproKernelAttr* out, int cap) {
  int dev = 0;
  AttrTable t{out, cap, 0, d < 1 ? 1 : d, 0};
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&t.sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  attr_rows_d<0>(t);
  attr_rows_d<1>(t);
  attr_rows_d<2>(t);
  attr_rows_d<3>(t);
  attr_rows_d<4>(t);
  attr_rows_d<5>(t);
  attr_rows_d<6>(t);
  attr_rows_d<7>(t);
  attr_rows_d<8>(t);
  attr_rows_kc<0>(t);
  attr_rows_kc<1>(t);
  attr_rows_kc<2>(t);
  const char* nn_both = "masked_nn,gather_masked_nn";
  const char* halo_nn = "halo_masked_nn,worklist_halo_masked_nn";
  const char* halo_all =
      "halo_range_count,halo_masked_nn,worklist_halo_range_count,"
      "worklist_halo_masked_nn";
  attr_row(t, gather_nn_decode_kernel, "gather_nn_decode_kernel", nn_both, 1,
           INT_MAX, kAuxThreads, kAuxThreads, 1, 0);
  attr_row(t, halo_fill_kernel, "halo_fill_kernel", halo_nn, 1, INT_MAX,
           kAuxThreads, kAuxThreads, 1, 0);
  attr_row(t, halo_decode_kernel, "halo_decode_kernel", halo_nn, 1, INT_MAX,
           kAuxThreads, kAuxThreads, 1, 0);
  attr_row(t, count_cut_kernel, "count_cut_kernel",
           "worklist_halo_range_count", 1, INT_MAX, kCutThreads, kWlRows, 1,
           0);
  attr_row(t, halo_rows_kernel, "halo_rows_kernel", halo_all, 1, INT_MAX,
           kAuxThreads, kAuxThreads, 1, 0);
  attr_row(t, halo_keys_kernel, "halo_keys_kernel", halo_all, 1, INT_MAX,
           kAuxThreads, kAuxThreads, 1, 0);
  attr_row(t, halo_plen_kernel, "halo_plen_kernel", halo_all, 1, INT_MAX,
           kAuxThreads, kAuxThreads, 1, 0);
  attr_row(t, halo_w64_kernel, "halo_w64_kernel", halo_all, 1, INT_MAX,
           kAuxThreads, kAuxThreads, 1, 0);
  attr_row(t, halo_split_kernel, "halo_split_kernel", halo_all, 1, INT_MAX,
           kAuxThreads, kAuxThreads, 1, 0);
  attr_row(t, halo_meta_kernel, "halo_meta_kernel", halo_all, 1, INT_MAX,
           kMetaThreads, 0, 1, 0);
  attr_row(t, halo_pack_kernel, "halo_pack_kernel", halo_all, 1, INT_MAX,
           kAuxThreads, 0, 1, 0);
  attr_row(t, halo_tmax_kernel, "halo_tmax_kernel", halo_nn, 1, INT_MAX,
           kAuxThreads, 0, 1, 0);
  // a refused opt-in or query leaves its error with its row, not behind
  // for the next launch's cudaGetLastError
  cudaGetLastError();
  return t.count;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
