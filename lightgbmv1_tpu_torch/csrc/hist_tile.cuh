// The histogram device code shared by K1 (csrc/hist.cu), K2
// (csrc/wave_fused.cu) and K6 (csrc/wave_loop.cu), which include this
// header (the last two through wave_round.cuh), so K2's and K6's
// smaller-child histograms are K1's histograms of the same slot label and
// precision, bit for bit.  ops/_build.py hashes every csrc/*.cuh a source
// includes into the library's name, so an edit here rebuilds all three.
//
// hist_partial_item (run one block an item by hist_partial_kernel, and
// in a grid-stride loop by K6): shared-memory sub-histograms of one
// feature, one row chunk and one group of slots.  Every histogram cell
// (slot, bin) has one owner warp, key % 8 with key = slot * nb + bin.  A
// tile's 256 rows are loaded one a thread; the rows that add (their slot
// below the item's live limit) are compacted by owner warp with a stable
// ballot count, so each warp's list is in row order.  Each warp then takes
// its list 32 rows at a time: __match_any_sync groups the lanes of one
// cell, and the lowest lane of each group loads the cell once, adds its
// peers' values in lane order (= row order) in registers and stores it
// once.  A cell therefore still receives its rows one f32 add at a time,
// in row order, from a 0.f start: no atomics, deterministic, and the same
// bits as one thread walking the rows; the serial depth is the largest
// number of rows of one cell in a batch of 32.  Each block writes its
// partial partial[chunk][f][slot][bin][NC]; merge_cell sums a cell's
// partials in chunk order, hi and lo apart, and adds the two at the end.
//
// Precision (the Pallas kernel's semantics): "f32" sums the f32 values;
// "bf16" sums hi = bf16_rn(v); "bf16x2" sums hi and lo = bf16_rn(v - hi)
// separately (NC = 6 accumulators a cell: hi, then lo).  The kernel only
// adds and subtracts, so floating-point contraction cannot change it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbm {

constexpr int kThreads = 256;  // = rows a tile
constexpr int kWarps = kThreads / 32;

enum Precision { kF32 = 0, kBf16 = 1, kBf16x2 = 2 };

__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Dynamic shared memory of one hist_partial_kernel block: the
// sub-histograms and one tile's compacted rows (NC values and a key each).
inline size_t hist_partial_smem(int ls_max, int nb, int nc) {
  return (static_cast<size_t>(ls_max) * nb * nc +
          static_cast<size_t>(kThreads) * nc) * sizeof(float) +
         kThreads * sizeof(int);
}

// The cell key of a row (slot id `leaf`, bin `bin`) in an item whose
// adding slots are [s0, s0 + s_add), or -1 for a row that adds nothing
// (another or a dead slot, a bin >= nb; a row past the chunk has leaf -1).
__device__ __forceinline__ int row_key(int leaf, int bin, int s0, int s_add,
                                       int nb) {
  const int s = leaf - s0;
  return s >= 0 && s < s_add && bin < nb ? s * nb + bin : -1;
}

// Tiles of slot ids and bins a thread keeps in flight ahead of its adds
// (even: see hist_partial_item).
constexpr int kDepth = 4;

// One tile of the partial stage (see hist_partial_item): the thread's row
// has cell key `key` (-1: adds nothing) and values `v` (read only for a
// row that adds).  Compacts the tile's adding rows by owner warp, stably,
// into tkey / tval[NC][tile], then each warp adds its rows to its cells of
// `hist`, 32 at a time.
// Opens with a block barrier and leaves the warps unsynchronised: the next
// tile's barrier orders its writes of wcnt, tkey and tval after this one's
// reads.
template <int PREC, int NC>
__device__ __forceinline__ void hist_add_tile(int key, const float (&v)[3],
                                              float* hist, float* tval,
                                              int* tkey, int wcells) {
  __shared__ int wcnt[kWarps][kWarps];   // [source warp][owner warp]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;

  // ---- stable compaction of the tile's adding rows by owner warp ------
  // four ballots (adds, and the owner's three bits) give every owner's
  // lanes of this warp: lane o < 8 counts owner o's, each lane ranks
  // itself among its own owner's
  const int owner = key >= 0 ? key % kWarps : kWarps;
  const unsigned live = __ballot_sync(0xffffffffu, key >= 0);
  unsigned bit[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    bit[i] = __ballot_sync(0xffffffffu, (owner >> i) & 1);
  unsigned mine = live, of_lane = live;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    mine &= (owner >> i) & 1 ? bit[i] : ~bit[i];
    of_lane &= (lane >> i) & 1 ? bit[i] : ~bit[i];
  }
  const int rank = __popc(mine & lt_mask);
  if (lane < kWarps) wcnt[warp][lane] = __popc(of_lane);
  if (!__syncthreads_or(live != 0u)) return;
  // lane o < 8 of every warp: owner o's rows in the tile, those from the
  // warps before this one, and (a scan over the 8 lanes) where o starts
  int tot = 0, before = 0;
  if (lane < kWarps) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcnt[w][lane];
      tot += c;
      if (w < warp) before += c;
    }
  }
  int incl = tot;
#pragma unroll
  for (int d = 1; d < kWarps; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  const int start = incl - tot;
  const int p = __shfl_sync(0xffffffffu, start + before, owner) + rank;
  const int cnt = __shfl_sync(0xffffffffu, tot, warp);
  const int base = __shfl_sync(0xffffffffu, start, warp);
  if (key >= 0) {
    tkey[p] = key;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (PREC == kF32) {
        tval[c * kThreads + p] = v[c];
      } else {
        const float hi = bf16_rn(v[c]);
        tval[c * kThreads + p] = hi;
        if (PREC == kBf16x2) tval[(3 + c) * kThreads + p] = bf16_rn(v[c] - hi);
      }
    }
  }
  __syncthreads();

  // ---- each warp adds its rows, 32 at a time, in row order -------------
  float* hw = hist + static_cast<size_t>(warp) * NC * wcells;
  for (int b0 = 0; b0 < cnt; b0 += 32) {
    const int i = b0 + lane;
    const int k = i < cnt ? tkey[base + i] : -1;  // -1: an idle lane
    float* h = hw + (k >= 0 ? k / kWarps : 0);
    float acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = k >= 0 ? h[c * wcells] : 0.f;
    const unsigned grp = __match_any_sync(0xffffffffu, k);
    if (k >= 0 && (grp & lt_mask) == 0) {  // the group's lowest lane
      const float* tv = tval + base + b0;
      unsigned m = grp;
      while (m) {  // the group's lanes in order, two loads ahead
        int j[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          j[u] = m ? __ffs(m) - 1 : -1;
          m &= m - 1u;
        }
        float x[2][NC];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (j[u] >= 0)
#pragma unroll
            for (int c = 0; c < NC; ++c) x[u][c] = tv[c * kThreads + j[u]];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (j[u] >= 0)
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[c] += x[u][c];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) h[c * wcells] = acc[c];
    }
    // the next batch's lanes read what this batch's lowest lanes stored
    __syncwarp();
  }
}

// One work item of the partial stage: the sub-histograms of feature `f`,
// row chunk `chunk` and slot group `group` (slots [group * ls_max, ...)),
// written to partial[chunk][f][slot][bin][NC].  Run by all kThreads
// threads of a block on `smem` (hist_partial_smem(ls_max, nb, NC) bytes).
// NC f32 accumulators a cell: 3 (f32, bf16) or 6 (bf16x2: hi, then lo).
// Only rows whose slot is in [0, nl_add) and whose bin is < nb add; the
// cells of slots [nl_add, nl) are written as 0 (a wave round's dead slot:
// its rows are dropped at the load, before any list, value or walk).
// `leaf_id` and `partial` carry no __restrict__: the persistent loop
// (wave_loop.cu) rewrites the labels and re-reads the partials between
// grid barriers of one launch, so they must not go through the
// read-only cache.
template <int PREC, int NC>
__device__ __forceinline__ void hist_partial_item(
    int f, int chunk, int group, const uint8_t* __restrict__ binned,
    const float* __restrict__ g3, const int* leaf_id, float* partial, int n,
    int nf, int nl, int nl_add, int nb, int ls_max, int chunk_rows,
    float* smem) {
  const int s0 = group * ls_max;
  const int ls = min(ls_max, nl - s0);
  const int s_add = min(ls, nl_add - s0);
  const int cells = ls * nb;
  const int wcells = cells / kWarps;  // the cells a warp owns (nb % 8 == 0)

  // hist[owner warp][channel][key / kWarps]: a warp's lanes hold distinct
  // keys of one residue mod 8, so key / 8 spreads them over the banks
  float* hist = smem;
  float* tval = hist + static_cast<size_t>(ls_max) * nb * NC;  // [NC][tile]
  int* tkey = reinterpret_cast<int*>(tval + kThreads * NC);     // [tile]
  const int tid = threadIdx.x;

  for (int i = tid; i < cells * NC; i += kThreads) hist[i] = 0.f;

  const int r_begin = chunk * chunk_rows;
  const int r_end = min(n, r_begin + chunk_rows);
  const uint8_t* brow = binned + static_cast<size_t>(f) * n;

  // A ring of this thread's rows of the next kDepth tiles (slot ids and
  // bins, loaded unconditionally from a clamped row and judged at use, so
  // no instruction waits on a load before its tile), and the values of
  // the current and the next tile, by the parity of the tile (kDepth is
  // even, so the parity of a ring slot is fixed).
  if (r_begin < r_end) {
    int lf[kDepth], bn[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int r = min(r_begin + d * kThreads + tid, r_end - 1);
      lf[d] = leaf_id[r];
      bn[d] = brow[r];
    }
    int key[2];
    float v[2][3];
    key[0] = row_key(r_begin + tid < r_end ? lf[0] : -1, bn[0], s0, s_add,
                     nb);
    if (key[0] >= 0)
      for (int c = 0; c < 3; ++c)
        v[0][c] = g3[static_cast<size_t>(r_begin + tid) * 3 + c];

    for (int t0 = r_begin; t0 < r_end; t0 += kDepth * kThreads) {
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        if (t0 + d * kThreads >= r_end) break;
        const int r = t0 + d * kThreads + tid;
        const int cur = d & 1, nxt = cur ^ 1;
        const int dn = (d + 1) % kDepth;
        // the next tile's key, and its values in flight while this one
        // adds
        key[nxt] = row_key(r + kThreads < r_end ? lf[dn] : -1, bn[dn], s0,
                           s_add, nb);
        if (key[nxt] >= 0)
          for (int c = 0; c < 3; ++c)
            v[nxt][c] = g3[static_cast<size_t>(r + kThreads) * 3 + c];
        // refill ring slot d with the row kDepth tiles ahead
        const int rf = min(r + kDepth * kThreads, r_end - 1);
        lf[d] = leaf_id[rf];
        bn[d] = brow[rf];
        hist_add_tile<PREC, NC>(key[cur], v[cur], hist, tval, tkey, wcells);
      }
    }
  }
  __syncthreads();

  // ---- this block's partial: partial[chunk][f][s0 + s][b][NC] ---------
  float* out = partial +
               ((static_cast<size_t>(chunk) * nf + f) * nl + s0) * nb * NC;
  for (int i = tid; i < cells * NC; i += kThreads) {
    const int k = i / NC;
    const int c = i - k * NC;
    out[i] = hist[((k % kWarps) * NC + c) * wcells + k / kWarps];
  }
}

// The partial stage as a kernel: one block a work item on the grid
// (nf, n_chunks, slot groups).  MANY: a block small enough in shared
// memory for five an SM is held to the registers of five (the plan's 532
// blocks at the headline then run in one wave of 660, not 528 + 4).
template <int PREC, int NC, bool MANY>
__global__ void __launch_bounds__(kThreads, MANY ? 5 : 1)
hist_partial_kernel(const uint8_t* __restrict__ binned,
                    const float* __restrict__ g3,
                    const int* __restrict__ leaf_id,
                    float* __restrict__ partial, int n, int nf, int nl,
                    int nl_add, int nb, int ls_max, int chunk_rows) {
  extern __shared__ float smem[];
  hist_partial_item<PREC, NC>(blockIdx.x, blockIdx.y, blockIdx.z, binned, g3,
                              leaf_id, partial, n, nf, nl, nl_add, nb,
                              ls_max, chunk_rows, smem);
}

// One channel of one cell, summed over the chunks in chunk order: the hi
// partials, plus (bf16x2) the same sum of the lo partials.  `p` points at
// the cell's channel in chunk 0; `stride` is one chunk's partial size.
template <int NC>
__device__ __forceinline__ float merge_cell(const float* p, size_t stride,
                                            int n_chunks) {
  float hi = 0.f, lo = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch, p += stride) {
    hi += p[0];
    if (NC == 6) lo += p[3];
  }
  return NC == 6 ? hi + lo : hi;
}

// The dynamic shared memory up to which five blocks share an SM's 228 KiB
// (each also takes 1 KiB reserved and its static arrays).
constexpr size_t kManySmem = 44 * 1024;

// Sets the partial kernel's shared memory and launches it on the grid
// (nf, n_chunks, slot groups): nl slots of which [0, nl_add) add.
// Returns the cudaError_t.
template <int PREC, int NC>
int launch_hist_partial(const uint8_t* binned, const float* g3,
                        const int* leaf_id, float* partial, int n, int nf,
                        int nl, int nl_add, int nb, int ls_max, int n_chunks,
                        int chunk_rows, cudaStream_t stream) {
  const size_t smem = hist_partial_smem(ls_max, nb, NC);
  const auto kernel = smem <= kManySmem ? hist_partial_kernel<PREC, NC, true>
                                        : hist_partial_kernel<PREC, NC, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (nl + ls_max - 1) / ls_max;
  dim3 grid(nf, n_chunks, groups);
  kernel<<<grid, kThreads, smem, stream>>>(binned, g3, leaf_id, partial, n,
                                           nf, nl, nl_add, nb, ls_max,
                                           chunk_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lgbm
