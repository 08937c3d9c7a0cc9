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
// "int8sr" (hist_dtype_deep=int8sr, the Pallas kernel's
// precision="int8sr") takes rows already quantized to exact integers in
// [-127, 127] (ops/quantize.py; f32 holding integers) and sums them as
// int32 (NC = 3): the shared sub-histograms, the partials and the merge
// are integer, so a cell's sum is exact and the same in any order, and
// it becomes f32 once, at the merge.  The Pallas kernel adds each row
// tile's int32 product into an f32 output, exact while every cell stays
// below 2^24 in magnitude; the two agree there.
// "int8" (hist_dtype=int8 / hist_dtype_deep=int8, the Pallas kernel's
// precision="int8", round to nearest under one scale a row tile of T
// rows) takes the rows q rounded to exact integers under their tile's
// scales (ops/quantize.rn_quantize; f32 holding integers) and the
// (ceil(n / T), 3) scales.  The Pallas kernel sums each tile's integers
// exactly (int32) and adds float(sum) * scale into its f32 output, tile
// after tile (an fma where XLA contracts the product and the add, as it
// does on the CPU); a tile in which a cell has no row adds an exact 0.
// Here a cell takes 6 words, the int32 sums of the current scale tile and
// the f32 sums, so 64 slots of 64 bins fit one group, as at bf16x2.  The
// scale tile is the warp's, not the cell's: a warp owns its cells (key %
// 8) and takes its compacted rows in row order, across the item's 256-row
// tiles, so it keeps one current scale tile in a warp-uniform register
// (Int8Warp) and every pending integer sum of its cells belongs to it.
// Before each batch of 32 rows a ballot over the rows' tiles (a row's 4th
// compacted word) splits the batch into segments of one scale tile (two
// at T = 128 in a 256-row tile; a sparse list may cross several).  Each
// segment runs int8sr's integer adds, two loads ahead, grouped over the
// segment's lanes; when a segment opens a later tile the warp first
// flushes the cells it touched in the closing one, f = fma(float(i),
// scale, f), and restarts their integer sums.  The touched cells are a
// per-warp mask of 32 words (cell c: word c % 32, bit c / 32, so each lane
// flushes the cells of its own bank), kept in the 5th of the 6 words of a
// row's compacted values; a touched cell whose sums came to 0 adds an
// exact 0, as in the Pallas kernel.  The item's end flushes what is
// pending.  So a cell still sees its tiles in order and one fma a tile,
// and the f32 sum of one row chunk is the Pallas kernel's sum over the
// chunk's tiles, bit for bit, while the serial add loop stays integer.
// The plan never splits a scale tile across chunks (ops/hist_cuda.plan),
// and the chunks' f32 partials merge in chunk order as the float legs'
// do: with one chunk the histogram is the Pallas kernel's bit for bit,
// else the sums of its tiles are associated by chunk.  T is the Pallas
// kernel's own row tile for the call (128 to 1024), not this kernel's
// 256-row tile.  The list walk (K2, K6) sees only a chunk's listed rows,
// but the scales come from all the tile's rows, from the quantize pass.
//
// Bins: (nf, n) bytes, or (PACKED, bin_layout=packed4) the (ceil(nf/2), n)
// bytes of two features each, lo nibble = feature 2p, hi = 2p + 1
// (ops/hist_cuda.pack4bit).  A packed item reads its feature's pair
// column and takes the nibble at use (bin_of); nf is the real feature
// count, so the items, the partial layout and every cell's rows and their
// order are the byte leg's, and so are the bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbm {

constexpr int kThreads = 256;  // = rows a tile
constexpr int kWarps = kThreads / 32;

enum Precision { kF32 = 0, kBf16 = 1, kBf16x2 = 2, kInt8sr = 3, kInt8 = 4 };

// The 4-byte words a cell takes in the shared sub-histograms and a row
// in a tile's compacted values: NC, or at int8 a cell's int32 sums of
// its warp's current scale tile and its f32 sums (6); a row's three
// integers and its scale tile take 4 of a row's 6, the warps' touched
// cells the 5th (int8_masks).
template <int PREC, int NC>
__host__ __device__ constexpr int cell_words() {
  return PREC == kInt8 ? 6 : NC;
}

// int8: a warp's state across the tiles of one item, uniform over its
// lanes: the scale tile whose integer sums its cells hold (-1: none yet)
// and that tile's (3,) scales, loaded when the tile opens so that its
// flush does not wait on them.
struct Int8Warp {
  int tile;
  float s[3];
};

// int8: the cells a warp can mark in its 32 mask words of 32 bits.
constexpr int kInt8MaxWarpCells = 32 * 32;

// int8: the warps' touched-cell masks, 32 words a warp, in the 5th of the
// 6 words of a row in `tval` (hist_partial_item's tile scratch).
__device__ __forceinline__ unsigned* int8_masks(float* tval) {
  return reinterpret_cast<unsigned*>(tval) + 4 * kThreads;
}

// int8: the warp flushes the cells it touched in its current scale tile,
// f = fma(float(int32 sum), scale, f), restarts their integer sums and
// clears its mask.  `hi` is the warp's cells (int32 sums [0, 3), f32
// sums [3, 6), each a channel of wcells words).  Lane l takes mask word
// l, the cells l + 32 b, so the lanes' cells fall in distinct banks.
// Called by all 32 lanes of the warp.
__device__ __forceinline__ void int8_flush(int* hi, int wcells,
                                           unsigned* mask,
                                           const Int8Warp& q8) {
  __syncwarp();  // the segment's stores of the sums and the mask
  const int lane = threadIdx.x & 31;
  unsigned bits = mask[lane];
  if (bits) {
    mask[lane] = 0u;
    float* hf = reinterpret_cast<float*>(hi) + 3 * static_cast<size_t>(wcells);
    do {
      const int cell = (__ffs(bits) - 1) * 32 + lane;
      bits &= bits - 1u;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        int* ic = hi + c * wcells + cell;
        float* fc = hf + c * wcells + cell;
        *fc = __fmaf_rn(__int2float_rn(*ic), q8.s[c], *fc);
        *ic = 0;
      }
    } while (bits);
  }
  __syncwarp();  // before the next segment reads the cells
}

// The accumulator of a precision: int32 for int8sr, f32 otherwise (int8's
// partials are f32; its shared cells are read through both types).  The
// shared sub-histograms, a tile's compacted values and the partials are
// 4-byte words either way, read through this type.
template <int PREC>
struct AccOf {
  using T = float;
};
template <>
struct AccOf<kInt8sr> {
  using T = int;
};

__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Dynamic shared memory of one hist_partial_kernel block: the
// sub-histograms and one tile's compacted rows (nc = hist_words values
// and a key each), 4-byte words whatever the accumulator.
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

// The stored byte column of feature f: its own row of the (nf, n) bins,
// or (PACKED) its pair's row of the (ceil(nf/2), n) packed bytes.
template <bool PACKED>
__device__ __forceinline__ const uint8_t* bin_column(const uint8_t* binned,
                                                     int f, int n) {
  return binned + static_cast<size_t>(PACKED ? f >> 1 : f) * n;
}

// Feature f's bin in a byte of its column (PACKED: the lo nibble for an
// even f, the hi one for an odd f).
template <bool PACKED>
__device__ __forceinline__ int bin_of(int byte, int f) {
  return PACKED ? (byte >> ((f & 1) * 4)) & 15 : byte;
}

// Tiles of slot ids and bins a thread keeps in flight ahead of its adds
// (even: see hist_partial_item).
constexpr int kDepth = 4;

// A cell group's lowest lane adds its peers' values to `acc`: the lanes
// of `grp` in order (= row order), two loads ahead, each lane j's values
// at tv[c * kThreads + j].
template <typename A, int NC>
__device__ __forceinline__ void add_group(A (&acc)[NC], const A* tv,
                                          unsigned grp) {
  unsigned m = grp;
  while (m) {
    int j[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      j[u] = m ? __ffs(m) - 1 : -1;
      m &= m - 1u;
    }
    A x[2][NC];
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
}

// One tile of the partial stage (see hist_partial_item): the thread's row
// has cell key `key` (-1: adds nothing) and values `v` (read only for a
// row that adds).  Compacts the tile's adding rows by owner warp, stably,
// into tkey / tval[NC][tile], then each warp adds its rows to its cells of
// `hist`, 32 at a time.  int8: `qt` is the row's scale tile, `qscale` the
// tiles' (3,) scales and `q8` the warp's state (see the head note; unread
// by the other legs).
// Opens with a block barrier and leaves the warps unsynchronised: the next
// tile's barrier orders its writes of wcnt, tkey and tval after this one's
// reads.
template <int PREC, int NC>
__device__ __forceinline__ void hist_add_tile(int key, const float (&v)[3],
                                              float* hist_words,
                                              float* tval_words, int* tkey,
                                              int wcells, int qt,
                                              const float* qscale,
                                              Int8Warp& q8) {
  using A = typename AccOf<PREC>::T;
  A* hist = reinterpret_cast<A*>(hist_words);
  A* tval = reinterpret_cast<A*>(tval_words);
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
      if constexpr (PREC == kInt8sr || PREC == kInt8) {
        reinterpret_cast<int*>(tval)[c * kThreads + p] = __float2int_rn(v[c]);
      } else if constexpr (PREC == kF32) {
        tval[c * kThreads + p] = v[c];
      } else {
        const float hi = bf16_rn(v[c]);
        tval[c * kThreads + p] = hi;
        if (PREC == kBf16x2) tval[(3 + c) * kThreads + p] = bf16_rn(v[c] - hi);
      }
    }
    if constexpr (PREC == kInt8)
      reinterpret_cast<int*>(tval)[3 * kThreads + p] = qt;
  }
  __syncthreads();

  if constexpr (PREC == kInt8) {
    // the warp's cells: int32 sums [0, 3), f32 sums [3, 6), each a
    // channel of wcells words; a batch splits into segments of one scale
    // tile, each flushing the closing tile's cells when it opens a later
    // one, then adding as int8sr does (head note)
    int* hi = reinterpret_cast<int*>(hist_words) +
              static_cast<size_t>(warp) * 6 * wcells;
    unsigned* mask = int8_masks(tval_words) + warp * 32;
    const int* tv = reinterpret_cast<const int*>(tval_words) + base;
    for (int b0 = 0; b0 < cnt; b0 += 32) {
      const int i = b0 + lane;
      const int k = i < cnt ? tkey[base + i] : -1;  // -1: an idle lane
      const int t = i < cnt ? tv[3 * kThreads + i] : -1;
      unsigned left = __ballot_sync(0xffffffffu, k >= 0);
      while (left) {  // the batch's scale tiles rise with its lanes
        const int t0 = __shfl_sync(0xffffffffu, t, __ffs(left) - 1);
        if (t0 != q8.tile) {
          int8_flush(hi, wcells, mask, q8);
          q8.tile = t0;
#pragma unroll
          for (int c = 0; c < 3; ++c) q8.s[c] = qscale[3 * t0 + c];
        }
        const bool in = k >= 0 && t == t0;
        left &= ~__ballot_sync(0xffffffffu, in);
        const int cell = in ? k / kWarps : 0;
        int* h = hi + cell;
        int acc[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[c] = in ? h[c * wcells] : 0;
        const unsigned grp = __match_any_sync(0xffffffffu, in ? k : -1);
        if (in && (grp & lt_mask) == 0) {  // the group's lowest lane
          add_group<int, 3>(acc, tv + b0, grp);
#pragma unroll
          for (int c = 0; c < 3; ++c) h[c * wcells] = acc[c];
          atomicOr(mask + (cell & 31), 1u << (cell >> 5));
        }
        // the next segment's lanes read what this one's lowest lanes
        // stored
        __syncwarp();
      }
    }
    return;
  }

  // ---- each warp adds its rows, 32 at a time, in row order -------------
  A* hw = hist + static_cast<size_t>(warp) * NC * wcells;
  for (int b0 = 0; b0 < cnt; b0 += 32) {
    const int i = b0 + lane;
    const int k = i < cnt ? tkey[base + i] : -1;  // -1: an idle lane
    A* h = hw + (k >= 0 ? k / kWarps : 0);
    A acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = k >= 0 ? h[c * wcells] : A(0);
    const unsigned grp = __match_any_sync(0xffffffffu, k);
    if (k >= 0 && (grp & lt_mask) == 0) {  // the group's lowest lane
      add_group<A, NC>(acc, tval + base + b0, grp);
#pragma unroll
      for (int c = 0; c < NC; ++c) h[c * wcells] = acc[c];
    }
    // the next batch's lanes read what this batch's lowest lanes stored
    __syncwarp();
  }
}

// Zeroes the sub-histograms of `cells` cells (int8: and the warps'
// touched-cell masks in the tile scratch `tval`).
template <int PREC, int NC>
__device__ __forceinline__ void hist_clear(float* hist, float* tval,
                                           int cells) {
  constexpr int HW = cell_words<PREC, NC>();
  int* w = reinterpret_cast<int*>(hist);
  for (int i = threadIdx.x; i < cells * HW; i += kThreads) w[i] = 0;
  static_assert(kWarps * 32 == kThreads, "one mask word a thread");
  if (PREC == kInt8) int8_masks(tval)[threadIdx.x] = 0u;
}

// int8: each warp flushes the cells its current scale tile left pending
// (the item's end; all kThreads threads).
__device__ __forceinline__ void int8_finish(float* hist, float* tval,
                                            int wcells, const Int8Warp& q8) {
  const int warp = threadIdx.x >> 5;
  int8_flush(reinterpret_cast<int*>(hist) +
                 static_cast<size_t>(warp) * 6 * wcells,
             wcells, int8_masks(tval) + warp * 32, q8);
}

// Writes the sub-histograms of `cells` cells to a partial, [cell][NC]
// (int8: each cell's f32 sums, after int8_finish).
template <int PREC, int NC>
__device__ __forceinline__ void hist_write(const float* hist, int cells,
                                           int wcells, float* out_words) {
  using A = typename AccOf<PREC>::T;
  constexpr int HW = cell_words<PREC, NC>();
  constexpr int OFF = PREC == kInt8 ? 3 : 0;  // int8: the f32 channels
  A* out = reinterpret_cast<A*>(out_words);
  const A* hacc = reinterpret_cast<const A*>(hist);
  for (int i = threadIdx.x; i < cells * NC; i += kThreads) {
    const int k = i / NC;
    const int c = i - k * NC;
    const size_t cell = static_cast<size_t>(k % kWarps) * HW * wcells +
                        k / kWarps;
    out[i] = hacc[cell + (OFF + c) * wcells];
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
// int8 (`qscale` the (ceil(n / qtile), 3) scales of the rows' qtile-row
// scale tiles): each warp flushes its cells at its rows' scale-tile
// boundaries and at the item's end (head note).
// `leaf_id` and `partial` carry no __restrict__: the persistent loop
// (wave_loop.cu) rewrites the labels and re-reads the partials between
// grid barriers of one launch, so they must not go through the
// read-only cache.
template <int PREC, int NC, bool PACKED>
__device__ __forceinline__ void hist_partial_item(
    int f, int chunk, int group, const uint8_t* __restrict__ binned,
    const float* __restrict__ g3, const int* leaf_id, float* partial, int n,
    int nf, int nl, int nl_add, int nb, int ls_max, int chunk_rows,
    float* smem, const float* qscale, int qtile) {
  const int s0 = group * ls_max;
  const int ls = min(ls_max, nl - s0);
  const int s_add = min(ls, nl_add - s0);
  const int cells = ls * nb;
  const int wcells = cells / kWarps;  // the cells a warp owns (nb % 8 == 0)
  constexpr int HW = cell_words<PREC, NC>();

  // hist[owner warp][channel][key / kWarps]: a warp's lanes hold distinct
  // keys of one residue mod 8, so key / 8 spreads them over the banks
  float* hist = smem;
  float* tval = hist + static_cast<size_t>(ls_max) * nb * HW;  // [HW][tile]
  int* tkey = reinterpret_cast<int*>(tval + kThreads * HW);     // [tile]
  const int tid = threadIdx.x;

  hist_clear<PREC, NC>(hist, tval, cells);
  Int8Warp q8{-1, {0.f, 0.f, 0.f}};

  const int r_begin = chunk * chunk_rows;
  const int r_end = min(n, r_begin + chunk_rows);
  const uint8_t* brow = bin_column<PACKED>(binned, f, n);

  // A ring of this thread's rows of the next kDepth tiles (slot ids and
  // bin bytes, loaded unconditionally from a clamped row and judged and
  // decoded at use, so no instruction waits on a load before its tile),
  // and the values of
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
    key[0] = row_key(r_begin + tid < r_end ? lf[0] : -1,
                     bin_of<PACKED>(bn[0], f), s0, s_add, nb);
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
        key[nxt] = row_key(r + kThreads < r_end ? lf[dn] : -1,
                           bin_of<PACKED>(bn[dn], f), s0, s_add, nb);
        if (key[nxt] >= 0)
          for (int c = 0; c < 3; ++c)
            v[nxt][c] = g3[static_cast<size_t>(r + kThreads) * 3 + c];
        // refill ring slot d with the row kDepth tiles ahead
        const int rf = min(r + kDepth * kThreads, r_end - 1);
        lf[d] = leaf_id[rf];
        bn[d] = brow[rf];
        hist_add_tile<PREC, NC>(key[cur], v[cur], hist, tval, tkey, wcells,
                                PREC == kInt8 ? r / qtile : 0, qscale, q8);
      }
    }
  }
  if constexpr (PREC == kInt8) int8_finish(hist, tval, wcells, q8);
  __syncthreads();

  // ---- this block's partial: partial[chunk][f][s0 + s][b][NC] ---------
  hist_write<PREC, NC>(
      hist, cells, wcells,
      partial + ((static_cast<size_t>(chunk) * nf + f) * nl + s0) * nb * NC);
}

// The same work item over a row chunk's list of live rows (K2 and K6).
// `g3` is a plain pointer: K6's int8sr rounds pass the rows it quantized
// earlier in the same launch, which must not come through the read-only
// cache (K2's kernel parameter keeps its __restrict__):
// `lrow` / `lslot` hold, from chunk * chunk_rows on, the chunk's rows
// whose slot is below the round's live limit, in row order, and each
// one's slot; `lcnt[chunk]` counts them (the list stage, wave_round.cuh
// list_tile).  The walk takes them 256 at a time through the same
// hist_add_tile, so every cell still receives its rows one f32 add at a
// time, in row order, from 0.f: the bits of hist_partial_item on the
// rows' labels, at a cost that follows the live rows.  Slots [nl_add, nl)
// are listed by no row and come out 0; an empty chunk writes its zero
// partial and ends.
template <int PREC, int NC, bool PACKED>
__device__ __forceinline__ void hist_partial_list_item(
    int f, int chunk, int group, const uint8_t* __restrict__ binned,
    const float* g3, const int* lrow, const int* lslot,
    const int* lcnt, float* partial, int n, int nf, int nl, int nb,
    int ls_max, int chunk_rows, float* smem, const float* qscale,
    int qtile) {
  const int s0 = group * ls_max;
  const int ls = min(ls_max, nl - s0);
  const int cells = ls * nb;
  const int wcells = cells / kWarps;
  const int tid = threadIdx.x;
  using A = typename AccOf<PREC>::T;
  constexpr int HW = cell_words<PREC, NC>();
  float* pout =
      partial + ((static_cast<size_t>(chunk) * nf + f) * nl + s0) * nb * NC;
  const int cnt = lcnt[chunk];
  if (cnt == 0) {
    A* out = reinterpret_cast<A*>(pout);
    for (int i = tid; i < cells * NC; i += kThreads) out[i] = A(0);
    return;
  }
  float* hist = smem;
  float* tval = hist + static_cast<size_t>(ls_max) * nb * HW;
  int* tkey = reinterpret_cast<int*>(tval + kThreads * HW);
  hist_clear<PREC, NC>(hist, tval, cells);
  Int8Warp q8{-1, {0.f, 0.f, 0.f}};

  const size_t base = static_cast<size_t>(chunk) * chunk_rows;
  const int* rows = lrow + base;
  const int* slots = lslot + base;
  const uint8_t* brow = bin_column<PACKED>(binned, f, n);
  // A ring of this thread's list entries (row, slot) of the next kDepth
  // tiles (row -1 past the list), and the bin byte and values of the
  // current tile's row, gathered one tile ahead and judged and decoded at
  // use.
  int rw[kDepth], sl[kDepth];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    const int j = d * kThreads + tid;
    rw[d] = j < cnt ? rows[j] : -1;
    sl[d] = j < cnt ? slots[j] : 0;
  }
  int bn = 0;
  float vn[3] = {0.f, 0.f, 0.f};
  if (rw[0] >= 0) {
    bn = brow[rw[0]];
    for (int c = 0; c < 3; ++c) vn[c] = g3[static_cast<size_t>(rw[0]) * 3 + c];
  }
  for (int t0 = 0; t0 < cnt; t0 += kDepth * kThreads) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (t0 + d * kThreads >= cnt) break;
      const int key =
          rw[d] >= 0 ? row_key(sl[d], bin_of<PACKED>(bn, f), s0, ls, nb)
                     : -1;
      const float v[3] = {vn[0], vn[1], vn[2]};
      // the next tile's bin and values, in flight while this one adds
      const int rn = rw[(d + 1) % kDepth];
      if (rn >= 0) {
        bn = brow[rn];
        for (int c = 0; c < 3; ++c) vn[c] = g3[static_cast<size_t>(rn) * 3 + c];
      }
      // the row's scale tile (int8), read before the slot is refilled
      const int qt = PREC == kInt8 && rw[d] >= 0 ? rw[d] / qtile : 0;
      // refill ring slot d with the entry kDepth tiles ahead
      const int j = t0 + (d + kDepth) * kThreads + tid;
      rw[d] = j < cnt ? rows[j] : -1;
      sl[d] = j < cnt ? slots[j] : 0;
      hist_add_tile<PREC, NC>(key, v, hist, tval, tkey, wcells, qt, qscale,
                              q8);
    }
  }
  if constexpr (PREC == kInt8) int8_finish(hist, tval, wcells, q8);
  __syncthreads();
  hist_write<PREC, NC>(hist, cells, wcells, pout);
}

// The partial stage as a kernel: one block a work item on the grid
// (nf, n_chunks, slot groups).  MANY: a block small enough in shared
// memory for five an SM is held to the registers of five (the plan's 532
// blocks at the headline then run in one wave of 660, not 528 + 4).
template <int PREC, int NC, bool MANY, bool PACKED>
__global__ void __launch_bounds__(kThreads, MANY ? 5 : 1)
hist_partial_kernel(const uint8_t* __restrict__ binned,
                    const float* __restrict__ g3,
                    const int* __restrict__ leaf_id,
                    float* __restrict__ partial, int n, int nf, int nl,
                    int nl_add, int nb, int ls_max, int chunk_rows,
                    const float* __restrict__ qscale, int qtile) {
  extern __shared__ float smem[];
  hist_partial_item<PREC, NC, PACKED>(blockIdx.x, blockIdx.y, blockIdx.z,
                                      binned, g3, leaf_id, partial, n, nf,
                                      nl, nl_add, nb, ls_max, chunk_rows,
                                      smem, qscale, qtile);
}

// The list walk as a kernel, on the grid (nf, n_chunks, slot groups).
template <int PREC, int NC, bool MANY, bool PACKED>
__global__ void __launch_bounds__(kThreads, MANY ? 5 : 1)
hist_partial_list_kernel(const uint8_t* __restrict__ binned,
                         const float* __restrict__ g3,
                         const int* __restrict__ lrow,
                         const int* __restrict__ lslot,
                         const int* __restrict__ lcnt,
                         float* __restrict__ partial, int n, int nf, int nl,
                         int nb, int ls_max, int chunk_rows,
                         const float* __restrict__ qscale, int qtile) {
  extern __shared__ float smem[];
  hist_partial_list_item<PREC, NC, PACKED>(
      blockIdx.x, blockIdx.y, blockIdx.z, binned, g3, lrow, lslot, lcnt,
      partial, n, nf, nl, nb, ls_max, chunk_rows, smem, qscale, qtile);
}

// One channel of one cell, summed over the chunks in chunk order: the hi
// partials, plus (bf16x2) the same sum of the lo partials; int8sr sums the
// int32 partials and rounds the sum to f32 once; int8's partials are f32
// and add as f32's.  `p` points at the
// cell's channel in chunk 0; `stride` is one chunk's partial size.
template <int PREC, int NC>
__device__ __forceinline__ float merge_cell(const float* p, size_t stride,
                                            int n_chunks) {
  if constexpr (PREC == kInt8sr) {
    const int* q = reinterpret_cast<const int*>(p);
    int s = 0;
    for (int ch = 0; ch < n_chunks; ++ch, q += stride) s += q[0];
    return __int2float_rn(s);
  }
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
// (nf, n_chunks, slot groups): nl slots of which [0, nl_add) add.  int8:
// `qscale` and `qtile`, the rows' scale tiles (hist_partial_item).
// Returns the cudaError_t.
template <int PREC, int NC, bool PACKED>
int launch_hist_partial(const uint8_t* binned, const float* g3,
                        const int* leaf_id, float* partial, int n, int nf,
                        int nl, int nl_add, int nb, int ls_max, int n_chunks,
                        int chunk_rows, const float* qscale, int qtile,
                        cudaStream_t stream) {
  if (PREC == kInt8 && ls_max * nb > kWarps * kInt8MaxWarpCells)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = hist_partial_smem(ls_max, nb, cell_words<PREC, NC>());
  const auto kernel = smem <= kManySmem
                          ? hist_partial_kernel<PREC, NC, true, PACKED>
                          : hist_partial_kernel<PREC, NC, false, PACKED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (nl + ls_max - 1) / ls_max;
  dim3 grid(nf, n_chunks, groups);
  kernel<<<grid, kThreads, smem, stream>>>(binned, g3, leaf_id, partial, n,
                                           nf, nl, nl_add, nb, ls_max,
                                           chunk_rows, qscale, qtile);
  return static_cast<int>(cudaGetLastError());
}

// Sets the list walk's shared memory and launches it on the grid (nf,
// n_chunks, slot groups).  Returns the cudaError_t.
template <int PREC, int NC, bool PACKED>
int launch_hist_partial_list(const uint8_t* binned, const float* g3,
                             const int* lrow, const int* lslot,
                             const int* lcnt, float* partial, int n, int nf,
                             int nl, int nb, int ls_max, int n_chunks,
                             int chunk_rows, const float* qscale, int qtile,
                             cudaStream_t stream) {
  if (PREC == kInt8 && ls_max * nb > kWarps * kInt8MaxWarpCells)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = hist_partial_smem(ls_max, nb, cell_words<PREC, NC>());
  const auto kernel = smem <= kManySmem
                          ? hist_partial_list_kernel<PREC, NC, true, PACKED>
                          : hist_partial_list_kernel<PREC, NC, false, PACKED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (nl + ls_max - 1) / ls_max;
  dim3 grid(nf, n_chunks, groups);
  kernel<<<grid, kThreads, smem, stream>>>(binned, g3, lrow, lslot, lcnt,
                                           partial, n, nf, nl, nb, ls_max,
                                           chunk_rows, qscale, qtile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lgbm
