// The persistent wave loop for Hopper (sm_90a), built by ops/_build.py with
// nvcc into a shared library with a plain C interface, loaded by ctypes.
//
// K6 lgbm_fused_wave_loop — replaces lightgbmv1_tpu/ops/wave_fused.py
//    _loop_kernel (reached through make_fused_wave_loop): R consecutive
//    wave rounds in one launch, the frontier state kept on the device
//    between them.  In: (F, N) u8 bins, (N, 3) f32 rows, the rows' leaf
//    ids, the frontier table ft (L, 12) [gain, feature, threshold,
//    default_left, left g/h/c, right g/h/c, output, depth], the leaf count,
//    the feature meta and mask and, in subtraction mode, the histogram
//    pool (L, F, B, 3).  Out: each round's packed SplitInfo rows
//    (R, 2K, 10), its split count, the leaf ids after the R rounds (in
//    place) and the pool after them (in place).  Each round:
//    0. boundary (block 0): _topk_by_rank over the L frontier gains (ties
//       to the lower leaf), the live count n = #{k: vals > 0, k < L - nl},
//       the slot bucket the single round would pick, S = ladder[#{b <
//       last: n > b}], and the S slots' splits, children's sums and
//       feature mask, as the grower's to_slot fills them;
//    1. route: route_label_tile over the rows (each row's slot found by
//       a binary search of the slots sorted by leaf), new leaf ids in
//       place, the label at S slots and each tile's live rows;
//    2. list: list_tile over the tiles, each row chunk's live rows in
//       row order under ops/hist_cuda.plan at the bucket's slot count;
//    3. histogram partials: hist_partial_list_item over the (feature,
//       chunk, slot group) items of that plan, each walking its chunk's
//       list, handed to the blocks one at a time from a counter;
//    4. scan_item over the (slot, feature) items, up to four a block at
//       once (one a 64-thread scan group on its own shared memory):
//       merge, subtract, scan; in subtraction mode it also commits the
//       pool, pool[leaf] = h_left and pool[new leaf] = h_right, in place
//       (an item owns its parent's (leaf, feature) rows, and new leaves
//       are no parent's);
//    5. pick + commit (block 0, one thread a child): the cross-feature
//       tie-band pick, right sums and default direction as _pick_pack
//       computes them, the packed row, then the children's frontier rows
//       (cgain = -inf past max_depth) and the next round's boundary.
//    The stages are wave_round.cuh's device functions, the ones K2 and K1
//    run (csrc/wave_fused.cu, csrc/hist.cu), on the same work items under
//    the same plan, so every round equals the single round K2 runs at the
//    same bucket, bit for bit, whatever the grid: the grid only decides
//    which block runs an item.  The packed leg (`packed`, the Pallas
//    kernel's `packed` / bin_layout=packed4) runs the headers' packed
//    route and list walk on (ceil(F/2), N) bytes of two 4-bit bins each;
//    its plans are the real F's, so its rounds are the u8 leg's, bit for
//    bit.  Stages are separated by grid barriers
//    (cooperative_groups::this_grid().sync()); a round whose n is 0 ends
//    the loop in every block (all read the same n after a barrier), and
//    its rows stay the zeros the wrapper wrote.
//    int8sr (QUANT: hist_dtype_deep=int8sr, the Pallas kernel's
//    quant_ladder / qmax): a round whose bucket quantizes (the `quant`
//    row of the tables) draws its uniforms in the kernel.  Stage 1's
//    threads also quantize their rows from the prequantized rows zq
//    (ops/quantize.prequantize_rows) under fold_in(key, 8_000_011 + nl),
//    nl the round's leaf count, with csrc/prng.cuh's functions, the ones
//    the quantize kernel runs, on the same counters 2 row + channel over
//    every row; stage 3 runs the int8sr leg of the partials (int32) on
//    those rows and stage 4 merges them as int32 and applies the round's
//    scales (the slots' before the subtraction, pool-free the children's
//    after the cumulative sum).  The other rounds of the segment run at
//    the launch's precision with ones scales, as the single round of a
//    quantized grow does; shared memory is sized for the larger leg.
//    int8 (hist_dtype=int8, the Pallas kernel's precision="int8"): every
//    round runs K2's int8 leg at its bucket's scale tile (the Pallas
//    round's own row tile at the bucket's slots, `qtile` of the tables),
//    on the tree's rows rounded under that tile (`q8`, one pointer pair a
//    bucket: ops/quantize.NearestRows, made before the launch), so a
//    round is the single round bit for bit.  The JAX loop runs one tile
//    for the whole ladder and its planner refuses a ladder whose tiles
//    differ; the card's loop has no such constraint.  No int8 launch
//    also quantizes int8sr buckets (the planner refuses it, as the JAX
//    planner refuses int8sr off an f32 base).
//    The constrained legs (the Pallas kernel's has_contri, path
//    smoothing and max_delta_step; `opts`, at most kLoopOpts): stage 0
//    also makes each child's output, leaf_output clamped to
//    +-max_delta_step and smoothed toward its parent's output (ft col
//    10), which stage 4's scan takes as the parent output it smooths
//    toward and stage 5 commits as the child's output column; stage 4
//    runs the kLoopOpts instance of its scan when the launch runs a leg,
//    the unconstrained one else.  Monotone constraints stay out of the
//    loop, as the JAX planner keeps them.
//
// Numbers.  Stage 5's pick is pick_child (wave_round.cuh), the function
// the single round's pick kernel runs after K2 (csrc/split_scan.cu),
// written with __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn, one
// rounding an op, as the PyTorch ops of _pick_pack and the grower's
// commit each round once: the packed rows equal the pick the single round
// runs on the card, bit for bit.
//
// What bounds it on this card.  A round moves what K2 moves at its bucket
// (about 49 MB at 1,048,576 rows x 28 features and 63 slots of 64 bins,
// 15 us at 3.35 TB/s; its live rows' share of that, as in K2) plus the
// frontier and pool commits (the children's (F, B, 3) rows); its
// arithmetic is far below the f32 rate, so the bound is by bytes.  The
// time goes, as in K2, to the histogram partials, R times.  The TPU
// kernel keeps the frontier, the pool and the labels in VMEM across its
// (R, row tiles) grid; no Hopper block holds a round's histograms (5.5 MB
// of pool and 52 MB of partials at 64 slots), so the state stays in
// device memory (50 MB of L2) and grid barriers take the place of the TPU
// grid's order.  The grid is one block an SM times the blocks the
// occupancy query allows at the largest stage's shared memory (K1's
// partials: 107 KiB at 64 slots in bf16x2, so two an SM); the scan packs
// as many 22.5 KB scan groups into a block as fit (four), and the
// boundary and pick run in one block while the others wait.  An opt-in
// debug buffer takes block 0's globaltimer stamps after each barrier, so
// the stages' split is measured inside a launch.

#include <cooperative_groups.h>

#include "prng.cuh"
#include "wave_round.cuh"

// The launch precisions this library instantiates: the float legs (f32,
// bf16, bf16x2, with or without int8sr buckets), or with LGBM_LOOP_INT8
// the int8 leg alone (csrc/wave_loop_int8.cu includes this file so), two
// libraries whose nvcc's build in parallel.
#ifndef LGBM_LOOP_INT8
#define LGBM_LOOP_INT8 0
#endif

namespace cg = cooperative_groups;
using namespace lgbm;

namespace {

constexpr int kMaxLadder = 8;
constexpr int kFtCols = 12;
// n_split, S, bucket, leaf count, the partial stage's next item
constexpr int kBndHdr = 5;
// The opt-in debug buffer: [0] block 0's entry, [1] the first boundary's
// barrier, then a round's kStages stamps (the end of route, list,
// partials, scan, pick + boundary: each after its grid barrier) and its
// live rows.
constexpr int kStages = 5;
__host__ __device__ inline int debug_words(int R) {
  return 2 + R * (kStages + 1);
}

// The scan options the loop compiles in beside the unconstrained scan
// (kOpt*, wave_round.cuh): every leg but the monotone one, which the
// planner keeps out of the loop.
constexpr int kLoopOpts = kOptSmooth | kOptMaxOut | kOptContri;

// The boundary record of a round in device memory (ints): the header,
// then K slots, K parent depths, 2K x 3 children's sums (f32), the 2K
// children's outputs (f32: the frontier commit's, and the scan's parent
// outputs under path smoothing) and the 2K x nf feature mask (bytes).
__host__ __device__ inline int bnd_depth_off(int K) { return kBndHdr + 9 * K; }
__host__ __device__ inline int bnd_csums_off(int K) {
  return kBndHdr + 10 * K;
}
__host__ __device__ inline int bnd_couts_off(int K) {
  return kBndHdr + 16 * K;
}
__host__ __device__ inline int bnd_mask_off(int K) { return kBndHdr + 18 * K; }
inline int bnd_ints(int K, int nf) {
  return bnd_mask_off(K) + (2 * K * nf + 3) / 4;
}

struct LoopArgs {
  const uint8_t* binned;     // (nf, n), or packed (ceil(nf/2), n)
  const float* g3;           // (n, 3)
  int* leaf;                 // (n,) leaf ids, routed in place
  float* ft;                 // (L, 12) frontier, committed in place
  float* pool;               // (L, nf, B, 3), or null (pool-free)
  const int* fmeta;          // (5, nf) num_bins, mtype, nan/zero bin, usable
  const uint8_t* base_mask;  // (nf,)
  const float* zq;           // (n, 3) prequantized rows, or null
  float* q3;                 // (n, 3) a quantized round's rows, scratch
  const float* qscale;       // (12,) the scales twice, then ones twice
  uint32_t key0, key1;       // the tree's rounding key
  float* packed;             // (R, 2K, 10), zeroed
  int* n_split;              // (R,), zeroed
  int* label;                // (n,) scratch
  int* tile_cnt;             // (ceil(n / 256),) scratch
  int* lrow;                 // the largest bucket's row lists, scratch
  int* lslot;                // and their slots, scratch
  int* lcnt;                 // the largest bucket's chunk counts, scratch
  float* partial;            // the largest bucket's partials, scratch
  float* residue;            // (2K, nf, 6) scratch
  int* bnd;                  // bnd_ints(K, nf) scratch
  unsigned long long* debug;  // stamps and live rows, or null (debug_words)
  int n, nf, B, nb, L, K, R, nl0, max_depth, n_buckets;
  int scan_groups;           // scan groups a block runs at once
  int ladder[kMaxLadder], ls_max[kMaxLadder], n_chunks[kMaxLadder],
      chunk_rows[kMaxLadder], quant[kMaxLadder];
  // int8: each bucket's rounded rows (n, 3), their scales and scale tile
  const float* q8[kMaxLadder];
  const float* q8scale[kMaxLadder];
  int qtile[kMaxLadder];
  ScanParams prm;            // opts: kLoopOpts bits at most
  const float* contri;       // (nf,) feature_contri, or null
};

// Stage 0 for a round that starts at leaf count nl, by block 0: the
// grower's _topk_by_rank, live count, slot bucket and to_slot arrays.
__device__ void boundary(const LoopArgs& a, int nl, float* sm) {
  __shared__ int s_n, s_S;
  float* g = sm;                                      // L gains
  int* lk = reinterpret_cast<int*>(g + a.L);          // K leaves by rank
  float* vk = reinterpret_cast<float*>(lk + a.K);     // K gains by rank
  const int tid = threadIdx.x;
  for (int l = tid; l < a.L; l += blockDim.x) g[l] = a.ft[l * kFtCols];
  for (int k = tid; k < a.K; k += blockDim.x) {
    lk[k] = 0;
    vk[k] = 0.f;
  }
  __syncthreads();
  // rank(l) = #{i : g_i > g_l, or g_i == g_l and i < l}; the sums over
  // each rank (one term, or none) are exact
  for (int l = tid; l < a.L; l += blockDim.x) {
    const float gl = g[l];
    int rank = 0;
    for (int i = 0; i < a.L; ++i) {
      const float gi = g[i];
      rank += (gi > gl) || (gi == gl && i < l);
    }
    if (rank < a.K) {
      atomicAdd(&lk[rank], l);
      atomicAdd(&vk[rank], gl);
    }
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < a.K; ++k) n += (vk[k] > 0.f) && (k < a.L - nl);
    int bi = 0;
    for (int b = 0; b + 1 < a.n_buckets; ++b) bi += n > a.ladder[b];
    a.bnd[0] = n;
    a.bnd[1] = a.ladder[bi];
    a.bnd[2] = bi;
    a.bnd[3] = nl;
    s_n = n;
    s_S = a.ladder[bi];
  }
  __syncthreads();
  const int n = s_n, S = s_S, nf = a.nf;
  Slot* slots = reinterpret_cast<Slot*>(a.bnd + kBndHdr);
  int* pdepth = a.bnd + bnd_depth_off(a.K);
  float* csums = reinterpret_cast<float*>(a.bnd + bnd_csums_off(a.K));
  float* couts = reinterpret_cast<float*>(a.bnd + bnd_couts_off(a.K));
  uint8_t* mask = reinterpret_cast<uint8_t*>(a.bnd + bnd_mask_off(a.K));
  for (int s = tid; s < S; s += blockDim.x) {
    if (s < n) {
      const int leaf = lk[s];
      const float* row = a.ft + static_cast<size_t>(leaf) * kFtCols;
      const int f = static_cast<int>(row[1]);
      slots[s] = Slot{leaf, nl + s, static_cast<int>(row[2]),
                      row[3] != 0.f, a.fmeta[nf + f], a.fmeta[2 * nf + f],
                      a.fmeta[3 * nf + f], row[6] <= row[9], f};
      pdepth[s] = static_cast<int>(row[11]);
      for (int c = 0; c < 6; ++c) csums[6 * s + c] = row[4 + c];
      // the children's outputs, smoothed toward the parent's (row[10])
      for (int c = 0; c < 2; ++c)
        couts[2 * s + c] = child_output<kLoopOpts>(
            row[4 + 3 * c], row[5 + 3 * c], row[6 + 3 * c], row[10], a.prm);
    } else {  // a dead slot: leaf L (no row's), sums 1.0, outputs 0.0
      slots[s] = Slot{a.L, 0, 0, 0, a.fmeta[nf], a.fmeta[2 * nf],
                      a.fmeta[3 * nf], 0, 0};
      pdepth[s] = 0;
      for (int c = 0; c < 6; ++c) csums[6 * s + c] = 1.f;
      couts[2 * s] = couts[2 * s + 1] = 0.f;
    }
  }
  for (int i = tid; i < 2 * S * nf; i += blockDim.x)
    mask[i] = i / nf < 2 * n ? (a.base_mask[i % nf] != 0) : 0;
}

// Stage 5 of round r, by block 0: _pick_pack on the children's residue
// (pick_child, one thread a child), then the live children's frontier
// rows.
__device__ void pick_commit(const LoopArgs& a, int r) {
  const int n = a.bnd[0], S = a.bnd[1], nl = a.bnd[3], nf = a.nf;
  const Slot* slots = reinterpret_cast<const Slot*>(a.bnd + kBndHdr);
  const int* pdepth = a.bnd + bnd_depth_off(a.K);
  const float* csums =
      reinterpret_cast<const float*>(a.bnd + bnd_csums_off(a.K));
  const float* couts =
      reinterpret_cast<const float*>(a.bnd + bnd_couts_off(a.K));
  float* out = a.packed + static_cast<size_t>(r) * 2 * a.K * kPackCols;
  for (int c = threadIdx.x; c < 2 * S; c += blockDim.x) {
    float row[kPackCols];
    pick_child<kLoopOpts>(a.residue + static_cast<size_t>(c) * nf * 6,
                          csums + 3 * c, couts[c], a.fmeta, nf, a.B, a.prm,
                          row);
    for (int k = 0; k < kPackCols; ++k) out[c * kPackCols + k] = row[k];
    if (c < 2 * n) {
      const int s = c >> 1;
      const int cleaf = (c & 1) ? nl + s : slots[s].leaf;
      const int depth = pdepth[s] + 1;
      const bool depth_ok = a.max_depth <= 0 || depth < a.max_depth;
      float* ft = a.ft + static_cast<size_t>(cleaf) * kFtCols;
      ft[0] = depth_ok ? row[0] : -INFINITY;
      for (int k = 1; k < kPackCols; ++k) ft[k] = row[k];
      ft[10] = couts[c];
      ft[11] = static_cast<float>(depth);
    }
  }
  if (threadIdx.x == 0) a.n_split[r] = n;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Block 0's thread 0 stamps debug word i, when the buffer is given.
__device__ __forceinline__ void stamp(const LoopArgs& a, int i) {
  if (a.debug && blockIdx.x == 0 && threadIdx.x == 0)
    a.debug[i] = global_ns();
}

// Stage 4 of a round, by every block: scan_groups (slot, feature) items
// a block at once, one a scan group (scan_item, wave_round.cuh) on its own
// kScanSmemFloats; in subtraction mode an item also commits its pool rows
// in place.  OPTS: the scan options compiled in.
template <int PREC, int NC, bool SUB, bool QUANT, int OPTS>
__device__ __forceinline__ void scan_stage(const LoopArgs& a, int n, int S,
                                           int n_chunks, int nlh,
                                           bool quant_r, float* smem) {
  const int nf = a.nf;
  const Slot* gslots = reinterpret_cast<const Slot*>(a.bnd + kBndHdr);
  const float* csums =
      reinterpret_cast<const float*>(a.bnd + bnd_csums_off(a.K));
  const uint8_t* mask =
      reinterpret_cast<const uint8_t*>(a.bnd + bnd_mask_off(a.K));
  // the scan's parent outputs are the children's own outputs (JAX
  // wave_fused.py:1140-1151)
  const ScanLegs legs{nullptr, nullptr,
                      reinterpret_cast<const float*>(a.bnd +
                                                     bnd_couts_off(a.K)),
                      nullptr, a.contri};
  const size_t hrow = static_cast<size_t>(a.B) * 3;
  const int g = threadIdx.x / kScanGroup;
  if (g >= a.scan_groups) return;
  const int slots_all = gridDim.x * a.scan_groups;
  for (int w = blockIdx.x * a.scan_groups + g; w < S * nf; w += slots_all) {
    const int s = w / nf, f = w % nf;
    const Slot m = gslots[s];
    float* par = nullptr;
    float* out_r = nullptr;
    if (SUB && s < n) {
      par = a.pool + (static_cast<size_t>(m.leaf) * nf + f) * hrow;
      out_r = a.pool + (static_cast<size_t>(m.nl) * nf + f) * hrow;
    }
    // a quantized grow's scales: the round's, or ones (QUANT only)
    const float* sc = QUANT ? a.qscale + (quant_r ? 0 : 6) : nullptr;
    if (quant_r) {
      scan_item<kInt8sr, 3, SUB, OPTS>(
          s, f, threadIdx.x % kScanGroup, 1 + g, a.partial, n_chunks, nf,
          nlh, a.nb, a.B, a.fmeta, mask, csums, SUB && m.sml != 0, par, sc,
          nullptr, par, out_r, a.residue, a.prm, legs,
          smem + g * kScanSmemFloats);
    } else {
      scan_item<PREC, NC, SUB, OPTS>(
          s, f, threadIdx.x % kScanGroup, 1 + g, a.partial, n_chunks, nf,
          nlh, a.nb, a.B, a.fmeta, mask, csums, SUB && m.sml != 0, par, sc,
          nullptr, par, out_r, a.residue, a.prm, legs,
          smem + g * kScanSmemFloats);
    }
  }
}

template <int PREC, int NC, bool SUB, bool PACKED, bool QUANT>
__global__ void __launch_bounds__(kThreads, 2)
wave_loop_kernel(LoopArgs a) {
  extern __shared__ float kernel_smem[];
  float* smem = kernel_smem;
  cg::grid_group grid = cg::this_grid();
  const int nf = a.nf;
  const Slot* gslots = reinterpret_cast<const Slot*>(a.bnd + kBndHdr);
  stamp(a, 0);
  if (blockIdx.x == 0) boundary(a, a.nl0, smem);
  grid.sync();
  stamp(a, 1);
  for (int r = 0; r < a.R; ++r) {
    const int st = 2 + r * (kStages + 1);  // this round's debug words
    const int n = a.bnd[0];
    if (n == 0) break;  // every block read the same n after the barrier
    const int S = a.bnd[1], bi = a.bnd[2], nl = a.bnd[3];
    const int nslots = SUB ? S : 2 * S;
    const int nlh = nslots + 1;  // slot nslots: the rows of no split
    const bool quant_r = QUANT && a.quant[bi] != 0;
    uint32_t rk0 = a.key0, rk1 = a.key1;  // the round's rounding key
    if (quant_r) fold_in(rk0, rk1, static_cast<uint32_t>(8000011 + nl));

    // ---- 1. route: new leaf ids in place, the label, tile counts -----
    Slot* slots = reinterpret_cast<Slot*>(smem);
    int* sleaf = reinterpret_cast<int*>(slots + S);
    int* sidx = sleaf + S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) slots[s] = gslots[s];
    __syncthreads();
    sort_slots(slots, S, sleaf, sidx);
    __syncthreads();
    const int tiles = (a.n + kThreads - 1) / kThreads;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      route_label_tile<SUB, PACKED>(t, a.binned, a.leaf, slots, sleaf, sidx,
                                    a.n, S, nslots, a.leaf, a.label,
                                    a.tile_cnt);
      const int r = t * kThreads + threadIdx.x;
      if (quant_r && r < a.n)  // every row, as the staged draw
        sr_quantize_row(a.zq + static_cast<size_t>(r) * 3, r, rk0, rk1,
                        a.q3 + static_cast<size_t>(r) * 3);
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) a.bnd[4] = 0;  // stage 3's
    grid.sync();
    stamp(a, st);

    // ---- 2. the chunks' live-row lists under the bucket's plan --------
    const int ls_max = a.ls_max[bi], n_chunks = a.n_chunks[bi];
    const int chunk_rows = a.chunk_rows[bi];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x)
      list_tile(t, a.label, a.tile_cnt, a.lrow, a.lslot, a.lcnt, a.n, nslots,
                chunk_rows);
    grid.sync();
    stamp(a, st + 1);
    if (a.debug && blockIdx.x == 0 && threadIdx.x == 0) {
      int live = 0;
      for (int c = 0; c < n_chunks; ++c) live += a.lcnt[c];
      a.debug[st + kStages] = live;
    }

    // ---- 3. histogram partials over the lists (slot nslots, the rows
    //      of no split, in no list); a block takes the next item when it
    //      is done with one, as the block scheduler hands out K2's, so
    //      items of short lists make room for long ones -----------------
    const int groups = (nlh + ls_max - 1) / ls_max;
    const int items = nf * n_chunks * groups;
    __shared__ int s_item;
    for (;;) {
      __syncthreads();  // the last item no longer reads s_item or smem
      if (threadIdx.x == 0) s_item = atomicAdd(a.bnd + 4, 1);
      __syncthreads();
      const int w = s_item;
      if (w >= items) break;
      if (quant_r) {
        hist_partial_list_item<kInt8sr, 3, PACKED>(
            w % nf, (w / nf) % n_chunks, w / (nf * n_chunks), a.binned,
            a.q3, a.lrow, a.lslot, a.lcnt, a.partial, a.n, nf, nlh, a.nb,
            ls_max, chunk_rows, smem, nullptr, 0);
      } else {
        hist_partial_list_item<PREC, NC, PACKED>(
            w % nf, (w / nf) % n_chunks, w / (nf * n_chunks), a.binned,
            PREC == kInt8 ? a.q8[bi] : a.g3, a.lrow, a.lslot, a.lcnt,
            a.partial, a.n, nf, nlh, a.nb, ls_max, chunk_rows, smem,
            a.q8scale[bi], a.qtile[bi]);
      }
    }
    grid.sync();
    stamp(a, st + 2);

    // ---- 4. merge + subtract + scan, and the pool commit: scan_groups
    //      (slot, feature) items a block at once, one a scan group on its
    //      own kScanSmemFloats; the constrained legs' instance when the
    //      launch runs one -------------------------------------------------
    if (a.prm.opts) {
      scan_stage<PREC, NC, SUB, QUANT, kLoopOpts>(a, n, S, n_chunks, nlh,
                                                  quant_r, smem);
    } else {
      scan_stage<PREC, NC, SUB, QUANT, 0>(a, n, S, n_chunks, nlh, quant_r,
                                          smem);
    }
    grid.sync();
    stamp(a, st + 3);

    // ---- 5. pick + frontier commit, the next round's boundary ---------
    if (blockIdx.x == 0) {
      pick_commit(a, r);
      __syncthreads();
      if (r + 1 < a.R) boundary(a, nl + n, smem);
    }
    grid.sync();
    stamp(a, st + 4);
  }
}

using LoopKernel = void (*)(LoopArgs);

template <bool SUB, bool PACKED, bool QUANT>
LoopKernel kernel_of(int precision) {
  if constexpr (LGBM_LOOP_INT8) {
    // never beside int8sr buckets (the planner refuses it)
    if constexpr (QUANT) {
      return nullptr;
    } else {
      return precision == kInt8 ? wave_loop_kernel<kInt8, 3, SUB, PACKED,
                                                   false>
                                : nullptr;
    }
  } else {
    switch (precision) {
      case kF32: return wave_loop_kernel<kF32, 3, SUB, PACKED, QUANT>;
      case kBf16: return wave_loop_kernel<kBf16, 3, SUB, PACKED, QUANT>;
      case kBf16x2: return wave_loop_kernel<kBf16x2, 6, SUB, PACKED, QUANT>;
      default: return nullptr;
    }
  }
}

// The shared-memory words a cell of the partial stage takes at a launch
// precision (cell_words, hist_tile.cuh).
int cell_words_of(int precision) {
  return precision == kBf16x2 || precision == kInt8 ? 6 : 3;
}

template <bool QUANT>
LoopKernel kernel_for_q(int precision, int sub, int packed_bins) {
  if (sub)
    return packed_bins ? kernel_of<true, true, QUANT>(precision)
                       : kernel_of<true, false, QUANT>(precision);
  return packed_bins ? kernel_of<false, true, QUANT>(precision)
                     : kernel_of<false, false, QUANT>(precision);
}

// `quant`: a bucket of the ladder quantizes (the QUANT kernels).  The
// QUANT=false kernels keep the int8sr leg out of the unquantized ladders:
// one kernel for both, the bucket read at run time, took 2-3% more per
// unquantized launch on an H100 (106 -> 118 registers on some variants;
// k6_ab.py, the headline's ladder).
LoopKernel kernel_for(int precision, int sub, int packed_bins, bool quant) {
  return quant ? kernel_for_q<true>(precision, sub, packed_bins)
               : kernel_for_q<false>(precision, sub, packed_bins);
}

bool any_quant(int n_buckets, const int* quant) {
  for (int b = 0; b < n_buckets; ++b)
    if (quant[b]) return true;
  return false;
}

// The largest stage's dynamic shared memory: the partials of any bucket
// (a quantized bucket's at 3 int32 channels), one scan group's, the
// route's slots or the boundary's gains.
size_t loop_smem(int nc, int nb, int L, int K, int n_buckets,
                 const int* ls_max, const int* quant) {
  size_t m = kScanSmemFloats * sizeof(float);
  for (int b = 0; b < n_buckets; ++b) {
    const size_t h = hist_partial_smem(ls_max[b], nb, quant[b] ? 3 : nc);
    m = h > m ? h : m;
  }
  const size_t route = static_cast<size_t>(K) * (sizeof(Slot) + 8);
  const size_t bnd = static_cast<size_t>(L + 2 * K) * sizeof(float);
  m = route > m ? route : m;
  m = bnd > m ? bnd : m;
  return (m + 15) / 16 * 16;
}

// out: [shared memory a block, resident blocks an SM, SMs, cooperative
// launch supported].
int limits(LoopKernel kern, size_t smem, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[2], cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[3], cudaDevAttrCooperativeLaunch, dev);
  int optin = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<int>(smem);
  out[1] = 0;
  if (smem > static_cast<size_t>(optin)) return 0;  // no block fits
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kern,
                                                        kThreads, smem);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Ints of the boundary scratch `bnd` of lgbm_fused_wave_loop.
int lgbm_wave_loop_bnd_ints(int K, int nf) { return bnd_ints(K, nf); }

// 64-bit words of the debug buffer of an R-round launch.
int lgbm_wave_loop_debug_words(int R) { return debug_words(R); }

// The launch's limits on the current device (out: shared memory a block,
// resident blocks an SM, SMs, cooperative launch supported); returns the
// cudaError_t of the queries.  `ls_max` holds each ladder bucket's
// partial-stage slot group (ops/hist_cuda.plan) and `quant` whether it
// quantizes (int8sr); `packed_bins` selects the packed leg's kernel.
int lgbm_wave_loop_limits(int precision, int sub, int packed_bins, int nb,
                          int L, int K, int n_buckets, const int* ls_max,
                          const int* quant, int* out) {
  if (n_buckets < 1 || n_buckets > kMaxLadder)
    return static_cast<int>(cudaErrorInvalidValue);
  const LoopKernel kern = kernel_for(precision, sub, packed_bins,
                                     any_quant(n_buckets, quant));
  if (!kern) return static_cast<int>(cudaErrorInvalidValue);
  return limits(kern,
                loop_smem(cell_words_of(precision), nb, L, K, n_buckets,
                          ls_max, quant),
                out);
}

// K6.  Returns the cudaError_t of the launch (0 = launched).  `tables`
// (host) holds 6 rows of n_buckets ints: the slot ladder, each bucket's
// ls_max, n_chunks and chunk_rows (ops/hist_cuda.plan at its nslots + 1
// slots, int8sr for a quantized bucket), whether it quantizes and (int8)
// its scale tile.  int8: `q8` (host) holds 2 n_buckets pointers, each
// bucket's rounded rows (n, 3) f32 and then each bucket's scales (ceil(n
// / tile), 3) f32; null otherwise.  With
// a quantized bucket `zq` (n, 3) holds the prequantized rows, `q3` (n, 3)
// is scratch (after the launch: the last quantized round's rows),
// `qscale` (12,) f32 the round scales twice and then six ones, and
// (key0, key1) the tree's rounding key; else all three may be null.
// `leaf`, `ft` and `pool` are updated in place; `packed` (R, 2K, 10) and
// `n_split` (R,) must be zeroed; `label` (N,), `tile_cnt`, `lrow`,
// `lslot`, `lcnt` (fused_cuda.list_scratch at the largest bucket's plan),
// `partial` (the largest bucket's), `residue` (2K, nf, 6) and `bnd`
// (lgbm_wave_loop_bnd_ints) are scratch.  Pool-free when `sub` is 0.
// `binned` is (nf, n) bytes, or with `packed_bins` != 0 the (ceil(nf/2),
// n) packed bytes of the nf features (nb must then be 16).
// `debug` (null, or lgbm_wave_loop_debug_words(R) zeroed words) receives
// block 0's globaltimer stamps (ns) after each grid barrier and each
// round's live rows.  `opts` (kLoopOpts bits at most) names the scan's
// legs, with max_delta_step / path_smooth their values and `contri`
// (nf,) f32 the contri multipliers (null without kOptContri).
int lgbm_fused_wave_loop(const void* binned, const void* g3, void* leaf,
                         void* ft, void* pool, const void* fmeta,
                         const void* base_mask, const void* zq, void* q3,
                         const void* qscale, unsigned key0, unsigned key1,
                         void* packed, void* n_split,
                         void* label, void* tile_cnt, void* lrow, void* lslot,
                         void* lcnt, void* partial, void* residue, void* bnd,
                         void* debug, const void* tables, const void* contri,
                         const void* const* q8,
                         int n, int nf, int B, int nb,
                         int L, int K, int R, int num_leaves, int max_depth,
                         int n_buckets, int precision, int sub,
                         int packed_bins, float l1, float l2,
                         float min_data, float min_hess, float min_gain,
                         float max_delta_step, float path_smooth,
                         float monotone_penalty, int opts, void* stream) {
  if (n_buckets < 1 || n_buckets > kMaxLadder || (opts & ~kLoopOpts) ||
      ((opts & kOptContri) && !contri))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* t = static_cast<const int*>(tables);
  const bool quant = any_quant(n_buckets, t + 4 * n_buckets);
  const LoopKernel kern = kernel_for(precision, sub, packed_bins, quant);
  if (!kern || B > kMaxBins || K < 1 || R < 1 || (sub && !pool) ||
      (packed_bins && nb != 16) || (quant && (!zq || !q3 || !qscale)))
    return static_cast<int>(cudaErrorInvalidValue);
  LoopArgs a{};
  a.binned = static_cast<const uint8_t*>(binned);
  a.g3 = static_cast<const float*>(g3);
  a.leaf = static_cast<int*>(leaf);
  a.ft = static_cast<float*>(ft);
  a.pool = static_cast<float*>(pool);
  a.fmeta = static_cast<const int*>(fmeta);
  a.base_mask = static_cast<const uint8_t*>(base_mask);
  a.zq = static_cast<const float*>(zq);
  a.q3 = static_cast<float*>(q3);
  a.qscale = static_cast<const float*>(qscale);
  a.key0 = key0;
  a.key1 = key1;
  a.packed = static_cast<float*>(packed);
  a.n_split = static_cast<int*>(n_split);
  a.label = static_cast<int*>(label);
  a.tile_cnt = static_cast<int*>(tile_cnt);
  a.lrow = static_cast<int*>(lrow);
  a.lslot = static_cast<int*>(lslot);
  a.lcnt = static_cast<int*>(lcnt);
  a.partial = static_cast<float*>(partial);
  a.residue = static_cast<float*>(residue);
  a.bnd = static_cast<int*>(bnd);
  a.debug = static_cast<unsigned long long*>(debug);
  a.n = n;
  a.nf = nf;
  a.B = B;
  a.nb = nb;
  a.L = L;
  a.K = K;
  a.R = R;
  a.nl0 = num_leaves;
  a.max_depth = max_depth;
  a.n_buckets = n_buckets;
  for (int b = 0; b < n_buckets; ++b) {
    a.ladder[b] = t[b];
    a.ls_max[b] = t[n_buckets + b];
    a.n_chunks[b] = t[2 * n_buckets + b];
    a.chunk_rows[b] = t[3 * n_buckets + b];
    a.quant[b] = t[4 * n_buckets + b];
    a.qtile[b] = t[5 * n_buckets + b];
    a.q8[b] = q8 ? static_cast<const float*>(q8[b]) : nullptr;
    a.q8scale[b] = q8 ? static_cast<const float*>(q8[n_buckets + b])
                      : nullptr;
    if (a.ladder[b] > K || a.ls_max[b] < 1 ||
        a.chunk_rows[b] % kThreads != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if (precision == kInt8 &&
        (!a.q8[b] || !a.q8scale[b] || a.qtile[b] <= 0 ||
         a.chunk_rows[b] % a.qtile[b] != 0 ||
         a.ls_max[b] * nb > kWarps * kInt8MaxWarpCells))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  a.prm = ScanParams{l1,        l2,          min_data,
                     min_hess,  min_gain,    max_delta_step,
                     path_smooth, monotone_penalty, opts};
  a.contri = static_cast<const float*>(contri);
  const size_t smem = loop_smem(cell_words_of(precision), nb, L, K,
                                n_buckets, a.ls_max, a.quant);
  int lim[4];
  int err = limits(kern, smem, lim);
  if (err != 0) return err;
  if (!lim[3] || lim[1] < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (n == 0) {  // no tile to list: every chunk's list is empty
    int chunks = 0;
    for (int b = 0; b < n_buckets; ++b)
      chunks = a.n_chunks[b] > chunks ? a.n_chunks[b] : chunks;
    err = static_cast<int>(cudaMemsetAsync(lcnt, 0, chunks * sizeof(int),
                                           static_cast<cudaStream_t>(stream)));
    if (err != 0) return err;
  }
  const int fit = static_cast<int>(smem / (kScanSmemFloats * sizeof(float)));
  const int most = kThreads / kScanGroup;
  a.scan_groups = fit < most ? fit : most;
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kern), dim3(lim[1] * lim[2]),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
