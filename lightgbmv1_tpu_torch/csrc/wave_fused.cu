// The fused wave round for Hopper (sm_90a), built by ops/_build.py with
// nvcc into a shared library with a plain C interface, loaded by ctypes.
//
// K2 lgbm_fused_round — replaces lightgbmv1_tpu/ops/wave_fused.py
//    _fused_kernel (reached through fused_wave_scan / make_fused_round):
//    one routed wave round.  In: (F, N) u8 bins, (N, 3) f32 rows, the
//    rows' current leaf ids, the round's S splits (rmeta (S, 8) i32 and
//    their features), per-feature meta, the children's feature mask and
//    sums and, in subtraction mode, the smaller-is-left flags and the
//    parents' (S, F, B, 3) histograms.  Out: the new leaf ids and the
//    row -> slot label (N,), the smaller children's histograms hsmall
//    (S, F, B, 3) in subtraction mode, and the (2S, F, 6) residue
//    [best gain, gain at the pick, pick, left g/h/c] of every child and
//    feature.  Four launches:
//    (a) route_label_kernel: one thread a row applies its leaf's split
//        (go_left_rule with the NaN / zero missing rules, op for op as
//        route_tile; the slot found by a binary search of the slots
//        sorted by leaf) and writes the new leaf id and the label: the
//        smaller child's slot in subtraction mode, 2s + right pool-free,
//        nslots for a row of no split.  Integer only, so exact.  Each
//        256-row tile also counts its live rows (label < nslots).
//    (b) list_kernel: for each row chunk of the plan K1 takes for
//        nslots + 1 slots (ops/hist_cuda.plan), the chunk's live rows in
//        row order, with their slots, and their count (list_tile).
//    (c) K1's partial stage walking those lists
//        (hist_partial_list_item, hist_tile.cuh): the same tiles of adds
//        on the same rows in the same order, so hsmall equals K1's
//        histogram of the label bit for bit; the rows of no split (slot
//        nslots, read by nothing) are in no list, as hist_wave drops them
//        in K1.  An item's cost follows its chunk's live rows.
//    (d) scan_kernel: one block a (slot, feature), one warp a child.  It
//        merges the partials in chunk order (merge_cell, as K1's merge
//        kernel), writes hsmall, subtracts (h_left = sml ? hsm : parent -
//        hsm, h_right = parent - h_left), runs both scan directions' left
//        sums in bin order, the gains with their min-data / min-hessian
//        gates and validity mask, and the per-feature tie-band pick, and
//        writes the residue row.  The cross-feature half of the pick
//        stays outside, as in the JAX package.
//    int8sr rounds (hist_dtype_deep=int8sr; the Pallas kernel's
//    precision="int8sr" with apply_scale / child_scale): (c) sums the
//    quantized rows (exact integers, csrc/quantize.cu) as int32, K1's
//    int8sr leg, (d) merges them as int32 and rounds once to f32, writes
//    hsmall raw, and multiplies by the round's power-of-two scales: the
//    smaller child before the subtraction, or pool-free the prefix sums
//    after the cumulative sum (scan_item, wave_round.cuh).  `scale` also
//    carries the ones of a quantized grow's other rounds.
//    int8 rounds (hist_dtype=int8 / hist_dtype_deep=int8; the Pallas
//    kernel's precision="int8"): (c) runs K1's int8 leg on the listed
//    rows, read from the rows rounded under one scale a tile of `qtile`
//    rows (csrc/quantize.cu lgbm_rn_quantize; `qtile` the Pallas round's
//    own row tile), with the tiles' scales `qscale`, taken over all of a
//    tile's rows whether listed or not, as the Pallas kernel's tile amax
//    is; (d) merges the f32 partials as the float legs do.
//    The constrained legs (the Pallas kernel's use_mc / monotone_penalty,
//    has_contri, path smoothing and max_delta_step; `opts`, kOpt* of
//    wave_round.cuh): (d) runs scan_child with them compiled in (the
//    kOptAll instance of scan_kernel, each leg switched by `opts`), on
//    the children's bounds, penalty factors and parent outputs; an
//    unconstrained round runs the instance without them.  The split-scan
//    kernel (split_scan.cu) runs the same scan_child on staged
//    histograms, so every pick on the card is made from K2's bits.
// K3 lgbm_route_rows — replaces wave_fused.py _route_only_kernel (reached
//    through fused_route_rows): a row set routed from its leaf ids through
//    a tree's rounds of splits in one launch.  The TPU kernel routes the
//    valid set through one round at a time, a launch a round; nobody
//    reads the valid leaf ids before the tree is grown, and the routing is
//    integer, so routing each row through all R rounds at once gives the
//    same ids.  In: the P splits in round order (rmeta (P, 8) and their
//    features) and the rounds' offsets (R + 1,); no offsets is one round.
//    The tables (each split's Slot and its place in its round's
//    leaf-sorted order, the order sort_slots gives, and the offsets) sit
//    in the block's shared memory, each split placed by a thread of its
//    own; one thread a row keeps the row's leaf id in a register across
//    the rounds, a round one binary search (route_leaf, the decision K2
//    and K6 run) and a bin load where its leaf splits, so the ids are
//    read and written once.  A tree whose tables pass kRouteSmemBytes has
//    them built once in device memory by route_tables_kernel and read
//    from there (through L1) by every block; on an H100 that leg routes a
//    254-split tree about 1.4x slower than the blocks' own shared copies,
//    so both stay.  What bounds K3: 8 bytes a
//    row and a bin byte for each round its leaf splits in, under a
//    microsecond at 131,072 rows; but a row's rounds are a chain of
//    dependent loads (the next round's feature follows this round's
//    leaf), so its time is that chain's latency, about one L2 round trip
//    a round, and the blocks' table set-up.
// K3 also takes (F, N) int16 bins (`layout` 2, max_bin > 255; the JAX
//    staged path routes them with XLA's route()): its 16-bit leg reads
//    each decision bin as an int16 (route_leaf's BinT), every other step
//    the u8 leg's, so on bins below 256 its ids are the u8 leg's.
// Both take 4-bit packed bins (`packed`, the Pallas kernels' `fpb > 0` /
//    `decision_bins(packed=True)` legs, bin_layout=packed4): (ceil(F/2), N)
//    bytes of two features each.  Only the loads in (a) and (c) differ
//    (bin_of, hist_tile.cuh); F is the real feature count, so the grid,
//    the plan, the lists and the cell order, and with them the bits, are
//    the u8 leg's.
//
// The stages are __device__ functions of one work item each
// (route_label_tile, list_tile and scan_item in wave_round.cuh,
// hist_partial_list_item in hist_tile.cuh); the kernels here run them one
// block an item, and the persistent wave loop K6 (wave_loop.cu) runs the
// same functions R rounds in one launch.
//
// Numbers.  The scan's arithmetic is written with __fadd_rn / __fsub_rn /
// __fmul_rn / __fdiv_rn, so nothing is contracted into an fma and the
// division is IEEE, and the left sums accumulate in double and round each
// prefix to f32: that is what torch.cumsum of an f32 tensor does on the
// CPU.  The residue then equals the plain version run on the CPU on the
// same histograms; torch.cumsum on the card scans in f32 in another
// order, so the plain version there differs in the last bits.
//
// What bounds it on this card.  A round reads the bins, the rows and the
// leaf ids once, writes the label and the new leaf ids, reads the parents
// and writes hsmall: about 49 MB at 1,048,576 rows x 28 features and 63
// slots of 64 bins, 15 us at 3.35 TB/s.  Only the live rows' bins and
// rows need reading, though: in subtraction mode a round labels the
// smaller children alone, a fifth to a third of the rows at the headline,
// so the work's own bound is one pass over the leaf ids and labels plus
// the live rows' bins and rows.  Its arithmetic (3 or 6 f32 adds a live
// row and feature, and the scan's O(2S F B)) is far below the f32 rate,
// so the bound is by bytes.  The time goes to (c), one block barrier and
// compaction a tile of 256 listed rows.  The TPU kernel instead runs the
// histogram as a one-hot product on the MXU and the scan on the
// VMEM-resident accumulator; on Hopper the one-hot product would do L
// times the useful work, and a block cannot hold a round's histograms, so
// the partials go through device memory (L2) between (c) and (d).

#include "wave_round.cuh"

using namespace lgbm;

namespace {

// the routing and list grids stride over the tiles with at most this many
// blocks
constexpr int kRouteMaxBlocks = 8 * 132;

int route_blocks(int tiles) {
  return tiles < kRouteMaxBlocks ? tiles : kRouteMaxBlocks;
}

// the route's shared memory a slot: the slot and its place in the
// leaf-sorted order (leaf, slot)
constexpr size_t kRouteSlotBytes = sizeof(Slot) + 2 * sizeof(int);

// K3's tables: P Slots; each round's leaf-sorted order, as P leaves and
// then P round-local slots (round q's at its offset); the R + 1 offsets.
// In shared memory up to kRouteSmemBytes, past it in the caller's device
// scratch, P (kRmetaCols + 3) + R + 1 ints (fused_cuda.route_rows).
constexpr size_t kRouteSmemBytes = 48 * 1024;
static_assert(sizeof(Slot) == (kRmetaCols + 1) * sizeof(int),
              "a Slot is an rmeta row and its feature");

size_t route_table_bytes(int P, int R) {
  return static_cast<size_t>(P) * kRouteSlotBytes +
         static_cast<size_t>(R + 1) * sizeof(int);
}

struct RouteTables {
  Slot* slots;
  int* sleaf;
  int* sidx;
  int* off;
};

__device__ __forceinline__ RouteTables route_tables(int* base, int P) {
  Slot* slots = reinterpret_cast<Slot*>(base);
  int* sleaf = reinterpret_cast<int*>(slots + P);
  return RouteTables{slots, sleaf, sleaf + P, sleaf + 2 * P};
}

// Round q's split range; a null `offs` is one round of the P splits.
__device__ __forceinline__ int round_offset(const int* offs, int q, int P) {
  return offs ? offs[q] : (q ? P : 0);
}

// Split s of P in R rounds (round q: round_offset(q) .. round_offset(q +
// 1), rising): its place in its round's leaf order, ties in slot order
// (slot_rank on the leaves leaf0[t * stride], the order sort_slots gives),
// written to the tables with its round-local slot.
__device__ __forceinline__ void place_split(int s, const int* offs, int P,
                                            int R, const int* leaf0,
                                            int stride,
                                            const RouteTables& tb) {
  // s's round: the last q with off(q) <= s (off(R) = P > s), past any
  // empty round at the same offset
  int lo = 0, hi = R - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (round_offset(offs, mid, P) <= s) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int o = round_offset(offs, lo, P);
  const int rank = slot_rank(leaf0 + static_cast<size_t>(o) * stride, stride,
                             round_offset(offs, lo + 1, P) - o, s - o);
  tb.sleaf[o + rank] = leaf0[static_cast<size_t>(s) * stride];
  tb.sidx[o + rank] = s - o;
}

// Each row of the grid from its leaf id through the R rounds of `tb`
// (BinT: the bins' type, uint8_t or K3's 16-bit leg's int16_t).
template <bool PACKED, typename BinT>
__device__ __forceinline__ void route_rounds(
    const BinT* __restrict__ binned, const int* __restrict__ oleaf,
    const RouteTables& tb, int* __restrict__ new_leaf, int n, int R) {
  const int step = gridDim.x * blockDim.x;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n; r += step) {
    int lf = oleaf[r];
    for (int q = 0; q < R; ++q) {
      const int o = tb.off[q];
      int dlab = 0;
      lf = route_leaf<false, false, PACKED, BinT>(r, lf, binned, tb.slots + o,
                                            tb.sleaf + o, tb.sidx + o, n,
                                            tb.off[q + 1] - o, 0, dlab);
    }
    new_leaf[r] = lf;
  }
}

// K3 on tables in shared memory: each block loads the P slots and the
// offsets, places each split in its round's leaf order (a thread a
// split), then routes its rows.
template <bool PACKED, typename BinT>
__global__ void __launch_bounds__(kThreads)
route_kernel(const BinT* __restrict__ binned,
             const int* __restrict__ oleaf, const int* __restrict__ feats,
             const int* __restrict__ rmeta, const int* __restrict__ offs,
             int* __restrict__ new_leaf, int n, int P, int R) {
  extern __shared__ int route_smem[];
  const RouteTables tb = route_tables(route_smem, P);
  load_slots(rmeta, feats, P, tb.slots);
  for (int q = threadIdx.x; q <= R; q += blockDim.x)
    tb.off[q] = round_offset(offs, q, P);
  __syncthreads();
  constexpr int kSlotInts = sizeof(Slot) / sizeof(int);
  for (int s = threadIdx.x; s < P; s += blockDim.x)
    place_split(s, offs, P, R, &tb.slots[0].leaf, kSlotInts, tb);
  __syncthreads();
  route_rounds<PACKED, BinT>(binned, oleaf, tb, new_leaf, n, R);
}

// The tables of a tree past kRouteSmemBytes, built once in device memory
// `tab`: one thread a split writes its Slot and places it in its round
// (on rmeta's leaf column).
__global__ void __launch_bounds__(kThreads)
route_tables_kernel(const int* __restrict__ feats,
                    const int* __restrict__ rmeta,
                    const int* __restrict__ offs, int* __restrict__ tab,
                    int P, int R) {
  const RouteTables tb = route_tables(tab, P);
  const int step = gridDim.x * blockDim.x;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  for (int q = g; q <= R; q += step) tb.off[q] = round_offset(offs, q, P);
  for (int s = g; s < P; s += step) {
    const int* m = rmeta + static_cast<size_t>(s) * kRmetaCols;
    tb.slots[s] = Slot{m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7],
                       feats[s]};
    place_split(s, offs, P, R, rmeta, kRmetaCols, tb);
  }
}

// K3 on the tables `route_tables_kernel` built in device memory.
template <bool PACKED, typename BinT>
__global__ void __launch_bounds__(kThreads)
route_global_kernel(const BinT* __restrict__ binned,
                    const int* __restrict__ oleaf, int* __restrict__ tab,
                    int* __restrict__ new_leaf, int n, int P, int R) {
  route_rounds<PACKED, BinT>(binned, oleaf, route_tables(tab, P), new_leaf, n,
                             R);
}

// K3's launch on bins of type BinT: the tables in each block's shared
// memory up to kRouteSmemBytes, else built once in `tab`.
template <bool PACKED, typename BinT>
int route_launch(const BinT* bn, const int* ol, const int* ft, const int* rm,
                 const int* of, int* o, int* tb, int n, int P, int R,
                 cudaStream_t st) {
  const int blocks = route_blocks((n + kThreads - 1) / kThreads);
  if (route_table_bytes(P, R) <= kRouteSmemBytes) {
    route_kernel<PACKED, BinT><<<blocks, kThreads, route_table_bytes(P, R),
                                 st>>>(bn, ol, ft, rm, of, o, n, P, R);
    return static_cast<int>(cudaGetLastError());
  }
  const int splits = P > R + 1 ? P : R + 1;
  route_tables_kernel<<<route_blocks((splits + kThreads - 1) / kThreads),
                        kThreads, 0, st>>>(ft, rm, of, tb, P, R);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  route_global_kernel<PACKED, BinT><<<blocks, kThreads, 0, st>>>(bn, ol, tb,
                                                                 o, n, P, R);
  return static_cast<int>(cudaGetLastError());
}

// K2 (a): route_label_tile on the tiles of the grid: new leaf ids, the
// label and each tile's live rows.
template <bool SUB, bool PACKED>
__global__ void __launch_bounds__(kThreads)
route_label_kernel(const uint8_t* __restrict__ binned,
                   const int* __restrict__ oleaf,
                   const int* __restrict__ feats,
                   const int* __restrict__ rmeta, int* __restrict__ new_leaf,
                   int* __restrict__ label, int* __restrict__ tile_cnt, int n,
                   int ns, int nslots) {
  extern __shared__ int route_smem[];
  Slot* slots = reinterpret_cast<Slot*>(route_smem);
  int* sleaf = reinterpret_cast<int*>(slots + ns);
  int* sidx = sleaf + ns;
  load_slots(rmeta, feats, ns, slots);
  __syncthreads();
  sort_slots(slots, ns, sleaf, sidx);
  __syncthreads();
  const int tiles = (n + kThreads - 1) / kThreads;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    route_label_tile<SUB, PACKED>(t, binned, oleaf, slots, sleaf, sidx, n,
                                  ns, nslots, new_leaf, label, tile_cnt);
}

// K2 (b): list_tile on the tiles of the grid.
__global__ void __launch_bounds__(kThreads)
list_kernel(const int* __restrict__ label, const int* __restrict__ tile_cnt,
            int* __restrict__ lrow, int* __restrict__ lslot,
            int* __restrict__ lcnt, int n, int nslots, int chunk_rows) {
  const int tiles = (n + kThreads - 1) / kThreads;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    list_tile(t, label, tile_cnt, lrow, lslot, lcnt, n, nslots, chunk_rows);
}

// K2 (d): block (s, f) runs scan_item (wave_round.cuh) as one scan group.
// OPTS: the scan's options compiled in (0, or kOptAll with prm.opts
// choosing the legs), so the unconstrained round runs the unconstrained
// code.
template <int PREC, int NC, bool SUB, int OPTS>
__global__ void __launch_bounds__(kScanGroup)
scan_kernel(const float* __restrict__ partial, int n_chunks, int nf, int nl,
            int nb, int B, const int* __restrict__ fmeta,
            const uint8_t* __restrict__ mask, const float* __restrict__ csums,
            const uint8_t* __restrict__ sml, const float* __restrict__ parent,
            const float* __restrict__ scale, float* __restrict__ hsmall,
            float* __restrict__ residue, ScanParams prm, ScanLegs legs) {
  __shared__ float sm[kScanSmemFloats];
  const int s = blockIdx.x;
  const int f = blockIdx.y;
  const size_t o = (static_cast<size_t>(s) * nf + f) * B * 3;
  // the slot's scales (subtraction) or its two children's (pool-free)
  const float* sc = scale ? scale + (SUB ? 3 * s : 6 * s) : nullptr;
  scan_item<PREC, NC, SUB, OPTS>(
      s, f, threadIdx.x, 1, partial, n_chunks, nf, nl, nb, B, fmeta, mask,
      csums, SUB && sml[s] != 0, SUB ? parent + o : nullptr, sc,
      SUB ? hsmall + o : nullptr, nullptr, nullptr, residue, prm, legs, sm);
}

// The round's scratch: tile counts, the chunks' row lists and slots, the
// chunks' counts, and the partials.
struct RoundScratch {
  int* tile_cnt;
  int* lrow;
  int* lslot;
  int* lcnt;
  float* partial;
};

template <int PREC, int NC, bool SUB, bool PACKED>
int launch_round(const uint8_t* binned, const float* g3, const int* oleaf,
                 const int* feats, const int* rmeta, int* label,
                 int* new_leaf, const RoundScratch& w, const int* fmeta,
                 const uint8_t* mask, const float* csums, const uint8_t* sml,
                 const float* parent, const float* scale, float* residue,
                 float* hsmall, int n, int nf, int S, int nslots, int nb,
                 int B, int ls_max, int n_chunks, int chunk_rows,
                 const float* qscale, int qtile, const ScanParams& prm,
                 const ScanLegs& legs, cudaStream_t stream) {
  if (chunk_rows % kThreads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + kThreads - 1) / kThreads;
  int err = 0;
  if (tiles == 0) {
    err = static_cast<int>(
        cudaMemsetAsync(w.lcnt, 0, n_chunks * sizeof(int), stream));
  } else {
    route_label_kernel<SUB, PACKED><<<route_blocks(tiles), kThreads,
                                      static_cast<size_t>(S) *
                                          kRouteSlotBytes,
                                      stream>>>(binned, oleaf, feats, rmeta,
                                                new_leaf, label, w.tile_cnt,
                                                n, S, nslots);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    list_kernel<<<route_blocks(tiles), kThreads, 0, stream>>>(
        label, w.tile_cnt, w.lrow, w.lslot, w.lcnt, n, nslots, chunk_rows);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err != 0) return err;
  const int nl = nslots + 1;  // slot nslots: the rows of no split, unlisted
  err = launch_hist_partial_list<PREC, NC, PACKED>(
      binned, g3, w.lrow, w.lslot, w.lcnt, w.partial, n, nf, nl, nb, ls_max,
      n_chunks, chunk_rows, qscale, qtile, stream);
  if (err != 0) return err;
  dim3 grid(S, nf);
  const auto scan = prm.opts ? scan_kernel<PREC, NC, SUB, kOptAll>
                             : scan_kernel<PREC, NC, SUB, 0>;
  scan<<<grid, kScanGroup, 0, stream>>>(w.partial, n_chunks, nf, nl, nb, B,
                                        fmeta, mask, csums, sml, parent,
                                        scale, hsmall, residue, prm, legs);
  return static_cast<int>(cudaGetLastError());
}

template <bool SUB, bool PACKED>
int dispatch_precision(int precision, const uint8_t* binned, const float* g3,
                       const int* oleaf, const int* feats, const int* rmeta,
                       int* label, int* new_leaf, const RoundScratch& w,
                       const int* fmeta, const uint8_t* mask,
                       const float* csums, const uint8_t* sml,
                       const float* parent, const float* scale,
                       float* residue, float* hsmall, int n, int nf, int S,
                       int nslots, int nb, int B, int ls_max, int n_chunks,
                       int chunk_rows, const float* qscale, int qtile,
                       const ScanParams& prm, const ScanLegs& legs,
                       cudaStream_t stream) {
#define LGBM_ROUND(P, C)                                                   \
  launch_round<P, C, SUB, PACKED>(binned, g3, oleaf, feats, rmeta, label,  \
                                  new_leaf, w, fmeta, mask, csums, sml,     \
                                  parent, scale, residue, hsmall, n, nf, S, \
                                  nslots, nb, B, ls_max, n_chunks,          \
                                  chunk_rows, qscale, qtile, prm, legs,     \
                                  stream)
  switch (precision) {
    case kF32:
      return LGBM_ROUND(kF32, 3);
    case kBf16:
      return LGBM_ROUND(kBf16, 3);
    case kBf16x2:
      return LGBM_ROUND(kBf16x2, 6);
    case kInt8sr:
      return LGBM_ROUND(kInt8sr, 3);
    case kInt8:
      // a scale tile never splits across chunks, nor a chunk's end
      if (!qscale || qtile <= 0 || chunk_rows % qtile != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      return LGBM_ROUND(kInt8, 3);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LGBM_ROUND
}

}  // namespace

extern "C" {

// K2.  Returns the cudaError_t of the launches (0 = all launched).
// `oleaf` (N,), `feats` (S,) and `rmeta` (S, 8) are read and `label` /
// `new_leaf` (N,) written.  Scratch: `tile_cnt` (ceil(N / 256),) i32,
// `lrow` and `lslot` (n_chunks * chunk_rows,) i32, `lcnt` (n_chunks,)
// i32, and `partial` (n_chunks, nf, nslots + 1, nb, 6 or 3) f32 (int8sr:
// int32).  `fmeta` (5, nf) i32 [num_bins, missing_type, nan_bin,
// zero_bin, usable]; `mask` (2S, nf) and `sml` (S,) bytes; `csums` (2S,
// 3); `parent` / `hsmall` (S, nf, B, 3) in subtraction mode (`sub` != 0,
// nslots = S; else nslots = 2S); `scale` (nslots, 3) f32 or null, the
// slots' dequantization; `residue` (2S, nf, 6).  `binned` is
// (nf, N) bytes, or with `packed` != 0 the (ceil(nf/2), N) packed bytes
// of the nf features (nb must then be 16).  `opts` (kOpt*, wave_round.cuh)
// names the scan's constrained legs and `constr` (2S, 2) (null:
// NO_CONSTRAINT), `pfac` (2S,), `pout` (2S,) (null: 0), `mono` (nf,) i32,
// `contri` (nf,) their inputs, null where a leg is off (`pfac` also
// without a monotone penalty).  int8:
// `g3` holds the rows rounded under `qtile`-row scale tiles and `qscale`
// their (ceil(N / qtile), 3) scales; null / 0 otherwise.
int lgbm_fused_round(const void* binned, const void* g3, const void* oleaf,
                     const void* feats, const void* rmeta, void* label,
                     void* new_leaf, void* tile_cnt, void* lrow, void* lslot,
                     void* lcnt, void* partial, const void* fmeta,
                     const void* mask, const void* csums, const void* sml,
                     const void* parent, const void* scale, void* residue,
                     void* hsmall, const void* constr, const void* pfac,
                     const void* pout, const void* mono, const void* contri,
                     int n,
                     int nf, int S, int nb, int B, int ls_max, int n_chunks,
                     int chunk_rows, int precision, int sub, int packed,
                     float l1, float l2, float min_data, float min_hess,
                     float min_gain, float max_delta_step, float path_smooth,
                     float monotone_penalty, int opts, const void* qscale,
                     int qtile, void* stream) {
  if (B > kMaxBins || S <= 0 || (packed && nb != 16) || opts < 0 ||
      opts > kOptAll ||
      ((opts & kOptMc) && (!mono || (monotone_penalty > 0.f && !pfac))) ||
      ((opts & kOptContri) && !contri))
    return static_cast<int>(cudaErrorInvalidValue);
  const ScanParams prm{l1, l2, min_data, min_hess, min_gain,
                       max_delta_step, path_smooth, monotone_penalty, opts};
  const ScanLegs legs{static_cast<const float*>(constr),
                      static_cast<const float*>(pfac),
                      static_cast<const float*>(pout),
                      static_cast<const int*>(mono),
                      static_cast<const float*>(contri)};
  const RoundScratch w{static_cast<int*>(tile_cnt), static_cast<int*>(lrow),
                       static_cast<int*>(lslot), static_cast<int*>(lcnt),
                       static_cast<float*>(partial)};
  const auto* bn = static_cast<const uint8_t*>(binned);
  const auto* g = static_cast<const float*>(g3);
  const auto* ol = static_cast<const int*>(oleaf);
  const auto* ft = static_cast<const int*>(feats);
  const auto* rm = static_cast<const int*>(rmeta);
  auto* lab = static_cast<int*>(label);
  auto* nlf = static_cast<int*>(new_leaf);
  const auto* fm = static_cast<const int*>(fmeta);
  const auto* mk = static_cast<const uint8_t*>(mask);
  const auto* cs = static_cast<const float*>(csums);
  const auto* sm = static_cast<const uint8_t*>(sml);
  const auto* pr = static_cast<const float*>(parent);
  const auto* sc = static_cast<const float*>(scale);
  auto* res = static_cast<float*>(residue);
  auto* hs = static_cast<float*>(hsmall);
  auto st = static_cast<cudaStream_t>(stream);
  const auto run = sub ? (packed ? dispatch_precision<true, true>
                                 : dispatch_precision<true, false>)
                       : (packed ? dispatch_precision<false, true>
                                 : dispatch_precision<false, false>);
  return run(precision, bn, g, ol, ft, rm, lab, nlf, w, fm, mk, cs, sm, pr,
             sc, res, hs, n, nf, S, sub ? S : 2 * S, nb, B, ls_max, n_chunks,
             chunk_rows, static_cast<const float*>(qscale), qtile, prm, legs,
             st);
}

// K3.  (N,) leaf ids of `binned`'s rows, from `oleaf`, after the P
// splits of `rmeta` (P, 8) on the features `feats` (P,), round q's splits
// rows offs[q] .. offs[q + 1] (`offs` (R + 1,), rising; null: one round,
// R = 1).  `layout`: 0 (F, N) u8 bins, 1 packed bytes, 2 (F, N) int16
// bins (the 16-bit leg).  `tab`: device scratch of P (kRmetaCols + 3) +
// R + 1 ints, used where the tables pass kRouteSmemBytes.
int lgbm_route_rows(const void* binned, const void* oleaf, const void* feats,
                    const void* rmeta, const void* offs, void* out, void* tab,
                    int n, int P, int R, int layout, void* stream) {
  if (P < 0 || R < 1 || (!offs && R != 1) || !tab || layout < 0 ||
      layout > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const auto* ol = static_cast<const int*>(oleaf);
  const auto* ft = static_cast<const int*>(feats);
  const auto* rm = static_cast<const int*>(rmeta);
  const auto* of = static_cast<const int*>(offs);
  auto* o = static_cast<int*>(out);
  auto* tb = static_cast<int*>(tab);
  auto st = static_cast<cudaStream_t>(stream);
  if (layout == 2)
    return route_launch<false, int16_t>(static_cast<const int16_t*>(binned),
                                        ol, ft, rm, of, o, tb, n, P, R, st);
  const auto* bn = static_cast<const uint8_t*>(binned);
  return layout == 1
             ? route_launch<true, uint8_t>(bn, ol, ft, rm, of, o, tb, n, P, R,
                                           st)
             : route_launch<false, uint8_t>(bn, ol, ft, rm, of, o, tb, n, P,
                                            R, st);
}

}  // extern "C"
