// Training histogram kernel for Hopper (sm_90a), built by ops/_build.py
// with nvcc into a shared library with a plain C interface, loaded by
// ctypes.
//
// K1 hist_leaves — replaces lightgbmv1_tpu/ops/hist_pallas.py _kernel
//    (reached through hist_leaves_pallas): per-slot gradient histograms
//    (L, F, B, 3) = [sum grad, sum hess, count] over the rows of each slot,
//    from (F, N) u8 bins, (N, 3) f32 rows and (N,) i32 slot ids.  Rows
//    whose id is outside [0, L) and bins outside [0, B) contribute nothing.
//    The packed leg (the Pallas kernel's `packed=True`, bin_layout=packed4)
//    reads (ceil(F/2), N) bytes of two 4-bit bins each, lo nibble = feature
//    2p, hi = 2p + 1, and decodes the nibble at the load (bin_of,
//    hist_tile.cuh); F is the real feature count, so its items, plan and
//    cell order, and with them its bits, are the u8 leg's.
//
// Precision (the Pallas kernel's semantics): "f32" sums the f32 values;
// "bf16" sums hi = bf16_rn(v); "bf16x2" sums hi and lo = bf16_rn(v - hi)
// separately in f32 and returns sum_hi + sum_lo.  Counts (0/1 row masks)
// are exact in every mode.  "int8sr" (the Pallas kernel's
// precision="int8sr", hist_dtype_deep=int8sr) takes rows quantized to
// exact integers in [-127, 127] (csrc/quantize.cu) and returns their
// integer histogram: int32 in shared memory, in the partials and in the
// merge, rounded to f32 once at the output (exact below 2^24, where the
// Pallas kernel's f32 adds of its tiles' int32 products are exact too).
// The rows stay (N, 3) f32, so the leg reads what the others read; its
// integer adds are exact in any order.  "int8" (the Pallas kernel's
// precision="int8", hist_dtype=int8 / hist_dtype_deep=int8) takes the
// rows rounded to nearest under one scale a row tile of `qtile` rows
// (csrc/quantize.cu lgbm_rn_quantize, T the Pallas kernel's own row tile
// for the call) and the tiles' scales: a cell takes 6 shared words, the
// int32 sums of its owner warp's current scale tile and the f32 sums, so
// 64 slots of 64 bins fit one slot group and L = 64 reads each row once,
// as bf16x2 does.  The warp adds its rows as int8sr does and, where its
// rows cross into a later scale tile (a ballot a batch of 32), first
// flushes fma(float(sum), scale, f32 sum) into the cells it touched in
// the closing tile, found in a per-warp mask (hist_tile.cuh), so the
// serial add loop stays integer and one chunk's cell is the Pallas
// kernel's sum over the chunk's tiles; the plan keeps every scale tile in
// one chunk.  It reads the same bytes as the f32 leg, plus 12 bytes a
// tile of scales; its integer adds and one fma a touched cell and tile
// are still far below the card's rates.
//
// What bounds it on this card.  The function reads each bin byte, each
// g3 row and each slot id once and writes the histogram once (about
// 47.5 MB at 1,048,576 rows x 28 features, 64 slots of 64 bins): 14 us at
// 3.35 TB/s; packed, the bins stream halves (F/2 bytes a row).  Its
// arithmetic is a few f32 adds per (row, feature), far below the f32
// rate, so the bound is by bytes.  The TPU kernel instead
// multiplies a (3 L, rows) masked-gradient block by a (rows, F B) one-hot
// on the MXU; on Hopper that product would do L times the useful work.
//
// Design: per-block shared-memory sub-histograms, filled in a fixed row
// order and merged in a fixed order, so the result is the same to the bit
// from run to run (no float atomics).  The partial kernel and the cell
// merge live in hist_tile.cuh, shared with K2 (csrc/wave_fused.cu).
//  * Grid (F, chunks, slot groups): a block owns one feature, one row
//    chunk and a group of slots whose f32 sub-histograms (hi and lo kept
//    apart in bf16x2) fit a 96 KiB shared-memory budget — all 64 slots of
//    64 bins at the headline shape, so two blocks share an SM (the 2 to
//    17 slots of the root and the small rounds fit many more).
//  * Rows stream through in tiles of 256 (coalesced u8 / f32 / i32
//    loads, the next tile's in flight while this one adds).  Every
//    histogram cell (slot, bin) has one owner warp, key % 8 with
//    key = slot * B + bin.  A tile's adding rows are compacted by owner
//    warp with a stable ballot count; each warp takes its rows 32 at a
//    time, groups the lanes of one cell with __match_any_sync, and the
//    group's lowest lane adds its peers' values in lane order (= row
//    order) in registers, one load and one store of the cell a batch.  A
//    cell is therefore updated one add at a time in row order from 0: no
//    atomics, no races, deterministic, and the same bits as one thread
//    walking the rows.  The serial depth is the largest count of one
//    cell's rows in a batch, not a warp's whole row count.
//  * A wave round's dead slot (its rows split nothing) is named by the
//    caller (`nl_add`): its rows are dropped at the load, so they cost
//    one label and one bin read, and its cells come out 0.  The plan
//    stays the one for all nl slots, so the live cells keep their bits.
//  * The chunk count is fixed by the shape (a constant SM count, not the
//    card's), so the order of the cross-block sum never changes.  Each
//    block writes its partial sub-histograms; a second kernel sums them
//    in chunk order, hi and lo apart, and adds the two at the end.

#include "hist_tile.cuh"

using namespace lgbm;

namespace {

// out[l][f][b][c] = sum over chunks (in chunk order) of the hi partials,
// plus (bf16x2) the same sum of the lo partials.
template <int PREC, int NC>
__global__ void hist_merge_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int n_chunks,
                                  int nf, int nl, int nb, int nb_out) {
  const size_t total = static_cast<size_t>(nl) * nf * nb_out * 3;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % 3);
  const int b = static_cast<int>((i / 3) % nb_out);
  const int f = static_cast<int>((i / (3 * static_cast<size_t>(nb_out))) % nf);
  const int l = static_cast<int>(i / (3 * static_cast<size_t>(nb_out) * nf));
  const size_t stride = static_cast<size_t>(nf) * nl * nb * NC;
  out[i] = merge_cell<PREC, NC>(
      partial + ((static_cast<size_t>(f) * nl + l) * nb + b) * NC + c, stride,
      n_chunks);
}

template <int PREC, int NC, bool PACKED>
int launch(const uint8_t* binned, const float* g3, const int* leaf_id,
           float* partial, float* out, int n, int nf, int nl, int nl_add,
           int nb, int nb_out, int ls_max, int n_chunks, int chunk_rows,
           const float* qscale, int qtile, cudaStream_t stream) {
  const int err = launch_hist_partial<PREC, NC, PACKED>(
      binned, g3, leaf_id, partial, n, nf, nl, nl_add, nb, ls_max, n_chunks,
      chunk_rows, qscale, qtile, stream);
  if (err != 0) return err;
  const size_t total = static_cast<size_t>(nl) * nf * nb_out * 3;
  if (total == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  hist_merge_kernel<PREC, NC><<<blocks, 256, 0, stream>>>(partial, out, n_chunks,
                                                    nf, nl, nb, nb_out);
  return static_cast<int>(cudaGetLastError());
}

template <bool PACKED>
int dispatch(int precision, const uint8_t* bn, const float* g,
             const int* lid, float* p, float* o, int n, int nf, int nl,
             int nl_add, int nb, int nb_out, int ls_max, int n_chunks,
             int chunk_rows, const float* qs, int qt, cudaStream_t st) {
#define LGBM_HIST(P, C)                                                   \
  launch<P, C, PACKED>(bn, g, lid, p, o, n, nf, nl, nl_add, nb, nb_out,    \
                       ls_max, n_chunks, chunk_rows, qs, qt, st)
  switch (precision) {
    case kF32:
      return LGBM_HIST(kF32, 3);
    case kBf16:
      return LGBM_HIST(kBf16, 3);
    case kBf16x2:
      return LGBM_HIST(kBf16x2, 6);
    case kInt8sr:
      return LGBM_HIST(kInt8sr, 3);
    case kInt8:
      // a scale tile never splits across chunks, nor a chunk's end
      if (!qs || qt <= 0 || chunk_rows % qt != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      return LGBM_HIST(kInt8, 3);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LGBM_HIST
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launches (0 = both launched).  `partial`
// is (n_chunks, nf, nl, nb, 6 or 3) f32 (int8sr: int32) scratch; `out` is
// (nl, nf, nb_out, 3) f32 with nb_out <= nb (the bins past nb_out are
// dropped).  Rows of slots [nl_add, nl) add nothing (0 <= nl_add <= nl).
// `binned` is (nf, n) bytes, or with `packed` != 0 the (ceil(nf/2), n)
// packed bytes of the nf features (nb must then be 16).  int8: `g3` holds
// the rounded rows and `qscale` the (ceil(n / qtile), 3) scales of their
// qtile-row tiles (chunk_rows a multiple of qtile); null / 0 otherwise.
int lgbm_hist_leaves(const void* binned, const void* g3, const void* leaf_id,
                     void* partial, void* out, int n, int nf, int nl,
                     int nl_add, int nb, int nb_out, int ls_max, int n_chunks,
                     int chunk_rows, int precision, int packed,
                     const void* qscale, int qtile, void* stream) {
  const uint8_t* bn = static_cast<const uint8_t*>(binned);
  const float* g = static_cast<const float*>(g3);
  const int* lid = static_cast<const int*>(leaf_id);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qs = static_cast<const float*>(qscale);
  if (packed) {
    if (nb != 16) return static_cast<int>(cudaErrorInvalidValue);
    return dispatch<true>(precision, bn, g, lid, p, o, n, nf, nl, nl_add, nb,
                          nb_out, ls_max, n_chunks, chunk_rows, qs, qtile,
                          st);
  }
  return dispatch<false>(precision, bn, g, lid, p, o, n, nf, nl, nl_add, nb,
                         nb_out, ls_max, n_chunks, chunk_rows, qs, qtile, st);
}

}  // extern "C"
