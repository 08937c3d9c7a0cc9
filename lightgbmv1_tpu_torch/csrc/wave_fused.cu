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
//    feature.  Three launches:
//    (a) route_kernel: one thread a row applies its leaf's split
//        (go_left_rule with the NaN / zero missing rules, op for op as
//        route_tile) and writes the new leaf id and the label: the
//        smaller child's slot in subtraction mode, 2s + right pool-free,
//        nslots for a row of no split.  Integer only, so exact.
//    (b) K1's hist_partial_kernel (hist_tile.cuh) on that label, under
//        the plan K1 takes for nslots + 1 slots (ops/hist_cuda.plan), so
//        hsmall equals K1's histogram of the label bit for bit; the rows
//        of no split (slot nslots, read by nothing) are dropped at the
//        load, as hist_wave drops them in K1.
//    (c) scan_kernel: one block a (slot, feature), one warp a child.  It
//        merges the partials in chunk order (merge_cell, as K1's merge
//        kernel), writes hsmall, subtracts (h_left = sml ? hsm : parent -
//        hsm, h_right = parent - h_left), runs both scan directions' left
//        sums in bin order, the gains with their min-data / min-hessian
//        gates and validity mask, and the per-feature tie-band pick, and
//        writes the residue row.  The cross-feature half of the pick
//        stays outside, as in the JAX package.
// K3 lgbm_route_rows — replaces wave_fused.py _route_only_kernel (reached
//    through fused_route_rows): the valid set routed through one round's
//    splits, launch (a)'s device function without the label.
//
// The three stages are __device__ functions of one work item each
// (route_row and scan_item in wave_round.cuh, hist_partial_item in
// hist_tile.cuh); the kernels here run them one block an item, and the
// persistent wave loop K6 (wave_loop.cu) runs the same functions R rounds
// in one launch.
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
// slots of 64 bins, 15 us at 3.35 TB/s; its arithmetic (3 or 6 f32 adds a
// live row and feature, and the scan's O(2S F B)) is far below the f32
// rate, so the bound is by bytes.  The time goes to (b), K1's partial
// kernel.  The TPU kernel instead runs
// the histogram as a one-hot product on the MXU and the scan on the
// VMEM-resident accumulator; on Hopper the one-hot product would do L
// times the useful work, and a block cannot hold a round's histograms, so
// the partials go through device memory (L2) between (b) and (c).

#include "wave_round.cuh"

using namespace lgbm;

namespace {

constexpr int kRouteThreads = 256;
// the routing grid strides over the rows with at most this many blocks
constexpr int kRouteMaxBlocks = 8 * 132;
constexpr int kScanThreads = 64;  // one warp a child of the block's slot

// route_tile on the rows of the grid (route_row, wave_round.cuh).
template <bool WANT_LABEL, bool SUB>
__global__ void __launch_bounds__(kRouteThreads)
route_kernel(const uint8_t* __restrict__ binned,
             const int* __restrict__ oleaf, const int* __restrict__ feats,
             const int* __restrict__ rmeta, int* __restrict__ new_leaf,
             int* __restrict__ label, int n, int ns, int nslots) {
  extern __shared__ int route_smem[];
  Slot* slots = reinterpret_cast<Slot*>(route_smem);
  load_slots(rmeta, feats, ns, slots);
  __syncthreads();
  const int step = gridDim.x * blockDim.x;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n; r += step)
    route_row<WANT_LABEL, SUB>(r, binned, oleaf, slots, n, ns, nslots,
                               new_leaf, label);
}

template <bool WANT_LABEL, bool SUB>
int launch_route(const uint8_t* binned, const int* oleaf, const int* feats,
                 const int* rmeta, int* new_leaf, int* label, int n, int ns,
                 int nslots, cudaStream_t stream) {
  if (n == 0) return 0;
  const int tiles = (n + kRouteThreads - 1) / kRouteThreads;
  const int blocks = tiles < kRouteMaxBlocks ? tiles : kRouteMaxBlocks;
  const size_t smem = static_cast<size_t>(ns) * sizeof(Slot);
  route_kernel<WANT_LABEL, SUB><<<blocks, kRouteThreads, smem, stream>>>(
      binned, oleaf, feats, rmeta, new_leaf, label, n, ns, nslots);
  return static_cast<int>(cudaGetLastError());
}

// Block (s, f): scan_item (wave_round.cuh) with one warp a child.
template <int NC, bool SUB>
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const float* __restrict__ partial, int n_chunks, int nf, int nl,
            int nb, int B, const int* __restrict__ fmeta,
            const uint8_t* __restrict__ mask, const float* __restrict__ csums,
            const uint8_t* __restrict__ sml, const float* __restrict__ parent,
            float* __restrict__ hsmall, float* __restrict__ residue,
            ScanParams prm) {
  __shared__ float sm[kScanSmemFloats];
  const int s = blockIdx.x;
  const int f = blockIdx.y;
  const size_t o = (static_cast<size_t>(s) * nf + f) * B * 3;
  scan_item<NC, SUB>(s, f, kScanThreads, partial, n_chunks, nf, nl, nb, B,
                     fmeta, mask, csums, SUB && sml[s] != 0,
                     SUB ? parent + o : nullptr, SUB ? hsmall + o : nullptr,
                     nullptr, nullptr, residue, prm, sm);
}

template <int PREC, int NC, bool SUB>
int launch_round(const uint8_t* binned, const float* g3, const int* oleaf,
                 const int* feats, const int* rmeta, int* label,
                 int* new_leaf, float* partial, const int* fmeta,
                 const uint8_t* mask, const float* csums, const uint8_t* sml,
                 const float* parent, float* residue, float* hsmall, int n,
                 int nf, int S, int nslots, int nb, int B, int ls_max,
                 int n_chunks, int chunk_rows, const ScanParams& prm,
                 cudaStream_t stream) {
  int err = launch_route<true, SUB>(binned, oleaf, feats, rmeta, new_leaf,
                                    label, n, S, nslots, stream);
  if (err != 0) return err;
  const int nl = nslots + 1;  // slot nslots: the rows of no split
  // the rows of no split are dropped at the load: nothing reads slot
  // nslots, whose cells come out 0
  err = launch_hist_partial<PREC, NC>(binned, g3, label, partial, n, nf, nl,
                                      nslots, nb, ls_max, n_chunks,
                                      chunk_rows, stream);
  if (err != 0) return err;
  dim3 grid(S, nf);
  scan_kernel<NC, SUB><<<grid, kScanThreads, 0, stream>>>(
      partial, n_chunks, nf, nl, nb, B, fmeta, mask, csums, sml, parent,
      hsmall, residue, prm);
  return static_cast<int>(cudaGetLastError());
}

template <bool SUB>
int dispatch_precision(int precision, const uint8_t* binned, const float* g3,
                       const int* oleaf, const int* feats, const int* rmeta,
                       int* label, int* new_leaf, float* partial,
                       const int* fmeta, const uint8_t* mask,
                       const float* csums, const uint8_t* sml,
                       const float* parent, float* residue, float* hsmall,
                       int n, int nf, int S, int nslots, int nb, int B,
                       int ls_max, int n_chunks, int chunk_rows,
                       const ScanParams& prm, cudaStream_t stream) {
  switch (precision) {
    case kF32:
      return launch_round<kF32, 3, SUB>(
          binned, g3, oleaf, feats, rmeta, label, new_leaf, partial, fmeta,
          mask, csums, sml, parent, residue, hsmall, n, nf, S, nslots, nb, B,
          ls_max, n_chunks, chunk_rows, prm, stream);
    case kBf16:
      return launch_round<kBf16, 3, SUB>(
          binned, g3, oleaf, feats, rmeta, label, new_leaf, partial, fmeta,
          mask, csums, sml, parent, residue, hsmall, n, nf, S, nslots, nb, B,
          ls_max, n_chunks, chunk_rows, prm, stream);
    case kBf16x2:
      return launch_round<kBf16x2, 6, SUB>(
          binned, g3, oleaf, feats, rmeta, label, new_leaf, partial, fmeta,
          mask, csums, sml, parent, residue, hsmall, n, nf, S, nslots, nb, B,
          ls_max, n_chunks, chunk_rows, prm, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// K2.  Returns the cudaError_t of the launches (0 = all launched).
// `oleaf` (N,), `feats` (S,) and `rmeta` (S, 8) are read and `label` /
// `new_leaf` (N,) written.  `partial` is
// (n_chunks, nf, nslots + 1, nb, 6 or 3) f32 scratch; `fmeta` (5, nf) i32
// [num_bins, missing_type, nan_bin, zero_bin, usable]; `mask` (2S, nf)
// and `sml` (S,) bytes; `csums` (2S, 3); `parent` / `hsmall` (S, nf, B,
// 3) in subtraction mode (`sub` != 0, nslots = S; else nslots = 2S);
// `residue` (2S, nf, 6).
int lgbm_fused_round(const void* binned, const void* g3, const void* oleaf,
                     const void* feats, const void* rmeta, void* label,
                     void* new_leaf, void* partial, const void* fmeta,
                     const void* mask, const void* csums, const void* sml,
                     const void* parent, void* residue, void* hsmall, int n,
                     int nf, int S, int nb, int B, int ls_max, int n_chunks,
                     int chunk_rows, int precision, int sub, float l1, float l2, float min_data, float min_hess,
                     float min_gain, void* stream) {
  if (B > kMaxBins || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const ScanParams prm{l1, l2, min_data, min_hess, min_gain};
  const auto* bn = static_cast<const uint8_t*>(binned);
  const auto* g = static_cast<const float*>(g3);
  const auto* ol = static_cast<const int*>(oleaf);
  const auto* ft = static_cast<const int*>(feats);
  const auto* rm = static_cast<const int*>(rmeta);
  auto* lab = static_cast<int*>(label);
  auto* nlf = static_cast<int*>(new_leaf);
  auto* part = static_cast<float*>(partial);
  const auto* fm = static_cast<const int*>(fmeta);
  const auto* mk = static_cast<const uint8_t*>(mask);
  const auto* cs = static_cast<const float*>(csums);
  const auto* sm = static_cast<const uint8_t*>(sml);
  const auto* pr = static_cast<const float*>(parent);
  auto* res = static_cast<float*>(residue);
  auto* hs = static_cast<float*>(hsmall);
  auto st = static_cast<cudaStream_t>(stream);
  if (sub)
    return dispatch_precision<true>(
        precision, bn, g, ol, ft, rm, lab, nlf, part, fm, mk, cs, sm, pr, res,
        hs, n, nf, S, S, nb, B, ls_max, n_chunks, chunk_rows, prm, st);
  return dispatch_precision<false>(
      precision, bn, g, ol, ft, rm, lab, nlf, part, fm, mk, cs, sm, pr, res,
      hs, n, nf, S, 2 * S, nb, B, ls_max, n_chunks, chunk_rows, prm, st);
}

// K3.  (N,) leaf ids of `binned`'s rows after the S splits of `rmeta`.
int lgbm_route_rows(const void* binned, const void* oleaf, const void* feats,
                    const void* rmeta, void* out, int n, int S,
                    void* stream) {
  return launch_route<false, false>(
      static_cast<const uint8_t*>(binned), static_cast<const int*>(oleaf),
      static_cast<const int*>(feats), static_cast<const int*>(rmeta),
      static_cast<int*>(out), nullptr, n, S, 0,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
