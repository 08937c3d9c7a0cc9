// The split-scan kernel for Hopper (sm_90a), built by ops/_build.py with
// nvcc into a shared library with a plain C interface, loaded by ctypes.
//
// lgbm_split_scan — replaces the staged split scan of
//    lightgbmv1_tpu/ops/split.py:459-661 (scan_left_sums,
//    scan_direction_gains, scan_pick_feature), which the JAX package
//    leaves to XLA and runs inside its Pallas kernel K2 as
//    child_scan_residue (ops/wave_fused.py:215).  In: (C, F, B, 3) f32
//    child histograms, optionally their (C, 3) int8sr dequantization
//    scales, the children's sums (C, 3) and feature mask (C, F), the
//    (5, F) feature table [num_bins, missing_type, nan_bin, zero_bin,
//    usable] and the options' inputs (ScanLegs, wave_round.cuh).  Out:
//    the (C, F, 6) residue [best gain, gain at the pick, pick, left
//    g/h/c] K2 writes.  One warp a (child, feature): the
//    warp stages the feature's (B, 3) row in shared memory and runs
//    scan_child, the device function K2's and K6's scan stage runs, so
//    every staged pick on the card is made from K2's bits: each prefix
//    summed in double in bin order and rounded to f32 (PyTorch's CPU
//    cumulative sum), every f32 op one rounding (__fadd_rn and the rest,
//    no contraction into an fma).  Four warps a block, each on its own
//    shared memory, no block barrier.
//
// The options are compile-time legs (kOpt* of wave_round.cuh); the
// kernel is instantiated for each of the 16 sets and the launch takes the
// set `opts` names, so an unconstrained scan runs the unconstrained code.
//
// What bounds it on this card.  A launch reads the histograms once (C x F
// x B x 12 bytes: 2.7 MB at C = 126, F = 28, B = 64) and writes the
// residue (C x F x 24 bytes): 0.83 us at 3.35 TB/s.  Its arithmetic, a
// few tens of f32 operations a candidate (2 C F B candidates), is far
// below the f32 rate, so the bound is by bytes.  The time goes to the
// sequential prefix sum (three lanes of a warp walk the B bins in double)
// and to the launch; the design keeps the prefix sequential because its
// order is the contract with the staged path's CPU twin and with K2.

#include "wave_round.cuh"

using namespace lgbm;

namespace {

constexpr int kScanWarps = 4;
// a warp's shared memory: the row (B, 3), the left sums [2][B][3] and
// the gains [2B], at kMaxBins
constexpr int kWarpSmemFloats = kMaxBins * 3 + 2 * kMaxBins * 3 +
                                2 * kMaxBins;

template <int OPTS>
__global__ void __launch_bounds__(kScanWarps * 32)
split_scan_kernel(const float* __restrict__ hist,
                  const float* __restrict__ hscale,
                  const float* __restrict__ csums,
                  const uint8_t* __restrict__ mask,
                  const int* __restrict__ fmeta, ScanLegs legs,
                  float* __restrict__ residue, int C, int nf, int B,
                  ScanParams prm) {
  __shared__ float sm[kScanWarps][kWarpSmemFloats];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kScanWarps + warp;
  if (item >= C * nf) return;  // the whole warp: no barrier follows
  const int c = item / nf;
  const int f = item % nf;
  float* base = sm[warp];
  const float* src = hist + static_cast<size_t>(item) * B * 3;
  for (int i = lane; i < B * 3; i += 32) base[i] = src[i];
  __syncwarp();
  auto* h = reinterpret_cast<const float(*)[3]>(base);
  auto* left = reinterpret_cast<float(*)[kMaxBins][3]>(base + kMaxBins * 3);
  float* gains = base + 3 * kMaxBins * 3;
  const bool usable = fmeta[4 * nf + f] != 0 && mask[item] != 0;
  scan_child<OPTS>(h, left, gains, lane, c, f, nf, B, fmeta, usable,
                   hscale ? hscale + 3 * c : nullptr, csums + 3 * c, prm,
                   legs, residue);
}

using ScanKernel = void (*)(const float*, const float*, const float*,
                            const uint8_t*, const int*, ScanLegs, float*, int,
                            int, int, ScanParams);

template <int O>
ScanKernel kernel_at(int opts) {
  if constexpr (O > kOptAll) {
    return nullptr;
  } else {
    return opts == O ? split_scan_kernel<O> : kernel_at<O + 1>(opts);
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = launched).  `hist` (C, nf,
// B, 3) f32, `hscale` (C, 3) f32 or null, `csums` (C, 3) f32, `mask` (C,
// nf) bytes, `fmeta` (5, nf) i32; `constr` (C, 2), `pfac` (C,), `pout`
// (C,) and `contri` (nf,) f32 and `mono` (nf,) i32, each null unless its
// option is on (`pfac` null without a monotone penalty); `residue` (C,
// nf, 6) f32 out.
int lgbm_split_scan(const void* hist, const void* hscale, const void* csums,
                    const void* mask, const void* fmeta, const void* constr,
                    const void* pfac, const void* pout, const void* mono,
                    const void* contri, void* residue, int C, int nf, int B,
                    float l1, float l2,
                    float min_data, float min_hess, float min_gain,
                    float max_delta_step, float path_smooth,
                    float monotone_penalty, int opts, void* stream) {
  const ScanKernel kern = kernel_at<0>(opts);
  if (!kern || B < 1 || B > kMaxBins || C < 1 || nf < 1 ||
      ((opts & kOptMc) &&
       (!constr || !mono || (monotone_penalty > 0.f && !pfac))) ||
      ((opts & kOptSmooth) && !pout) ||
      ((opts & kOptContri) && !contri))
    return static_cast<int>(cudaErrorInvalidValue);
  const ScanParams prm{l1, l2, min_data, min_hess, min_gain,
                       max_delta_step, path_smooth, monotone_penalty, opts};
  const ScanLegs legs{static_cast<const float*>(constr),
                      static_cast<const float*>(pfac),
                      static_cast<const float*>(pout),
                      static_cast<const int*>(mono),
                      static_cast<const float*>(contri)};
  const int items = C * nf;
  kern<<<(items + kScanWarps - 1) / kScanWarps, kScanWarps * 32, 0,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hist), static_cast<const float*>(hscale),
      static_cast<const float*>(csums), static_cast<const uint8_t*>(mask),
      static_cast<const int*>(fmeta), legs, static_cast<float*>(residue), C,
      nf, B, prm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
