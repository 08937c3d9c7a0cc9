// The split-scan kernel and the pick kernel for Hopper (sm_90a), built by
// ops/_build.py with nvcc into a shared library with a plain C interface,
// loaded by ctypes.
//
// lgbm_split_scan — replaces the staged split scan of
//    lightgbmv1_tpu/ops/split.py:437 find_best_split (vmapped):
//    scan_left_sums, scan_direction_gains and scan_pick_feature
//    (:459-661), which the JAX package leaves to XLA and runs inside its
//    Pallas kernel K2 as child_scan_residue (ops/wave_fused.py:215), and
//    the cross-feature pick after them (_pick_pack, ops/wave_fused.py:610).
//    In: (C, F, B, 3) f32 child histograms, optionally their (C, 3) int8sr
//    dequantization scales, the children's sums (C, 3) and feature mask
//    (C, F), the (5, F) feature table [num_bins, missing_type, nan_bin,
//    zero_bin, usable] and the options' inputs (ScanLegs, wave_round.cuh;
//    a null `constr` is NO_CONSTRAINT, a null `pout` 0).  Out: the (C, 10)
//    packed rows [gain, feature, threshold, default_left, left g/h/c,
//    right g/h/c] ops/split.py pick_pack writes and, when asked, the
//    (C, F, 6) residue [best gain, gain at the pick, pick, left g/h/c] K2
//    writes.  One block a child, one warp a feature (a warp loops over
//    features when F exceeds the block's warps): the warp stages the
//    feature's (B, 3) row in its own shared memory and runs scan_child,
//    the device function K2's and K6's scan stage runs, writing the
//    feature's residue row to shared memory (past the features a block
//    holds there, lgbm_split_scan_resident's, about 9,000 at 227 KB, to
//    the `residue` output); after one block barrier one thread runs
//    pick_child, K6's pick, on that residue.  So every staged
//    pick on the card is made from K2's bits: each prefix summed in double
//    in bin order and rounded to f32 (PyTorch's CPU cumulative sum), every
//    f32 op one rounding (__fadd_rn and the rest, no contraction into an
//    fma), in one launch with nothing before it.
//
// lgbm_split_pick — replaces _pick_pack (ops/wave_fused.py:610) after K2:
//    the fused round's (2S, F, 6) residue, the children's sums and parent
//    outputs -> the (2S, 10) packed rows, pick_child by one thread a
//    child.
//
// The options are compile-time legs (kOpt* of wave_round.cuh); each
// kernel is instantiated for each of the 16 sets and the launch takes the
// set `opts` names, so an unconstrained scan runs the unconstrained code.
// extra_trees (kOptRand; the JAX package's split.py:602-607, the staged
// scan's random threshold) runs one more instance, kOptAllScan, with every
// leg compiled in and switched by `opts`: each warp draws its (child,
// feature)'s threshold with the JAX package's threefry stream (rand_bin:
// fold_in(tree key, uid + 1_000_003 + extra_seed), the feature's uniform,
// one f32 multiply by max(num_bins - 1, 1), truncated) and only that
// threshold stays a candidate; `rbins`, where given, receives the draws.
// So a node's draw costs two threefry hashes in the kernel, where the
// per-node masks' PyTorch draw costs about ten small launches.
//
// The wide leg (split_scan_wide.cu, which includes this file with
// LGBM_SCAN_WIDE 1): int16 bins (max_bin > 255, up to 32,768 bins) would
// need a warp's (2 kMaxBins x 3 + 5 B) floats for any B, 1.4 MB at B =
// 32,768, past a block's 227 KB.  scan_child_wide walks the feature's row
// in chunks of kMaxBins with the prefix carried in double, twice (the
// first pass finds the feature's best gain, the second its preferred
// candidate in the band), so a warp needs scan_child's scratch at
// kMaxBins whatever B is, and every value is scan_child's.
//
// What bounds them on this card.  A scan reads the histograms once (C x F
// x B x 12 bytes: 2.7 MB at C = 126, F = 28, B = 64) and writes C x 40
// bytes of rows: 0.81 us at 3.35 TB/s; a pick reads C x F x 24 bytes and
// writes C x 40.  Their arithmetic, a few tens of f32 operations a
// candidate (2 C F B candidates), is far below the f32 rate, so the bound
// is by bytes.  The time goes to the sequential prefix sum (three lanes of
// a warp walk the B bins in double), the serial pick (one thread walks the
// F features twice) and the launch; the design keeps the prefix
// sequential because its order is the contract with the staged path's CPU
// twin and with K2, and puts the pick in the scan's launch so the host
// launches one kernel a find_best_split where it launched about fifty.
// A block takes one child's F warps at once where the shared memory
// allows: a warp's scan needs (2 kMaxBins x 3 + 5 B) floats (7.4 KB at B
// = 64, 11.3 KB at B = 256), so the kernel opts into the card's largest
// block (227 KB) and sizes its warps from B: 28 at B <= 64, 20 at B = 256.
// C = 126 children fill 126 of the 132 SMs in one wave.

#include <atomic>

#include "wave_round.cuh"

// 1: the wide leg (csrc/split_scan_wide.cu includes this file so): every
// feature's row walked in chunks of kMaxBins by scan_child_wide, so any B
// runs (int16 bins, max_bin > 255); 0: scan_child at B <= kMaxBins.
#ifndef LGBM_SCAN_WIDE
#define LGBM_SCAN_WIDE 0
#endif

using namespace lgbm;

namespace {

constexpr bool kWide = LGBM_SCAN_WIDE != 0;
constexpr int kMaxScanWarps = 32;
constexpr int kPickThreads = 128;
constexpr int kMaxDevices = 64;
// a warp's shared memory at B bins: the left sums [2][kMaxBins][3]
// (scan_child's layout), the row (B, 3) and the gains [2B]; the wide leg's
// the left sums and one chunk's row [kMaxBins][3]
__host__ __device__ inline int warp_floats(int B) {
  return kWide ? 2 * kMaxBins * 3 + 3 * kMaxBins : 2 * kMaxBins * 3 + 5 * B;
}

template <int OPTS>
__global__ void __launch_bounds__(kMaxScanWarps * 32)
split_scan_kernel(const float* __restrict__ hist,
                  const float* __restrict__ hscale,
                  const float* __restrict__ csums,
                  const uint8_t* __restrict__ mask,
                  const int* __restrict__ fmeta, ScanLegs legs,
                  float* __restrict__ residue, float* __restrict__ packed,
                  int* __restrict__ rbins, int nf, int B, int mstride,
                  bool res_shared, ScanParams prm) {
  // W warps' scratch, then (res_shared) the child's (nf, 6) residue
  extern __shared__ float sm[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x;
  float* base = sm + static_cast<size_t>(warp) * warp_floats(B);
  // the child's residue rows: in shared memory where they fit beside the
  // warps' scratch, else the child's rows of `residue`
  float* res = res_shared ? sm + static_cast<size_t>(W) * warp_floats(B)
                          : residue + static_cast<size_t>(c) * nf * 6;
  // the child's legs, as child 0 of scan_child's view (null stays null)
  const ScanLegs child_legs{legs.constr ? legs.constr + 2 * c : nullptr,
                            legs.pfac ? legs.pfac + c : nullptr,
                            legs.pout ? legs.pout + c : nullptr, legs.mono,
                            legs.contri,
                            legs.uids ? legs.uids + c : nullptr,
                            legs.key0, legs.key1, legs.extra_seed,
                            legs.cegb ? legs.cegb +
                                            static_cast<size_t>(c) * nf
                                      : nullptr};
  auto* left = reinterpret_cast<float(*)[kMaxBins][3]>(base);
  auto* h = reinterpret_cast<float(*)[3]>(base + 2 * kMaxBins * 3);
  float* gains = base + 2 * kMaxBins * 3 + 3 * B;
  const float* cs = csums + 3 * c;
  const float* sc = hscale ? hscale + 3 * c : nullptr;
  for (int f = warp; f < nf; f += W) {
    const float* src = hist + (static_cast<size_t>(c) * nf + f) * B * 3;
    const bool usable = fmeta[4 * nf + f] != 0 &&
                        mask[static_cast<size_t>(c) * mstride + f] != 0;
    if constexpr (kWide) {
      scan_child_wide<OPTS>(src, h, left, lane, 0, f, nf, B, fmeta, usable,
                            sc, cs, prm, child_legs, res);
    } else {
      float* row = base + 2 * kMaxBins * 3;
      for (int i = lane; i < B * 3; i += 32) row[i] = src[i];
      __syncwarp();
      scan_child<OPTS>(h, left, gains, lane, 0, f, nf, B, fmeta, usable, sc,
                       cs, prm, child_legs, res);
    }
    // the extra_trees threshold the scan drew, where the caller asks
    if (rbins && lane == 0 && leg_on<OPTS>(prm, kOptRand))
      rbins[static_cast<size_t>(c) * nf + f] =
          rand_bin(legs.key0, legs.key1, child_legs.uids[0], legs.extra_seed,
                   f, fmeta[f]);
    __syncwarp();  // the warp's scratch is read before its next feature
  }
  __syncthreads();  // every residue row, shared or global, is written
  if (residue && res_shared) {
    float* out = residue + static_cast<size_t>(c) * nf * 6;
    for (int i = threadIdx.x; i < nf * 6; i += blockDim.x) out[i] = res[i];
  }
  if (packed && threadIdx.x == 0) {
    float row[kPackCols];
    pick_child<OPTS>(res, cs, legs.pout ? legs.pout[c] : 0.f, fmeta, nf, B,
                     prm, row);
    for (int k = 0; k < kPackCols; ++k) packed[c * kPackCols + k] = row[k];
  }
}

template <int OPTS>
__global__ void __launch_bounds__(kPickThreads)
split_pick_kernel(const float* __restrict__ residue,
                  const float* __restrict__ csums,
                  const float* __restrict__ pout,
                  const int* __restrict__ fmeta, float* __restrict__ packed,
                  int C, int nf, int B, ScanParams prm) {
  const int c = blockIdx.x * kPickThreads + threadIdx.x;
  if (c >= C) return;
  float row[kPackCols];
  pick_child<OPTS>(residue + static_cast<size_t>(c) * nf * 6, csums + 3 * c,
                   pout ? pout[c] : 0.f, fmeta, nf, B, prm, row);
  for (int k = 0; k < kPackCols; ++k) packed[c * kPackCols + k] = row[k];
}

using ScanKernel = void (*)(const float*, const float*, const float*,
                            const uint8_t*, const int*, ScanLegs, float*,
                            float*, int*, int, int, int, bool, ScanParams);
using PickKernel = void (*)(const float*, const float*, const float*,
                            const int*, float*, int, int, int, ScanParams);

// The scan kernel of option set `opts`: an instance a set of the kOptAll
// legs; a set with kOptRand runs the kOptAllScan instance, its other legs
// switched by prm.opts.
template <int O>
ScanKernel scan_at(int opts) {
  if (opts & kOptRand)
    return opts > kOptAllScan ? nullptr : split_scan_kernel<kOptAllScan>;
  if constexpr (O > kOptAll) {
    return nullptr;
  } else {
    return opts == O ? split_scan_kernel<O> : scan_at<O + 1>(opts);
  }
}

template <int O>
PickKernel pick_at(int opts) {
  if constexpr (O > kOptAll) {
    return nullptr;
  } else {
    return opts == O ? split_pick_kernel<O> : pick_at<O + 1>(opts);
  }
}

// The dynamic shared memory a block of the scan kernel may take: the
// device's largest block less the kernel's static words, opted into once
// a (device, option set); 0 on an error.
int scan_smem_cap(ScanKernel kern, int opts) {
  static std::atomic<int> cap[kMaxDevices][kOptAllScan + 1];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  int v = cap[dev][opts].load(std::memory_order_relaxed);
  if (v > 0) return v;
  cudaFuncAttributes attr;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kern) != cudaSuccess)
    return 0;
  v -= static_cast<int>(attr.sharedSizeBytes);
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           v) != cudaSuccess)
    return 0;
  cap[dev][opts].store(v, std::memory_order_relaxed);
  return v;
}

ScanParams scan_params(float l1, float l2, float min_data, float min_hess,
                       float min_gain, float max_delta_step,
                       float path_smooth, float monotone_penalty, int opts) {
  return ScanParams{l1, l2, min_data, min_hess, min_gain, max_delta_step,
                    path_smooth, monotone_penalty, opts};
}

}  // namespace

extern "C" {

// The most features whose (nf, 6) residue a block of the scan kernel at
// B bins and options `opts` holds in shared memory beside one warp's
// scratch, on the current device; -1 on an error.  Past it the residue
// lives in the `residue` output, which lgbm_split_scan then needs.
int lgbm_split_scan_resident(int B, int opts) {
  const ScanKernel kern = scan_at<0>(opts);
  if (!kern || B < 1 || (!kWide && B > kMaxBins)) return -1;
  const int cap = scan_smem_cap(kern, opts);
  const int left = cap - static_cast<int>(sizeof(float)) * warp_floats(B);
  return cap <= 0 || left < 0 ? -1
                              : left / static_cast<int>(sizeof(float) * 6);
}

// Returns the cudaError_t of the launch (0 = launched).  `hist` (C, nf,
// B, 3) f32, `hscale` (C, 3) f32 or null, `csums` (C, 3) f32, `mask` (C,
// nf) bytes, its rows `mask_stride` bytes apart (nf, or 0: one row for
// every child), `fmeta` (5, nf) i32; `constr` (C, 2) (null: NO_CONSTRAINT),
// `pfac` (C,), `pout` (C,) (null: 0) and `contri` (nf,) f32 and `mono`
// (nf,) i32, each read only when its option is on (`mono` and `pfac`,
// under a monotone penalty, must then be given, and `contri`); under
// kOptRand (extra_trees) `uids` (C,) i32, the tree key (key0, key1) and
// extra_seed; `cegb` (C, nf) f32 (the CEGB leg) or null.  Out: `packed`
// (C, 10) f32 and `residue` (C, nf, 6) f32,
// either null (not both; `residue` must be given past
// lgbm_split_scan_resident's nf), and under kOptRand `rbins` (C, nf) i32,
// each feature's random threshold, where not null.  B <= kMaxBins, or any
// B in the wide leg's library.
int lgbm_split_scan(const void* hist, const void* hscale, const void* csums,
                    const void* mask, const void* fmeta, const void* constr,
                    const void* pfac, const void* pout, const void* mono,
                    const void* contri, void* residue, void* packed, int C,
                    int nf, int B, int mask_stride, float l1, float l2,
                    float min_data, float min_hess, float min_gain,
                    float max_delta_step, float path_smooth,
                    float monotone_penalty, int opts, const void* uids,
                    void* rbins, unsigned key0, unsigned key1, int extra_seed,
                    const void* cegb, void* stream) {
  const ScanKernel kern = scan_at<0>(opts);
  if (!kern || B < 1 || (!kWide && B > kMaxBins) || C < 1 || nf < 1 ||
      (mask_stride != nf && mask_stride != 0) || (!residue && !packed) ||
      ((opts & kOptMc) && (!mono || (monotone_penalty > 0.f && !pfac))) ||
      ((opts & kOptContri) && !contri) || ((opts & kOptRand) && !uids))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cap = scan_smem_cap(kern, opts);
  const size_t warp_bytes = sizeof(float) * warp_floats(B);
  const bool res_shared =
      cap > 0 && sizeof(float) * 6 * static_cast<size_t>(nf) + warp_bytes <=
                     static_cast<size_t>(cap);
  const size_t res_bytes =
      res_shared ? sizeof(float) * 6 * static_cast<size_t>(nf) : 0;
  if (cap <= 0 || (!res_shared && !residue))
    return static_cast<int>(cudaErrorInvalidValue);
  int W = static_cast<int>((cap - res_bytes) / warp_bytes);
  W = W < kMaxScanWarps ? W : kMaxScanWarps;
  W = W < nf ? W : nf;
  const ScanLegs legs{static_cast<const float*>(constr),
                      static_cast<const float*>(pfac),
                      static_cast<const float*>(pout),
                      static_cast<const int*>(mono),
                      static_cast<const float*>(contri),
                      static_cast<const int*>(uids),
                      key0,
                      key1,
                      extra_seed,
                      static_cast<const float*>(cegb)};
  kern<<<C, W * 32, W * warp_bytes + res_bytes,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hist), static_cast<const float*>(hscale),
      static_cast<const float*>(csums), static_cast<const uint8_t*>(mask),
      static_cast<const int*>(fmeta), legs, static_cast<float*>(residue),
      static_cast<float*>(packed), static_cast<int*>(rbins), nf, B,
      mask_stride, res_shared,
      scan_params(l1, l2, min_data, min_hess, min_gain, max_delta_step,
                  path_smooth, monotone_penalty, opts));
  return static_cast<int>(cudaGetLastError());
}

// Returns the cudaError_t of the launch.  `residue` (C, nf, 6) f32,
// `csums` (C, 3) f32, `pout` (C,) f32 or null (0; read under the
// smoothing option), `fmeta` (5, nf) i32; `packed` (C, 10) f32 out.
int lgbm_split_pick(const void* residue, const void* csums, const void* pout,
                    const void* fmeta, void* packed, int C, int nf, int B,
                    float l1, float l2, float min_data, float min_hess,
                    float min_gain, float max_delta_step, float path_smooth,
                    float monotone_penalty, int opts, void* stream) {
  const PickKernel kern = pick_at<0>(opts);
  if (!kern || B < 1 || C < 1 || nf < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  kern<<<(C + kPickThreads - 1) / kPickThreads, kPickThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(residue), static_cast<const float*>(csums),
      static_cast<const float*>(pout), static_cast<const int*>(fmeta),
      static_cast<float*>(packed), C, nf, B,
      scan_params(l1, l2, min_data, min_hess, min_gain, max_delta_step,
                  path_smooth, monotone_penalty, opts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
