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
//    1. route: route_row over the rows, new leaf ids in place and the
//       label at S slots;
//    2. histogram partials: hist_partial_item over the (feature, chunk,
//       slot group) items of ops/hist_cuda.plan at the bucket's slot
//       count;
//    3. scan_item over the (slot, feature) items: merge, subtract, scan;
//       in subtraction mode it also commits the pool, pool[leaf] = h_left
//       and pool[new leaf] = h_right, in place (an item owns its parent's
//       (leaf, feature) rows, and new leaves are no parent's);
//    4. pick + commit (block 0, one thread a child): the cross-feature
//       tie-band pick, right sums and default direction as _pick_pack
//       computes them, the packed row, then the children's frontier rows
//       (cgain = -inf past max_depth) and the next round's boundary.
//    The stages are wave_round.cuh's device functions, the ones K2 and K1
//    run (csrc/wave_fused.cu, csrc/hist.cu), on the same work items under
//    the same plan, so every round equals the single round K2 runs at the
//    same bucket, bit for bit, whatever the grid: the grid only decides
//    which block runs an item.  Stages are separated by grid barriers
//    (cooperative_groups::this_grid().sync()); a round whose n is 0 ends
//    the loop in every block (all read the same n after a barrier), and
//    its rows stay the zeros the wrapper wrote.
//
// Numbers.  Stage 4 is written with __fadd_rn / __fsub_rn / __fmul_rn /
// __fdiv_rn, one rounding an op, as the PyTorch ops of _pick_pack and the
// grower's commit each round once: the packed rows equal the pick the
// single round runs on the card, bit for bit.
//
// What bounds it on this card.  A round moves what K2 moves at its bucket
// (about 49 MB at 1,048,576 rows x 28 features and 63 slots of 64 bins,
// 15 us at 3.35 TB/s) plus the frontier and pool commits (the children's
// (F, B, 3) rows); its arithmetic is far below the f32 rate, so the bound
// is by bytes.  The time goes, as in K2, to the histogram partials, R
// times.  The TPU kernel keeps the frontier,
// the pool and the labels in VMEM across its (R, row tiles) grid; no
// Hopper block holds a round's histograms (5.5 MB of pool and 52 MB of
// partials at 64 slots), so the state stays in device memory (50 MB of
// L2) and grid barriers take the place of the TPU grid's order.  The grid
// is one block an SM times the blocks the occupancy query allows at the
// largest stage's shared memory (K1's partials: 107 KiB at 64 slots in
// bf16x2); the boundary and pick run in one block while the others wait.

#include <cooperative_groups.h>

#include "wave_round.cuh"

namespace cg = cooperative_groups;
using namespace lgbm;

namespace {

constexpr int kMaxLadder = 8;
constexpr int kFtCols = 12;
constexpr int kPackCols = 10;
constexpr int kBndHdr = 4;  // n_split, S, bucket, leaf count

// The boundary record of a round in device memory (ints): the header,
// then K slots, K parent depths, 2K x 3 children's sums (f32) and the
// 2K x nf feature mask (bytes).
__host__ __device__ inline int bnd_depth_off(int K) { return kBndHdr + 9 * K; }
__host__ __device__ inline int bnd_csums_off(int K) {
  return kBndHdr + 10 * K;
}
__host__ __device__ inline int bnd_mask_off(int K) { return kBndHdr + 16 * K; }
inline int bnd_ints(int K, int nf) {
  return bnd_mask_off(K) + (2 * K * nf + 3) / 4;
}

struct LoopArgs {
  const uint8_t* binned;     // (nf, n)
  const float* g3;           // (n, 3)
  int* leaf;                 // (n,) leaf ids, routed in place
  float* ft;                 // (L, 12) frontier, committed in place
  float* pool;               // (L, nf, B, 3), or null (pool-free)
  const int* fmeta;          // (5, nf) num_bins, mtype, nan/zero bin, usable
  const uint8_t* base_mask;  // (nf,)
  float* packed;             // (R, 2K, 10), zeroed
  int* n_split;              // (R,), zeroed
  int* label;                // (n,) scratch
  float* partial;            // the largest bucket's partials, scratch
  float* residue;            // (2K, nf, 6) scratch
  int* bnd;                  // bnd_ints(K, nf) scratch
  int n, nf, B, nb, L, K, R, nl0, max_depth, n_buckets;
  int ladder[kMaxLadder], ls_max[kMaxLadder], n_chunks[kMaxLadder],
      chunk_rows[kMaxLadder];
  ScanParams prm;
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
    } else {  // a dead slot: leaf L (no row's), sums 1.0
      slots[s] = Slot{a.L, 0, 0, 0, a.fmeta[nf], a.fmeta[2 * nf],
                      a.fmeta[3 * nf], 0, 0};
      pdepth[s] = 0;
      for (int c = 0; c < 6; ++c) csums[6 * s + c] = 1.f;
    }
  }
  for (int i = tid; i < 2 * S * nf; i += blockDim.x)
    mask[i] = i / nf < 2 * n ? (a.base_mask[i % nf] != 0) : 0;
}

// Stage 4 of round r, by block 0: _pick_pack on the children's residue,
// then the live children's frontier rows.
__device__ void pick_commit(const LoopArgs& a, int r) {
  const int n = a.bnd[0], S = a.bnd[1], nl = a.bnd[3], nf = a.nf;
  const Slot* slots = reinterpret_cast<const Slot*>(a.bnd + kBndHdr);
  const int* pdepth = a.bnd + bnd_depth_off(a.K);
  const float* csums =
      reinterpret_cast<const float*>(a.bnd + bnd_csums_off(a.K));
  float* out = a.packed + static_cast<size_t>(r) * 2 * a.K * kPackCols;
  for (int c = threadIdx.x; c < 2 * S; c += blockDim.x) {
    const float* res = a.residue + static_cast<size_t>(c) * nf * 6;
    const float* cs = csums + 3 * c;
    float gbest = res[0];
    for (int f = 1; f < nf; ++f) gbest = nan_max(gbest, res[f * 6]);
    const float shift = gain_shift(cs[0], cs[1], a.prm);
    const float babs = isfinite(gbest) ? fabsf(gbest) : 0.f;
    const float floor_g =
        __fsub_rn(gbest, __fmul_rn(kTieRtol, __fadd_rn(fabsf(shift), babs)));
    int feature = 0;  // the first feature in the band (0 if none)
    for (int f = 0; f < nf; ++f) {
      if (res[f * 6] >= floor_g) {
        feature = f;
        break;
      }
    }
    const float* rf = res + feature * 6;
    const float best = rf[1];
    const int sc = static_cast<int>(rf[2]);
    const int dir = sc / a.B;
    const int mt = a.fmeta[nf + feature];
    const bool dl = (mt == kMissingNan || mt == kMissingZero) && dir == 1;
    float row[kPackCols] = {isfinite(best) ? best : -INFINITY,
                            static_cast<float>(feature),
                            static_cast<float>(sc % a.B),
                            dl ? 1.f : 0.f,
                            rf[3],
                            rf[4],
                            rf[5],
                            __fsub_rn(cs[0], rf[3]),
                            __fsub_rn(cs[1], rf[4]),
                            __fsub_rn(cs[2], rf[5])};
    for (int k = 0; k < kPackCols; ++k) out[c * kPackCols + k] = row[k];
    if (c < 2 * n) {
      const int s = c >> 1;
      const int cleaf = (c & 1) ? nl + s : slots[s].leaf;
      const int depth = pdepth[s] + 1;
      const bool depth_ok = a.max_depth <= 0 || depth < a.max_depth;
      float* ft = a.ft + static_cast<size_t>(cleaf) * kFtCols;
      ft[0] = depth_ok ? row[0] : -INFINITY;
      for (int k = 1; k < kPackCols; ++k) ft[k] = row[k];
      ft[10] = leaf_output(cs[0], cs[1], a.prm);
      ft[11] = static_cast<float>(depth);
    }
  }
  if (threadIdx.x == 0) a.n_split[r] = n;
}

template <int PREC, int NC, bool SUB>
__global__ void __launch_bounds__(kThreads, 2)
wave_loop_kernel(LoopArgs a) {
  extern __shared__ float kernel_smem[];
  float* smem = kernel_smem;
  cg::grid_group grid = cg::this_grid();
  const int nf = a.nf;
  const Slot* gslots = reinterpret_cast<const Slot*>(a.bnd + kBndHdr);
  const float* csums =
      reinterpret_cast<const float*>(a.bnd + bnd_csums_off(a.K));
  const uint8_t* mask =
      reinterpret_cast<const uint8_t*>(a.bnd + bnd_mask_off(a.K));
  if (blockIdx.x == 0) boundary(a, a.nl0, smem);
  grid.sync();
  for (int r = 0; r < a.R; ++r) {
    const int n = a.bnd[0];
    if (n == 0) break;  // every block read the same n after the barrier
    const int S = a.bnd[1], bi = a.bnd[2], nl = a.bnd[3];
    const int nslots = SUB ? S : 2 * S;
    const int nlh = nslots + 1;  // slot nslots: the rows of no split

    // ---- 1. route: new leaf ids in place, the label ------------------
    Slot* slots = reinterpret_cast<Slot*>(smem);
    for (int s = threadIdx.x; s < S; s += blockDim.x) slots[s] = gslots[s];
    __syncthreads();
    const int step = gridDim.x * blockDim.x;
    for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < a.n;
         row += step)
      route_row<true, SUB>(row, a.binned, a.leaf, slots, a.n, S, nslots,
                           a.leaf, a.label);
    grid.sync();

    // ---- 2. histogram partials under the bucket's plan (slot nslots,
    //      the rows of no split, dropped at the load) -------------------
    const int ls_max = a.ls_max[bi], n_chunks = a.n_chunks[bi];
    const int groups = (nlh + ls_max - 1) / ls_max;
    const int items = nf * n_chunks * groups;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      __syncthreads();
      hist_partial_item<PREC, NC>(w % nf, (w / nf) % n_chunks,
                                  w / (nf * n_chunks), a.binned, a.g3,
                                  a.label, a.partial, a.n, nf, nlh, nslots,
                                  a.nb, ls_max, a.chunk_rows[bi], smem);
    }
    grid.sync();

    // ---- 3. merge + subtract + scan, and the pool commit --------------
    const size_t hrow = static_cast<size_t>(a.B) * 3;
    for (int w = blockIdx.x; w < S * nf; w += gridDim.x) {
      const int s = w / nf, f = w % nf;
      const Slot m = gslots[s];
      float* par = nullptr;
      float* out_r = nullptr;
      if (SUB && s < n) {
        par = a.pool + (static_cast<size_t>(m.leaf) * nf + f) * hrow;
        out_r = a.pool + (static_cast<size_t>(m.nl) * nf + f) * hrow;
      }
      __syncthreads();
      scan_item<NC, SUB>(s, f, blockDim.x, a.partial, n_chunks, nf, nlh, a.nb,
                         a.B, a.fmeta, mask, csums, SUB && m.sml != 0, par,
                         nullptr, par, out_r, a.residue, a.prm, smem);
    }
    grid.sync();

    // ---- 4. pick + frontier commit, the next round's boundary ---------
    if (blockIdx.x == 0) {
      pick_commit(a, r);
      __syncthreads();
      if (r + 1 < a.R) boundary(a, nl + n, smem);
    }
    grid.sync();
  }
}

using LoopKernel = void (*)(LoopArgs);

LoopKernel kernel_for(int precision, int sub) {
  switch (precision * 2 + (sub ? 1 : 0)) {
    case kF32 * 2: return wave_loop_kernel<kF32, 3, false>;
    case kF32 * 2 + 1: return wave_loop_kernel<kF32, 3, true>;
    case kBf16 * 2: return wave_loop_kernel<kBf16, 3, false>;
    case kBf16 * 2 + 1: return wave_loop_kernel<kBf16, 3, true>;
    case kBf16x2 * 2: return wave_loop_kernel<kBf16x2, 6, false>;
    case kBf16x2 * 2 + 1: return wave_loop_kernel<kBf16x2, 6, true>;
    default: return nullptr;
  }
}

// The largest stage's dynamic shared memory: the partials of any bucket,
// the scan, the route's slots or the boundary's gains.
size_t loop_smem(int nc, int nb, int L, int K, int n_buckets,
                 const int* ls_max) {
  size_t m = kScanSmemFloats * sizeof(float);
  for (int b = 0; b < n_buckets; ++b) {
    const size_t h = hist_partial_smem(ls_max[b], nb, nc);
    m = h > m ? h : m;
  }
  const size_t route = static_cast<size_t>(K) * sizeof(Slot);
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

// The launch's limits on the current device (out: shared memory a block,
// resident blocks an SM, SMs, cooperative launch supported); returns the
// cudaError_t of the queries.  `ls_max` holds each ladder bucket's
// partial-stage slot group (ops/hist_cuda.plan).
int lgbm_wave_loop_limits(int precision, int sub, int nb, int L, int K,
                          int n_buckets, const int* ls_max, int* out) {
  const LoopKernel kern = kernel_for(precision, sub);
  if (!kern || n_buckets < 1 || n_buckets > kMaxLadder)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = precision == kBf16x2 ? 6 : 3;
  return limits(kern, loop_smem(nc, nb, L, K, n_buckets, ls_max), out);
}

// K6.  Returns the cudaError_t of the launch (0 = launched).  `tables`
// (host) holds 4 rows of n_buckets ints: the slot ladder and each
// bucket's ls_max, n_chunks and chunk_rows (ops/hist_cuda.plan at its
// nslots + 1 slots).  `leaf`, `ft` and `pool` are updated in place;
// `packed` (R, 2K, 10) and `n_split` (R,) must be zeroed; `label` (N,),
// `partial` (the largest bucket's), `residue` (2K, nf, 6) and `bnd`
// (lgbm_wave_loop_bnd_ints) are scratch.  Pool-free when `sub` is 0.
int lgbm_fused_wave_loop(const void* binned, const void* g3, void* leaf,
                         void* ft, void* pool, const void* fmeta,
                         const void* base_mask, void* packed, void* n_split,
                         void* label, void* partial, void* residue, void* bnd,
                         const void* tables, int n, int nf, int B, int nb,
                         int L, int K, int R, int num_leaves, int max_depth,
                         int n_buckets, int precision, int sub, float l1,
                         float l2, float min_data, float min_hess,
                         float min_gain, void* stream) {
  const LoopKernel kern = kernel_for(precision, sub);
  if (!kern || B > kMaxBins || K < 1 || R < 1 || n_buckets < 1 ||
      n_buckets > kMaxLadder || (sub && !pool))
    return static_cast<int>(cudaErrorInvalidValue);
  LoopArgs a{};
  a.binned = static_cast<const uint8_t*>(binned);
  a.g3 = static_cast<const float*>(g3);
  a.leaf = static_cast<int*>(leaf);
  a.ft = static_cast<float*>(ft);
  a.pool = static_cast<float*>(pool);
  a.fmeta = static_cast<const int*>(fmeta);
  a.base_mask = static_cast<const uint8_t*>(base_mask);
  a.packed = static_cast<float*>(packed);
  a.n_split = static_cast<int*>(n_split);
  a.label = static_cast<int*>(label);
  a.partial = static_cast<float*>(partial);
  a.residue = static_cast<float*>(residue);
  a.bnd = static_cast<int*>(bnd);
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
  const int* t = static_cast<const int*>(tables);
  for (int b = 0; b < n_buckets; ++b) {
    a.ladder[b] = t[b];
    a.ls_max[b] = t[n_buckets + b];
    a.n_chunks[b] = t[2 * n_buckets + b];
    a.chunk_rows[b] = t[3 * n_buckets + b];
    if (a.ladder[b] > K || a.ls_max[b] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  a.prm = ScanParams{l1, l2, min_data, min_hess, min_gain};
  const int nc = precision == kBf16x2 ? 6 : 3;
  const size_t smem = loop_smem(nc, nb, L, K, n_buckets, a.ls_max);
  int lim[4];
  int err = limits(kern, smem, lim);
  if (err != 0) return err;
  if (!lim[3] || lim[1] < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kern), dim3(lim[1] * lim[2]),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
