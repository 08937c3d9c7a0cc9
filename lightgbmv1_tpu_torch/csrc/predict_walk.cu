// Serving walk kernels for Hopper (sm_90a), built by ops/_build.py with
// nvcc into a shared library with a plain C interface, loaded by ctypes.
//
// K4 serving_fused — replaces lightgbmv1_tpu/ops/predict_pallas.py
//    _fused_kernel (reached through serving_fused_pallas): walk every tree
//    of the ensemble over prebinned serving codes and either sum the leaf
//    values per class in tree order (mode "scores", optional sigmoid /
//    softmax epilogue) or write the leaf ids (mode "leaf").
// K5 serving_leaf — replaces lightgbmv1_tpu/ops/predict_pallas.py _kernel
//    (reached through serving_leaf_pallas): (N, F) codes -> (N, T) leaf ids.
//
// What bounds them on this card.  A walk step is a chain of dependent
// gathers from the node tables: the split feature, the row's code for
// that feature, the missing type, then default-left (a missing value) or
// the threshold bin (plus the zero bin for a NaN/zero code), then the
// child: 5 or 6 four-byte loads a step.  Codes in and scores out are
// ~32 B a row, so HBM is idle; the work is those loads over every
// (row, tree) walk, from shared memory (K4) or L1 (K5), which the SM
// serves at 32 words a clock.  The bound is that load count over 132 SMs
// x 32 words x 1.98 GHz (8.36e12 gathers/s); chip_smoke.py counts the
// loads of every walk of its input (walk_loads).
//
// K4 design.  One block per row tile, one thread per row, no atomics:
//  * the block's codes are staged in shared memory once (the feature
//    index depends on the data, and registers cannot be indexed that way);
//  * the block loops over tree tiles: it copies the tile's seven node
//    tables, num_leaves and leaf values into shared memory, syncs, and
//    every thread walks its row through the tile's trees, adding leaf
//    values in tree order into one f32 register (K == 1) or its own
//    column of a shared (K, rows) accumulator (class of tree g is g % K);
//  * the epilogue runs once, after the last tile.
//  The tree tile is priced against a shared-memory budget by
//  ops/predict_cuda.plan_predict_tiles (an L = 255 tree is 8,136 B), and
//  the tree axis is padded to a tile multiple with num_leaves = 0 trees
//  that park on leaf 0 (value 0.0).  Each block re-reads the whole table
//  set from L2 (4 MB for the 500-tree model): the price of per-tile
//  staging, and the first thing a faster version would cut.
//
// K5 design.  The node tables stay in global memory (the 500-tree model's
// 3.5 MB sit in the 50 MB L2, and hot upper levels in L1); a block stages
// the codes of R rows in shared memory and its threads walk the R x T
// (row, tree) pairs with neighbouring threads on neighbouring trees of
// one row, so the (N, T) leaf-id stores are contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;

enum CodeKind { kU8 = 0, kU16 = 1, kI32 = 2, kPacked4 = 3 };
enum Transform { kNone = 0, kSigmoid = 1, kSoftmax = 2 };

template <typename CodeT, bool PACKED>
__device__ __forceinline__ int code_of(const CodeT* row, int f) {
  if (PACKED) {  // two 4-bit codes a byte: lo nibble = even feature
    const int byte = static_cast<int>(row[f >> 1]);
    return ((f & 1) ? (byte >> 4) : byte) & 15;
  }
  return static_cast<int>(row[f]);
}

// One root-to-leaf walk of the tree whose nodes start at index `base` of
// the seven tables; exactly the decision of the Pallas kernels (and of
// models/predict.serving_leaf_binned): NaN and zero ride two reserved
// codes, a missing value goes default_left, any other compares its code
// (NaN/zero taken as the bin of 0.0) with the node's threshold bin.
// A tree of <= 1 leaf parks on leaf 0.  At most n_steps decisions.
template <typename CodeT, bool PACKED>
__device__ __forceinline__ int walk_tree(
    const int* __restrict__ feat, const int* __restrict__ tbin,
    const int* __restrict__ zbin, const int* __restrict__ dl,
    const int* __restrict__ mt, const int* __restrict__ lc,
    const int* __restrict__ rc, int base, int num_leaves,
    const CodeT* row, int n_steps, int zero_code, int nan_code) {
  int node = num_leaves > 1 ? 0 : -1;
  for (int s = 0; s < n_steps && node >= 0; ++s) {
    const int i = base + node;
    const int b = code_of<CodeT, PACKED>(row, feat[i]);
    const bool is_nan = b == nan_code;
    const bool is_zero = b == zero_code;
    const int m = mt[i];
    const bool missing =
        (m == kMissingNan) ? is_nan : (m == kMissingZero && (is_nan || is_zero));
    bool left;
    if (missing) {
      left = dl[i] != 0;
    } else {
      left = ((is_nan || is_zero) ? zbin[i] : b) <= tbin[i];
    }
    node = left ? lc[i] : rc[i];
  }
  return -node - 1;
}

// ---------------------------------------------------------------- K4 ----

__host__ __device__ inline size_t fused_smem_bytes(int rows, int fc,
                                                   int code_bytes,
                                                   int tree_tile, int l1,
                                                   int l, int k,
                                                   bool scores) {
  size_t b = static_cast<size_t>(7 * tree_tile * l1 + tree_tile) * 4;
  if (scores) {
    b += static_cast<size_t>(tree_tile) * l * 4;
    if (k > 1) b += static_cast<size_t>(k) * rows * 4;
  }
  return b + static_cast<size_t>(rows) * fc * code_bytes;
}

template <typename CodeT, bool PACKED>
__global__ void serving_fused_kernel(
    const int* __restrict__ nl, const int* __restrict__ feat,
    const int* __restrict__ tbin, const int* __restrict__ zbin,
    const int* __restrict__ dl, const int* __restrict__ mt,
    const int* __restrict__ lc, const int* __restrict__ rc,
    const float* __restrict__ lv, const CodeT* __restrict__ codes,
    float* __restrict__ scores, int* __restrict__ leaves, int n, int fc,
    int t_pad, int l1, int l, int k, int tree_tile, int n_steps,
    int zero_code, int nan_code, int transform) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = blockDim.x;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * rows;
  const int row = row0 + tid;
  const bool score_mode = leaves == nullptr;
  const int tl = tree_tile * l1;

  int* s_feat = reinterpret_cast<int*>(smem);
  int* s_tbin = s_feat + tl;
  int* s_zbin = s_tbin + tl;
  int* s_dl = s_zbin + tl;
  int* s_mt = s_dl + tl;
  int* s_lc = s_mt + tl;
  int* s_rc = s_lc + tl;
  int* s_nl = s_rc + tl;
  float* s_lv = reinterpret_cast<float*>(s_nl + tree_tile);
  float* s_acc = s_lv + (score_mode ? tree_tile * l : 0);
  CodeT* s_codes = reinterpret_cast<CodeT*>(
      s_acc + ((score_mode && k > 1) ? k * rows : 0));

  const int n_rows = min(rows, n - row0);
  const int64_t code_base = static_cast<int64_t>(row0) * fc;
  for (int i = tid; i < n_rows * fc; i += rows) s_codes[i] = codes[code_base + i];
  if (score_mode && k > 1) {
    for (int c = 0; c < k; ++c) s_acc[c * rows + tid] = 0.f;
  }
  const bool active = tid < n_rows;
  const CodeT* my_codes = s_codes + tid * fc;
  float acc = 0.f;

  for (int t0 = 0; t0 < t_pad; t0 += tree_tile) {
    __syncthreads();  // the previous tile's walks are done with the tables
    const int64_t tb = static_cast<int64_t>(t0) * l1;
    for (int i = tid; i < tl; i += rows) {
      s_feat[i] = feat[tb + i];
      s_tbin[i] = tbin[tb + i];
      s_zbin[i] = zbin[tb + i];
      s_dl[i] = dl[tb + i];
      s_mt[i] = mt[tb + i];
      s_lc[i] = lc[tb + i];
      s_rc[i] = rc[tb + i];
    }
    for (int i = tid; i < tree_tile; i += rows) s_nl[i] = nl[t0 + i];
    if (score_mode) {
      const int64_t vb = static_cast<int64_t>(t0) * l;
      for (int i = tid; i < tree_tile * l; i += rows) s_lv[i] = lv[vb + i];
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < tree_tile; ++j) {
      const int leaf = walk_tree<CodeT, PACKED>(
          s_feat, s_tbin, s_zbin, s_dl, s_mt, s_lc, s_rc, j * l1, s_nl[j],
          my_codes, n_steps, zero_code, nan_code);
      const int g = t0 + j;
      if (!score_mode) {
        leaves[static_cast<int64_t>(row) * t_pad + g] = leaf;
      } else {
        const float v = s_lv[j * l + max(leaf, 0)];
        if (k == 1) {
          acc += v;
        } else {
          s_acc[(g % k) * rows + tid] += v;
        }
      }
    }
  }
  if (!score_mode || !active) return;

  float* out = scores + static_cast<int64_t>(row) * k;
  if (k == 1) {
    if (transform == kSigmoid) {
      acc = 1.f / (1.f + expf(-acc));
    } else if (transform == kSoftmax) {
      acc = 1.f;  // exp(acc - acc) / exp(acc - acc)
    }
    out[0] = acc;
    return;
  }
  if (transform == kSoftmax) {
    float mx = s_acc[tid];
    for (int c = 1; c < k; ++c) mx = fmaxf(mx, s_acc[c * rows + tid]);
    float sum = 0.f;
    for (int c = 0; c < k; ++c) {
      const float e = expf(s_acc[c * rows + tid] - mx);
      s_acc[c * rows + tid] = e;
      sum += e;
    }
    for (int c = 0; c < k; ++c) out[c] = s_acc[c * rows + tid] / sum;
  } else {
    for (int c = 0; c < k; ++c) {
      const float a = s_acc[c * rows + tid];
      out[c] = transform == kSigmoid ? 1.f / (1.f + expf(-a)) : a;
    }
  }
}

template <typename CodeT, bool PACKED>
cudaError_t launch_fused(const int* nl, const int* feat, const int* tbin,
                         const int* zbin, const int* dl, const int* mt,
                         const int* lc, const int* rc, const float* lv,
                         const void* codes, float* scores, int* leaves,
                         int n, int fc, int t_pad, int l1, int l, int k,
                         int tree_tile, int n_steps, int zero_code,
                         int nan_code, int transform, int row_tile,
                         cudaStream_t stream) {
  const size_t smem = fused_smem_bytes(row_tile, fc, sizeof(CodeT), tree_tile,
                                       l1, l, k, leaves == nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      serving_fused_kernel<CodeT, PACKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + row_tile - 1) / row_tile);
  serving_fused_kernel<CodeT, PACKED><<<grid, row_tile, smem, stream>>>(
      nl, feat, tbin, zbin, dl, mt, lc, rc, lv,
      static_cast<const CodeT*>(codes), scores, leaves, n, fc, t_pad, l1, l,
      k, tree_tile, n_steps, zero_code, nan_code, transform);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- K5 ----

template <typename CodeT>
__global__ void serving_leaf_kernel(
    const int* __restrict__ nl, const int* __restrict__ feat,
    const int* __restrict__ tbin, const int* __restrict__ zbin,
    const int* __restrict__ dl, const int* __restrict__ mt,
    const int* __restrict__ lc, const int* __restrict__ rc,
    const CodeT* __restrict__ codes, int* __restrict__ out, int n, int f,
    int t, int l1, int rows_per_block, int n_steps, int zero_code,
    int nan_code) {
  extern __shared__ __align__(16) unsigned char smem[];
  CodeT* s_codes = reinterpret_cast<CodeT*>(smem);
  const int row0 = blockIdx.x * rows_per_block;
  const int n_rows = min(rows_per_block, n - row0);
  const int64_t code_base = static_cast<int64_t>(row0) * f;
  for (int i = threadIdx.x; i < n_rows * f; i += blockDim.x) {
    s_codes[i] = codes[code_base + i];
  }
  __syncthreads();
  int* out_block = out + static_cast<int64_t>(row0) * t;
  const int work = n_rows * t;
  for (int idx = threadIdx.x; idx < work; idx += blockDim.x) {
    const int r = idx / t;
    const int tree = idx - r * t;
    out_block[idx] = walk_tree<CodeT, false>(
        feat, tbin, zbin, dl, mt, lc, rc, tree * l1, nl[tree],
        s_codes + r * f, n_steps, zero_code, nan_code);
  }
}

template <typename CodeT>
cudaError_t launch_leaf(const int* nl, const int* feat, const int* tbin,
                        const int* zbin, const int* dl, const int* mt,
                        const int* lc, const int* rc, const void* codes,
                        int* out, int n, int f, int t, int l1,
                        int rows_per_block, int threads, int n_steps,
                        int zero_code, int nan_code, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(rows_per_block) * f * sizeof(CodeT);
  const dim3 grid((n + rows_per_block - 1) / rows_per_block);
  serving_leaf_kernel<CodeT><<<grid, threads, smem, stream>>>(
      nl, feat, tbin, zbin, dl, mt, lc, rc, static_cast<const CodeT*>(codes),
      out, n, f, t, l1, rows_per_block, n_steps, zero_code, nan_code);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = launched).  `leaves` null
// selects mode "scores" (writes `scores`, (n, k) f32); non-null selects
// mode "leaf" (writes `leaves`, (n, t_pad) i32).
int lgbm_serving_fused(const void* nl, const void* feat, const void* tbin,
                       const void* zbin, const void* dl, const void* mt,
                       const void* lc, const void* rc, const void* lv,
                       const void* codes, int code_kind, void* scores,
                       void* leaves, int n, int fc, int t_pad, int l1, int l,
                       int k, int tree_tile, int n_steps, int zero_code,
                       int nan_code, int transform, int row_tile,
                       void* stream) {
  if (n <= 0) return 0;
  const int* a[8] = {static_cast<const int*>(nl), static_cast<const int*>(feat),
                     static_cast<const int*>(tbin), static_cast<const int*>(zbin),
                     static_cast<const int*>(dl), static_cast<const int*>(mt),
                     static_cast<const int*>(lc), static_cast<const int*>(rc)};
  const float* v = static_cast<const float*>(lv);
  float* s = static_cast<float*>(scores);
  int* o = static_cast<int*>(leaves);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (code_kind) {
    case kU8:
      return launch_fused<uint8_t, false>(a[0], a[1], a[2], a[3], a[4], a[5],
                                          a[6], a[7], v, codes, s, o, n, fc,
                                          t_pad, l1, l, k, tree_tile, n_steps,
                                          zero_code, nan_code, transform,
                                          row_tile, st);
    case kU16:
      return launch_fused<uint16_t, false>(a[0], a[1], a[2], a[3], a[4], a[5],
                                           a[6], a[7], v, codes, s, o, n, fc,
                                           t_pad, l1, l, k, tree_tile, n_steps,
                                           zero_code, nan_code, transform,
                                           row_tile, st);
    case kI32:
      return launch_fused<int32_t, false>(a[0], a[1], a[2], a[3], a[4], a[5],
                                          a[6], a[7], v, codes, s, o, n, fc,
                                          t_pad, l1, l, k, tree_tile, n_steps,
                                          zero_code, nan_code, transform,
                                          row_tile, st);
    case kPacked4:
      return launch_fused<uint8_t, true>(a[0], a[1], a[2], a[3], a[4], a[5],
                                         a[6], a[7], v, codes, s, o, n, fc,
                                         t_pad, l1, l, k, tree_tile, n_steps,
                                         zero_code, nan_code, transform,
                                         row_tile, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int lgbm_serving_leaf(const void* nl, const void* feat, const void* tbin,
                      const void* zbin, const void* dl, const void* mt,
                      const void* lc, const void* rc, const void* codes,
                      int code_kind, void* out, int n, int f, int t, int l1,
                      int rows_per_block, int threads, int n_steps,
                      int zero_code, int nan_code, void* stream) {
  if (n <= 0) return 0;
  const int* a[8] = {static_cast<const int*>(nl), static_cast<const int*>(feat),
                     static_cast<const int*>(tbin), static_cast<const int*>(zbin),
                     static_cast<const int*>(dl), static_cast<const int*>(mt),
                     static_cast<const int*>(lc), static_cast<const int*>(rc)};
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (code_kind) {
    case kU8:
      return launch_leaf<uint8_t>(a[0], a[1], a[2], a[3], a[4], a[5], a[6],
                                  a[7], codes, o, n, f, t, l1, rows_per_block,
                                  threads, n_steps, zero_code, nan_code, st);
    case kU16:
      return launch_leaf<uint16_t>(a[0], a[1], a[2], a[3], a[4], a[5], a[6],
                                   a[7], codes, o, n, f, t, l1, rows_per_block,
                                   threads, n_steps, zero_code, nan_code, st);
    case kI32:
      return launch_leaf<int32_t>(a[0], a[1], a[2], a[3], a[4], a[5], a[6],
                                  a[7], codes, o, n, f, t, l1, rows_per_block,
                                  threads, n_steps, zero_code, nan_code, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
