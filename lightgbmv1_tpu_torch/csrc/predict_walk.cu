// Serving walk kernels for Hopper (sm_90a), built by ops/_build.py with
// nvcc into a shared library with a plain C interface, loaded by ctypes.
//
// K4 serving_fused — replaces lightgbmv1_tpu/ops/predict_pallas.py
//    _fused_kernel (reached through serving_fused_pallas): walk every tree
//    of the ensemble over prebinned serving codes and either sum the leaf
//    values per class (mode "scores", optional sigmoid / softmax epilogue)
//    or write the leaf ids (mode "leaf").
// K5 serving_leaf — replaces lightgbmv1_tpu/ops/predict_pallas.py _kernel
//    (reached through serving_leaf_pallas): (N, F) codes -> (N, T) leaf ids.
//
// What bounds them on this card.  A walk step is a chain of dependent
// shared-memory (K4) or L1 (K5) loads: the node, the row's code for the
// node's split feature, then the child.  Codes in and scores out are
// ~32 B a row, so HBM is idle; the work is the loads of every (row, tree)
// walk, which an SM serves at 32 four-byte words a clock.  chip_smoke.py
// prices the bound with the loads the decision needs (walk_loads: 4
// words a step, 5 or 6 for a NaN or zero code, which also reads the
// missing type and then default_left or the zero bin) over 132 SMs x 32
// words x 1.98 GHz, the same formula for K4 and K5, and reports K4's own
// words a step beside it.
// Below that rate a walk is latency-bound: each step waits for its node,
// then for its code, and a warp steps until its deepest lane is done
// (the lanes that are done idle: the lane efficiency chip_smoke.py
// reports).
//
// K4 design.
//  * The tree axis is cut into G fixed groups of tree_tile consecutive
//    trees (ops/predict_cuda.plan_predict_tiles: from the model and the
//    shared-memory budget, never from the batch).  Grid = groups x row
//    chunks: block (g, c) walks group g for the rows of chunk c, 256 rows
//    a tile, so a server batch of 512 rows is 2 row tiles x 63 groups =
//    126 blocks, where one block used to walk all trees for 256 rows.
//  * Compact node records (ops/predict_cuda.node_records, built once a
//    predictor): 16 B a node, int4 {split feature | missing type << 28 |
//    default_left << 30 | parked << 31, threshold bin, zero bin, left
//    child in the low and right child in the high 16 bits}; bit 31 marks
//    node 0 of a tree of <= 1 leaf, which parks on leaf 0.  A step is one
//    16-byte load and the code load, where the seven tables took 5-6
//    loads; a 255-leaf tree is 5,088 B with its leaf values (8,136 B
//    before), so a group of 8 trees and two code buffers take 55,040 B
//    and four blocks (32 warps) share an SM.
//  * Staging overlaps the walk: the group's records and leaf values
//    (contiguous, tree-major) and the first row tile's codes arrive by
//    cp.async; each next tile's codes are copied while the current tile
//    is walked (two buffers).  A block reads its group once for all the
//    rows of its chunk; the wrapper sizes chunks from N so that a
//    131,072-row chunk reads the tables about 35 times, not 512.
//  * Each thread walks its row through kWalks trees of one class at once,
//    their steps interleaved, so four independent load chains are in
//    flight a thread.
//  * Fixed order, whatever the launch shape: a group's partial of class c
//    is the sum over its trees t with t % K == c, in tree order, from
//    0.f; partials go to a (G, N, K) f32 buffer; the combine kernel adds
//    them in group order from 0.f and runs the epilogue.  So the bits
//    do not depend on N, on the chunking or on the block order, and a
//    server's answer equals Booster.predict bit for bit.
//
// K5 design.  K5 reads the seven int32 node tables as they are, from
// global memory, so it serves every model whose tables the wrapper takes
// (no 16-byte records, no 16-bit children, no shared-memory copy of the
// tables, so no size refusal); it wins by the order of its walks.
//  * A warp walks one tree at a time: the grid is tree groups x row
//    tiles (ops/predict_cuda.plan_leaf_walk: the group size from the
//    model's table bytes, the row tile from the code width and the card's
//    shared memory, never from the batch), one thread a row of the tile.
//    All 32 lanes of a warp are on the same tree at the same step, so a
//    root load is one broadcast and a step at depth d touches at most 2^d
//    nodes of one tree's table row (1,016 B at 255 leaves: 8 lines), not
//    32 lines of 32 trees.  The group's tables (7 x 4 x L1 bytes a tree)
//    are read through the read-only path and stay in L1 for all the
//    tile's rows and for the next tiles of the same group, which the
//    block order (row tile fastest) puts on the same SMs.
//  * A step loads the node's split feature, threshold bin and both
//    children at once (independent loads of one node), then the row's
//    code from shared memory, and picks the child in registers: two
//    dependent round trips a step, not three.  The missing type,
//    default_left and the zero bin are read only for a NaN or zero code
//    (another code is never missing).
//  * One walk a thread: a warp runs each tree until its deepest lane is
//    done, and every walk a thread interleaves widens that wait to the
//    deepest of all of them, so on the headline model one walk a thread
//    ran fastest (k5_ab.py on an H100: 1.49 ms at 131,072 rows against
//    1.67 / 1.99 / 2.00 / 3.6 ms for 2 / 3 / 4 / 8 trees a thread and 2.30
//    / 2.75 ms for 2 / 4 rows a thread; latency is hidden by the 8 warps a
//    block and the blocks an SM instead).
//  * The decision (walk_trees / next_node) is K4's, one device function
//    templated on where a node's fields come from: TableNodes here,
//    RecordNodes (the 16-byte shared records) in K4.
//  * The codes of the tile are staged in shared memory with a row stride
//    of an odd number of words, so the lanes' code loads of one feature
//    fall in 32 different banks at every code width; the leaf ids gather
//    in a (rows x group) tile in shared memory and leave as each row's
//    group of ids, contiguous words, so the (N, T) stores coalesce.
//    A ragged last group (T not a multiple of the group) and a ragged
//    last row tile are masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;
// K4: one thread a row of a row tile (ops/predict_cuda.ROW_TILE) and
// kWalks walks in flight a thread (ops/predict_cuda.WALKS)
constexpr int kRowTile = 256;
constexpr int kWalks = 4;
constexpr int kMaxDevices = 64;
// node record word 0: the split feature in bits 0-27
constexpr int kFeatMask = 0x0FFFFFFF;

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

// ---------------------------------------------------------------- K4 ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the most recent commit group have landed
__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The block's threads copy `bytes` bytes in 16-byte cp.async chunks; both
// addresses are 16-aligned and the last chunk zero-fills past `bytes`.
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int64_t bytes) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  for (int64_t i = threadIdx.x * 16LL; i < bytes; i += kRowTile * 16LL) {
    const int64_t left = bytes - i;
    cp_async16(d + i, s + i, left < 16 ? static_cast<int>(left) : 16);
  }
}

__host__ __device__ inline int codes_buf_bytes(int row_bytes) {
  return (kRowTile * row_bytes + 15) / 16 * 16;
}

// the block's shared memory: the group's records and leaf values, then
// two code buffers (ops/predict_cuda.plan_predict_tiles prices the same)
inline size_t fused_smem_bytes(int tree_tile, int l1, int lp, int row_bytes) {
  return static_cast<size_t>(tree_tile) * l1 * 16 +
         static_cast<size_t>(tree_tile) * lp * 4 +
         2 * static_cast<size_t>(codes_buf_bytes(row_bytes));
}

// Where a walk step reads a node's fields.  Each source gives the node of
// index `node` of the tree whose nodes start at `base`, and that node's
// fields; a field the decision may not need is read only when asked for.
//
// K4: the 16-byte records staged in shared memory (ops/predict_cuda
// node_records); a tree of <= 1 leaf parks through bit 31 of its root's
// word 0 at its first step.
struct RecordNodes {
  const int4* rec;
  int l1;
  struct Node {
    int4 r;
  };
  __device__ __forceinline__ int base(int tree) const { return tree * l1; }
  __device__ __forceinline__ int root(int) const { return 0; }
  __device__ __forceinline__ Node load(int b, int node) const {
    return {rec[b + node]};
  }
  __device__ __forceinline__ int feature(const Node& n) const {
    return n.r.x & kFeatMask;
  }
  __device__ __forceinline__ int threshold(const Node& n) const {
    return n.r.y;
  }
  __device__ __forceinline__ int zero_bin(const Node& n) const {
    return n.r.z;
  }
  __device__ __forceinline__ int missing_type(const Node& n) const {
    return (n.r.x >> 28) & 3;
  }
  __device__ __forceinline__ bool default_left(const Node& n) const {
    return ((n.r.x >> 30) & 1) != 0;
  }
  __device__ __forceinline__ int child(const Node& n, bool left) const {
    const int c = left ? static_cast<int>(static_cast<short>(n.r.w & 0xFFFF))
                       : (n.r.w >> 16);
    return n.r.x < 0 ? -1 : c;
  }
};

// K5: the seven int32 (T, L1) tables and num_leaves in global memory,
// read through the read-only path; a tree of <= 1 leaf parks at its root.
struct TableNodes {
  const int* __restrict__ nl;
  const int* __restrict__ feat;
  const int* __restrict__ tbin;
  const int* __restrict__ zbin;
  const int* __restrict__ dl;
  const int* __restrict__ mt;
  const int* __restrict__ lc;
  const int* __restrict__ rc;
  int l1;
  struct Node {
    int i;
    int feat;
    int tbin;
    int left;
    int right;
  };
  __device__ __forceinline__ int base(int tree) const { return tree * l1; }
  __device__ __forceinline__ int root(int tree) const {
    return __ldg(nl + tree) > 1 ? 0 : -1;
  }
  __device__ __forceinline__ Node load(int b, int node) const {
    const int i = b + node;
    return {i, __ldg(feat + i), __ldg(tbin + i), __ldg(lc + i),
            __ldg(rc + i)};
  }
  __device__ __forceinline__ int feature(const Node& n) const {
    return n.feat;
  }
  __device__ __forceinline__ int threshold(const Node& n) const {
    return n.tbin;
  }
  __device__ __forceinline__ int zero_bin(const Node& n) const {
    return __ldg(zbin + n.i);
  }
  __device__ __forceinline__ int missing_type(const Node& n) const {
    return __ldg(mt + n.i);
  }
  __device__ __forceinline__ bool default_left(const Node& n) const {
    return __ldg(dl + n.i) != 0;
  }
  __device__ __forceinline__ int child(const Node& n, bool left) const {
    return left ? n.left : n.right;
  }
};

// One decision, the Pallas kernels' (and models/predict
// .serving_leaf_binned's): NaN and zero ride two reserved codes; such a
// code goes default_left where the node's missing type takes it as
// missing, else compares as the bin of 0.0 (the zero bin); any other
// code compares with the node's threshold bin.  A code that is neither
// is never missing, so only the reserved codes read the missing type.
template <typename Nodes>
__device__ __forceinline__ int next_node(const Nodes& nodes,
                                         const typename Nodes::Node& nd,
                                         int b, int zero_code, int nan_code) {
  const bool is_nan = b == nan_code;
  bool left;
  if (is_nan || b == zero_code) {
    const int m = nodes.missing_type(nd);
    const bool missing = (m == kMissingNan) ? is_nan : (m == kMissingZero);
    left = missing ? nodes.default_left(nd)
                   : nodes.zero_bin(nd) <= nodes.threshold(nd);
  } else {
    left = b <= nodes.threshold(nd);
  }
  return nodes.child(nd, left);
}

// Walks one row through `count` <= W trees, tree j0 + w * stride for walk
// w, the walks' steps interleaved so that their independent loads overlap
// (K4: W = kWalks; K5: W = 1); at most n_steps decisions a walk.  leaf[w]
// = -node - 1, as the Pallas kernels write it (a walk cut by n_steps
// keeps its internal node).
template <typename Nodes, typename CodeT, bool PACKED, int W = kWalks>
__device__ __forceinline__ void walk_trees(const Nodes& nodes, int j0,
                                           int stride, int count,
                                           const CodeT* row, int n_steps,
                                           int zero_code, int nan_code,
                                           int (&leaf)[W]) {
  int node[W];
  int base[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int tree = j0 + w * stride;
    base[w] = nodes.base(tree);
    node[w] = w < count ? nodes.root(tree) : -1;
  }
  for (int s = 0; s < n_steps; ++s) {
    bool act[W];
    bool any = false;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      act[w] = node[w] >= 0;
      any = any || act[w];
    }
    if (!any) break;
    typename Nodes::Node nd[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (act[w]) nd[w] = nodes.load(base[w], node[w]);
    }
    int b[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (act[w]) b[w] = code_of<CodeT, PACKED>(row, nodes.feature(nd[w]));
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (act[w]) node[w] = next_node(nodes, nd[w], b[w], zero_code, nan_code);
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w) leaf[w] = -node[w] - 1;
}

// Block (g, c): tree group g (trees g * tree_tile ...) over the row tiles
// of row chunk c.  Mode "leaf" writes (n, t_pad) leaf ids; mode "scores"
// writes the group's per-class partials to partial[g][row][class].
template <typename CodeT, bool PACKED, bool LEAF>
__global__ void __launch_bounds__(kRowTile) serving_fused_kernel(
    const int4* __restrict__ rec, const float* __restrict__ lv,
    const unsigned char* __restrict__ codes, float* __restrict__ partial,
    int* __restrict__ leaves, int n, int row_bytes, int t_pad, int l1, int lp,
    int k, int tree_tile, int tiles_per_block, int n_steps, int zero_code,
    int nan_code) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  int4* s_rec = reinterpret_cast<int4*>(smem);
  float* s_lv = reinterpret_cast<float*>(s_rec + tree_tile * l1);
  unsigned char* s_codes =
      reinterpret_cast<unsigned char*>(s_lv + tree_tile * lp);
  const int buf_bytes = codes_buf_bytes(row_bytes);
  const int n_tiles = (n + kRowTile - 1) / kRowTile;
  const int tile0 = blockIdx.y * tiles_per_block;
  const int tile_end = min(tile0 + tiles_per_block, n_tiles);
  const int t_base = g * tree_tile;
  const RecordNodes nodes{s_rec, l1};

  auto stage_codes = [&](int tile, unsigned char* dst) {
    const int rows = min(kRowTile, n - tile * kRowTile);
    copy_async(dst, codes + static_cast<int64_t>(tile) * kRowTile * row_bytes,
               static_cast<int64_t>(rows) * row_bytes);
  };
  copy_async(s_rec, rec + static_cast<int64_t>(t_base) * l1,
             static_cast<int64_t>(tree_tile) * l1 * 16);
  if (!LEAF) {
    copy_async(s_lv, lv + static_cast<int64_t>(t_base) * lp,
               static_cast<int64_t>(tree_tile) * lp * 4);
  }
  stage_codes(tile0, s_codes);
  cp_async_commit();

  for (int t = tile0; t < tile_end; ++t) {
    const int buf = (t - tile0) & 1;
    if (t + 1 < tile_end) stage_codes(t + 1, s_codes + (buf ^ 1) * buf_bytes);
    cp_async_commit();
    cp_async_wait_all_but_last();  // the group and tile t have landed
    __syncthreads();
    const int row = t * kRowTile + tid;
    if (row < n) {
      const CodeT* my = reinterpret_cast<const CodeT*>(
          s_codes + buf * buf_bytes + tid * row_bytes);
      int leaf[kWalks];
      if (LEAF) {
        int* out = leaves + static_cast<int64_t>(row) * t_pad + t_base;
        for (int j = 0; j < tree_tile; j += kWalks) {
          walk_trees<RecordNodes, CodeT, PACKED>(
              nodes, j, 1, min(kWalks, tree_tile - j), my, n_steps,
              zero_code, nan_code, leaf);
#pragma unroll
          for (int w = 0; w < kWalks; ++w) {
            if (j + w < tree_tile) out[j + w] = leaf[w];
          }
        }
      } else {
        float* out = partial + (static_cast<int64_t>(g) * n + row) * k;
        const int c0 = t_base % k;  // the class of the group's first tree
        for (int c = 0; c < k; ++c) {
          const int j0 = c >= c0 ? c - c0 : c - c0 + k;
          float acc = 0.f;
          for (int j = j0; j < tree_tile; j += kWalks * k) {
            const int count = min(kWalks, (tree_tile - j + k - 1) / k);
            walk_trees<RecordNodes, CodeT, PACKED>(nodes, j, k, count, my,
                                                   n_steps, zero_code,
                                                   nan_code, leaf);
#pragma unroll
            for (int w = 0; w < kWalks; ++w) {
              if (w < count) acc += s_lv[(j + w * k) * lp + max(leaf[w], 0)];
            }
          }
          out[c] = acc;
        }
      }
    }
    __syncthreads();  // tile t's buffer is refilled at tile t + 2
  }
}

// The objective epilogue on one row's k finished scores.
__device__ __forceinline__ void epilogue(float* o, int k, int transform) {
  if (k == 1) {
    if (transform == kSigmoid) {
      o[0] = 1.f / (1.f + expf(-o[0]));
    } else if (transform == kSoftmax) {
      o[0] = 1.f;  // exp(acc - acc) / exp(acc - acc)
    }
    return;
  }
  if (transform == kSoftmax) {
    float mx = o[0];
    for (int c = 1; c < k; ++c) mx = fmaxf(mx, o[c]);
    float sum = 0.f;
    for (int c = 0; c < k; ++c) {
      const float e = expf(o[c] - mx);
      o[c] = e;
      sum += e;
    }
    for (int c = 0; c < k; ++c) o[c] = o[c] / sum;
  } else if (transform == kSigmoid) {
    for (int c = 0; c < k; ++c) o[c] = 1.f / (1.f + expf(-o[c]));
  }
}

// One thread a row: the group partials added in group order from 0.f
// (neighbouring rows' loads coalesce), then the epilogue.
__global__ void serving_combine_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int n, int k,
                                       int n_groups, int transform) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float* o = out + static_cast<int64_t>(row) * k;
  for (int c = 0; c < k; ++c) {
    float acc = 0.f;
    for (int g = 0; g < n_groups; ++g) {
      acc += partial[(static_cast<int64_t>(g) * n + row) * k + c];
    }
    o[c] = acc;
  }
  epilogue(o, k, transform);
}

template <typename CodeT, bool PACKED, bool LEAF>
cudaError_t launch_walk(const int4* rec, const float* lv, const void* codes,
                        float* partial, int* leaves, int n, int row_bytes,
                        int t_pad, int l1, int lp, int k, int tree_tile,
                        int tiles_per_block, int n_steps, int zero_code,
                        int nan_code, cudaStream_t stream) {
  const size_t smem = fused_smem_bytes(tree_tile, l1, lp, row_bytes);
  // raise the instance's shared-memory cap once a device, not every call
  static size_t cap[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > cap[device]) {
    err = cudaFuncSetAttribute(serving_fused_kernel<CodeT, PACKED, LEAF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    cap[device] = smem;
  }
  const int n_tiles = (n + kRowTile - 1) / kRowTile;
  const dim3 grid(t_pad / tree_tile,
                  (n_tiles + tiles_per_block - 1) / tiles_per_block);
  serving_fused_kernel<CodeT, PACKED, LEAF><<<grid, kRowTile, smem, stream>>>(
      rec, lv, static_cast<const unsigned char*>(codes), partial, leaves, n,
      row_bytes, t_pad, l1, lp, k, tree_tile, tiles_per_block, n_steps,
      zero_code, nan_code);
  return cudaGetLastError();
}

template <bool LEAF>
cudaError_t launch_walk_kind(int code_kind, const int4* rec, const float* lv,
                             const void* codes, float* partial, int* leaves,
                             int n, int row_bytes, int t_pad, int l1, int lp,
                             int k, int tree_tile, int tiles_per_block,
                             int n_steps, int zero_code, int nan_code,
                             cudaStream_t st) {
  switch (code_kind) {
    case kU8:
      return launch_walk<uint8_t, false, LEAF>(
          rec, lv, codes, partial, leaves, n, row_bytes, t_pad, l1, lp, k,
          tree_tile, tiles_per_block, n_steps, zero_code, nan_code, st);
    case kU16:
      return launch_walk<uint16_t, false, LEAF>(
          rec, lv, codes, partial, leaves, n, row_bytes, t_pad, l1, lp, k,
          tree_tile, tiles_per_block, n_steps, zero_code, nan_code, st);
    case kI32:
      return launch_walk<int32_t, false, LEAF>(
          rec, lv, codes, partial, leaves, n, row_bytes, t_pad, l1, lp, k,
          tree_tile, tiles_per_block, n_steps, zero_code, nan_code, st);
    case kPacked4:
      return launch_walk<uint8_t, true, LEAF>(
          rec, lv, codes, partial, leaves, n, row_bytes, t_pad, l1, lp, k,
          tree_tile, tiles_per_block, n_steps, zero_code, nan_code, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- K5 ----

// K5's block: one thread a row of the row tile, at most kLeafThreads
// (ops/predict_cuda.LEAF_ROWS)
constexpr int kLeafThreads = 256;

// Copies n_rows rows of `units` U's each, src_stride U's apart in `src`,
// to rows dst_stride U's apart in `dst`, with the block's threads, each
// stepping its (row, column) by the block's size (no division a unit).
template <typename U>
__device__ __forceinline__ void copy_rows(U* __restrict__ dst,
                                          int64_t dst_stride,
                                          const U* __restrict__ src,
                                          int src_stride, int n_rows,
                                          int units) {
  const int dr = blockDim.x / units;
  const int dc = blockDim.x - dr * units;
  int r = threadIdx.x / units;
  int c = threadIdx.x - r * units;
  while (r < n_rows) {
    dst[r * dst_stride + c] = src[r * src_stride + c];
    r += dr;
    c += dc;
    if (c >= units) {
      c -= units;
      ++r;
    }
  }
}

// Block b: row tile b % n_tiles of tree group b / n_tiles (the row tile
// fastest, so the blocks that run together share the group's tables in
// L1).  Shared memory: the tile's codes (`rows` rows, stride_bytes
// apart), then its (rows, group + 1) int32 leaf ids.
template <typename CodeT>
__global__ void __launch_bounds__(kLeafThreads) serving_leaf_kernel(
    TableNodes nodes, const unsigned char* __restrict__ codes,
    int* __restrict__ out, int n, int row_bytes, int t, int group, int rows,
    int stride_bytes, int n_tiles, int n_steps, int zero_code,
    int nan_code) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = static_cast<int>(blockIdx.x % n_tiles);
  const int g = static_cast<int>(blockIdx.x / n_tiles);
  const int row0 = tile * rows;
  const int n_rows = min(rows, n - row0);
  const int t0 = g * group;
  const int g_count = min(group, t - t0);
  const int lstride = group + 1;  // odd for even groups: no bank conflict
  int* s_leaf = reinterpret_cast<int*>(smem + rows * stride_bytes);

  const unsigned char* src = codes + static_cast<int64_t>(row0) * row_bytes;
  if (row_bytes == 0) {
    // no codes: every tree parks at its root
  } else if ((row_bytes & 3) == 0 &&
             (reinterpret_cast<uintptr_t>(src) & 3) == 0) {
    copy_rows(reinterpret_cast<uint32_t*>(smem), stride_bytes >> 2,
              reinterpret_cast<const uint32_t*>(src), row_bytes >> 2, n_rows,
              row_bytes >> 2);
  } else {
    const int size = static_cast<int>(sizeof(CodeT));
    copy_rows(reinterpret_cast<CodeT*>(smem), stride_bytes / size,
              reinterpret_cast<const CodeT*>(src), row_bytes / size, n_rows,
              row_bytes / size);
  }
  __syncthreads();

  // one thread a row, through each tree of the group in turn
  const int r = threadIdx.x;
  if (r < n_rows) {
    const CodeT* my = reinterpret_cast<const CodeT*>(smem + r * stride_bytes);
    int leaf[1];
    for (int j = 0; j < g_count; ++j) {
      walk_trees<TableNodes, CodeT, false, 1>(nodes, t0 + j, 1, 1, my,
                                              n_steps, zero_code, nan_code,
                                              leaf);
      s_leaf[r * lstride + j] = leaf[0];
    }
  }
  __syncthreads();

  // each row's g_count ids are contiguous words of the output
  copy_rows(out + static_cast<int64_t>(row0) * t + t0, t, s_leaf, lstride,
            n_rows, g_count);
}

template <typename CodeT>
cudaError_t launch_leaf(const TableNodes& nodes, const void* codes, int* out,
                        int n, int row_bytes, int t, int group, int rows,
                        int threads, int stride_bytes, int n_steps,
                        int zero_code, int nan_code, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(rows) * stride_bytes +
                      static_cast<size_t>(rows) * (group + 1) * 4;
  // raise the instance's shared-memory cap once a device, not every call
  static size_t cap[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > cap[device]) {
    err = cudaFuncSetAttribute(serving_leaf_kernel<CodeT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    cap[device] = smem;
  }
  const int n_tiles = (n + rows - 1) / rows;
  const int64_t blocks =
      static_cast<int64_t>(n_tiles) * ((t + group - 1) / group);
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidConfiguration;
  serving_leaf_kernel<CodeT><<<static_cast<unsigned>(blocks), threads, smem,
                               stream>>>(
      nodes, static_cast<const unsigned char*>(codes), out, n, row_bytes, t,
      group, rows, stride_bytes, n_tiles, n_steps, zero_code, nan_code);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launches (0 = launched).  `leaves` null
// selects mode "scores": the walk writes the (n_groups, n, k) f32
// `partial` buffer and the combine writes `scores`, (n, k) f32; non-null
// selects mode "leaf" (writes `leaves`, (n, t_pad) i32).  All pointers
// are 16-byte aligned.
int lgbm_serving_fused(const void* rec, const void* lv, const void* codes,
                       int code_kind, void* partial, void* scores,
                       void* leaves, int n, int row_bytes, int t_pad, int l1,
                       int lp, int k, int tree_tile, int tiles_per_block,
                       int n_steps, int zero_code, int nan_code,
                       int transform, void* stream) {
  if (n <= 0) return 0;
  if (tree_tile <= 0 || t_pad % tree_tile || tiles_per_block <= 0 || k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int4* r = static_cast<const int4*>(rec);
  const float* v = static_cast<const float*>(lv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (leaves != nullptr) {
    return launch_walk_kind<true>(code_kind, r, v, codes, nullptr,
                                  static_cast<int*>(leaves), n, row_bytes,
                                  t_pad, l1, lp, k, tree_tile,
                                  tiles_per_block, n_steps, zero_code,
                                  nan_code, st);
  }
  float* p = static_cast<float*>(partial);
  cudaError_t err = launch_walk_kind<false>(
      code_kind, r, v, codes, p, nullptr, n, row_bytes, t_pad, l1, lp, k,
      tree_tile, tiles_per_block, n_steps, zero_code, nan_code, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  serving_combine_kernel<<<(n + threads - 1) / threads, threads, 0, st>>>(
      p, static_cast<float*>(scores), n, k, t_pad / tree_tile, transform);
  return static_cast<int>(cudaGetLastError());
}

// Returns the cudaError_t of the launch (0 = launched).  The launch plan
// (group, rows, threads, stride_bytes) is ops/predict_cuda.plan_leaf_walk:
// threads >= rows, threads <= kLeafThreads, stride_bytes >= row_bytes and
// a multiple of 4.
int lgbm_serving_leaf(const void* nl, const void* feat, const void* tbin,
                      const void* zbin, const void* dl, const void* mt,
                      const void* lc, const void* rc, const void* codes,
                      int code_kind, void* out, int n, int row_bytes, int t,
                      int l1, int group, int rows, int threads,
                      int stride_bytes, int n_steps, int zero_code,
                      int nan_code, void* stream) {
  if (n <= 0 || t <= 0) return 0;
  if (group <= 0 || rows <= 0 || threads < rows || threads > kLeafThreads ||
      stride_bytes < row_bytes || (stride_bytes & 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TableNodes nodes{
      static_cast<const int*>(nl),   static_cast<const int*>(feat),
      static_cast<const int*>(tbin), static_cast<const int*>(zbin),
      static_cast<const int*>(dl),   static_cast<const int*>(mt),
      static_cast<const int*>(lc),   static_cast<const int*>(rc),
      l1};
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (code_kind) {
    case kU8:
      return launch_leaf<uint8_t>(nodes, codes, o, n, row_bytes, t, group,
                                  rows, threads, stride_bytes, n_steps,
                                  zero_code, nan_code, st);
    case kU16:
      return launch_leaf<uint16_t>(nodes, codes, o, n, row_bytes, t, group,
                                   rows, threads, stride_bytes, n_steps,
                                   zero_code, nan_code, st);
    case kI32:
      return launch_leaf<int32_t>(nodes, codes, o, n, row_bytes, t, group,
                                  rows, threads, stride_bytes, n_steps,
                                  zero_code, nan_code, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
