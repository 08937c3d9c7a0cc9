// Training histogram kernel for Hopper (sm_90a), built by ops/_build.py
// with nvcc into a shared library with a plain C interface, loaded by
// ctypes.
//
// K1 hist_leaves — replaces lightgbmv1_tpu/ops/hist_pallas.py _kernel
//    (reached through hist_leaves_pallas): per-slot gradient histograms
//    (L, F, B, 3) = [sum grad, sum hess, count] over the rows of each slot,
//    from (F, N) u8 bins, (N, 3) f32 rows and (N,) i32 slot ids.  Rows
//    whose id is outside [0, L) and bins outside [0, B) contribute nothing.
//
// Precision (the Pallas kernel's semantics): "f32" sums the f32 values;
// "bf16" sums hi = bf16_rn(v); "bf16x2" sums hi and lo = bf16_rn(v - hi)
// separately in f32 and returns sum_hi + sum_lo.  Counts (0/1 row masks)
// are exact in every mode.
//
// What bounds it on this card.  The function reads each bin byte, each
// g3 row and each slot id once and writes the histogram once (about
// 47.5 MB at 1,048,576 rows x 28 features, 64 slots of 64 bins): 14 us at
// 3.35 TB/s.  Its arithmetic is a few f32 adds per (row, feature), far
// below the f32 rate, so the bound is by bytes.  The TPU kernel instead
// multiplies a (3 L, rows) masked-gradient block by a (rows, F B) one-hot
// on the MXU; on Hopper that product would do L times the useful work.
//
// Design: per-block shared-memory sub-histograms, filled in a fixed row
// order and merged in a fixed order, so the result is the same to the bit
// from run to run (no float atomics).
//  * Grid (F, chunks, slot groups): a block owns one feature, one row
//    chunk and a group of slots whose f32 sub-histograms (hi and lo kept
//    apart in bf16x2) fit a 96 KiB shared-memory budget — all 64 slots of
//    64 bins at the headline shape, so two blocks share an SM.
//  * Rows stream through in tiles of 256 (coalesced u8 / f32 / i32
//    loads).  Every histogram cell (slot, bin) has one owner: warp
//    key % 8, lane (key / 8) % 32 with key = slot * B + bin.  A tile's
//    rows are partitioned by owner warp with a stable ballot count, and
//    each warp walks its rows in row order; only the owner lane adds.
//    A cell is therefore updated by one thread, in row order: no atomics,
//    no races, deterministic.  The price: a warp adds one row at a time.
//  * The chunk count is fixed by the shape (a constant SM count, not the
//    card's), so the order of the cross-block sum never changes.  Each
//    block writes its partial sub-histograms; a second kernel sums them
//    in chunk order, hi and lo apart, and adds the two at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // = rows a tile
constexpr int kWarps = kThreads / 32;

enum Precision { kF32 = 0, kBf16 = 1, kBf16x2 = 2 };

__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// NC f32 accumulators a cell: 3 (f32, bf16) or 6 (bf16x2: hi, then lo).
template <int PREC, int NC>
__global__ void __launch_bounds__(kThreads)
hist_partial_kernel(const uint8_t* __restrict__ binned,
                    const float* __restrict__ g3,
                    const int* __restrict__ leaf_id,
                    float* __restrict__ partial, int n, int nf, int nl,
                    int nb, int ls_max, int chunk_rows) {
  extern __shared__ float smem[];
  const int f = blockIdx.x;
  const int chunk = blockIdx.y;
  const int s0 = blockIdx.z * ls_max;
  const int ls = min(ls_max, nl - s0);
  const int cells = ls * nb;

  float* hist = smem;                                   // cells * NC
  float* tval = hist + static_cast<size_t>(ls_max) * nb * NC;  // tile * NC
  int* tkey = reinterpret_cast<int*>(tval + kThreads * NC);     // tile
  uint16_t* lists = reinterpret_cast<uint16_t*>(tkey + kThreads);
  __shared__ int wcnt[kWarps][kWarps];   // [source warp][owner warp]
  __shared__ int woff[kWarps][kWarps];   // [owner warp][source warp]
  __shared__ int wtot[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;

  for (int i = tid; i < cells * NC; i += kThreads) hist[i] = 0.f;

  const int r_begin = chunk * chunk_rows;
  const int r_end = min(n, r_begin + chunk_rows);
  const uint8_t* brow = binned + static_cast<size_t>(f) * n;

  for (int t0 = r_begin; t0 < r_end; t0 += kThreads) {
    // ---- load one tile: each thread one row --------------------------
    const int r = t0 + tid;
    int owner = kWarps;  // kWarps = contributes nothing
    if (r < r_end) {
      const int s = leaf_id[r] - s0;
      const int b = brow[r];
      if (s >= 0 && s < ls && b < nb) {
        const int key = s * nb + b;
        tkey[tid] = key;
        owner = key % kWarps;
        for (int c = 0; c < 3; ++c) {
          const float v = g3[static_cast<size_t>(r) * 3 + c];
          if (PREC == kF32) {
            tval[tid * NC + c] = v;
          } else {
            const float hi = bf16_rn(v);
            tval[tid * NC + c] = hi;
            if (PREC == kBf16x2) tval[tid * NC + 3 + c] = bf16_rn(v - hi);
          }
        }
      }
    }
    // ---- stable partition of the tile's rows by owner warp ------------
    int rank = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const unsigned m = __ballot_sync(0xffffffffu, owner == k);
      if (lane == 0) wcnt[warp][k] = __popc(m);
      if (owner == k) rank = __popc(m & lt_mask);
    }
    __syncthreads();
    if (tid < kWarps) {
      int acc = 0;
      for (int w = 0; w < kWarps; ++w) {
        woff[tid][w] = acc;
        acc += wcnt[w][tid];
      }
      wtot[tid] = acc;
    }
    __syncthreads();
    if (owner < kWarps)
      lists[owner * kThreads + woff[owner][warp] + rank] =
          static_cast<uint16_t>(tid);
    __syncthreads();
    // ---- each warp adds its rows in row order; the owner lane adds ----
    const int cnt = wtot[warp];
    const uint16_t* mine = lists + warp * kThreads;
    for (int i = 0; i < cnt; ++i) {
      const int t = mine[i];
      const int key = tkey[t];
      if (((key / kWarps) & 31) == lane) {
        float* h = hist + static_cast<size_t>(key) * NC;
        const float* v = tval + t * NC;
#pragma unroll
        for (int c = 0; c < NC; ++c) h[c] += v[c];
      }
    }
    __syncthreads();
  }

  // ---- this block's partial: partial[chunk][f][s0 + s][b][NC] ---------
  float* out = partial +
               ((static_cast<size_t>(chunk) * nf + f) * nl + s0) * nb * NC;
  for (int i = tid; i < cells * NC; i += kThreads) out[i] = hist[i];
}

// out[l][f][b][c] = sum over chunks (in chunk order) of the hi partials,
// plus (bf16x2) the same sum of the lo partials.
template <int NC>
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
  const float* p =
      partial + ((static_cast<size_t>(f) * nl + l) * nb + b) * NC + c;
  float hi = 0.f, lo = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch, p += stride) {
    hi += p[0];
    if (NC == 6) lo += p[3];
  }
  out[i] = NC == 6 ? hi + lo : hi;
}

template <int PREC, int NC>
int launch(const uint8_t* binned, const float* g3, const int* leaf_id,
           float* partial, float* out, int n, int nf, int nl, int nb,
           int nb_out, int ls_max, int n_chunks, int chunk_rows,
           cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(ls_max) * nb * NC +
                       static_cast<size_t>(kThreads) * NC) * sizeof(float) +
                      kThreads * sizeof(int) +
                      static_cast<size_t>(kWarps) * kThreads * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      hist_partial_kernel<PREC, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (nl + ls_max - 1) / ls_max;
  dim3 grid(nf, n_chunks, groups);
  hist_partial_kernel<PREC, NC><<<grid, kThreads, smem, stream>>>(
      binned, g3, leaf_id, partial, n, nf, nl, nb, ls_max, chunk_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(nl) * nf * nb_out * 3;
  if (total == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  hist_merge_kernel<NC><<<blocks, 256, 0, stream>>>(partial, out, n_chunks,
                                                    nf, nl, nb, nb_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launches (0 = both launched).  `partial`
// is (n_chunks, nf, nl, nb, 6 or 3) f32 scratch; `out` is (nl, nf, nb_out,
// 3) f32 with nb_out <= nb (the bins past nb_out are dropped).
int lgbm_hist_leaves(const void* binned, const void* g3, const void* leaf_id,
                     void* partial, void* out, int n, int nf, int nl, int nb,
                     int nb_out, int ls_max, int n_chunks, int chunk_rows,
                     int precision, void* stream) {
  const uint8_t* bn = static_cast<const uint8_t*>(binned);
  const float* g = static_cast<const float*>(g3);
  const int* lid = static_cast<const int*>(leaf_id);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (precision) {
    case kF32:
      return launch<kF32, 3>(bn, g, lid, p, o, n, nf, nl, nb, nb_out, ls_max,
                             n_chunks, chunk_rows, st);
    case kBf16:
      return launch<kBf16, 3>(bn, g, lid, p, o, n, nf, nl, nb, nb_out, ls_max,
                              n_chunks, chunk_rows, st);
    case kBf16x2:
      return launch<kBf16x2, 6>(bn, g, lid, p, o, n, nf, nl, nb, nb_out,
                                ls_max, n_chunks, chunk_rows, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
