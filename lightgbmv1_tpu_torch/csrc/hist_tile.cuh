// The histogram device code shared by K1 (csrc/hist.cu) and K2
// (csrc/wave_fused.cu): both .cu files include this header, so K2's
// smaller-child histograms are K1's histograms of the same slot label and
// precision, bit for bit.  ops/_build.py hashes every csrc/*.cuh a source
// includes into the library's name, so an edit here rebuilds both.
//
// hist_partial_kernel: per-block shared-memory sub-histograms of one
// feature, one row chunk and one group of slots.  Every histogram cell
// (slot, bin) has one owner: warp key % 8, lane (key / 8) % 32 with
// key = slot * nb + bin.  A tile's 256 rows are partitioned by owner warp
// with a stable ballot count and each warp walks its rows in row order;
// only the owner lane adds.  A cell is therefore updated by one thread, in
// row order: no atomics, deterministic.  Each block writes its partial
// partial[chunk][f][slot][bin][NC]; merge_cell sums a cell's partials in
// chunk order, hi and lo apart, and adds the two at the end.
//
// Precision (the Pallas kernel's semantics): "f32" sums the f32 values;
// "bf16" sums hi = bf16_rn(v); "bf16x2" sums hi and lo = bf16_rn(v - hi)
// separately (NC = 6 accumulators a cell: hi, then lo).  The kernel only
// adds and subtracts, so floating-point contraction cannot change it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbm {

constexpr int kThreads = 256;  // = rows a tile
constexpr int kWarps = kThreads / 32;

enum Precision { kF32 = 0, kBf16 = 1, kBf16x2 = 2 };

__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Dynamic shared memory of one hist_partial_kernel block.
inline size_t hist_partial_smem(int ls_max, int nb, int nc) {
  return (static_cast<size_t>(ls_max) * nb * nc +
          static_cast<size_t>(kThreads) * nc) * sizeof(float) +
         kThreads * sizeof(int) +
         static_cast<size_t>(kWarps) * kThreads * sizeof(uint16_t);
}

// NC f32 accumulators a cell: 3 (f32, bf16) or 6 (bf16x2: hi, then lo).
// Rows whose slot is outside [0, nl) or whose bin is >= nb add nothing.
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

// One channel of one cell, summed over the chunks in chunk order: the hi
// partials, plus (bf16x2) the same sum of the lo partials.  `p` points at
// the cell's channel in chunk 0; `stride` is one chunk's partial size.
template <int NC>
__device__ __forceinline__ float merge_cell(const float* __restrict__ p,
                                            size_t stride, int n_chunks) {
  float hi = 0.f, lo = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch, p += stride) {
    hi += p[0];
    if (NC == 6) lo += p[3];
  }
  return NC == 6 ? hi + lo : hi;
}

// Sets the partial kernel's shared memory and launches it on the grid
// (nf, n_chunks, slot groups).  Returns the cudaError_t.
template <int PREC, int NC>
int launch_hist_partial(const uint8_t* binned, const float* g3,
                        const int* leaf_id, float* partial, int n, int nf,
                        int nl, int nb, int ls_max, int n_chunks,
                        int chunk_rows, cudaStream_t stream) {
  const size_t smem = hist_partial_smem(ls_max, nb, NC);
  cudaError_t err = cudaFuncSetAttribute(
      hist_partial_kernel<PREC, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (nl + ls_max - 1) / ls_max;
  dim3 grid(nf, n_chunks, groups);
  hist_partial_kernel<PREC, NC><<<grid, kThreads, smem, stream>>>(
      binned, g3, leaf_id, partial, n, nf, nl, nb, ls_max, chunk_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lgbm
