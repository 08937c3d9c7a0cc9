// The quantize kernels for Hopper (sm_90a), built by ops/_build.py with
// nvcc into a shared library with a plain C interface, loaded by ctypes.
//
// lgbm_sr_quantize — the draw and rounding of
//    lightgbmv1_tpu/ops/quantize.py sr_quantize_g3 (XLA in the JAX
//    package, no Pallas kernel): from the prequantized rows zq (N, 3) =
//    [grad * 2^e_g, hess * 2^e_h, round(count * inv_c)]
//    (ops/quantize.prequantize_rows) and the round key, the quantized rows
//    q3 (N, 3) = [clip(floor(zg + u), -127, 127) for the two channels, the
//    count], u = jax.random.uniform(key, (N, 2)) element 2 row + channel.
//    One thread a row (a grid-stride loop): two threefry draws, two
//    rounded adds, floors and clips (csrc/prng.cuh, the device functions
//    K6 inlines for its in-kernel draw, so the two give the same bits).
//    The rows stay f32 holding exact integers, as the JAX package keeps
//    them: K1's, K2's and K6's int8sr legs read the same (N, 3) f32 rows
//    as their other legs.
//
// What bounds it on this card.  It reads 12 bytes a row and writes 12:
// 25.2 MB at 1,048,576 rows, 7.5 us at 3.35 TB/s.  Its integer work is
// two threefry2x32 hashes a row (20 rounds of an add, a funnel-shift
// rotation and an XOR, and the key schedule: about 81 integer operations
// a draw), 170 M operations at 1,048,576 rows, 10.2 us at the card's
// int32 rate (16.7 TOP/s: 64 INT32 lanes an SM, 132 SMs, 1.98 GHz), so
// the bound is the operations'.  The design keeps the draw in registers:
// no uniform is written to device memory, the (N, 2) draw of the JAX
// package exists only as the counters of the rows' threads.

//
// lgbm_rn_quantize — the round-to-nearest quantization inside
//    lightgbmv1_tpu/ops/hist_pallas.py _kernel at precision="int8"
//    (hist_pallas.py:144-154; the same body is K2's and K6's tile of
//    adds): per row tile of T rows, amax = max |g| of each of the two
//    value channels over the tile's rows, inv = 127 / amax (IEEE
//    division), scale = amax * fl(1/127) (XLA compiles the kernel's
//    amax / 127 as a product with the float32 reciprocal), both 0 where
//    amax is 0; q = rint(g * inv) (half to even) and the count channel
//    rint(c * 64) under the scale 1/64.  Out: q (N, 3) f32 holding exact
//    integers in [-127, 127] (counts 64 or 0), which K1's, K2's and K6's
//    int8 legs read through the same f32 loads as their other legs, and
//    the (ceil(N / T), 3) scales.  The TPU kernel recomputes this inside
//    every histogram pass and every feature block; the rows of a tree are
//    fixed, so here it runs once a tree and row tile
//    (ops/quantize.NearestRows).
//    A tile of T rows is 12 T bytes, 3T / 4 float4s (T in ROW_TILES =
//    128 .. 1024, so a tile starts on a 16-byte boundary where g3 does),
//    read once from device memory in 16-byte loads by T / 4 threads,
//    three float4s each at a stride of T / 4 (a warp's loads are 512
//    contiguous bytes) and kept in registers: float4 k of a tile holds
//    floats 4k .. 4k + 3, of channels (k + j) % 3.  The two channel maxima (exact in any order)
//    are taken with warp shuffles and, when a tile spans warps, one step
//    through shared memory; then each thread scales and rounds its twelve
//    values and writes them with 16-byte stores.  A 256-thread block
//    holds 1024 / T tiles, so no thread idles at T = 128.  The last tile
//    masks its rows past N (a float4 that runs past 3N is read and written
//    a float at a time); rows or q off a 16-byte boundary take the same
//    path a float at a time (VEC = false).
//
// What bounds it on this card.  It reads 12 bytes a row and writes 12
// (and 12 bytes a tile of scales): 25.2 MB at 1,048,576 rows, 7.5 us at
// 3.35 TB/s.  Its arithmetic (a max, a multiply and a rounding a value)
// is far below any rate of the card, so the bound is the bytes'.  The
// first design read each tile twice in 4-byte loads a channel, with one
// block a tile (half its threads idle at T = 128); with the L2 cleared
// before each launch it takes 1.3x this one at T = 128 on an H100, and a
// scalar kernel of two tiles a block there 1.25x.

#include <cuda_runtime.h>

#include "prng.cuh"

using namespace lgbm;

namespace {

__global__ void __launch_bounds__(256)
sr_quantize_kernel(const float* __restrict__ zq, float* __restrict__ q3,
                   int n, uint32_t k0, uint32_t k1) {
  const int step = gridDim.x * blockDim.x;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n; r += step) {
    float q[3];
    sr_quantize_row(zq + static_cast<size_t>(r) * 3, r, k0, k1, q);
    float* out = q3 + static_cast<size_t>(r) * 3;
    out[0] = q[0];
    out[1] = q[1];
    out[2] = q[2];
  }
}

// fl(1/127), the JAX kernel's scale factor, and the count channel's scale
constexpr float kInvQmax = 0x1.020408p-7f;
constexpr float kCountScale = 64.f;

constexpr int kRnThreads = 256;

// The twelve values of a thread's three float4s of its tile, float4 k at
// the tile's float4 i + k * tpt; `base` the tile's first float, `nf` = 3N.
// VEC: g3 on a 16-byte boundary, whole float4s read in one load.
template <bool VEC>
__device__ __forceinline__ void rn_load(const float* __restrict__ g3,
                                        size_t base, size_t nf, int i,
                                        int tpt, float (&v)[3][4]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const size_t f = base + 4 * static_cast<size_t>(i + k * tpt);
    if (VEC && f + 4 <= nf) {
      const float4 x = *reinterpret_cast<const float4*>(g3 + f);
      v[k][0] = x.x;
      v[k][1] = x.y;
      v[k][2] = x.z;
      v[k][3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[k][j] = f + j < nf ? g3[f + j] : 0.f;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kRnThreads)
rn_quantize_kernel(const float* __restrict__ g3, float* __restrict__ q3,
                   float* __restrict__ scale, int n, int tile) {
  __shared__ float red[2][kRnThreads / 32];
  const int tpt = tile / 4;                 // threads a tile, 32 .. 256
  const int tid = threadIdx.x;
  const int t = blockIdx.x * (kRnThreads / tpt) + tid / tpt;
  const int i = tid % tpt;
  const size_t nf = 3 * static_cast<size_t>(n);
  const size_t base = 3 * static_cast<size_t>(t) * tile;
  float v[3][4];
  rn_load<VEC>(g3, base, nf, i, tpt, v);
  float m0 = 0.f, m1 = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int c0 = (i + k * tpt) % 3;       // base is a multiple of 3
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = (c0 + j) % 3;
      const float a = fabsf(v[k][j]);
      if (c == 0) m0 = fmaxf(m0, a);
      if (c == 1) m1 = fmaxf(m1, a);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  if (tpt > 32) {                           // the tile spans tpt / 32 warps
    const int w = tid >> 5;
    if ((tid & 31) == 0) {
      red[0][w] = m0;
      red[1][w] = m1;
    }
    __syncthreads();
    const int w0 = (tid / tpt) * (tpt / 32);
    m0 = red[0][w0];
    m1 = red[1][w0];
    for (int u = 1; u < tpt / 32; ++u) {
      m0 = fmaxf(m0, red[0][w0 + u]);
      m1 = fmaxf(m1, red[1][w0 + u]);
    }
  }
  const float inv0 = m0 > 0.f ? __fdiv_rn(127.f, m0) : 0.f;
  const float inv1 = m1 > 0.f ? __fdiv_rn(127.f, m1) : 0.f;
  if (i == 0 && base < nf) {
    float* sc = scale + static_cast<size_t>(t) * 3;
    sc[0] = m0 > 0.f ? __fmul_rn(m0, kInvQmax) : 0.f;
    sc[1] = m1 > 0.f ? __fmul_rn(m1, kInvQmax) : 0.f;
    sc[2] = 1.f / kCountScale;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const size_t f = base + 4 * static_cast<size_t>(i + k * tpt);
    const int c0 = (i + k * tpt) % 3;
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = (c0 + j) % 3;
      o[j] = rintf(__fmul_rn(v[k][j], c == 0 ? inv0 : c == 1 ? inv1
                                                          : kCountScale));
    }
    if (VEC && f + 4 <= nf) {
      *reinterpret_cast<float4*>(q3 + f) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (f + j < nf) q3[f + j] = o[j];
    }
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = launched).  `g3` and `q3` are
// (n, 3) f32 (16-byte loads and stores where both start on a 16-byte
// boundary), `scale` (ceil(n / tile), 3) f32; `tile` is the row tile T, a
// multiple of 128 up to 1024.
int lgbm_rn_quantize(const void* g3, void* q3, void* scale, int n, int tile,
                     void* stream) {
  if (tile < 128 || tile > 4 * kRnThreads || tile % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int tiles = (n + tile - 1) / tile;
  const int per_block = 4 * kRnThreads / tile;
  const bool vec = reinterpret_cast<uintptr_t>(g3) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q3) % 16 == 0;
  const auto kernel =
      vec ? rn_quantize_kernel<true> : rn_quantize_kernel<false>;
  kernel<<<(tiles + per_block - 1) / per_block, kRnThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g3), static_cast<float*>(q3),
      static_cast<float*>(scale), n, tile);
  return static_cast<int>(cudaGetLastError());
}

// Returns the cudaError_t of the launch (0 = launched).  `zq` and `q3` are
// (n, 3) f32; (k0, k1) the round key's two uint32 words.
int lgbm_sr_quantize(const void* zq, void* q3, int n, unsigned k0,
                     unsigned k1, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + 255) / 256 < 8 * 132 ? (n + 255) / 256 : 8 * 132;
  sr_quantize_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(zq), static_cast<float*>(q3), n, k0, k1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
