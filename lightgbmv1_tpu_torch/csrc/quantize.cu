// The stochastic-rounding quantize kernel for Hopper (sm_90a), built by
// ops/_build.py with nvcc into a shared library with a plain C interface,
// loaded by ctypes.
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

}  // namespace

extern "C" {

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
