// The JAX package's threefry rounding stream on the card, shared by the
// quantize kernel (csrc/quantize.cu) and the persistent wave loop K6
// (csrc/wave_loop.cu), so a round's uniforms are the same bits whichever
// kernel draws them.  utils/prng.py is the same function in PyTorch:
//
//   threefry2x32  the 20-round Random123 function (rotations
//                 [13, 15, 26, 6] / [17, 29, 16, 24], key-schedule
//                 constant 0x1BD11BDA), jax.random's default generator;
//   fold_in       jax.random.fold_in(key, d) = threefry2x32(key, (0, d));
//   uniform_at    element i of jax.random.uniform(key, shape, float32)
//                 under jax_threefry_partitionable: the counter
//                 (i >> 32, i & 0xffffffff), the two output words XORed,
//                 the top 23 bits a mantissa of [1, 2), minus 1;
//   sr_round      ops/quantize.sr_quantize_g3's clip(floor(z + u), -127,
//                 127): one rounded add (never contracted: z is the
//                 prequantized zg = g * 2^e, exact, so an fma could not
//                 change it either), a floor and a clip that lets a NaN
//                 through, as jnp.clip does.
//
// Integer adds, rotations and XORs only, so the bits are the same on any
// device.  ops/_build.py hashes every csrc/*.cuh a source includes into
// the library's name.

#pragma once

#include <math.h>
#include <stdint.h>

namespace lgbm {

constexpr float kQmax = 127.f;  // ops/quantize.py INT8_QMAX

__host__ __device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 of the counter (x0, x1) under the key (k0, k1), in place.
__host__ __device__ __forceinline__ void threefry2x32(uint32_t k0,
                                                      uint32_t k1,
                                                      uint32_t& x0,
                                                      uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// jax.random.fold_in(key, d): the key (k0, k1) becomes the hash of (0, d).
__host__ __device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                                 uint32_t d) {
  uint32_t x0 = 0, x1 = d;
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// Element i of jax.random.uniform(key, shape, float32).
__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1,
                                            uint64_t i) {
  uint32_t x0 = static_cast<uint32_t>(i >> 32);
  uint32_t x1 = static_cast<uint32_t>(i);
  threefry2x32(k0, k1, x0, x1);
  const uint32_t bits = ((x0 ^ x1) >> 9) | 0x3F800000u;
  return __fsub_rn(__uint_as_float(bits), 1.f);
}

// clip(floor(z + u), -127, 127), a NaN passing through.
__device__ __forceinline__ float sr_round(float z, float u) {
  const float q = floorf(__fadd_rn(z, u));
  return q < -kQmax ? -kQmax : (q > kQmax ? kQmax : q);
}

// One row's quantized values from its prequantized row zq = [zg_grad,
// zg_hess, qc] (ops/quantize.prequantize_rows) under the round key
// (k0, k1): the uniforms of counters 2 row and 2 row + 1.
__device__ __forceinline__ void sr_quantize_row(const float* zq, int row,
                                                uint32_t k0, uint32_t k1,
                                                float* q) {
  const uint64_t i = 2 * static_cast<uint64_t>(row);
  q[0] = sr_round(zq[0], uniform_at(k0, k1, i));
  q[1] = sr_round(zq[1], uniform_at(k0, k1, i + 1));
  q[2] = zq[2];
}

}  // namespace lgbm
