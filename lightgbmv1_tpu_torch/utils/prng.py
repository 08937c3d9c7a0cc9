"""The JAX package's threefry rounding stream, reproduced bit for bit.

The JAX package keys its stochastic rounding (ops/quantize.py) with
``jax.random``: ``PRNGKey(seed)``, ``fold_in`` and ``uniform`` over the
default threefry2x32 generator, with ``jax_threefry_partitionable`` on
(the default since JAX 0.5).  This module is that stream without JAX:

* a key is two uint32 words ``(k0, k1)``; ``prng_key(s)`` is ``(0, s &
  0xffffffff)``: the JAX package runs with 64-bit types off, so a seed
  is taken as an int32 (its high word dropped, a negative seed in two's
  complement) before threefry's seed split ``(s >> 32, s & 0xffffffff)``;
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``: the data as a
  uint32 seed ``(d >> 32, d & 0xffffffff)`` = ``(0, d)`` hashed under
  the key;
* ``uniform(key, n_rows)`` is the (n_rows, 2) float32 draw
  ``jax.random.uniform(key, (n_rows, 2))``: element ``i = 2 row +
  channel`` hashes the counter ``(i >> 32, i & 0xffffffff)``, XORs the
  two output words, keeps the top 23 bits as a mantissa of [1, 2) and
  subtracts 1.  ``uniform_1d(key, n)`` is the (n,) draw
  ``jax.random.uniform(key, (n,))``, element i from counter i, and
  ``bernoulli(key, p, n)`` is ``jax.random.bernoulli(key, p, (n,))``,
  ``uniform_1d(key, n) < p`` with ``p`` as a float32 (the bagging masks
  and the per-node feature sampling of the JAX package).

``threefry2x32`` is the 20-round Random123 function (rotations
[13, 15, 26, 6] / [17, 29, 16, 24], key-schedule constant 0x1BD11BDA).
It is written with ``+ & ^ | << >>`` only, so one body runs on Python
ints (the keys) and on int64 tensors (the draw) of any device, every
word held in [0, 2^32) by masking: the CPU and the card give the same
bits.  The card's kernels carry the same function in CUDA C
(``csrc/prng.cuh``).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """threefry2x32 of the counter words ``(x0, x1)`` under the key
    ``(k0, k1)``: uint32 values held in Python ints or int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: ``(0, seed
    mod 2^32)``."""
    return (0, int(seed) & MASK32)


def fold_in(key: tuple, data: int) -> tuple:
    """``jax.random.fold_in(key, data)`` (``data`` as a uint32)."""
    return threefry2x32(int(key[0]), int(key[1]), 0, int(data) & MASK32)


def _uniform_bits(k0, k1, i: torch.Tensor) -> torch.Tensor:
    """float32 uniforms of the counters ``i`` (int64) under the key words
    ``(k0, k1)`` (ints, or int64 tensors broadcast against ``i``)."""
    b0, b1 = threefry2x32(k0, k1, i >> 32, i & MASK32)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform_1d(key: tuple, n: int, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))``: (n,) float32 in [0, 1), element
    i from counter i."""
    i = torch.arange(int(n), dtype=torch.int64, device=device)
    return _uniform_bits(int(key[0]), int(key[1]), i)


def uniform_folded(key: tuple, data: torch.Tensor, n: int,
                   then=None) -> torch.Tensor:
    """(C, n): row c is ``uniform_1d(fold_in(key, data[c]), n)`` for the
    (C,) int64 tensor ``data``, every key and draw in one pass; with
    ``then`` (an int) each key is folded with it once more,
    ``uniform_1d(fold_in(fold_in(key, data[c]), then), n)``."""
    d = data.to(torch.int64) & MASK32
    k0, k1 = threefry2x32(int(key[0]), int(key[1]), torch.zeros_like(d), d)
    if then is not None:
        k0, k1 = threefry2x32(k0, k1, torch.zeros_like(d),
                              torch.full_like(d, int(then) & MASK32))
    i = torch.arange(int(n), dtype=torch.int64, device=data.device)
    return _uniform_bits(k0[:, None], k1[:, None], i[None, :])


def uniform(key: tuple, n_rows: int, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, (n_rows, 2))``: (n_rows, 2) float32 in
    [0, 1), element ``(row, c)`` from counter ``2 row + c``."""
    return uniform_1d(key, 2 * int(n_rows), device).reshape(int(n_rows), 2)


def bernoulli(key: tuple, p: float, n: int, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, (n,))``: (n,) bool, ``uniform_1d <
    p`` with ``p`` rounded to float32 as the JAX package's weak float."""
    return uniform_1d(key, n, device) < torch.tensor(
        float(p), dtype=torch.float32, device=device)
