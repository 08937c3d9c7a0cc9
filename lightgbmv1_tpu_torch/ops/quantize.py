"""Gradient quantization for the int8 histogram passes.

Two legs.  Round to nearest (``hist_dtype=int8`` / ``hist_dtype_deep=int8``,
the JAX package's ``hist_pallas._kernel`` ``precision="int8"``,
hist_pallas.py:144-154): each row tile of T rows has one scale a channel,
``amax = max |g|`` over the tile's rows, and the rows are rounded half to
even, ``q = round(g * 127 / amax)``; the count channel is scaled by 64
(``_COUNT_SCALE``).  The scale is ``amax / 127`` as the JAX kernel runs
it: XLA compiles a division by the constant 127 as a product with the
float32 reciprocal ``1/127`` (``INV_QMAX``), while ``127 / amax`` stays an
IEEE division.  ``rn_quantize`` (the CUDA kernel ``lgbm_rn_quantize`` of
``csrc/quantize.cu`` on a CUDA tensor, ``rn_quantize_ref`` on a CPU one)
gives the rows q (N, 3), float32 holding exact integers in [-127, 127]
(the count 64 or 0): the histogram kernels read them through the same
(N, 3) float32 loads as every other leg, and K6 reads them in place of
g3.  T is each histogram kernel's own row tile (``hist_cuda.row_tile_for``),
so ``NearestRows`` quantizes a tree's rows once for each T its rounds use.

Stochastic rounding (``hist_dtype_deep=int8sr``), the port of
lightgbmv1_tpu/ops/quantize.py.  A
quantized wave round histograms integer rows: each row's gradient and
hessian are scaled by a power of two and rounded down or up with
probability equal to the fractional part, ``q = clip(floor(z + u), -127,
127)``, which makes every per-bin sum an unbiased estimate of the f32
one; the count channel is rounded to nearest under a power-of-two scale,
so unit counts stay exact.  The uniforms ``u`` are the JAX package's
threefry stream bit for bit (``utils/prng.py``), keyed per tree and
round by the grower, so the quantized rows, and the trees, are the JAX
package's.

* ``sr_prequantize_g3`` (JAX :97): the key-independent half, the scaled
  rows ``zg`` (N, 2), the rounded counts ``qc`` (N,) and the (nslots, 3)
  dequantization scales ``[2^-e_g, 2^-e_h, 1 / inv_c]``, one per-pass
  scale for every slot.  ``prequantize_rows`` packs ``zq = [zg, qc]``
  (N, 3), the quantize kernel's and K6's input;
* ``sr_quantize`` — the draw and rounding: the CUDA kernel
  ``lgbm_sr_quantize`` (``csrc/quantize.cu``, its head note says what
  bounds it) on a CUDA tensor, the plain version ``sr_quantize_ref`` on
  a CPU one;
* ``sr_quantize_g3`` (JAX :56): the two composed, ``(q3, scales)``;
* ``dequantize_hist`` (JAX :144): integer histograms times the scales.

The exponents are exact: ``e = floor(log2(127 / amax))`` from the
frexp exponent of the f32 quotient, and ``2^e`` built from its bits, the
same on the CPU and the card.  The JAX package computes them with
``jnp.log2`` and ``jnp.exp2``, which XLA's CPU backend evaluates as
``log(x) / log(2)`` and ``exp(x log 2)``: there ``exp2`` is not exact for
``|e| >= 13`` (``amax`` below 0.0155 or above 1.04e6) and ``log2`` rounds
up to ``k`` for a quotient a few ulps below ``2^k`` (k >= 3): at those
inputs the JAX package's CPU scales differ from powers of two (or from
the exact exponent), which its own design rests on (JAX :38-42), and the
port keeps the design.  Everywhere else the two agree bit for bit
(tests/test_torch_int8sr.py pins both sides).

The rows stay f32 holding exact integers, as in the JAX package.  Each
kernel launch adds one to ``launch_counts["sr_quantize"]`` (the
round-to-nearest leg's to ``["rn_quantize"]``); each plain call one to
``plain_counts`` under the same name.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ..utils import prng
from . import _build

INT8_QMAX = 127.0
# the float32 reciprocal of 127 (0x1.020408p-7), the JAX kernel's scale
# factor, and the count channel's scale (hist_pallas.py:58)
INV_QMAX = float.fromhex("0x1.020408p-7")
COUNT_SCALE = 64.0

launch_counts = {"sr_quantize": 0, "rn_quantize": 0}
plain_counts = {"sr_quantize": 0, "rn_quantize": 0}
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for d in (launch_counts, plain_counts):
            for k in d:
                d[k] = 0


def floor_log2(y: torch.Tensor) -> torch.Tensor:
    """Exact ``floor(log2(y))`` of positive finite f32 values (int64), from
    the frexp exponent: ``y = m 2^e`` with ``m`` in [0.5, 1)."""
    return torch.frexp(y)[1].to(torch.int64) - 1


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact ``2^e`` as f32 for integer ``e``: the f64 power of two built
    from its exponent bits, rounded to f32 (exact down to 2^-149; 0 below,
    inf above 2^127)."""
    e = e.to(torch.int64).clamp(-1022, 1023)
    return ((e + 1023) << 52).view(torch.float64).to(torch.float32)


def _inv_pow2(amax: torch.Tensor) -> torch.Tensor:
    """``2^floor(log2(127 / amax))`` for ``amax > 0`` (inf where the
    quotient overflows), as the exponent of ``inv`` and its reciprocal.
    The quotient is a tensor division (a scalar over a tensor would be a
    reciprocal and a product, two roundings)."""
    y = torch.full_like(amax, INT8_QMAX) / amax
    e = torch.where(torch.isinf(y), torch.full_like(amax, 2000,
                                                    dtype=torch.int64),
                    floor_log2(y))
    return e


def sr_prequantize_g3(g3: torch.Tensor, nslots: int):
    """The key-independent half of ``sr_quantize_g3`` (JAX :97): ``zg =
    g * inv`` (N, 2) with ``inv = 2^floor(log2(127 / amax))`` per channel
    (0 where ``amax == 0``), the counts ``qc = round(c * inv_c)`` (N,)
    with ``inv_c = min(2^floor(log2(127 / cmax)), 64)`` (1 where ``cmax
    == 0``), rounding half to even, and the (nslots, 3) scales ``[1 /
    inv, 1 / inv_c]`` (0 where ``amax == 0``)."""
    g = g3[:, :2].to(torch.float32)
    amax = g.abs().amax(dim=0) if g.shape[0] else torch.zeros(
        2, dtype=torch.float32, device=g.device)
    e = _inv_pow2(amax)
    pos = amax > 0
    zero = torch.zeros_like(amax)
    inv = torch.where(pos, pow2(e), zero)
    scale = torch.where(pos, pow2(-e), zero)
    zg = g * inv[None, :]
    c = g3[:, 2].to(torch.float32)
    cmax = c.abs().amax() if c.shape[0] else torch.zeros(
        (), dtype=torch.float32, device=c.device)
    inv_c = torch.where(cmax > 0, torch.clamp(pow2(_inv_pow2(cmax)),
                                              max=64.0),
                        torch.ones_like(cmax))
    qc = torch.round(c * inv_c)
    scales = torch.cat([scale, (1.0 / inv_c)[None]])[None, :] \
        .expand(int(nslots), 3).contiguous()
    return zg, qc, scales


def prequantize_rows(g3: torch.Tensor):
    """``zq = [zg, qc]`` (N, 3) f32 contiguous, the quantize kernel's and
    K6's input, and the per-pass scales (3,)."""
    zg, qc, scales = sr_prequantize_g3(g3, 1)
    return torch.cat([zg, qc[:, None]], dim=1).contiguous(), scales[0]


def sr_quantize_ref(zq: torch.Tensor, key) -> torch.Tensor:
    """Plain version of ``sr_quantize``: the (N, 2) draw of
    ``prng.uniform``, ``clip(floor(zg + u), -127, 127)`` and the counts."""
    with _count_lock:
        plain_counts["sr_quantize"] += 1
    u = prng.uniform(key, zq.shape[0], device=zq.device)
    q = torch.clamp(torch.floor(zq[:, :2] + u), -INT8_QMAX, INT8_QMAX)
    return torch.cat([q, zq[:, 2:3]], dim=1).contiguous()


def rn_quantize_ref(g3: torch.Tensor, row_tile: int):
    """Plain version of ``rn_quantize``: the rows rounded to nearest under
    their tile's scale, ``(q (N, 3) f32, scale (ceil(N / T), 3) f32)``."""
    with _count_lock:
        plain_counts["rn_quantize"] += 1
    T, N = int(row_tile), g3.shape[0]
    nt = -(-N // T)
    g = g3.to(torch.float32)
    a = torch.zeros((nt * T, 2), dtype=torch.float32, device=g.device)
    a[:N] = g[:, :2].abs()
    amax = a.view(nt, T, 2).amax(dim=1)                      # (nt, 2)
    pos = amax > 0
    zero = torch.zeros_like(amax)
    inv = torch.where(pos, torch.full_like(amax, INT8_QMAX)
                      / torch.where(pos, amax, torch.ones_like(amax)), zero)
    scale = torch.where(pos, amax * torch.tensor(
        INV_QMAX, dtype=torch.float32, device=g.device), zero)
    q = torch.empty((N, 3), dtype=torch.float32, device=g.device)
    q[:, :2] = torch.round(g[:, :2] * inv.repeat_interleave(T, dim=0)[:N])
    q[:, 2] = torch.round(g[:, 2] * COUNT_SCALE)
    scale3 = torch.cat([scale, torch.full((nt, 1), 1.0 / COUNT_SCALE,
                                          dtype=torch.float32,
                                          device=g.device)], dim=1)
    return q, scale3.contiguous()


_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("quantize")
    lib.lgbm_sr_quantize.argtypes = [_P, _P, _I, _U, _U, _P]
    lib.lgbm_sr_quantize.restype = _I
    lib.lgbm_rn_quantize.argtypes = [_P, _P, _P, _I, _I, _P]
    lib.lgbm_rn_quantize.restype = _I
    return lib


ROW_TILES = (128, 256, 512, 1024)


def rn_quantize(g3: torch.Tensor, row_tile: int):
    """The rows ``g3`` (N, 3) rounded to nearest under one scale a tile of
    ``row_tile`` = T rows (128, 256, 512 or 1024) -> ``(q (N, 3) f32
    exact integers, scale (ceil(N / T), 3) f32)``: the kernel on a CUDA
    tensor, the plain version on a CPU one."""
    if int(row_tile) not in ROW_TILES:
        raise ValueError(f"row_tile={row_tile}: expected one of {ROW_TILES}")
    if g3.device.type == "cpu":
        return rn_quantize_ref(g3, row_tile)
    if g3.device.type != "cuda":
        raise ValueError(f"g3 on {g3.device}: expected cpu or cuda")
    if g3.dtype != torch.float32 or g3.dim() != 2 or g3.shape[1] != 3 \
            or not g3.is_contiguous():
        raise ValueError("g3 must be a contiguous (N, 3) float32 tensor")
    N, T = g3.shape[0], int(row_tile)
    if N >= 2 ** 31:
        raise ValueError("g3 exceeds the kernel's int32 row indexing")
    q = torch.empty_like(g3)
    scale = torch.empty((-(-N // T), 3), dtype=torch.float32,
                        device=g3.device)
    with torch.cuda.device(g3.device), _build.kernel_scope("rn_quantize"):
        stream = torch.cuda.current_stream(g3.device).cuda_stream
        err = _lib().lgbm_rn_quantize(g3.data_ptr(), q.data_ptr(),
                                      scale.data_ptr(), N, T, stream)
    if err != 0:
        raise RuntimeError(f"rn_quantize: CUDA launch failed (cudaError "
                           f"{err})")
    with _count_lock:
        launch_counts["rn_quantize"] += 1
    return q, scale


class NearestRows:
    """A tree's rows ``g3`` rounded to nearest under each row tile T that
    its histograms ask for, each T's ``rn_quantize`` made once (g3 is fixed
    for the whole tree): ``rows(T) -> (q, scale)``."""

    def __init__(self, g3: torch.Tensor):
        self.g3 = g3
        self._by_tile = {}

    def __call__(self, row_tile: int):
        T = int(row_tile)
        if T not in self._by_tile:
            self._by_tile[T] = rn_quantize(self.g3, T)
        return self._by_tile[T]


def sr_quantize(zq: torch.Tensor, key) -> torch.Tensor:
    """The quantized rows q3 (N, 3) f32 of the prequantized rows ``zq``
    (N, 3) under the round key (two uint32 words): the kernel on a CUDA
    tensor, the plain version on a CPU one."""
    if zq.device.type == "cpu":
        return sr_quantize_ref(zq, key)
    if zq.device.type != "cuda":
        raise ValueError(f"zq on {zq.device}: expected cpu or cuda")
    if zq.dtype != torch.float32 or zq.dim() != 2 or zq.shape[1] != 3 \
            or not zq.is_contiguous():
        raise ValueError("zq must be a contiguous (N, 3) float32 tensor")
    N = zq.shape[0]
    if N >= 2 ** 31:
        raise ValueError("zq exceeds the kernel's int32 row indexing")
    q3 = torch.empty_like(zq)
    with torch.cuda.device(zq.device), _build.kernel_scope("sr_quantize"):
        stream = torch.cuda.current_stream(zq.device).cuda_stream
        err = _lib().lgbm_sr_quantize(zq.data_ptr(), q3.data_ptr(), N,
                                      int(key[0]) & prng.MASK32,
                                      int(key[1]) & prng.MASK32, stream)
    if err != 0:
        raise RuntimeError(f"sr_quantize: CUDA launch failed (cudaError "
                           f"{err})")
    with _count_lock:
        launch_counts["sr_quantize"] += 1
    return q3


def sr_quantize_g3(g3: torch.Tensor, label, nslots: int, key):
    """Quantize ``g3`` (N, 3) with stochastic rounding (JAX :56) ->
    ``(q3 (N, 3) f32 exact integers, scales (nslots, 3))``.  ``label`` is
    unused (one per-pass scale), as in the JAX package."""
    del label
    zq, scale3 = prequantize_rows(g3)
    return sr_quantize(zq, key), scale3[None, :].expand(int(nslots), 3) \
        .contiguous()


def dequantize_hist(hist_q: torch.Tensor, scales: torch.Tensor):
    """(S, F, B, 3) integer histograms * (S, 3) per-slot scales."""
    return hist_q * scales[:, None, None, :]
