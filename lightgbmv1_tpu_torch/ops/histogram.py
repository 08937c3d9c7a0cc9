"""Histogram construction: method dispatch and the scatter oracle.

Port of lightgbmv1_tpu/ops/histogram.py for the wave grower's passes:

* ``hist_leaves_scatter`` (:53) — the exact f32 oracle, one
  ``index_add_`` over the flattened (feature, slot, bin) index;
* ``hist_one_leaf`` (:153) — the sequential grower's histogram of one
  leaf's rows: K1 with L = 1 over the rows masked to the leaf (on a
  compacted segment's gathered rows, every row is the leaf's);
* ``hist_frontier`` (:272) — all slots' histograms in one pass, through
  the method the trainer resolved: ``pallas`` is the hand-written CUDA
  kernel K1 (``ops/hist_cuda.hist_leaves``, whose plain version a CPU
  tensor takes), ``scatter`` the oracle above;
* ``hist_wave`` (:312) — the wave round's ``nslots`` histograms: rows
  labelled ``nslots`` are dead; the histogram runs at ``nslots + 1``
  slots (the plan, so the bits, of the JAX package's sacrificial slot)
  with only the first ``nslots`` live, so K1 drops the dead rows at the
  load, and the dead slot is sliced away;
* ``hist_wave_quant`` (:334) — the quantized wave round
  (``hist_dtype_deep=int8sr``): the tree's prequantized rows
  (``ops/quantize.prequantize_rows``, made once a tree) stochastically
  rounded to integers (``ops/quantize.sr_quantize``, the quantize kernel
  on the card) and their integer histogram, K1's ``int8sr`` leg on
  ``pallas``, the exact f32 scatter of the integers on ``scatter`` (the
  same values while a cell stays below 2^24); the dequantization scales
  are the tree's, which the grower keeps (the JAX function returns them
  with the histogram);
* ``hist_leaves_onehot`` / ``_matmul_hist`` (:77-150) — the JAX
  package's one-hot product, ``hist_method=onehot``: a chunk of 16,384
  rows at a time, the (3 Lp, C) leaf-masked rows times the (C, F B)
  one-hot of every feature's bin, accumulated in f32 over the chunks.  In
  the JAX package this is XLA's matrix product outside any Pallas kernel,
  so here it is ``torch.matmul``, not a hand-written kernel (and not
  counted as one: ``matmul_counts["hist_leaves_onehot"]`` counts its
  calls).  The precisions are JAX's: f32, bf16 (the rows rounded to
  bf16) and bf16x2 (rounded to bf16 plus the bf16 rounding of the
  remainder, two products added).  A one-hot and a bf16-rounded row are
  exact in f32, so every leg multiplies in f32 and sums in f32, as the
  MXU's ``preferred_element_type=f32`` does: the sums are JAX's up to
  their order.  The f32 leg multiplies at full f32, never TF32
  (``float32_matmul_precision`` "highest" inside the call, whatever the
  caller set); on the card the bf16 legs take TF32 tensor-core products
  ("high"), which are exact on bf16 values and a one-hot (TF32 keeps ten
  mantissa bits, bf16 seven) and accumulate in f32, so they compute the
  same sums as the full-f32 product;
* ``default_hist_method`` (:380) — ``auto`` is ``pallas`` (K1) for a CUDA
  tensor, as on the TPU, ``onehot`` for int16 bins (``max_bin > 255``,
  past K1's byte bins), and ``scatter`` for a CPU one, as on the JAX
  package's CPU backend; ``fused`` resolves to its base method ``pallas``
  (``onehot`` on int16 bins), the one its root pass runs (the wave
  rounds' fused dispatch is in parallel/trainer.py);
* ``benchmark_hist_methods`` (:420-520) — ``hist_method=bench`` (and
  ``auto`` on the card past 256 features): the candidates
  (``bench_candidates``: K1 and onehot on byte bins, onehot alone on
  int16, K1 alone on packed bins, a forced method added) timed on a
  subset of the rows, with CUDA events on the card, and the fastest
  picked.  Unlike the JAX package, a candidate that fails raises: a
  caught failure would hide a kernel.

``precision="int8"`` (``hist_dtype=int8`` / ``hist_dtype_deep=int8``)
runs K1's int8 leg on ``pallas``: the rows rounded to nearest under one
scale a row tile (ops/quantize.rn_quantize); ``rows8``, a tree's
``quantize.NearestRows``, holds them for each row tile the tree's passes
use, so they are quantized once a tree.  ``hist_one_leaf`` masks the rows
to its leaf first, so its rows are quantized a call.  ``scatter`` sums
the f32 rows at every precision, as the JAX package's scatter does.

``packed`` / ``num_features``: ``binned`` holds the (ceil(F/2), N) 4-bit
packed bytes of F features (``bin_layout=packed4``); only ``pallas``
reads them (K1's packed leg), ``scatter`` and ``onehot`` refuse them, as
in the JAX package (:182-184, :303-305).

Output layout: (L, F, B, 3) float32 — [sum_grad, sum_hess, count].
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..utils.log import log_info
from . import hist_cuda

# the one-hot product's row chunk (JAX hist_leaves_onehot's row_chunk)
ONEHOT_ROW_CHUNK = 16384
METHODS = ("scatter", "onehot", "pallas")
# calls of the one-hot product (torch.matmul, not a kernel)
matmul_counts = {"hist_leaves_onehot": 0}


def reset_matmul_counts() -> None:
    matmul_counts["hist_leaves_onehot"] = 0


def hist_leaves_scatter(binned: torch.Tensor, g3: torch.Tensor,
                        leaf_id: torch.Tensor, num_leaves: int,
                        num_bins: int, live_slots=None) -> torch.Tensor:
    """Exact f32 histograms of every slot (the oracle of the kernels)."""
    hist_cuda.count_plain("hist_leaves_scatter")
    return hist_cuda.index_add_hist(binned, [g3.to(torch.float32)],
                                    leaf_id, num_leaves, num_bins,
                                    live_slots)


@contextlib.contextmanager
def matmul_precision(level: str):
    """PyTorch's ``float32_matmul_precision`` at ``level`` inside the
    block ("highest": full f32, no TF32 on the card and no reduced passes
    on the CPU; "high": TF32 on the card), the caller's setting restored
    after."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(level)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def onehot_matmul_level(precision: str, device) -> str:
    """The f32 matmul precision of the one-hot product: "highest" for the
    f32 leg and on the CPU; "high" (TF32, exact on bf16-exact operands)
    for the bf16 legs on the card."""
    if precision == "f32" or torch.device(device).type != "cuda":
        return "highest"
    return "high"


def _matmul_hist(lg: torch.Tensor, onehot: torch.Tensor,
                 precision: str) -> torch.Tensor:
    """(R, C) rows @ (C, F B) one-hot, summed in f32 (JAX :77): ``f32``
    the rows as they are; ``bf16`` the rows rounded to bf16; any other
    precision (``bf16x2``) the rows' bf16 rounding and the bf16 rounding
    of the remainder, each product in f32, added.  The bf16 values are
    exact in f32, so the f32 product multiplies them exactly and never
    rounds a sum to bf16."""
    if precision == "f32":
        return lg @ onehot
    hi = lg.to(torch.bfloat16).to(torch.float32)
    if precision == "bf16":
        return hi @ onehot
    lo = (lg - hi).to(torch.bfloat16).to(torch.float32)
    R = lg.shape[0]
    both = torch.cat([hi, lo]) @ onehot
    return both[:R] + both[R:]


def hist_leaves_onehot(binned: torch.Tensor, g3: torch.Tensor,
                       leaf_id: torch.Tensor, num_leaves: int,
                       num_bins: int, precision: str = "bf16x2",
                       row_chunk: int = ONEHOT_ROW_CHUNK,
                       live_slots=None) -> torch.Tensor:
    """(L, F, B, 3) histograms as the JAX package's one-hot product
    (:98-150): chunks of ``min(row_chunk, max(256, N))`` rows, each the
    (3 (L + 1), C) leaf-masked rows [g, h, c] (a row of a leaf outside
    [0, L] adds nothing; slot L is the JAX sacrificial slot) times the
    (C, F B) one-hot of every feature's bin, accumulated in f32 in chunk
    order.  ``binned`` (F, N) uint8 or int16.  With ``live_slots`` the
    slots from it on are zeroed (``hist_frontier``'s contract)."""
    matmul_counts["hist_leaves_onehot"] += 1
    F, N = binned.shape
    L, B = int(num_leaves), int(num_bins)
    Lp = L + 1
    dev = binned.device
    C = min(int(row_chunk), max(256, N))
    acc = torch.zeros((Lp * 3, F * B), dtype=torch.float32, device=dev)
    slots = torch.arange(Lp, device=dev)[:, None]
    offs = (torch.arange(F, device=dev) * B)[None, :]
    g3 = g3.to(torch.float32)
    with matmul_precision(onehot_matmul_level(precision, dev)):
        for c0 in range(0, N, C):
            c1 = min(c0 + C, N)
            lid = leaf_id[c0:c1].to(torch.int64)
            leaf_oh = (lid[None, :] == slots).to(torch.float32)   # (Lp, c)
            lg = (leaf_oh[:, None, :] * g3[c0:c1].T[None]).reshape(
                Lp * 3, c1 - c0)
            onehot = torch.zeros((c1 - c0, F * B), dtype=torch.float32,
                                 device=dev)
            onehot.scatter_(1, binned[:, c0:c1].T.to(torch.int64) + offs,
                            1.0)
            acc += _matmul_hist(lg, onehot, precision)
    h = acc.reshape(Lp, 3, F, B).permute(0, 2, 3, 1)[:L].contiguous()
    if live_slots is not None and live_slots < L:
        h[live_slots:] = 0.0
    return h


def hist_frontier(binned: torch.Tensor, g3: torch.Tensor,
                  leaf_id: torch.Tensor, num_leaves: int, num_bins: int,
                  method: str = "scatter", precision: str = "bf16x2",
                  live_slots=None, packed: bool = False,
                  num_features=None, rows8=None) -> torch.Tensor:
    """All slots' histograms in a single pass; with ``live_slots`` only
    the rows of the slots below it add."""
    if method == "pallas":
        return hist_cuda.hist_leaves(binned, g3, leaf_id, num_leaves,
                                     num_bins, precision=precision,
                                     live_slots=live_slots, packed=packed,
                                     num_features=num_features, rows8=rows8)
    if packed:
        raise ValueError("4-bit packed bins require the pallas hist method")
    if method == "scatter":
        return hist_leaves_scatter(binned, g3, leaf_id, num_leaves, num_bins,
                                   live_slots)
    if method == "onehot":
        return hist_leaves_onehot(binned, g3, leaf_id, num_leaves, num_bins,
                                  precision, live_slots=live_slots)
    raise ValueError(f"hist method {method!r}: expected one of {METHODS}")


def hist_one_leaf(binned: torch.Tensor, g3: torch.Tensor,
                  leaf_id: torch.Tensor, target_leaf: int, num_bins: int,
                  method: str = "scatter", precision: str = "bf16x2",
                  packed: bool = False, num_features=None) -> torch.Tensor:
    """(F, B, 3) histogram of the rows in ``target_leaf``: one slot over
    the rows' values masked to the leaf (the smaller-child pass of the
    reference's BeforeFindBestSplit, serial_tree_learner.cpp:274-314)."""
    mask = (leaf_id == target_leaf).to(torch.float32)
    g3m = (g3 * mask[:, None]).contiguous()
    return hist_frontier(binned, g3m, torch.zeros_like(leaf_id), 1,
                         num_bins, method=method, precision=precision,
                         packed=packed, num_features=num_features)[0]


def hist_wave(binned: torch.Tensor, g3: torch.Tensor, label: torch.Tensor,
              nslots: int, num_bins: int, method: str = "scatter",
              precision: str = "bf16x2", packed: bool = False,
              num_features=None, rows8=None) -> torch.Tensor:
    """(nslots, F, B, 3) histograms of the rows labelled 0..nslots-1;
    rows labelled ``nslots`` (not in this wave) contribute nothing."""
    return hist_frontier(binned, g3, label, nslots + 1, num_bins,
                         method=method, precision=precision,
                         live_slots=nslots, packed=packed,
                         num_features=num_features, rows8=rows8)[:nslots]


def hist_wave_quant(binned: torch.Tensor, zq: torch.Tensor,
                    label: torch.Tensor, nslots: int, num_bins: int, key,
                    method: str = "scatter", packed: bool = False,
                    num_features=None) -> torch.Tensor:
    """``hist_q (nslots, F, B, 3)``: the integer histograms of the rows
    labelled 0..nslots-1 after stochastic rounding of the prequantized
    rows ``zq`` (N, 3) under the round key ``key``; the real histogram is
    ``hist_q`` times the tree's scales, which the grower folds into the
    subtraction or the split scan."""
    from .quantize import sr_quantize

    q3 = sr_quantize(zq, key)
    prec = "int8sr" if method == "pallas" else "f32"
    return hist_wave(binned, q3, label, nslots, num_bins, method=method,
                     precision=prec, packed=packed,
                     num_features=num_features)


def _wide_bins(bin_dtype) -> bool:
    return bin_dtype is not None and torch.iinfo(bin_dtype).bits > 8


def default_hist_method(config_method: str = "auto",
                        device: torch.device = torch.device("cpu"),
                        bin_dtype=torch.uint8) -> str:
    """Resolve ``hist_method`` (JAX :380): ``auto`` (and ``bench``'s
    static pick) is the CUDA kernel K1 (``pallas``) on a CUDA device, the
    one-hot product for int16 bins there (K1 reads bytes), and the
    scatter oracle on the CPU; an explicit ``scatter``, ``onehot`` or
    ``pallas`` stays as it is (``pallas`` on the CPU runs K1's plain
    version, the precision-faithful lane); ``fused`` is its base method
    ``pallas`` (``onehot`` on int16 bins), so a fused tree's root pass is
    the staged one's and the trees compare bit for bit."""
    if config_method == "fused":
        return "onehot" if _wide_bins(bin_dtype) else "pallas"
    if config_method not in ("auto", "bench"):
        if config_method not in METHODS:
            raise ValueError(f"hist_method={config_method!r}")
        return config_method
    if torch.device(device).type != "cuda":
        return "scatter"
    return "onehot" if _wide_bins(bin_dtype) else "pallas"


def bench_candidates(device, bin_dtype, packed: bool,
                     must_include=None) -> list:
    """The methods ``benchmark_hist_methods`` times (JAX :463-482): on
    the CPU scatter and onehot; on the card K1 and onehot for byte bins,
    onehot alone for int16 bins; only K1 on packed bins; a forced method
    (``must_include``) first where it is not in the list and can read
    the bins."""
    if torch.device(device).type != "cuda":
        cands = ["scatter", "onehot"]
    elif _wide_bins(bin_dtype):
        cands = ["onehot"]
    else:
        cands = ["pallas", "onehot"]
    if packed:
        cands = [m for m in cands if m == "pallas"]
    if must_include and must_include not in cands:
        if packed and must_include != "pallas":
            from ..utils.log import log_warning

            log_warning(f"hist_method=bench: forced method "
                        f"'{must_include}' cannot run on 4-bit packed "
                        "bins; force ignored")
        else:
            cands = [must_include] + cands
    return cands


def _time_method(fn, device, reps: int = 5) -> float:
    """Seconds a call of ``fn``: the median of ``reps`` calls after one
    untimed call, with CUDA events on the card."""
    fn()
    times = []
    if torch.device(device).type == "cuda":
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def benchmark_hist_methods(binned: torch.Tensor, num_bins: int,
                           precision: str, packed: bool, num_features: int,
                           nslots: int = 16, max_rows: int = 131072,
                           candidates=None, must_include=None,
                           times_out=None) -> str:
    """Time the applicable histogram methods on the first ``max_rows``
    rows of ``binned`` (its device's) at a wave round's shape (``nslots``
    slots, random rows from a fixed seed) and return the fastest (JAX
    :420-520, the reference's col-wise / row-wise auto-benchmark).  A
    single candidate is returned untimed.  Every candidate runs: one
    that fails to build or launch raises.  ``times_out`` (a dict)
    receives each candidate's seconds a call."""
    dev = binned.device
    if candidates is None:
        candidates = bench_candidates(dev, binned.dtype, packed,
                                      must_include)
    if len(candidates) <= 1:
        pick = candidates[0] if candidates else default_hist_method(
            "auto", dev, binned.dtype)
        log_info(f"hist-method benchmark: single applicable candidate "
                 f"-> {pick}" + (" (4-bit packing pins the pallas kernel)"
                                 if packed else ""))
        return pick
    n = min(binned.shape[1], max_rows)
    sub = binned[:, :n].contiguous()
    rng = np.random.RandomState(0)
    g3 = torch.as_tensor(rng.randn(n, 3).astype(np.float32), device=dev)
    label = torch.as_tensor(rng.randint(0, nslots + 1, n).astype(np.int32),
                            device=dev)
    times = {}
    for m in candidates:
        times[m] = _time_method(
            lambda m=m: hist_wave(sub, g3, label, nslots, num_bins, method=m,
                                  precision=precision, packed=packed,
                                  num_features=num_features), dev)
    if times_out is not None:
        times_out.update(times)
    pick = min(times, key=times.get)
    log_info("hist-method benchmark (%s rows x %s cols, %s): %s -> %s"
             % (n, binned.shape[0], binned.dtype,
                ", ".join(f"{m}={v * 1e3:.2f}ms"
                          for m, v in sorted(times.items())), pick))
    return pick
