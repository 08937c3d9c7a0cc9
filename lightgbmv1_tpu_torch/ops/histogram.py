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
* ``default_hist_method`` (:380) — ``auto`` is ``pallas`` (K1) for a CUDA
  tensor, as on the TPU, and ``scatter`` for a CPU one, as on the JAX
  package's CPU backend; ``fused`` resolves to its base method ``pallas``,
  the one its root pass runs (the wave rounds' fused dispatch is in
  parallel/trainer.py).

``precision="int8"`` (``hist_dtype=int8`` / ``hist_dtype_deep=int8``)
runs K1's int8 leg on ``pallas``: the rows rounded to nearest under one
scale a row tile (ops/quantize.rn_quantize); ``rows8``, a tree's
``quantize.NearestRows``, holds them for each row tile the tree's passes
use, so they are quantized once a tree.  ``hist_one_leaf`` masks the rows
to its leaf first, so its rows are quantized a call.  ``scatter`` sums
the f32 rows at every precision, as the JAX package's scatter does.

``packed`` / ``num_features``: ``binned`` holds the (ceil(F/2), N) 4-bit
packed bytes of F features (``bin_layout=packed4``); only ``pallas``
reads them (K1's packed leg), ``scatter`` refuses them, as in the JAX
package (:182-184, :303-305).

Output layout: (L, F, B, 3) float32 — [sum_grad, sum_hess, count].
"""

from __future__ import annotations

import torch

from ..config import HIST_METHODS, not_ported
from . import hist_cuda


def hist_leaves_scatter(binned: torch.Tensor, g3: torch.Tensor,
                        leaf_id: torch.Tensor, num_leaves: int,
                        num_bins: int, live_slots=None) -> torch.Tensor:
    """Exact f32 histograms of every slot (the oracle of the kernels)."""
    hist_cuda.count_plain("hist_leaves_scatter")
    return hist_cuda.index_add_hist(binned, [g3.to(torch.float32)],
                                    leaf_id, num_leaves, num_bins,
                                    live_slots)


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
    raise not_ported(f"hist_method={method}", HIST_METHODS)


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


def default_hist_method(config_method: str = "auto",
                        device: torch.device = torch.device("cpu")) -> str:
    """Resolve ``hist_method``: ``auto`` is the CUDA kernel K1
    (``pallas``) on a CUDA device and the scatter oracle on the CPU; an
    explicit ``scatter`` or ``pallas`` stays as it is (``pallas`` on the
    CPU runs K1's plain version, the precision-faithful lane); ``fused``
    is its base method ``pallas``, so a fused tree's root pass is the
    staged one's and the trees compare bit for bit."""
    if config_method in ("scatter", "pallas"):
        return config_method
    if config_method == "fused":
        return "pallas"
    if config_method != "auto":
        raise not_ported(f"hist_method={config_method}", HIST_METHODS)
    return "pallas" if torch.device(device).type == "cuda" else "scatter"
