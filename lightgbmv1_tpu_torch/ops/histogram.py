"""Histogram construction: method dispatch and the scatter oracle.

Port of lightgbmv1_tpu/ops/histogram.py for the wave grower's passes:

* ``hist_leaves_scatter`` (:53) — the exact f32 oracle, one
  ``index_add_`` over the flattened (feature, slot, bin) index;
* ``hist_frontier`` (:272) — all slots' histograms in one pass, through
  the method the trainer resolved: ``pallas`` is the hand-written CUDA
  kernel K1 (``ops/hist_cuda.hist_leaves``, whose plain version a CPU
  tensor takes), ``scatter`` the oracle above;
* ``hist_wave`` (:312) — the wave round's ``nslots`` histograms: rows
  labelled ``nslots`` are dead; the histogram runs at ``nslots + 1``
  slots (the plan, so the bits, of the JAX package's sacrificial slot)
  with only the first ``nslots`` live, so K1 drops the dead rows at the
  load, and the dead slot is sliced away;
* ``default_hist_method`` (:380) — ``auto`` is ``pallas`` (K1) for a CUDA
  tensor, as on the TPU, and ``scatter`` for a CPU one, as on the JAX
  package's CPU backend; ``fused`` resolves to its base method ``pallas``,
  the one its root pass runs (the wave rounds' fused dispatch is in
  parallel/trainer.py).

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
                  live_slots=None) -> torch.Tensor:
    """All slots' histograms in a single pass; with ``live_slots`` only
    the rows of the slots below it add."""
    if method == "pallas":
        return hist_cuda.hist_leaves(binned, g3, leaf_id, num_leaves,
                                     num_bins, precision=precision,
                                     live_slots=live_slots)
    if method == "scatter":
        return hist_leaves_scatter(binned, g3, leaf_id, num_leaves, num_bins,
                                   live_slots)
    raise not_ported(f"hist_method={method}", HIST_METHODS)


def hist_wave(binned: torch.Tensor, g3: torch.Tensor, label: torch.Tensor,
              nslots: int, num_bins: int, method: str = "scatter",
              precision: str = "bf16x2") -> torch.Tensor:
    """(nslots, F, B, 3) histograms of the rows labelled 0..nslots-1;
    rows labelled ``nslots`` (not in this wave) contribute nothing."""
    return hist_frontier(binned, g3, label, nslots + 1, num_bins,
                         method=method, precision=precision,
                         live_slots=nslots)[:nslots]


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
