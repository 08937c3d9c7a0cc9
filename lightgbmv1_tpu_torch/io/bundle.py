"""Exclusive Feature Bundling (EFB): the port's copy of
lightgbmv1_tpu/io/bundle.py (:47-304).

Features that are rarely non-zero on the same row share one bundle
column: bundle bin 0 is "every member at its zero bin", member ``f``'s
bin ``b`` away from its zero bin is ``offset[f] + b``; a feature alone in
its bundle keeps its bins (offset 0).  The histograms of training run over
the BF bundle columns (K1 at ``padded_bundle_bin`` bins); the split scan
reads each original feature's slice of its bundle's histogram, the zero
bin of a bundled feature recovered from its parent's totals
(``expand_bundle_hist``, the reference's ``FixHistogram``); every decision
reads its feature's bin back out of the bundle column
(``bundle_bins_of_feat`` / ``bundle_bins_of_rows``, and on the card K3's
bundle leg).  Trees always speak original features and bins, so the model
text is the one unbundled training writes where the splits agree.

``find_bundles`` is the greedy conflict-bounded grouping (reference
``FindGroups``, src/io/dataset.cpp:97-235); ``maybe_bundle`` bundles a
dense binned matrix where it saves at least a fifth of the columns, and
``apply_bundles_csr`` builds the bundle matrix straight from binned CSR
triplets.  ``BundleArrays`` holds the layout on the training device with
the (5, F) int32 table K3's bundle leg reads (``table``: bundle_of,
offset, num_bins, zero_bin, is_bundled).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils.log import log_info

MAX_BUNDLE_BINS = 256      # uint8 bundles only
_CONFLICT_SAMPLE = 32768   # rows sampled for conflict counting


@dataclass
class BundleLayout:
    """Original features -> bundle columns: ``bundle_of`` (F,) int32,
    ``offset`` (F,) int32 (0 in a bundle of one), ``is_bundled`` (F,)
    bool (the feature shares its bundle), ``bundle_nbins`` (BF,) int32."""

    bundle_of: np.ndarray
    offset: np.ndarray
    is_bundled: np.ndarray
    bundle_nbins: np.ndarray

    @property
    def num_bundles(self) -> int:
        return len(self.bundle_nbins)

    @property
    def num_features(self) -> int:
        return len(self.bundle_of)

    @classmethod
    def identity(cls, num_bins) -> "BundleLayout":
        """Every feature its own bundle: bundle bins are original bins."""
        F = len(num_bins)
        return cls(np.arange(F, dtype=np.int32), np.zeros(F, np.int32),
                   np.zeros(F, bool), np.asarray(num_bins, np.int32))


def find_bundles(nonzero_masks: np.ndarray, num_bins: Sequence[int],
                 max_conflict_rate: float = 0.0,
                 max_bundle_bins: int = MAX_BUNDLE_BINS
                 ) -> Optional[BundleLayout]:
    """The greedy grouping of (F, S) sampled non-zero masks: features in
    falling non-zero count, each into the first bundle (of at most 256
    searched) whose conflicts stay within ``max_conflict_rate * S`` and
    whose bins fit ``max_bundle_bins``.  None where no two features
    share."""
    F, S = nonzero_masks.shape
    num_bins = np.asarray(num_bins, dtype=np.int64)
    budget = int(max_conflict_rate * S)
    order = np.argsort(-nonzero_masks.sum(axis=1, dtype=np.int64),
                       kind="stable")
    group_masks: List[np.ndarray] = []
    group_conflicts: List[int] = []
    group_bins: List[int] = []
    group_members: List[List[int]] = []
    max_search = 256
    rng = np.random.RandomState(3)
    for f in order:
        fm = nonzero_masks[f]
        nb = int(num_bins[f])
        placed = False
        n_groups = len(group_masks)
        if n_groups <= max_search:
            candidates = range(n_groups)
        else:
            candidates = rng.choice(n_groups, size=max_search, replace=False)
        for g in candidates:
            if group_bins[g] + nb > max_bundle_bins:
                continue
            cnt = int(np.count_nonzero(group_masks[g] & fm))
            if group_conflicts[g] + cnt <= budget:
                group_masks[g] |= fm
                group_conflicts[g] += cnt
                group_bins[g] += nb
                group_members[g].append(int(f))
                placed = True
                break
        if not placed:
            group_masks.append(fm.copy())
            group_conflicts.append(0)
            group_bins.append(1 + nb)    # + the shared all-zero bin
            group_members.append([int(f)])
    BF = len(group_members)
    if BF >= F:
        return None
    bundle_of = np.zeros(F, np.int32)
    offset = np.zeros(F, np.int32)
    is_bundled = np.zeros(F, bool)
    bundle_nbins = np.zeros(BF, np.int32)
    for g, members in enumerate(group_members):
        if len(members) == 1:
            bundle_of[members[0]] = g
            bundle_nbins[g] = num_bins[members[0]]
            continue
        off = 1                          # bin 0: every member at zero
        for f in members:
            bundle_of[f], offset[f], is_bundled[f] = g, off, True
            off += int(num_bins[f])
        bundle_nbins[g] = off
    return BundleLayout(bundle_of, offset, is_bundled, bundle_nbins)


def conflict_masks_from_dense(binned: np.ndarray, zero_bins: Sequence[int],
                              sample_cnt: int = _CONFLICT_SAMPLE,
                              seed: int = 1) -> np.ndarray:
    """(F, S) bool sampled non-zero masks of a dense (F, N) binned matrix."""
    F, N = binned.shape
    rng = np.random.RandomState(seed)
    if N > sample_cnt:
        sub = binned[:, rng.choice(N, size=sample_cnt, replace=False)]
    else:
        sub = binned
    zb = np.asarray(zero_bins, dtype=binned.dtype)[:, None]
    return sub != zb


def _bundle_dtype(layout: BundleLayout):
    return np.uint8 if int(layout.bundle_nbins.max()) <= 256 else np.int16


def apply_bundles_dense(binned: np.ndarray, zero_bins: Sequence[int],
                        layout: BundleLayout) -> np.ndarray:
    """(F, N) -> (BF, N) bundle matrix.  Where two members are non-zero on
    one row (``max_conflict_rate > 0``) the later member's bin stays, as
    the reference's push order leaves it."""
    F, N = binned.shape
    dtype = _bundle_dtype(layout)
    out = np.zeros((layout.num_bundles, N), dtype=dtype)
    zb = np.asarray(zero_bins)
    for f in range(F):
        g = int(layout.bundle_of[f])
        if not layout.is_bundled[f]:
            out[g] = binned[f].astype(dtype)
            continue
        nz = binned[f] != zb[f]
        out[g][nz] = (layout.offset[f] + binned[f][nz]).astype(dtype)
    return out


def apply_bundles_csr(indptr: np.ndarray, indices: np.ndarray,
                      bin_values: np.ndarray, num_data: int,
                      zero_bins: Sequence[int],
                      layout: BundleLayout) -> np.ndarray:
    """The (BF, N) bundle matrix straight from binned CSR triplets
    (``bin_values`` original bins); the dense (F, N) matrix never forms.
    An absent entry is a raw 0.0: bundle bin 0 for a bundled member, the
    feature's zero bin for a bundle of one."""
    dtype = _bundle_dtype(layout)
    out = np.zeros((layout.num_bundles, num_data), dtype=dtype)
    zb = np.asarray(zero_bins)
    for f in np.where(~layout.is_bundled)[0]:
        if zb[f] != 0:
            out[int(layout.bundle_of[f])][:] = zb[f]
    rows = np.repeat(np.arange(num_data), np.diff(indptr))
    feats = indices
    nz = bin_values != zb[feats]
    bundle_bin = np.where(layout.is_bundled[feats],
                          layout.offset[feats] + bin_values, bin_values)
    # bundled members write their non-zero bins only; a bundle of one
    # writes every explicit entry (an explicit zero is its zero bin)
    w = nz | (~layout.is_bundled[feats])
    out[layout.bundle_of[feats[w]], rows[w]] = bundle_bin[w].astype(dtype)
    return out


def maybe_bundle(binned: np.ndarray, zero_bins, num_bins,
                 max_conflict_rate: float = 0.0, min_saving: float = 0.2):
    """``(bundled, layout)`` of a dense binned matrix, or ``(binned,
    None)`` where bundling saves less than ``min_saving`` of the columns
    (or there are fewer than three features)."""
    F = binned.shape[0]
    if F < 3:
        return binned, None
    layout = find_bundles(conflict_masks_from_dense(binned, zero_bins),
                          num_bins, max_conflict_rate=max_conflict_rate)
    if layout is None or layout.num_bundles > F * (1.0 - min_saving):
        return binned, None
    bundled = apply_bundles_dense(binned, zero_bins, layout)
    log_info(f"EFB: bundled {F} features into {layout.num_bundles} dense "
             f"columns (max {int(layout.bundle_nbins.max())} bins/bundle)")
    return bundled, layout


class BundleArrays:
    """The layout on the training device: (F,) int64 ``bundle_of``,
    ``offset``, ``num_bins``, ``zero_bin``, bool ``is_bundled``, and the
    (5, F) int32 ``table`` of K3's bundle leg (those five rows)."""

    def __init__(self, layout: BundleLayout, zero_bins, num_bins, device):
        rows = [np.asarray(layout.bundle_of), np.asarray(layout.offset),
                np.asarray(num_bins), np.asarray(zero_bins),
                np.asarray(layout.is_bundled)]
        self.table = torch.as_tensor(
            np.stack([r.astype(np.int32) for r in rows]),
            device=device).contiguous()
        self.bundle_of, self.offset, self.num_bins, self.zero_bin = (
            self.table[i].long() for i in range(4))
        self.is_bundled = self.table[4] != 0
        self.num_bundles = int(layout.num_bundles)


def expand_bundle_hist(hist_b: torch.Tensor, parent_sum: torch.Tensor,
                       ba: BundleArrays, num_bins: int) -> torch.Tensor:
    """(C, BF, Bb, 3) bundle histograms and their (C, 3) totals -> the
    (C, F, B = ``num_bins``, 3) view of the original features (JAX
    :232-255, batched over C): each feature's bins a slice of its bundle's
    histogram (a gather), the zero bin of a bundled feature its parent's
    totals less the feature's other bins.  A bundle of one is an identity
    slice."""
    C, _, Bb, _ = hist_b.shape
    dev = hist_b.device
    F = ba.bundle_of.shape[0]
    bins_iota = torch.arange(num_bins, device=dev)
    idx = ba.offset[:, None] + bins_iota[None, :]                  # (F, B)
    v = hist_b[:, ba.bundle_of[:, None], idx.clamp(0, Bb - 1)]     # (C,F,B,3)
    valid = (bins_iota[None, :] < ba.num_bins[:, None]) & (idx < Bb)
    v = torch.where(valid[None, :, :, None], v, torch.zeros((), device=dev))
    zfix = parent_sum[:, None, :] - v.sum(dim=2)                   # (C, F, 3)
    zb = ba.zero_bin.clamp(0, num_bins - 1)
    fi = torch.arange(F, device=dev)
    cur = v[:, fi, zb]                                             # (C, F, 3)
    v[:, fi, zb] = torch.where(ba.is_bundled[None, :, None], zfix, cur)
    return v


def bundle_bins_of_feat(bundled: torch.Tensor, feat,
                        ba: BundleArrays) -> torch.Tensor:
    """(N,) original bins of feature ``feat`` (JAX :258-268): its bundle
    column less its offset, a value outside its range its zero bin; a
    bundle of one as it is."""
    bb = bundled[ba.bundle_of[feat]].long()
    inner = bb - ba.offset[feat]
    in_range = (inner >= 0) & (inner < ba.num_bins[feat])
    mapped = torch.where(in_range, inner, ba.zero_bin[feat])
    return torch.where(ba.is_bundled[feat], mapped, bb)


def bundle_bins_of_rows(bundled: torch.Tensor, f_row: torch.Tensor,
                        ba: BundleArrays) -> torch.Tensor:
    """(N,) original bins of each row's own feature ``f_row`` (JAX
    :271-283)."""
    f_row = f_row.long()
    g_row = ba.bundle_of[f_row]
    bb = torch.gather(bundled, 0, g_row[None, :])[0].long()
    inner = bb - ba.offset[f_row]
    in_range = (inner >= 0) & (inner < ba.num_bins[f_row])
    mapped = torch.where(in_range, inner, ba.zero_bin[f_row])
    return torch.where(ba.is_bundled[f_row], mapped, bb)
