"""Best numerical split of each leaf from its histogram (plain torch).

Port of the numerical split scan of lightgbmv1_tpu/ops/split.py
(reference ``FeatureHistogram::FindBestThresholdSequentially``,
feature_histogram.hpp:855-1056): both scan directions as cumulative sums
over the bin axis, evaluated for all features, bins and directions at
once, then the tie-band preference argmax.  The JAX version is vmapped
over the wave's 2K children; here that batch is the leading axis ``C``
of every input.

Ported: ``tie_tol`` (:56, ``TIE_RTOL``), ``go_left_rule`` (:65),
``SplitParams`` (:85), ``SplitResult`` (:112), ``leaf_gain`` /
``leaf_output`` (:130/:145), ``FeatureMeta`` / ``make_feature_meta``
(:157/:173), ``child_leaf_output`` (:216), ``scan_left_sums`` (:459),
``scan_direction_gains`` (:532), ``scan_pick_feature`` (:636),
``scan_pick`` (:667), ``gain_shift`` and
``find_best_split`` (:437; both with ``hist_scale``, the int8sr rounds'
dequantize-aware scan), which takes its leaves as a batch and so is
also ``find_best_split_batch`` (:837, the JAX vmap over a frontier).  The tie-breaking is kept exactly: it decides
the tree.  Categorical splits, monotone constraints, path smoothing,
max_delta_step, feature_contri, CEGB and extra_trees are not ported
(the config refuses them).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..io.binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO

NEG_INF = float("-inf")

# Near-tie tolerance of the split argmax, relative to the gain scale:
# candidates within TIE_RTOL * (|shift| + |best|) of the best are tied and
# resolved by the deterministic preference order (reference scan order
# within a feature, the lowest feature across features), so f32
# summation-order noise in the histograms cannot flip a pick.
TIE_RTOL = 4e-6

NO_CONSTRAINT = (-3.0e38, 3.0e38)


def tie_tol(best_gain: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Absolute gain tolerance under which two candidates count as tied;
    a ``-inf`` best contributes nothing."""
    b = torch.where(torch.isfinite(best_gain), best_gain.abs(),
                    torch.zeros_like(best_gain))
    return TIE_RTOL * (scale.abs() + b)


def go_left_rule(bins, thr, dl, mt, nan_bin, zero_bin):
    """The numerical split's go-left decision on integer bin ids: the bin
    compare plus the NaN / zero missing-direction rules.  Every argument
    broadcasts; pure integer and bool ops, so exact on any device."""
    na = ((mt == MISSING_NAN) & (bins == nan_bin)) | (
        (mt == MISSING_ZERO) & (bins == zero_bin))
    return torch.where(na, dl, bins <= thr)


class SplitParams(NamedTuple):
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: float = 20.0
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0


class SplitResult(NamedTuple):
    """Batched over the leading axis C."""

    gain: torch.Tensor           # (C,) f32 relative gain; <= 0: no split
    feature: torch.Tensor        # (C,) int64
    threshold_bin: torch.Tensor  # (C,) int64 — bin <= threshold goes left
    default_left: torch.Tensor   # (C,) bool — missing-value direction
    left_sum: torch.Tensor       # (C, 3) [grad, hess, count]
    right_sum: torch.Tensor      # (C, 3)


def threshold_l1(s, l1: float):
    """reference ThresholdL1, feature_histogram.hpp:734."""
    return torch.sign(s) * torch.clamp(s.abs() - l1, min=0.0)


def leaf_gain(g, h, p: SplitParams):
    """reference GetLeafGain, feature_histogram.hpp:823-839."""
    t = threshold_l1(g, p.lambda_l1)
    return (t * t) / (h + p.lambda_l2)


def leaf_output(g, h, p: SplitParams):
    """reference CalculateSplittedLeafOutput, feature_histogram.hpp:740."""
    return -threshold_l1(g, p.lambda_l1) / (h + p.lambda_l2)


def child_leaf_output(sums, p: SplitParams):
    """A frontier child's leaf output from its (..., 3) [g, h, c] sums."""
    return leaf_output(sums[..., 0], sums[..., 1], p)


class FeatureMeta(NamedTuple):
    """Per-feature bin metadata the scan reads, on the training device."""

    num_bins: torch.Tensor       # (F,) int64
    missing_type: torch.Tensor   # (F,) int64
    nan_bin: torch.Tensor        # (F,) int64 (-1 if none)
    zero_bin: torch.Tensor       # (F,) int64
    usable: torch.Tensor         # (F,) bool — not trivial


def make_feature_meta(dataset, device) -> FeatureMeta:
    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return FeatureMeta(num_bins=t(dataset.num_bins),
                       missing_type=t(dataset.missing_types),
                       nan_bin=t(dataset.nan_bins),
                       zero_bin=t(dataset.zero_bins),
                       usable=t(~np.asarray(dataset.is_trivial), torch.bool))


def scan_left_sums(hist: torch.Tensor, meta: FeatureMeta,
                   hist_scale=None) -> torch.Tensor:
    """(C, F, B, 3) histograms -> (C, 2, F, B, 3) left sums of both scan
    directions: direction 0 sends the missing mass right (the forward
    scan), direction 1 sends it left.  Zero-as-missing features skip the
    zero bin while accumulating, so its mass rides the missing direction
    (reference SKIP_DEFAULT_BIN, feature_histogram.hpp:879-882).

    Dequantize-aware (JAX :459, int8sr): with ``hist_scale`` (C, 3) the
    histograms hold integer sums, the cumulative sum runs on them (exact)
    and one multiply dequantizes the prefix sums, and the point reads of
    the missing mass."""
    C, F, B, _ = hist.shape
    cum = torch.cumsum(hist, dim=2)                      # inclusive
    if hist_scale is not None:
        cum = cum * hist_scale[:, None, None, :]
        hist = hist * hist_scale[:, None, None, :]       # point reads below
    t_idx = torch.arange(B, device=hist.device)[None, :]          # (1, B)
    fi = torch.arange(F, device=hist.device)
    nan_contrib = hist[:, fi, meta.nan_bin.clamp(min=0)]          # (C, F, 3)
    zero_contrib = hist[:, fi, meta.zero_bin]                     # (C, F, 3)
    is_nan_f = (meta.missing_type == MISSING_NAN)[:, None]        # (F, 1)
    is_zero_f = (meta.missing_type == MISSING_ZERO)[:, None]
    zb = meta.zero_bin[:, None]
    zeros = torch.zeros((), dtype=hist.dtype, device=hist.device)
    left_a = cum - torch.where((is_zero_f & (t_idx >= zb))[None, :, :, None],
                               zero_contrib[:, :, None, :], zeros)
    left_b = cum + torch.where(
        is_nan_f[None, :, :, None], nan_contrib[:, :, None, :],
        torch.where((is_zero_f & (t_idx < zb))[None, :, :, None],
                    zero_contrib[:, :, None, :], zeros))
    return torch.stack([left_a, left_b], dim=1)


def gain_shift(parent_sum: torch.Tensor, params: SplitParams):
    """(C,) parent gain + min_gain_to_split: every candidate's baseline."""
    return leaf_gain(parent_sum[:, 0], parent_sum[:, 1], params) \
        + params.min_gain_to_split


def scan_direction_gains(left2, parent_sum, meta: FeatureMeta,
                         feature_mask, params: SplitParams):
    """(C, 2, F, B) relative gains of every candidate (shift subtracted;
    ``-inf`` where a side misses min_data / min_hessian or the candidate
    does not exist) and the (C,) shift."""
    C, _, F, B, _ = left2.shape
    dev = left2.device
    tot = parent_sum[:, None, None, None, :]             # (C, 1, 1, 1, 3)
    lg, lh, lc = left2[..., 0], left2[..., 1], left2[..., 2]
    rg, rh, rc = tot[..., 0] - lg, tot[..., 1] - lh, tot[..., 2] - lc
    ok = ((lc >= params.min_data_in_leaf) & (rc >= params.min_data_in_leaf)
          & (lh >= params.min_sum_hessian_in_leaf)
          & (rh >= params.min_sum_hessian_in_leaf))
    gain = leaf_gain(lg, lh, params) + leaf_gain(rg, rh, params)
    neg_inf = torch.full((), NEG_INF, dtype=left2.dtype, device=dev)
    t_idx = torch.arange(B, device=dev)[None, :]
    has_miss_dir = (meta.missing_type == MISSING_NAN) | (
        meta.missing_type == MISSING_ZERO)
    base_valid = ((t_idx <= meta.num_bins[:, None] - 2)[None]
                  & (feature_mask & meta.usable[None, :])[:, :, None])
    valid2 = torch.stack(
        [base_valid, base_valid & has_miss_dir[None, :, None]], dim=1)
    gains2 = torch.where(valid2 & ok, gain, neg_inf)
    shift = gain_shift(parent_sum, params)
    return gains2 - shift[:, None, None, None], shift


def scan_pick_feature(gains: torch.Tensor, shift: torch.Tensor,
                      meta: FeatureMeta):
    """The per-feature half of the tie-band preference argmax (JAX :636):
    (C, 2, F, B) gains -> each feature's best gain ``fbest`` (C, F) and
    its preferred in-band candidate ``sel_f`` (C, F), encoded
    ``direction * B + threshold``.  Within a feature the reference's scan
    order decides a tie: the reverse scan's highest threshold first for a
    missing-none or 2-bin feature, else the forward scan's lowest.  The
    fused round (ops/wave_fused.py) runs this half per feature and leaves
    only its O(F) residue for the cross-feature half."""
    C, _, F, B = gains.shape
    dev = gains.device
    t_idx = torch.arange(B, device=dev)[None, :]
    rev_like_a = ((meta.missing_type == MISSING_NONE)
                  | (meta.num_bins <= 2))[:, None]
    pref_a = torch.where(rev_like_a, 2 * B + t_idx, B - 1 - t_idx)
    pref_b = (2 * B + t_idx).expand(F, B)
    gains_f = torch.cat([gains[:, 0], gains[:, 1]], dim=2)       # (C, F, 2B)
    pref_f = torch.cat([pref_a, pref_b], dim=1)[None]            # (1, F, 2B)
    fbest = gains_f.max(dim=2).values                            # (C, F)
    tol_f = tie_tol(fbest, shift[:, None])
    sel_f = torch.argmax(torch.where(gains_f >= (fbest - tol_f)[..., None],
                                     pref_f, torch.full_like(pref_f, -1)),
                         dim=2)                                  # (C, F)
    return fbest, sel_f


def scan_pick(gains: torch.Tensor, shift: torch.Tensor, meta: FeatureMeta):
    """The tie-band preference argmax over (C, 2, F, B) gains -> (best
    gain, feature, threshold, direction), each (C,): the per-feature half
    (``scan_pick_feature``), then across features the lowest feature in
    the band wins (reference SplitInfo::operator>)."""
    C, _, F, B = gains.shape
    dev = gains.device
    fbest, sel_f = scan_pick_feature(gains, shift, meta)
    gains_f = torch.cat([gains[:, 0], gains[:, 1]], dim=2)       # (C, F, 2B)
    gbest = fbest.max(dim=1).values                              # (C,)
    in_band = fbest >= (gbest - tie_tol(gbest, shift))[:, None]
    feature = torch.argmax(in_band.to(torch.uint8), dim=1)       # first
    ci = torch.arange(C, device=dev)
    sel = sel_f[ci, feature]
    best_gain = gains_f[ci, feature, sel]
    return best_gain, feature, sel % B, sel // B


def find_best_split(hist: torch.Tensor, parent_sum: torch.Tensor,
                    meta: FeatureMeta, feature_mask: torch.Tensor,
                    params: SplitParams, hist_scale=None) -> SplitResult:
    """Best numerical split of each of C leaves: ``hist`` (C, F, B, 3),
    ``parent_sum`` (C, 3), ``feature_mask`` (C, F) bool; ``hist_scale``
    (C, 3): ``hist`` holds quantized integer sums, dequantized after the
    cumulative sum (``scan_left_sums``)."""
    C = hist.shape[0]
    left2 = scan_left_sums(hist, meta, hist_scale)
    gains, shift = scan_direction_gains(left2, parent_sum, meta,
                                        feature_mask, params)
    best_gain, feature, threshold, direction = scan_pick(gains, shift, meta)
    ci = torch.arange(C, device=hist.device)
    left = left2[ci, direction, feature, threshold]              # (C, 3)
    right = parent_sum - left
    mtype = meta.missing_type[feature]
    default_left = ((mtype == MISSING_NAN) | (mtype == MISSING_ZERO)) \
        & (direction == 1)
    rel_gain = torch.where(torch.isfinite(best_gain), best_gain,
                           torch.full_like(best_gain, NEG_INF))
    return SplitResult(gain=rel_gain.to(torch.float32), feature=feature,
                       threshold_bin=threshold, default_left=default_left,
                       left_sum=left.to(torch.float32),
                       right_sum=right.to(torch.float32))

