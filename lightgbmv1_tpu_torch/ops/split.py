"""Best numerical split of each leaf from its histogram.

Port of the numerical split scan of lightgbmv1_tpu/ops/split.py
(reference ``FeatureHistogram::FindBestThresholdSequentially``,
feature_histogram.hpp:855-1056): both scan directions as cumulative sums
over the bin axis, evaluated for all features, bins and directions at
once, then the tie-band preference argmax.  The JAX version is vmapped
over the wave's 2K children; here that batch is the leading axis ``C``
of every input.

Ported: ``tie_tol`` (:56, ``TIE_RTOL``), ``go_left_rule`` (:65),
``SplitParams`` (:85), ``SplitResult`` (:112), ``leaf_gain`` /
``leaf_output`` with ``max_delta_step`` (:130/:145), ``FeatureMeta`` /
``make_feature_meta`` with the monotone types and ``feature_contri``
(:157/:173), ``leaf_gain_given_output``, ``smooth_output``,
``child_leaf_output`` and ``monotone_penalty_factor`` (:198-240),
``scan_left_sums`` (:459), ``gain_shift`` (:515),
``scan_direction_gains`` (:532, the constrained scan of the reference's
``GetSplitGains<USE_MC, USE_MAX_OUTPUT, USE_SMOOTHING>``,
feature_histogram.hpp:740-839, with the relative-gain penalties in the
reference order: the contri multiply, then the monotone depth penalty),
``scan_pick_feature`` (:636), ``scan_pick`` (:667), the fused path's
``_pick_pack`` / ``unpack_children`` (wave_fused.py:610/:652) as
``pick_pack`` / ``unpack_children``, and ``find_best_split`` (:437, with
``hist_scale``, the int8sr rounds' dequantize-aware scan), which takes
its leaves as a batch and so is also ``find_best_split_batch`` (:837, the
JAX vmap over a frontier): constraints (C, 2), depths (C,) and parent
outputs (C,) are per leaf.  The tie-breaking is kept exactly: it decides
the tree.

extra_trees (JAX :602-607, the numerical leg): each leaf draws one
threshold a feature, ``uniform(fold_in(tree_key, uid + 1_000_003 +
extra_seed), (F,))`` times ``max(num_bins - 1, 1)`` in f32, truncated
(``extra_rand_bins``), and only that threshold is a candidate.
``find_best_split`` takes the tree key and the leaves' uids for it; the
split-scan kernel draws the same bits itself (``csrc/wave_round.cuh``
``rand_bin``).

``find_best_split`` is the per-feature residue (``scan_residue``: the
scan's stages up to ``scan_pick_feature``) and the cross-feature pick on
it (``pick_pack``), the two halves the fused round splits the same way.
On a CUDA tensor both are one launch of the split-scan kernel
(``ops/scan_cuda.py``, ``csrc/split_scan.cu``), which sums each prefix
in K2's order, the order PyTorch's CPU cumulative sum takes, and picks
as ``pick_pack`` does, bit for bit; on a CPU tensor they are the plain
versions here.  The kernels read the feature meta's int32 tables, made
once with the meta (``with_tables``).  The monotone penalty factor of a
depth is one table made on the host (``monotone_penalty_factors``), so
the kernel and the plain version multiply by the same bits.
Categorical splits and CEGB are not ported (the config refuses them).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..io.binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO
from ..utils import prng

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
    # reference USE_MAX_OUTPUT: leaf outputs clamped to +-max_delta_step
    max_delta_step: float = 0.0
    # reference USE_SMOOTHING: outputs smoothed toward the parent's
    path_smooth: float = 0.0
    # reference ComputeMonotoneSplitGainPenalty (monotone constraints only)
    monotone_penalty: float = 0.0
    # reference USE_RAND: one random threshold a feature a node
    extra_trees: bool = False
    extra_seed: int = 0


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
    """reference GetLeafGain, feature_histogram.hpp:823-839; with
    ``max_delta_step`` the gain at the clamped output."""
    if p.max_delta_step <= 0:
        t = threshold_l1(g, p.lambda_l1)
        return (t * t) / (h + p.lambda_l2)
    return leaf_gain_given_output(g, h, leaf_output(g, h, p), p)


def leaf_output(g, h, p: SplitParams):
    """reference CalculateSplittedLeafOutput, feature_histogram.hpp:740,
    clamped to +-``max_delta_step`` when it is set."""
    out = -threshold_l1(g, p.lambda_l1) / (h + p.lambda_l2)
    if p.max_delta_step <= 0:
        return out
    return torch.clamp(out, -p.max_delta_step, p.max_delta_step)


def leaf_gain_given_output(g, h, out, p: SplitParams):
    """reference GetLeafGainGivenOutput: the gain of a leaf forced to
    emit ``out``, ``-(2 t out + (h + l2) out out)`` in that op order (the
    split-scan kernel's ``leaf_gain_given_output`` rounds the same
    products and sums)."""
    t = threshold_l1(g, p.lambda_l1)
    return -(2.0 * t * out + (h + p.lambda_l2) * out * out)


def smooth_output(raw_out, count, parent_output, p: SplitParams):
    """Path smoothing (reference feature_histogram.hpp:756-760):
    ``out * w / (w + 1) + parent / (w + 1)`` with ``w = n / path_smooth``."""
    w = count / p.path_smooth
    return raw_out * w / (w + 1.0) + parent_output / (w + 1.0)


def child_leaf_output(sums, p: SplitParams, constr=None, parent_out=None):
    """A frontier child's leaf output from its (..., 3) [g, h, c] sums:
    smoothed toward ``parent_out`` (0 when None) under ``path_smooth``,
    then clamped to ``constr`` (..., 2) [min, max] when given (monotone
    constraints) — the grower's ``clamp_out``, also K6's commit."""
    out = leaf_output(sums[..., 0], sums[..., 1], p)
    if p.path_smooth > 0:
        out = smooth_output(out, sums[..., 2],
                            0.0 if parent_out is None else parent_out, p)
    if constr is None:
        return out
    return torch.clamp(out, constr[..., 0], constr[..., 1])


def monotone_penalty_factor(depth: int, penalization: float) -> np.float32:
    """reference ComputeMonotoneSplitGainPenalty,
    monotone_constraints.hpp:66-76, in the JAX package's f32 op order,
    for one depth."""
    f32 = np.float32
    d, p = f32(depth), f32(penalization)
    eps = f32(1e-10)
    if penalization >= depth + 1.0:
        return eps
    if penalization <= 1.0:
        return f32(f32(1.0) - p / f32(2.0) ** d) + eps
    return f32(f32(1.0) - f32(2.0) ** (p - f32(1.0) - d)) + eps


@functools.lru_cache(maxsize=16)
def _penalty_table(penalization: float, device: torch.device) -> torch.Tensor:
    n = int(np.ceil(max(penalization, 0.0))) + 66
    return torch.as_tensor(
        np.array([monotone_penalty_factor(d, penalization) for d in range(n)],
                 np.float32), device=device)


def monotone_penalty_factors(depth: torch.Tensor,
                             penalization: float) -> torch.Tensor:
    """(C,) f32 factors of the children's depths (C,), from one table made
    on the host (once a penalization and device): the split-scan kernel,
    K2 and the plain scan multiply by the same bits on any device.  Past
    ``penalization + 64`` every factor is 1.0 in f32, so the table stops
    there."""
    table = _penalty_table(float(penalization), depth.device)
    return table[depth.long().clamp(0, table.shape[0] - 1)]


class FeatureMeta(NamedTuple):
    """Per-feature bin metadata the scan reads, on the training device."""

    num_bins: torch.Tensor       # (F,) int64
    missing_type: torch.Tensor   # (F,) int64
    nan_bin: torch.Tensor        # (F,) int64 (-1 if none)
    zero_bin: torch.Tensor       # (F,) int64
    usable: torch.Tensor         # (F,) bool — not trivial
    # (F,) int64 -1 / 0 / +1 monotone direction; None: no constraint set
    monotone_type: Optional[torch.Tensor] = None
    # (F,) f32 feature_contri gain multipliers; None: not set
    contri: Optional[torch.Tensor] = None
    # what the kernels read, made once from the fields above by
    # ``with_tables`` (``make_feature_meta`` calls it): the (5, F) int32
    # feature table (``feature_table``) and the int32 monotone types (None
    # without constraints).  The card's wrappers refuse a meta without
    # them; a ``_replace`` of a field above goes through ``with_tables``
    # again.
    table: Optional[torch.Tensor] = None
    mono32: Optional[torch.Tensor] = None


def feature_table(meta: FeatureMeta) -> torch.Tensor:
    """The (5, F) int32 feature table the scans of K2, K6 and the
    split-scan kernel read: num_bins, missing_type, nan_bin, zero_bin,
    usable."""
    return torch.stack([meta.num_bins, meta.missing_type, meta.nan_bin,
                        meta.zero_bin, meta.usable.long()]) \
        .to(torch.int32).contiguous()


def with_tables(meta: FeatureMeta) -> FeatureMeta:
    """``meta`` with the kernels' int32 tables made from its fields, so a
    scan on the card runs no PyTorch op before its launch."""
    mono = meta.monotone_type
    return meta._replace(
        table=feature_table(meta),
        mono32=None if mono is None else mono.to(torch.int32).contiguous())


def make_feature_meta(dataset, device, monotone_constraints=None,
                      feature_contri=None) -> FeatureMeta:
    """The dataset's feature meta (JAX :173), with its kernel tables
    (``with_tables``).  ``monotone_type`` is None unless a constraint is
    nonzero (the JAX package's ``use_mc``), so a caller reads the monotone
    leg from the meta without a device read; ``contri`` is set whenever
    ``feature_contri`` is (ones past its length)."""
    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    F = len(dataset.num_bins)
    mono = None
    if monotone_constraints and any(monotone_constraints):
        m = np.zeros(F, np.int64)
        mc = np.asarray(list(monotone_constraints), np.int64)[:F]
        m[:len(mc)] = mc
        mono = t(m)
    contri = None
    if feature_contri:
        c = np.ones(F, np.float32)
        fc = np.asarray(list(feature_contri), np.float32)[:F]
        c[:len(fc)] = fc
        contri = t(c, torch.float32)
    return with_tables(FeatureMeta(
        num_bins=t(dataset.num_bins), missing_type=t(dataset.missing_types),
        nan_bin=t(dataset.nan_bins), zero_bin=t(dataset.zero_bins),
        usable=t(~np.asarray(dataset.is_trivial), torch.bool),
        monotone_type=mono, contri=contri))


class RandLeg(NamedTuple):
    """extra_trees' inputs of a scan of C leaves: the tree key (two uint32
    words, utils/prng.py), the leaves' uids (C,) int32 and extra_seed."""

    key: tuple
    uids: torch.Tensor
    extra_seed: int


def extra_rand_bins(rand: RandLeg, num_bins: torch.Tensor) -> torch.Tensor:
    """(C, F) int32 random thresholds (JAX :605-606): row c is
    ``uniform(fold_in(key, uids[c] + 1_000_003 + extra_seed), (F,))``
    times ``max(num_bins - 1, 1)``, one f32 multiply, truncated."""
    d = rand.uids.to(torch.int64) + 1_000_003 + int(rand.extra_seed)
    u = prng.uniform_folded(rand.key, d, num_bins.shape[0])
    m = (num_bins - 1).clamp(min=1).to(torch.float32)
    return (u * m[None, :]).to(torch.int32)


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


def gain_shift(parent_sum: torch.Tensor, params: SplitParams,
               parent_output=None):
    """(C,) parent gain + min_gain_to_split: every candidate's baseline.
    Under path smoothing the parent's gain is taken at its current
    (smoothed) output ``parent_output`` (C,) (JAX :515; None: 0)."""
    g, h = parent_sum[:, 0], parent_sum[:, 1]
    if params.path_smooth > 0:
        if parent_output is None:
            parent_output = torch.zeros_like(g)
        pg = leaf_gain_given_output(g, h, parent_output, params)
    else:
        pg = leaf_gain(g, h, params)
    return pg + params.min_gain_to_split


def scan_direction_gains(left2, parent_sum, meta: FeatureMeta,
                         feature_mask, params: SplitParams, constraint=None,
                         pfac=None, parent_output=None, rand_bin=None):
    """(C, 2, F, B) relative gains of every candidate (shift subtracted;
    ``-inf`` where a side misses min_data / min_hessian, the candidate
    does not exist or breaks its feature's monotone direction) and the
    (C,) shift.  With monotone constraints (``meta.monotone_type``) the
    outputs are clamped to ``constraint`` (C, 2) (``NO_CONSTRAINT`` when
    None); with path smoothing they are smoothed toward
    ``parent_output`` (C,) (0 when None); either way the gain is taken at
    those outputs (JAX :533-634).  Then, on finite gains, the
    ``meta.contri`` multiply and the monotone depth penalty ``pfac`` (C,)
    (``monotone_penalty_factors`` of the children's depths; None: no
    penalty) on monotone features.  ``rand_bin`` (C, F) (extra_trees,
    ``extra_rand_bins``): the one threshold of each feature that stays a
    candidate."""
    C, _, F, B, _ = left2.shape
    dev = left2.device
    use_mc = meta.monotone_type is not None
    use_smooth = params.path_smooth > 0
    if use_smooth and parent_output is None:
        parent_output = torch.zeros(C, dtype=left2.dtype, device=dev)
    tot = parent_sum[:, None, None, None, :]             # (C, 1, 1, 1, 3)
    lg, lh, lc = left2[..., 0], left2[..., 1], left2[..., 2]
    rg, rh, rc = tot[..., 0] - lg, tot[..., 1] - lh, tot[..., 2] - lc
    ok = ((lc >= params.min_data_in_leaf) & (rc >= params.min_data_in_leaf)
          & (lh >= params.min_sum_hessian_in_leaf)
          & (rh >= params.min_sum_hessian_in_leaf))
    if not use_mc and not use_smooth:
        gain = leaf_gain(lg, lh, params) + leaf_gain(rg, rh, params)
    else:
        out_l = leaf_output(lg, lh, params)
        out_r = leaf_output(rg, rh, params)
        if use_smooth:
            po = parent_output[:, None, None, None]
            out_l = smooth_output(out_l, lc, po, params)
            out_r = smooth_output(out_r, rc, po, params)
        if use_mc:
            if constraint is None:
                constraint = torch.tensor(NO_CONSTRAINT, dtype=left2.dtype,
                                          device=dev).expand(C, 2)
            lo = constraint[:, 0][:, None, None, None]
            hi = constraint[:, 1][:, None, None, None]
            out_l = torch.clamp(out_l, lo, hi)
            out_r = torch.clamp(out_r, lo, hi)
        gain = (leaf_gain_given_output(lg, lh, out_l, params)
                + leaf_gain_given_output(rg, rh, out_r, params))
        if use_mc:
            mono = meta.monotone_type[None, None, :, None]
            ok = ok & ~(((mono > 0) & (out_l > out_r))
                        | ((mono < 0) & (out_l < out_r)))
    neg_inf = torch.full((), NEG_INF, dtype=left2.dtype, device=dev)
    t_idx = torch.arange(B, device=dev)[None, :]
    has_miss_dir = (meta.missing_type == MISSING_NAN) | (
        meta.missing_type == MISSING_ZERO)
    base_valid = ((t_idx <= meta.num_bins[:, None] - 2)[None]
                  & (feature_mask & meta.usable[None, :])[:, :, None])
    if rand_bin is not None:
        base_valid = base_valid & (t_idx[None] == rand_bin[:, :, None])
    valid2 = torch.stack(
        [base_valid, base_valid & has_miss_dir[None, :, None]], dim=1)
    gains2 = torch.where(valid2 & ok, gain, neg_inf)
    shift = gain_shift(parent_sum, params, parent_output)
    gains = gains2 - shift[:, None, None, None]
    finite = torch.isfinite(gains)
    if meta.contri is not None:
        gains = torch.where(finite, gains * meta.contri[None, None, :, None],
                            gains)
    if use_mc and pfac is not None:
        mono_f = (meta.monotone_type != 0)[None, None, :, None]
        gains = torch.where(finite & mono_f,
                            gains * pfac[:, None, None, None], gains)
    return gains, shift


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


def scan_residue(hist, mask, csums, *, meta: FeatureMeta,
                 params: SplitParams, hist_scale=None, constraint=None,
                 pfac=None, parent_output=None, rand=None):
    """The per-feature half of the scan -> the children's (C, F, 6)
    residue: the staged scan's own stages (``scan_left_sums`` ->
    ``scan_direction_gains`` -> ``scan_pick_feature``) on ``hist`` (C, F,
    B, 3), ``mask`` (C, F) and ``csums`` (C, 3) (JAX
    ``child_scan_residue``, wave_fused.py:215).  Columns: the feature's
    best gain, the gain at its pick, the pick ``direction * B +
    threshold`` and the left sums there.  The plain version of the
    split-scan kernel (``ops/scan_cuda.py``) and of the scan stage of K2
    and K6.  ``rand`` (a ``RandLeg``; None: off): extra_trees' thresholds
    (``extra_rand_bins``)."""
    B = hist.shape[2]
    left2 = scan_left_sums(hist, meta, hist_scale)
    rand_bin = None if rand is None else extra_rand_bins(rand, meta.num_bins)
    gains, shift = scan_direction_gains(left2, csums, meta, mask, params,
                                        constraint, pfac, parent_output,
                                        rand_bin)
    fbest, sel = scan_pick_feature(gains, shift, meta)
    gains_f = torch.cat([gains[:, 0], gains[:, 1]], dim=2)   # (C, F, 2B)
    gsel = torch.gather(gains_f, 2, sel[..., None])[..., 0]
    C, F = hist.shape[:2]
    ci = torch.arange(C, device=hist.device)[:, None]
    fi = torch.arange(F, device=hist.device)[None, :]
    lsel = left2[ci, sel // B, fi, sel % B]                  # (C, F, 3)
    return torch.cat([fbest[..., None], gsel[..., None],
                      sel.to(torch.float32)[..., None], lsel], dim=2)


def pick_pack(residue_c, shift_c, parent_sum_c, meta: FeatureMeta,
              num_bins):
    """Cross-feature half of ``scan_pick`` on the children's (C, F, 6)
    residue, plus the tail of the scan (right sums, missing default
    direction): the (C, 10) packed SplitInfo [gain, feature, threshold,
    default_left, left g/h/c, right g/h/c] (JAX ``_pick_pack``,
    wave_fused.py:610).  ``find_best_split`` and the fused round finish
    their picks through it."""
    fbest = residue_c[..., 0]
    gsel = residue_c[..., 1]
    sel = residue_c[..., 2].long()
    gbest = fbest.max(dim=1).values                          # (C,)
    in_band = fbest >= (gbest - tie_tol(gbest, shift_c))[:, None]
    feature = torch.argmax(in_band.to(torch.uint8), dim=1)   # first
    ci = torch.arange(residue_c.shape[0], device=residue_c.device)
    best_gain = gsel[ci, feature]
    sc = sel[ci, feature]
    direction = sc // num_bins
    threshold = sc % num_bins
    left = residue_c[ci, feature, 3:6]
    right = parent_sum_c - left
    mtype = meta.missing_type[feature]
    default_left = ((mtype == MISSING_NAN) | (mtype == MISSING_ZERO)) \
        & (direction == 1)
    rel_gain = torch.where(torch.isfinite(best_gain), best_gain,
                           torch.full_like(best_gain, NEG_INF))
    f32 = torch.float32
    return torch.cat([rel_gain.to(f32)[:, None], feature.to(f32)[:, None],
                      threshold.to(f32)[:, None],
                      default_left.to(f32)[:, None], left.to(f32),
                      right.to(f32)], dim=1)


def unpack_children(packed: torch.Tensor, num_bins: int) -> SplitResult:
    """(C, 10) packed rows (``pick_pack``) -> batched SplitResult: views
    of the rows and two casts (feature and threshold in one)."""
    ints = packed[:, 1:3].long()
    return SplitResult(gain=packed[:, 0], feature=ints[:, 0],
                       threshold_bin=ints[:, 1],
                       default_left=packed[:, 3] != 0,
                       left_sum=packed[:, 4:7], right_sum=packed[:, 7:10])


def scan_inputs(meta: FeatureMeta, params: SplitParams, C, dev,
                constraint=None, depth=None, parent_output=None) -> dict:
    """The constrained legs' per-child inputs of a scan of C children, as
    the split-scan kernel, K2 and the plain versions take them:
    ``constraint`` (C, 2) f32 and the penalty factors ``pfac`` (C,)
    under monotone constraints (``pfac`` only with ``monotone_penalty``,
    ``depth`` None: 0), ``parent_output`` (C,) f32 under path smoothing.
    None where a leg is off or not given: the kernels and the plain
    versions read a None ``constraint`` as ``NO_CONSTRAINT`` and a None
    ``parent_output`` as 0.  Without constraints, penalty or given legs
    it runs no PyTorch op."""
    f32 = torch.float32
    out = dict(constraint=None, pfac=None, parent_output=None)
    if meta.monotone_type is not None:
        if constraint is not None:
            out["constraint"] = constraint.to(f32).contiguous()
        if params.monotone_penalty > 0:
            d = (depth if depth is not None
                 else torch.zeros(C, dtype=torch.int64, device=dev))
            out["pfac"] = monotone_penalty_factors(d, params.monotone_penalty)
    if params.path_smooth > 0 and parent_output is not None:
        out["parent_output"] = parent_output.to(f32).contiguous()
    return out


def rand_leg(params: SplitParams, key, uids, C, dev) -> Optional[RandLeg]:
    """extra_trees' ``RandLeg`` of a scan of C leaves whose uids are
    ``uids`` (a (C,) tensor or a sequence) under the tree ``key``; None
    without extra_trees or without a key (JAX: no ``rand_key``, no
    draw)."""
    if not params.extra_trees or key is None or uids is None:
        return None
    u = torch.as_tensor(uids, device=dev).to(torch.int32).reshape(-1)
    if u.shape[0] != C:
        raise ValueError(f"{u.shape[0]} uids for {C} leaves")
    return RandLeg((int(key[0]), int(key[1])), u.contiguous(),
                   int(params.extra_seed))


def find_best_split(hist: torch.Tensor, parent_sum: torch.Tensor,
                    meta: FeatureMeta, feature_mask: torch.Tensor,
                    params: SplitParams, hist_scale=None, constraint=None,
                    depth=None, parent_output=None, key=None,
                    uids=None) -> SplitResult:
    """Best numerical split of each of C leaves: ``hist`` (C, F, B, 3),
    ``parent_sum`` (C, 3), ``feature_mask`` (C, F) bool; ``hist_scale``
    (C, 3): ``hist`` holds quantized integer sums, dequantized after the
    cumulative sum (``scan_left_sums``).  ``constraint`` (C, 2) [min, max]
    output bounds (None: ``NO_CONSTRAINT``) and ``depth`` (C,) (the
    monotone penalty; None: 0) are read under monotone constraints,
    ``parent_output`` (C,) the leaves' current outputs (None: 0) under
    path smoothing, the tree ``key`` and the leaves' ``uids`` (C,) under
    extra_trees (JAX :437, vmapped, its ``rand_key`` ``fold_in(key, uid +
    1_000_003 + extra_seed)``).  On a CUDA tensor one launch of the
    split-scan kernel computes the residue and the pick
    (``scan_cuda.split_scan_pick``); on a CPU tensor its plain version,
    ``pick_pack`` on ``scan_residue``."""
    from . import scan_cuda

    C, _, B, _ = hist.shape
    legs = scan_inputs(meta, params, C, hist.device, constraint, depth,
                       parent_output)
    if feature_mask.stride() != (0, 1):      # a broadcast row stays so
        feature_mask = feature_mask.contiguous()
    packed = scan_cuda.split_scan_pick(
        hist.contiguous(), feature_mask, parent_sum.contiguous(),
        meta=meta, params=params,
        hist_scale=None if hist_scale is None else hist_scale.contiguous(),
        rand=rand_leg(params, key, uids, C, hist.device), **legs)
    return unpack_children(packed, B)
