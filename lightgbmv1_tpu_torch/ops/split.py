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
Categorical splits (JAX :281 ``_best_categorical``, merged at
:721-740): ``best_categorical`` on each leaf's histograms, one-vs-rest
or the sorted two-direction scan, its left set packed as a bin-space
bitset (``pack_bitset``), merged into the numerical pick where strictly
better (``merge_categorical``); the numerical scan skips categorical
features (``numerical_usable``).  On the card it is the split-scan
kernel's categorical leg (``csrc/split_scan_cat.cu``).  CEGB (JAX
:627-628, :339-340, :399-400): a (C, F) penalty subtracted from the
finite numerical gains after the contri multiply and from every
categorical candidate.

``per_feature_best_gain`` (JAX :767) is the voting learner's score: each
feature's best numerical gain relative to the parent's, under the
reference's plain gain (no constraint or smoothing of the children),
contri applied; plain PyTorch, as the JAX package runs it in XLA.
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
    # categorical splits (reference FindBestThresholdCategoricalInner,
    # feature_histogram.hpp:278-460)
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    min_data_per_group: float = 100.0
    # CEGB (reference cost_effective_gradient_boosting.hpp DetlaGain)
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0


class SplitResult(NamedTuple):
    """Batched over the leading axis C."""

    gain: torch.Tensor           # (C,) f32 relative gain; <= 0: no split
    feature: torch.Tensor        # (C,) int64
    threshold_bin: torch.Tensor  # (C,) int64 — bin <= threshold goes left
    default_left: torch.Tensor   # (C,) bool — missing-value direction
    left_sum: torch.Tensor       # (C, 3) [grad, hess, count]
    right_sum: torch.Tensor      # (C, 3)
    # categorical splits (None when the data has no categorical feature):
    # (C,) bool, and (C, W) int32 bin-space bitsets (uint32 words, bit b
    # of word w set: bin 32 w + b goes left; W = ceil(B / 32))
    is_cat: Optional[torch.Tensor] = None
    cat_bitset: Optional[torch.Tensor] = None


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
    # (F,) bool categorical features; None: the data has none.  Its
    # kernel table ``cat32`` (the usable categorical features' indices,
    # (n,) int32) is made by ``with_tables``.
    is_categorical: Optional[torch.Tensor] = None
    cat32: Optional[torch.Tensor] = None


def numerical_usable(meta: FeatureMeta) -> torch.Tensor:
    """(F,) bool: the usable features the numerical scan reads (JAX
    :621 ``numerical_ok``: a categorical feature is scanned by the
    categorical leg alone)."""
    if meta.is_categorical is None:
        return meta.usable
    return meta.usable & ~meta.is_categorical


def feature_table(meta: FeatureMeta) -> torch.Tensor:
    """The (5, F) int32 feature table the scans of K2, K6 and the
    split-scan kernel read: num_bins, missing_type, nan_bin, zero_bin,
    and usable for the numerical scan (``numerical_usable``)."""
    return torch.stack([meta.num_bins, meta.missing_type, meta.nan_bin,
                        meta.zero_bin, numerical_usable(meta).long()]) \
        .to(torch.int32).contiguous()


def with_tables(meta: FeatureMeta) -> FeatureMeta:
    """``meta`` with the kernels' int32 tables made from its fields, so a
    scan on the card runs no PyTorch op before its launch."""
    mono = meta.monotone_type
    cat = meta.is_categorical
    return meta._replace(
        table=feature_table(meta),
        mono32=None if mono is None else mono.to(torch.int32).contiguous(),
        cat32=(None if cat is None else (cat & meta.usable).nonzero()[:, 0]
               .to(torch.int32).contiguous()))


def make_feature_meta(dataset, device, monotone_constraints=None,
                      feature_contri=None) -> FeatureMeta:
    """The dataset's feature meta (JAX :173), with its kernel tables
    (``with_tables``).  ``monotone_type`` is None unless a constraint is
    nonzero (the JAX package's ``use_mc``), so a caller reads the monotone
    leg from the meta without a device read; ``contri`` is set whenever
    ``feature_contri`` is (ones past its length); ``is_categorical``
    where the data has a categorical feature."""
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
    is_cat = np.asarray(getattr(dataset, "is_categorical",
                                np.zeros(F, bool)), bool)
    return with_tables(FeatureMeta(
        num_bins=t(dataset.num_bins), missing_type=t(dataset.missing_types),
        nan_bin=t(dataset.nan_bins), zero_bin=t(dataset.zero_bins),
        usable=t(~np.asarray(dataset.is_trivial), torch.bool),
        monotone_type=mono, contri=contri,
        is_categorical=t(is_cat, torch.bool) if is_cat.any() else None))


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
                         pfac=None, parent_output=None, rand_bin=None,
                         cegb=None):
    """(C, 2, F, B) relative gains of every candidate (shift subtracted;
    ``-inf`` where a side misses min_data / min_hessian, the candidate
    does not exist or breaks its feature's monotone direction) and the
    (C,) shift.  With monotone constraints (``meta.monotone_type``) the
    outputs are clamped to ``constraint`` (C, 2) (``NO_CONSTRAINT`` when
    None); with path smoothing they are smoothed toward
    ``parent_output`` (C,) (0 when None); either way the gain is taken at
    those outputs (JAX :533-634).  Then, on finite gains, the
    ``meta.contri`` multiply, the CEGB penalty ``cegb`` (C, F) subtracted
    (JAX :627-628) and the monotone depth penalty ``pfac`` (C,)
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
                  & (feature_mask & numerical_usable(meta)[None, :])
                  [:, :, None])
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
    if cegb is not None:
        gains = torch.where(finite, gains - cegb[:, None, :, None], gains)
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
                 pfac=None, parent_output=None, rand=None, cegb=None):
    """The per-feature half of the scan -> the children's (C, F, 6)
    residue: the staged scan's own stages (``scan_left_sums`` ->
    ``scan_direction_gains`` -> ``scan_pick_feature``) on ``hist`` (C, F,
    B, 3), ``mask`` (C, F) and ``csums`` (C, 3) (JAX
    ``child_scan_residue``, wave_fused.py:215).  Columns: the feature's
    best gain, the gain at its pick, the pick ``direction * B +
    threshold`` and the left sums there.  The plain version of the
    split-scan kernel (``ops/scan_cuda.py``) and of the scan stage of K2
    and K6.  ``rand`` (a ``RandLeg``; None: off): extra_trees' thresholds
    (``extra_rand_bins``); ``cegb`` (C, F): the CEGB penalties."""
    B = hist.shape[2]
    left2 = scan_left_sums(hist, meta, hist_scale)
    rand_bin = None if rand is None else extra_rand_bins(rand, meta.num_bins)
    gains, shift = scan_direction_gains(left2, csums, meta, mask, params,
                                        constraint, pfac, parent_output,
                                        rand_bin, cegb)
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


# the hessian nudge of the categorical scan (JAX :295 ``eps``)
CAT_EPS = 1e-15


def bitset_words(num_bins: int) -> int:
    """W = ceil(num_bins / 32): the uint32 words of a bin-space bitset."""
    return -(-int(num_bins) // 32)


def pack_bitset(member: torch.Tensor) -> torch.Tensor:
    """(..., B) bool membership -> (..., W) int32 bitset words holding the
    uint32 bit patterns (JAX ``_pack_bitset`` :242)."""
    B = member.shape[-1]
    W = bitset_words(B)
    m = torch.nn.functional.pad(member.to(torch.int64), (0, W * 32 - B))
    m = m.reshape(member.shape[:-1] + (W, 32))
    shifts = torch.arange(32, dtype=torch.int64, device=member.device)
    words = (m << shifts).sum(dim=-1)
    return (((words + (1 << 31)) % (1 << 32)) - (1 << 31)).to(torch.int32)


def bitset_contains(bitset: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """Vectorized FindInBitset (JAX ``bitset_contains`` :251): ``bitset``
    (..., W) int32 words, ``bins`` (...,) -> True where the bin's bit is
    set."""
    b = bins.long()
    words = bitset.long().expand(*b.shape, bitset.shape[-1])
    word = torch.gather(words, -1, (b >> 5)[..., None])[..., 0]
    return ((word >> (b & 31)) & 1) == 1


def cat_go_left(bins, bitset, is_cat, numeric_left):
    """The decision of a split on integer bins: bitset membership where
    ``is_cat``, else the numerical ``numeric_left`` (JAX grower.py
    :303-315, tree.py:183-189); ``bitset`` (..., W) broadcast against
    ``bins``."""
    if is_cat is None:
        return numeric_left
    return torch.where(is_cat, bitset_contains(bitset, bins), numeric_left)


def cat_rand_draws(rand: RandLeg, F: int) -> torch.Tensor:
    """(C, 2, F) f32 uniforms of the categorical extra_trees draw (JAX
    :315-317): ``uniform(fold_in(rand_key, 7), (2, F))`` under each
    leaf's ``rand_key = fold_in(tree_key, uid + 1_000_003 +
    extra_seed)``."""
    d = rand.uids.to(torch.int64) + 1_000_003 + int(rand.extra_seed)
    return prng.uniform_folded(rand.key, d, 2 * F, then=7).reshape(-1, 2, F)


def _cat_split_gain(lg, lh, rg, rh, lc, rc, p: SplitParams, use_mc, lo, hi,
                    pout):
    """JAX ``_cat_split_gain`` (:259): the two sides' gains, at their
    outputs smoothed toward ``pout`` and clamped to [lo, hi] under path
    smoothing / monotone constraints (no monotone direction check)."""
    use_smooth = p.path_smooth > 0
    if not use_mc and not use_smooth:
        return leaf_gain(lg, lh, p) + leaf_gain(rg, rh, p)
    out_l = leaf_output(lg, lh, p)
    out_r = leaf_output(rg, rh, p)
    if use_smooth:
        out_l = smooth_output(out_l, lc, pout, p)
        out_r = smooth_output(out_r, rc, pout, p)
    if use_mc:
        out_l = torch.clamp(out_l, lo, hi)
        out_r = torch.clamp(out_r, lo, hi)
    return (leaf_gain_given_output(lg, lh, out_l, p)
            + leaf_gain_given_output(rg, rh, out_r, p))


def best_categorical(hist, csums, meta: FeatureMeta, mask,
                     params: SplitParams, shift, constraint=None,
                     parent_output=None, rand: Optional[RandLeg] = None,
                     cegb=None):
    """The best categorical split of each of C leaves (JAX
    ``_best_categorical`` :281, vmapped): ``hist`` (C, F, B, 3)
    (dequantized), ``csums`` (C, 3), ``mask`` (C, F), ``shift`` (C,) the
    numerical scan's.  One-vs-rest on features of at most
    ``max_cat_to_onehot`` bins; otherwise the bins of at least
    ``cat_smooth`` rows sorted by g / (h + cat_smooth) (stable) and
    scanned from both ends at ``lambda_l2 + cat_l2``, at most
    ``max_cat_threshold`` positions, a position evaluated once
    ``min_data_per_group`` rows gathered since the last one.  The
    trailing bin (other / unseen / NaN) never joins the left set.  The
    relative gains take the contri multiply and the CEGB penalty ``cegb``
    (C, F); the first best in the JAX flat order (one-vs-rest, then the
    forward scan, then the backward, each feature-major) wins.  Returns
    the gain (C,), feature (C,), left sums (C, 3) and bitset (C, W)."""
    C, F, B, _ = hist.shape
    dev = hist.device
    f32 = torch.float32
    eps = CAT_EPS
    use_mc = meta.monotone_type is not None
    g, h, c = hist[..., 0], hist[..., 1], hist[..., 2]           # (C, F, B)
    tg = csums[:, 0][:, None, None]
    th = csums[:, 1][:, None, None]
    tc = csums[:, 2][:, None, None]
    lo = hi = None
    if use_mc:
        if constraint is None:
            constraint = torch.tensor(NO_CONSTRAINT, dtype=f32,
                                      device=dev).expand(C, 2)
        lo, hi = constraint[:, 0], constraint[:, 1]
    pout = (parent_output if parent_output is not None
            else torch.zeros(C, dtype=f32, device=dev))
    t_idx = torch.arange(B, device=dev)
    nb = meta.num_bins[None, :, None]
    fmask = (mask & meta.usable[None, :]
             & meta.is_categorical[None, :])[:, :, None]
    bin_ok = (t_idx < nb - 1) & fmask
    use_onehot = nb <= params.max_cat_to_onehot                  # (1, F, 1)
    ku = cat_rand_draws(rand, F) if rand is not None else None   # (C, 2, F)
    neg_inf = torch.full((), NEG_INF, dtype=f32, device=dev)
    md, mh = params.min_data_in_leaf, params.min_sum_hessian_in_leaf

    # ---- one-vs-rest (JAX :320-349) ---------------------------------------
    oth_g, oth_h, oth_c = tg - g, th - h, tc - c
    ok1 = (bin_ok & use_onehot & (c >= md) & (h >= mh) & (oth_c >= md)
           & ((oth_h - eps) >= mh))
    if ku is not None:
        m1 = (meta.num_bins - 1).clamp(min=1).to(f32)
        rb1 = (ku[:, 0] * m1[None, :]).to(torch.int32)           # (C, F)
        ok1 = ok1 & (t_idx == rb1[..., None])
    c3 = (lambda x: x[:, None, None]) if use_mc else (lambda x: None)
    gain1 = _cat_split_gain(g, h + eps, oth_g, oth_h - eps, c, oth_c, params,
                            use_mc, c3(lo), c3(hi), pout[:, None, None]) \
        - shift[:, None, None]
    if meta.contri is not None:
        gain1 = gain1 * meta.contri[None, :, None]
    if cegb is not None:
        gain1 = gain1 - cegb[:, :, None]
    gain1 = torch.where(ok1, gain1, neg_inf)

    # ---- the sorted two-direction scan (JAX :351-401) ---------------------
    l2cat = params._replace(lambda_l2=params.lambda_l2 + params.cat_l2)
    valid = bin_ok & ~use_onehot & (c >= params.cat_smooth)
    ratio = torch.where(valid, g / (h + params.cat_smooth),
                        torch.full((), float("inf"), dtype=f32, device=dev))
    order = torch.argsort(ratio, dim=2, stable=True)             # valid first
    used = valid.sum(dim=2)                                      # (C, F)
    sg = torch.gather(g, 2, order)
    sh = torch.gather(h, 2, order)
    sc = torch.gather(c, 2, order)
    bwd = (used[..., None] - 1 - t_idx).clamp(0, B - 1)
    sg2 = torch.stack([sg, torch.gather(sg, 2, bwd)], dim=1)      # (C,2,F,B)
    sh2 = torch.stack([sh, torch.gather(sh, 2, bwd)], dim=1)
    sc2 = torch.stack([sc, torch.gather(sc, 2, bwd)], dim=1)
    clg = torch.cumsum(sg2, dim=3)
    clh = torch.cumsum(sh2, dim=3) + eps
    clc = torch.cumsum(sc2, dim=3)
    tg4, th4, tc4 = tg[:, None], th[:, None], tc[:, None]
    crg, crh, crc = tg4 - clg, th4 - clh, tc4 - clc
    mnc = torch.clamp((used + 1) // 2, max=int(params.max_cat_threshold))
    t4 = t_idx[None, None, None, :]
    pos_ok = ((t4 < mnc[:, None, :, None]) & (t4 < used[:, None, :, None])
              & (clc >= md) & (clh >= mh) & (crc >= md)
              & (crc >= params.min_data_per_group) & (crh >= mh))
    if ku is not None:
        max_thr = (torch.minimum(mnc, used) - 1).clamp(min=0)
        rp = (ku[:, 1] * max_thr.clamp(min=1).to(f32)).to(torch.int32)
        pos_ok = pos_ok & (t4 == rp[:, None, :, None])
    # min_data_per_group: a position is evaluated once enough rows gathered
    # since the last evaluated one (JAX :383-392, sequential)
    n_steps = min(B, int(params.max_cat_threshold))
    can = torch.zeros_like(pos_ok)
    grp = torch.zeros((C, 2, F), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    for i in range(n_steps):
        grp = grp + sc2[..., i]
        ci = pos_ok[..., i] & (grp >= params.min_data_per_group)
        grp = torch.where(ci, zero, grp)
        can[..., i] = ci
    c4 = (lambda x: x[:, None, None, None]) if use_mc else (lambda x: None)
    gain2 = _cat_split_gain(clg, clh, crg, crh, clc, crc, l2cat, use_mc,
                            c4(lo), c4(hi), pout[:, None, None, None]) \
        - shift[:, None, None, None]
    if meta.contri is not None:
        gain2 = gain2 * meta.contri[None, None, :, None]
    if cegb is not None:
        gain2 = gain2 - cegb[:, None, :, None]
    gain2 = torch.where(can, gain2, neg_inf)

    # ---- the pick and its left set (JAX :403-433) --------------------------
    flat = torch.cat([gain1.reshape(C, -1), gain2.reshape(C, -1)], dim=1)
    best = torch.argmax(flat, dim=1)
    ci = torch.arange(C, device=dev)
    best_gain = flat[ci, best]
    FB = F * B
    from_onehot = best < FB
    idx2 = (best - FB).clamp(min=0)
    direction = idx2 // FB
    feat = torch.where(from_onehot, (best // B) % F, (idx2 // B) % F)
    pos = torch.where(from_onehot, best % B, idx2 % B)
    left1 = hist[ci, feat, pos] + torch.tensor([0.0, eps, 0.0], dtype=f32,
                                               device=dev)
    left2 = torch.stack([clg[ci, direction, feat, pos],
                         clh[ci, direction, feat, pos],
                         clc[ci, direction, feat, pos]], dim=1)
    left = torch.where(from_onehot[:, None], left1, left2)
    ub = used[ci, feat][:, None]
    p1 = pos[:, None]
    member_pos = torch.where(direction[:, None] == 0, t_idx[None] <= p1,
                             (t_idx[None] >= ub - 1 - p1) & (t_idx[None] < ub))
    member_sorted = torch.zeros((C, B), dtype=torch.bool, device=dev) \
        .scatter(1, order[ci, feat], member_pos)
    member = torch.where(from_onehot[:, None], t_idx[None] == p1,
                         member_sorted)
    return best_gain, feat, left, pack_bitset(member)


def merge_categorical(packed, csums, cgain, cfeat, cleft, cbits):
    """The numerical pick's (C, PACK) rows merged with the categorical
    candidates where they are strictly better (JAX :721-740, ``cgain >
    best_gain``): gain, feature, threshold 0, default_left off, the left
    sums and right = sums - left.  Returns the rows and the (C, 1 + W)
    int32 ``cat_out`` [is_cat, bitset words] (zeros where numerical)."""
    num_gain = packed[:, 0]
    use = cgain > num_gain
    gain = torch.maximum(num_gain, cgain)
    gain = torch.where(torch.isfinite(gain), gain,
                       torch.full_like(gain, NEG_INF))
    u = use[:, None]
    f32 = torch.float32
    left = torch.where(u, cleft, packed[:, 4:7])
    out = torch.cat([
        gain[:, None],
        torch.where(use, cfeat.to(f32), packed[:, 1])[:, None],
        torch.where(use, torch.zeros_like(gain), packed[:, 2])[:, None],
        torch.where(use, torch.zeros_like(gain), packed[:, 3])[:, None],
        left, torch.where(u, csums - cleft, packed[:, 7:10])], dim=1)
    cat_out = torch.cat([use.to(torch.int32)[:, None],
                         torch.where(u, cbits, torch.zeros_like(cbits))],
                        dim=1)
    return out, cat_out


def unpack_cat(res: SplitResult, cat_out) -> SplitResult:
    """``res`` with the categorical leg's (C, 1 + W) ``cat_out`` (None:
    no categorical feature)."""
    if cat_out is None:
        return res
    return res._replace(is_cat=cat_out[:, 0] != 0, cat_bitset=cat_out[:, 1:])


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
                    uids=None, cegb=None) -> SplitResult:
    """Best numerical split of each of C leaves: ``hist`` (C, F, B, 3),
    ``parent_sum`` (C, 3), ``feature_mask`` (C, F) bool; ``hist_scale``
    (C, 3): ``hist`` holds quantized integer sums, dequantized after the
    cumulative sum (``scan_left_sums``).  ``constraint`` (C, 2) [min, max]
    output bounds (None: ``NO_CONSTRAINT``) and ``depth`` (C,) (the
    monotone penalty; None: 0) are read under monotone constraints,
    ``parent_output`` (C,) the leaves' current outputs (None: 0) under
    path smoothing, the tree ``key`` and the leaves' ``uids`` (C,) under
    extra_trees (JAX :437, vmapped, its ``rand_key`` ``fold_in(key, uid +
    1_000_003 + extra_seed)``), the CEGB penalties ``cegb`` (C, F) f32
    under CEGB (JAX's ``cegb_penalty``, the grower's).  On a CUDA tensor
    one launch of the split-scan kernel computes the residue and the pick
    (``scan_cuda.split_scan_pick``); on a CPU tensor its plain version,
    ``pick_pack`` on ``scan_residue``.  Where the data has a categorical
    feature (``meta.is_categorical``), the categorical leg then merges its
    candidates into the pick (``scan_cuda.split_scan_cat``, a second
    launch; plain version ``best_categorical`` + ``merge_categorical``)
    and the result carries ``is_cat`` and ``cat_bitset``."""
    from . import scan_cuda

    C, _, B, _ = hist.shape
    legs = scan_inputs(meta, params, C, hist.device, constraint, depth,
                       parent_output)
    if feature_mask.stride() != (0, 1):      # a broadcast row stays so
        feature_mask = feature_mask.contiguous()
    hist = hist.contiguous()
    csums = parent_sum.contiguous()
    hscale = None if hist_scale is None else hist_scale.contiguous()
    rand = rand_leg(params, key, uids, C, hist.device)
    if cegb is not None:
        cegb = cegb.to(torch.float32).contiguous()
    packed = scan_cuda.split_scan_pick(
        hist, feature_mask, csums, meta=meta, params=params,
        hist_scale=hscale, rand=rand, cegb=cegb, **legs)
    cat_out = None
    if meta.is_categorical is not None:
        packed, cat_out = scan_cuda.split_scan_cat(
            hist, feature_mask, csums, packed, meta=meta, params=params,
            hist_scale=hscale, constraint=legs["constraint"],
            parent_output=legs["parent_output"], rand=rand, cegb=cegb)
    return unpack_cat(unpack_children(packed, B), cat_out)


def per_feature_best_gain(hist: torch.Tensor, parent_sum: torch.Tensor,
                          meta: FeatureMeta, feature_mask: torch.Tensor,
                          params: SplitParams, parent_output=None
                          ) -> torch.Tensor:
    """(C, F) best numerical split gain of each feature of each of C
    leaves (-inf where none), relative to the parent's gain plus
    ``min_gain_to_split`` and times ``meta.contri`` (JAX :767, the PV-Tree
    vote's score; reference voting_parallel_tree_learner.cpp:300-310):
    ``hist`` (C, F, B, 3), ``parent_sum`` (C, 3), ``feature_mask`` (C, F),
    ``parent_output`` (C,) (path smoothing; None: 0).  Both missing-value
    directions are scanned as the full search scans them."""
    C, F, B, _ = hist.shape
    dev = hist.device
    tg, th = parent_sum[:, 0, None, None], parent_sum[:, 1, None, None]
    tc = parent_sum[:, 2, None, None]
    t_idx = torch.arange(B, device=dev)[None, :]
    nb = meta.num_bins[:, None]
    is_nan_f = (meta.missing_type == MISSING_NAN)[:, None]
    is_zero_f = (meta.missing_type == MISSING_ZERO)[:, None]

    def gains_for(left):
        lg, lh, lc = left[..., 0], left[..., 1], left[..., 2]
        rg, rh, rc = tg - lg, th - lh, tc - lc
        ok = ((lc >= params.min_data_in_leaf)
              & (rc >= params.min_data_in_leaf)
              & (lh >= params.min_sum_hessian_in_leaf)
              & (rh >= params.min_sum_hessian_in_leaf))
        gain = leaf_gain(lg, lh, params) + leaf_gain(rg, rh, params)
        return torch.where(ok, gain, torch.full_like(gain, NEG_INF))

    usable = numerical_usable(meta)
    valid = ((t_idx <= nb - 2) & usable[:, None])[None] \
        & feature_mask[:, :, None]
    left = scan_left_sums(hist, meta)
    neg = torch.full((), NEG_INF, dtype=hist.dtype, device=dev)
    ga = torch.where(valid, gains_for(left[:, 0]), neg)
    gb = torch.where(valid & (is_nan_f | is_zero_f)[None],
                     gains_for(left[:, 1]), neg)
    best = torch.maximum(ga.max(dim=2).values, gb.max(dim=2).values)
    shift = gain_shift(parent_sum, params, parent_output)[:, None]
    fin = torch.isfinite(best)
    best = torch.where(fin, best - shift, best)
    if meta.contri is not None:
        best = torch.where(fin, best * meta.contri[None, :], best)
    return best
