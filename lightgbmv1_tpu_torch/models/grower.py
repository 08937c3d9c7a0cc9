"""Sequential (best-first) and level-wise tree growth, eager PyTorch.

Port of lightgbmv1_tpu/models/grower.py ``make_leafwise_grower`` (:153)
and ``make_levelwise_grower`` (:742).  Both grow on the training device;
their histograms come from ``hist_fn`` / ``hist_frontier_fn``, the CUDA
kernel K1 on the card (ops/hist_cuda.py), and their split scans are one
batched ``ops/split.py`` call a step.

* **Sequential** (the reference's SerialTreeLearner::Train order,
  serial_tree_learner.cpp:152-202): one split a step, the leaf of the best
  gain, until ``num_leaves`` or no positive gain.  The smaller child's
  histogram is K1 at one slot; the larger is the parent's minus it (the
  histogram pool, reference HistogramPool), or, where the pool would pass
  ``hist_pool_mb`` (``histogram_pool_size``; 512 MB when unset), both
  children are histogrammed (pool-free, JAX :273-293).
  ``partition=True`` keeps the rows grouped by leaf in one row order
  (reference DataPartition, data_partition.hpp:101-120): a split
  partitions its parent's segment stably, and the smaller child's
  histogram runs on that segment's rows gathered at their exact count,
  where the JAX package slices a static capacity picked by ``lax.switch``
  and zeroes the rows past the count.  ``partition=False``
  (``tree_growth=leafwise_masked``) masks the rows of all ``N`` to the
  child instead.  The two passes over the rows (the root's, and each
  split's routing and children's histograms) are objects,
  ``PartitionRows`` and ``MaskedRows``; the out-of-core trainer grows
  the same trees with its own, which fold the masked passes over row
  blocks (models/grower_stream.py).  The JAX ``fori_loop`` with its
  latched ``done`` flag becomes a Python loop that reads each step's
  best gain on the host and stops at the first that is not positive.
* **Level-wise** (depth-wise, the whole frontier at once): a level's
  leaves are histogrammed in one K1 pass, each split scanned in one
  batched call, and the positive gains ranked under the ``num_leaves``
  budget (a stable sort, ties to the lower leaf, as ``jnp.argsort``).  A
  leaf that does not split at its level is not split later.  From the
  second level the pass labels only the smaller child of each of the last
  level's splits (its slot), with one dead slot for every other row, and
  the sibling is the parent's histogram minus it (JAX :880-920), while
  the level's histogram state stays under 512 MB.

Both take ``packed``: ``binned`` holds 4-bit packed bytes
(``bin_layout=packed4``), the histograms' callables read them (K1's packed
leg) and the partitions decode their split feature's nibble
(``hist_cuda.bins_of_feat`` / ``bins_of_rows``).  Both take ``bundle``
(EFB, the JAX growers' ``split_fn`` / ``bins_of_fn`` of the bundle
path): ``binned`` holds the bundle columns, the histograms (and the pool
and the level's carried histograms) are over them, each scan reads them
expanded to the original features (``expand_bundle_hist``, on the
scanned nodes' sums) and the partitions decode their feature's bin from
its bundle column.

Both run ``basic`` monotone constraints (JAX :549-570, :1053-1073;
``intermediate`` runs on the wave grower, the trainer resolves it):
each leaf's [min, max] output bound, its children's outputs clamped to
it and their bounds cut at the midpoint of the two outputs
(``BasicLeafConstraints::Update``); a scan takes its leaves' bounds,
depths (the sequential grower's own, the level's on the level-wise one,
as the JAX package passes them) and current outputs (path smoothing).
The root's output is smoothed toward 0 under ``path_smooth``.

Per-node feature sampling (``feature_fraction_bynode < 1``, JAX :139
``_node_feature_mask``) draws each node's mask from the tree's features
(``base_mask``, the per-tree sample) with the JAX package's stream:
``uniform(fold_in(tree_key, uid), (F,))``, the k smallest of the tree's
features kept, k = max(1, ceil(fraction * n)) in float32; the uids are
the JAX growers' (the sequential grower's root 0 and step s's children
2s + 1 and 2s + 2; the level-wise grower's d * 2L + i for leaf i of
level d), and ``grow`` takes the tree's ``key``.  The level-wise
grower's int8 passes (``hist_dtype=int8``) read the tree's rows rounded
once a row tile (``quantize.NearestRows``); the sequential grower masks
its rows to a leaf first, so its passes round their own rows.

extra_trees (JAX :246-249, :822-825) draws each scanned node's
thresholds under the tree's ``key`` for the same uids as the per-node
masks (``find_best_split(..., key=, uids=)``).

Categorical splits (``meta.is_categorical``, JAX :303-315, :1033-1041):
the scan's categorical leg picks them, a partition sends a row left by
its bin's bit in the split's bin-space bitset (``split_go_left``), and
the tree keeps ``is_cat`` and ``cat_bitset``; a categorical split cuts no
monotone bound.  Interaction constraints (JAX :127
``allowed_features_for``): each node's mask keeps the features its
branch allows.  CEGB (JAX :218-243, ``Cegb``): each scan subtracts its
nodes' penalties — ``tradeoff * penalty_split`` a row, the coupled
penalty of each feature the model has not used, and (sequential, masked
rows) the lazy penalty of each row not yet charged for a feature; the
model's used features and the charged rows come in as ``cegb_used`` and
grow with each split.  Forced splits (JAX :481-531, :942-1000): the (S,
6) BFS steps of ``parallel.trainer.parse_forced_splits`` split first
(the sequential grower's first S steps, the level-wise grower's leaves
at each step's depth, ranked before the budget), each at its actual
gain from the leaf's histogram (``forced_split_stats``); a step that
would leave a child empty is skipped with every step below it.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..io.bundle import expand_bundle_hist
from ..ops.hist_cuda import bins_of_feat, bins_of_rows
from ..ops.histogram import root_sums
from ..ops.quantize import NearestRows
from ..io.binning import MISSING_NAN, MISSING_ZERO
from ..ops.split import (NEG_INF, NO_CONSTRAINT, FeatureMeta, SplitParams,
                         bitset_words, cat_go_left, child_leaf_output,
                         find_best_split, go_left_rule, leaf_gain,
                         leaf_output, smooth_output)
from ..utils import prng
from ..utils.log import log_info
from .tree import empty_tree

# the auto cap of the sequential grower's histogram pool and of the
# level-wise grower's carried level histograms (JAX :281, :878)
_POOL_AUTO_BYTES = 512.0 * (1 << 20)


def node_feature_masks(key, uids, base_mask: torch.Tensor,
                       fraction: float) -> torch.Tensor:
    """(C, F) per-node feature masks of the nodes ``uids`` (C,) (JAX
    ``_node_feature_mask``, :139, one node a row): ``base_mask`` itself
    at ``fraction >= 1``; else each node's F uniforms
    ``uniform(fold_in(key, uid), (F,))`` over the features of
    ``base_mask`` (others +inf), and the ones at or below the k-th
    smallest kept, k = max(1, ceil(fraction * n_allowed)) in float32 as
    the JAX package computes it."""
    F = base_mask.shape[0]
    if fraction >= 1.0:
        return base_mask[None, :].expand(len(uids), F)
    dev = base_mask.device
    uids = torch.as_tensor(uids, dtype=torch.int64, device=dev).reshape(-1)
    if key is None:
        raise ValueError("feature_fraction_bynode < 1 needs the tree key")
    scores = prng.uniform_folded(key, uids, F)
    scores = torch.where(base_mask[None, :], scores,
                         torch.full_like(scores, float("inf")))
    n_allowed = base_mask.sum().to(torch.float32)
    k = int(torch.clamp(torch.ceil(torch.tensor(
        fraction, dtype=torch.float32, device=dev) * n_allowed), min=1.0))
    thresh = torch.sort(scores, dim=1).values[:, k - 1:k]
    return base_mask[None, :] & (scores <= thresh)


def root_output(root_sum, params: SplitParams):
    """The root's output, smoothed toward 0 under path smoothing (JAX
    :437-439)."""
    out = leaf_output(root_sum[0], root_sum[1], params)
    if params.path_smooth > 0:
        out = smooth_output(out, root_sum[2], 0.0, params)
    return out


def child_constraints(pconstr, out_l, out_r, mono, intermediate):
    """The children's (n, 2) bounds from their parents' ``pconstr`` (n,
    2), their outputs and the split features' monotone types ``mono``
    (n,): ``BasicLeafConstraints::Update`` (the midpoint; JAX grower.py
    :549-570, grower_wave.py :1151-1165) or, ``intermediate``, the
    sibling's output (JAX grower_wave.py :1131-1150)."""
    lo, hi = pconstr[:, 0], pconstr[:, 1]
    inc, dec = mono > 0, mono < 0
    if intermediate:
        bound_l, bound_r = out_r, out_l
    else:
        bound_l = bound_r = 0.5 * (out_l + out_r)
    max_l = torch.where(inc, torch.minimum(hi, bound_l), hi)
    min_l = torch.where(dec, torch.maximum(lo, bound_l), lo)
    max_r = torch.where(dec, torch.minimum(hi, bound_r), hi)
    min_r = torch.where(inc, torch.maximum(lo, bound_r), lo)
    return (torch.stack([min_l, max_l], dim=1),
            torch.stack([min_r, max_r], dim=1))


def scan_view(hist, sums, bundle, num_bins, hist_scale=None):
    """A batch of histograms as the split scan reads them: under EFB
    (``bundle``) the (C, BF, Bh, 3) bundle histograms expanded to the
    (C, F, ``num_bins``, 3) original features on their nodes' (C, 3)
    ``sums``, a quantized batch dequantized by its ``hist_scale`` first
    (JAX trainer.py:928-930); else as they are.  Returns the histograms
    and the scale the scan still applies."""
    if bundle is None:
        return hist, hist_scale
    if hist_scale is not None:
        hist = hist * hist_scale[:, None, None, :]
    return expand_bundle_hist(hist, sums, bundle, num_bins), None


def no_constraints(n, dev):
    return torch.tensor(NO_CONSTRAINT, dtype=torch.float32,
                        device=dev).repeat(n, 1)


def allowed_features_for(groups, used):
    """Interaction constraints (JAX :127, reference ColSampler::GetByNode,
    col_sampler.hpp:92-112): each node's (n, F) allowed features from its
    branch features ``used`` (n, F) — the branch features plus the union
    of the groups (G, F) bool that hold every branch feature; all
    features where ``groups`` is None."""
    if groups is None:
        return torch.ones_like(used)
    fits = (groups[None, :, :] | ~used[:, None, :]).all(dim=2)   # (n, G)
    return used | (groups[None, :, :] & fits[:, :, None]).any(dim=1)


class Cegb:
    """The CEGB penalty of a scan (JAX :228-243 ``cegb_penalty_vec``,
    :799-809 ``cegb_penalty_batch``; reference
    CostEfficientGradientBoosting::DetlaGain): ``tradeoff *
    penalty_split * n`` for a node of ``n`` rows, plus ``tradeoff *
    coupled[f]`` for each feature the model has not used yet, plus
    ``tradeoff * lazy[f]`` times the node's rows not yet charged for f.
    ``coupled`` / ``lazy``: (F,) sequences or None."""

    def __init__(self, params: SplitParams, coupled, lazy, device):
        def t(a):
            return (None if a is None else torch.as_tensor(
                np.asarray(a), dtype=torch.float32, device=device))

        self.tradeoff = float(params.cegb_tradeoff)
        self.split = float(params.cegb_penalty_split)
        self.coupled, self.lazy = t(coupled), t(lazy)

    @staticmethod
    def active(params: SplitParams, coupled, lazy) -> bool:
        return (params.cegb_penalty_split > 0 or coupled is not None
                or lazy is not None)

    def penalty(self, counts, used_model, unmarked=None):
        """(n, F) f32 penalties of n nodes of ``counts`` (n,) rows under
        the model's used features ``used_model`` (F,) bool and, lazy,
        their uncharged rows ``unmarked`` (n, F) f32, in the JAX op
        order."""
        F = used_model.shape[0]
        pen = (self.tradeoff * self.split * counts)[:, None].expand(
            counts.shape[0], F)
        if self.coupled is not None:
            pen = pen + (self.tradeoff * self.coupled
                         * (~used_model).to(torch.float32))[None, :]
        if self.lazy is not None and unmarked is not None:
            pen = pen + self.tradeoff * self.lazy[None, :] * unmarked
        return pen.contiguous()


def forced_split_stats(hf, parent_sum, ffeat, fbin, fdl, meta: FeatureMeta,
                       params: SplitParams):
    """A forced split's left / right sums and its actual relative gain
    from the leaf's (B, 3) histogram of the forced feature (JAX :99, the
    reference's ForceSplits SplitInfo, serial_tree_learner.cpp:500-520):
    the missing mass (NaN bin or zero-as-missing bin) rides the default
    direction wherever it sits against the threshold."""
    cumf = torch.cumsum(hf, dim=0)
    mt = int(meta.missing_type[ffeat])
    has_nan, has_zero = mt == MISSING_NAN, mt == MISSING_ZERO
    miss_bin = (max(int(meta.nan_bin[ffeat]), 0) if has_nan
                else int(meta.zero_bin[ffeat]))
    miss_c = hf[miss_bin] * (1.0 if (has_nan or has_zero) else 0.0)
    in_cum = (has_nan or has_zero) and miss_bin <= fbin
    flsum = cumf[fbin] + miss_c * (float(bool(fdl)) - float(in_cum))
    frsum = parent_sum - flsum
    fgain = (leaf_gain(flsum[0], flsum[1], params)
             + leaf_gain(frsum[0], frsum[1], params)
             - leaf_gain(parent_sum[0], parent_sum[1], params)
             - params.min_gain_to_split)
    return flsum, frsum, fgain


def split_go_left(bins, thr, dl, mt, nanb, zb, is_cat=None, bitset=None):
    """A split's go-left decision on integer bins: the numerical rule
    (``go_left_rule``), bitset membership where ``is_cat`` (JAX
    :303-315)."""
    return cat_go_left(bins, bitset, is_cat,
                       go_left_rule(bins, thr, dl, mt, nanb, zb))


class MaskedRows:
    """The masked sequential grower's O(N) passes over resident rows
    (``partition=False``): ``leaf_id`` holds every row's leaf; a split
    routes the split leaf's rows and histograms its children over all
    ``N`` rows masked to each.  A pass object answers ``root() -> (hist0,
    root_sum)``, ``split(leaf, nl, rule, lsum, rsum, need_large) ->
    (smaller_is_left, h_small, h_large)`` and ``leaf_ids()``; the
    streamed trainer's (models/grower_stream.py) folds the same passes
    over row blocks."""

    def __init__(self, binned, g3, hist_fn, packed=False, bundle=None):
        self.binned, self.g3, self.hist_fn = binned, g3, hist_fn
        self.packed, self.bundle = packed, bundle
        self.device, self.num_rows = binned.device, binned.shape[1]
        self.leaf_id = torch.zeros(self.num_rows, dtype=torch.int32,
                                   device=self.device)

    def root(self):
        return (self.hist_fn(self.binned, self.g3, self.leaf_id, 0),
                root_sums(self.g3))

    def split(self, leaf, nl, rule, lsum, rsum, need_large):
        """``rule`` = (feat, thr, dl, missing type, nan bin, zero bin,
        is_cat, bitset) of the split."""
        gl = split_go_left(
            bins_of_feat(self.binned, rule[0], self.packed,
                         self.bundle).long(), *rule[1:])
        self.leaf_id = torch.where((self.leaf_id == leaf) & ~gl,
                                   torch.full_like(self.leaf_id, nl),
                                   self.leaf_id)
        sm_left = bool(lsum[2] <= rsum[2])
        small, large = (leaf, nl) if sm_left else (nl, leaf)
        h_small = self.hist_fn(self.binned, self.g3, self.leaf_id, small)
        h_large = (self.hist_fn(self.binned, self.g3, self.leaf_id, large)
                   if need_large else None)
        return sm_left, h_small, h_large

    def leaf_ids(self):
        return self.leaf_id


class PartitionRows:
    """The partitioned sequential grower's passes (``partition=True``,
    reference DataPartition): the rows kept grouped by leaf in one row
    order, a split partitioning its leaf's segment stably and the smaller
    child histogrammed on its segment's rows, gathered."""

    def __init__(self, binned, g3, hist_fn, packed=False, bundle=None):
        self.binned, self.g3, self.hist_fn = binned, g3, hist_fn
        self.packed, self.bundle = packed, bundle
        self.device, self.num_rows = binned.device, binned.shape[1]
        self.order = torch.arange(self.num_rows, dtype=torch.long,
                                  device=self.device)
        # each leaf's segment: its first position in ``order``, its rows
        self.begin, self.phys = {0: 0}, {0: self.num_rows}

    def root(self):
        zeros = torch.zeros(self.num_rows, dtype=torch.int32,
                            device=self.device)
        self.hist0 = self.hist_fn(self.binned, self.g3, zeros, 0)
        return self.hist0, root_sums(self.g3)

    def _hist_rows(self, b, n):
        """K1 at one slot over a segment's rows, gathered: (F, n) bins and
        (n, 3) values."""
        if n == 0:
            return torch.zeros_like(self.hist0)
        rows = self.order[b:b + n]
        return self.hist_fn(self.binned[:, rows].contiguous(),
                            self.g3[rows].contiguous(),
                            torch.zeros(n, dtype=torch.int32,
                                        device=self.device), 0)

    def split(self, leaf, nl, rule, lsum, rsum, need_large):
        b0, n_p = self.begin[leaf], self.phys[leaf]
        seg = self.order[b0:b0 + n_p]
        bseg = bins_of_feat(self.binned, rule[0], self.packed,
                            self.bundle)[seg].long()
        gl = split_go_left(bseg, *rule[1:])
        left_rows, right_rows = seg[gl], seg[~gl]    # stable
        n_l = int(left_rows.shape[0])
        self.order[b0:b0 + n_p] = torch.cat([left_rows, right_rows])
        n_r = n_p - n_l
        sm_left = n_l <= n_r
        sm_b, sm_n = (b0, n_l) if sm_left else (b0 + n_l, n_r)
        lg_b, lg_n = (b0 + n_l, n_r) if sm_left else (b0, n_l)
        h_small = self._hist_rows(sm_b, sm_n)
        h_large = self._hist_rows(lg_b, lg_n) if need_large else None
        self.begin[nl], self.phys[leaf], self.phys[nl] = b0 + n_l, n_l, n_r
        return sm_left, h_small, h_large

    def leaf_ids(self):
        """Each row's leaf from the segments (the splits never touched
        per-row leaf ids)."""
        by_begin = sorted(self.begin, key=lambda k: self.begin[k])
        pos_leaf = torch.repeat_interleave(
            torch.tensor(by_begin, dtype=torch.int32, device=self.device),
            torch.tensor([self.phys[k] for k in by_begin],
                         device=self.device))
        leaf_id = torch.empty(self.num_rows, dtype=torch.int32,
                              device=self.device)
        leaf_id[self.order] = pos_leaf
        return leaf_id


def make_leafwise_grower(*, num_leaves: int, num_bins: int,
                         meta: FeatureMeta, params: SplitParams,
                         hist_fn: Callable, max_depth: int = -1,
                         partition: bool = True, hist_pool_mb: float = -1.0,
                         packed: bool = False,
                         feature_fraction_bynode: float = 1.0,
                         bundle=None, interaction_groups=None,
                         forced_splits=None, cegb_coupled=None,
                         cegb_lazy=None, split_fn: Callable = None,
                         sums_fn: Callable = None):
    """Build ``grow(binned, g3, base_mask, key=None, cegb_used=None,
    rows=None) -> (tree, leaf_id, root_sum)``; ``key`` is the tree's
    (per-node feature sampling).  ``rows``: the O(N) passes, by default
    ``PartitionRows`` (or, ``partition=False``, ``MaskedRows``) over
    ``binned`` and ``g3``; the streamed trainer passes its row-block
    passes (models/grower_stream.py) and no ``binned`` / ``g3``.
    ``grow.use_pool``: whether the histogram pool is kept.

    ``hist_fn(binned, g3, leaf_id, target) -> (F, B, 3)``: the histogram
    of the rows whose leaf id is ``target`` (ops/histogram.hist_one_leaf,
    K1 at one slot); the partition path calls it on a segment's gathered
    rows with every leaf id 0.  ``interaction_groups`` (G, F) bool
    (``parallel.trainer.parse_interaction_constraints``), ``forced_splits``
    (S, 6) int (``parse_forced_splits``), ``cegb_coupled`` / ``cegb_lazy``
    (F,) (the lazy penalty needs ``partition=False``: per-row leaf ids);
    ``cegb_used`` is the model's used features (F,) bool, or with lazy
    costs ``(used, marks)`` with the (N, F) bool rows already charged.
    ``split_fn`` (``find_best_split``'s signature) and ``sums_fn(g3) ->
    (3,)`` take the scans and the root sums where given: the parallel
    learners' cross-rank reductions (JAX's hooks of the same names)."""
    L = num_leaves
    scan = find_best_split if split_fn is None else split_fn
    pool_bytes = float(L) * int(meta.num_bins.shape[0]) * num_bins * 3 * 4
    cap_bytes = (hist_pool_mb * (1 << 20) if hist_pool_mb > 0
                 else _POOL_AUTO_BYTES)
    S_forced = (0 if forced_splits is None
                else min(len(forced_splits), L - 1))
    forced = (np.asarray(forced_splits)[:S_forced].tolist() if S_forced
              else [])
    # forced splits read their parents' histograms after the fact
    use_pool = S_forced > 0 or pool_bytes <= cap_bytes
    use_mc = meta.monotone_type is not None
    has_cat = meta.is_categorical is not None
    W = bitset_words(num_bins)
    use_cegb = Cegb.active(params, cegb_coupled, cegb_lazy)
    if cegb_lazy is not None and partition:
        raise ValueError("cegb_penalty_feature_lazy needs the masked "
                         "sequential grower (per-row leaf ids)")
    if not use_pool:
        log_info(f"Histogram pool would need {pool_bytes / (1 << 20):.0f} "
                 f"MB (> {cap_bytes / (1 << 20):.0f} MB cap); using "
                 "pool-free growth (children histograms rebuilt per split)")

    def grow(binned: torch.Tensor, g3: torch.Tensor,
             base_mask: torch.Tensor, key=None, cegb_used=None, rows=None):
        if rows is None:
            rows = (PartitionRows if partition else MaskedRows)(
                binned, g3, hist_fn, packed, bundle)
        dev, N = rows.device, rows.num_rows
        F = base_mask.shape[0]
        groups = (None if interaction_groups is None else torch.as_tensor(
            np.asarray(interaction_groups), dtype=torch.bool, device=dev))
        cegb = Cegb(params, cegb_coupled, cegb_lazy, dev) if use_cegb \
            else None
        marks = None
        if isinstance(cegb_used, (tuple, list)):
            cegb_used, marks = cegb_used
        if cegb_used is None:
            cegb_used = torch.zeros(F, dtype=torch.bool, device=dev)
        if cegb is not None and cegb.lazy is not None:
            # the tree's own copy: each split charges its leaf's rows
            marks = (torch.zeros((N, F), dtype=torch.bool, device=dev)
                     if marks is None else marks.clone())
        hist0, root_sum = rows.root()
        if sums_fn is not None:
            root_sum = sums_fn(g3)
        out0 = root_output(root_sum, params)
        mask0 = node_feature_masks(key, [0], base_mask,
                                   feature_fraction_bynode)
        if groups is not None:
            mask0 = mask0 & allowed_features_for(
                groups, torch.zeros((1, F), dtype=torch.bool, device=dev))
        pen0 = None
        if cegb is not None:
            unmk0 = (None if cegb.lazy is None
                     else (~marks).sum(dim=0).to(torch.float32)[None, :])
            pen0 = cegb.penalty(root_sum[2:3], cegb_used, unmk0)
        res0 = scan(scan_view(hist0[None], root_sum[None], bundle,
                              num_bins)[0],
                    root_sum[None], meta, mask0, params,
                    depth=torch.zeros(1, dtype=torch.int64, device=dev),
                    parent_output=out0[None], key=key, uids=[0], cegb=pen0)
        tree = empty_tree(L, dev, W)
        f32 = torch.float32
        pool = (torch.zeros((L,) + tuple(hist0.shape), dtype=f32, device=dev)
                if use_pool else None)
        if use_pool:
            pool[0] = hist0
        # per-leaf frontier state: sums, output, best split
        leaf_sums = torch.zeros((L, 3), dtype=f32, device=dev)
        leaf_sums[0] = root_sum
        leaf_out = torch.zeros(L, dtype=f32, device=dev)
        leaf_out[0] = out0
        leaf_constr = no_constraints(L, dev) if use_mc else None
        leaf_used = (torch.zeros((L, F), dtype=torch.bool, device=dev)
                     if groups is not None else None)
        best_gain = torch.full((L,), NEG_INF, dtype=f32, device=dev)
        best_feat = torch.zeros(L, dtype=torch.int64, device=dev)
        best_bin = torch.zeros(L, dtype=torch.int64, device=dev)
        best_dl = torch.zeros(L, dtype=torch.bool, device=dev)
        best_left = torch.zeros((L, 3), dtype=f32, device=dev)
        best_right = torch.zeros((L, 3), dtype=f32, device=dev)
        best_iscat = torch.zeros(L, dtype=torch.bool, device=dev)
        best_bits = torch.zeros((L, W), dtype=torch.int32, device=dev)

        def store_best(leafs, res, gains):
            best_gain[leafs] = gains
            best_feat[leafs] = res.feature
            best_bin[leafs] = res.threshold_bin
            best_dl[leafs] = res.default_left
            best_left[leafs] = res.left_sum
            best_right[leafs] = res.right_sum
            if res.is_cat is not None:
                best_iscat[leafs] = res.is_cat
                best_bits[leafs] = res.cat_bitset

        store_best(torch.zeros(1, dtype=torch.long, device=dev), res0,
                   res0.gain)
        # host state: depths, parents and sides, each applied forced
        # step's [left, right] leaves
        depth, parent, is_left = [0] * L, [-1] * L, [False] * L
        forced_leaf = [[-1, -1] for _ in range(S_forced)]

        nl = 1
        while nl < L:
            s_step = nl - 1
            li = torch.argmax(best_gain)              # the first best leaf
            leaf = int(li)
            is_forced = False
            if s_step < S_forced:
                # the forced steps come first, in BFS order (JAX :481-531):
                # one whose parent step was skipped, or that would leave a
                # child empty, is skipped
                pstep, side, ffeat, fbin, fdl = forced[s_step][:5]
                fleaf = 0 if pstep < 0 else forced_leaf[pstep][side]
                if fleaf >= 0:
                    flsum, frsum, fgain = forced_split_stats(
                        pool[fleaf][ffeat], leaf_sums[fleaf], ffeat, fbin,
                        fdl, meta, params)
                    is_forced = bool((flsum[2] > 0) & (frsum[2] > 0))
            if is_forced:
                leaf = fleaf
                li = torch.tensor(leaf, device=dev)
                forced_leaf[s_step] = [leaf, nl]
                feat = torch.tensor(ffeat, device=dev)
                thr = torch.tensor(fbin, device=dev)
                dl = torch.tensor(bool(fdl), device=dev)
                lsum, rsum, split_gain = flsum, frsum, fgain
                iscat = bits = None
            else:
                if not bool(best_gain[li] > 0):       # the step's host read
                    break
                feat, thr, dl = best_feat[li], best_bin[li], best_dl[li]
                lsum, rsum = best_left[li], best_right[li]
                split_gain = best_gain[li]
                iscat = best_iscat[li] if has_cat else None
                bits = best_bits[li] if has_cat else None
            node = nl - 1
            mt, nanb, zb = (meta.missing_type[feat], meta.nan_bin[feat],
                            meta.zero_bin[feat])
            lid_before = getattr(rows, "leaf_id", None)
            sm_left, h_small, h_large = rows.split(
                leaf, nl, (feat, thr, dl, mt, nanb, zb, iscat, bits), lsum,
                rsum, need_large=not use_pool)
            if use_pool:
                # the larger child by subtraction, as the JAX package
                # forms it: right = parent - left whichever was measured
                h_parent = pool[leaf]
                h_left = h_small if sm_left else h_parent - h_small
                h_right = h_parent - h_left
                pool[leaf], pool[nl] = h_left, h_right
            else:
                h_left, h_right = ((h_small, h_large) if sm_left
                                   else (h_large, h_small))
            d = depth[leaf] + 1
            csums = torch.stack([lsum, rsum])
            pconstr = leaf_constr[li][None] if use_mc else None
            couts = child_leaf_output(csums, params, pconstr, leaf_out[li])
            cconstr = None
            if use_mc:
                mono = meta.monotone_type[feat][None]
                if iscat is not None:
                    # a categorical split cuts no monotone bound
                    mono = torch.where(iscat, torch.zeros_like(mono), mono)
                c_l, c_r = child_constraints(
                    pconstr, couts[0:1], couts[1:2], mono,
                    intermediate=False)
                cconstr = torch.cat([c_l, c_r])
            uids2 = [2 * node + 1, 2 * node + 2]
            masks2 = node_feature_masks(key, uids2, base_mask,
                                        feature_fraction_bynode)
            used_child = None
            if groups is not None:
                used_child = leaf_used[li].clone()
                used_child[feat] = True
                masks2 = masks2 & allowed_features_for(groups,
                                                       used_child[None])
            pen2 = None
            if cegb is not None:
                cegb_used = cegb_used.clone()
                cegb_used[feat] = True
                unmk = None
                if cegb.lazy is not None:
                    # charge the split leaf's rows for the split feature,
                    # then price the children by their uncharged rows
                    # (JAX :586-598; integer counts, as exact as the JAX
                    # package's f32 product of 0 / 1 values)
                    marks[:, feat] |= lid_before == leaf
                    unmk = torch.stack([
                        (~marks[rows.leaf_id == c]).sum(dim=0)
                        for c in (leaf, nl)
                    ]).to(f32)
                pen2 = cegb.penalty(csums[:, 2], cegb_used, unmk)
            res = scan(
                scan_view(torch.stack([h_left, h_right]), csums, bundle,
                          num_bins)[0], csums, meta, masks2, params,
                constraint=cconstr,
                depth=torch.full((2,), d, dtype=torch.int64, device=dev),
                parent_output=couts, key=key, uids=uids2, cegb=pen2)
            gains = (res.gain if max_depth <= 0 or d < max_depth
                     else torch.full_like(res.gain, NEG_INF))

            p = parent[leaf]
            if p >= 0:
                (tree.left_child if is_left[leaf]
                 else tree.right_child)[p] = node
            tree.left_child[node] = -(leaf + 1)
            tree.right_child[node] = -(nl + 1)
            idx = torch.tensor([leaf, nl], dtype=torch.long, device=dev)
            tree.split_feature[node] = feat
            tree.threshold_bin[node] = thr
            tree.default_left[node] = dl
            tree.missing_type[node] = mt
            if iscat is not None:
                tree.is_cat[node] = iscat
                tree.cat_bitset[node] = bits
            tree.split_gain[node] = split_gain
            tree.internal_value[node] = leaf_out[li]
            tree.internal_weight[node] = leaf_sums[li, 1]
            tree.internal_count[node] = leaf_sums[li, 2]
            tree.leaf_value[idx] = couts
            tree.leaf_weight[idx] = csums[:, 1]
            tree.leaf_count[idx] = csums[:, 2]
            tree.leaf_parent[idx] = node
            leaf_sums[idx] = csums
            leaf_out[idx] = couts
            if use_mc:
                leaf_constr[idx] = cconstr
            if used_child is not None:
                leaf_used[idx] = used_child
            store_best(idx, res, gains)
            depth[leaf] = depth[nl] = d
            parent[leaf] = parent[nl] = node
            is_left[leaf], is_left[nl] = True, False
            nl += 1

        tree = tree._replace(num_leaves=torch.tensor(
            nl, dtype=torch.int32, device=dev))
        return tree, rows.leaf_ids(), root_sum

    grow.use_pool = use_pool
    return grow


def make_levelwise_grower(*, num_leaves: int, num_bins: int,
                          meta: FeatureMeta, params: SplitParams,
                          hist_frontier_fn: Callable, max_depth: int = -1,
                          packed: bool = False,
                          feature_fraction_bynode: float = 1.0,
                          bundle=None, interaction_groups=None,
                          forced_splits=None, cegb_coupled=None,
                          split_fn: Callable = None,
                          sums_fn: Callable = None):
    """Build ``grow(binned, g3, base_mask, key=None, cegb_used=None) ->
    (tree, leaf_id, root_sum)``; ``key`` is the tree's (per-node feature
    sampling); ``split_fn`` / ``sums_fn`` as the sequential grower takes
    them.

    ``hist_frontier_fn(binned, g3, label, L, live_slots=None, rows8=None)
    -> (L, F, B, 3)``: every slot's histogram in one pass, only the rows
    of the slots below ``live_slots`` adding (ops/histogram.hist_frontier;
    ``rows8`` the tree's rounded rows for an int8 pass).
    ``interaction_groups``, ``forced_splits`` (S, 6) and ``cegb_coupled``
    as the sequential grower takes them (no lazy CEGB: the trainer drops
    it with the JAX warning); a forced step splits its level's leaf
    before the budget ranking (JAX :742 docstring)."""
    L = num_leaves
    levels = math.ceil(math.log2(max(L, 2)))
    if max_depth > 0:
        levels = min(levels, max_depth)
    use_mc = meta.monotone_type is not None
    has_cat = meta.is_categorical is not None
    W = bitset_words(num_bins)
    S_forced = (0 if forced_splits is None
                else min(len(forced_splits), L - 1))
    fs = np.asarray(forced_splits)[:S_forced] if S_forced else None
    steps_at_depth: dict = {}
    if S_forced:
        if max_depth <= 0:
            # forced chains deeper than ceil(log2(L)) extend the levels
            levels = max(levels, min(int(fs[:, 5].max()) + 1, L - 1))
        for st in range(S_forced):
            if int(fs[st, 5]) < levels:
                steps_at_depth.setdefault(int(fs[st, 5]), []).append(st)
    use_cegb = Cegb.active(params, cegb_coupled, None)
    scan = find_best_split if split_fn is None else split_fn

    def grow(binned: torch.Tensor, g3: torch.Tensor,
             base_mask: torch.Tensor, key=None, cegb_used=None):
        dev = binned.device
        N = binned.shape[1]
        F = base_mask.shape[0]
        f32 = torch.float32
        groups = (None if interaction_groups is None else torch.as_tensor(
            np.asarray(interaction_groups), dtype=torch.bool, device=dev))
        cegb = Cegb(params, cegb_coupled, None, dev) if use_cegb else None
        if isinstance(cegb_used, (tuple, list)):
            cegb_used = cegb_used[0]
        if cegb_used is None:
            cegb_used = torch.zeros(F, dtype=torch.bool, device=dev)
        rows8 = NearestRows(g3)
        leaf_id = torch.zeros(N, dtype=torch.int32, device=dev)
        root_sum = root_sums(g3) if sums_fn is None else sums_fn(g3)
        tree = empty_tree(L, dev, W)
        leaf_sums = torch.zeros((L, 3), dtype=f32, device=dev)
        leaf_sums[0] = root_sum
        leaf_out = torch.zeros(L, dtype=f32, device=dev)
        leaf_out[0] = root_output(root_sum, params)
        leaf_constr = no_constraints(L, dev) if use_mc else None
        leaf_used = (torch.zeros((L, F), dtype=torch.bool, device=dev)
                     if groups is not None else None)
        leaf_active = torch.zeros(L, dtype=torch.bool, device=dev)
        leaf_active[0] = True
        leaf_is_left = torch.zeros(L, dtype=torch.bool, device=dev)
        forced_leaf = [[-1, -1] for _ in range(S_forced)]
        nl, nodes = 1, 0
        prev, use_sub = None, False
        for d in range(levels):
            Ld = min(1 << d, L)
            if prev is None:
                hist = hist_frontier_fn(binned, g3, leaf_id, Ld, rows8=rows8)
                use_sub = L * hist[0].numel() * 4 <= _POOL_AUTO_BYTES
            else:
                # the smaller child of each last-level split takes its
                # parent's slot; every other row the dead slot Lp
                p_hist, p_sel, p_new, p_sml = prev
                Lp = p_hist.shape[0]
                small = torch.where(p_sml[p_sel], p_sel, p_new[p_sel])
                slot_of = torch.full((L,), Lp, dtype=torch.int32,
                                     device=dev)
                slot_of[small] = p_sel.to(torch.int32)
                label = slot_of[leaf_id.long()]
                h_small = hist_frontier_fn(binned, g3, label, Lp + 1,
                                           live_slots=Lp, rows8=rows8)[:Lp]
                smL = p_sml[:, None, None, None]
                h_left = torch.where(smL, h_small, p_hist - h_small)
                h_right = p_hist - h_left
                split = torch.zeros(Lp, dtype=torch.bool, device=dev)
                split[p_sel] = True
                hist = torch.zeros((Ld,) + tuple(p_hist.shape[1:]),
                                   dtype=f32, device=dev)
                hist[:Lp] = torch.where(split[:, None, None, None], h_left,
                                        p_hist)
                hist[p_new[p_sel]] = h_right[p_sel]
            # the whole level in one batched scan (JAX
            # find_best_split_batch, a vmap)
            # one uid a leaf, not a level (JAX :933-936)
            uids = d * (2 * L) + torch.arange(Ld, device=dev)
            masks = node_feature_masks(key, uids, base_mask,
                                       feature_fraction_bynode)
            if groups is not None:
                masks = masks & allowed_features_for(groups, leaf_used[:Ld])
            pen = (None if cegb is None
                   else cegb.penalty(leaf_sums[:Ld, 2], cegb_used))
            res = scan(
                scan_view(hist, leaf_sums[:Ld], bundle, num_bins)[0],
                leaf_sums[:Ld], meta, masks,
                params, constraint=leaf_constr[:Ld] if use_mc else None,
                depth=torch.full((Ld,), d, dtype=torch.int64, device=dev),
                parent_output=leaf_out[:Ld], key=key, uids=uids, cegb=pen)
            # ---- the level's forced steps (JAX :952-983) -----------------
            forced_now = torch.zeros(Ld, dtype=torch.bool, device=dev)
            resolved = {}
            for st in steps_at_depth.get(d, []):
                pstep, side, ffeat, fbin, fdl = (int(v) for v in fs[st, :5])
                traw = 0 if pstep < 0 else forced_leaf[pstep][side]
                if not 0 <= traw < Ld or not bool(leaf_active[traw]):
                    continue
                flsum, frsum, fgain = forced_split_stats(
                    hist[traw, ffeat], leaf_sums[traw], ffeat, fbin, fdl,
                    meta, params)
                if not bool((flsum[2] > 0) & (frsum[2] > 0)):
                    continue
                resolved[st] = traw
                forced_now[traw] = True
                res = res._replace(
                    gain=_set_row(res.gain, traw, fgain),
                    feature=_set_row(res.feature, traw, ffeat),
                    threshold_bin=_set_row(res.threshold_bin, traw, fbin),
                    default_left=_set_row(res.default_left, traw,
                                          bool(fdl)),
                    left_sum=_set_row(res.left_sum, traw, flsum),
                    right_sum=_set_row(res.right_sum, traw, frsum),
                    is_cat=(None if res.is_cat is None
                            else _set_row(res.is_cat, traw, False)))
            gains = torch.where(leaf_active[:Ld], res.gain,
                                torch.full_like(res.gain, NEG_INF))
            rank_gains = torch.where(forced_now,
                                     torch.full_like(gains, float("inf")),
                                     gains)
            want = rank_gains > 0
            # the num_leaves budget: wanted splits ranked by gain, forced
            # ones first, ties to the lower leaf (jnp.argsort is stable)
            order = torch.argsort(-torch.where(want, rank_gains,
                                               torch.full_like(gains,
                                                               NEG_INF)),
                                  stable=True)
            rank = torch.empty_like(order)
            rank[order] = torch.arange(Ld, device=dev)
            split_mask = want & (rank < L - nl)
            sel = split_mask.nonzero()[:, 0]             # the level's read
            n = int(sel.shape[0])
            if n == 0:
                break                  # nothing stays active: tree done
            new_leaf = torch.zeros(Ld, dtype=torch.long, device=dev)
            new_leaf[sel] = nl + torch.arange(n, device=dev)
            nd = nodes + torch.arange(n, device=dev)
            for st, tl in resolved.items():
                if bool(split_mask[tl]):
                    forced_leaf[st] = [tl, int(new_leaf[tl])]

            # partition: the split leaves' rows that go right move
            k = leaf_id.long()
            f_row = res.feature[k]
            b_row = bins_of_rows(binned, f_row, packed, bundle).long()
            gl = split_go_left(
                b_row, res.threshold_bin[k], res.default_left[k],
                meta.missing_type[f_row], meta.nan_bin[f_row],
                meta.zero_bin[f_row],
                None if res.is_cat is None else res.is_cat[k],
                None if res.is_cat is None else res.cat_bitset[k])
            leaf_id = torch.where(split_mask[k] & ~gl,
                                  new_leaf[k].to(torch.int32), leaf_id)

            nlf = new_leaf[sel]
            lsum, rsum = res.left_sum[sel], res.right_sum[sel]
            pconstr = leaf_constr[sel] if use_mc else None
            lout = child_leaf_output(lsum, params, pconstr, leaf_out[sel])
            rout = child_leaf_output(rsum, params, pconstr, leaf_out[sel])
            if use_mc:
                mono = meta.monotone_type[res.feature[sel]]
                if res.is_cat is not None:
                    mono = torch.where(res.is_cat[sel],
                                       torch.zeros_like(mono), mono)
                lcon, rcon = child_constraints(pconstr, lout, rout, mono,
                                               intermediate=False)
            # each split leaf's parent pointer now names its node, whose
            # children are the leaf (left) and the new leaf, as ~leaf
            par, was_left = tree.leaf_parent[sel].long(), leaf_is_left[sel]
            fl, fr = (par >= 0) & was_left, (par >= 0) & ~was_left
            tree.left_child[par[fl]] = nd[fl].to(torch.int32)
            tree.right_child[par[fr]] = nd[fr].to(torch.int32)
            tree.left_child[nd] = (-(sel + 1)).to(torch.int32)
            tree.right_child[nd] = (-(nlf + 1)).to(torch.int32)
            feats = res.feature[sel]
            tree.split_feature[nd] = feats.to(torch.int32)
            tree.threshold_bin[nd] = res.threshold_bin[sel].to(torch.int32)
            tree.default_left[nd] = res.default_left[sel]
            tree.missing_type[nd] = meta.missing_type[feats].to(torch.int32)
            if res.is_cat is not None:
                tree.is_cat[nd] = res.is_cat[sel]
                tree.cat_bitset[nd] = res.cat_bitset[sel]
            tree.split_gain[nd] = res.gain[sel]
            tree.internal_value[nd] = leaf_out[sel]
            tree.internal_weight[nd] = leaf_sums[sel, 1]
            tree.internal_count[nd] = leaf_sums[sel, 2]
            if use_mc:
                leaf_constr[sel] = lcon
                leaf_constr[nlf] = rcon
            if cegb is not None:
                cegb_used = cegb_used.clone()
                cegb_used[feats] = True
            if leaf_used is not None:
                used_child = leaf_used[sel].clone()
                used_child[torch.arange(n, device=dev), feats] = True
                leaf_used[sel] = used_child
                leaf_used[nlf] = used_child
            for leafs, sums, outs, left in ((sel, lsum, lout, True),
                                            (nlf, rsum, rout, False)):
                tree.leaf_value[leafs] = outs
                tree.leaf_weight[leafs] = sums[:, 1]
                tree.leaf_count[leafs] = sums[:, 2]
                tree.leaf_parent[leafs] = nd.to(torch.int32)
                leaf_sums[leafs] = sums
                leaf_out[leafs] = outs
                leaf_is_left[leafs] = left
            leaf_active[:Ld] &= split_mask
            leaf_active[nlf] = True
            nl += n
            nodes += n
            prev = ((hist, sel, new_leaf,
                     res.left_sum[:, 2] <= res.right_sum[:, 2])
                    if d + 1 < levels and use_sub else None)
        tree = tree._replace(num_leaves=torch.tensor(
            nl, dtype=torch.int32, device=dev))
        return tree, leaf_id, root_sum

    return grow


def _set_row(t: torch.Tensor, i: int, v) -> torch.Tensor:
    """``t`` with row ``i`` set to ``v`` (a copy)."""
    t = t.clone()
    t[i] = v
    return t
