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
  child instead.  The JAX ``fori_loop`` with its latched ``done`` flag
  becomes a Python loop that reads each step's best gain on the host and
  stops at the first that is not positive.
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
(``hist_cuda.bins_of_feat`` / ``bins_of_rows``).

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

Forced splits, CEGB and interaction constraints are not ported (the
config refuses them).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..ops.hist_cuda import bins_of_feat, bins_of_rows
from ..ops.quantize import NearestRows
from ..ops.split import (NEG_INF, NO_CONSTRAINT, FeatureMeta, SplitParams,
                         child_leaf_output, find_best_split, go_left_rule,
                         leaf_output, smooth_output)
from ..utils import prng
from ..utils.log import log_info
from .tree import empty_tree

# the auto cap of the sequential grower's histogram pool and of the
# level-wise grower's carried level histograms (JAX :281, :878)
_POOL_AUTO_BYTES = 512.0 * (1 << 20)


def root_sums(g3):
    """The rows' (3,) [g, h, c] sums: an f32 reduction, as the JAX
    package's ``sums_fn``, rounded in the device's own order (the one
    place a grower sums rows outside K1)."""
    return g3.sum(dim=0)


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


def no_constraints(n, dev):
    return torch.tensor(NO_CONSTRAINT, dtype=torch.float32,
                        device=dev).repeat(n, 1)


def make_leafwise_grower(*, num_leaves: int, num_bins: int,
                         meta: FeatureMeta, params: SplitParams,
                         hist_fn: Callable, max_depth: int = -1,
                         partition: bool = True, hist_pool_mb: float = -1.0,
                         packed: bool = False,
                         feature_fraction_bynode: float = 1.0):
    """Build ``grow(binned, g3, base_mask, key=None) -> (tree, leaf_id,
    root_sum)``; ``key`` is the tree's (per-node feature sampling).

    ``hist_fn(binned, g3, leaf_id, target) -> (F, B, 3)``: the histogram
    of the rows whose leaf id is ``target`` (ops/histogram.hist_one_leaf,
    K1 at one slot); the partition path calls it on a segment's gathered
    rows with every leaf id 0."""
    L = num_leaves
    pool_bytes = float(L) * int(meta.num_bins.shape[0]) * num_bins * 3 * 4
    cap_bytes = (hist_pool_mb * (1 << 20) if hist_pool_mb > 0
                 else _POOL_AUTO_BYTES)
    use_pool = pool_bytes <= cap_bytes
    use_mc = meta.monotone_type is not None
    if not use_pool:
        log_info(f"Histogram pool would need {pool_bytes / (1 << 20):.0f} "
                 f"MB (> {cap_bytes / (1 << 20):.0f} MB cap); using "
                 "pool-free growth (children histograms rebuilt per split)")

    def grow(binned: torch.Tensor, g3: torch.Tensor,
             base_mask: torch.Tensor, key=None):
        dev = binned.device
        N = binned.shape[1]
        leaf_id = torch.zeros(N, dtype=torch.int32, device=dev)
        hist0 = hist_fn(binned, g3, leaf_id, 0)
        root_sum = root_sums(g3)
        out0 = root_output(root_sum, params)
        mask0 = node_feature_masks(key, [0], base_mask,
                                   feature_fraction_bynode)
        res0 = find_best_split(hist0[None], root_sum[None], meta,
                               mask0, params,
                               depth=torch.zeros(1, dtype=torch.int64,
                                                 device=dev),
                               parent_output=out0[None], key=key, uids=[0])
        tree = empty_tree(L, dev)
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
        best_gain = torch.full((L,), NEG_INF, dtype=f32, device=dev)
        best_feat = torch.zeros(L, dtype=torch.int64, device=dev)
        best_bin = torch.zeros(L, dtype=torch.int64, device=dev)
        best_dl = torch.zeros(L, dtype=torch.bool, device=dev)
        best_left = torch.zeros((L, 3), dtype=f32, device=dev)
        best_right = torch.zeros((L, 3), dtype=f32, device=dev)

        def store_best(leafs, res, gains):
            best_gain[leafs] = gains
            best_feat[leafs] = res.feature
            best_bin[leafs] = res.threshold_bin
            best_dl[leafs] = res.default_left
            best_left[leafs] = res.left_sum
            best_right[leafs] = res.right_sum

        store_best(torch.zeros(1, dtype=torch.long, device=dev), res0,
                   res0.gain)
        # host state: depths, parents and sides, the partition's segments
        depth, parent, is_left = [0] * L, [-1] * L, [False] * L
        order = torch.arange(N, dtype=torch.long, device=dev)
        begin, phys = [0] * L, [0] * L
        phys[0] = N

        def hist_rows(b, n):
            """K1 at one slot over a segment's rows, gathered: (F, n) bins
            and (n, 3) values."""
            if n == 0:
                return torch.zeros_like(hist0)
            rows = order[b:b + n]
            return hist_fn(binned[:, rows].contiguous(), g3[rows].contiguous(),
                           torch.zeros(n, dtype=torch.int32, device=dev), 0)

        nl = 1
        while nl < L:
            li = torch.argmax(best_gain)              # the first best leaf
            leaf = int(li)
            if not bool(best_gain[li] > 0):           # the step's host read
                break
            node = nl - 1
            feat, thr, dl = best_feat[li], best_bin[li], best_dl[li]
            lsum, rsum = best_left[li], best_right[li]
            mt, nanb, zb = (meta.missing_type[feat], meta.nan_bin[feat],
                            meta.zero_bin[feat])
            if partition:
                b0, n_p = begin[leaf], phys[leaf]
                seg = order[b0:b0 + n_p]
                bseg = bins_of_feat(binned, feat, packed)[seg].long()
                gl = go_left_rule(bseg, thr, dl, mt, nanb, zb)
                left_rows, right_rows = seg[gl], seg[~gl]    # stable
                n_l = int(left_rows.shape[0])
                order[b0:b0 + n_p] = torch.cat([left_rows, right_rows])
                n_r = n_p - n_l
                sm_left = n_l <= n_r
                sm_b, sm_n = (b0, n_l) if sm_left else (b0 + n_l, n_r)
                lg_b, lg_n = (b0 + n_l, n_r) if sm_left else (b0, n_l)
                h_small = hist_rows(sm_b, sm_n)
                h_large = None if use_pool else hist_rows(lg_b, lg_n)
                begin[nl], phys[leaf], phys[nl] = b0 + n_l, n_l, n_r
            else:
                gl = go_left_rule(bins_of_feat(binned, feat, packed).long(),
                                  thr, dl, mt, nanb, zb)
                leaf_id = torch.where((leaf_id == leaf) & ~gl,
                                      torch.full_like(leaf_id, nl), leaf_id)
                sm_left = bool(lsum[2] <= rsum[2])
                h_small = hist_fn(binned, g3, leaf_id,
                                  leaf if sm_left else nl)
                h_large = (None if use_pool else
                           hist_fn(binned, g3, leaf_id,
                                   nl if sm_left else leaf))
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
                c_l, c_r = child_constraints(
                    pconstr, couts[0:1], couts[1:2],
                    meta.monotone_type[feat][None], intermediate=False)
                cconstr = torch.cat([c_l, c_r])
            uids2 = [2 * node + 1, 2 * node + 2]
            masks2 = node_feature_masks(key, uids2, base_mask,
                                        feature_fraction_bynode)
            res = find_best_split(
                torch.stack([h_left, h_right]), csums, meta, masks2, params,
                constraint=cconstr,
                depth=torch.full((2,), d, dtype=torch.int64, device=dev),
                parent_output=couts, key=key, uids=uids2)
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
            tree.split_gain[node] = best_gain[li]
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
            store_best(idx, res, gains)
            depth[leaf] = depth[nl] = d
            parent[leaf] = parent[nl] = node
            is_left[leaf], is_left[nl] = True, False
            nl += 1

        if partition:
            # each row's leaf from the segments (the loop never touched
            # the per-row leaf ids)
            by_begin = sorted(range(nl), key=lambda k: begin[k])
            pos_leaf = torch.repeat_interleave(
                torch.tensor(by_begin, dtype=torch.int32, device=dev),
                torch.tensor([phys[k] for k in by_begin], device=dev))
            leaf_id = torch.empty(N, dtype=torch.int32, device=dev)
            leaf_id[order] = pos_leaf
        tree = tree._replace(num_leaves=torch.tensor(
            nl, dtype=torch.int32, device=dev))
        return tree, leaf_id, root_sum

    return grow


def make_levelwise_grower(*, num_leaves: int, num_bins: int,
                          meta: FeatureMeta, params: SplitParams,
                          hist_frontier_fn: Callable, max_depth: int = -1,
                          packed: bool = False,
                          feature_fraction_bynode: float = 1.0):
    """Build ``grow(binned, g3, base_mask, key=None) -> (tree, leaf_id,
    root_sum)``; ``key`` is the tree's (per-node feature sampling).

    ``hist_frontier_fn(binned, g3, label, L, live_slots=None, rows8=None)
    -> (L, F, B, 3)``: every slot's histogram in one pass, only the rows
    of the slots below ``live_slots`` adding (ops/histogram.hist_frontier;
    ``rows8`` the tree's rounded rows for an int8 pass)."""
    L = num_leaves
    levels = math.ceil(math.log2(max(L, 2)))
    if max_depth > 0:
        levels = min(levels, max_depth)
    use_mc = meta.monotone_type is not None

    def grow(binned: torch.Tensor, g3: torch.Tensor,
             base_mask: torch.Tensor, key=None):
        dev = binned.device
        N = binned.shape[1]
        f32 = torch.float32
        rows8 = NearestRows(g3)
        leaf_id = torch.zeros(N, dtype=torch.int32, device=dev)
        root_sum = root_sums(g3)
        tree = empty_tree(L, dev)
        leaf_sums = torch.zeros((L, 3), dtype=f32, device=dev)
        leaf_sums[0] = root_sum
        leaf_out = torch.zeros(L, dtype=f32, device=dev)
        leaf_out[0] = root_output(root_sum, params)
        leaf_constr = no_constraints(L, dev) if use_mc else None
        leaf_active = torch.zeros(L, dtype=torch.bool, device=dev)
        leaf_active[0] = True
        leaf_is_left = torch.zeros(L, dtype=torch.bool, device=dev)
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
            res = find_best_split(
                hist, leaf_sums[:Ld], meta, masks,
                params, constraint=leaf_constr[:Ld] if use_mc else None,
                depth=torch.full((Ld,), d, dtype=torch.int64, device=dev),
                parent_output=leaf_out[:Ld], key=key, uids=uids)
            gains = torch.where(leaf_active[:Ld], res.gain,
                                torch.full_like(res.gain, NEG_INF))
            want = gains > 0
            # the num_leaves budget: wanted splits ranked by gain, ties to
            # the lower leaf (jnp.argsort is stable)
            order = torch.argsort(-torch.where(want, gains, torch.full_like(
                gains, NEG_INF)), stable=True)
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

            # partition: the split leaves' rows that go right move
            k = leaf_id.long()
            f_row = res.feature[k]
            b_row = bins_of_rows(binned, f_row, packed).long()
            gl = go_left_rule(b_row, res.threshold_bin[k],
                              res.default_left[k], meta.missing_type[f_row],
                              meta.nan_bin[f_row], meta.zero_bin[f_row])
            leaf_id = torch.where(split_mask[k] & ~gl,
                                  new_leaf[k].to(torch.int32), leaf_id)

            nlf = new_leaf[sel]
            lsum, rsum = res.left_sum[sel], res.right_sum[sel]
            pconstr = leaf_constr[sel] if use_mc else None
            lout = child_leaf_output(lsum, params, pconstr, leaf_out[sel])
            rout = child_leaf_output(rsum, params, pconstr, leaf_out[sel])
            if use_mc:
                lcon, rcon = child_constraints(
                    pconstr, lout, rout, meta.monotone_type[res.feature[sel]],
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
            tree.split_gain[nd] = res.gain[sel]
            tree.internal_value[nd] = leaf_out[sel]
            tree.internal_weight[nd] = leaf_sums[sel, 1]
            tree.internal_count[nd] = leaf_sums[sel, 2]
            if use_mc:
                leaf_constr[sel] = lcon
                leaf_constr[nlf] = rcon
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
