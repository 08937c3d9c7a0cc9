"""Wave-K best-first tree growth — the leaf-wise schedule of the port.

Port of lightgbmv1_tpu/models/grower_wave.py ``make_wave_grower`` (:667,
body ``grow`` :839).  The policy is the reference's: frontier leaves
ranked by best split gain, global across depths, stopped by the
``num_leaves`` budget and the positive-gain test
(serial_tree_learner.cpp:152-202).  The schedule splits the top-K
frontier leaves a round and histograms their children in one pass:

* the per-split partition becomes one decision pass over all rows;
* the smaller child of each split is labelled with its slot and all K
  smaller-child histograms come from one histogram pass
  (``hist_wave_fn``, the CUDA kernel K1 on the card); the larger children
  come from the per-leaf histogram state by subtraction
  (``subtract_child_hists``);
* the 2K children's split scan is one batched call (ops/split.py).

Slot buckets (``slot_buckets_for``): a round with few splits runs its
partition and histogram at the smallest bucket S >= its split count, and
the sustained rounds of a wave of K >= 32 (``deep``) may run the cheaper
deep precision.

This is the SERIALIZED round body of the JAX grower
(``async_wave_pipeline=false``).  The JAX package's pipelined body defers
each round's state scatter and valid routing into the next round and is
bit-identical to the serialized one by its own pin
(tests/test_wave_pipeline.py::test_pipeline_bit_parity_binary_bagging_ff);
an eager PyTorch loop has nothing to overlap, so only the serialized body
is ported.  The ``lax.while_loop`` becomes a Python loop that reads each
round's split count on the host, and since the top-K picks of a round are
a prefix of the ranking (gains sorted, budget a prefix), a round works on
its ``n_split`` picks only: the JAX version's padded dead ranks are
computed there and dropped, so the values kept are the same.  The
partition is written per row (each row looks up its leaf's slot) instead
of the JAX version's (S, N) compare: the same integer decisions.

The valid sets are routed once a tree, after its last round: their leaf
ids are read only then (the score update), and the routing is integer, so
routing each row through all of the tree's rounds at once gives the ids a
routing round by round gives.  The splits come from the store's node rows
(``_PackedStore.split_rows``, node order being round order) with each
round's split count, and ``route_valid_sets`` routes each set in one
launch of K3 on the card, on every path (staged, fused, looped).

With ``fused_round_fn`` (``hist_method=fused``, ops/wave_fused.py) a
round is the JAX package's single-pass routed round (JAX :787-799,
:1258-1272, :1318-1370, :1402-1429): no separate partition and histogram
pass — the fused round (the CUDA kernel K2 on the card) routes the rows,
histograms the label it made, subtracts and scans, and returns the new
leaf ids and the packed SplitInfo of the 2S slot children.  Dead slots
carry leaf id ``L`` and child sums 1.0, as the JAX ``to_slot`` /
``to_cslot`` fill them; a round's slot k is its rank k, so the slot ->
rank gather is a prefix.  The root pass stays on ``hist_wave_fn`` (K1).

With ``fused_loop_fn`` as well (``wave_loop_rounds > 1``) the rounds run
as segments (JAX :1547-1659): one launch of the persistent loop (K6 on
the card) runs R rounds from the frontier columns of the store, and the
grower reads the segment's split counts once and replays each round that
split through the same boundary and store commit as the single round,
from the round's packed SplitInfo.  The segments end at a round of no
split or at ``num_leaves``.

Quantized rounds (``hist_dtype_deep=int8sr``, JAX :49-58, :855-863,
:1078-1085, :1371-1465): with ``hist_wave_quant_fn`` the sustained
bucket (``S == K >= 32``) and the 16-slot ramp of a wave of K > 16 run
the stochastic-rounded integer histogram (ops/quantize.py), keyed by
``fold_in(tree_key, 8_000_011 + num_leaves)`` at the round's start; the
root pass and buckets of 4 slots never quantize.  The per-slot
dequantization folds into the subtraction (``subtract_child_hists(...,
slot_scale)``) or, pool-free, into the split scan after its integer
cumulative sum (``find_best_split(..., hist_scale)``); once a grow has
quantized buckets every round carries scales, ones on the others, as
the JAX package does.  The fused round and the loop quantize with the
same stream (the quantize kernel and K6's in-kernel draw on the card).

Monotone constraints (JAX :216-252, :490-586, :1040-1060, :1111-1165):
``basic`` mode bounds each child by the midpoint of the two children's
outputs (``BasicLeafConstraints::Update``); ``intermediate`` mode keeps a
bin-space box a leaf, recomputes every frontier leaf's bounds a round
from the outputs of the leaves adjacent to it along a monotone feature
(``intermediate_constraints``), bounds each child by its sibling's
output, and defers a leaf adjacent to a higher-ranked pick of the same
round (in rank order, as the JAX loop does: it decides which leaves
split).  The bounds ride in two more store columns; each child's output
is clamped to its parent's bound (``clamp_out``), and the children's
bounds, depths and outputs feed the scan (staged and fused).  Path
smoothing, ``max_delta_step`` and ``feature_contri`` are the scan's and
``clamp_out``'s; the root's output is smoothed toward 0.

Plain int8 rounds (``hist_dtype=int8`` / ``hist_dtype_deep=int8``): the
histograms of the root pass and of the staged, fused and looped rounds
at int8 read the tree's rows rounded to nearest under each kernel's scale
tile (``quantize.NearestRows``, made once a grow, each tile's rows once).

Per-node feature sampling (``feature_fraction_bynode < 1``, JAX
:881-884, :901, :1176-1197): the root's mask is node 0's and each
child's is drawn for its uid, 2 node + 1 (left) and 2 node + 2 (right)
(``grower.node_feature_masks``, the tree's ``key``); the persistent loop
does not run it (the trainer refuses it, as the JAX grower keeps the
loop off).  extra_trees (JAX :813-816) draws each scanned node's
thresholds for the same uids under the tree's ``key``
(``find_best_split(..., key=, uids=)``, the split-scan kernel's rand leg
on the card); the fused family refuses it (the trainer).

int16 bins (``max_bin > 255``) run the staged rounds: the partition
reads them as any bins (``bins_of_rows``), the histograms come from the
trainer's method (the one-hot product on the card), the scan is the
split-scan kernel's wide leg and the valid routing K3's 16-bit leg.

Categorical splits, CEGB and interaction constraints are not ported (the
config refuses them), and the split scan and the root sums are the
serial learner's own (the JAX version's ``split_fn`` / ``sums_fn`` hooks
carry the cross-chip reductions, which the port has not).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..ops.hist_cuda import bins_of_rows
from ..ops.quantize import NearestRows, prequantize_rows
from ..ops.split import (NEG_INF, NO_CONSTRAINT, FeatureMeta, SplitParams,
                         child_leaf_output, find_best_split, go_left_rule,
                         leaf_output, smooth_output)
from ..ops.wave_fused import (fused_route_rows, subtract_children,
                               unpack_children)
from ..utils.prng import fold_in
from .grower import child_constraints, node_feature_masks, root_sums
from .tree import TreeArrays

# Slot bucketing starts at this many rows (each bucket is one more
# partition + histogram shape); tests lower it to reach the bucketed and
# deep rounds at small sizes.
_BUCKET_MIN_N = 1 << 16

# The smaller-child + subtraction mode keeps an (L, F, B, 3) per-leaf
# histogram state; above this size the grower runs the pool-free 2K-slot
# pass instead.
_SUB_STATE_CAP_BYTES = 512 * (1 << 20)


def auto_wave_size(num_leaves: int) -> int:
    """``leafwise_wave_size=0``: num_leaves // 4 (JAX :163)."""
    return max(1, num_leaves // 4)


def slot_buckets_for(K: int, N: int) -> List[int]:
    """The slot-bucket ladder for wave size ``K`` over ``N`` rows."""
    if K > 4 and N >= _BUCKET_MIN_N:
        return sorted({4, min(16, K), K})
    return [K]


def quant_buckets_for(slot_buckets: Sequence[int], K: int) -> tuple:
    """The buckets whose rounds quantize under int8sr (JAX :855-863): the
    sustained bucket of a wave of K >= 32 and the 16-slot ramp of a wave
    of K > 16; never the root pass, a 4-slot bucket or a one-bucket
    ladder."""
    if len(slot_buckets) <= 1:
        return ()
    return tuple(S for S in slot_buckets
                 if (S == K and K >= 32) or (S == 16 and S < K))


def round_key(tree_key, num_leaves: int):
    """The rounding key of the round that starts at ``num_leaves`` leaves
    (JAX :1084): ``fold_in(tree_key, 8_000_011 + num_leaves)``."""
    return fold_in(tree_key, 8_000_011 + int(num_leaves))


def subtract_child_hists(h_slot, leaf_hist, leafs, order_c, sm_left,
                         slot_scale=None):
    """Smaller-child + parent-subtraction child histograms of one round
    (reference BeforeFindBestSplit + FeatureHistogram::Subtract):
    ``h_slot`` holds the measured smaller children in slot order, the
    larger sibling is the parent's stored histogram minus the smaller.
    ``slot_scale`` (K, 3): a quantized round's dequantization, one
    multiply before the subtraction (exact: every scale is a power of
    two).  Returns the rank-order interleaved (2K, F, B, 3) child
    stack."""
    return subtract_children(h_slot[order_c], leaf_hist[leafs], sm_left,
                             None if slot_scale is None
                             else slot_scale[order_c])


def _box_adjacency_per_feature(lo, hi, feats):
    """``(f, adj_up, adj_dn)`` (L, L) adjacency of leaf boxes along each
    feature of ``feats`` (JAX :191): A -> B adjacent-up along f when
    hi_A[f] == lo_B[f] and the boxes overlap in every other feature; the
    overlap counts accumulate in blocks of 256 features."""
    L, F = lo.shape
    ov_cnt = torch.zeros((L, L), dtype=torch.int64, device=lo.device)
    for c0 in range(0, F, 256):
        c1 = min(c0 + 256, F)
        ov_cnt += ((lo[:, None, c0:c1] < hi[None, :, c0:c1])
                   & (lo[None, :, c0:c1] < hi[:, None, c0:c1])).sum(dim=2)
    for f in feats:
        ov_f = (lo[:, None, f] < hi[None, :, f]) & (lo[None, :, f]
                                                     < hi[:, None, f])
        other = (ov_cnt - ov_f.long()) == F - 1
        yield (f, (hi[:, None, f] == lo[None, :, f]) & other,
               (lo[:, None, f] == hi[None, :, f]) & other)


def intermediate_constraints(boxes, outs, num_leaves, mono_feats,
                             mono_types):
    """Every leaf's [min, max] output bound (L, 2) in intermediate mode
    (JAX :216, the reference's IntermediateLeafConstraints as a pairwise
    reduction): a leaf's upper bound along an increasing feature is the
    least output of the leaves adjacent above it, its lower bound the
    largest below (roles swapped on a decreasing feature), over the
    ``num_leaves`` leaves of ``boxes`` (L, F, 2) [lo, hi) and ``outs``
    (L,)."""
    L = boxes.shape[0]
    dev = boxes.device
    lo, hi = boxes[..., 0], boxes[..., 1]
    iota = torch.arange(L, device=dev)
    valid_b = (iota[None, :] < num_leaves) & (iota[:, None] != iota[None, :])
    max_c = torch.full((L,), NO_CONSTRAINT[1], dtype=torch.float32,
                       device=dev)
    min_c = torch.full((L,), NO_CONSTRAINT[0], dtype=torch.float32,
                       device=dev)
    types = dict(zip(mono_feats, mono_types))
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    for f, adj_up, adj_dn in _box_adjacency_per_feature(lo, hi, mono_feats):
        adj_up, adj_dn = adj_up & valid_b, adj_dn & valid_b
        if types[f] < 0:           # decreasing: roles of up/down swap
            adj_up, adj_dn = adj_dn, adj_up
        max_c = torch.minimum(max_c, torch.where(
            adj_up, outs[None, :], inf).min(dim=1).values)
        min_c = torch.maximum(min_c, torch.where(
            adj_dn, outs[None, :], -inf).max(dim=1).values)
    return torch.stack([min_c, max_c], dim=1)


def defer_adjacent(valid, boxes, mono_feats):
    """Intermediate mode's same-round deferral (JAX :1040-1060): a pick
    adjacent along a monotone feature to a kept pick of higher rank waits
    for a later round.  ``valid`` (K,) bool by rank, ``boxes`` (K, F, 2)
    the picks' boxes; the ranks are walked in order on the host, as the
    JAX loop walks them."""
    K = valid.shape[0]
    adj = torch.zeros((K, K), dtype=torch.bool, device=valid.device)
    for _f, up, dn in _box_adjacency_per_feature(boxes[..., 0],
                                                 boxes[..., 1], mono_feats):
        adj |= up | dn
    kept = valid.cpu().tolist()
    adj_h = adj.cpu().tolist()
    for j in range(1, K):
        if kept[j] and any(kept[i] and adj_h[j][i] for i in range(j)):
            kept[j] = False
    return torch.tensor(kept, dtype=torch.bool, device=valid.device)


class _PackedStore:
    """The per-leaf frontier + tree-leaf state in one (L, 17) f32 table
    (19 with monotone constraints: their bounds) and the per-node tree
    state in one (L1, 11) f32 table (JAX :472, and the leaf each node
    split, which the valid routing reads at the tree's end).  Ids, bins,
    depths and child indices ride as exact small f32 values; a round
    commits with one 2K-row frontier write, one K-row node write and one
    child-pointer fixup."""

    # frontier-table columns (per leaf)
    GAIN, FEAT, BIN, DL = 0, 1, 2, 3
    LS, RS = 4, 7                    # [4:7) left sums, [7:10) right sums
    OUT, DEPTH, ISLEFT = 10, 11, 12
    LVAL, LWEIGHT, LCNT, LPAR = 13, 14, 15, 16
    CMIN, CMAX = 17, 18              # only with monotone constraints
    # node-table columns (per internal node)
    NFEAT, NBIN, NDL, NMT, NGAIN, NIVAL, NIW, NIC, NLC, NRC, NLEAF = \
        range(11)

    # The grower owns the tables, so a round's commit writes them in place
    # (the JAX version's functional update would copy both a round).
    def __init__(self, L, L1, device, use_mc=False):
        self.L, self.L1, self.device = L, L1, device
        self.use_mc = use_mc
        self.CF = 19 if use_mc else 17

    def init(self, res0, out0):
        ft = torch.zeros((self.L, self.CF), dtype=torch.float32,
                         device=self.device)
        ft[:, self.GAIN] = NEG_INF
        ft[:, self.LPAR] = -1.0
        if self.use_mc:
            ft[:, self.CMIN] = NO_CONSTRAINT[0]
            ft[:, self.CMAX] = NO_CONSTRAINT[1]
        z = torch.zeros((), dtype=torch.float32, device=self.device)
        ft[0, :17] = torch.stack([
            res0.gain[0], res0.feature[0].float(),
            res0.threshold_bin[0].float(), res0.default_left[0].float(),
            *res0.left_sum[0], *res0.right_sum[0],
            out0, z, z, z, z, z, z - 1.0])
        nt = torch.zeros((self.L1, 11), dtype=torch.float32,
                         device=self.device)
        nt[:, self.NLC] = -1.0
        nt[:, self.NRC] = -2.0
        return {"ft": ft, "nt": nt}

    def gains(self, s):
        return s["ft"][:, self.GAIN]

    def read(self, s, leafs):
        rows = s["ft"][leafs]                    # one gather for all fields
        return dict(
            feats=rows[:, self.FEAT].long(),
            thrs=rows[:, self.BIN].long(),
            dls=rows[:, self.DL] != 0,
            lsums=rows[:, self.LS:self.LS + 3],
            rsums=rows[:, self.RS:self.RS + 3],
            pout=rows[:, self.OUT],
            pdepth=rows[:, self.DEPTH].long(),
            was_left=rows[:, self.ISLEFT] != 0,
            parent=rows[:, self.LPAR].long(),
            pconstr=(rows[:, self.CMIN:self.CMAX + 1] if self.use_mc
                     else None),
        )

    def write(self, s, r):
        res = r["res"]
        n = r["nidx"].shape[0]
        f32 = torch.float32
        isleft = torch.tensor([1.0, 0.0], dtype=f32,
                              device=self.device).repeat(n)
        crows = torch.cat([
            r["cgain"][:, None], res.feature.to(f32)[:, None],
            res.threshold_bin.to(f32)[:, None],
            res.default_left.to(f32)[:, None], res.left_sum, res.right_sum,
            r["couts"][:, None], r["cdepth"].to(f32)[:, None],
            isleft[:, None],
            r["couts"][:, None],                 # leaf_value == leaf_out
            r["csums"][:, 1:2], r["csums"][:, 2:3],
            r["nidx"].repeat_interleave(2).to(f32)[:, None]]
            + ([r["cconstr"]] if self.use_mc else []), dim=1)
        s["ft"][r["cidx"]] = crows
        nrows = torch.cat([
            r["feats"].to(f32)[:, None], r["thrs"].to(f32)[:, None],
            r["dls"].to(f32)[:, None], r["mtypes"].to(f32)[:, None],
            r["vals"][:, None], r["pout"][:, None],
            r["psum"][:, 1:2], r["psum"][:, 2:3],
            (-(r["leafs"] + 1)).to(f32)[:, None],
            (-(r["nls"] + 1)).to(f32)[:, None],
            r["leafs"].to(f32)[:, None]], dim=1)
        nt = s["nt"]
        # parents are strictly older nodes than this round's new rows, so
        # the pointer fixup and the row write never collide
        p, was_left = r["parent"], r["was_left"]
        has_p = p >= 0
        nodes_f = r["nidx"].to(f32)
        fl = has_p & was_left
        fr = has_p & ~was_left
        nt[p[fl], self.NLC] = nodes_f[fl]
        nt[p[fr], self.NRC] = nodes_f[fr]
        nt[r["nidx"]] = nrows

    def split_rows(self, s, n_splits):
        """The tree's ``n_splits`` splits in node order, which is round
        order (a round's nodes are ``nl - 1 + rank``): ``(feats, thrs,
        dls, leafs, nls)`` int32, the leaf each split and the new leaf
        its right child took (node j's is j + 1)."""
        rows = s["nt"][:n_splits]
        i32 = torch.int32
        fbd = rows[:, self.NFEAT:self.NDL + 1].to(i32)
        return (fbd[:, 0], fbd[:, 1], fbd[:, 2], rows[:, self.NLEAF].to(i32),
                torch.arange(1, n_splits + 1, dtype=i32, device=self.device))

    def finalize(self, s, num_leaves) -> TreeArrays:
        ft, nt = s["ft"], s["nt"]
        i32 = torch.int32
        return TreeArrays(
            num_leaves=torch.tensor(num_leaves, dtype=i32,
                                    device=self.device),
            split_feature=nt[:, self.NFEAT].to(i32),
            threshold_bin=nt[:, self.NBIN].to(i32),
            threshold=torch.zeros(self.L1, dtype=torch.float32,
                                  device=self.device),
            default_left=nt[:, self.NDL] != 0,
            missing_type=nt[:, self.NMT].to(i32),
            left_child=nt[:, self.NLC].to(i32),
            right_child=nt[:, self.NRC].to(i32),
            split_gain=nt[:, self.NGAIN].clone(),
            internal_value=nt[:, self.NIVAL].clone(),
            internal_weight=nt[:, self.NIW].clone(),
            internal_count=nt[:, self.NIC].clone(),
            leaf_value=ft[:, self.LVAL].clone(),
            leaf_weight=ft[:, self.LWEIGHT].clone(),
            leaf_count=ft[:, self.LCNT].clone(),
            leaf_parent=ft[:, self.LPAR].to(i32))


def _topk_by_rank(gains: torch.Tensor, K: int):
    """Top-K gains, descending, ties by the lower leaf index (the
    ``lax.top_k`` order the JAX version's rank matrix reproduces)."""
    L = gains.shape[0]
    iota = torch.arange(L, device=gains.device)
    g_l, g_i = gains[:, None], gains[None, :]
    beats = (g_l > g_i) | ((g_l == g_i) & (iota[:, None] < iota[None, :]))
    rank = beats.sum(dim=0)
    sel = rank[None, :] == torch.arange(K, device=gains.device)[:, None]
    leafs = torch.where(sel, iota[None, :], 0).sum(dim=1)
    vals = torch.where(sel, gains[None, :], 0.0).sum(dim=1)
    return vals, leafs


def route_valid_sets(store: _PackedStore, st, round_splits, valids, *,
                     num_leaves, meta: FeatureMeta, packed=False):
    """Each valid set's leaf ids, from the root through all of a grown
    tree's rounds at once (K3 on the card, a launch a set): nothing reads
    them before the tree ends.  ``round_splits``: each round's split
    count, in order; the splits are the store's node rows."""
    dev = store.device
    vlids = [torch.zeros(v.shape[1], dtype=torch.int32, device=dev)
             for v in valids]
    if not valids or not round_splits:
        return vlids
    feats, thrs, dls, leafs, nls = store.split_rows(st, sum(round_splits))
    offsets = torch.tensor(np.cumsum([0] + list(round_splits)),
                           dtype=torch.int32)
    if dev.type == "cuda":
        # from pinned memory the copy need not wait for the stream
        offsets = offsets.pin_memory().to(dev, non_blocking=True)
    return fused_route_rows(list(zip(valids, vlids)), feats=feats, thrs=thrs,
                            dls=dls, leafs=leafs, nls=nls,
                            num_leaves=num_leaves, meta=meta, packed=packed,
                            offsets=offsets)


def make_wave_grower(*, num_leaves: int, num_bins: int, meta: FeatureMeta,
                     params: SplitParams, hist_wave_fn: Callable,
                     max_depth: int = -1, wave_size: int = 32,
                     fused_round_fn: Optional[Callable] = None,
                     fused_loop_fn: Optional[Callable] = None,
                     hist_wave_quant_fn: Optional[Callable] = None,
                     packed: bool = False, monotone_mode: str = "basic",
                     feature_fraction_bynode: float = 1.0):
    """Build ``grow(binned, g3, base_mask, valids=(), key=None)``.

    ``hist_wave_fn(binned, g3, label, nslots, deep=False, rows8=None) ->
    (nslots, F, B, 3)``: histograms of the rows labelled 0..nslots-1
    (``nslots`` is dead); ``deep`` marks a sustained round that may run
    the cheaper deep precision; ``rows8`` is the tree's
    ``quantize.NearestRows`` for an int8 pass (the fused round and the
    loop take it too).  ``fused_round_fn``
    (ops/wave_fused.make_fused_round) runs every round after the root as
    one routed fused round; with
    ``fused_loop_fn`` (ops/wave_fused.make_fused_wave_loop, which the
    trainer builds only where its plan is eligible) the rounds run as
    segments of ``fused_loop_fn.rounds`` rounds a launch, replayed here
    from their packed SplitInfo (JAX :1547-1659).  ``grow`` returns
    ``(tree, leaf_id, root_sum, valid_leaf_ids)``: each valid set's rows
    routed through the same splits, once the tree is grown, so its score
    update is a leaf-value gather.  ``packed``: ``binned`` and the valid
    sets hold 4-bit packed bytes, which the staged round's partition
    decodes (``hist_cuda.bins_of_rows``) and the callables and the valid
    routing read themselves.
    ``hist_wave_quant_fn(binned, zq, label, nslots, key) -> hist_q``
    (``hist_dtype_deep=int8sr``) runs the quantized buckets' staged
    rounds on the tree's prequantized rows ``zq``
    (``quantize.prequantize_rows``, made once a grow); its presence also
    quantizes the fused and looped rounds of those buckets, keyed by
    ``grow``'s per-tree ``key`` (two uint32 words, utils/prng.py).
    ``monotone_mode`` (``basic`` / ``intermediate``, as the trainer
    resolved it) is read when ``meta.monotone_type`` is set; the
    persistent loop does not run them (the trainer refuses it).
    ``feature_fraction_bynode < 1`` draws every node's feature mask from
    ``key`` (the persistent loop does not run it)."""
    L = num_leaves
    L1 = max(L - 1, 1)
    K = max(1, min(wave_size, L1))
    use_mc = meta.monotone_type is not None
    use_inter = use_mc and monotone_mode == "intermediate"
    if use_mc and fused_loop_fn is not None:
        raise ValueError("the persistent loop runs no monotone constraints")
    bynode = feature_fraction_bynode
    if bynode < 1.0 and fused_loop_fn is not None:
        raise ValueError("the persistent loop runs no per-node feature "
                         "sampling")
    inter_feats = inter_types = ()
    if use_inter:
        mono_h = meta.monotone_type.cpu()
        inter_feats = [int(f) for f in (mono_h != 0).nonzero()[:, 0]]
        inter_types = [int(mono_h[f]) for f in inter_feats]

    def clamp_out(sums, pconstr, pout):
        """Children's outputs under their parents' bounds and outputs (JAX
        ``clamp_out``, :833)."""
        return child_leaf_output(sums, params, pconstr, pout)

    def grow(binned: torch.Tensor, g3: torch.Tensor,
             base_mask: torch.Tensor, valids: Sequence[torch.Tensor] = (),
             key=None):
        dev = binned.device
        N = binned.shape[1]
        F = base_mask.shape[0]
        slot_buckets = slot_buckets_for(K, N)
        quant_buckets = quant_buckets_for(slot_buckets, K) \
            if hist_wave_quant_fn is not None else ()
        if quant_buckets and key is None:
            raise ValueError("int8sr rounds need the per-tree key")
        quant = scale_rows = None
        if quant_buckets:
            # the rows' key-independent half and the scales depend on g3
            # alone: made once a tree, each quantized round only draws
            quant = prequantize_rows(g3)
            # a round's slot scales: the tree's where it quantized, ones
            # on the others (the JAX ``scaled`` rounds)
            qrows = quant[1].expand(2 * K, 3).contiguous()
            scale_rows = (qrows, torch.ones_like(qrows))
        store = _PackedStore(L, L1, dev, use_mc)
        # int8 passes: the tree's rows rounded once a scale tile
        rows8 = NearestRows(g3)

        leaf_id = torch.zeros(N, dtype=torch.int32, device=dev)
        hist0 = hist_wave_fn(binned, g3, leaf_id, 1, deep=False,
                             rows8=rows8)[0]
        use_sub = L * hist0.numel() * 4 <= _SUB_STATE_CAP_BYTES
        root_sum = root_sums(g3)
        out0 = leaf_output(root_sum[0], root_sum[1], params)
        if params.path_smooth > 0:
            out0 = smooth_output(out0, root_sum[2], 0.0, params)
        res0 = find_best_split(hist0[None], root_sum[None], meta,
                               node_feature_masks(key, [0], base_mask,
                                                  bynode), params,
                               depth=torch.zeros(1, dtype=torch.int64,
                                                 device=dev),
                               parent_output=out0[None], key=key, uids=[0])
        st = store.init(res0, out0)
        leaf_box = None
        if use_inter:
            # each leaf's bin-space box [lo, hi) along every feature
            leaf_box = torch.zeros((L, F, 2), dtype=torch.int64, device=dev)
            leaf_box[0, :, 1] = meta.num_bins
        leaf_hist = None
        if use_sub:
            leaf_hist = torch.zeros((L,) + tuple(hist0.shape),
                                    dtype=torch.float32, device=dev)
            leaf_hist[0] = hist0
        kiota = torch.arange(K, device=dev)
        nl = 1
        round_splits = []           # each round's split count, in order

        def route(lid, feats, thrs, dls, nls, slot_of):
            """This round's splits applied to the train rows' leaf ids:
            the new leaf ids and each row's go-left decision and slot."""
            row_slot = slot_of[lid.long()]
            in_split = row_slot >= 0
            rs = row_slot.clamp(min=0)
            f_row = feats[rs]
            b_row = bins_of_rows(binned, f_row, packed).long()
            gl = go_left_rule(b_row, thrs[rs], dls[rs],
                              meta.missing_type[f_row], meta.nan_bin[f_row],
                              meta.zero_bin[f_row])
            new = torch.where(in_split & ~gl, nls[rs].to(torch.int32), lid)
            return new, gl, in_split, rs

        def to_slot(v, fill, width):
            out = torch.full((width,) + tuple(v.shape[1:]), fill,
                             dtype=v.dtype, device=dev)
            out[:v.shape[0]] = v
            return out

        def boundary(vals, leafs):
            """A round of ``n`` splits, the kept ranks' gains and leaves
            (a prefix of the ranking — gains sorted, budget a prefix —
            but for intermediate mode's deferrals): their store rows, the
            children's sums, outputs, bounds, depths and mask and the
            slot bucket S."""
            n = vals.shape[0]
            order = torch.arange(n, device=dev)
            b = dict(vals=vals, leafs=leafs, order=order,
                     nodes=nl - 1 + order, nls=nl + order)
            rd = store.read(st, b["leafs"])
            b.update(rd)
            lsums, rsums = rd["lsums"], rd["rsums"]
            b["sm_left"] = lsums[:, 2] <= rsums[:, 2]    # smaller child
            b["cleafs"] = torch.stack([b["leafs"], b["nls"]],
                                      dim=1).reshape(2 * n)
            b["csums"] = torch.stack([lsums, rsums], dim=1).reshape(2 * n, 3)
            pconstr = rd["pconstr"]
            if use_inter:
                # fresh bounds from the adjacent leaves' current outputs
                pconstr = intermediate_constraints(
                    leaf_box, st["ft"][:, store.OUT], nl, inter_feats,
                    inter_types)[leafs]
            out_l = clamp_out(lsums, pconstr, rd["pout"])
            out_r = clamp_out(rsums, pconstr, rd["pout"])
            b["couts"] = torch.stack([out_l, out_r], dim=1).reshape(2 * n)
            b["cconstr"] = None
            if use_mc:
                c_l, c_r = child_constraints(
                    pconstr, out_l, out_r, meta.monotone_type[rd["feats"]],
                    use_inter)
                b["cconstr"] = torch.stack([c_l, c_r], dim=1) \
                    .reshape(2 * n, 2)
            b["cdepth"] = (rd["pdepth"] + 1).repeat_interleave(2)
            # each child's uid (left 2 node + 1, right 2 node + 2): its
            # mask's draw, or the tree's mask, and its extra_trees draw
            b["cuids"] = torch.stack([2 * b["nodes"] + 1, 2 * b["nodes"] + 2],
                                     dim=1).reshape(2 * n)
            b["cmask"] = node_feature_masks(key, b["cuids"], base_mask,
                                            bynode)
            b["S"] = slot_buckets[sum(n > s for s in slot_buckets[:-1])]
            return b

        def slot_route(b):
            """The round's splits as (S,) slot arrays, the fused round's
            routing input (dead slots carry leaf id L, the JAX ``to_slot``
            fill)."""
            S = b["S"]
            return dict(feats=to_slot(b["feats"], 0, S),
                        thrs=to_slot(b["thrs"], 0, S),
                        dls=to_slot(b["dls"], False, S),
                        leafs=to_slot(b["leafs"], L, S),
                        nls=to_slot(b["nls"], 0, S), num_leaves=L)

        def commit(b, res):
            """Tree assembly + frontier commit of a round's children."""
            round_splits.append(b["leafs"].shape[0])
            depth_ok = (max_depth <= 0) | (b["cdepth"] < max_depth)
            cgain = torch.where(depth_ok, res.gain,
                                torch.full_like(res.gain, NEG_INF))
            lsums, rsums = b["lsums"], b["rsums"]
            store.write(st, dict(
                res=res, cgain=cgain, cidx=b["cleafs"], nidx=b["nodes"],
                leafs=b["leafs"], nls=b["nls"], feats=b["feats"],
                thrs=b["thrs"], dls=b["dls"],
                mtypes=meta.missing_type[b["feats"]], vals=b["vals"],
                pout=b["pout"], psum=lsums + rsums, csums=b["csums"],
                couts=b["couts"], cdepth=b["cdepth"], parent=b["parent"],
                was_left=b["was_left"], cconstr=b["cconstr"]))
            if use_inter:
                # the children's boxes: the parent's cut at thr + 1 along
                # the split feature
                ki = torch.arange(b["leafs"].shape[0], device=dev)
                pbox = leaf_box[b["leafs"]]
                box_l, box_r = pbox.clone(), pbox.clone()
                box_l[ki, b["feats"], 1] = b["thrs"] + 1
                box_r[ki, b["feats"], 0] = b["thrs"] + 1
                leaf_box[b["leafs"]] = box_l
                leaf_box[b["nls"]] = box_r

        while nl < L:
            if fused_loop_fn is not None:
                # ---- a segment: R rounds in one launch (K6), replayed ----
                packed_r, leaf_id, pool, n_split = fused_loop_fn(
                    binned, g3, leaf_id,
                    st["ft"][:, store.GAIN:store.DEPTH + 1], nl, key,
                    K=K, slot_buckets=slot_buckets,
                    quant_buckets=quant_buckets, quant=quant,
                    max_depth=max_depth,
                    base_mask=base_mask, pool=leaf_hist, rows8=rows8)
                counts = n_split.tolist()        # the segment's host read
                for r, n in enumerate(counts):
                    if n == 0:
                        break
                    vals, leafs = _topk_by_rank(store.gains(st), K)
                    b = boundary(vals[:n], leafs[:n])
                    commit(b, unpack_children(packed_r[r][:2 * n],
                                              num_bins))
                    nl += n
                leaf_hist = pool
                if 0 in counts:
                    break
                continue

            vals, leafs = _topk_by_rank(store.gains(st), K)
            valid = (vals > 0) & (kiota < L - nl)
            if use_inter and K > 1:
                valid = defer_adjacent(valid, leaf_box[leafs], inter_feats)
                keep = valid.nonzero()[:, 0]
                vals, leafs = vals[keep], leafs[keep]
            n = int(valid.sum())                 # the round's host read
            if n == 0:
                break
            b = boundary(vals[:n], leafs[:n])
            S = b["S"]
            leafs, order, sm_left = b["leafs"], b["order"], b["sm_left"]
            # sustained rounds of a big wave may run the deep precision
            deep = S == K and K >= 32 and len(slot_buckets) > 1
            # the quantized buckets' rounding key (per tree and round)
            rkey = round_key(key, nl) if S in quant_buckets else None
            nsl = S if use_sub else 2 * S
            # quantized grows fold the scales in (ones on the rounds that
            # did not quantize), the dequantization never a pass of its own
            scale = scale_rows[rkey is None][:nsl] if quant_buckets else None
            if fused_round_fn is not None:
                # ---- the routed fused round (K2) ------------------------
                rt = slot_route(b)
                picks, h_slot, leaf_id = fused_round_fn(
                    binned, g3, S, deep=deep, quant_key=rkey,
                    zq=None if quant is None else quant[0], scale=scale,
                    mask=to_slot(b["cmask"], False, 2 * S),
                    csums=to_slot(b["csums"], 1.0, 2 * S),
                    sml=to_slot(sm_left, False, S) if use_sub else None,
                    parent=(to_slot(leaf_hist[leafs], 0.0, S) if use_sub
                            else None),
                    route=dict(rt, leaf_id=leaf_id),
                    constr=(to_slot(b["cconstr"], 0.0, 2 * S) if use_mc
                            else None),
                    depth=to_slot(b["cdepth"], 1, 2 * S),
                    pout=to_slot(b["couts"], 0.0, 2 * S), rows8=rows8)
                if use_sub:
                    # the subtraction the round ran, again on the emitted
                    # smaller children, for the per-leaf state
                    hist = subtract_child_hists(h_slot, leaf_hist, leafs,
                                                order, sm_left,
                                                slot_scale=scale)
                res = unpack_children(picks[:2 * n], num_bins)
            else:
                # ---- partition + labelling + histogram at bucket S ------
                feats, thrs, dls, nls = b["feats"], b["thrs"], b["dls"], \
                    b["nls"]
                slot_of = torch.full((L + 1,), -1, dtype=torch.long,
                                     device=dev)
                slot_of[leafs] = order
                new_leaf_id, gl, in_split, rs = route(
                    leaf_id, feats, thrs, dls, nls, slot_of)
                if use_sub:
                    # label only the SMALLER child of each split
                    in_small = gl == sm_left[rs]
                    label = torch.where(in_split & in_small, rs, S)
                else:
                    label = torch.where(in_split, 2 * rs + (~gl).long(),
                                        2 * S)
                label = label.to(torch.int32).contiguous()
                if rkey is not None:
                    # stochastic-rounded integer histograms
                    h_slot = hist_wave_quant_fn(binned, quant[0], label, nsl,
                                                rkey)
                else:
                    h_slot = hist_wave_fn(binned, g3, label, nsl, deep=deep,
                                          rows8=rows8)
                leaf_id = new_leaf_id

                if use_sub:
                    hist = subtract_child_hists(h_slot, leaf_hist, leafs,
                                                order, sm_left,
                                                slot_scale=scale)
                    scale = None
                else:
                    hist = h_slot[:2 * n]        # slot 2s + side = child
                    if scale is not None:
                        scale = scale[:2 * n]
                res = find_best_split(hist, b["csums"], meta, b["cmask"],
                                      params, hist_scale=scale,
                                      constraint=b["cconstr"],
                                      depth=b["cdepth"],
                                      parent_output=b["couts"], key=key,
                                      uids=b["cuids"])
            commit(b, res)
            if use_sub:
                leaf_hist[b["cleafs"]] = hist
            nl += n

        tree = store.finalize(st, nl)
        vlids = route_valid_sets(store, st, round_splits, valids,
                                 num_leaves=L, meta=meta, packed=packed)
        return tree, leaf_id, root_sum, vlids

    grow.routes_valids = True
    return grow
