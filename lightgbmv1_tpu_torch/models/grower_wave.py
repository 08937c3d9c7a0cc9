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

With ``fused_round_fn`` (``hist_method=fused``, ops/wave_fused.py) a
round is the JAX package's single-pass routed round (JAX :787-799,
:1258-1272, :1318-1370, :1402-1429): no separate partition and histogram
pass — the fused round (the CUDA kernel K2 on the card) routes the rows,
histograms the label it made, subtracts and scans, and returns the new
leaf ids and the packed SplitInfo of the 2S slot children; the valid sets
go through ``fused_round_fn.route_rows`` (K3).  Dead slots carry leaf id
``L`` and child sums 1.0, as the JAX ``to_slot`` / ``to_cslot`` fill them;
a round's slot k is its rank k, so the slot -> rank gather is a prefix.
The root pass stays on ``hist_wave_fn`` (K1).

Categorical splits, monotone constraints, CEGB, per-node feature
sampling, interaction constraints, the quantized int8sr rounds and the
persistent wave loop (K6) are not ported (the config refuses them):
every child's feature mask is the tree's, and the split scan and the root
sums are the serial learner's own (the JAX version's ``split_fn`` /
``sums_fn`` hooks carry the cross-chip reductions, which the port has
not).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from ..ops.split import (NEG_INF, FeatureMeta, SplitParams,
                         child_leaf_output, find_best_split, go_left_rule,
                         leaf_output)
from ..ops.wave_fused import subtract_children, unpack_children
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


def subtract_child_hists(h_slot, leaf_hist, leafs, order_c, sm_left):
    """Smaller-child + parent-subtraction child histograms of one round
    (reference BeforeFindBestSplit + FeatureHistogram::Subtract):
    ``h_slot`` holds the measured smaller children in slot order, the
    larger sibling is the parent's stored histogram minus the smaller.
    Returns the rank-order interleaved (2K, F, B, 3) child stack."""
    return subtract_children(h_slot[order_c], leaf_hist[leafs], sm_left)


class _PackedStore:
    """The per-leaf frontier + tree-leaf state in one (L, 17) f32 table
    and the per-node tree state in one (L1, 10) f32 table (JAX :472).
    Ids, bins, depths and child indices ride as exact small f32 values;
    a round commits with one 2K-row frontier write, one K-row node write
    and one child-pointer fixup."""

    # frontier-table columns (per leaf)
    GAIN, FEAT, BIN, DL = 0, 1, 2, 3
    LS, RS = 4, 7                    # [4:7) left sums, [7:10) right sums
    OUT, DEPTH, ISLEFT = 10, 11, 12
    LVAL, LWEIGHT, LCNT, LPAR = 13, 14, 15, 16
    CF = 17
    # node-table columns (per internal node)
    NFEAT, NBIN, NDL, NMT, NGAIN, NIVAL, NIW, NIC, NLC, NRC = range(10)

    # The grower owns the tables, so a round's commit writes them in place
    # (the JAX version's functional update would copy both a round).
    def __init__(self, L, L1, device):
        self.L, self.L1, self.device = L, L1, device

    def init(self, res0, out0):
        ft = torch.zeros((self.L, self.CF), dtype=torch.float32,
                         device=self.device)
        ft[:, self.GAIN] = NEG_INF
        ft[:, self.LPAR] = -1.0
        z = torch.zeros((), dtype=torch.float32, device=self.device)
        ft[0] = torch.stack([
            res0.gain[0], res0.feature[0].float(),
            res0.threshold_bin[0].float(), res0.default_left[0].float(),
            *res0.left_sum[0], *res0.right_sum[0],
            out0, z, z, z, z, z, z - 1.0])
        nt = torch.zeros((self.L1, 10), dtype=torch.float32,
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
            r["nidx"].repeat_interleave(2).to(f32)[:, None]], dim=1)
        s["ft"][r["cidx"]] = crows
        nrows = torch.cat([
            r["feats"].to(f32)[:, None], r["thrs"].to(f32)[:, None],
            r["dls"].to(f32)[:, None], r["mtypes"].to(f32)[:, None],
            r["vals"][:, None], r["pout"][:, None],
            r["psum"][:, 1:2], r["psum"][:, 2:3],
            (-(r["leafs"] + 1)).to(f32)[:, None],
            (-(r["nls"] + 1)).to(f32)[:, None]], dim=1)
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


def make_wave_grower(*, num_leaves: int, num_bins: int, meta: FeatureMeta,
                     params: SplitParams, hist_wave_fn: Callable,
                     max_depth: int = -1, wave_size: int = 32,
                     fused_round_fn: Optional[Callable] = None):
    """Build ``grow(binned, g3, base_mask, valids=())``.

    ``hist_wave_fn(binned, g3, label, nslots, deep=False) -> (nslots, F,
    B, 3)``: histograms of the rows labelled 0..nslots-1 (``nslots`` is
    dead); ``deep`` marks a sustained round that may run the cheaper deep
    precision.  ``fused_round_fn`` (ops/wave_fused.make_fused_round) runs
    every round after the root as one routed fused round.  ``grow``
    returns ``(tree, leaf_id, root_sum, valid_leaf_ids)``:
    each valid set's rows routed through the same splits, so its score
    update is a leaf-value gather."""
    L = num_leaves
    L1 = max(L - 1, 1)
    K = max(1, min(wave_size, L1))

    def grow(binned: torch.Tensor, g3: torch.Tensor,
             base_mask: torch.Tensor, valids: Sequence[torch.Tensor] = ()):
        dev = binned.device
        N = binned.shape[1]
        F = base_mask.shape[0]
        slot_buckets = slot_buckets_for(K, N)
        store = _PackedStore(L, L1, dev)

        leaf_id = torch.zeros(N, dtype=torch.int32, device=dev)
        hist0 = hist_wave_fn(binned, g3, leaf_id, 1, deep=False)[0]
        use_sub = L * hist0.numel() * 4 <= _SUB_STATE_CAP_BYTES
        root_sum = g3.sum(dim=0)
        out0 = leaf_output(root_sum[0], root_sum[1], params)
        res0 = find_best_split(hist0[None], root_sum[None], meta,
                               base_mask[None], params)
        st = store.init(res0, out0)
        leaf_hist = None
        if use_sub:
            leaf_hist = torch.zeros((L,) + tuple(hist0.shape),
                                    dtype=torch.float32, device=dev)
            leaf_hist[0] = hist0
        vlids = [torch.zeros(v.shape[1], dtype=torch.int32, device=dev)
                 for v in valids]
        kiota = torch.arange(K, device=dev)
        nl = 1

        def route(matrix, lid, feats, thrs, dls, leafs, nls, slot_of):
            """This round's splits applied to (F, rows) bins + leaf ids:
            the new leaf ids and each row's go-left decision and slot."""
            row_slot = slot_of[lid.long()]
            in_split = row_slot >= 0
            rs = row_slot.clamp(min=0)
            f_row = feats[rs]
            b_row = torch.gather(matrix, 0, f_row[None, :])[0].long()
            gl = go_left_rule(b_row, thrs[rs], dls[rs],
                              meta.missing_type[f_row], meta.nan_bin[f_row],
                              meta.zero_bin[f_row])
            new = torch.where(in_split & ~gl, nls[rs].to(torch.int32), lid)
            return new, gl, in_split, rs

        while nl < L:
            vals, leafs = _topk_by_rank(store.gains(st), K)
            valid = (vals > 0) & (kiota < L - nl)
            n = int(valid.sum())                 # the round's host read
            if n == 0:
                break
            # the picks are a prefix of the ranking: keep the n live ranks
            vals, leafs = vals[:n], leafs[:n]
            order = torch.arange(n, device=dev)
            nodes = nl - 1 + order
            nls = nl + order
            rd = store.read(st, leafs)
            feats, thrs, dls = rd["feats"], rd["thrs"], rd["dls"]
            lsums, rsums = rd["lsums"], rd["rsums"]
            sm_left = lsums[:, 2] <= rsums[:, 2]         # smaller child
            cleafs = torch.stack([leafs, nls], dim=1).reshape(2 * n)
            csums = torch.stack([lsums, rsums], dim=1).reshape(2 * n, 3)
            out_l = child_leaf_output(lsums, params)
            out_r = child_leaf_output(rsums, params)
            couts = torch.stack([out_l, out_r], dim=1).reshape(2 * n)
            cdepth = (rd["pdepth"] + 1).repeat_interleave(2)
            depth_ok = (max_depth <= 0) | (cdepth < max_depth)
            cmask = base_mask[None, :].expand(2 * n, F)

            S = slot_buckets[sum(n > b for b in slot_buckets[:-1])]
            # sustained rounds of a big wave may run the deep precision
            deep = S == K and K >= 32 and len(slot_buckets) > 1
            if fused_round_fn is not None:
                # ---- the routed fused round (K2) + valid routing (K3) ----
                def to_slot(v, fill, width=S):
                    out = torch.full((width,) + tuple(v.shape[1:]), fill,
                                     dtype=v.dtype, device=dev)
                    out[:v.shape[0]] = v
                    return out

                rt = dict(feats=to_slot(feats, 0), thrs=to_slot(thrs, 0),
                          dls=to_slot(dls, False), leafs=to_slot(leafs, L),
                          nls=to_slot(nls, 0), num_leaves=L)
                parent = None
                if use_sub:
                    parent = to_slot(leaf_hist[leafs], 0.0)
                packed, h_slot, leaf_id = fused_round_fn(
                    binned, g3, S, deep=deep,
                    mask=to_slot(cmask, False, 2 * S),
                    csums=to_slot(csums, 1.0, 2 * S),
                    sml=to_slot(sm_left, False) if use_sub else None,
                    parent=parent,
                    route=dict(rt, leaf_id=leaf_id))
                vlids = [fused_round_fn.route_rows(vb, vl, **rt)
                         for vb, vl in zip(valids, vlids)]
                if use_sub:
                    # the subtraction the round ran, again on the emitted
                    # smaller children, for the per-leaf state
                    hist = subtract_child_hists(h_slot, leaf_hist, leafs,
                                                order, sm_left)
                res = unpack_children(packed[:2 * n], num_bins)
            else:
                # ---- partition + labelling + histogram at bucket S ------
                slot_of = torch.full((L + 1,), -1, dtype=torch.long,
                                     device=dev)
                slot_of[leafs] = order
                new_leaf_id, gl, in_split, rs = route(
                    binned, leaf_id, feats, thrs, dls, leafs, nls, slot_of)
                if use_sub:
                    # label only the SMALLER child of each split
                    in_small = gl == sm_left[rs]
                    label = torch.where(in_split & in_small, rs, S)
                    nsl = S
                else:
                    label = torch.where(in_split, 2 * rs + (~gl).long(),
                                        2 * S)
                    nsl = 2 * S
                vlids = [route(vb, vl, feats, thrs, dls, leafs, nls,
                               slot_of)[0] for vb, vl in zip(valids, vlids)]
                h_slot = hist_wave_fn(binned, g3,
                                      label.to(torch.int32).contiguous(),
                                      nsl, deep=deep)
                leaf_id = new_leaf_id

                if use_sub:
                    hist = subtract_child_hists(h_slot, leaf_hist, leafs,
                                                order, sm_left)
                else:
                    hist = h_slot[:2 * n]        # slot 2s + side = child
                res = find_best_split(hist, csums, meta, cmask, params)
            cgain = torch.where(depth_ok, res.gain,
                                torch.full_like(res.gain, NEG_INF))

            # ---- tree assembly + frontier commit -------------------------
            store.write(st, dict(
                res=res, cgain=cgain, cidx=cleafs, nidx=nodes,
                leafs=leafs, nls=nls, feats=feats, thrs=thrs, dls=dls,
                mtypes=meta.missing_type[feats], vals=vals, pout=rd["pout"],
                psum=lsums + rsums, csums=csums, couts=couts, cdepth=cdepth,
                parent=rd["parent"], was_left=rd["was_left"]))
            if use_sub:
                leaf_hist[cleafs] = hist
            nl += n

        tree = store.finalize(st, nl)
        return tree, leaf_id, root_sum, vlids

    return grow
