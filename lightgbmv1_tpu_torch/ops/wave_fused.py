"""The single-pass wave round: route + histogram + subtraction + split scan.

Port of lightgbmv1_tpu/ops/wave_fused.py for the routed wave round
(``hist_method=fused``).  One round reads the binned matrix once: the
committed splits' go-left decisions relabel the rows, the smaller
children (or, pool-free, all children) are histogrammed from that label,
the larger sibling is its parent minus the smaller, and each child's
split scan runs per feature.  Only an O(F) residue a child (``RES_COLS``
floats a feature) leaves the scan; the cross-feature half of the pick
runs on it outside.  On the card that round is the hand-written CUDA
kernel K2 and the valid-set routing K3 (``ops/fused_cuda.py``,
``csrc/wave_fused.cu``); the functions here are the plain arithmetic both
share with the staged path, so a fused tree equals a staged one.  The
persistent loop (``wave_loop_rounds > 1``) runs R such rounds in one
launch, the hand-written kernel K6 on the card (``ops/loop_cuda.py``,
``csrc/wave_loop.cu``).

Ported: ``RES_COLS`` / ``PACK_COLS`` / ``RMETA_COLS`` (:126-128),
``route_tile`` (:134), ``pack_route_meta`` (:179), ``decision_bins``
(:197), ``child_scan_residue`` (:215), ``fused_route_rows`` (:567),
``_pick_pack`` (:610), ``pack_children`` / ``unpack_children`` (:641 /
:652), ``make_fused_round`` (:669), ``plan_wave_loop`` (:804),
``make_fused_wave_loop`` (:1183) and ``fused_ineligible_reason`` (:1356).
The arguments the port's scan never reads are gone: monotone
constraints, path smoothing, int8sr and packed4 bins are refused by the
config, so ``constr``, ``depth``, ``pout``, ``cscale`` / ``sscale``,
``quant_key``, ``meta_override`` and ``packed`` do not exist here.  The
JAX package's (1, T) row tiles are 1-D (T,) rows, and its per-child
``vmap`` is the leading batch axis C, as in ops/split.py.  There is no
counterpart of ``backend_lowers_fused``: the kernel builds and launches,
or the run raises.
"""

from __future__ import annotations

import functools

import torch

from ..io.binning import MISSING_NAN, MISSING_ZERO
from .split import (NEG_INF, FeatureMeta, SplitParams, SplitResult,
                    gain_shift, go_left_rule, scan_direction_gains,
                    scan_left_sums, scan_pick_feature, tie_tol)

RES_COLS = 6    # fbest, gain_at_sel, sel (direction*B+thr), left g/h/c
PACK_COLS = 10  # gain, feature, threshold, default_left, left(3), right(3)
RMETA_COLS = 8  # leaf, new-leaf, thr, default_left, mtype, nan_bin,
                # zero_bin, smaller-is-left — the packed per-slot split
                # metadata the routing stage reads (int32)


def route_tile(dbin, oleaf, rmeta, *, nslots, sub, want_label=True):
    """The decision stage on a set of rows (JAX :134): ``dbin`` (T,) each
    row's decision bin (the bin of its leaf's committed split feature),
    ``oleaf`` (T,) its current leaf, ``rmeta`` (S, RMETA_COLS) the slots'
    splits; dead slots carry leaf id ``num_leaves``, which no row has.

    Returns ``(new_leaf (T,), label (T,) or None)``: the updated leaf ids
    and (``want_label``) the row's histogram slot — the smaller child's
    slot in subtraction mode, ``2s + right`` pool-free, ``nslots`` for a
    row of no split.  Integer only, the JAX package's (S, T) sums term
    for term."""
    dbin = dbin.to(torch.int32)[None, :]
    oleaf = oleaf.to(torch.int32)[None, :]
    leafs, nls, thr = rmeta[:, 0:1], rmeta[:, 1:2], rmeta[:, 2:3]
    dl = rmeta[:, 3:4] != 0
    mt, nanb, zb = rmeta[:, 4:5], rmeta[:, 5:6], rmeta[:, 6:7]
    sml = rmeta[:, 7:8] != 0
    mine = oleaf == leafs                                    # (S, T)
    g = go_left_rule(dbin, thr, dl, mt, nanb, zb)            # (S, T)
    zero = torch.zeros((), dtype=torch.int32, device=rmeta.device)
    new_leaf = (oleaf + torch.where(mine & ~g, nls - oleaf, zero)
                .sum(dim=0, keepdim=True)).to(torch.int32)[0]
    if not want_label:
        return new_leaf, None
    siota = torch.arange(rmeta.shape[0], dtype=torch.int32,
                         device=rmeta.device)[:, None]
    if sub:
        hit = mine & (g == sml)
        slot = siota.expand(mine.shape)
    else:
        hit = mine
        slot = 2 * siota + (~g).to(torch.int32)
    label = (torch.where(hit, slot - nslots, zero).sum(dim=0, keepdim=True)
             + nslots).to(torch.int32)[0]
    return new_leaf, label


def pack_route_meta(feats, thrs, dls, leafs, nls, meta: FeatureMeta,
                    sml=None):
    """(S, RMETA_COLS) int32 routing metadata from slot-order split arrays
    and the feature meta — one place, so the train rows' routing and the
    valid sets' cannot pack differently."""
    f = feats.long()
    i32 = torch.int32
    z = torch.zeros_like(f, dtype=i32)
    return torch.stack([
        leafs.to(i32), nls.to(i32), thrs.to(i32), dls.to(i32),
        meta.missing_type[f].to(i32), meta.nan_bin[f].to(i32),
        meta.zero_bin[f].to(i32),
        sml.to(i32) if sml is not None else z], dim=1).contiguous()


def decision_bins(binned, lids, feats, leafs, num_leaves):
    """Each row's decision bin ``binned[f(leaf(row)), row]`` through a
    leaf -> feature table and one gather; rows of non-splitting leaves
    read feature 0 (their slot mask is False)."""
    tab = torch.zeros(num_leaves + 1, dtype=torch.long, device=lids.device)
    tab[leafs.long()] = feats.long()
    f_of = tab[lids.long()]                                  # (N,)
    return torch.gather(binned, 0, f_of[None, :])[0].to(torch.int32)


def child_scan_residue(hc, mask_c, csum_c, *, meta_blk: FeatureMeta,
                       params: SplitParams, num_bins, fblk):
    """The children's split scan -> their (C, fblk, RES_COLS) residue: the
    staged scan's own stages (``scan_left_sums`` ->
    ``scan_direction_gains`` -> ``scan_pick_feature``) on ``hc`` (C, fblk,
    B, 3), so the fused and the staged paths compute the same values.
    Columns: the feature's best gain, the gain at its pick, the pick
    ``direction * B + threshold`` and the left sums there."""
    left2 = scan_left_sums(hc, meta_blk)
    gains, shift = scan_direction_gains(left2, csum_c, meta_blk, mask_c,
                                        params)
    fbest, sel = scan_pick_feature(gains, shift, meta_blk)
    gains_f = torch.cat([gains[:, 0], gains[:, 1]], dim=2)   # (C, F, 2B)
    gsel = torch.gather(gains_f, 2, sel[..., None])[..., 0]
    C = hc.shape[0]
    ci = torch.arange(C, device=hc.device)[:, None]
    fi = torch.arange(fblk, device=hc.device)[None, :]
    lsel = left2[ci, sel // num_bins, fi, sel % num_bins]    # (C, F, 3)
    return torch.cat([fbest[..., None], gsel[..., None],
                      sel.to(torch.float32)[..., None], lsel], dim=2)


def subtract_children(hsm, parent, sml):
    """(2S, F, B, 3) child stack of a subtraction round: ``hsm`` the
    smaller children in slot order, the larger sibling its parent minus
    the smaller — the op order of ``subtract_child_hists``."""
    smL = (sml != 0)[:, None, None, None]
    h_left = torch.where(smL, hsm, parent - hsm)
    h_right = parent - h_left
    return torch.stack([h_left, h_right], dim=1).reshape(
        (2 * hsm.shape[0],) + tuple(hsm.shape[1:]))


def fused_route_rows(binned, lids, *, feats, thrs, dls, leafs, nls,
                     num_leaves, meta: FeatureMeta):
    """Route one row set through a round's committed splits with the same
    decision stage the round runs on the train rows — the valid-set lane
    (K3 on the card, ``fused_cuda.route_rows``).  Integer only, so equal
    to the staged routing."""
    from . import fused_cuda

    if lids.shape[0] == 0:
        return lids
    rmeta = pack_route_meta(feats, thrs, dls, leafs, nls, meta)
    return fused_cuda.route_rows(binned, lids,
                                 feats.to(torch.int32).contiguous(), rmeta,
                                 num_leaves)


def _pick_pack(residue_c, shift_c, parent_sum_c, meta: FeatureMeta,
               num_bins):
    """Cross-feature half of ``scan_pick`` on the children's (C, F,
    RES_COLS) residue, plus the tail of ``find_best_split`` (right sums,
    missing default direction): the (C, PACK_COLS) packed SplitInfo.
    Formula for formula the staged code on the same values."""
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


def pack_children(res: SplitResult) -> torch.Tensor:
    """Batched SplitResult -> the (C, PACK_COLS) rows."""
    f32 = torch.float32
    return torch.cat([res.gain.to(f32)[:, None],
                      res.feature.to(f32)[:, None],
                      res.threshold_bin.to(f32)[:, None],
                      res.default_left.to(f32)[:, None],
                      res.left_sum.to(f32), res.right_sum.to(f32)], dim=1)


def unpack_children(packed: torch.Tensor, num_bins: int) -> SplitResult:
    """(C, PACK_COLS) rows -> batched SplitResult."""
    return SplitResult(gain=packed[:, 0], feature=packed[:, 1].long(),
                       threshold_bin=packed[:, 2].long(),
                       default_left=packed[:, 3] != 0,
                       left_sum=packed[:, 4:7], right_sum=packed[:, 7:10])


def make_fused_round(*, meta: FeatureMeta, params: SplitParams, num_bins,
                     precision, deep_precision):
    """Build the grower-facing ``fused_round_fn`` (JAX :669).

    ``fused_round(binned, g3, S, *, deep, mask, csums, sml, parent, route)
    -> (packed (2S, PACK_COLS), hsmall (S, F, B, 3) or None, new_leaf
    (N,))``.

    * ``route`` (dict ``leaf_id (N,) / feats / thrs / dls / leafs / nls
      (S,) / num_leaves``) is the round's partition: the round evaluates
      the splits' go-left decisions while it sweeps the rows and returns
      the updated leaf ids.  The JAX package's unrouted form (a label
      made outside) has no caller in the port and is not ported.  The
      callable has ``supports_route = True`` and the valid-set router
      ``route_rows``.
    * ``parent`` (S, F, B, 3) with ``sml`` (S,) selects the subtraction
      mode (S smaller-child slots, and ``hsmall`` out); without it the
      round is pool-free (2S slots, ``hsmall`` None).
    * ``deep`` — a sustained-bucket round: it sums at ``deep_precision``.
    """
    from . import fused_cuda

    fmeta = fused_cuda.feature_table(meta)

    def fused_round(binned, g3, S, *, deep=False, mask, csums, sml=None,
                    parent=None, route):
        nslots = S if parent is not None else 2 * S
        route_in = dict(
            oleaf=route["leaf_id"],
            feats=route["feats"].to(torch.int32).contiguous(),
            rmeta=pack_route_meta(route["feats"], route["thrs"],
                                  route["dls"], route["leafs"],
                                  route["nls"], meta, sml=sml),
            num_leaves=route["num_leaves"])
        residue, hsmall, new_leaf, _ = fused_cuda.fused_round(
            binned, g3, nslots=nslots, num_bins=num_bins,
            precision=deep_precision if deep else precision, meta=meta,
            params=params, mask=mask, csums=csums, sml=sml, parent=parent,
            route=route_in, fmeta=fmeta)
        shift = gain_shift(csums, params)
        return _pick_pack(residue, shift, csums, meta, num_bins), hsmall, \
            new_leaf

    fused_round.supports_route = True
    fused_round.route_rows = functools.partial(fused_route_rows, meta=meta)
    return fused_round


_LOOP_MAX_ROUNDS = 64


def plan_wave_loop(*, rounds, N, F, num_bins, K, L, use_sub, slot_buckets,
                   precision, deep_precision, use_mc=False, limits=None):
    """Eligibility and size of the persistent wave loop (JAX :804), decided
    from shapes and knobs: the JAX dict's keys (``eligible``, ``rounds``,
    ``reason``, ``ladder`` and the byte counts) and the card's limits.

    Kept from the JAX planner, with its reasons word for word: ``rounds <=
    1`` is the single round, ``rounds`` is capped at ``_LOOP_MAX_ROUNDS``,
    monotone constraints keep the single round, and a reachable deep
    bucket (K >= 32, a multi-bucket ladder) needs ``deep_precision ==
    precision``: one precision, one kernel instance, for the whole launch.

    Replaced: the JAX lane, row-tile and VMEM gates are facts of Pallas on
    a TPU.  The card's own stand in their place when ``limits``
    (``loop_cuda.limits``) is given: cooperative launch, at least one
    resident block an SM at the kernel's shared memory, and the resident
    state and scratch within the device's free memory.  The row-tile gate
    has no counterpart: the loop runs each round at the bucket the single
    round picks and under that bucket's histogram plan, so its sums are
    partitioned exactly as K2's.  Without ``limits`` (the plain version on
    the CPU) the card's gates are not asked."""
    from .loop_cuda import partial_floats

    R = int(min(rounds, _LOOP_MAX_ROUNDS))
    B, C = num_bins, 2 * K
    state_bytes = L * 12 * 4 + 2 * N * 4 + (L * F * B * 3 * 4 if use_sub
                                            else 0)
    partial_bytes = 4 * partial_floats(N, F, B, precision, slot_buckets,
                                       use_sub)
    scratch_bytes = (N * 4 + partial_bytes + C * F * RES_COLS * 4
                     + R * C * PACK_COLS * 4)
    plan = dict(eligible=False, rounds=1, reason="",
                ladder=tuple(int(s) for s in slot_buckets),
                state_bytes=int(state_bytes),
                partial_bytes=int(partial_bytes),
                total_bytes=int(state_bytes + scratch_bytes))
    if limits is not None:
        plan.update({k: limits[k] for k in ("smem_bytes", "blocks_per_sm",
                                            "sms", "cooperative")})
    if rounds <= 1:
        plan["reason"] = "wave_loop_rounds=1 (single-round dispatch)"
        return plan
    if use_mc:
        plan["reason"] = ("monotone constraints propagate per-round "
                          "bounds outside the kernel")
        return plan
    if K >= 32 and len(slot_buckets) > 1 and deep_precision != precision:
        plan["reason"] = ("deep-precision drop would change the "
                          "accumulate dtype mid-loop")
        return plan
    if limits is not None:
        if not limits["cooperative"]:
            plan["reason"] = ("the device does not support cooperative "
                              "launch (cudaDevAttrCooperativeLaunch)")
            return plan
        if limits["blocks_per_sm"] < 1:
            plan["reason"] = (
                f"no block of the loop kernel is resident on an SM at "
                f"{limits['smem_bytes']} B of shared memory "
                "(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
            return plan
        if plan["total_bytes"] > limits["free_bytes"]:
            plan["reason"] = (
                f"resident state + scratch ({plan['total_bytes']} B) "
                f"exceeds the device's free memory "
                f"({limits['free_bytes']} B)")
            return plan
    plan["eligible"] = True
    plan["rounds"] = R
    return plan


def make_fused_wave_loop(*, meta: FeatureMeta, params: SplitParams,
                         num_bins, precision, deep_precision, rounds):
    """Build the grower-facing persistent wave loop (JAX :1183).

    ``fused_loop(binned, g3, leaf_id, ft12, num_leaves, *, K,
    slot_buckets, max_depth, base_mask, pool=None) -> (packed (R, 2K,
    PACK_COLS), new_leaf (N,), pool or None, n_split (R,) i32)``: R
    rounds in one launch (K6 on the card, ``ops/loop_cuda.py``), R =
    ``rounds`` capped at ``_LOOP_MAX_ROUNDS``.  ``ft12`` (L, 12) f32 is
    the frontier (the split store's columns gain .. depth); ``pool``
    selects the subtraction mode.  The per-round packed SplitInfo rows and
    split counts are all the grower's replay needs; the JAX package has no
    ``n_split`` output (its replay is traced), here it is the one host
    read of a segment.  The loop runs at ``precision``: the planner
    refuses a reachable deep bucket at another precision.

    ``fused_loop.rounds`` is R; ``fused_loop.plan(N=, F=, K=, L=,
    use_sub=, slot_buckets=, device=)`` is ``plan_wave_loop`` with the
    knobs bound here and, on a CUDA device, the card's limits.  ``rounds
    == 1`` is never built: the trainer runs the single round."""
    from . import fused_cuda, loop_cuda

    fmeta = fused_cuda.feature_table(meta)
    R = int(min(rounds, _LOOP_MAX_ROUNDS))

    def fused_loop(binned, g3, leaf_id, ft12, num_leaves, *, K,
                   slot_buckets, max_depth, base_mask, pool=None):
        return loop_cuda.fused_wave_loop(
            binned, g3, leaf_id, ft12.contiguous(), num_leaves, rounds=R,
            K=K, slot_buckets=tuple(slot_buckets), max_depth=max_depth,
            base_mask=base_mask, num_bins=num_bins, precision=precision,
            meta=meta, params=params, pool=pool, fmeta=fmeta)

    def plan(*, N, F, K, L, use_sub, slot_buckets, device):
        limits = None
        if torch.device(device).type == "cuda":
            limits = loop_cuda.limits(
                device, precision=precision, sub=use_sub, num_bins=num_bins,
                N=N, F=F, L=L, K=K, slot_buckets=tuple(slot_buckets))
        return plan_wave_loop(rounds=rounds, N=N, F=F, num_bins=num_bins,
                              K=K, L=L, use_sub=use_sub,
                              slot_buckets=slot_buckets, precision=precision,
                              deep_precision=deep_precision, limits=limits)

    fused_loop.rounds = R
    fused_loop.plan = plan
    return fused_loop


def fused_ineligible_reason(*, bin_dtype, num_bins) -> str:
    """Static eligibility gate (JAX :1356): the reason the fused round
    cannot run, or ``""``.  The port refuses categorical features, EFB
    bundles, packed bins and extra_trees before any round (config.py,
    io/dataset.py), so what remains to check is the bin type."""
    if torch.iinfo(bin_dtype).bits > 8:
        return "int16 bins exceed the uint8 one-hot kernel family"
    if num_bins > 256:
        return "num_bins > 256 exceeds the uint8 kernel family"
    return ""
