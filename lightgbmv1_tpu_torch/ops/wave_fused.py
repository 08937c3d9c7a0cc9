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
``csrc/wave_fused.cu``), and the pick after it the pick kernel
(``ops/scan_cuda.split_pick``, ``csrc/split_scan.cu``); the functions
here are the plain arithmetic both share with the staged path, so a
fused tree equals a staged one.  The
persistent loop (``wave_loop_rounds > 1``) runs R such rounds in one
launch, the hand-written kernel K6 on the card (``ops/loop_cuda.py``,
``csrc/wave_loop.cu``).

Ported: ``RES_COLS`` / ``PACK_COLS`` / ``RMETA_COLS`` (:126-128),
``route_tile`` (:134), ``pack_route_meta`` (:179), ``decision_bins``
(:197), ``fused_route_rows`` (:567), ``pack_children`` (:641),
``make_fused_round`` (:669), ``plan_wave_loop`` (:804),
``make_fused_wave_loop`` (:1183) and ``fused_ineligible_reason`` (:1356).
``child_scan_residue`` (:215), ``_pick_pack`` (:610) and
``unpack_children`` (:652) live in ops/split.py (``scan_residue``,
``pick_pack``, ``unpack_children``), where ``find_best_split`` finishes
its picks through the same functions.  The round's scan takes the
children's monotone bounds ``constr``, depths ``depth`` and parent
outputs ``pout`` (the constrained legs, JAX :346-357, :440-475: monotone
constraints with ``monotone_penalty``, path smoothing, ``max_delta_step``
and ``feature_contri``); ``meta_override`` (the feature-parallel
learner's) is not ported.  ``packed``
(4-bit packed bins, ``bin_layout=packed4``) is kept: the kernels' packed
legs decode the nibble at the load and plan from the real feature count,
so a packed round is the u8 round bit for bit.  So are the int8sr
rounds' ``quant_key`` / ``scale`` (``hist_dtype_deep=int8sr``): a
quantized round histograms the stochastically rounded rows
(ops/quantize.py) as exact integers and folds the dequantization into
the subtraction (``apply_scale``, the slots' scales) or, pool-free, into
the scan after its integer cumulative sum (``child_scale``); the loop
draws a quantized round's uniforms in its kernel from the same stream
(``quant_buckets``).  The plain int8
rounds (``hist_dtype=int8`` / ``hist_dtype_deep=int8``) histogram the
rows rounded to nearest under one scale a tile of the Pallas round's row
tile (``hist_cuda.round_row_tile``), which a grow keeps in ``rows8``
(``quantize.NearestRows``, once a tree and tile).  The
JAX package's (1, T) row tiles are 1-D (T,) rows, and its per-child
``vmap`` is the leading batch axis C, as in ops/split.py.  There is no
counterpart of ``backend_lowers_fused``: the kernel builds and launches,
or the run raises.
"""

from __future__ import annotations

import torch

from .hist_cuda import bins_of_rows
from .split import (FeatureMeta, SplitParams, SplitResult, go_left_rule,
                    scan_inputs)
from .split import unpack_children  # noqa: F401  (the fused path's name)

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


def decision_bins(binned, lids, feats, leafs, num_leaves, packed=False):
    """Each row's decision bin ``binned[f(leaf(row)), row]`` through a
    leaf -> feature table and one gather; rows of non-splitting leaves
    read feature 0 (their slot mask is False).  ``packed``: the nibble of
    the feature in its packed byte (``hist_cuda.packed_bins_of_rows``)."""
    tab = torch.zeros(num_leaves + 1, dtype=torch.long, device=lids.device)
    tab[leafs.long()] = feats.long()
    return bins_of_rows(binned, tab[lids.long()], packed)


def subtract_children(hsm, parent, sml, slot_scale=None):
    """(2S, F, B, 3) child stack of a subtraction round: ``hsm`` the
    smaller children in slot order, the larger sibling its parent minus
    the smaller — the op order of ``subtract_child_hists``, the
    dequantization (``slot_scale`` (S, 3), a quantized round's) first."""
    if slot_scale is not None:
        hsm = hsm * slot_scale[:, None, None, :]
    smL = (sml != 0)[:, None, None, None]
    h_left = torch.where(smL, hsm, parent - hsm)
    h_right = parent - h_left
    return torch.stack([h_left, h_right], dim=1).reshape(
        (2 * hsm.shape[0],) + tuple(hsm.shape[1:]))


def fused_route_rows(row_sets, *, feats, thrs, dls, leafs, nls, num_leaves,
                     meta: FeatureMeta, packed=False, offsets=None):
    """Route row sets through a tree's committed splits with the same
    decision the round runs on the train rows — the valid-set lane (K3 on
    the card, ``fused_cuda.route_rows``; ``packed``: its packed leg).
    ``row_sets``: (bins, leaf ids) pairs; the splits (P,) are in round
    order, round q's at ``offsets[q]:offsets[q + 1]`` (``offsets`` (R +
    1,) i32; None: one round, as the JAX function routes).  The splits are
    packed once and each set routed through every round in one launch.
    Integer only, so equal to the staged routing round by round."""
    from . import fused_cuda

    rmeta = pack_route_meta(feats, thrs, dls, leafs, nls, meta)
    feats = feats.to(torch.int32).contiguous()
    return [lids if lids.shape[0] == 0 else fused_cuda.route_rows(
        binned, lids, feats, rmeta, num_leaves, packed=packed,
        offsets=offsets) for binned, lids in row_sets]


def pack_children(res: SplitResult) -> torch.Tensor:
    """Batched SplitResult -> the (C, PACK_COLS) rows."""
    f32 = torch.float32
    return torch.cat([res.gain.to(f32)[:, None],
                      res.feature.to(f32)[:, None],
                      res.threshold_bin.to(f32)[:, None],
                      res.default_left.to(f32)[:, None],
                      res.left_sum.to(f32), res.right_sum.to(f32)], dim=1)


def make_fused_round(*, meta: FeatureMeta, params: SplitParams, num_bins,
                     precision, deep_precision, packed=False):
    """Build the grower-facing ``fused_round_fn`` (JAX :669).

    ``fused_round(binned, g3, S, *, deep, quant_key, zq, scale, mask,
    csums, sml, parent, route) -> (packed (2S, PACK_COLS), hsmall (S, F,
    B, 3) or None, new_leaf (N,))``.

    * ``route`` (dict ``leaf_id (N,) / feats / thrs / dls / leafs / nls
      (S,) / num_leaves``) is the round's partition: the round evaluates
      the splits' go-left decisions while it sweeps the rows and returns
      the updated leaf ids.  The JAX package's unrouted form (a label
      made outside) has no caller in the port and is not ported.  The
      callable has ``supports_route = True``; the valid sets are routed
      once a tree (``fused_route_rows``).
    * ``parent`` (S, F, B, 3) with ``sml`` (S,) selects the subtraction
      mode (S smaller-child slots, and ``hsmall`` out); without it the
      round is pool-free (2S slots, ``hsmall`` None).
    * ``deep`` — a sustained-bucket round: it sums at ``deep_precision``.
    * ``quant_key`` (the round key, two uint32 words) — an int8sr bucket:
      the tree's prequantized rows ``zq`` (``quantize.prequantize_rows``,
      made once a tree) are rounded under the key (``sr_quantize``, the
      quantize kernel on the card), the round sums them as integers
      (K2's ``int8sr`` leg) and ``hsmall`` is the raw integer histogram.
    * ``scale`` (nslots, 3) — the grow has quantized buckets: the round's
      dequantization scales (ones when it did not quantize), applied in
      the subtraction, or pool-free in the scan (the JAX ``scaled``
      rounds; JAX returns them, here the grower makes them once a tree).
    * ``packed`` — ``binned`` holds 4-bit packed bytes: the round runs
      its packed leg.
    * ``constr`` (2S, 2), ``depth`` (2S,), ``pout`` (2S,) — the children's
      monotone bounds, depths (the monotone penalty) and parent outputs
      (path smoothing), in child-slot order, dead children filled as the
      JAX ``to_cslot`` fills them (0.0, 1, 0.0); read only by the legs
      ``meta`` and ``params`` turn on (``split.scan_inputs``).
    * ``rows8`` — the tree's ``quantize.NearestRows`` of ``g3``, read by
      a round at ``int8`` (its rows rounded under the round's scale tile);
      None quantizes them in the round.
    """
    from . import fused_cuda, quantize, scan_cuda

    def fused_round(binned, g3, S, *, deep=False, quant_key=None, zq=None,
                    scale=None, mask, csums, sml=None, parent=None, route,
                    constr=None, depth=None, pout=None, rows8=None):
        nslots = S if parent is not None else 2 * S
        if quant_key is not None:
            g3u, prec = quantize.sr_quantize(zq, quant_key), "int8sr"
        else:
            g3u, prec = g3, deep_precision if deep else precision
        route_in = dict(
            oleaf=route["leaf_id"],
            feats=route["feats"].to(torch.int32).contiguous(),
            rmeta=pack_route_meta(route["feats"], route["thrs"],
                                  route["dls"], route["leafs"],
                                  route["nls"], meta, sml=sml),
            num_leaves=route["num_leaves"])
        legs = scan_inputs(meta, params, 2 * S, binned.device, constr,
                           depth, pout)
        residue, hsmall, new_leaf, _ = fused_cuda.fused_round(
            binned, g3u, nslots=nslots, num_bins=num_bins, precision=prec,
            meta=meta, params=params, mask=mask, csums=csums, sml=sml,
            parent=parent, route=route_in, packed=packed,
            scale=scale, rows8=rows8, **legs)
        packed_rows = scan_cuda.split_pick(
            residue, csums, meta=meta, params=params,
            parent_output=legs["parent_output"], num_bins=num_bins)
        return packed_rows, hsmall, new_leaf

    fused_round.supports_route = True
    return fused_round


_LOOP_MAX_ROUNDS = 64


def plan_wave_loop(*, rounds, N, F, num_bins, K, L, use_sub, slot_buckets,
                   precision, deep_precision, quant_buckets=(), use_mc=False,
                   packed=False, limits=None):
    """Eligibility and size of the persistent wave loop (JAX :804), decided
    from shapes and knobs: the JAX dict's keys (``eligible``, ``rounds``,
    ``reason``, ``ladder`` and the byte counts) and the card's limits.

    Kept from the JAX planner, with its reasons word for word: ``rounds <=
    1`` is the single round, ``rounds`` is capped at ``_LOOP_MAX_ROUNDS``,
    monotone constraints keep the single round, and a reachable deep
    bucket (K >= 32, a multi-bucket ladder, no quantized bucket) needs
    ``deep_precision == precision``: one precision, one kernel instance,
    for the whole launch.  The JAX gate that int8sr rounds need
    ``hist_dtype=f32`` is a fact of its f32 MXU accumulate: the card's
    kernel runs a quantized bucket's rounds on its int32 leg beside the
    launch's precision (``quant_buckets``), its shared memory sized for
    the larger of the two legs.  An int8 launch has no int8sr leg beside
    it, so ``precision="int8"`` with quantized buckets keeps the JAX reason.

    Replaced: the JAX lane, row-tile and VMEM gates are facts of Pallas on
    a TPU.  The card's own stand in their place when ``limits``
    (``loop_cuda.limits``) is given: cooperative launch, at least one
    resident block an SM at the kernel's shared memory, and the resident
    state and scratch within the device's free memory.  The row-tile gate
    has no counterpart: the loop runs each round at the bucket the single
    round picks and under that bucket's histogram plan (at int8 also its
    scale tile), so its sums are partitioned exactly as K2's.  Without
    ``limits`` (the plain version on the CPU) the card's gates are not
    asked.  ``packed`` (as the JAX
    planner): the resident bins are the packed bytes (``binned_bytes``);
    the plans stay the real F's, so packed and u8 loops share their
    partition."""
    from .fused_cuda import list_scratch_sizes
    from .loop_cuda import list_sizes, partial_floats

    R = int(min(rounds, _LOOP_MAX_ROUNDS))
    B, C = num_bins, 2 * K
    quant_buckets = tuple(int(S) for S in quant_buckets)
    state_bytes = L * 12 * 4 + 2 * N * 4 + (L * F * B * 3 * 4 if use_sub
                                            else 0)
    partial_bytes = 4 * partial_floats(N, F, B, precision, slot_buckets,
                                       use_sub, quant_buckets)
    list_bytes = 4 * sum(list_scratch_sizes(
        N, *list_sizes(N, F, B, precision, slot_buckets, use_sub,
                       quant_buckets)))
    # the prequantized rows and a quantized round's rows
    quant_bytes = 2 * N * 12 if quant_buckets else 0
    scratch_bytes = (N * 4 + list_bytes + partial_bytes + quant_bytes
                     + C * F * RES_COLS * 4 + R * C * PACK_COLS * 4)
    plan = dict(eligible=False, rounds=1, reason="",
                ladder=tuple(int(s) for s in slot_buckets),
                quant_ladder=quant_buckets,
                state_bytes=int(state_bytes),
                partial_bytes=int(partial_bytes),
                total_bytes=int(state_bytes + scratch_bytes),
                packed=bool(packed),
                binned_bytes=int((-(-F // 2) if packed else F) * max(N, 1)))
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
    if quant_buckets and precision == "int8":
        plan["reason"] = ("int8sr-in-loop needs the exact-integer f32 "
                          "accumulate (hist_dtype=f32)")
        return plan
    if (not quant_buckets and K >= 32 and len(slot_buckets) > 1
            and deep_precision != precision):
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
                         num_bins, precision, deep_precision, rounds,
                         packed=False):
    """Build the grower-facing persistent wave loop (JAX :1183).

    ``fused_loop(binned, g3, leaf_id, ft12, num_leaves, key=None, *, K,
    slot_buckets, quant_buckets=(), quant=None, max_depth, base_mask,
    pool=None) ->
    (packed (R, 2K, PACK_COLS), new_leaf (N,), pool or None, n_split (R,)
    i32)``: R
    rounds in one launch (K6 on the card, ``ops/loop_cuda.py``), R =
    ``rounds`` capped at ``_LOOP_MAX_ROUNDS``.  ``ft12`` (L, 12) f32 is
    the frontier (the split store's columns gain .. depth); ``pool``
    selects the subtraction mode.  The per-round packed SplitInfo rows and
    split counts are all the grower's replay needs; the JAX package has no
    ``n_split`` output (its replay is traced), here it is the one host
    read of a segment.  The loop runs at ``precision``: the planner
    refuses a reachable deep bucket at another precision.  The rounds of
    the ``quant_buckets`` (int8sr) run quantized under ``fold_in(key,
    8_000_011 + num_leaves)``, ``key`` the tree's, drawn in the kernel
    from ``quant`` = ``quantize.prequantize_rows(g3)``, made once a
    tree.  ``rows8`` (a tree's ``quantize.NearestRows``): the int8
    rounds' rows.

    ``fused_loop.rounds`` is R; ``fused_loop.plan(N=, F=, K=, L=,
    use_sub=, slot_buckets=, device=, quant_buckets=())`` is
    ``plan_wave_loop`` with the
    knobs bound here and, on a CUDA device, the card's limits.  ``rounds
    == 1`` is never built: the trainer runs the single round.  ``packed``:
    ``binned`` holds 4-bit packed bytes, and K6 runs its packed leg."""
    from . import loop_cuda

    R = int(min(rounds, _LOOP_MAX_ROUNDS))

    def fused_loop(binned, g3, leaf_id, ft12, num_leaves, key=None, *, K,
                   slot_buckets, quant_buckets=(), quant=None, max_depth,
                   base_mask, pool=None, rows8=None):
        return loop_cuda.fused_wave_loop(
            binned, g3, leaf_id, ft12.contiguous(), num_leaves, rounds=R,
            K=K, slot_buckets=tuple(slot_buckets), max_depth=max_depth,
            base_mask=base_mask, num_bins=num_bins, precision=precision,
            meta=meta, params=params, pool=pool, packed=packed,
            key=key, quant_buckets=tuple(quant_buckets), quant=quant,
            rows8=rows8)

    def plan(*, N, F, K, L, use_sub, slot_buckets, device,
             quant_buckets=()):
        limits = None
        if torch.device(device).type == "cuda":
            limits = loop_cuda.limits(
                device, precision=precision, sub=use_sub, num_bins=num_bins,
                N=N, F=F, L=L, K=K, slot_buckets=tuple(slot_buckets),
                packed=packed, quant_buckets=tuple(quant_buckets))
        return plan_wave_loop(rounds=rounds, N=N, F=F, num_bins=num_bins,
                              K=K, L=L, use_sub=use_sub,
                              slot_buckets=slot_buckets, precision=precision,
                              deep_precision=deep_precision,
                              quant_buckets=quant_buckets, packed=packed,
                              limits=limits)

    fused_loop.rounds = R
    fused_loop.plan = plan
    return fused_loop


def fused_ineligible_reason(*, bin_dtype, num_bins, params=None) -> str:
    """Static eligibility gate (JAX :1356): the reason the fused round
    cannot run, or ``""``, in the JAX order.  The port refuses
    categorical features and EFB bundles before any round (config.py,
    io/dataset.py), and packed bins run the kernels' packed legs, so what
    remains to check is the bin type and extra_trees."""
    if torch.iinfo(bin_dtype).bits > 8:
        return "int16 bins exceed the uint8 one-hot kernel family"
    if num_bins > 256:
        return "num_bins > 256 exceeds the uint8 kernel family"
    if params is not None and params.extra_trees:
        return "extra_trees draws per-node randomness inside the scan"
    return ""
