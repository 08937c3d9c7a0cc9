"""The persistent wave loop (K6) on the card, and its plain version.

Counterpart of lightgbmv1_tpu/ops/wave_fused.py ``_loop_kernel`` (reached
through ``make_fused_wave_loop``): R consecutive wave rounds in one launch,
the frontier state kept on the device between them.  A round is the
single round K2 runs (ops/fused_cuda.py) plus the boundary before it and
the pick and commit after it: top-k over the frontier gains, the live
count and its slot bucket, route + label, the smaller children's (or,
pool-free, all children's) histograms, subtraction, split scan, the
cross-feature pick (``wave_fused._pick_pack``), then the children's
frontier rows and, in subtraction mode, their pool rows.  The kernel is
written by hand in CUDA C++ (``csrc/wave_loop.cu``; its head note says
what bounds it and how the design answers it) and launched cooperatively:
its stages are K2's device code, separated by grid barriers.

``fused_wave_loop_ref`` is the plain PyTorch version: ``loop_rounds``
with K2's plain round (``fused_cuda.round_ref``).  ``loop_rounds`` with
``round_fn=fused_cuda.fused_round`` is R launches of K2 with the same
boundary, pick and commit in PyTorch, which the kernel equals bit for bit
on the card.  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.  On the card an opt-in ``debug`` buffer
takes block 0's stamps after each grid barrier and each round's live
rows; ``stage_split`` reads it.

int8sr (``quant_buckets``, ``hist_dtype_deep=int8sr``): a round whose
bucket quantizes draws its uniforms in the kernel from ``fold_in(key,
8_000_011 + nl)`` (csrc/prng.cuh, the quantize kernel's functions) on
the tree's prequantized rows (``quant = quantize.prequantize_rows(g3)``,
made once a tree by the grower) and sums them as integers; the launch's
other rounds run at ``precision``, and every round carries the grow's
scales (ones where it did not quantize), as the single round does.
``loop_rounds`` quantizes each such round with ``quantize.sr_quantize``
(its plain version under the plain round) before the round.

int8 (``precision="int8"``, ``hist_dtype=int8``): each round runs K2's
int8 leg at its bucket's scale tile (``hist_cuda.round_row_tile`` at the
bucket's slots) on the tree's rows rounded under it (``rows8``, a tree's
``quantize.NearestRows``, made before the launch: one (q, scale) pair a
distinct tile), so the loop is R single rounds bit for bit.  An int8
launch never runs int8sr buckets (``plan_wave_loop`` refuses it).

4-bit packed bins (``packed=True``, ``bin_layout=packed4``): the kernel's
packed leg runs the packed route and list walk of K2's device code on the
(ceil(F/2), N) bytes of ``hist_cuda.pack4bit``; its plans are the real F's
(``base_mask``'s width), so its rounds are the u8 leg's, bit for bit.  The
plain version unpacks once (``hist_cuda.unpack4bit``) and runs the u8
plain version.

The constrained legs K6 runs (JAX :951, :1127-1151: ``has_contri``,
path smoothing, ``max_delta_step``): each child's output is smoothed
toward its parent's and clamped (``split.child_leaf_output``, the
frontier commit's output column) and is the scan's parent output, the
scan's options are those of ``scan_cuda.scan_options`` (the kernel's
``kLoopOpts`` instance of its scan stage beside the unconstrained one).
Monotone constraints stay out of the loop, as the JAX planner keeps them
(``MONOTONE_REASON``); ``fused_wave_loop`` raises on them.

Each launch adds one to ``launch_counts["fused_wave_loop"]`` (packed:
``"fused_wave_loop_packed"``) and to ``bucket_launch_counts[(R,
precision, mode)]`` (mode ``"sub"`` / ``"pool"``, packed ``"sub:packed"``
/ ``"pool:packed"``, with ``":int8sr"`` after it when a bucket
quantizes, then ``":opts<bits>"`` when the scan runs its legs); each plain
call adds one to ``plain_counts["fused_wave_loop"]``.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ..utils import prng
from . import _build, fused_cuda, hist_cuda, quantize, scan_cuda
from . import wave_fused as wf
from .split import (NEG_INF, FeatureMeta, SplitParams, child_leaf_output,
                    gain_shift, pick_pack)

# plan_wave_loop's reasons word for word (JAX wave_fused.py:876-882)
MONOTONE_REASON = ("monotone constraints propagate per-round bounds "
                   "outside the kernel")
INT8SR_REASON = ("int8sr-in-loop needs the exact-integer f32 accumulate "
                 "(hist_dtype=f32)")

# the stages of a round in the kernel's debug stamps, in order: each
# ends at a grid barrier ("pick": the pick, the commit and the next
# round's boundary)
LOOP_STAGES = ("route", "list", "partials", "scan", "pick")

launch_counts = {"fused_wave_loop": 0, "fused_wave_loop_packed": 0}
# the launches of K6 by (rounds, precision, mode)
bucket_launch_counts: dict = {}
plain_counts = {"fused_wave_loop": 0}
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for k in launch_counts:
            launch_counts[k] = 0
        plain_counts["fused_wave_loop"] = 0
        bucket_launch_counts.clear()


def loop_rounds(binned, g3, leaf_id, ft12, num_leaves, *, rounds, K,
                slot_buckets, max_depth, base_mask, num_bins, precision,
                meta: FeatureMeta, params: SplitParams, pool=None,
                round_fn=fused_cuda.round_ref, packed=False, key=None,
                quant_buckets=(), quant=None, rows8=None):
    """``rounds`` wave rounds from the frontier ``ft12`` (L, 12) at
    ``num_leaves`` leaves, each through ``round_fn`` (a fused round's
    signature, given ``packed``) -> ``(packed (R, 2K, PACK_COLS),
    new_leaf (N,), pool or None, n_split (R,) i32)``.  Round r's packed
    rows [0, 2 S_r) are its slots' picks (the live ones first), the rest
    zero; a round with no split ends the loop, and it and the rounds
    after it stay zero.  The boundary, pick and commit are the grower's
    (models/grower_wave.py) op for op, so the frontier after a round is
    the split store's.  A round of a bucket in ``quant_buckets`` runs on
    the prequantized rows ``quant = (zq, scale3)`` rounded under
    ``fold_in(key, 8_000_011 + nl)`` at ``int8sr``; with quantized
    buckets every round carries scales.  ``rows8``: the int8 rounds' rows
    (``quantize.NearestRows``)."""
    from ..models.grower_wave import _topk_by_rank

    dev = binned.device
    L = ft12.shape[0]
    C = 2 * K
    sub = pool is not None
    ft = ft12.clone()
    pool = pool.clone() if sub else None
    leaf = leaf_id
    picks = torch.zeros((rounds, C, wf.PACK_COLS), dtype=torch.float32,
                         device=dev)
    n_split = torch.zeros(rounds, dtype=torch.int32, device=dev)
    kiota = torch.arange(K, device=dev)
    nl = int(num_leaves)
    scaled = bool(quant_buckets)
    if scaled:
        zq, scale3 = quant
        ones3 = torch.ones_like(scale3)
        draw = (quantize.sr_quantize_ref if round_fn is fused_cuda.round_ref
                else quantize.sr_quantize)
    for r in range(rounds):
        vals, leafs = _topk_by_rank(ft[:, 0], K)
        n = int(((vals > 0) & (kiota < L - nl)).sum())
        if n == 0:
            break
        S = slot_buckets[sum(n > b for b in slot_buckets[:-1])]
        leafs = leafs[:n]
        rows = ft[leafs]
        feats, thrs = rows[:, 1].long(), rows[:, 2].long()
        dls = rows[:, 3] != 0
        lsums, rsums = rows[:, 4:7], rows[:, 7:10]
        sml = lsums[:, 2] <= rsums[:, 2]
        nls = nl + torch.arange(n, device=dev)
        # the children's outputs, smoothed toward their parent's: the
        # commit's and, under path smoothing, the scan's parent outputs
        pout = rows[:, 10].repeat_interleave(2)

        def to_slot(v, fill, width=S):
            out = torch.full((width,) + tuple(v.shape[1:]), fill,
                             dtype=v.dtype, device=dev)
            out[:v.shape[0]] = v
            return out

        feats_s = to_slot(feats, 0)
        rmeta = wf.pack_route_meta(feats_s, to_slot(thrs, 0),
                                   to_slot(dls, False), to_slot(leafs, L),
                                   to_slot(nls, 0), meta,
                                   sml=to_slot(sml, False))
        csums = torch.stack([lsums, rsums], dim=1).reshape(2 * n, 3)
        csums_s = to_slot(csums, 1.0, 2 * S)
        couts = child_leaf_output(csums, params, parent_out=pout)
        pout_s = (to_slot(couts, 0.0, 2 * S) if params.path_smooth > 0
                  else None)
        mask = to_slot(base_mask[None, :].expand(2 * n, base_mask.shape[0]),
                       False, 2 * S)
        nsl = S if sub else 2 * S
        g3r, prec, scale = g3, precision, None
        if scaled:
            sc3 = ones3
            if S in quant_buckets:
                g3r = draw(zq, prng.fold_in(key, 8_000_011 + nl))
                prec, sc3 = "int8sr", scale3
            scale = sc3[None, :].expand(nsl, 3).contiguous()
        residue, hsm, leaf, _ = round_fn(
            binned, g3r, nslots=nsl, num_bins=num_bins,
            precision=prec, meta=meta, params=params, mask=mask,
            csums=csums_s, sml=to_slot(sml, False) if sub else None,
            parent=to_slot(pool[leafs], 0.0) if sub else None,
            route=dict(oleaf=leaf, feats=feats_s.to(torch.int32), rmeta=rmeta,
                       num_leaves=L), packed=packed, scale=scale,
            parent_output=pout_s, rows8=rows8)
        pk = pick_pack(residue, gain_shift(csums_s, params, pout_s), csums_s,
                       meta, num_bins)
        picks[r, :2 * S] = pk
        n_split[r] = n
        # ---- the commit: the store's frontier columns, the pool --------
        cidx = torch.stack([leafs, nls], dim=1).reshape(2 * n)
        cdepth = (rows[:, 11].long() + 1).repeat_interleave(2)
        depth_ok = (max_depth <= 0) | (cdepth < max_depth)
        live = pk[:2 * n]
        cgain = torch.where(depth_ok, live[:, 0],
                            torch.full_like(live[:, 0], NEG_INF))
        ft[cidx] = torch.cat([cgain[:, None], live[:, 1:], couts[:, None],
                              cdepth.to(torch.float32)[:, None]], dim=1)
        if sub:
            pool[cidx] = wf.subtract_children(
                hsm[:n], pool[leafs], sml,
                None if scale is None else scale[:n])
        nl += n
    return picks, leaf, pool, n_split


def fused_wave_loop_ref(binned, g3, leaf_id, ft12, num_leaves,
                        packed=False, **kw):
    """Plain version of ``fused_wave_loop``: ``loop_rounds`` on K2's plain
    round (packed bins unpacked once)."""
    with _count_lock:
        plain_counts["fused_wave_loop"] += 1
    if packed:
        binned = hist_cuda.unpack4bit(binned, kw["base_mask"].shape[0])
    return loop_rounds(binned, g3, leaf_id, ft12, num_leaves, **kw)


_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_uint


@functools.cache
def _lib(int8: bool = False) -> ctypes.CDLL:
    """K6's library: ``csrc/wave_loop.cu`` (the float legs), or with
    ``int8`` ``csrc/wave_loop_int8.cu`` (the int8 leg), built apart so the
    two build in parallel."""
    lib = _build.load("wave_loop_int8" if int8 else "wave_loop")
    lib.lgbm_fused_wave_loop.argtypes = [_P] * 10 + [_U] * 2 + [_P] * 14 \
        + [_I] * 13 + [_F] * 8 + [_I, _P]
    lib.lgbm_fused_wave_loop.restype = _I
    lib.lgbm_wave_loop_limits.argtypes = [_I] * 7 + [_P, _P, _P]
    lib.lgbm_wave_loop_limits.restype = _I
    lib.lgbm_wave_loop_bnd_ints.argtypes = [_I, _I]
    lib.lgbm_wave_loop_bnd_ints.restype = _I
    lib.lgbm_wave_loop_debug_words.argtypes = [_I]
    lib.lgbm_wave_loop_debug_words.restype = _I
    return lib


def debug_buffer(rounds: int, device) -> torch.Tensor:
    """K6's debug buffer for ``rounds`` rounds on a card, sized by the
    kernel's library (``lgbm_wave_loop_debug_words``): block 0's entry
    stamp, the first boundary's, then each round's ``LOOP_STAGES`` stamps
    and its live rows, as ``stage_split`` reads them."""
    return torch.zeros(_lib().lgbm_wave_loop_debug_words(int(rounds)),
                       dtype=torch.int64, device=device)


def stage_split(debug: torch.Tensor, n_split) -> list:
    """Per live round of a launch: its stages' durations in microseconds
    (``LOOP_STAGES``) and its live rows, from the debug buffer."""
    d = [int(x) for x in debug.tolist()]
    w = len(LOOP_STAGES) + 1
    out, prev = [], d[1]
    for r, n in enumerate(int(x) for x in n_split):
        if n == 0:
            break
        st = d[2 + r * w: 2 + (r + 1) * w]
        out.append({"n_split": n, "live_rows": st[-1], **{
            name: (st[i] - (prev if i == 0 else st[i - 1])) / 1e3
            for i, name in enumerate(LOOP_STAGES)}})
        prev = st[len(LOOP_STAGES) - 1]
    return out


def bucket_tiles(F, num_bins, precision, slot_buckets, sub) -> list:
    """Each ladder bucket's int8 scale tile (``hist_cuda.round_row_tile``
    at its nslots), or 0 at another precision."""
    return [hist_cuda.round_row_tile(S if sub else 2 * S, F, num_bins)
            if precision == "int8" else 0 for S in slot_buckets]


def bucket_plans(N, F, num_bins, precision, slot_buckets, sub,
                 quant_buckets=()) -> list:
    """K2's histogram plan (``hist_cuda.plan``) at each ladder bucket's
    nslots + 1 slots, precision (``int8sr`` for a quantized bucket) and
    int8 scale tile: the loop runs a round under its bucket's plan."""
    tiles = bucket_tiles(F, num_bins, precision, slot_buckets, sub)
    return [hist_cuda.plan(N, F, (S if sub else 2 * S) + 1, num_bins,
                           "int8sr" if S in quant_buckets else precision,
                           T or None)
            for S, T in zip(slot_buckets, tiles)]


def partial_floats(N, F, num_bins, precision, slot_buckets, sub,
                   quant_buckets=()) -> int:
    """The partial scratch (4-byte words) of the largest bucket's plan."""
    return max(p["n_chunks"] * F * ((S if sub else 2 * S) + 1) * p["nb"]
               * p["nc"] for S, p in zip(slot_buckets, bucket_plans(
                   N, F, num_bins, precision, slot_buckets, sub,
                   quant_buckets)))


def list_sizes(N, F, num_bins, precision, slot_buckets, sub,
               quant_buckets=()) -> tuple:
    """The list scratch of the buckets' largest plans: (chunks, chunks x
    chunk_rows); ``fused_cuda.list_scratch`` allocates it."""
    plans = bucket_plans(N, F, num_bins, precision, slot_buckets, sub,
                         quant_buckets)
    return (max(p["n_chunks"] for p in plans),
            max(p["n_chunks"] * p["chunk_rows"] for p in plans))


def limits(device, *, precision, sub, num_bins, N, F, L, K, slot_buckets,
           packed=False, quant_buckets=()) -> dict:
    """The card's limits on the loop kernel (``packed``: its packed leg)
    at this shape, F the real feature count: shared memory a block,
    resident blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    SMs, cooperative launch (``cudaDevAttrCooperativeLaunch``) and the
    device memory free to the loop."""
    plans = bucket_plans(N, F, num_bins, precision, slot_buckets, sub,
                         quant_buckets)
    ls_max = (ctypes.c_int * len(plans))(*[p["ls_max"] for p in plans])
    quant = (ctypes.c_int * len(plans))(*[int(S in quant_buckets)
                                          for S in slot_buckets])
    out = (ctypes.c_int * 4)()
    lib = _lib(precision == "int8")
    with torch.cuda.device(device):
        fused_cuda._raise_on(lib.lgbm_wave_loop_limits(
            hist_cuda.PREC_ID[precision], int(sub), int(packed),
            hist_cuda.kernel_width(num_bins), L, K, len(plans), ls_max,
            quant, out), "fused_wave_loop limits")
        free = torch.cuda.mem_get_info(device)[0] + (
            torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))
    return {"smem_bytes": out[0], "blocks_per_sm": out[1], "sms": out[2],
            "cooperative": bool(out[3]), "free_bytes": int(free)}


def fused_wave_loop(binned, g3, leaf_id, ft12, num_leaves, *, rounds, K,
                    slot_buckets, max_depth, base_mask, num_bins, precision,
                    meta: FeatureMeta, params: SplitParams, pool=None,
                    debug=None, packed=False, key=None,
                    quant_buckets=(), quant=None, q3=None, rows8=None):
    """K6: ``rounds`` wave rounds in one launch -> ``(packed (R, 2K,
    PACK_COLS), new_leaf (N,), pool or None, n_split (R,) i32)``, as
    ``loop_rounds`` computes them.

    ``ft12`` (L, 12) f32 is the frontier (the split store's columns gain
    .. depth), ``num_leaves`` the leaf count, ``base_mask`` (F,) bool the
    features a child may split on, ``slot_buckets`` the ladder; ``pool``
    (L, F, B, 3) f32 selects the subtraction mode.  The inputs are not
    modified; the scans read the meta's feature table
    (``split.with_tables``).  ``debug`` (card only): a
    ``debug_buffer(rounds, ...)`` that receives the stage stamps and live
    rows ``stage_split`` reads.  ``packed``: ``binned`` holds the
    (ceil(F/2), N) packed bytes of the F = ``base_mask.shape[0]``
    features (num_bins <= 16).  ``quant_buckets`` (a subset of the
    ladder) quantize their rounds under the tree's rounding ``key`` (two
    uint32 words) from ``quant`` = ``quantize.prequantize_rows(g3)``
    (the rows ``zq`` (N, 3) and the scales (3,)); ``q3`` (card only): an
    (N, 3) f32 buffer for the
    quantized rows, which after the launch holds the last quantized
    round's.  ``precision="int8"``: ``rows8`` (a tree's
    ``quantize.NearestRows``; None: quantized now) gives each bucket's
    rows rounded under its scale tile."""
    if (debug is not None or q3 is not None) \
            and binned.device.type != "cuda":
        raise ValueError("debug / q3: the card kernel's buffers")
    if meta.monotone_type is not None:
        raise ValueError(f"fused_wave_loop: {MONOTONE_REASON}")
    quant_buckets = tuple(int(S) for S in quant_buckets)
    if quant_buckets and (key is None or quant is None
                          or not set(quant_buckets) <= set(slot_buckets)):
        raise ValueError(f"quant_buckets={quant_buckets}: need the tree "
                         f"key, the prequantized rows and buckets of the "
                         f"ladder {slot_buckets}")
    if quant_buckets and precision == "int8":
        raise ValueError(f"fused_wave_loop: {INT8SR_REASON}")
    if binned.device.type == "cpu":
        return fused_wave_loop_ref(
            binned, g3, leaf_id, ft12, num_leaves, rounds=rounds, K=K,
            slot_buckets=slot_buckets, max_depth=max_depth,
            base_mask=base_mask, num_bins=num_bins, precision=precision,
            meta=meta, params=params, pool=pool, packed=packed, key=key,
            quant_buckets=quant_buckets, quant=quant, rows8=rows8)
    F = base_mask.shape[0]
    _, N = fused_cuda._check_bins(binned, packed, F)
    if not packed and binned.shape[0] != F:
        raise ValueError(f"binned has {binned.shape[0]} features, base_mask "
                         f"{F}")
    if packed and num_bins > 16:
        raise ValueError(f"num_bins={num_bins}: packed bins hold <= 16")
    if precision not in hist_cuda.FLOAT_PRECISIONS + ("int8",):
        raise ValueError(f"precision={precision!r}: expected one of "
                         f"{hist_cuda.FLOAT_PRECISIONS + ('int8',)} (a "
                         "quantized bucket's rounds: quant_buckets)")
    L, B, C, R, dev = ft12.shape[0], int(num_bins), 2 * K, int(rounds), \
        binned.device
    sub = pool is not None
    if R < 1 or not 1 <= len(slot_buckets) <= 8 or max(slot_buckets) > K:
        raise ValueError(f"rounds={R}, slot_buckets={slot_buckets}, K={K}: "
                         "expected rounds >= 1 and 1-8 buckets <= K")
    fused_cuda._need(g3, "g3", torch.float32, (N, 3), dev)
    fused_cuda._need(leaf_id, "leaf_id", torch.int32, (N,), dev)
    fused_cuda._need(ft12, "ft12", torch.float32, (L, 12), dev)
    fused_cuda._need(base_mask, "base_mask", torch.bool, (F,), dev)
    if sub:
        fused_cuda._need(pool, "pool", torch.float32, (L, F, B, 3), dev)
    if debug is not None:
        fused_cuda._need(debug, "debug", torch.int64,
                         (_lib(precision == "int8")
                          .lgbm_wave_loop_debug_words(R),), dev)
        debug.zero_()
    plans = bucket_plans(N, F, B, precision, slot_buckets, sub,
                         quant_buckets)
    tiles = bucket_tiles(F, B, precision, slot_buckets, sub)
    tables = (ctypes.c_int * (6 * len(plans)))(
        *slot_buckets, *[p["ls_max"] for p in plans],
        *[p["n_chunks"] for p in plans], *[p["chunk_rows"] for p in plans],
        *[int(S in quant_buckets) for S in slot_buckets], *tiles)
    q8 = None
    if precision == "int8":
        if rows8 is None:
            rows8 = quantize.NearestRows(g3)
        qs = [rows8(T) for T in tiles]
        q8 = (ctypes.c_void_p * (2 * len(qs)))(
            *[q.data_ptr() for q, _ in qs], *[sc.data_ptr() for _, sc in qs])
    lib = _lib(precision == "int8")
    f32, i32 = torch.float32, torch.int32
    new_leaf = leaf_id.clone()
    ft = ft12.clone()
    pool_out = pool.clone() if sub else None
    picks = torch.zeros((R, C, wf.PACK_COLS), dtype=f32, device=dev)
    n_split = torch.zeros(R, dtype=i32, device=dev)
    label = torch.empty(N, dtype=i32, device=dev)
    lists = fused_cuda.list_scratch(
        N, *list_sizes(N, F, B, precision, slot_buckets, sub, quant_buckets),
        dev)
    partial = torch.empty(partial_floats(N, F, B, precision, slot_buckets,
                                         sub, quant_buckets), dtype=f32,
                          device=dev)
    zq = qscale = None
    key_words = (0, 0)
    if quant_buckets:
        zq, scale3 = quant
        fused_cuda._need(zq, "zq", f32, (N, 3), dev)
        qscale = torch.cat([scale3, scale3, torch.ones(6, dtype=f32,
                                                       device=dev)])
        if q3 is None:
            q3 = torch.empty_like(zq)
        fused_cuda._need(q3, "q3", f32, (N, 3), dev)
        key_words = (int(key[0]) & prng.MASK32, int(key[1]) & prng.MASK32)
    else:
        q3 = None
    residue = torch.empty((C, F, wf.RES_COLS), dtype=f32, device=dev)
    bnd = torch.empty(lib.lgbm_wave_loop_bnd_ints(K, F), dtype=i32,
                      device=dev)
    mask = base_mask.to(torch.uint8)
    fused_cuda._need(meta.table, "meta.table", torch.int32, (5, F), dev)
    # the scan's legs; the kernel makes the children's outputs it smooths
    # toward (no monotone leg: refused above)
    opts = scan_cuda.scan_options(meta, params)
    contri = 0
    if opts & scan_cuda.OPT_CONTRI:
        fused_cuda._need(meta.contri, "meta.contri", f32, (F,), dev)
        contri = meta.contri.data_ptr()
    with torch.cuda.device(dev), _build.kernel_scope("fused_wave_loop"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lgbm_fused_wave_loop(
            binned.data_ptr(), g3.data_ptr(), new_leaf.data_ptr(),
            ft.data_ptr(), pool_out.data_ptr() if sub else 0,
            meta.table.data_ptr(), mask.data_ptr(),
            *[0 if t is None else t.data_ptr() for t in (zq, q3, qscale)],
            *key_words, picks.data_ptr(),
            n_split.data_ptr(), label.data_ptr(),
            *[t.data_ptr() for t in lists], partial.data_ptr(),
            residue.data_ptr(), bnd.data_ptr(),
            0 if debug is None else debug.data_ptr(), tables, contri, q8,
            N, F, B, hist_cuda.kernel_width(B), L, K, R, int(num_leaves),
            int(max_depth), len(plans), hist_cuda.PREC_ID[precision],
            int(sub), int(packed), *scan_cuda.scan_floats(params), opts,
            stream)
    fused_cuda._raise_on(err, "fused_wave_loop")
    with _count_lock:
        launch_counts["fused_wave_loop_packed" if packed
                      else "fused_wave_loop"] += 1
        bkey = (R, precision,
                ("sub" if sub else "pool") + (":packed" if packed else "")
                + (":int8sr" if quant_buckets else "")
                + (f":opts{opts}" if opts else ""))
        bucket_launch_counts[bkey] = bucket_launch_counts.get(bkey, 0) + 1
    return picks, new_leaf, pool_out, n_split
