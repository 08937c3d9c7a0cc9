"""The fused wave round (K2) and the valid-set routing (K3) on the card,
and their plain versions.

Counterpart of the two Pallas kernels of lightgbmv1_tpu/ops/wave_fused.py.
``fused_round`` replaces ``_fused_kernel`` (reached through
``fused_wave_scan`` / ``make_fused_round``): one routed wave round —
go-left decisions -> new leaf ids and the row -> slot label, each row
chunk's list of live rows (label below nslots), the slots' histograms over
those lists, the parent subtraction and each child's per-feature split
scan -> a (2S, F, ``RES_COLS``) residue.  ``route_rows`` replaces
``_route_only_kernel`` (``fused_route_rows``): a row set routed through a
tree's rounds of splits in one launch, where the TPU kernel takes one
round a launch (the ids are integers and nobody reads them between the
rounds, so all rounds at once give the same ids).  Both are written by
hand in CUDA C++ (``csrc/wave_fused.cu``; its head note says what bounds
them and how the design answers it).  K2's histograms are K1's device
code on the same label under K1's plan (``hist_cuda.plan`` at nslots + 1
slots), walking only the listed rows in row order, so they equal K1's bit
for bit.

``fused_round_ref`` and ``route_rows_ref`` are the plain PyTorch versions:
``route_tile`` on the decision bins (round after round for K3), the list
(``live_rows_ref``), K1's plain histogram of the listed rows
(``hist_cuda.index_add_hist`` on the precision's parts), the subtraction
and the staged scan's stages (``split.scan_residue``).  A CPU tensor
takes them; a CUDA tensor launches the kernel or raises.

The constrained legs (JAX :346-357, :440-475: ``use_mc`` with
``monotone_penalty``, path smoothing, ``max_delta_step``, ``has_contri``)
are the scan's options (``scan_cuda.scan_options``): K2 takes the
children's bounds ``constraint``, penalty factors ``pfac`` and parent
outputs ``parent_output`` (``split.scan_inputs``), and its scan stage is
the split-scan kernel's device code (``scan_child``), compiled with the
legs in (instance ``kOptAll``) for a launch that runs any; the
unconstrained round keeps the unconstrained instance.  Such a launch's
bucket mode ends ``":opts<bits>"``.

int8sr rounds (``precision="int8sr"``, ``hist_dtype_deep=int8sr``): K2
takes the quantized rows (exact integers, ops/quantize.py) and sums its
histograms as int32 (K1's ``int8sr`` leg), ``hsmall`` is the raw integer
histogram, and ``scale`` carries the dequantization: the slots' (S, 3)
scales multiply the smaller child before the subtraction (the Pallas
kernel's ``apply_scale``), or pool-free the children's (2S, 3) scales
multiply the prefix sums after the integer cumulative sum
(``child_scale``).  Every scale is a power of two, so each multiply is
exact.

int8 rounds (``precision="int8"``, ``hist_dtype=int8`` /
``hist_dtype_deep=int8``): K2 takes the f32 rows, and they are rounded to
nearest under one scale a tile of the Pallas round's own row tile
(``hist_cuda.round_row_tile`` at nslots + 1 slots; the quantize kernel,
or a tree's ``rows8``, ``quantize.NearestRows``); the list walk sums
them as K1's int8 leg does, and the scales are every row's of a tile,
listed or not.  The plain version sums the label's rows in the Pallas
kernel's order (``hist_cuda.int8_hist``).

4-bit packed bins (``packed=True``, ``bin_layout=packed4``): both
kernels take the (ceil(F/2), N) bytes of ``hist_cuda.pack4bit`` and
decode the nibble at the load; F is the real feature count (the mask's
width), so the plan, the lists and every cell's row order, and with them
the bits, are the u8 leg's.  The plain versions unpack
(``hist_cuda.unpack4bit``) or decode the decision bins
(``wave_fused.decision_bins(..., packed=True)``).

Each launch adds one to ``launch_counts[name]`` (the packed leg's to
``name + "_packed"``), and K2's also to ``bucket_launch_counts[(nslots,
precision, mode)]`` (mode ``"sub"`` / ``"pool"``, packed ``"sub:packed"``
/ ``"pool:packed"``); each plain call adds one to ``plain_counts[name]``.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _build, hist_cuda
from . import wave_fused as wf
from .split import FeatureMeta, SplitParams, scan_residue

launch_counts = {"fused_round": 0, "route_rows": 0, "fused_round_packed": 0,
                 "route_rows_packed": 0}
# K3's 16-bit leg (int16 bins), apart from the byte legs above
int16_launch_counts = {"route_rows": 0}
# the launches of K2 by (nslots, precision, mode)
bucket_launch_counts: dict = {}
plain_counts = {"fused_round": 0, "route_rows": 0}
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for d in (launch_counts, plain_counts, int16_launch_counts):
            for k in d:
                d[k] = 0
        bucket_launch_counts.clear()


def count_plain(name: str) -> None:
    with _count_lock:
        plain_counts[name] += 1


def route_rows_ref(binned, lids, feats, rmeta, num_leaves, packed=False,
                   offsets=None):
    """Plain version of ``route_rows``: ``route_tile`` on each row's
    decision bin, round after round (``offsets``; None: one round)."""
    count_plain("route_rows")
    bounds = [0, rmeta.shape[0]] if offsets is None else offsets.tolist()
    for o0, o1 in zip(bounds[:-1], bounds[1:]):
        dbin = wf.decision_bins(binned, lids, feats[o0:o1], rmeta[o0:o1, 0],
                                num_leaves, packed=packed)
        lids = wf.route_tile(dbin, lids, rmeta[o0:o1], nslots=0, sub=False,
                             want_label=False)[0]
    return lids


def live_rows_ref(label, nslots, n_chunks, chunk_rows):
    """Plain version of K2's and K6's list stage: for each row chunk of
    the histogram plan, the rows whose label is below ``nslots`` (the rows
    the round's histograms add), in row order -> ``(rows (n_chunks *
    chunk_rows,) i32, counts (n_chunks,) i32)``.  Chunk c's rows are
    ``rows[c * chunk_rows:][:counts[c]]``; the rest of its span is -1."""
    live = (label < nslots).nonzero()[:, 0]            # rows, rising
    chunk = live // chunk_rows
    counts = torch.bincount(chunk, minlength=n_chunks)
    start = torch.cumsum(counts, 0) - counts
    pos = chunk * chunk_rows + torch.arange(live.numel(),
                                            device=label.device) - start[chunk]
    rows = torch.full((n_chunks * chunk_rows,), -1, dtype=torch.int32,
                      device=label.device)
    rows[pos] = live.to(torch.int32)
    return rows, counts.to(torch.int32)


def fused_round_ref(binned, g3, *, nslots, num_bins, precision,
                    meta: FeatureMeta, params: SplitParams, mask, csums,
                    route, sml=None, parent=None, packed=False, scale=None,
                    constraint=None, pfac=None, parent_output=None,
                    rows8=None):
    """Plain version of ``fused_round``: the route (``route_tile``), K1's
    plain histogram of the label, the subtraction and
    ``split.scan_residue``."""
    count_plain("fused_round")
    return round_ref(binned, g3, nslots=nslots, num_bins=num_bins,
                     precision=precision, meta=meta, params=params,
                     mask=mask, csums=csums, route=route, sml=sml,
                     parent=parent, packed=packed, scale=scale,
                     constraint=constraint, pfac=pfac,
                     parent_output=parent_output, rows8=rows8)


def round_ref(binned, g3, *, nslots, num_bins, precision, meta: FeatureMeta,
              params: SplitParams, mask, csums, route, sml=None,
              parent=None, packed=False, scale=None, constraint=None,
              pfac=None, parent_output=None, rows8=None):
    """``fused_round_ref`` uncounted: the round the persistent loop's plain
    version (ops/loop_cuda.py) runs R times.  The histograms sum the
    listed rows only, in row order (``live_rows_ref`` under K2's plan):
    the rows of no split add nothing either way.  Packed bins are
    unpacked first (F is the mask's width)."""
    if packed:
        binned = hist_cuda.unpack4bit(binned, mask.shape[1])
    sub = parent is not None
    dbin = wf.decision_bins(binned, route["oleaf"], route["feats"],
                            route["rmeta"][:, 0], route["num_leaves"])
    new_leaf, label = wf.route_tile(dbin, route["oleaf"], route["rmeta"],
                                    nslots=nslots, sub=sub)
    F, N = binned.shape
    if precision == "int8":
        # the label's rows in the Pallas kernel's tile order, under the
        # scales of every row of a tile
        T = hist_cuda.round_row_tile(nslots, F, num_bins)
        q, qscale = hist_cuda.int8_rows(g3, T, rows8)
        h = hist_cuda.int8_hist(binned, q, qscale, T, label, nslots + 1,
                                num_bins, live_slots=nslots)[:nslots]
    else:
        p = hist_cuda.plan(N, F, nslots + 1, num_bins, precision)
        rows, _ = live_rows_ref(label, nslots, p["n_chunks"],
                                p["chunk_rows"])
        rows = rows[rows >= 0].long()
        h = hist_cuda.index_add_hist(
            binned[:, rows],
            [v[rows] for v in hist_cuda.split_parts(g3, precision)],
            label[rows], nslots + 1, num_bins)[:nslots]
    hc = wf.subtract_children(h, parent, sml, scale) if sub else h
    residue = scan_residue(hc, mask, csums, meta=meta, params=params,
                           hist_scale=None if sub else scale,
                           constraint=constraint, pfac=pfac,
                           parent_output=parent_output)
    return residue, (h if sub else None), new_leaf, label


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("wave_fused")
    lib.lgbm_fused_round.argtypes = [_P] * 25 + [_I] * 11 + [_F] * 8 \
        + [_I, _P, _I, _P]
    lib.lgbm_fused_round.restype = _I
    lib.lgbm_route_rows.argtypes = [_P] * 7 + [_I] * 4 + [_P]
    lib.lgbm_route_rows.restype = _I
    return lib


def _need(t, name, dtype, shape, device):
    if t is None or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                         f"{dtype} tensor on {device}")


def _check_bins(binned, packed=False, num_features=None):
    """(stored columns, N) of bins on the card (``hist_cuda.check_bins``)."""
    if binned.device.type != "cuda":
        raise ValueError(f"binned on {binned.device}: expected cpu or cuda")
    return hist_cuda.check_bins(binned, packed, num_features)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def list_scratch_sizes(N, n_chunks, span) -> tuple:
    """The i32 words of the list stage's scratch: the 256-row tiles' live
    counts, the chunks' row lists and their slots (``span`` = n_chunks x
    chunk_rows each) and the chunks' counts."""
    return (-(-N // hist_cuda.ROW_TILE), span, span, n_chunks)


def list_scratch(N, n_chunks, span, device) -> list:
    """The list stage's scratch (``list_scratch_sizes``), uninitialised."""
    return [torch.empty(n, dtype=torch.int32, device=device)
            for n in list_scratch_sizes(N, n_chunks, span)]


def route_rows(binned, lids, feats, rmeta, num_leaves, packed=False,
               offsets=None):
    """K3: (N,) leaf ids of ``binned``'s rows, from ``lids``, after the
    splits of ``rmeta`` (P, RMETA_COLS) on the features ``feats`` (P,),
    in rounds: round q's splits are rows ``offsets[q]:offsets[q + 1]``
    (``offsets`` (R + 1,) i32, rising from 0 to P; None: one round, R =
    1).  ``packed``: ``binned`` holds packed bytes.  (F, N) int16 bins
    (``max_bin > 255``) take the kernel's 16-bit leg
    (``int16_launch_counts["route_rows"]``)."""
    if binned.device.type == "cpu":
        return route_rows_ref(binned, lids, feats, rmeta, num_leaves, packed,
                              offsets)
    wide = binned.dtype == torch.int16
    if wide:
        if packed or binned.dim() != 2 or not binned.is_contiguous():
            raise ValueError("int16 bins must be a contiguous (F, N) tensor "
                             "(never packed)")
        N = binned.shape[1]
    else:
        _, N = _check_bins(binned)
    P = rmeta.shape[0]
    dev = binned.device
    _need(lids, "lids", torch.int32, (N,), dev)
    _need(feats, "feats", torch.int32, (P,), dev)
    _need(rmeta, "rmeta", torch.int32, (P, wf.RMETA_COLS), dev)
    R = 1
    if offsets is not None:
        R = offsets.shape[0] - 1
        _need(offsets, "offsets", torch.int32, (R + 1,), dev)
        if R < 1:
            raise ValueError("offsets must hold R + 1 >= 2 round bounds")
    out = torch.empty(N, dtype=torch.int32, device=dev)
    # scratch for the kernel's tables where they pass a block's shared
    # memory: P Slots (an rmeta row and its feature), each round's leaf
    # order (2 P), the R + 1 offsets
    tab = torch.empty(P * (wf.RMETA_COLS + 3) + R + 1, dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().lgbm_route_rows(
            binned.data_ptr(), lids.data_ptr(), feats.data_ptr(),
            rmeta.data_ptr(), 0 if offsets is None else offsets.data_ptr(),
            out.data_ptr(), tab.data_ptr(), N, P, R,
            2 if wide else int(packed), stream)
    _raise_on(err, "route_rows")
    with _count_lock:
        if wide:
            int16_launch_counts["route_rows"] += 1
        else:
            launch_counts["route_rows_packed" if packed
                          else "route_rows"] += 1
    return out


def fused_round(binned, g3, *, nslots, num_bins, precision,
                meta: FeatureMeta, params: SplitParams, mask, csums, route,
                sml=None, parent=None, packed=False, scale=None,
                constraint=None, pfac=None, parent_output=None, rows8=None):
    """K2: one wave round -> ``(residue (2S, F, RES_COLS), hsmall (S, F,
    B, 3) or None, new_leaf (N,), label (N,))``.

    ``parent`` (S, F, B, 3) f32 and ``sml`` (S,) bool select the
    subtraction mode (``nslots = S``); without them the round is
    pool-free (``nslots = 2S``).  ``route`` (dict ``oleaf`` (N,) i32,
    ``feats`` (S,) i32, ``rmeta`` (S, RMETA_COLS) i32, ``num_leaves``)
    gives the label and the new leaf ids from the current ones.  ``mask``
    (2S, F) bool and ``csums`` (2S, 3) f32 are the children's; the scan
    reads the meta's feature table (``split.with_tables``).  ``packed``:
    ``binned`` holds the (ceil(F/2), N) packed bytes of the F =
    ``mask.shape[1]`` features (num_bins <= 16).
    ``scale`` (nslots, 3) f32: the slots' dequantization (the subtraction
    mode's smaller children, or pool-free every child after its integer
    cumulative sum); ``precision="int8sr"``: ``g3`` holds quantized rows
    and the histograms are integer.  ``constraint`` (2S, 2), ``pfac``
    (2S,) and ``parent_output`` (2S,): the children's inputs of the scan's
    constrained legs (``split.scan_inputs``), None where a leg is off or
    at its default (``NO_CONSTRAINT``, 0); the legs themselves follow
    ``meta`` and ``params`` (``scan_cuda.scan_options``).  ``precision="int8"``: ``g3`` holds the
    f32 rows, rounded under the round's scale tiles
    (``hist_cuda.round_row_tile``) by the quantize kernel or taken from
    ``rows8`` (a tree's ``quantize.NearestRows``)."""
    if binned.device.type == "cpu":
        return fused_round_ref(binned, g3, nslots=nslots,
                               num_bins=num_bins, precision=precision,
                               meta=meta, params=params, mask=mask,
                               csums=csums, route=route, sml=sml,
                               parent=parent, packed=packed, scale=scale,
                               constraint=constraint, pfac=pfac,
                               parent_output=parent_output, rows8=rows8)
    from .scan_cuda import leg_args, scan_floats
    F = mask.shape[1]
    _, N = _check_bins(binned, packed, F)
    if not packed and binned.shape[0] != F:
        raise ValueError(f"binned has {binned.shape[0]} features, the mask "
                         f"{F}")
    if precision not in hist_cuda.PRECISIONS:
        raise ValueError(f"precision={precision!r}: expected one of "
                         f"{hist_cuda.PRECISIONS}")
    if packed and num_bins > 16:
        raise ValueError(f"num_bins={num_bins}: packed bins hold <= 16")
    sub = parent is not None
    S = nslots if sub else nslots // 2
    if S < 1 or (not sub and nslots % 2):
        raise ValueError(f"nslots={nslots}: expected S >= 1 (subtraction) "
                         "or 2S (pool-free)")
    B, C, dev = int(num_bins), 2 * S, binned.device
    _need(g3, "g3", torch.float32, (N, 3), dev)
    _need(mask, "mask", torch.bool, (C, F), dev)
    _need(csums, "csums", torch.float32, (C, 3), dev)
    if scale is not None:
        _need(scale, "scale", torch.float32, (nslots, 3), dev)
    if sub:
        _need(sml, "sml", torch.bool, (S,), dev)
        _need(parent, "parent", torch.float32, (S, F, B, 3), dev)
    _need(route["oleaf"], "oleaf", torch.int32, (N,), dev)
    _need(route["feats"], "feats", torch.int32, (S,), dev)
    _need(route["rmeta"], "rmeta", torch.int32, (S, wf.RMETA_COLS), dev)
    label = torch.empty(N, dtype=torch.int32, device=dev)
    new_leaf = torch.empty(N, dtype=torch.int32, device=dev)
    qscale, T = None, 0
    if precision == "int8":
        T = hist_cuda.round_row_tile(nslots, F, B)
        g3, qscale = hist_cuda.int8_rows(g3, T, rows8)
    p = hist_cuda.plan(N, F, nslots + 1, B, precision, T)
    lists = list_scratch(N, p["n_chunks"], p["n_chunks"] * p["chunk_rows"],
                         dev)
    partial = torch.empty((p["n_chunks"], F, nslots + 1, p["nb"], p["nc"]),
                          dtype=hist_cuda.partial_dtype(precision),
                          device=dev)
    residue = torch.empty((C, F, wf.RES_COLS), dtype=torch.float32,
                          device=dev)
    hsmall = torch.empty((S, F, B, 3), dtype=torch.float32, device=dev) \
        if sub else None
    _need(meta.table, "meta.table", torch.int32, (5, F), dev)
    opts, legs = leg_args(meta, params, C, dev, constraint, pfac,
                          parent_output)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().lgbm_fused_round(
            binned.data_ptr(), g3.data_ptr(), route["oleaf"].data_ptr(),
            route["feats"].data_ptr(), route["rmeta"].data_ptr(),
            label.data_ptr(), new_leaf.data_ptr(),
            *[t.data_ptr() for t in lists], partial.data_ptr(),
            meta.table.data_ptr(), mask.data_ptr(), csums.data_ptr(), ptr(sml),
            ptr(parent), ptr(scale), residue.data_ptr(), ptr(hsmall),
            legs["constraint"], legs["pfac"], legs["parent_output"],
            legs["mono"], legs["contri"], N, F, S, p["nb"], B, p["ls_max"],
            p["n_chunks"],
            p["chunk_rows"], hist_cuda.PREC_ID[precision], int(sub),
            int(packed), *scan_floats(params), opts,
            0 if qscale is None else qscale.data_ptr(), T, stream)
    _raise_on(err, "fused_round")
    with _count_lock:
        launch_counts["fused_round_packed" if packed else "fused_round"] += 1
        mode = ("sub" if sub else "pool") + (":packed" if packed else "") \
            + (f":opts{opts}" if opts else "")
        key = (nslots, precision, mode)
        bucket_launch_counts[key] = bucket_launch_counts.get(key, 0) + 1
    return residue, hsmall, new_leaf, label
