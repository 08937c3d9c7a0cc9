"""The fused wave round (K2) and the valid-set routing (K3) on the card,
and their plain versions.

Counterpart of the two Pallas kernels of lightgbmv1_tpu/ops/wave_fused.py.
``fused_round`` replaces ``_fused_kernel`` (reached through
``fused_wave_scan`` / ``make_fused_round``): one routed wave round —
go-left decisions -> new leaf ids and the row -> slot label, the slots'
histograms, the parent subtraction and each child's per-feature split scan
-> a (2S, F, ``RES_COLS``) residue.  ``route_rows`` replaces
``_route_only_kernel`` (``fused_route_rows``): a valid set routed through
one round's splits.  Both are written by hand in CUDA C++
(``csrc/wave_fused.cu``; its head note says what bounds them and how the
design answers it).  K2's histograms are K1's device code on the same
label under K1's plan (``hist_cuda.plan`` at nslots + 1 slots), so they
equal K1's bit for bit.

``fused_round_ref`` and ``route_rows_ref`` are the plain PyTorch versions:
``route_tile`` on the decision bins, K1's plain histogram
(``hist_cuda.index_add_hist`` on the precision's parts), the subtraction
and the staged scan's stages (``wave_fused.child_scan_residue``).  A CPU
tensor takes them; a CUDA tensor launches the kernel or raises.  Each
launch adds one to ``launch_counts[name]``, and K2's also to
``bucket_launch_counts[(nslots, precision, mode)]``; each plain call adds
one to ``plain_counts[name]``.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _build, hist_cuda
from . import wave_fused as wf
from .split import FeatureMeta, SplitParams

launch_counts = {"fused_round": 0, "route_rows": 0}
# the launches of ``launch_counts["fused_round"]`` by (nslots, precision,
# "sub" | "pool")
bucket_launch_counts: dict = {}
plain_counts = {"fused_round": 0, "route_rows": 0}
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for d in (launch_counts, plain_counts):
            for k in d:
                d[k] = 0
        bucket_launch_counts.clear()


def count_plain(name: str) -> None:
    with _count_lock:
        plain_counts[name] += 1


def route_rows_ref(binned, lids, feats, rmeta, num_leaves):
    """Plain version of ``route_rows``: ``route_tile`` on each row's
    decision bin."""
    count_plain("route_rows")
    dbin = wf.decision_bins(binned, lids, feats, rmeta[:, 0], num_leaves)
    return wf.route_tile(dbin, lids, rmeta, nslots=0, sub=False,
                         want_label=False)[0]


def fused_round_ref(binned, g3, *, nslots, num_bins, precision,
                    meta: FeatureMeta, params: SplitParams, mask, csums,
                    route, sml=None, parent=None):
    """Plain version of ``fused_round``: the route (``route_tile``), K1's
    plain histogram of the label, the subtraction and
    ``child_scan_residue``."""
    count_plain("fused_round")
    sub = parent is not None
    dbin = wf.decision_bins(binned, route["oleaf"], route["feats"],
                            route["rmeta"][:, 0], route["num_leaves"])
    new_leaf, label = wf.route_tile(dbin, route["oleaf"], route["rmeta"],
                                    nslots=nslots, sub=sub)
    h = hist_cuda.index_add_hist(binned, hist_cuda.split_parts(g3, precision),
                                 label, nslots + 1, num_bins)[:nslots]
    hc = wf.subtract_children(h, parent, sml) if sub else h
    residue = wf.child_scan_residue(hc, mask, csums, meta_blk=meta,
                                    params=params, num_bins=num_bins,
                                    fblk=binned.shape[0])
    return residue, (h if sub else None), new_leaf, label


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("wave_fused")
    lib.lgbm_fused_round.argtypes = [_P] * 15 + [_I] * 10 + [_F] * 5 + [_P]
    lib.lgbm_fused_round.restype = _I
    lib.lgbm_route_rows.argtypes = [_P] * 5 + [_I] * 2 + [_P]
    lib.lgbm_route_rows.restype = _I
    return lib


def feature_table(meta: FeatureMeta) -> torch.Tensor:
    """The (5, F) int32 feature table K2's scan reads: num_bins,
    missing_type, nan_bin, zero_bin, usable."""
    return torch.stack([meta.num_bins, meta.missing_type, meta.nan_bin,
                        meta.zero_bin, meta.usable.long()]) \
        .to(torch.int32).contiguous()


def _need(t, name, dtype, shape, device):
    if t is None or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                         f"{dtype} tensor on {device}")


def _check_bins(binned):
    if binned.device.type != "cuda":
        raise ValueError(f"binned on {binned.device}: expected cpu or cuda")
    if binned.dtype != torch.uint8 or binned.dim() != 2 \
            or not binned.is_contiguous():
        raise ValueError("binned must be a contiguous (F, N) uint8 tensor")
    F, N = binned.shape
    if F * max(N, 1) >= 2 ** 31:
        raise ValueError("binned exceeds the kernel's int32 row indexing")
    return F, N


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def route_rows(binned, lids, feats, rmeta, num_leaves):
    """K3: (N,) leaf ids of ``binned``'s rows after the splits of
    ``rmeta`` (S, RMETA_COLS) on the features ``feats`` (S,)."""
    if binned.device.type == "cpu":
        return route_rows_ref(binned, lids, feats, rmeta, num_leaves)
    F, N = _check_bins(binned)
    S = rmeta.shape[0]
    dev = binned.device
    _need(lids, "lids", torch.int32, (N,), dev)
    _need(feats, "feats", torch.int32, (S,), dev)
    _need(rmeta, "rmeta", torch.int32, (S, wf.RMETA_COLS), dev)
    out = torch.empty(N, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().lgbm_route_rows(binned.data_ptr(), lids.data_ptr(),
                                     feats.data_ptr(), rmeta.data_ptr(),
                                     out.data_ptr(), N, S, stream)
    _raise_on(err, "route_rows")
    with _count_lock:
        launch_counts["route_rows"] += 1
    return out


def fused_round(binned, g3, *, nslots, num_bins, precision,
                meta: FeatureMeta, params: SplitParams, mask, csums, route,
                sml=None, parent=None, fmeta=None):
    """K2: one wave round -> ``(residue (2S, F, RES_COLS), hsmall (S, F,
    B, 3) or None, new_leaf (N,), label (N,))``.

    ``parent`` (S, F, B, 3) f32 and ``sml`` (S,) bool select the
    subtraction mode (``nslots = S``); without them the round is
    pool-free (``nslots = 2S``).  ``route`` (dict ``oleaf`` (N,) i32,
    ``feats`` (S,) i32, ``rmeta`` (S, RMETA_COLS) i32, ``num_leaves``)
    gives the label and the new leaf ids from the current ones.  ``mask``
    (2S, F) bool and ``csums`` (2S, 3) f32 are the children's.
    ``fmeta`` is ``feature_table(meta)``, made once by a caller that runs
    many rounds."""
    if binned.device.type == "cpu":
        return fused_round_ref(binned, g3, nslots=nslots,
                               num_bins=num_bins, precision=precision,
                               meta=meta, params=params, mask=mask,
                               csums=csums, route=route, sml=sml,
                               parent=parent)
    F, N = _check_bins(binned)
    if precision not in hist_cuda.PRECISIONS:
        raise ValueError(f"precision={precision!r}: expected one of "
                         f"{hist_cuda.PRECISIONS}")
    sub = parent is not None
    S = nslots if sub else nslots // 2
    if S < 1 or (not sub and nslots % 2):
        raise ValueError(f"nslots={nslots}: expected S >= 1 (subtraction) "
                         "or 2S (pool-free)")
    B, C, dev = int(num_bins), 2 * S, binned.device
    _need(g3, "g3", torch.float32, (N, 3), dev)
    _need(mask, "mask", torch.bool, (C, F), dev)
    _need(csums, "csums", torch.float32, (C, 3), dev)
    if sub:
        _need(sml, "sml", torch.bool, (S,), dev)
        _need(parent, "parent", torch.float32, (S, F, B, 3), dev)
    _need(route["oleaf"], "oleaf", torch.int32, (N,), dev)
    _need(route["feats"], "feats", torch.int32, (S,), dev)
    _need(route["rmeta"], "rmeta", torch.int32, (S, wf.RMETA_COLS), dev)
    label = torch.empty(N, dtype=torch.int32, device=dev)
    new_leaf = torch.empty(N, dtype=torch.int32, device=dev)
    p = hist_cuda.plan(N, F, nslots + 1, B, precision)
    partial = torch.empty((p["n_chunks"], F, nslots + 1, p["nb"], p["nc"]),
                          dtype=torch.float32, device=dev)
    residue = torch.empty((C, F, wf.RES_COLS), dtype=torch.float32,
                          device=dev)
    hsmall = torch.empty((S, F, B, 3), dtype=torch.float32, device=dev) \
        if sub else None
    if fmeta is None:
        fmeta = feature_table(meta)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().lgbm_fused_round(
            binned.data_ptr(), g3.data_ptr(), route["oleaf"].data_ptr(),
            route["feats"].data_ptr(), route["rmeta"].data_ptr(),
            label.data_ptr(), new_leaf.data_ptr(), partial.data_ptr(),
            fmeta.data_ptr(), mask.data_ptr(), csums.data_ptr(), ptr(sml),
            ptr(parent), residue.data_ptr(), ptr(hsmall), N, F, S, p["nb"],
            B, p["ls_max"], p["n_chunks"], p["chunk_rows"],
            hist_cuda.PREC_ID[precision], int(sub),
            params.lambda_l1, params.lambda_l2, params.min_data_in_leaf,
            params.min_sum_hessian_in_leaf, params.min_gain_to_split,
            stream)
    _raise_on(err, "fused_round")
    with _count_lock:
        launch_counts["fused_round"] += 1
        key = (nslots, precision, "sub" if sub else "pool")
        bucket_launch_counts[key] = bucket_launch_counts.get(key, 0) + 1
    return residue, hsmall, new_leaf, label
