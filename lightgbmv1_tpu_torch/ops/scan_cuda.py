"""The split-scan kernel on the card, and its plain version.

The JAX package computes the staged split scan in XLA
(lightgbmv1_tpu/ops/split.py:459-661: ``scan_left_sums``,
``scan_direction_gains``, ``scan_pick_feature``); the Pallas kernel K2
runs the same stages on its VMEM accumulator (``child_scan_residue``,
wave_fused.py:215).  ``split_scan`` is that per-feature half of the scan
as a CUDA kernel written by hand (``csrc/split_scan.cu``): (C, F, B, 3)
f32 child histograms -> the (C, F, 6) residue K2 writes [best gain, gain
at the pick, pick = direction * B + threshold, left g/h/c there].  Its
device code is K2's and K6's scan stage (``scan_child`` in
``csrc/wave_round.cuh``), so every ``find_best_split`` on the card — the
staged rounds, the root of every path, the sequential and level-wise
growers — sums its prefixes in K2's order: each prefix accumulated in
double and rounded to f32, which is what PyTorch's CPU cumulative sum
does.  The staged and fused paths then pick from the same bits.

The constrained legs are compile-time options of the device code
(``OPT_*``, the reference ``GetSplitGains<USE_MC, USE_MAX_OUTPUT,
USE_SMOOTHING>`` plus the contri multiply): monotone constraints (the
children's bounds ``constraint`` (C, 2), the monotone type of each
feature and, with ``monotone_penalty``, the children's penalty factors
``pfac`` (C,), ``split.monotone_penalty_factors``), path smoothing (the
parents' outputs ``parent_output`` (C,)), ``max_delta_step`` and
``feature_contri`` (``meta.contri``).  The kernel is instantiated for
each of the 16 option sets and launched at the one the meta and params
select (``scan_options``).

``split_scan_ref`` is the plain version, ``split.scan_residue``: a CPU
tensor takes it; a CUDA tensor launches the kernel or raises.  Each
launch adds one to ``launch_counts["split_scan"]`` and to
``opt_launch_counts[opts]``; each plain call one to
``plain_counts["split_scan"]``.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _build
from .fused_cuda import _need, _raise_on, feature_table
from .split import FeatureMeta, SplitParams, scan_residue

RES_COLS = 6
# the option bits of csrc/wave_round.cuh (kOpt*)
OPT_MC, OPT_SMOOTH, OPT_MAXOUT, OPT_CONTRI = 1, 2, 4, 8

launch_counts = {"split_scan": 0}
# the launches by option bits
opt_launch_counts: dict = {}
plain_counts = {"split_scan": 0}
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        launch_counts["split_scan"] = 0
        plain_counts["split_scan"] = 0
        opt_launch_counts.clear()


def scan_options(meta: FeatureMeta, params: SplitParams) -> int:
    """The option bits a scan under ``meta`` and ``params`` runs."""
    return ((OPT_MC if meta.monotone_type is not None else 0)
            | (OPT_SMOOTH if params.path_smooth > 0 else 0)
            | (OPT_MAXOUT if params.max_delta_step > 0 else 0)
            | (OPT_CONTRI if meta.contri is not None else 0))


def split_scan_ref(hist, mask, csums, *, meta: FeatureMeta,
                   params: SplitParams, hist_scale=None, constraint=None,
                   pfac=None, parent_output=None):
    """Plain version of ``split_scan``: ``split.scan_residue``."""
    with _count_lock:
        plain_counts["split_scan"] += 1
    return scan_residue(hist, mask, csums, meta=meta, params=params,
                        hist_scale=hist_scale, constraint=constraint,
                        pfac=pfac, parent_output=parent_output)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("split_scan")
    lib.lgbm_split_scan.argtypes = [_P] * 11 + [_I] * 3 + [_F] * 8 + [_I, _P]
    lib.lgbm_split_scan.restype = _I
    return lib


def leg_args(meta: FeatureMeta, params: SplitParams, C, dev, constraint,
             pfac, parent_output):
    """The option bits and the legs' pointers (0 where off) of a scan of
    C children on ``dev``, each leg's tensor checked: the split-scan
    kernel's and K2's arguments (``mono``: the features' monotone types
    as int32, its tensor kept under ``"_keep"`` until the launch)."""
    opts = scan_options(meta, params)
    f32 = torch.float32
    ptrs = {"constraint": 0, "pfac": 0, "parent_output": 0, "mono": 0,
            "contri": 0}
    if opts & OPT_MC:
        _need(constraint, "constraint", f32, (C, 2), dev)
        ptrs["constraint"] = constraint.data_ptr()
        F = meta.num_bins.shape[0]
        mono = meta.monotone_type.to(torch.int32).contiguous()
        _need(mono, "meta.monotone_type", torch.int32, (F,), dev)
        ptrs["mono"], ptrs["_keep"] = mono.data_ptr(), mono
        if params.monotone_penalty > 0:
            _need(pfac, "pfac", f32, (C,), dev)
            ptrs["pfac"] = pfac.data_ptr()
    if opts & OPT_SMOOTH:
        _need(parent_output, "parent_output", f32, (C,), dev)
        ptrs["parent_output"] = parent_output.data_ptr()
    if opts & OPT_CONTRI:
        F = meta.num_bins.shape[0]
        _need(meta.contri, "meta.contri", f32, (F,), dev)
        ptrs["contri"] = meta.contri.data_ptr()
    return opts, ptrs


def scan_floats(params: SplitParams) -> list:
    """ScanParams' floats in the kernels' argument order."""
    return [params.lambda_l1, params.lambda_l2, params.min_data_in_leaf,
            params.min_sum_hessian_in_leaf, params.min_gain_to_split,
            params.max_delta_step, params.path_smooth,
            params.monotone_penalty]


def split_scan(hist, mask, csums, *, meta: FeatureMeta, params: SplitParams,
               hist_scale=None, constraint=None, pfac=None,
               parent_output=None, fmeta=None):
    """The split-scan kernel: ``hist`` (C, F, B, 3) f32, ``mask`` (C, F)
    bool, ``csums`` (C, 3) f32 -> the (C, F, RES_COLS) residue.
    ``hist_scale`` (C, 3): ``hist`` holds integer sums, dequantized after
    the cumulative sum.  The legs (``split.scan_inputs``) as the options
    of ``meta`` and ``params`` need them.  ``fmeta`` is
    ``fused_cuda.feature_table(meta)``, made once by a caller that scans
    many times."""
    if hist.device.type == "cpu":
        return split_scan_ref(hist, mask, csums, meta=meta, params=params,
                              hist_scale=hist_scale, constraint=constraint,
                              pfac=pfac, parent_output=parent_output)
    if hist.device.type != "cuda":
        raise ValueError(f"hist on {hist.device}: expected cpu or cuda")
    C, F, B, _ = hist.shape
    dev = hist.device
    if B > 256 or C < 1 or F < 1:
        raise ValueError(f"hist {tuple(hist.shape)}: expected C, F >= 1 and "
                         "at most 256 bins")
    _need(hist, "hist", torch.float32, (C, F, B, 3), dev)
    _need(mask, "mask", torch.bool, (C, F), dev)
    _need(csums, "csums", torch.float32, (C, 3), dev)
    if hist_scale is not None:
        _need(hist_scale, "hist_scale", torch.float32, (C, 3), dev)
    if fmeta is None:
        fmeta = feature_table(meta)
    _need(fmeta, "fmeta", torch.int32, (5, F), dev)
    opts, ptrs = leg_args(meta, params, C, dev, constraint, pfac,
                          parent_output)
    residue = torch.empty((C, F, RES_COLS), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().lgbm_split_scan(
            hist.data_ptr(),
            0 if hist_scale is None else hist_scale.data_ptr(),
            csums.data_ptr(), mask.data_ptr(), fmeta.data_ptr(),
            ptrs["constraint"], ptrs["pfac"], ptrs["parent_output"],
            ptrs["mono"], ptrs["contri"], residue.data_ptr(), C, F, B,
            *scan_floats(params), opts, stream)
    _raise_on(err, "split_scan")
    with _count_lock:
        launch_counts["split_scan"] += 1
        opt_launch_counts[opts] = opt_launch_counts.get(opts, 0) + 1
    return residue
