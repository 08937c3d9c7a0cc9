"""The split-scan kernel and the pick kernel on the card, and their plain
versions.

The JAX package computes the staged split scan in XLA
(lightgbmv1_tpu/ops/split.py:437 ``find_best_split``, vmapped:
``scan_left_sums``, ``scan_direction_gains``, ``scan_pick_feature`` and
the cross-feature pick); the Pallas kernel K2 runs the per-feature stages
on its VMEM accumulator (``child_scan_residue``, wave_fused.py:215) and
leaves the pick to ``_pick_pack`` (:610).  Here both are CUDA kernels
written by hand (``csrc/split_scan.cu``):

* ``split_scan_pick``: (C, F, B, 3) f32 child histograms -> the (C, 10)
  packed rows ``split.pick_pack`` writes [gain, feature, threshold,
  default_left, left g/h/c, right g/h/c], in one launch: one block a
  child, each warp scanning a feature with ``scan_child`` (K2's and K6's
  scan stage, ``csrc/wave_round.cuh``) into shared memory, then one
  thread picking across the features with ``pick_child`` (K6's pick).  So
  every ``find_best_split`` on the card — the staged rounds, the root of
  every path, the sequential and level-wise growers — sums its prefixes
  in K2's order (each prefix accumulated in double and rounded to f32,
  which is what PyTorch's CPU cumulative sum does) and picks as
  ``pick_pack`` does, bit for bit.  Its plain version ``split_pick_ref``
  is ``pick_pack`` on ``split.scan_residue``.
* ``split_scan``: the same kernel writing the (C, F, 6) residue K2 writes
  [best gain, gain at the pick, pick = direction * B + threshold, left
  g/h/c] instead of (or beside) the rows; plain version ``split_scan_ref``
  (``split.scan_residue``).  The main path does not call it: it holds the
  kernel's scan half to the plain scan.
* ``split_pick``: the fused round's pick after K2, (2S, F, 6) residue ->
  (2S, 10) rows (``pick_child`` a thread); plain version ``pick_ref``
  (``pick_pack`` with ``split.gain_shift``).

The scan's other legs:

* extra_trees (``OPT_RAND``, ``rand``: a ``split.RandLeg`` of the tree
  key, the children's uids and extra_seed): the kernel draws each
  (child, feature)'s threshold itself with the JAX package's threefry
  stream (``rand_bin``, ``csrc/wave_round.cuh``), the bits of
  ``split.extra_rand_bins``; ``rand_out`` (C, F) int32 receives them
  where a caller asks.  Only the split-scan kernel has this leg (the
  fused family refuses extra_trees).
* the wide leg (``csrc/split_scan_wide.cu``, a library of its own): a
  scan past 256 bins (int16 bins, ``max_bin > 255``) walks each feature
  in chunks of 256 bins with the prefix carried (``scan_child_wide``),
  the same values as the 256-bin scan; ``wide=True`` forces it at any B.
  Its launches count under ``launch_counts["split_scan_wide"]`` too.

* the categorical leg (``split_scan_cat``, ``csrc/split_scan_cat.cu``,
  a library of its own): a second launch after the numerical scan where
  the meta has categorical features (``meta.cat32``), the JAX package's
  ``_best_categorical`` (split.py:281: one-vs-rest, or the bins sorted by
  g / (h + cat_smooth) and scanned from both ends with
  ``min_data_per_group`` and ``max_cat_threshold``, the extra_trees
  draw) merged into the packed rows where strictly better; it writes the
  (C, 1 + W) [is_cat, bitset] rows.  Its plain version ``split_cat_ref``
  is ``split.best_categorical`` + ``split.merge_categorical``; its
  launches count under ``launch_counts["split_scan_cat"]``.
* the CEGB leg (``cegb`` (C, F) f32 penalties, a nullable pointer of the
  scan, not an option bit): subtracted from the finite gains after the
  contri multiply, as the plain ``scan_direction_gains`` does; the
  categorical leg takes them too.  Scans with it count under
  ``cegb_launch_counts["split_scan"]`` as well.

The constrained legs are compile-time options of the device code
(``OPT_*``, the reference ``GetSplitGains<USE_MC, USE_MAX_OUTPUT,
USE_SMOOTHING>`` plus the contri multiply): monotone constraints (the
children's bounds ``constraint`` (C, 2) (None: ``NO_CONSTRAINT``), the
monotone type of each feature and, with ``monotone_penalty``, the
children's penalty factors ``pfac`` (C,),
``split.monotone_penalty_factors``), path smoothing (the parents' outputs
``parent_output`` (C,), None: 0), ``max_delta_step`` and
``feature_contri`` (``meta.contri``).  The kernels are instantiated for
each of the 16 option sets and launched at the one the meta and params
select (``scan_options``); a set with ``OPT_RAND`` runs one instance with
every leg compiled in, each switched by the set.  The feature table and the int32 monotone
types are the meta's own (``split.with_tables``), so an unconstrained
scan runs no PyTorch op before its launch (``scan_args``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  Each scan launch adds one to ``launch_counts["split_scan"]``
and to ``opt_launch_counts[opts]``, each pick launch one to
``launch_counts["split_pick"]``; each plain call one to its
``plain_counts`` entry.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _build
from .fused_cuda import _need, _raise_on
from .split import (FeatureMeta, RandLeg, SplitParams, best_categorical,
                    bitset_words, extra_rand_bins, gain_shift,
                    merge_categorical, pick_pack, scan_residue)

RES_COLS = 6
PACK_COLS = 10
# the option bits of csrc/wave_round.cuh (kOpt*)
OPT_MC, OPT_SMOOTH, OPT_MAXOUT, OPT_CONTRI, OPT_RAND = 1, 2, 4, 8, 16
# the widest bin axis of the 256-bin scan (kMaxBins); past it the wide leg
MAX_BINS = 256

launch_counts = {"split_scan": 0, "split_scan_wide": 0, "split_pick": 0,
                 "split_scan_cat": 0}
# the scan launches by option bits
opt_launch_counts: dict = {}
plain_counts = {"split_scan": 0, "split_pick": 0, "split_scan_cat": 0}
# the scan launches with the CEGB leg (a non-null penalty pointer)
cegb_launch_counts = {"split_scan": 0}
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for counts in (launch_counts, plain_counts, cegb_launch_counts):
            for k in counts:
                counts[k] = 0
        opt_launch_counts.clear()


def scan_options(meta: FeatureMeta, params: SplitParams,
                 rand: RandLeg = None) -> int:
    """The option bits a scan under ``meta`` and ``params`` (and, with
    ``rand``, extra_trees) runs."""
    return ((OPT_MC if meta.monotone_type is not None else 0)
            | (OPT_SMOOTH if params.path_smooth > 0 else 0)
            | (OPT_MAXOUT if params.max_delta_step > 0 else 0)
            | (OPT_CONTRI if meta.contri is not None else 0)
            | (OPT_RAND if rand is not None else 0))


def _plain(name: str) -> None:
    with _count_lock:
        plain_counts[name] += 1


def _rand_out(rand, rand_out, meta):
    """The plain versions' ``rand_out``: ``extra_rand_bins``."""
    if rand_out is not None and rand is not None:
        rand_out.copy_(extra_rand_bins(rand, meta.num_bins))


def split_scan_ref(hist, mask, csums, *, meta: FeatureMeta,
                   params: SplitParams, hist_scale=None, constraint=None,
                   pfac=None, parent_output=None, rand=None, rand_out=None,
                   cegb=None):
    """Plain version of ``split_scan``: ``split.scan_residue``."""
    _plain("split_scan")
    _rand_out(rand, rand_out, meta)
    return scan_residue(hist, mask, csums, meta=meta, params=params,
                        hist_scale=hist_scale, constraint=constraint,
                        pfac=pfac, parent_output=parent_output, rand=rand,
                        cegb=cegb)


def pick_ref(residue, csums, *, meta: FeatureMeta, params: SplitParams,
             parent_output=None, num_bins: int):
    """Plain version of ``split_pick``: ``pick_pack`` with the children's
    ``gain_shift``."""
    _plain("split_pick")
    return pick_pack(residue, gain_shift(csums, params, parent_output), csums,
                     meta, num_bins)


def split_pick_ref(hist, mask, csums, *, meta: FeatureMeta,
                   params: SplitParams, hist_scale=None, constraint=None,
                   pfac=None, parent_output=None, rand=None, rand_out=None,
                   cegb=None):
    """Plain version of ``split_scan_pick``: ``pick_pack`` on
    ``scan_residue``, the staged scan's composition."""
    _plain("split_scan")
    _rand_out(rand, rand_out, meta)
    residue = scan_residue(hist, mask, csums, meta=meta, params=params,
                           hist_scale=hist_scale, constraint=constraint,
                           pfac=pfac, parent_output=parent_output, rand=rand,
                           cegb=cegb)
    return pick_pack(residue, gain_shift(csums, params, parent_output), csums,
                     meta, hist.shape[2])


_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_uint


@functools.cache
def _lib(wide: bool = False) -> ctypes.CDLL:
    """The 256-bin library, or (``wide``) the wide leg's."""
    lib = _build.load("split_scan_wide" if wide else "split_scan")
    lib.lgbm_split_scan.argtypes = ([_P] * 12 + [_I] * 4 + [_F] * 8
                                    + [_I, _P, _P, _U, _U, _I, _P, _P])
    lib.lgbm_split_scan.restype = _I
    lib.lgbm_split_scan_resident.argtypes = [_I, _I]
    lib.lgbm_split_scan_resident.restype = _I
    lib.lgbm_split_pick.argtypes = [_P] * 5 + [_I] * 3 + [_F] * 8 + [_I, _P]
    lib.lgbm_split_pick.restype = _I
    return lib


def leg_args(meta: FeatureMeta, params: SplitParams, C, dev, constraint,
             pfac, parent_output, rand=None):
    """The option bits and the legs' pointers (0 where off) of a scan of
    C children on ``dev``, each given leg's tensor checked: the
    split-scan kernel's and K2's arguments (``mono``: the meta's int32
    monotone types).  A None ``constraint`` or ``parent_output``
    (``split.scan_inputs``' default) passes a null pointer, which the
    kernels read as ``NO_CONSTRAINT`` and 0.  ``rand``: extra_trees (the
    split-scan kernel's leg alone; ``rand_args`` gives its arguments)."""
    opts = scan_options(meta, params, rand)
    f32 = torch.float32
    ptrs = {"constraint": 0, "pfac": 0, "parent_output": 0, "mono": 0,
            "contri": 0}
    F = meta.num_bins.shape[0]
    if opts & OPT_MC:
        if constraint is not None:
            _need(constraint, "constraint", f32, (C, 2), dev)
            ptrs["constraint"] = constraint.data_ptr()
        _need(meta.mono32, "meta.mono32", torch.int32, (F,), dev)
        ptrs["mono"] = meta.mono32.data_ptr()
        if params.monotone_penalty > 0:
            _need(pfac, "pfac", f32, (C,), dev)
            ptrs["pfac"] = pfac.data_ptr()
    if opts & OPT_SMOOTH and parent_output is not None:
        _need(parent_output, "parent_output", f32, (C,), dev)
        ptrs["parent_output"] = parent_output.data_ptr()
    if opts & OPT_CONTRI:
        _need(meta.contri, "meta.contri", f32, (F,), dev)
        ptrs["contri"] = meta.contri.data_ptr()
    return opts, ptrs


def scan_floats(params: SplitParams) -> list:
    """ScanParams' floats in the kernels' argument order."""
    return [params.lambda_l1, params.lambda_l2, params.min_data_in_leaf,
            params.min_sum_hessian_in_leaf, params.min_gain_to_split,
            params.max_delta_step, params.path_smooth,
            params.monotone_penalty]


def _need_rows(t, name, dtype, shape, device):
    """``_need`` for a (C, F) tensor whose rows may be one row broadcast
    (row stride 0, ``expand``'s view)."""
    if t is not None and t.stride() == (0, 1) and t.dtype == dtype \
            and tuple(t.shape) == tuple(shape) and t.device == device:
        return
    _need(t, name, dtype, shape, device)


def scan_args(hist, mask, csums, *, meta: FeatureMeta, params: SplitParams,
              hist_scale=None, constraint=None, pfac=None,
              parent_output=None, rand=None, cegb=None, wide=False):
    """The split-scan kernel's inputs, checked: ``(opts, head, tail)``,
    ``head`` its pointers before the outputs, ``tail`` its sizes, floats
    and option bits after them (extra_trees' arguments follow,
    ``rand_args``).  It reads the meta's tables (``split.with_tables``)
    and takes a mask of one row broadcast to the children as it is (row
    stride 0), so it runs no PyTorch op.  ``wide``: the wide leg's launch
    (any B)."""
    C, F, B, _ = hist.shape
    dev = hist.device
    if (B > MAX_BINS and not wide) or C < 1 or F < 1:
        raise ValueError(f"hist {tuple(hist.shape)}: expected C >= 1, "
                         f"F >= 1 and at most {MAX_BINS} bins (past them "
                         "the wide leg)")
    _need(hist, "hist", torch.float32, (C, F, B, 3), dev)
    _need_rows(mask, "mask", torch.bool, (C, F), dev)
    _need(csums, "csums", torch.float32, (C, 3), dev)
    if hist_scale is not None:
        _need(hist_scale, "hist_scale", torch.float32, (C, 3), dev)
    _need(meta.table, "meta.table", torch.int32, (5, F), dev)
    opts, ptrs = leg_args(meta, params, C, dev, constraint, pfac,
                          parent_output, rand)
    head = (hist.data_ptr(),
            0 if hist_scale is None else hist_scale.data_ptr(),
            csums.data_ptr(), mask.data_ptr(), meta.table.data_ptr(),
            ptrs["constraint"], ptrs["pfac"], ptrs["parent_output"],
            ptrs["mono"], ptrs["contri"])
    if cegb is not None:
        _need(cegb, "cegb", torch.float32, (C, F), dev)
    tail = (C, F, B, mask.stride(0) if C > 1 else F, *scan_floats(params),
            opts)
    return opts, head, tail


def rand_args(rand, C, dev, rand_out=None) -> tuple:
    """extra_trees' arguments of a split-scan launch of C children, after
    ``scan_args``' tail: the uids' pointer, ``rand_out``'s (C, F) int32
    (0: none), the tree key's two words and extra_seed; zeros without
    ``rand``."""
    if rand is None:
        return (0, 0, 0, 0, 0)
    _need(rand.uids, "rand.uids", torch.int32, (C,), dev)
    return (rand.uids.data_ptr(),
            0 if rand_out is None else rand_out.data_ptr(),
            int(rand.key[0]), int(rand.key[1]), int(rand.extra_seed))


@functools.cache
def resident_features(device_index: int, B: int, opts: int,
                      wide: bool = False) -> int:
    """The most features whose residue a scan block at ``B`` bins keeps in
    shared memory on the card ``device_index`` (past it the residue goes
    through global memory)."""
    with torch.cuda.device(device_index):
        n = _lib(wide).lgbm_split_scan_resident(B, opts)
    if n < 0:
        raise RuntimeError(f"split_scan: no shared-memory size at B = {B}")
    return n


def _scan_launch(hist, kw, residue, packed, rand_out=None, wide=None):
    """Launch the split-scan kernel on ``hist`` into ``residue`` and / or
    ``packed`` (and ``rand_out``); a child's residue too large for shared
    memory goes through a (C, F, RES_COLS) buffer made here.  ``wide``
    None: the wide leg past ``MAX_BINS`` bins."""
    if hist.device.type != "cuda":
        raise ValueError(f"hist on {hist.device}: expected cpu or cuda")
    C, F, B, _ = hist.shape
    wide = B > MAX_BINS if wide is None else bool(wide)
    opts, head, tail = scan_args(hist, wide=wide, **kw)
    dev = hist.device
    if rand_out is not None:
        _need(rand_out, "rand_out", torch.int32, (C, F), dev)
    if residue is None and F > resident_features(dev.index, B, opts, wide):
        residue = torch.empty((C, F, RES_COLS), dtype=torch.float32,
                              device=dev)
    extra = rand_args(kw["rand"], C, dev, rand_out)
    cegb = kw["cegb"]
    with torch.cuda.device(dev), _build.kernel_scope("split_scan"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib(wide).lgbm_split_scan(
            *head, 0 if residue is None else residue.data_ptr(),
            0 if packed is None else packed.data_ptr(), *tail, *extra,
            0 if cegb is None else cegb.data_ptr(), stream)
    _raise_on(err, "split_scan_wide" if wide else "split_scan")
    with _count_lock:
        launch_counts["split_scan"] += 1
        if cegb is not None:
            cegb_launch_counts["split_scan"] += 1
        if wide:
            launch_counts["split_scan_wide"] += 1
        opt_launch_counts[opts] = opt_launch_counts.get(opts, 0) + 1


def split_scan_pick(hist, mask, csums, *, meta: FeatureMeta,
                    params: SplitParams, hist_scale=None, constraint=None,
                    pfac=None, parent_output=None, rand=None, rand_out=None,
                    cegb=None, wide=None):
    """The split-scan kernel: ``hist`` (C, F, B, 3) f32, ``mask`` (C, F)
    bool, ``csums`` (C, 3) f32 -> the children's (C, PACK_COLS) packed
    rows, one launch.  ``hist_scale`` (C, 3): ``hist`` holds integer
    sums, dequantized after the cumulative sum.  The legs as the options
    of ``meta`` and ``params`` need them (``constraint`` None:
    ``NO_CONSTRAINT``; ``parent_output`` None: 0); ``rand`` (a
    ``split.RandLeg``): extra_trees, its thresholds into ``rand_out``
    (C, F) int32 where given; ``cegb`` (C, F) f32: the CEGB leg, the
    penalties subtracted from the finite gains after the contri
    multiply.  Past 256 bins (or ``wide=True``) the wide leg."""
    kw = dict(mask=mask, csums=csums, meta=meta, params=params,
              hist_scale=hist_scale, constraint=constraint, pfac=pfac,
              parent_output=parent_output, rand=rand, cegb=cegb)
    if hist.device.type == "cpu":
        return split_pick_ref(hist, rand_out=rand_out, **kw)
    packed = torch.empty((hist.shape[0], PACK_COLS), dtype=torch.float32,
                         device=hist.device)
    _scan_launch(hist, kw, None, packed, rand_out, wide)
    return packed


def split_scan(hist, mask, csums, *, meta: FeatureMeta, params: SplitParams,
               hist_scale=None, constraint=None, pfac=None,
               parent_output=None, rand=None, rand_out=None, cegb=None,
               wide=None):
    """The split-scan kernel's residue: the inputs of ``split_scan_pick``
    -> the (C, F, RES_COLS) residue K2 writes, one launch."""
    kw = dict(mask=mask, csums=csums, meta=meta, params=params,
              hist_scale=hist_scale, constraint=constraint, pfac=pfac,
              parent_output=parent_output, rand=rand, cegb=cegb)
    if hist.device.type == "cpu":
        return split_scan_ref(hist, rand_out=rand_out, **kw)
    C, F = hist.shape[:2]
    residue = torch.empty((C, F, RES_COLS), dtype=torch.float32,
                          device=hist.device)
    _scan_launch(hist, kw, residue, None, rand_out, wide)
    return residue


def split_pick(residue, csums, *, meta: FeatureMeta, params: SplitParams,
               parent_output=None, num_bins: int):
    """The pick kernel: the children's (C, F, RES_COLS) residue (K2's),
    sums (C, 3) and, under path smoothing, parent outputs (C,) (None: 0)
    -> their (C, PACK_COLS) packed rows, one launch."""
    if residue.device.type == "cpu":
        return pick_ref(residue, csums, meta=meta, params=params,
                        parent_output=parent_output, num_bins=num_bins)
    if residue.device.type != "cuda":
        raise ValueError(f"residue on {residue.device}: expected cpu or "
                         "cuda")
    C, F, _ = residue.shape
    dev = residue.device
    _need(residue, "residue", torch.float32, (C, F, RES_COLS), dev)
    _need(csums, "csums", torch.float32, (C, 3), dev)
    _need(meta.table, "meta.table", torch.int32, (5, F), dev)
    pout = 0
    if parent_output is not None:
        _need(parent_output, "parent_output", torch.float32, (C,), dev)
        pout = parent_output.data_ptr()
    opts = scan_options(meta, params)
    packed = torch.empty((C, PACK_COLS), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), _build.kernel_scope("split_pick"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().lgbm_split_pick(
            residue.data_ptr(), csums.data_ptr(), pout, meta.table.data_ptr(),
            packed.data_ptr(), C, F, int(num_bins), *scan_floats(params),
            opts, stream)
    _raise_on(err, "split_pick")
    with _count_lock:
        launch_counts["split_pick"] += 1
    return packed


# ---- the categorical leg -------------------------------------------------

def split_cat_ref(hist, mask, csums, packed, *, meta: FeatureMeta,
                  params: SplitParams, hist_scale=None, constraint=None,
                  parent_output=None, rand=None, cegb=None):
    """Plain version of ``split_scan_cat``: ``split.best_categorical`` on
    the (dequantized) histograms, merged into the numerical rows by
    ``split.merge_categorical``."""
    _plain("split_scan_cat")
    h = hist if hist_scale is None else hist * hist_scale[:, None, None, :]
    shift = gain_shift(csums, params, parent_output)
    cgain, cfeat, cleft, cbits = best_categorical(
        h, csums, meta, mask, params, shift, constraint, parent_output, rand,
        cegb)
    return merge_categorical(packed, csums, cgain, cfeat, cleft, cbits)


@functools.cache
def _cat_lib() -> ctypes.CDLL:
    lib = _build.load("split_scan_cat")
    lib.lgbm_split_cat.argtypes = ([_P] * 13 + [_I] * 5 + [_F] * 10
                                   + [_I] * 3 + [_U, _U, _I, _P])
    lib.lgbm_split_cat.restype = _I
    return lib


def split_scan_cat(hist, mask, csums, packed, *, meta: FeatureMeta,
                   params: SplitParams, hist_scale=None, constraint=None,
                   parent_output=None, rand=None, cegb=None):
    """The split-scan kernel's categorical leg (``csrc/split_scan_cat.cu``,
    one launch after the numerical scan): the best categorical split of
    each of C children from ``hist`` (C, F, B, 3) f32 (``hist_scale``
    (C, 3): integer sums, dequantized at the load), merged into the
    numerical scan's (C, PACK_COLS) rows ``packed`` where strictly better.
    The legs as the numerical scan takes them (``constraint`` under
    monotone constraints, ``parent_output`` under path smoothing, ``rand``
    extra_trees, ``cegb`` (C, F) the CEGB penalties).  Returns the merged
    rows and the (C, 1 + W) int32 [is_cat, bitset words]; on the card the
    rows are ``packed`` itself, written in place."""
    kw = dict(meta=meta, params=params, hist_scale=hist_scale,
              constraint=constraint, parent_output=parent_output, rand=rand,
              cegb=cegb)
    if hist.device.type == "cpu":
        return split_cat_ref(hist, mask, csums, packed, **kw)
    if hist.device.type != "cuda":
        raise ValueError(f"hist on {hist.device}: expected cpu or cuda")
    C, F, B, _ = hist.shape
    dev = hist.device
    if B > MAX_BINS:
        raise ValueError(f"hist {tuple(hist.shape)}: the categorical leg "
                         f"takes at most {MAX_BINS} bins")
    _need(hist, "hist", torch.float32, (C, F, B, 3), dev)
    _need_rows(mask, "mask", torch.bool, (C, F), dev)
    _need(csums, "csums", torch.float32, (C, 3), dev)
    _need(packed, "packed", torch.float32, (C, PACK_COLS), dev)
    if hist_scale is not None:
        _need(hist_scale, "hist_scale", torch.float32, (C, 3), dev)
    _need(meta.table, "meta.table", torch.int32, (5, F), dev)
    if meta.cat32 is None:
        raise ValueError("split_scan_cat: the meta has no categorical "
                         "feature table (split.with_tables)")
    n_cat = meta.cat32.shape[0]
    _need(meta.cat32, "meta.cat32", torch.int32, (n_cat,), dev)
    # (the categorical gains take no monotone depth penalty)
    opts, ptrs = leg_args(meta, params._replace(monotone_penalty=0.0), C,
                          dev, constraint, None, parent_output, rand)
    if cegb is not None:
        _need(cegb, "cegb", torch.float32, (C, F), dev)
    if rand is not None:
        _need(rand.uids, "rand.uids", torch.int32, (C,), dev)
    W = bitset_words(B)
    cat_out = torch.empty((C, 1 + W), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev), _build.kernel_scope("split_scan_cat"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _cat_lib().lgbm_split_cat(
            hist.data_ptr(),
            0 if hist_scale is None else hist_scale.data_ptr(),
            csums.data_ptr(), mask.data_ptr(), meta.table.data_ptr(),
            meta.cat32.data_ptr(), ptrs["constraint"], ptrs["parent_output"],
            ptrs["contri"], 0 if cegb is None else cegb.data_ptr(),
            0 if rand is None else rand.uids.data_ptr(), packed.data_ptr(),
            cat_out.data_ptr(), C, F, B, n_cat,
            mask.stride(0) if C > 1 else F,
            params.lambda_l1, params.lambda_l2, params.min_data_in_leaf,
            params.min_sum_hessian_in_leaf, params.min_gain_to_split,
            params.max_delta_step, params.path_smooth,
            float(params.lambda_l2 + params.cat_l2), params.cat_smooth,
            params.min_data_per_group, int(params.max_cat_threshold),
            int(params.max_cat_to_onehot), opts,
            *(rand_args(rand, C, dev)[2:5] if rand is not None
              else (0, 0, 0)), stream)
    _raise_on(err, "split_scan_cat")
    with _count_lock:
        launch_counts["split_scan_cat"] += 1
    return packed, cat_out
