"""Batched inference engine on the card.

Port of lightgbmv1_tpu/models/predict.py.  The layers are the JAX
package's:

* **Prebinned serving codes** — ``build_serving_binner`` turns every
  threshold the ensemble splits on into per-feature sorted boundaries;
  rows are binned ONCE on the host in float64 (so decisions are exact
  against the host walk's double compares) and every node decision is an
  integer compare.  NaN and zero-as-missing ride two reserved codes;
  categorical splits use raw-value bitsets.  With <= 16 codes a feature
  the codes ship 4-bit packed, two a byte.
* **Stacked node tables** — ``build_serving_arrays`` stacks the trees into
  (T, L1) tables on the device.
* **The walks** — ``predict_method``:
  ``fused`` runs the serving megakernel (ops/predict_cuda.serving_fused,
  CUDA K4) — one launch walks every tree and sums the scores;
  ``pallas`` takes leaf ids from the leaf-walk kernel
  (ops/predict_cuda.serving_leaf, CUDA K5) and sums them in torch;
  ``depthwise`` is the plain-torch depth-stepped walk
  (``serving_leaf_binned`` / ``serving_leaf_raw``), which is also the
  path for what the fused plan refuses (categorical bitsets, the raw
  walk, a tree too big for shared memory: refused with the reason logged
  and kept in ``fused_plan["reason"]``).
* **BatchPredictor** — power-of-two row buckets and chunked streaming.
  PyTorch runs eagerly, so there is no compile cache; kernels launch
  asynchronously and the host encodes the next chunk while the card
  walks the current one.  What the port builds per ensemble SHAPE is
  K4's tile plan; with ``shared_cache=True`` (the tenant platform's
  predictors) it comes from a cache keyed by the shape, never the model
  or the tenant, so same-shape tenants share it (``shared_cache_stats``,
  the counterpart of the JAX package's shared executable cache).
* **Fault seam** — ``h2d`` (utils/faults.py) fires before each chunk
  goes to the device, in ``predict_leaf`` and ``predict_raw``.

Not ported yet (ROADMAP queue 1, item 13, row-sharded predict):
``predict_method=scan`` and row-sharded predict (``num_shards > 1``);
both raise ``NotImplementedError`` naming that item.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import SHARDED_PREDICT, not_ported
from ..device import DeviceLike, resolve_device
from ..io.binning import K_ZERO_THRESHOLD, MISSING_NAN, MISSING_ZERO
from ..ops.predict_cuda import (apply_transform, node_records,
                                plan_predict_tiles, serving_fused,
                                serving_leaf, walk_tables)
from ..utils import faults
from ..utils.log import log_info, log_warning
from .tree import (HostTree, host_tree_depth, leaves_to_scores,
                   pad_tree_axis, validate_host_tree)

# widest raw category representable as a serving bitset
_MAX_CAT_BITSET = 1 << 22

# process-wide log-once keys: a chunked predict hits the same refusal on
# every chunk and a server rebuilds predictors per publish
_logged_once: set = set()


def _log_once(key: str, msg: str, warn: bool = False) -> None:
    if key in _logged_once:
        return
    _logged_once.add(key)
    (log_warning if warn else log_info)(msg)


def pack_serving_codes(codes: np.ndarray) -> np.ndarray:
    """(N, F) serving codes <= 15 -> (N, ceil(F/2)) packed bytes, two
    features a byte (lo nibble = even feature 2p, hi = 2p+1)."""
    codes = np.asarray(codes, np.uint8)
    n, f = codes.shape
    if f % 2:
        codes = np.concatenate([codes, np.zeros((n, 1), np.uint8)], axis=1)
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).astype(np.uint8)


def unpack_serving_codes(packed: torch.Tensor,
                         num_features: int) -> torch.Tensor:
    """``pack_serving_codes``'s inverse, in torch — the staged walks unpack
    ON THE DEVICE so the packed host-to-device copy still pays off when
    the fused kernel is not the walk."""
    un = torch.stack([packed & 15, packed >> 4], dim=2)
    un = un.reshape(packed.shape[0], -1)[:, :num_features]
    return un.to(torch.uint8).contiguous()


class ServingArrays(NamedTuple):
    """Stacked (T, ...) SoA node tables of the whole ensemble, on the
    device.  ``threshold`` carries the real split values (raw-feature
    walk), ``threshold_bin`` the serving-bin index of the same split
    (prebinned walk); ``cat_bitset`` is in RAW category space, its uint32
    words held in int64 (torch's shifts and masks are defined there)."""

    num_leaves: torch.Tensor     # (T,) int32
    split_feature: torch.Tensor  # (T, L1) int32
    threshold: torch.Tensor      # (T, L1) f32
    threshold_bin: torch.Tensor  # (T, L1) int32 — serving-bin index
    zero_bin: torch.Tensor       # (T, L1) int32 — serving bin of 0.0
    default_left: torch.Tensor   # (T, L1) bool
    missing_type: torch.Tensor   # (T, L1) int32
    left_child: torch.Tensor     # (T, L1) int32
    right_child: torch.Tensor    # (T, L1) int32
    leaf_value: torch.Tensor     # (T, L) f32
    is_cat: torch.Tensor         # (T, L1) bool
    cat_bitset: torch.Tensor     # (T, L1, W) int64 — RAW-value membership


@dataclass
class ServingBinner:
    """Per-feature serving-bin boundaries derived from the ensemble's own
    thresholds (the model IS the bin mapper at serving time).

    Codes per feature f:
      numeric   — ``searchsorted(thresholds[f], v, side='left')``, so
                  ``code(v) <= bin(t_j) == j`` iff ``v <= t_j``;
      reserved  — ``zero_code`` for |v| <= kZeroThreshold, ``nan_code``
                  for NaN;
      categorical — ``trunc(v)`` clipped to the feature's bitset range
                  (negatives/NaN/overflow map outside every left set).
    """

    thresholds: List[np.ndarray]      # per feature, sorted float64
    zero_bin: np.ndarray              # (F,) int32 — code of 0.0
    cat_feat: np.ndarray              # (F,) bool
    cat_limit: np.ndarray             # (F,) int64 — clip target
    zero_code: int
    nan_code: int
    dtype: Any                        # np.uint8 | np.uint16 | np.int32
    ok: bool = True
    why_not: str = ""

    @property
    def packed_ok(self) -> bool:
        """4-bit packed codes are exact when every code — the two
        reserved NaN/zero codes included — fits a nibble."""
        return bool(self.ok and self.nan_code <= 15)

    def prebin(self, X: np.ndarray) -> np.ndarray:
        """(N, F) float -> (N, F) serving codes.  Float64 exact."""
        X = np.asarray(X, np.float64)
        N, F = X.shape
        codes = np.zeros((N, F), self.dtype)
        for f in range(min(F, len(self.thresholds))):
            col = X[:, f]
            isnan = np.isnan(col)
            if self.cat_feat[f]:
                lim = int(self.cat_limit[f])
                vi = np.where(isnan, -1.0,
                              np.trunc(np.where(isnan, 0.0, col)))
                code = np.where((vi < 0) | (vi > lim), lim, vi)
                codes[:, f] = code.astype(self.dtype)
            else:
                b = np.searchsorted(self.thresholds[f], col, side="left")
                b = b.astype(np.int64)
                b[np.abs(col) <= K_ZERO_THRESHOLD] = self.zero_code
                b[isnan] = self.nan_code
                codes[:, f] = b.astype(self.dtype)
        return codes


def build_serving_binner(trees: List[HostTree],
                         num_features: int) -> ServingBinner:
    """Collect every split threshold / category set into per-feature
    serving bins.  ``ok=False`` (with a reason) when the prebinned path
    cannot be EXACT — callers take the raw walk."""
    th: List[set] = [set() for _ in range(num_features)]
    cat_feat = np.zeros(num_features, bool)
    num_feat = np.zeros(num_features, bool)
    cat_max = np.zeros(num_features, np.int64)
    ok, why = True, ""
    for t in trees:
        for i in range(t.num_leaves - 1):
            f = int(t.split_feature[i])
            if f >= num_features:
                ok, why = False, f"split feature {f} out of range"
                continue
            if bool(t.is_cat[i]):
                cat_feat[f] = True
                s = t.cat_sets[i]
                if s is None:
                    ok, why = False, "raw categorical sets unavailable"
                    continue
                if len(s):
                    cat_max[f] = max(cat_max[f], int(np.max(s)))
            else:
                num_feat[f] = True
                th[f].add(float(t.threshold[i]))
    if (cat_feat & num_feat).any():
        ok, why = False, "feature used both numeric and categorical"
    if (cat_max >= _MAX_CAT_BITSET).any():
        ok, why = False, "category value too large for a serving bitset"
    thresholds = [np.array(sorted(s), np.float64) for s in th]
    # exactness guard: a threshold STRICTLY inside the +-kZeroThreshold
    # band would make the zero-code collapse lossy
    for a in thresholds:
        if len(a) and (np.abs(a) < K_ZERO_THRESHOLD).any():
            ok, why = False, "threshold within the zero-missing band"
    cat_limit = cat_max + 1
    n_codes = max([len(a) + 1 for a in thresholds] or [1])
    if cat_feat.any():
        n_codes = max(n_codes, int(cat_limit[cat_feat].max()) + 1)
    zero_code, nan_code = n_codes, n_codes + 1
    if nan_code < 256:
        dtype: Any = np.uint8
    elif nan_code < 65536:
        dtype = np.uint16
    else:
        dtype = np.int32
    zero_bin = np.array(
        [np.searchsorted(a, 0.0, side="left") for a in thresholds]
        + [0] * (num_features - len(thresholds)), np.int32)
    return ServingBinner(thresholds=thresholds, zero_bin=zero_bin,
                         cat_feat=cat_feat, cat_limit=cat_limit,
                         zero_code=zero_code, nan_code=nan_code,
                         dtype=dtype, ok=ok, why_not=why)


def build_serving_arrays(trees: List[HostTree], binner: ServingBinner,
                         num_features: int, device: DeviceLike = None
                         ) -> Tuple[ServingArrays, int]:
    """HostTrees -> stacked tables on ``device`` + the ensemble's max depth
    (the walks' step count)."""
    dev = resolve_device(device)
    for i, t in enumerate(trees):
        validate_host_tree(t, i)
    depth = max([host_tree_depth(t) for t in trees] or [0])
    L = max([max(t.num_leaves, 1) for t in trees] or [1])
    L1 = max(L - 1, 1)
    W = 1
    if binner.ok and binner.cat_feat.any():
        W = int(binner.cat_limit[binner.cat_feat].max()) // 32 + 1
    T = len(trees)

    num_leaves = np.zeros(T, np.int32)
    feat = np.zeros((T, L1), np.int32)
    thr = np.zeros((T, L1), np.float32)
    tbin = np.zeros((T, L1), np.int32)
    zbin = np.zeros((T, L1), np.int32)
    dl = np.zeros((T, L1), bool)
    mt = np.zeros((T, L1), np.int32)
    lc = np.full((T, L1), -1, np.int32)
    rc = np.full((T, L1), -2, np.int32)
    lv = np.zeros((T, L), np.float32)
    is_cat = np.zeros((T, L1), bool)
    bitset = np.zeros((T, L1, W), np.uint32)
    for ti, t in enumerate(trees):
        n = t.num_leaves
        nn = max(n - 1, 0)
        num_leaves[ti] = n
        if nn:
            feat[ti, :nn] = t.split_feature
            thr[ti, :nn] = t.threshold
            dl[ti, :nn] = t.default_left
            mt[ti, :nn] = t.missing_type
            lc[ti, :nn] = t.left_child
            rc[ti, :nn] = t.right_child
            is_cat[ti, :nn] = t.is_cat
            for i in range(nn):
                f = int(t.split_feature[i])
                if binner.ok and f < num_features:
                    zbin[ti, i] = binner.zero_bin[f]
                    if bool(t.is_cat[i]):
                        s = t.cat_sets[i]
                        if s is not None and len(s):
                            s = np.asarray(s, np.int64)
                            np.bitwise_or.at(
                                bitset[ti, i], s // 32,
                                np.uint32(1) << (s % 32).astype(np.uint32))
                    else:
                        tbin[ti, i] = int(np.searchsorted(
                            binner.thresholds[f], float(t.threshold[i]),
                            side="left"))
        lv[ti, :n] = t.leaf_value[:n]

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    arrays = ServingArrays(
        num_leaves=on(num_leaves), split_feature=on(feat), threshold=on(thr),
        threshold_bin=on(tbin), zero_bin=on(zbin), default_left=on(dl),
        missing_type=on(mt), left_child=on(lc), right_child=on(rc),
        leaf_value=on(lv), is_cat=on(is_cat),
        cat_bitset=on(bitset.astype(np.int64)))
    return arrays, depth


# ---------------------------------------------------------------------------
# Depth-stepped walks in plain torch (the depthwise method, and the path
# for what the fused plan refuses)
# ---------------------------------------------------------------------------


def _cat_go_left(sm: ServingArrays, ti, nd, code, go_left, has_cat: bool):
    if not has_cat:
        return go_left
    W = sm.cat_bitset.shape[-1]
    bi = code.clamp(0, W * 32 - 1).long()
    word = sm.cat_bitset[ti, nd, bi >> 5]
    in_set = ((word >> (bi & 31)) & 1) == 1
    in_set = in_set & (code >= 0) & (code < W * 32)
    return torch.where(sm.is_cat[ti, nd], in_set, go_left)


def _node0(sm: ServingArrays, N: int) -> torch.Tensor:
    T = sm.left_child.shape[0]
    dev = sm.left_child.device
    return torch.where(sm.num_leaves[None, :] > 1,
                       torch.zeros((N, T), dtype=torch.int64, device=dev),
                       torch.full((N, T), -1, dtype=torch.int64, device=dev))


def serving_leaf_raw(sm: ServingArrays, X: torch.Tensor, n_steps: int,
                     has_cat: bool = False) -> torch.Tensor:
    """Depth-stepped walk on RAW float features (f32 compares).  With
    ``has_cat`` the categorical decision is ``trunc(v)`` membership in the
    node's raw bitset (reference CategoricalDecision, tree.h:302-320)."""
    T = sm.left_child.shape[0]
    ti = torch.arange(T, device=X.device)[None, :]
    node = _node0(sm, X.shape[0])
    for _ in range(max(int(n_steps), 1)):
        nd = node.clamp(min=0)
        f = sm.split_feature[ti, nd].long()
        v = torch.gather(X, 1, f)
        is_nan = torch.isnan(v)
        v0 = torch.where(is_nan, torch.zeros_like(v), v)
        mtype = sm.missing_type[ti, nd]
        is_missing = torch.where(
            mtype == MISSING_NAN, is_nan,
            (mtype == MISSING_ZERO) & (is_nan
                                       | (v0.abs() <= K_ZERO_THRESHOLD)))
        go_left = torch.where(is_missing, sm.default_left[ti, nd],
                              v0 <= sm.threshold[ti, nd])
        if has_cat:
            W = sm.cat_bitset.shape[-1]
            vc = v0.clamp(-1.0, float(W * 32))
            vi = torch.where(is_nan, -1, vc.to(torch.int32))   # C trunc
            go_left = _cat_go_left(sm, ti, nd, vi, go_left, True)
        nxt = torch.where(go_left, sm.left_child[ti, nd],
                          sm.right_child[ti, nd])
        node = torch.where(node >= 0, nxt.long(), node)
    return (-node - 1).to(torch.int32)


def serving_leaf_binned(sm: ServingArrays, codes: torch.Tensor, n_steps: int,
                        zero_code: int, nan_code: int,
                        has_cat: bool = False) -> torch.Tensor:
    """Depth-stepped walk on prebinned serving codes: every decision is an
    integer compare against the node's serving-bin threshold; NaN /
    zero-missing routing rides the two reserved codes (``b0`` restores
    the reference's NaN-as-0.0 compare via the precomputed zero bin)."""
    T = sm.left_child.shape[0]
    ti = torch.arange(T, device=codes.device)[None, :]
    c = codes.long()
    node = _node0(sm, codes.shape[0])
    for _ in range(max(int(n_steps), 1)):
        nd = node.clamp(min=0)
        f = sm.split_feature[ti, nd].long()
        b = torch.gather(c, 1, f)
        is_nan = b == nan_code
        is_zero = b == zero_code
        b0 = torch.where(is_nan | is_zero, sm.zero_bin[ti, nd].long(), b)
        mtype = sm.missing_type[ti, nd]
        is_missing = torch.where(mtype == MISSING_NAN, is_nan,
                                 (mtype == MISSING_ZERO) & (is_nan | is_zero))
        go_left = torch.where(is_missing, sm.default_left[ti, nd],
                              b0 <= sm.threshold_bin[ti, nd])
        go_left = _cat_go_left(sm, ti, nd, b, go_left, has_cat)
        nxt = torch.where(go_left, sm.left_child[ti, nd],
                          sm.right_child[ti, nd])
        node = torch.where(node >= 0, nxt.long(), node)
    return (-node - 1).to(torch.int32)


# ---------------------------------------------------------------------------
# The predictor object: buckets, chunk streaming, method dispatch
# ---------------------------------------------------------------------------


# the cross-instance plan cache: predictors of the same shape (tree count,
# table geometry, code width, depth, K4's plan inputs) share ONE tile
# plan.  The key is the shape, never the model or the tenant; opt-in per
# predictor (``shared_cache=True``), LRU-bounded
_SHARED_CACHE_CAPACITY = 256
_shared_lock = threading.RLock()
_shared_cache: "OrderedDict[tuple, Any]" = OrderedDict()
_shared_stats = {"hits": 0, "misses": 0, "evictions": 0}


def shared_cache_stats() -> Dict[str, int]:
    """Point read of the cross-instance plan cache: ``hits``,
    ``misses``, ``evictions``, ``entries`` and ``capacity``."""
    with _shared_lock:
        out = dict(_shared_stats)
        out["entries"] = len(_shared_cache)
        out["capacity"] = _SHARED_CACHE_CAPACITY
    return out


def reset_shared_cache() -> None:
    """Drop every shared plan and zero the counters (tests and probes;
    live predictors keep the plans they hold)."""
    with _shared_lock:
        _shared_cache.clear()
        for k in _shared_stats:
            _shared_stats[k] = 0


def _shared_plan(key: tuple, build):
    """Fetch-or-build one per-shape plan through the shared cache."""
    with _shared_lock:
        ent = _shared_cache.get(key)
        if ent is not None:
            _shared_cache.move_to_end(key)
            _shared_stats["hits"] += 1
            return ent
    ent = build()
    with _shared_lock:
        _shared_stats["misses"] += 1
        _shared_cache[key] = ent
        _shared_cache.move_to_end(key)
        while len(_shared_cache) > _SHARED_CACHE_CAPACITY:
            _shared_cache.popitem(last=False)
            _shared_stats["evictions"] += 1
    return ent


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


class BatchPredictor:
    """Serving engine for one frozen ensemble slice on one device.

    Owns the stacked node tables and the serving binner; pads each chunk
    to a power-of-two row bucket (``bucket_for``) so batch shapes stay
    few, and counts device calls in ``call_count``.  ``Booster.predict``
    holds one BatchPredictor per (start_iteration, tree count, method)."""

    def __init__(self, trees: List[HostTree], K: int, num_features: int, *,
                 method: str = "depthwise", prebin: str = "auto",
                 code_layout: str = "auto", num_shards: int = 0,
                 bucket_min: int = 256, chunk_rows: int = 1 << 17,
                 device: DeviceLike = None, shared_cache: bool = False):
        if not trees:
            raise ValueError("BatchPredictor needs at least one tree")
        if method == "scan":
            raise not_ported("predict_method=scan (the per-tree scan parity "
                             "pin)", SHARDED_PREDICT)
        if method not in ("depthwise", "pallas", "fused"):
            raise ValueError(f"predict_method={method!r}: expected "
                             "depthwise | pallas | fused")
        if code_layout not in ("auto", "u8", "packed4"):
            raise ValueError(f"predict_code_layout={code_layout!r}: "
                             "expected auto | u8 | packed4")
        if prebin not in ("auto", "on", "off"):
            raise ValueError(f"predict_prebin={prebin!r}")
        if int(num_shards) > 1:
            raise not_ported("row-sharded predict (predict_num_shards > 1)",
                             SHARDED_PREDICT)
        self.device = resolve_device(device)
        self.K = max(int(K), 1)
        self.T = len(trees)
        self.F = int(num_features)
        self.method = method
        self.shared_cache = bool(shared_cache)
        self.bucket_min = max(int(bucket_min), 8)
        self.chunk_rows = max(int(chunk_rows), self.bucket_min)
        self.binner = build_serving_binner(trees, num_features)
        self.arrays, self.depth = build_serving_arrays(
            trees, self.binner, num_features, self.device)
        self.has_cat = bool(self.arrays.is_cat.any())
        if self.has_cat and not self.binner.ok:
            raise ValueError(
                "device serving of this categorical model is not possible: "
                + self.binner.why_not)
        self.prebin = self.binner.ok if prebin == "auto" else (prebin == "on")
        if self.prebin and not self.binner.ok:
            log_warning("predict_prebin=on but the prebinned path cannot "
                        f"be exact ({self.binner.why_not}); using the raw "
                        "walk")
            self.prebin = False
        # 4-bit packed serving codes: "auto" engages exactly when eligible
        # AND the fused kernel consumes nibbles directly; "packed4"
        # engages on any prebinned walk (the staged walks unpack on the
        # device) or refuses with one reason
        self.code_layout = code_layout
        packed_able = bool(self.prebin and self.binner.packed_ok)
        if code_layout == "packed4":
            if packed_able:
                self.packed = True
                _log_once("packed4:on",
                          "predict_code_layout=packed4: serving codes "
                          "packed two per byte")
            else:
                reason = (f"{self.binner.nan_code + 1} serving codes "
                          "exceed the 16 nibble values"
                          if self.prebin and self.binner.ok
                          else "prebinned serving codes not in play")
                _log_once(f"packed4:refuse:{reason}",
                          f"predict_code_layout=packed4: {reason}; "
                          "storing unpacked codes", warn=True)
                self.packed = False
        else:
            self.packed = bool(code_layout == "auto" and method == "fused"
                               and packed_able)
        # float64 leaf table for exact score reconstruction (the host walk
        # accumulates f64 in tree order)
        L = self.arrays.leaf_value.shape[1]
        self._leaf_value64 = np.zeros((self.T, L), np.float64)
        for i, t in enumerate(trees):
            self._leaf_value64[i, : t.num_leaves] = t.leaf_value[: t.num_leaves]
        self.call_count = 0
        # the leaf-walk kernel's tables (predict_method=pallas serves the
        # prebinned numeric walk; categorical and raw walks stay staged)
        self._leaf_tables = None
        if method == "pallas" and self.prebin and not self.has_cat:
            self._leaf_tables = walk_tables(self.arrays)
        # serving-megakernel plan: cuts the tree axis into fixed
        # shared-memory-sized groups; a refusal = the staged walk + one
        # honest reason line.  The kernel's 16-byte node records are
        # packed here, once a predictor (a publish), not per call
        self.fused_plan = None
        self._fused_tables = None
        if method == "fused":
            shape = dict(
                T=self.T, L1=self.arrays.split_feature.shape[1], L=L,
                F=self.F, K=self.K, depth=self.depth, has_cat=self.has_cat,
                prebin=self.prebin, packed=self.packed,
                code_bytes=np.dtype(self.binner.dtype).itemsize)
            if self.shared_cache:
                self.fused_plan = _shared_plan(
                    ("fused",) + tuple(sorted(shape.items())),
                    lambda: plan_predict_tiles(**shape))
            else:
                self.fused_plan = plan_predict_tiles(**shape)
            if self.fused_plan["eligible"]:
                self._fused_tables = node_records(
                    pad_tree_axis(walk_tables(self.arrays),
                                  self.fused_plan["t_pad"]),
                    self.fused_plan["tree_tile"])
            else:
                _log_once("fused:refuse:" + self.fused_plan["reason"],
                          f"predict_method=fused: "
                          f"{self.fused_plan['reason']}; serving the "
                          "staged depth-stepped walk", warn=True)

    def bucket_for(self, n: int) -> int:
        b = _next_pow2(max(n, self.bucket_min))
        return min(b, _next_pow2(self.chunk_rows))

    def _fused_engaged(self) -> bool:
        return self._fused_tables is not None

    # -- host <-> device ------------------------------------------------
    def encode(self, X: np.ndarray) -> np.ndarray:
        """Host-side input encoding: prebinned codes (uint8/uint16, or
        4-bit packed bytes when the nibble layout is engaged) or f32 raw
        features."""
        if self.prebin:
            codes = self.binner.prebin(X)
            if self.packed:
                return pack_serving_codes(codes)
            return codes
        return np.asarray(X, np.float32)

    def _to_device(self, X: np.ndarray, bucket: int) -> torch.Tensor:
        enc = self.encode(X)
        n = enc.shape[0]
        if n != bucket:
            enc = np.concatenate(
                [enc, np.zeros((bucket - n, enc.shape[1]), enc.dtype)])
        return torch.from_numpy(np.ascontiguousarray(enc)).to(self.device)

    # -- the walks ---------------------------------------------------------
    def _walk_leaf(self, xb: torch.Tensor) -> torch.Tensor:
        """(bucket, T) leaf ids through the non-fused walk."""
        zc, nc = self.binner.zero_code, self.binner.nan_code
        if self.packed:
            xb = unpack_serving_codes(xb, self.F)
        if self._leaf_tables is not None:
            return serving_leaf(self._leaf_tables, xb, n_steps=self.depth,
                                zero_code=zc, nan_code=nc)
        if self.prebin:
            return serving_leaf_binned(self.arrays, xb, self.depth, zc, nc,
                                       self.has_cat)
        return serving_leaf_raw(self.arrays, xb, self.depth, self.has_cat)

    def _fused(self, xb: torch.Tensor, mode: str = "scores",
               transform=None) -> torch.Tensor:
        out = serving_fused(
            self._fused_tables, xb, n_steps=self.depth,
            zero_code=self.binner.zero_code, nan_code=self.binner.nan_code,
            K=self.K, mode=mode, packed=self.packed, transform=transform)
        if mode == "leaf":
            out = out[:, : self.T]        # slice the tree-tile pad away
        return out

    def _chunks(self, X: np.ndarray, chunk_rows: Optional[int] = None,
                site: str = "predict_raw"):
        chunk_rows = chunk_rows or self.chunk_rows
        for lo in range(0, X.shape[0], chunk_rows):
            chunk = X[lo: lo + chunk_rows]
            bucket = self.bucket_for(chunk.shape[0])
            # fault seam: a transient host->device failure lands here,
            # before the chunk's copy and walk; the server's retry loop
            # absorbs it
            faults.fire("h2d", site=site)
            self.call_count += 1
            yield self._to_device(chunk, bucket), chunk.shape[0]

    @staticmethod
    def _gather(pending) -> np.ndarray:
        return np.concatenate([out[:m].cpu().numpy() for out, m in pending],
                              axis=0)

    # -- public API ------------------------------------------------------
    def predict_leaf(self, X: np.ndarray) -> np.ndarray:
        """(N, T) int32 leaf index per (row, tree) — node-exact against
        the host walk on the prebinned path (the raw walk compares f32)."""
        pending = []
        for xb, m in self._chunks(np.asarray(X), site="predict_leaf"):
            leaf = (self._fused(xb, mode="leaf") if self._fused_engaged()
                    else self._walk_leaf(xb))
            pending.append((leaf, m))
        return self._gather(pending)

    def predict_raw(self, X: np.ndarray, f64_exact: bool = False,
                    chunk_rows: Optional[int] = None) -> np.ndarray:
        """(N, K) raw scores.

        Default: leaf values summed on the device in f32.  ``f64_exact``:
        the device walk produces leaf ids and the scores are summed on
        the host in float64 IN TREE ORDER — bit-identical to the host
        walk.  Launches are asynchronous, so the host encodes chunk i+1
        while the card walks chunk i; the results are copied back at the
        end."""
        X = np.asarray(X)
        if f64_exact:
            leaf = self.predict_leaf(X)
            out = np.zeros((X.shape[0], self.K), np.float64)
            for t in range(self.T):    # tree order = the host walk's f64
                out[:, t % self.K] += self._leaf_value64[t][leaf[:, t]]
            return out
        pending = []
        for xb, m in self._chunks(X, chunk_rows):
            if self._fused_engaged():
                scores = self._fused(xb)   # walk + sum in one launch
            else:
                scores = leaves_to_scores(self.arrays.leaf_value,
                                          self._walk_leaf(xb), self.K)
            pending.append((scores, m))
        return self._gather(pending)

    def predict_scores(self, X: np.ndarray, transform=None,
                       chunk_rows: Optional[int] = None) -> np.ndarray:
        """(N, K) scores with the optional objective epilogue
        (``transform``: None | 'sigmoid' | 'softmax').  When the fused
        kernel is engaged the transform runs inside its launch; otherwise
        after the staged walk's score sum (same f32 math)."""
        if transform not in (None, "sigmoid", "softmax"):
            raise ValueError(f"transform={transform!r}: expected None | "
                             "sigmoid | softmax")
        X = np.asarray(X)
        if not self._fused_engaged():
            raw = torch.from_numpy(self.predict_raw(X, chunk_rows=chunk_rows))
            return apply_transform(raw.to(self.device),
                                   transform).cpu().numpy()
        pending = [(self._fused(xb, transform=transform), m)
                   for xb, m in self._chunks(X, chunk_rows)]
        return self._gather(pending)
