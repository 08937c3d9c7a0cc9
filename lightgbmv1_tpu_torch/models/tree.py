"""Host trees and the stacked-table helpers of the serving path.

Port of lightgbmv1_tpu/models/tree.py: the numpy ``HostTree`` (the
object model text is parsed into and written from, and the exact f64
oracle every device walk is held to), the structural validators, the two
stacked-table helpers the serving walks use (``leaves_to_scores``,
``pad_tree_axis``), and the training side's ``TreeArrays`` (:33),
``empty_tree`` (:106) and ``leaf_lookup`` (:65) in torch, with
``host_tree_from_arrays`` from a grown tree to its ``HostTree``.

Node encoding follows the reference exactly so the v3 model text
round-trips: internal nodes are numbered in split order;
``left_child``/``right_child`` hold an internal node index (>= 0) or
``~leaf_index`` (< 0).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..io.binning import K_ZERO_THRESHOLD, MISSING_NAN, MISSING_ZERO


class TreeArrays(NamedTuple):
    """One grown tree on the training device, arrays padded to
    ``max_leaves`` (nodes: L - 1).  Thresholds are bin ids here; the real
    thresholds are filled from the bin mappers on the host."""

    num_leaves: torch.Tensor       # () int32 — actual leaves
    split_feature: torch.Tensor    # (L-1,) int32
    threshold_bin: torch.Tensor    # (L-1,) int32
    threshold: torch.Tensor        # (L-1,) float32
    default_left: torch.Tensor     # (L-1,) bool
    missing_type: torch.Tensor     # (L-1,) int32 — of the split feature
    left_child: torch.Tensor       # (L-1,) int32 (>= 0 node, < 0 ~leaf)
    right_child: torch.Tensor      # (L-1,) int32
    split_gain: torch.Tensor       # (L-1,) float32
    internal_value: torch.Tensor   # (L-1,) float32
    internal_weight: torch.Tensor  # (L-1,) float32
    internal_count: torch.Tensor   # (L-1,) float32
    leaf_value: torch.Tensor       # (L,) float32
    leaf_weight: torch.Tensor      # (L,) float32
    leaf_count: torch.Tensor       # (L,) float32
    leaf_parent: torch.Tensor      # (L,) int32


def empty_tree(max_leaves: int, device=None) -> TreeArrays:
    """A one-leaf tree with room for ``max_leaves`` leaves."""
    L = max_leaves
    L1 = max(L - 1, 1)

    def full(n, v, dtype):
        return torch.full((n,), v, dtype=dtype, device=device)

    i32, f32 = torch.int32, torch.float32
    return TreeArrays(
        num_leaves=torch.tensor(1, dtype=i32, device=device),
        split_feature=full(L1, 0, i32), threshold_bin=full(L1, 0, i32),
        threshold=full(L1, 0.0, f32),
        default_left=full(L1, False, torch.bool),
        missing_type=full(L1, 0, i32), left_child=full(L1, -1, i32),
        right_child=full(L1, -2, i32), split_gain=full(L1, 0.0, f32),
        internal_value=full(L1, 0.0, f32),
        internal_weight=full(L1, 0.0, f32),
        internal_count=full(L1, 0.0, f32), leaf_value=full(L, 0.0, f32),
        leaf_weight=full(L, 0.0, f32), leaf_count=full(L, 0.0, f32),
        leaf_parent=full(L, -1, i32))


def leaf_lookup(table: torch.Tensor, leaf_id: torch.Tensor) -> torch.Tensor:
    """``table[leaf_id]``: each row's leaf value.  A plain gather on the
    card; the JAX package's broadcast-compare form is a TPU workaround
    with equal values.  Every id must be in ``[0, len(table))``."""
    return table[leaf_id.long()]


def host_tree_from_arrays(arrays: TreeArrays,
                          shrinkage: float = 1.0) -> "HostTree":
    """A grown tree (on any device) -> its numpy ``HostTree``, cut to its
    node and leaf counts (JAX ``HostTree(arrays)``)."""
    fields = {k: getattr(arrays, k).detach().cpu().numpy()
              for k in HostTree.FIELDS}
    return HostTree(int(arrays.num_leaves), shrinkage=shrinkage, **fields)


def leaves_to_scores(leaf_value: torch.Tensor, leaf: torch.Tensor,
                     K: int) -> torch.Tensor:
    """(N, T) leaf indices + (T, L) stacked leaf values -> (N, K) raw
    scores, class k summing trees ``k, k+K, k+2K, ...`` (iteration-major
    tree order, reference GBDT::PredictRaw)."""
    N, T = leaf.shape
    ti = torch.arange(T, device=leaf.device)[None, :]
    vals = leaf_value[ti, leaf.long()]                     # (N, T)
    return vals.reshape(N, T // K, K).sum(dim=1)


def pad_tree_axis(tables, t_pad: int):
    """Zero-pad every stacked (T, ...) table of a NamedTuple along the TREE
    axis to ``t_pad`` trees — the fused serving kernel's tree tiles need
    the tree axis to be a multiple of the planner's tree tile.  A padded
    tree has ``num_leaves == 0``, so the walks park it on leaf 0 whose
    value is 0.0: scores are unchanged and leaf-mode callers slice the pad
    away."""
    T = int(tables.num_leaves.shape[0])
    if t_pad < T:
        raise ValueError(f"t_pad={t_pad} < T={T}")
    if t_pad == T:
        return tables
    return type(tables)(*(
        torch.cat([a, a.new_zeros((t_pad - T,) + tuple(a.shape[1:]))])
        for a in tables))


def validate_host_tree(t, index: int = -1) -> None:
    """Child-pointer structural validation (cycle / out-of-range /
    reconvergence / unreachable-leaf detection).  A malformed model file
    would otherwise send the walks round a cycle; load fails loudly here
    and the device walks are step-bounded as defense in depth.  Raises
    ``ValueError``."""
    n = int(t.num_leaves)
    where = f"tree {index}" if index >= 0 else "tree"
    if n <= 1:
        return
    n_nodes = n - 1
    lc = np.asarray(t.left_child)
    rc = np.asarray(t.right_child)
    if len(lc) < n_nodes or len(rc) < n_nodes:
        raise ValueError(f"{where}: child arrays shorter than num_leaves-1")
    seen = np.zeros(n_nodes, bool)
    seen_leaf = np.zeros(n, bool)
    seen[0] = True
    stack = [0]
    while stack:
        nd = stack.pop()
        for c in (int(lc[nd]), int(rc[nd])):
            if c >= 0:
                if c >= n_nodes:
                    raise ValueError(
                        f"{where}: child index {c} out of range "
                        f"(num_leaves={n})")
                if seen[c]:
                    raise ValueError(
                        f"{where}: node {c} reached twice — cyclic or "
                        "reconvergent child pointers")
                seen[c] = True
                stack.append(c)
            else:
                leaf = -c - 1
                if leaf >= n:
                    raise ValueError(
                        f"{where}: leaf index {leaf} out of range "
                        f"(num_leaves={n})")
                if seen_leaf[leaf]:
                    raise ValueError(
                        f"{where}: leaf {leaf} reached twice — malformed "
                        "child pointers")
                seen_leaf[leaf] = True
    if not seen.all():
        raise ValueError(f"{where}: unreachable internal nodes "
                         f"{np.flatnonzero(~seen).tolist()}")
    if not seen_leaf.all():
        raise ValueError(f"{where}: unreachable leaves "
                         f"{np.flatnonzero(~seen_leaf).tolist()}")


def host_tree_depth(t) -> int:
    """Max root-to-leaf decision count (edges).  Assumes a validated
    tree; guards the level walk by the node count regardless."""
    n = int(t.num_leaves)
    if n <= 1:
        return 0
    n_nodes = n - 1
    lc = np.asarray(t.left_child)
    rc = np.asarray(t.right_child)
    depth = 0
    frontier = [0]
    while frontier and depth <= n_nodes:
        depth += 1
        frontier = [c for nd in frontier for c in (int(lc[nd]), int(rc[nd]))
                    if c >= 0]
    if frontier:
        raise ValueError("host_tree_depth: path longer than the node "
                         "count — cyclic child pointers")
    return depth


# (name, dtype, per-node (True) or per-leaf (False)) of every array field
_FIELD_SPECS = (
    ("split_feature", np.int32, True),
    ("threshold_bin", np.int32, True),
    ("threshold", np.float64, True),
    ("default_left", bool, True),
    ("missing_type", np.int32, True),
    ("left_child", np.int32, True),
    ("right_child", np.int32, True),
    ("split_gain", np.float64, True),
    ("internal_value", np.float64, True),
    ("internal_weight", np.float64, True),
    ("internal_count", np.int64, True),
    ("leaf_value", np.float64, False),
    ("leaf_weight", np.float64, False),
    ("leaf_count", np.int64, False),
    ("leaf_parent", np.int32, False),
    ("is_cat", bool, True),
)


class HostTree:
    """Numpy copy of one tree; the object serialized to/from model text.

    Built from keyword arrays (``HostTree(num_leaves, **fields)``): each
    field of ``_FIELD_SPECS`` is cut to the tree's node or leaf count and
    cast to its dtype; a missing field is zeros (``leaf_parent`` -1).
    ``cat_bitset`` is the (n_nodes, W) uint32 bin-space bitset of
    categorical nodes and ``cat_sets`` their raw-category sets (None for
    numerical nodes)."""

    FIELDS = [
        "split_feature", "threshold_bin", "threshold", "default_left",
        "missing_type", "left_child", "right_child", "split_gain",
        "internal_value", "internal_weight", "internal_count",
        "leaf_value", "leaf_weight", "leaf_count", "leaf_parent",
    ]

    def __init__(self, num_leaves: int, shrinkage: float = 1.0,
                 cat_bitset: Optional[np.ndarray] = None,
                 cat_sets: Optional[list] = None, **arrays: Any):
        unknown = set(arrays) - {name for name, _, _ in _FIELD_SPECS}
        if unknown:
            raise TypeError(f"HostTree: unknown fields {sorted(unknown)}")
        self.num_leaves = int(num_leaves)
        n_nodes = max(self.num_leaves - 1, 0)
        for name, dtype, per_node in _FIELD_SPECS:
            n = n_nodes if per_node else self.num_leaves
            a = arrays.get(name)
            if a is None:
                fill = -1 if name == "leaf_parent" else 0
                a = np.full(n, fill, dtype)
            setattr(self, name, np.asarray(a)[:n].astype(dtype))
        if cat_bitset is None:
            cat_bitset = np.zeros((n_nodes, 1), np.uint32)
        self.cat_bitset = np.asarray(cat_bitset)[:n_nodes].astype(np.uint32)
        self.cat_sets = (list(cat_sets)[:n_nodes] if cat_sets is not None
                         else [None] * n_nodes)
        self.shrinkage = float(shrinkage)

    def add_bias(self, val: float) -> None:
        """Fold a constant score into the tree (reference Tree::AddBias,
        tree.h:198-211: embeds the boost-from-average score in the saved
        model; forces shrinkage to 1)."""
        if val == 0.0:
            return
        self.leaf_value = self.leaf_value + val
        self.internal_value = self.internal_value + val
        self.shrinkage = 1.0

    def cat_bins_of(self, node: int) -> np.ndarray:
        """Bins in node's left set, decoded from the bin-space bitset."""
        words = self.cat_bitset[node]
        bits = np.unpackbits(words.view(np.uint8), bitorder="little")
        return np.flatnonzero(bits)

    # -- numpy prediction (exact, host) ------------------------------------
    def _go_left(self, nd: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Vectorized Tree::Decision (reference tree.h:331-339): numerical
        threshold compare or categorical raw-value bitset membership."""
        t = self.threshold[nd]
        dl = self.default_left[nd]
        mt = self.missing_type[nd]
        isnan = np.isnan(v)
        v0 = np.where(isnan, 0.0, v)
        miss = np.where(
            mt == MISSING_NAN, isnan,
            np.where(mt == MISSING_ZERO,
                     isnan | (np.abs(v0) <= K_ZERO_THRESHOLD), False),
        )
        go_left = np.where(miss, dl, v0 <= t)
        cat_rows = self.is_cat[nd]
        if cat_rows.any():
            # reference CategoricalDecision (tree.h:302-320): C truncation
            # cast, NOT rounding; negatives and NaN go right
            vi = np.where(isnan, -1, np.trunc(v0)).astype(np.int64)
            for node in np.unique(nd[cat_rows]):
                m = cat_rows & (nd == node)
                s = self.cat_sets[node]
                if s is None:
                    s = self.cat_bins_of(node)
                go_left[m] = (vi[m] >= 0) & np.isin(vi[m], np.asarray(s))
        return go_left

    def _walk(self, X: np.ndarray):
        """Root-to-leaf walk; returns the leaf index per row."""
        N = X.shape[0]
        leaf = np.zeros(N, dtype=np.int32)
        if self.num_leaves <= 1:
            return leaf
        node = np.zeros(N, dtype=np.int64)
        active = np.ones(N, dtype=bool)
        while active.any():
            nd = node[active]
            f = self.split_feature[nd]
            v = X[active, f].astype(np.float64)
            go_left = self._go_left(nd, v)
            nxt = np.where(go_left, self.left_child[nd], self.right_child[nd])
            node[active] = nxt
            idx = np.flatnonzero(active)
            done = nxt < 0
            leaf[idx[done]] = -nxt[done] - 1
            active[idx[done]] = False
        return leaf

    def predict(self, X: np.ndarray) -> np.ndarray:
        if self.num_leaves < 1:
            return np.zeros(X.shape[0], dtype=np.float64)
        return self.leaf_value[self._walk(X)]

    def predict_leaf_index(self, X: np.ndarray) -> np.ndarray:
        return self._walk(X)
