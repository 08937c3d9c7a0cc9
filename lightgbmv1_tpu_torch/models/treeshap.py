"""Exact TreeSHAP feature contributions; the port's copy of
lightgbmv1_tpu/models/treeshap.py.

The polynomial-time exact SHAP value algorithm for decision trees
(Lundberg et al., "Consistent Individualized Feature Attribution for
Tree Ensembles"), the algorithm of the reference's
``Tree::PredictContrib`` / ``TreeSHAP`` (include/LightGBM/tree.h:138,
src/io/tree.cpp), in float64 on the host, a row at a time, as the JAX
package computes it: ``Booster.predict(pred_contrib=True)`` sums
``tree_shap`` over the trees.

The path state mirrors the published algorithm: a list of
(feature_index, zero_fraction, one_fraction, pweight) entries extended at
each internal node and unwound when a feature repeats on the path.
Per-node "cover" weights come from the training row counts stored in the
model (internal_count / leaf_count), exactly like the reference.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .tree import HostTree


class _Path:
    __slots__ = ("d", "z", "o", "w")

    def __init__(self, d, z, o, w):
        self.d = d
        self.z = z
        self.o = o
        self.w = w


def _extend(path: List[_Path], pz: float, po: float, pi: int) -> List[_Path]:
    # copy-on-extend: the recursion shares parent paths between the hot and
    # cold branches (the C++ implementation copies into a fresh buffer per
    # call, tree_shap's unique_path + unique_depth+1 offset)
    path = [_Path(p.d, p.z, p.o, p.w) for p in path] + [
        _Path(pi, pz, po, 1.0 if len(path) == 0 else 0.0)]
    n = len(path) - 1
    for i in range(n - 1, -1, -1):
        path[i + 1].w += po * path[i].w * (i + 1) / (n + 1)
        path[i].w = pz * path[i].w * (n - i) / (n + 1)
    return path


def _unwind(path: List[_Path], i: int) -> List[_Path]:
    n = len(path) - 1
    po, pz = path[i].o, path[i].z
    out = [_Path(p.d, p.z, p.o, p.w) for p in path]
    nxt = out[n].w
    for j in range(n - 1, -1, -1):
        if po != 0:
            tmp = out[j].w
            out[j].w = nxt * (n + 1) / ((j + 1) * po)
            nxt = tmp - out[j].w * pz * (n - j) / (n + 1)
        else:
            out[j].w = out[j].w * (n + 1) / (pz * (n - j))
    for j in range(i, n):
        out[j].d, out[j].z, out[j].o = out[j + 1].d, out[j + 1].z, out[j + 1].o
    out.pop()
    return out


def _unwound_sum(path: List[_Path], i: int) -> float:
    n = len(path) - 1
    po, pz = path[i].o, path[i].z
    total = 0.0
    if po != 0:
        nxt = path[n].w
        for j in range(n - 1, -1, -1):
            tmp = nxt * (n + 1) / ((j + 1) * po)
            total += tmp
            nxt = path[j].w - tmp * pz * (n - j) / (n + 1)
    else:
        for j in range(n - 1, -1, -1):
            total += path[j].w * (n + 1) / (pz * (n - j))
    return total


def _node_count(tree: HostTree, child: int) -> float:
    if child < 0:
        return float(tree.leaf_count[-child - 1])
    return float(tree.internal_count[child])


def tree_expected_value(tree: HostTree) -> float:
    """Count-weighted mean output (reference: Tree::ExpectedValue)."""
    if tree.num_leaves <= 1:
        return float(tree.leaf_value[0]) if tree.num_leaves == 1 else 0.0
    total = tree.leaf_count.sum()
    if total <= 0:
        return 0.0
    return float((tree.leaf_value * tree.leaf_count).sum() / total)


def _tree_shap_row(tree: HostTree, go_left_row: np.ndarray,
                   phi: np.ndarray) -> None:
    """Accumulate one tree's SHAP values for one row into ``phi`` (F+1,).

    ``go_left_row``: precomputed decision per internal node (vectorized
    HostTree._go_left over all nodes at once).  Iterative DFS with an
    explicit stack — path depth can approach num_leaves-1 for leaf-wise
    trees, beyond Python's recursion limit.
    """
    stack = [(0, [], 1.0, 1.0, -1)]
    while stack:
        node, path, pz, po, pi = stack.pop()
        path = _extend(path, pz, po, pi)
        if node < 0:
            v = float(tree.leaf_value[-node - 1])
            for i in range(1, len(path)):
                w = _unwound_sum(path, i)
                phi[path[i].d] += w * (path[i].o - path[i].z) * v
            continue
        if go_left_row[node]:
            hot, cold = int(tree.left_child[node]), int(tree.right_child[node])
        else:
            hot, cold = int(tree.right_child[node]), int(tree.left_child[node])
        f = int(tree.split_feature[node])
        cnt = float(tree.internal_count[node])
        hot_frac = _node_count(tree, hot) / cnt if cnt > 0 else 0.0
        cold_frac = _node_count(tree, cold) / cnt if cnt > 0 else 0.0
        iz, io = 1.0, 1.0
        k = next((i for i in range(1, len(path)) if path[i].d == f), None)
        if k is not None:
            iz, io = path[k].z, path[k].o
            path = _unwind(path, k)
        stack.append((hot, path, iz * hot_frac, io, f))
        stack.append((cold, path, iz * cold_frac, 0.0, f))


def tree_shap(tree: HostTree, X: np.ndarray) -> np.ndarray:
    """(N, F+1) SHAP values for one tree; last column is the expected value
    (the reference appends it per tree too, PredictContrib)."""
    N, F = X.shape
    out = np.zeros((N, F + 1), dtype=np.float64)
    out[:, F] = tree_expected_value(tree)
    if tree.num_leaves <= 1:
        return out
    n_nodes = tree.num_leaves - 1
    # (N, n_nodes) decision matrix via the vectorized host walk
    go_left = np.empty((N, n_nodes), dtype=bool)
    for nd in range(n_nodes):
        f = int(tree.split_feature[nd])
        go_left[:, nd] = tree._go_left(np.full(N, nd, dtype=np.int64),
                                       X[:, f].astype(np.float64))
    for r in range(N):
        _tree_shap_row(tree, go_left[r], out[r])
    return out
