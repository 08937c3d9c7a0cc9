"""Carry state across from the JAX package, as numpy arrays and fields.

* ``host_trees_from_numpy``: the JAX package's ``HostTree`` fields
  (``HostTree.FIELDS`` plus ``num_leaves``, ``is_cat``, ``cat_bitset``,
  ``cat_sets`` and optionally ``shrinkage``) become the port's
  ``HostTree``s field for field, so both packages serve the identical
  ensemble;
* ``bin_mappers_from_numpy``: its ``BinMapper`` fields (a categorical
  mapper's ``bin_2_categorical`` too) become the port's ``BinMapper``s,
  so both packages bin the same rows to the same codes;
* ``tree_arrays_from_numpy``: a grown ``TreeArrays`` (its numpy fields)
  becomes the port's ``TreeArrays`` on a device.

The caller extracts the arrays; this module imports nothing of the JAX
package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..io.binning import BIN_CATEGORICAL, BinMapper
from .tree import HostTree, TreeArrays, validate_host_tree

_MAPPER_FIELDS = ("bin_upper_bound", "num_bin", "missing_type", "bin_type",
                  "is_trivial", "sparse_rate", "min_value", "max_value")

_EXTRA = ("num_leaves", "is_cat", "cat_bitset", "cat_sets")


def host_trees_from_numpy(trees: Sequence[Dict[str, Any]], K: int,
                          num_features: int) -> List[HostTree]:
    """``[{field: np.ndarray, ...}, ...]`` -> validated port ``HostTree``s.
    Raises ``ValueError`` on a missing field, a tree count that is not a
    whole number of ``K``-tree iterations, a split feature outside
    ``num_features`` or a malformed tree."""
    if len(trees) % max(int(K), 1):
        raise ValueError(f"{len(trees)} trees is not a whole number of "
                         f"{K}-tree iterations")
    out = []
    for i, fields in enumerate(trees):
        missing = [k for k in (*HostTree.FIELDS, *_EXTRA) if k not in fields]
        if missing:
            raise ValueError(f"tree {i}: missing fields {missing}")
        t = HostTree(
            int(fields["num_leaves"]),
            shrinkage=float(fields.get("shrinkage", 1.0)),
            cat_bitset=fields["cat_bitset"], cat_sets=fields["cat_sets"],
            is_cat=fields["is_cat"],
            **{k: fields[k] for k in HostTree.FIELDS})
        validate_host_tree(t, i)
        n_nodes = max(t.num_leaves - 1, 0)
        if n_nodes and int(t.split_feature.max()) >= int(num_features):
            raise ValueError(f"tree {i}: split feature "
                             f"{int(t.split_feature.max())} outside "
                             f"{num_features} features")
        out.append(t)
    return out


def bin_mappers_from_numpy(mappers: Sequence[Dict[str, Any]]
                           ) -> List[BinMapper]:
    """``[{bin_upper_bound, num_bin, missing_type, bin_type, is_trivial,
    sparse_rate, min_value, max_value[, bin_2_categorical]}, ...]`` (the
    JAX ``BinMapper.to_arrays``) -> the port's ``BinMapper``s.  Raises
    ``ValueError`` on a missing field (``bin_2_categorical`` of a
    categorical mapper too)."""
    out = []
    for i, d in enumerate(mappers):
        missing = [k for k in _MAPPER_FIELDS if k not in d]
        if int(d.get("bin_type", 0)) == BIN_CATEGORICAL \
                and "bin_2_categorical" not in d:
            missing.append("bin_2_categorical")
        if missing:
            raise ValueError(f"mapper {i}: missing fields {missing}")
        cats = [int(c) for c in d.get("bin_2_categorical", [])]
        out.append(BinMapper(
            bin_upper_bound=np.asarray(d["bin_upper_bound"], np.float64),
            num_bin=int(d["num_bin"]), missing_type=int(d["missing_type"]),
            bin_type=int(d["bin_type"]), is_trivial=bool(d["is_trivial"]),
            sparse_rate=float(d["sparse_rate"]),
            min_value=float(d["min_value"]),
            max_value=float(d["max_value"]),
            bin_2_categorical=cats,
            categorical_2_bin={c: b for b, c in enumerate(cats)}))
    return out


def tree_arrays_from_numpy(fields: Dict[str, Any],
                           device="cpu") -> TreeArrays:
    """A JAX ``TreeArrays``'s numpy fields -> the port's ``TreeArrays``,
    its (L-1, W) uint32 ``cat_bitset`` held as the port's int32 words."""
    fields = dict(fields)
    fields["cat_bitset"] = np.ascontiguousarray(
        np.asarray(fields["cat_bitset"], np.uint32)).view(np.int32)
    dtypes = {f: (torch.int32 if f in ("num_leaves", "split_feature",
                                       "threshold_bin", "missing_type",
                                       "left_child", "right_child",
                                       "leaf_parent", "cat_bitset")
                  else torch.bool if f in ("default_left", "is_cat")
                  else torch.float32)
              for f in TreeArrays._fields}
    return TreeArrays(**{
        f: torch.tensor(np.asarray(fields[f]), dtype=dtypes[f],
                        device=device)
        for f in TreeArrays._fields})
