"""Carry an ensemble across from the JAX package without model text.

The JAX package's ``HostTree`` holds plain numpy fields; given as dicts of
numpy arrays (``HostTree.FIELDS`` plus ``num_leaves``, ``is_cat``,
``cat_bitset``, ``cat_sets`` and optionally ``shrinkage``), they become
the port's ``HostTree``s field for field, so both packages serve the
identical ensemble.  The caller extracts the dicts; this module imports
nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

from .tree import HostTree, validate_host_tree

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
