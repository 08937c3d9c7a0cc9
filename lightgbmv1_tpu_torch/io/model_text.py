"""Model serialization — LightGBM v3 text format.

Port of lightgbmv1_tpu/io/model_text.py (reference
``src/boosting/gbdt_model_text.cpp`` ``SaveModelToString`` :306-397,
``LoadModelFromString`` :410+; per-tree block ``Tree::ToString``
src/io/tree.cpp:223).  Text written here is byte-identical to the JAX
package's for the same trees, and either package loads the other's.
``dump_model_dict`` is the JSON dump (JAX :353-413; reference
``GBDT::DumpModel``, gbdt_model_text.cpp:21-120).

decision_type byte (reference include/LightGBM/tree.h decision-type masks):
bit0 = categorical, bit1 = default_left, bits 2-3 = missing type
(0 None, 1 Zero, 2 NaN).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from ..models.tree import HostTree, validate_host_tree
from .binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO
from ..utils.log import log_fatal, log_warning

_K_CATEGORICAL_MASK = 1
_K_DEFAULT_LEFT_MASK = 2


def _encode_decision_type(is_cat: bool, default_left: bool,
                          missing_type: int) -> int:
    dt = 0
    if is_cat:
        dt |= _K_CATEGORICAL_MASK
    if default_left:
        dt |= _K_DEFAULT_LEFT_MASK
    dt |= (int(missing_type) & 3) << 2
    return dt


def _decode_decision_type(dt: int):
    return (bool(dt & _K_CATEGORICAL_MASK), bool(dt & _K_DEFAULT_LEFT_MASK),
            (dt >> 2) & 3)


def _fmt_float(x: float) -> str:
    """High-precision float formatting (reference Common::DoubleToStr)."""
    return np.format_float_scientific(x, precision=16, trim="-")


def _fmt_list(values, fmt=str) -> str:
    return " ".join(fmt(v) for v in values)


def _cats_to_bitset(cats: np.ndarray) -> np.ndarray:
    """Raw category values -> uint32 bitset words (reference
    Common::ConstructBitset); word count = max//32 + 1."""
    cats = np.asarray(cats, dtype=np.int64)
    if len(cats) == 0:
        return np.zeros(1, np.uint32)
    words = np.zeros(int(cats.max()) // 32 + 1, np.uint32)
    np.bitwise_or.at(words, cats // 32,
                     np.uint32(1) << (cats % 32).astype(np.uint32))
    return words


def _bitset_to_cats(words: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(np.asarray(words, np.uint32).view(np.uint8),
                         bitorder="little")
    return np.flatnonzero(bits).astype(np.int64)


def tree_to_string(tree: HostTree, index: int) -> str:
    """Per-tree block (reference: Tree::ToString, src/io/tree.cpp:223)."""
    n = tree.num_leaves
    n_nodes = max(n - 1, 0)
    is_cat = tree.is_cat
    cat_nodes = [i for i in range(n_nodes) if is_cat[i]]
    lines = [f"Tree={index}", f"num_leaves={n}", f"num_cat={len(cat_nodes)}"]
    if n > 1:
        dts = [
            _encode_decision_type(bool(is_cat[i]), bool(dl), int(mt))
            for i, (dl, mt) in enumerate(zip(tree.default_left,
                                             tree.missing_type))
        ]
        # categorical nodes store their cat index in the threshold slot
        # (reference Tree::SplitCategorical, tree.cpp:78-80)
        thresholds = np.array(tree.threshold, dtype=np.float64)
        boundaries = [0]
        words_all: List[int] = []
        for ci, node in enumerate(cat_nodes):
            thresholds[node] = float(ci)
            s = tree.cat_sets[node]
            w = _cats_to_bitset(s if s is not None else tree.cat_bins_of(node))
            boundaries.append(boundaries[-1] + len(w))
            words_all.extend(int(x) for x in w)
        lines.append("split_feature=" + _fmt_list(tree.split_feature))
        lines.append("split_gain=" + _fmt_list(tree.split_gain,
                                               lambda x: f"{x:.8g}"))
        lines.append("threshold=" + _fmt_list(thresholds, _fmt_float))
        lines.append("decision_type=" + _fmt_list(dts))
        lines.append("left_child=" + _fmt_list(tree.left_child))
        lines.append("right_child=" + _fmt_list(tree.right_child))
        lines.append("leaf_value=" + _fmt_list(tree.leaf_value, _fmt_float))
        lines.append("leaf_weight=" + _fmt_list(tree.leaf_weight,
                                                lambda x: f"{x:.8g}"))
        lines.append("leaf_count=" + _fmt_list(tree.leaf_count))
        lines.append("internal_value=" + _fmt_list(tree.internal_value,
                                                   lambda x: f"{x:.8g}"))
        lines.append("internal_weight=" + _fmt_list(tree.internal_weight,
                                                    lambda x: f"{x:.8g}"))
        lines.append("internal_count=" + _fmt_list(tree.internal_count))
        if cat_nodes:
            lines.append("cat_boundaries=" + _fmt_list(boundaries))
            lines.append("cat_threshold=" + _fmt_list(words_all))
    else:
        lines.append("leaf_value=" + _fmt_float(
            tree.leaf_value[0] if len(tree.leaf_value) else 0.0))
    lines.append(f"shrinkage={tree.shrinkage:g}")
    return "\n".join(lines) + "\n"


def _parse_tree_block(block: str) -> HostTree:
    kv: Dict[str, str] = {}
    index = 0
    for line in block.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("Tree="):
            index = int(line.split("=", 1)[1])
            continue
        if "=" in line:
            k, v = line.split("=", 1)
            kv[k] = v

    n = int(kv["num_leaves"])
    n_nodes = max(n - 1, 0)

    def arr(key, dtype, size):
        if key not in kv or not kv[key].strip():
            return np.zeros(size, dtype=dtype)
        return np.array(kv[key].split(), dtype=dtype)

    threshold = arr("threshold", np.float64, n_nodes)
    decoded = [_decode_decision_type(int(dt))
               for dt in arr("decision_type", np.int32, n_nodes)]
    is_cat = np.array([d[0] for d in decoded], bool)
    cat_sets: list = [None] * n_nodes
    if is_cat.any():
        bounds = arr("cat_boundaries", np.int64, 0)
        words = arr("cat_threshold", np.uint32, 0)
        for node in np.flatnonzero(is_cat):
            ci = int(threshold[node])
            cat_sets[node] = _bitset_to_cats(
                words[int(bounds[ci]): int(bounds[ci + 1])])
    t = HostTree(
        n, shrinkage=float(kv.get("shrinkage", 1.0)),
        cat_bitset=np.zeros((n_nodes, 1), np.uint32),  # bin space unknown
        cat_sets=cat_sets,
        split_feature=arr("split_feature", np.int32, n_nodes),
        split_gain=arr("split_gain", np.float64, n_nodes),
        threshold=threshold,
        default_left=np.array([d[1] for d in decoded], bool),
        missing_type=np.array([d[2] for d in decoded], np.int32),
        is_cat=is_cat,
        left_child=arr("left_child", np.int32, n_nodes),
        right_child=arr("right_child", np.int32, n_nodes),
        leaf_value=arr("leaf_value", np.float64, n),
        leaf_weight=arr("leaf_weight", np.float64, n),
        leaf_count=arr("leaf_count", np.int64, n),
        internal_value=arr("internal_value", np.float64, n_nodes),
        internal_weight=arr("internal_weight", np.float64, n_nodes),
        internal_count=arr("internal_count", np.int64, n_nodes),
    )
    # child-pointer structural validation: a malformed model file must
    # fail the load, not send a walk round a cycle
    try:
        validate_host_tree(t, index)
    except ValueError as e:
        log_fatal(f"Invalid model file: {e}")
    # reconstruct leaf_parent from children
    for nd in range(n_nodes):
        for c in (t.left_child[nd], t.right_child[nd]):
            if c < 0:
                t.leaf_parent[-c - 1] = nd
    return t


@dataclass
class LoadedModel:
    """Parsed model — everything needed for prediction."""

    trees: List[HostTree] = field(default_factory=list)
    objective: str = "regression"
    objective_params: Dict[str, str] = field(default_factory=dict)
    num_class: int = 1
    num_tree_per_iteration: int = 1
    label_index: int = 0
    max_feature_idx: int = 0
    feature_names: List[str] = field(default_factory=list)
    feature_infos: List[str] = field(default_factory=list)
    average_output: bool = False
    parameters: Dict[str, str] = field(default_factory=dict)

    @property
    def num_iterations(self) -> int:
        return len(self.trees) // max(self.num_tree_per_iteration, 1)


def model_to_string(
    trees: List[HostTree],
    *,
    objective_string: str,
    num_class: int,
    num_tree_per_iteration: int,
    feature_names: List[str],
    feature_infos: List[str],
    label_index: int = 0,
    average_output: bool = False,
    parameters: Optional[Dict[str, Any]] = None,
    importance_type: int = 0,
) -> str:
    """reference: GBDT::SaveModelToString, gbdt_model_text.cpp:306-397."""
    out: List[str] = [
        "tree",
        "version=v3",
        f"num_class={num_class}",
        f"num_tree_per_iteration={num_tree_per_iteration}",
        f"label_index={label_index}",
        f"max_feature_idx={len(feature_names) - 1}",
        f"objective={objective_string}",
    ]
    if average_output:
        out.append("average_output")
    out.append("feature_names=" + " ".join(feature_names))
    out.append("feature_infos=" + " ".join(feature_infos))

    tree_strs = [tree_to_string(t, i) + "\n" for i, t in enumerate(trees)]
    out.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
    out.append("")
    for s in tree_strs:
        out.append(s.rstrip("\n"))
        out.append("")
    out.append("end of trees")
    out.append("")

    # feature importances, descending (split counts (0) or total gains (1),
    # reference gbdt.cpp:779-800)
    counts = np.zeros(len(feature_names), dtype=np.float64)
    for t in trees:
        for i, f in enumerate(t.split_feature[: t.num_leaves - 1]):
            counts[f] += t.split_gain[i] if importance_type == 1 else 1.0
    order = np.argsort(-counts, kind="stable")
    out.append("feature_importances:")
    for i in order:
        if counts[i] > 0:
            val = (f"{counts[i]:g}" if importance_type == 1
                   else str(int(counts[i])))
            out.append(f"{feature_names[i]}={val}")
    out.append("")
    out.append("parameters:")
    for k, v in (parameters or {}).items():
        if isinstance(v, (list, tuple)):
            v = ",".join(str(x) for x in v)
        out.append(f"[{k}: {v}]")
    out.append("end of parameters")
    out.append("")
    out.append("pandas_categorical:null")
    return "\n".join(out) + "\n"


def model_from_string(model_str: str) -> LoadedModel:
    """reference: GBDT::LoadModelFromString, gbdt_model_text.cpp:410+."""
    m = LoadedModel()
    lines = model_str.splitlines()
    i = 0
    n = len(lines)
    # header
    while i < n and not lines[i].startswith("Tree="):
        line = lines[i].strip()
        i += 1
        if not line or line == "tree":
            continue
        if line == "end of trees":
            break
        if line == "average_output":
            m.average_output = True
            continue
        if "=" not in line:
            continue
        key, value = line.split("=", 1)
        if key == "num_class":
            m.num_class = int(value)
        elif key == "num_tree_per_iteration":
            m.num_tree_per_iteration = int(value)
        elif key == "label_index":
            m.label_index = int(value)
        elif key == "max_feature_idx":
            m.max_feature_idx = int(value)
        elif key == "objective":
            parts = value.split()
            m.objective = parts[0] if parts else "regression"
            for p in parts[1:]:
                if ":" in p:
                    k2, v2 = p.split(":", 1)
                    m.objective_params[k2] = v2
        elif key == "feature_names":
            m.feature_names = value.split()
        elif key == "feature_infos":
            m.feature_infos = value.split()
    # trees
    while i < n:
        line = lines[i].strip()
        if line.startswith("Tree="):
            block = [lines[i]]
            i += 1
            while i < n and lines[i].strip() != "":
                block.append(lines[i])
                i += 1
            m.trees.append(_parse_tree_block("\n".join(block)))
        elif line == "end of trees":
            i += 1
            break
        else:
            i += 1
    # parameters block
    in_params = False
    for j in range(i, n):
        line = lines[j].strip()
        if line == "parameters:":
            in_params = True
        elif line == "end of parameters":
            in_params = False
        elif in_params and line.startswith("[") and line.endswith("]"):
            inner = line[1:-1]
            if ": " in inner:
                k, v = inner.split(": ", 1)
                m.parameters[k] = v
    if not m.trees and "Tree=" in model_str:
        log_warning("Model parsing found no trees")
    return m


# ---------------------------------------------------------------------------
# JSON dump (reference: GBDT::DumpModel, gbdt_model_text.cpp:21-120)
# ---------------------------------------------------------------------------


def _node_to_dict(tree: HostTree, node: int,
                  feature_names: List[str]) -> Dict:
    if node < 0:
        leaf = -node - 1
        return {"leaf_index": int(leaf),
                "leaf_value": float(tree.leaf_value[leaf]),
                "leaf_weight": float(tree.leaf_weight[leaf]),
                "leaf_count": int(tree.leaf_count[leaf])}
    mt = {MISSING_NONE: "None", MISSING_ZERO: "Zero", MISSING_NAN: "NaN"}[
        int(tree.missing_type[node])]
    return {
        "split_index": int(node),
        "split_feature": int(tree.split_feature[node]),
        "split_gain": float(tree.split_gain[node]),
        "threshold": float(tree.threshold[node]),
        "decision_type": "<=",
        "default_left": bool(tree.default_left[node]),
        "missing_type": mt,
        "internal_value": float(tree.internal_value[node]),
        "internal_weight": float(tree.internal_weight[node]),
        "internal_count": int(tree.internal_count[node]),
        "left_child": _node_to_dict(tree, int(tree.left_child[node]),
                                    feature_names),
        "right_child": _node_to_dict(tree, int(tree.right_child[node]),
                                     feature_names),
    }


def dump_model_dict(trees: List[HostTree], *, objective_string: str,
                    num_class: int, num_tree_per_iteration: int,
                    feature_names: List[str], feature_infos: List[str],
                    label_index: int = 0,
                    average_output: bool = False) -> Dict:
    """The model as the reference's JSON dump (JAX model_text.py:381)."""
    return {
        "name": "tree",
        "version": "v3",
        "num_class": num_class,
        "num_tree_per_iteration": num_tree_per_iteration,
        "label_index": label_index,
        "max_feature_idx": len(feature_names) - 1,
        "objective": objective_string,
        "average_output": average_output,
        "feature_names": list(feature_names),
        "feature_infos": list(feature_infos),
        "tree_info": [
            {"tree_index": i, "num_leaves": t.num_leaves, "num_cat": 0,
             "shrinkage": t.shrinkage,
             "tree_structure": _node_to_dict(
                 t, 0 if t.num_leaves > 1 else -1, feature_names)}
            for i, t in enumerate(trees)],
    }
