"""Model -> standalone C++ if-else code; the port's copy of
lightgbmv1_tpu/io/model_codegen.py (``task=convert_model``).

The counterpart of the reference's model compiler
(``GBDT::SaveModelToIfElse`` / ``Tree::ToIfElse``,
src/boosting/gbdt_model_text.cpp:122-304, src/io/tree.cpp
NumericalDecisionIfElse/CategoricalDecisionIfElse): a self-contained C++
translation unit with one function per tree (nested if-else over the
split structure) plus ``PredictRaw``/``Predict`` aggregators, so a trained
model can be deployed with zero runtime dependencies.  The code is the
JAX package's byte for byte, its banner included.

The emitted decision logic mirrors the host predictor exactly:
numerical nodes reproduce missing-type handling (None/Zero/NaN +
default-left), categorical nodes test raw-category bitset membership
(truncation cast; negatives and NaN go right).
"""

from __future__ import annotations

from typing import List

import numpy as np

from .binning import MISSING_NAN, MISSING_ZERO
from ..models.tree import HostTree

_K_ZERO = 1e-35


def _node_code(t: HostTree, node: int, indent: str, tree_idx: int,
               cat_arrays: List[str]) -> str:
    if node < 0:
        leaf = -node - 1
        return f"{indent}return {float(t.leaf_value[leaf])!r};\n"
    f = int(t.split_feature[node])
    mt = int(t.missing_type[node])
    dl = bool(t.default_left[node])
    out = ""
    if t.is_cat[node]:
        cats = np.asarray(t.cat_sets[node] if t.cat_sets[node] is not None
                          else t.cat_bins_of(node))
        name = f"kCatSet_{tree_idx}_{node}"
        cat_arrays.append(
            f"static const int {name}[] = {{"
            + ", ".join(str(int(c)) for c in cats) + "};")
        out += (f"{indent}if (CatInSet(fval[{f}], {name}, "
                f"{len(cats)})) {{\n")
    else:
        thr = float(t.threshold[node])
        v = f"fval[{f}]"
        if mt == MISSING_NAN:
            miss = f"std::isnan({v})"
        elif mt == MISSING_ZERO:
            miss = f"(std::isnan({v}) || std::fabs({v}) <= {_K_ZERO!r})"
        else:
            miss = "false"
        go_left = (f"({miss}) ? {str(dl).lower()} : "
                   f"(ZeroIfNan({v}) <= {thr!r})")
        out += f"{indent}if ({go_left}) {{\n"
    out += _node_code(t, int(t.left_child[node]), indent + "  ",
                      tree_idx, cat_arrays)
    out += f"{indent}}} else {{\n"
    out += _node_code(t, int(t.right_child[node]), indent + "  ",
                      tree_idx, cat_arrays)
    out += f"{indent}}}\n"
    return out


def model_to_cpp(loaded) -> str:
    """The C++ source of ``loaded``, a LoadedModel (io/model_text.py)."""
    trees: List[HostTree] = loaded.trees
    K = max(loaded.num_tree_per_iteration, 1)
    n_feat = loaded.max_feature_idx + 1
    parts = [
        "// Generated by lightgbmv1_tpu task=convert_model "
        "(reference: GBDT::SaveModelToIfElse)",
        "#include <cmath>",
        "#include <cstring>",
        "",
        "static inline double ZeroIfNan(double v) "
        "{ return std::isnan(v) ? 0.0 : v; }",
        "static inline bool CatInSet(double v, const int* s, int n) {",
        "  if (std::isnan(v)) return false;",
        "  long c = (long)v;  // truncation cast, reference "
        "CategoricalDecision",
        "  if (c < 0) return false;",
        "  for (int i = 0; i < n; ++i) if (s[i] == c) return true;",
        "  return false;",
        "}",
        "",
    ]
    import sys

    max_leaves = max((t.num_leaves for t in trees), default=2)
    # nested-if emission recurses once per tree level; leaf-wise paths can
    # approach num_leaves-1 levels
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 3 * max_leaves + 200))
    for i, t in enumerate(trees):
        cat_arrays: List[str] = []
        if t.num_leaves <= 1:
            v = t.leaf_value[0] if len(t.leaf_value) else 0.0
            body = f"  return {float(v)!r};"
        else:
            body = _node_code(t, 0, "  ", i, cat_arrays).rstrip("\n")
        parts.extend(cat_arrays)
        parts.append(f"static double PredictTree{i}(const double* fval) {{")
        parts.append(body)
        parts.append("}")
        parts.append("")
    parts.append(f"static const int kNumTrees = {len(trees)};")
    parts.append(f"static const int kNumClass = {K};")
    parts.append(f"static const int kNumFeature = {n_feat};")
    parts.append("")
    parts.append("void PredictRaw(const double* fval, double* output) {")
    parts.append(f"  std::memset(output, 0, sizeof(double) * {K});")
    for i in range(len(trees)):
        parts.append(f"  output[{i % K}] += PredictTree{i}(fval);")
    parts.append("}")
    parts.append("")
    obj = loaded.objective
    parts.append("void Predict(const double* fval, double* output) {")
    parts.append("  PredictRaw(fval, output);")
    if obj == "binary":
        sigmoid = float(loaded.objective_params.get("sigmoid", 1.0))
        parts.append(f"  output[0] = 1.0 / (1.0 + std::exp(-{sigmoid!r} * "
                     "output[0]));")
    elif obj in ("multiclass", "softmax"):
        parts.append(f"  double wmax = output[0], wsum = 0.0;")
        parts.append(f"  for (int k = 1; k < {K}; ++k) "
                     "if (output[k] > wmax) wmax = output[k];")
        parts.append(f"  for (int k = 0; k < {K}; ++k) "
                     "{ output[k] = std::exp(output[k] - wmax); "
                     "wsum += output[k]; }")
        parts.append(f"  for (int k = 0; k < {K}; ++k) output[k] /= wsum;")
    parts.append("}")
    parts.append("")
    return "\n".join(parts)
