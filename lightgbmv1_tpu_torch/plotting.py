"""Plotting: importance, metric, split-value histogram and tree; the
port's copy of lightgbmv1_tpu/plotting.py.

API-compatible with the reference plotting module
(python-package/lightgbm/plotting.py: plot_importance :21,
plot_split_value_histogram :118, plot_metric :208, plot_tree :537,
create_tree_digraph :420).  matplotlib and graphviz are imported when a
function needs them and raise the reference's ImportError messages when
absent.
"""

from __future__ import annotations

from copy import deepcopy
from typing import List, Optional

import numpy as np

from .basic import Booster
from .utils.log import log_warning


def _check_not_tuple_of_2_elements(obj, obj_name: str) -> None:
    if not isinstance(obj, (list, tuple)) or len(obj) != 2:
        raise TypeError(f"{obj_name} must be a list/tuple of 2 elements")


def _get_matplotlib():
    try:
        import matplotlib.pyplot as plt
        return plt
    except ImportError:
        raise ImportError("You must install matplotlib "
                          "to plot importance/metric/split histograms.")


def plot_importance(
    booster,
    ax=None,
    height: float = 0.2,
    xlim=None,
    ylim=None,
    title: str = "Feature importance",
    xlabel: str = "Feature importance",
    ylabel: str = "Features",
    importance_type: str = "split",
    max_num_features: Optional[int] = None,
    ignore_zero: bool = True,
    figsize=None,
    dpi=None,
    grid: bool = True,
    precision: Optional[int] = 3,
    **kwargs,
):
    """Plot model feature importances (reference plotting.py:21)."""
    plt = _get_matplotlib()
    if isinstance(booster, Booster):
        importance = booster.feature_importance(
            importance_type=importance_type)
        feature_names = booster.feature_name()
    elif hasattr(booster, "booster_"):       # sklearn wrapper
        importance = booster.booster_.feature_importance(
            importance_type=importance_type)
        feature_names = booster.booster_.feature_name()
    else:
        raise TypeError("booster must be Booster or LGBMModel")

    tuples = sorted(zip(feature_names, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [x for x in tuples if x[1] > 0]
    if not tuples:
        raise ValueError("Cannot plot empty feature importances")
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    labels, values = zip(*tuples)

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        fmt = f"%.{precision}f" if (precision is not None
                                    and importance_type == "gain") else "%d"
        ax.text(x + 1, y, fmt % x, va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
    else:
        xlim = (0, max(values) * 1.1)
    ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
    else:
        ylim = (-1, len(values))
    ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_split_value_histogram(
    booster,
    feature,
    bins=None,
    ax=None,
    width_coef: float = 0.8,
    xlim=None,
    ylim=None,
    title: Optional[str] = ("Split value histogram for feature with "
                            "@index/name@ @feature@"),
    xlabel: Optional[str] = "Feature split value",
    ylabel: Optional[str] = "Count",
    figsize=None,
    dpi=None,
    grid: bool = True,
    **kwargs,
):
    """Histogram of split threshold values used for one feature
    (reference plotting.py:118)."""
    plt = _get_matplotlib()
    if hasattr(booster, "booster_"):
        booster = booster.booster_
    names = booster.feature_name()
    if isinstance(feature, str):
        fidx = names.index(feature)
    else:
        fidx = int(feature)
    values = []
    for t in booster._all_trees():
        for i in range(t.num_leaves - 1):
            if t.split_feature[i] == fidx and not t.is_cat[i]:
                values.append(float(t.threshold[i]))
    if not values:
        raise ValueError(
            "Cannot plot split value histogram, "
            f"because feature {feature} was not used in splitting")
    values = np.asarray(values)
    hist, bin_edges = np.histogram(values, bins=bins or "auto")
    centres = (bin_edges[:-1] + bin_edges[1:]) / 2
    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    width = width_coef * (bin_edges[1] - bin_edges[0])
    ax.bar(centres, hist, align="center", width=width, **kwargs)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
        ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
    else:
        ylim = (0, max(hist) * 1.1)
    ax.set_ylim(ylim)
    if title is not None:
        title = title.replace("@feature@", str(feature)).replace(
            "@index/name@", "name" if isinstance(feature, str) else "index")
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(
    booster,
    metric: Optional[str] = None,
    dataset_names: Optional[List[str]] = None,
    ax=None,
    xlim=None,
    ylim=None,
    title: Optional[str] = "Metric during training",
    xlabel: Optional[str] = "Iterations",
    ylabel: Optional[str] = "@metric@",
    figsize=None,
    dpi=None,
    grid: bool = True,
):
    """Plot a metric recorded with record_evaluation (reference
    plotting.py:208). ``booster`` is the evals_result dict or an LGBMModel."""
    plt = _get_matplotlib()
    if isinstance(booster, dict):
        eval_results = deepcopy(booster)
    elif hasattr(booster, "evals_result_"):
        eval_results = deepcopy(booster.evals_result_)
    else:
        raise TypeError("booster must be dict or LGBMModel")
    if not eval_results:
        raise ValueError("eval results cannot be empty")

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)

    if dataset_names is None:
        dataset_names = list(eval_results.keys())
    name0 = dataset_names[0]
    metrics_for_one = eval_results[name0]
    if metric is None:
        if len(metrics_for_one) > 1:
            log_warning("More than one metric available, picking one to plot.")
        metric, results = list(metrics_for_one.items())[-1]
    else:
        results = metrics_for_one[metric]
    num_iteration = len(results)
    max_result = max(results)
    min_result = min(results)
    x_ = np.arange(num_iteration)
    for name in dataset_names:
        results = eval_results[name][metric]
        ax.plot(x_, results, label=name)
        max_result = max(max(results), max_result)
        min_result = min(min(results), min_result)
    ax.legend(loc="best")
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
    else:
        xlim = (0, num_iteration)
    ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
    else:
        margin = 0.05 * (max_result - min_result + 1e-12)
        ylim = (min_result - margin, max_result + margin)
    ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel.replace("@metric@", metric))
    ax.grid(grid)
    return ax


# ---------------------------------------------------------------------------
# Tree visualization (graphviz)
# ---------------------------------------------------------------------------


def _tree_to_graph(tree, feature_names, precision=3, orientation="horizontal",
                   show_info=None, **kwargs):
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("You must install graphviz to plot tree.")
    show_info = show_info or []

    graph = Digraph(**kwargs)
    rankdir = "LR" if orientation == "horizontal" else "TB"
    graph.attr(rankdir=rankdir)

    def fmt(v):
        return f"{v:.{precision}f}"

    def add(node, parent=None, decision=None):
        if node >= 0:
            name = f"split{node}"
            f = int(tree.split_feature[node])
            fname = (feature_names[f] if feature_names is not None
                     else f"Column_{f}")
            if tree.is_cat[node]:
                cats = tree.cat_sets[node]
                if cats is None:
                    cats = tree.cat_bins_of(node)
                label = f"{fname} in " + "||".join(
                    str(int(c)) for c in np.asarray(cats)[:10])
            else:
                label = f"{fname} <= {fmt(float(tree.threshold[node]))}"
            if "split_gain" in show_info:
                label += f"\\ngain: {fmt(float(tree.split_gain[node]))}"
            if "internal_value" in show_info:
                label += f"\\nvalue: {fmt(float(tree.internal_value[node]))}"
            if "internal_count" in show_info:
                label += f"\\ncount: {int(tree.internal_count[node])}"
            graph.node(name, label=label, shape="rectangle")
            add(int(tree.left_child[node]), name, "yes")
            add(int(tree.right_child[node]), name, "no")
        else:
            leaf = -node - 1
            name = f"leaf{leaf}"
            label = f"leaf {leaf}: {fmt(float(tree.leaf_value[leaf]))}"
            if "leaf_count" in show_info:
                label += f"\\ncount: {int(tree.leaf_count[leaf])}"
            if "leaf_weight" in show_info:
                label += f"\\nweight: {fmt(float(tree.leaf_weight[leaf]))}"
            graph.node(name, label=label)
        if parent is not None:
            graph.edge(parent, name, decision)

    add(0 if tree.num_leaves > 1 else -1)
    return graph


def create_tree_digraph(
    booster,
    tree_index: int = 0,
    show_info: Optional[List[str]] = None,
    precision: Optional[int] = 3,
    orientation: str = "horizontal",
    **kwargs,
):
    """Create a graphviz Digraph of one tree (reference plotting.py:420)."""
    if hasattr(booster, "booster_"):
        booster = booster.booster_
    trees = booster._all_trees()
    if tree_index >= len(trees):
        raise IndexError("tree_index is out of range.")
    return _tree_to_graph(trees[tree_index], booster.feature_name(),
                          precision=precision, orientation=orientation,
                          show_info=show_info, **kwargs)


def plot_tree(
    booster,
    ax=None,
    tree_index: int = 0,
    figsize=None,
    dpi=None,
    show_info: Optional[List[str]] = None,
    precision: Optional[int] = 3,
    orientation: str = "horizontal",
    **kwargs,
):
    """Render one tree with matplotlib via graphviz (reference
    plotting.py:537)."""
    plt = _get_matplotlib()
    import io

    graph = create_tree_digraph(booster, tree_index=tree_index,
                                show_info=show_info, precision=precision,
                                orientation=orientation, **kwargs)
    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    from matplotlib.image import imread

    s = graph.pipe(format="png")
    ax.imshow(imread(io.BytesIO(s)))
    ax.axis("off")
    return ax
