"""The port's sklearn wrappers and plotting functions against the JAX
package's, on the CPU (JAX tests/test_sklearn_api.py, test_plotting.py).

The four estimators (``device_type="cpu"`` among their keyword
parameters) fit the same rows at ``hist_dtype=f32`` as the JAX ones:
predictions within 2e-5 (the port's training tolerance), the same
classes, ``get_params`` / ``set_params`` / ``sklearn.base.clone`` alike.
The plots, under matplotlib's Agg backend, of one model text loaded by
both packages carry the JAX figures' data; ``create_tree_digraph`` and
``plot_tree`` build the JAX package's graph through a stub ``graphviz``
module put in ``sys.modules`` (graphviz is installed on neither machine).
"""

import io
import sys
import types

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbmv1_tpu as lj  # noqa: E402

import lightgbmv1_tpu_torch as lt  # noqa: E402

CPU = {"device_type": "cpu"}
COMMON = dict(num_leaves=7, min_child_samples=10, n_estimators=8,
              hist_dtype="f32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _data(n=600, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    logit = 1.5 * X[:, 0] - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    return X, logit + 0.3 * rng.randn(n)


def _fit(name, X, y, **fit_kw):
    """The JAX estimator and the port's, fitted on the same rows."""
    out = []
    for pkg, extra in ((lj, {}), (lt, CPU)):
        est = getattr(pkg, name)(**COMMON, **extra)
        out.append(est.fit(X, y, **fit_kw))
    return out


def test_regressor_matches_jax():
    X, t = _data()
    je, te = _fit("LGBMRegressor", X, t)
    np.testing.assert_allclose(te.predict(X), je.predict(X), rtol=0,
                               atol=2e-5)
    assert te.n_features_ == je.n_features_ == 5
    np.testing.assert_array_equal(te.feature_importances_,
                                  je.feature_importances_)
    assert te.feature_name_ == je.feature_name_
    assert te.booster_.current_iteration() == 8


@pytest.mark.parametrize("n_class", [2, 3])
def test_classifier_matches_jax(n_class):
    X, t = _data(seed=1)
    labels = np.array(["ant", "bee", "cat"])[:n_class]
    y = labels[np.digitize(t, [0.0] if n_class == 2 else [-0.8, 0.8])]
    Xv, tv = _data(200, seed=2)
    yv = labels[np.digitize(tv, [0.0] if n_class == 2 else [-0.8, 0.8])]
    je, te = _fit("LGBMClassifier", X, y, eval_set=[(Xv, yv)])
    assert list(te.classes_) == list(je.classes_) == list(labels)
    assert te.n_classes_ == n_class
    np.testing.assert_allclose(te.predict_proba(Xv), je.predict_proba(Xv),
                               rtol=0, atol=2e-5)
    assert te.predict_proba(Xv).shape == (200, n_class)
    np.testing.assert_array_equal(te.predict(Xv), je.predict(Xv))
    np.testing.assert_allclose(te.predict(Xv, raw_score=True),
                               je.predict(Xv, raw_score=True), rtol=0,
                               atol=2e-5)
    for name, metrics in je.evals_result_.items():
        for metric, values in metrics.items():
            np.testing.assert_allclose(te.evals_result_[name][metric],
                                       values, rtol=0, atol=1e-6)


def test_classifier_early_stopping_and_class_weight():
    X, t = _data(seed=3)
    y = (t > 0).astype(int)
    Xv, tv = _data(200, seed=4)
    yv = (tv > 0).astype(int)
    out = []
    for pkg, extra in ((lj, {}), (lt, CPU)):
        est = pkg.LGBMClassifier(num_leaves=7, n_estimators=60,
                                 learning_rate=0.5, class_weight="balanced",
                                 hist_dtype="f32", **extra)
        out.append(est.fit(X, y, eval_set=[(Xv, yv)],
                           eval_metric="binary_logloss",
                           early_stopping_rounds=3))
    je, te = out
    assert te.best_iteration_ == je.best_iteration_
    assert 0 < te.best_iteration_ < 60
    np.testing.assert_allclose(te.predict_proba(Xv), je.predict_proba(Xv),
                               rtol=0, atol=2e-5)


def test_ranker_matches_jax():
    rng = np.random.RandomState(7)
    X = rng.randn(30 * 20, 5)
    rel = np.clip((X[:, 0] * 2 + rng.randn(600) * 0.5).round(), 0, 4)
    group = np.full(30, 20)
    je, te = _fit("LGBMRanker", X, rel, group=group, eval_metric="ndcg")
    np.testing.assert_allclose(te.predict(X), je.predict(X), rtol=0,
                               atol=2e-5)
    with pytest.raises(lt.LightGBMError, match="group"):
        lt.LGBMRanker(**CPU).fit(X, rel)


def test_model_matches_jax():
    """The base estimator trains its default objective (regression)."""
    X, t = _data(seed=5)
    je, te = _fit("LGBMModel", X, t)
    np.testing.assert_allclose(te.predict(X), je.predict(X), rtol=0,
                               atol=2e-5)
    with pytest.raises(lt.LightGBMError, match="fit"):
        lt.LGBMModel().predict(X)


@pytest.mark.parametrize("name", ["LGBMModel", "LGBMRegressor",
                                  "LGBMClassifier", "LGBMRanker"])
def test_params_protocol(name):
    """get_params / set_params as the JAX estimators, and
    sklearn.base.clone keeps every parameter, the extra ones too."""
    from sklearn.base import clone

    kw = dict(num_leaves=9, learning_rate=0.2, custom_thing=3, **CPU)
    te, je = getattr(lt, name)(**kw), getattr(lj, name)(**kw)
    assert te.get_params() == je.get_params()
    te.set_params(num_leaves=15, other=1)
    je.set_params(num_leaves=15, other=1)
    assert te.get_params() == je.get_params()
    assert te.num_leaves == 15 and te.get_params()["other"] == 1
    c = clone(te)
    assert type(c) is type(te) and c is not te
    assert c.get_params() == te.get_params()


@pytest.fixture(scope="module")
def pair():
    """One model text loaded by both packages, and a record of metrics."""
    X, t = _data(seed=6)
    y = (t > 0).astype(float)
    res = {}
    b = lt.train({"objective": "binary", "num_leaves": 7, "verbosity": -1,
                  "metric": ["auc", "binary_logloss"]},
                 lt.Dataset(X, label=y), 8,
                 valid_sets=[lt.Dataset(X[:200], label=y[:200])],
                 valid_names=["v0"], evals_result=res, device="cpu")
    text = b.model_to_string()
    return (lj.Booster(model_str=text),
            lt.Booster(model_str=text, device="cpu"), res)


def _bars(ax):
    return [(p.get_x(), p.get_y(), p.get_width(), p.get_height())
            for p in ax.patches]


def _texts(ax):
    return ([t.get_text() for t in ax.get_yticklabels()],
            [t.get_text() for t in ax.texts], ax.get_xlim(), ax.get_ylim(),
            ax.get_title(), ax.get_xlabel(), ax.get_ylabel())


@pytest.mark.parametrize("kw", [{}, {"importance_type": "gain",
                                     "max_num_features": 3}])
def test_plot_importance_matches_jax(pair, kw):
    jb, tb, _ = pair
    ta, ja = lt.plot_importance(tb, **kw), lj.plot_importance(jb, **kw)
    assert len(ta.patches) > 0
    assert _bars(ta) == _bars(ja) and _texts(ta) == _texts(ja)


def test_plot_importance_of_an_estimator():
    X, t = _data(seed=8)
    te = lt.LGBMRegressor(**COMMON, **CPU).fit(X, t)
    je = lj.LGBMRegressor(**COMMON).fit(X, t)
    assert _bars(lt.plot_importance(te)) == _bars(lj.plot_importance(je))
    with pytest.raises(TypeError):
        lt.plot_importance(42)


def test_plot_split_value_histogram_matches_jax(pair):
    jb, tb, _ = pair
    ta = lt.plot_split_value_histogram(tb, feature=0, bins=5)
    ja = lj.plot_split_value_histogram(jb, feature=0, bins=5)
    assert len(ta.patches) == 5
    assert _bars(ta) == _bars(ja) and _texts(ta) == _texts(ja)
    with pytest.raises(ValueError, match="not used in splitting"):
        lt.plot_split_value_histogram(tb, feature=4)


def test_plot_metric_matches_jax(pair):
    _, _, res = pair
    for metric in ("auc", None):
        ta, ja = lt.plot_metric(res, metric=metric), lj.plot_metric(
            res, metric=metric)
        assert [list(ln.get_ydata()) for ln in ta.lines] == \
            [list(ln.get_ydata()) for ln in ja.lines]
        assert _texts(ta) == _texts(ja)
    with pytest.raises(TypeError):
        lt.plot_metric(42)


class _Digraph:
    """A stand-in for graphviz.Digraph that records what is drawn."""

    def __init__(self, **kwargs):
        self.calls = [("init", kwargs)]

    def attr(self, **kwargs):
        self.calls.append(("attr", kwargs))

    def node(self, name, **kwargs):
        self.calls.append(("node", name, kwargs))

    def edge(self, tail, head, label=None):
        self.calls.append(("edge", tail, head, label))

    def pipe(self, format="png"):
        buf = io.BytesIO()
        plt.imsave(buf, np.zeros((4, 4, 3)), format=format)
        return buf.getvalue()


@pytest.fixture
def graphviz(monkeypatch):
    mod = types.ModuleType("graphviz")
    mod.Digraph = _Digraph
    monkeypatch.setitem(sys.modules, "graphviz", mod)


@pytest.mark.parametrize("kw", [
    {}, {"tree_index": 3, "orientation": "vertical", "precision": 5,
         "show_info": ["split_gain", "internal_value", "internal_count",
                       "leaf_count", "leaf_weight"]}])
def test_create_tree_digraph_matches_jax(pair, graphviz, kw):
    jb, tb, _ = pair
    tg, jg = lt.create_tree_digraph(tb, **kw), lj.create_tree_digraph(jb,
                                                                      **kw)
    assert tg.calls == jg.calls
    assert sum(c[0] == "node" for c in tg.calls) == \
        2 * tb._all_trees()[kw.get("tree_index", 0)].num_leaves - 1
    with pytest.raises(IndexError):
        lt.create_tree_digraph(tb, tree_index=99)


def test_plot_tree_draws_the_graph(pair, graphviz):
    jb, tb, _ = pair
    ta, ja = lt.plot_tree(tb, tree_index=1), lj.plot_tree(jb, tree_index=1)
    assert len(ta.images) == len(ja.images) == 1
    assert not ta.axison


def test_missing_graphviz_raises_the_reference_error(pair, monkeypatch):
    _, tb, _ = pair
    monkeypatch.setitem(sys.modules, "graphviz", None)
    with pytest.raises(ImportError, match="install graphviz"):
        lt.create_tree_digraph(tb)
