"""The port's ``Booster``, ``Dataset`` and package surface against the
JAX package's, on the CPU.

Part 1.1 of the breadth item: ``feature_importance`` (split counts
exact, gains within 1e-4 relative: a gain is a float32 of the split scan,
whose histograms sum in another order), ``feature_name``, the
``dump_model`` dict (the same keys and structure, values within 5e-4 of
max(1, |value|): a larger child's sums are its parent's minus the
smaller's in float32, which moves them by up to about 3.4e-4, ROADMAP
queue 3), ``create_valid``, the ``Dataset`` setters on a
constructed set, ``set_verbosity`` and ``register_callback``.

The guard: every public name of the JAX ``Booster``, ``Dataset`` and the
package's ``__all__`` exists in the port, and calling it either works or
raises ``NotImplementedError`` naming ``ROADMAP queue 1, <title>`` of
the item that will port it — never ``AttributeError``.
"""

import os
import re
import tempfile

import numpy as np
import pytest
import torch

import lightgbmv1_tpu as lj
from lightgbmv1_tpu import basic as jbasic

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch import config as tconfig

PARAMS = {"objective": "binary", "verbosity": -1, "max_bin": 31,
          "num_leaves": 7, "min_data_in_leaf": 10, "hist_dtype": "f32"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed=0, n=1024):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    y = (X[:, 0] - X[:, 2] + 0.7 * rng.randn(n) > 0).astype(np.float64)
    return X, y


@pytest.fixture(scope="module")
def pair():
    X, y = _data()
    names = [f"f{i}" for i in range(5)]
    jb = lj.train(PARAMS, lj.Dataset(X, label=y, feature_name=names), 4,
                  verbose_eval=False)
    tb = lt.train(PARAMS, lt.Dataset(X, label=y, feature_name=names), 4,
                  device="cpu")
    return jb, tb, X, y


def test_feature_importance_and_names(pair):
    jb, tb, _, _ = pair
    assert tb.feature_name() == jb.feature_name() == [f"f{i}"
                                                      for i in range(5)]
    for it in (None, 2, -1):
        split = tb.feature_importance("split", iteration=it)
        assert split.dtype == np.int64
        np.testing.assert_array_equal(
            split, jb.feature_importance("split", iteration=it))
        gain = tb.feature_importance("gain", iteration=it)
        assert gain.dtype == np.float64 and gain.sum() > 0
        np.testing.assert_allclose(
            gain, jb.feature_importance("gain", iteration=it), rtol=1e-4)
    loaded = lt.Booster(model_str=tb.model_to_string(), device="cpu")
    np.testing.assert_array_equal(loaded.feature_importance(),
                                  tb.feature_importance())
    assert loaded.feature_name() == tb.feature_name()


def _same_tree_dict(got, want, path="tree"):
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _same_tree_dict(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree_dict(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= 5e-4 * max(1.0, abs(want)), path
    else:
        assert got == want, path


def test_dump_model_dict(pair):
    jb, tb, _, _ = pair
    for kw in ({}, {"num_iteration": 2}, {"start_iteration": 1}):
        _same_tree_dict(tb.dump_model(**kw), jb.dump_model(**kw))
    text = tb.model_to_string()
    _same_tree_dict(lt.Booster(model_str=text, device="cpu").dump_model(),
                    lj.Booster(model_str=text).dump_model())


def test_create_valid_and_setters():
    """``create_valid`` bins with the training set's bins; the setters
    reach a constructed set without binning it again, and the trainer
    reads the new fields: the models are the JAX package's."""
    X, y = _data(1)
    Xv, yv = _data(2, 300)
    rng = np.random.RandomState(3)
    w, init = rng.rand(len(y)) + 0.5, rng.randn(len(y)) * 0.2
    out = []
    for pkg, kw in ((lj, {}), (lt, {"device": "cpu"})):
        ds = pkg.Dataset(X, label=np.zeros(len(y)), params=dict(PARAMS))
        ds.construct()
        binned = ds._binned
        ds.set_label(y).set_weight(w).set_field("init_score", init)
        ds.set_field("label", y)
        assert ds._binned is binned
        assert np.array_equal(ds.get_label(), y)
        assert np.array_equal(ds.get_field("weight"), w)
        dv = ds.create_valid(Xv, label=yv)
        assert dv.reference is ds and dv.params == ds.params
        ev = {}
        b = pkg.train(PARAMS, ds, 3, valid_sets=[dv], evals_result=ev, **kw)
        out.append((b, ev["valid_0"]["binary_logloss"]))
        ds.set_weight(None).set_init_score(None)
        assert ds._binned.metadata.weight is None
        assert ds._binned.metadata.init_score is None
    (jb, jloss), (tb, tloss) = out
    np.testing.assert_allclose(tloss, jloss, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb.predict(Xv, raw_score=True),
                               jb.predict(Xv, raw_score=True), atol=2e-5)


def test_set_verbosity_and_register_callback():
    """Each emitted line goes to the registered callback in place of
    stderr, at the level ``set_verbosity`` lets through; the JAX
    package's lines for the same training are the same."""
    X, y = _data(4, 512)
    params = dict(PARAMS, verbosity=1, boosting="goss")
    seen = {}
    for name, pkg, kw in (("jax", lj, {}), ("port", lt, {"device": "cpu"})):
        lines = []
        pkg.register_callback(lines.append)
        try:
            pkg.train(params, pkg.Dataset(X, label=np.zeros(len(y))), 1,
                      **kw)
            pkg.set_verbosity(-1)
            from importlib import import_module
            import_module(f"{pkg.__name__}.utils.log").log_warning("quiet")
        finally:
            pkg.register_callback(None)
            pkg.set_verbosity(1)
        seen[name] = lines
    stop = [ln for ln in seen["port"] if "no more leaves" in ln]
    assert stop and all(ln.startswith("[LightGBM-TPU] [Warning]")
                        for ln in stop)
    assert not any("quiet" in ln for ln in seen["port"])
    assert [ln for ln in seen["jax"] if "no more leaves" in ln] == stop


# ---------------------------------------------------------------------------
# the guard: no public name of the JAX package raises AttributeError
# ---------------------------------------------------------------------------


def _trained():
    X, y = _data(5, 256)
    ds = lt.Dataset(X, label=y, params=dict(PARAMS))
    return lt.train(PARAMS, ds, 2, device="cpu"), ds, X


def _checkpoint(b):
    """``b``'s checkpoint in a fresh temporary directory."""
    path = os.path.join(tempfile.mkdtemp(), "state.ckpt")
    b.save_checkpoint(path)
    return path


_BOOSTER_CALLS = {
    "add_valid": lambda b, ds, X: lt.Booster(
        PARAMS, train_set=ds, device="cpu").add_valid(ds.create_valid(X),
                                                      "v"),
    "capture_model_reference": lambda b, ds, X: b.capture_model_reference(),
    "current_iteration": lambda b, ds, X: b.current_iteration(),
    "dump_model": lambda b, ds, X: b.dump_model(),
    "eval_train": lambda b, ds, X: b.eval_train(),
    "eval_valid": lambda b, ds, X: b.eval_valid(),
    "feature_importance": lambda b, ds, X: b.feature_importance("gain"),
    "feature_name": lambda b, ds, X: b.feature_name(),
    "free_dataset": lambda b, ds, X: b.free_dataset(),
    "free_network": lambda b, ds, X: b.free_network(),
    "model_to_string": lambda b, ds, X: b.model_to_string(),
    "num_feature": lambda b, ds, X: b.num_feature(),
    "num_model_per_iteration": lambda b, ds, X: b.num_model_per_iteration(),
    "num_trees": lambda b, ds, X: b.num_trees(),
    "predict": lambda b, ds, X: b.predict(X),
    "quality_snapshot": lambda b, ds, X: b.quality_snapshot(),
    "refit": lambda b, ds, X: b.refit(X, ds.get_label()),
    "reset_parameter": lambda b, ds, X: b.reset_parameter(
        {"learning_rate": 0.05}),
    "resume_from_checkpoint": lambda b, ds, X: lt.Booster(
        PARAMS, train_set=ds, device="cpu").resume_from_checkpoint(
            _checkpoint(b)),
    "rollback_one_iter": lambda b, ds, X: b.rollback_one_iter(),
    "save_checkpoint": lambda b, ds, X: _checkpoint(b),
    "save_model": lambda b, ds, X: b.model_to_string(),   # no file here
    "update": lambda b, ds, X: b.update(),
}

_DATASET_CALLS = {
    "construct": lambda ds, X: ds.construct(),
    "create_valid": lambda ds, X: ds.create_valid(X),
    "from_binned": lambda ds, X: _from_binned(ds),
    "get_field": lambda ds, X: ds.get_field("label"),
    "get_group": lambda ds, X: ds.get_group(),
    "get_init_score": lambda ds, X: ds.get_init_score(),
    "get_label": lambda ds, X: ds.get_label(),
    "get_weight": lambda ds, X: ds.get_weight(),
    "num_data": lambda ds, X: ds.num_data(),
    "num_feature": lambda ds, X: ds.num_feature(),
    "save_binary": lambda ds, X: _binary_round_trip(ds),
    "save_block_cache": lambda ds, X: _block_cache_round_trip(ds),
    "set_field": lambda ds, X: ds.set_field("weight", None),
    "set_group": lambda ds, X: ds.set_group(None),
    "set_init_score": lambda ds, X: ds.set_init_score(None),
    "set_label": lambda ds, X: ds.set_label(ds.get_label()),
    "set_weight": lambda ds, X: ds.set_weight(None),
    "subset": lambda ds, X: ds.subset(np.arange(10)),
}


def _block_cache_round_trip(ds):
    """``ds``'s block cache in a fresh temporary directory, opened back
    as a streaming dataset."""
    path = os.path.join(tempfile.mkdtemp(), "blocks")
    ds.save_block_cache(path, block_rows=64)
    sds = lt.Dataset(path).construct()
    assert sds._binned.is_streaming
    assert sds.num_data() == ds.num_data()


def _binary_round_trip(ds):
    """``ds``'s binned cache in a fresh temporary directory, loaded
    back."""
    path = os.path.join(tempfile.mkdtemp(), "train.bin")
    ds.save_binary(path)
    back = lt.Dataset(path).construct()
    np.testing.assert_array_equal(back._binned.binned, ds._binned.binned)


class _Digraph:
    """A stand-in for graphviz.Digraph (installed on neither machine)."""

    def __init__(self, **kwargs):
        self.nodes = []

    def attr(self, **kwargs):
        pass

    def node(self, name, **kwargs):
        self.nodes.append(name)

    def edge(self, tail, head, label=None):
        pass

    def pipe(self, format="png"):
        import io

        import matplotlib.pyplot as plt

        buf = io.BytesIO()
        plt.imsave(buf, np.zeros((4, 4, 3)), format=format)
        return buf.getvalue()


def _with_graphviz(call):
    """``call()`` with the stand-in importable as ``graphviz``."""
    import sys
    import types

    import matplotlib

    matplotlib.use("Agg")
    mod = types.ModuleType("graphviz")
    mod.Digraph = _Digraph
    saved = sys.modules.get("graphviz")
    sys.modules["graphviz"] = mod
    try:
        return call()
    finally:
        if saved is None:
            del sys.modules["graphviz"]
        else:
            sys.modules["graphviz"] = saved


def _plotted(call):
    """``call()`` under matplotlib's Agg backend, its figures closed."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    try:
        return call()
    finally:
        plt.close("all")


_EST = dict(num_leaves=7, n_estimators=2, device_type="cpu")

_TOP_CALLS = {
    "Config": lambda: lt.Config.from_dict({"eta": 0.2}),
    "LightGBMError": lambda: lt.LightGBMError("x"),
    "register_callback": lambda: lt.register_callback(None),
    "set_verbosity": lambda: lt.set_verbosity(1),
    "Dataset": lambda: lt.Dataset(np.zeros((4, 2))),
    "Booster": lambda: lt.Booster(model_str=_trained()[0].model_to_string(),
                                  device="cpu"),
    "train": lambda: _trained(),
    "cv": lambda: lt.cv(PARAMS, lt.Dataset(*_data(6, 300)), 1, nfold=2,
                        device="cpu"),
    "CVBooster": lambda: lt.CVBooster(),
    "early_stopping": lambda: lt.early_stopping(3),
    "log_evaluation": lambda: lt.log_evaluation(),
    "record_evaluation": lambda: lt.record_evaluation({}),
    "reset_parameter": lambda: lt.reset_parameter(learning_rate=[0.1]),
    "LGBMModel": lambda: lt.LGBMModel(**_EST).fit(*_data(8, 256)),
    "LGBMRegressor": lambda: lt.LGBMRegressor(**_EST).fit(*_data(8, 256)),
    "LGBMClassifier": lambda: lt.LGBMClassifier(**_EST).fit(
        *_data(8, 256)).predict_proba(_data(8, 256)[0]),
    "LGBMRanker": lambda: lt.LGBMRanker(**_EST).fit(
        *_data(8, 256), group=[64] * 4),
    "plot_importance": lambda: _plotted(
        lambda: lt.plot_importance(_trained()[0])),
    "plot_metric": lambda: _plotted(
        lambda: lt.plot_metric({"v": {"auc": [0.6, 0.7]}})),
    "plot_split_value_histogram": lambda: _plotted(
        lambda: lt.plot_split_value_histogram(_trained()[0], 0)),
    "plot_tree": lambda: _plotted(lambda: _with_graphviz(
        lambda: lt.plot_tree(_trained()[0]))),
    "create_tree_digraph": lambda: _with_graphviz(
        lambda: lt.create_tree_digraph(_trained()[0])),
}

def _from_binned(ds):
    """A Dataset over the binned set trains the model of the set itself;
    its data-parallel training at the two-level mesh (``num_hosts``)
    raises item 14.2b's title."""
    p = dict(PARAMS, verbosity=-1)
    a = lt.train(p, lt.Dataset.from_binned(ds._binned), 2, device="cpu")
    assert a.model_to_string() == lt.train(p, ds, 2, device="cpu") \
        .model_to_string()
    lt.train(dict(p, tree_learner="data", num_hosts=2),
             lt.Dataset.from_binned(ds._binned), 1, device="cpu")


# the names that refuse, by the title of their ROADMAP queue 1 item
_REFUSING = {
    "from_binned": tconfig.PARALLEL_LEGS,
}


def _public(cls):
    return sorted(n for n in dir(cls) if not n.startswith("_"))


def test_guard_tables_cover_the_jax_surface():
    """Every public name of the JAX ``Booster``, ``Dataset`` and
    ``__all__`` has a call below, so a name the JAX package adds fails
    here until the port has it."""
    assert sorted(_BOOSTER_CALLS) == _public(jbasic.Booster)
    assert sorted(_DATASET_CALLS) == _public(jbasic.Dataset)
    assert sorted(_TOP_CALLS) == sorted(lj.__all__)
    assert set(lj.__all__) <= set(lt.__all__)


def _works_or_refuses(name, call):
    title = _REFUSING.get(name)
    if title is None:
        call()
        return
    with pytest.raises(NotImplementedError,
                       match=re.escape(f"ROADMAP queue 1, {title}") + "$"):
        call()


@pytest.mark.parametrize("name", _public(jbasic.Booster))
def test_booster_names_work_or_refuse(name):
    b, ds, X = _trained()
    assert hasattr(lt.Booster, name)
    _works_or_refuses(name, lambda: _BOOSTER_CALLS[name](b, ds, X))


@pytest.mark.parametrize("name", _public(jbasic.Dataset))
def test_dataset_names_work_or_refuse(name):
    X, y = _data(7, 128)
    ds = lt.Dataset(X, label=y, params=dict(PARAMS)).construct()
    assert hasattr(lt.Dataset, name)
    _works_or_refuses(name, lambda: _DATASET_CALLS[name](ds, X))


@pytest.mark.parametrize("name", lj.__all__)
def test_package_names_work_or_refuse(name):
    assert hasattr(lt, name)
    _works_or_refuses(name, _TOP_CALLS[name])
