"""GOSS, DART and RF of the port held against the JAX package's, on the
CPU.

Both packages train the same numpy rows for 10 iterations through
``train`` (the JAX package's ``create_boosting``: its fused step, Pallas
in interpret mode; the port's eager step, the kernels' plain versions).
GOSS samples from ``fold_in(PRNGKey(seed + 17), iteration)`` through the
port's threefry stream, DART draws its drops from the same
``RandomState(drop_seed)`` sequence, RF averages unshrunk bagged trees,
so the same seeds grow the same trees.

Tolerances: every split identical; raw predictions within 2e-5 (the
port's training tolerance, ``test_torch_train.test_f32_trees_identical``:
the histograms sum in another f32 order, about 1e-4 of the largest leaf
of a shrunk model), and for RF's unshrunk trees (leaves near 2, ten
times a shrunk model's) within the same 1e-4 of its largest leaf; the
valid metric within 1e-6;
GOSS's g3 rows bit for bit; DART's drop lists equal; DART's training
scores within 1e-6 of a fresh float64 walk of its saved trees.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightgbmv1_tpu as lj
from lightgbmv1_tpu.config import Config as JConfig
from lightgbmv1_tpu.models import gbdt as jgbdt

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.models import gbdt as tgbdt
from lightgbmv1_tpu_torch.models.convert import tree_arrays_from_numpy
from lightgbmv1_tpu_torch.utils.log import LightGBMError

N, NV, ITERS = 2048, 512, 10
BASE = {"objective": "binary", "verbosity": -1, "max_bin": 63,
        "num_leaves": 15, "min_data_in_leaf": 5, "hist_dtype": "f32",
        "metric": "binary_logloss"}
CASES = {
    "goss": {"boosting": "goss"},
    "dart": {"boosting": "dart"},
    "dart-rate0.6": {"boosting": "dart", "drop_rate": 0.6},
    "dart-xgboost": {"boosting": "dart", "xgboost_dart_mode": True,
                     "drop_rate": 0.3},
    "dart-uniform": {"boosting": "dart", "uniform_drop": True,
                     "drop_rate": 0.3},
    "dart-max2": {"boosting": "dart", "max_drop": 2, "drop_rate": 0.6},
    "dart-skip0.5": {"boosting": "dart", "skip_drop": 0.5,
                     "drop_rate": 0.4},
    "rf": {"boosting": "rf", "bagging_fraction": 0.6, "bagging_freq": 1},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op pool, and
    beside other pytest workers its spinning threads starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed, n):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[rng.rand(n) < 0.05, 0] = np.nan
    X[:, 3] = np.round(X[:, 3] * 2)
    y = (np.nan_to_num(X[:, 0]) - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
         + rng.randn(n) > 0).astype(np.float64)
    return X, y


@contextlib.contextmanager
def _recording_drops(cls, out):
    """Record each ``_select_drops`` result of ``cls``'s trainers."""
    orig = cls._select_drops

    def spy(self):
        drops = orig(self)
        out.append(list(drops))
        return drops

    cls._select_drops = spy
    try:
        yield
    finally:
        cls._select_drops = orig


_RUNS = {}


def _run(case):
    """Both packages trained on ``CASES[case]``, once a module."""
    if case not in _RUNS:
        params = dict(BASE, **CASES[case])
        X, y = _data(10, N)
        Xv, yv = _data(11, NV)
        jev, tev, jdrops, tdrops = {}, {}, [], []
        with _recording_drops(jgbdt.DART, jdrops):
            jb = lj.train(params, lj.Dataset(X, label=y), ITERS,
                          valid_sets=[lj.Dataset(Xv, label=yv)],
                          evals_result=jev, verbose_eval=False)
        with _recording_drops(tgbdt.DART, tdrops):
            tb = lt.train(params, lt.Dataset(X, label=y), ITERS,
                          valid_sets=[lt.Dataset(Xv, label=yv)],
                          evals_result=tev, device="cpu")
        _RUNS[case] = dict(jb=jb, tb=tb, jev=jev, tev=tev, X=X, Xv=Xv,
                           jdrops=jdrops, tdrops=tdrops)
    return _RUNS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_trees_identical(case):
    run = _run(case)
    jtrees = jax.device_get(run["jb"]._gbdt._device_trees)
    ttrees = run["tb"]._gbdt._device_trees
    assert len(jtrees) == len(ttrees) == ITERS
    assert type(run["tb"]._gbdt).__name__ == type(run["jb"]._gbdt).__name__
    for jt, tt in zip(jtrees, ttrees):
        carried = tree_arrays_from_numpy(jt._asdict())
        n = int(carried.num_leaves)
        assert n == int(tt.num_leaves) > 1
        for f in ("split_feature", "threshold_bin", "default_left",
                  "left_child", "right_child"):
            assert torch.equal(getattr(carried, f)[:n - 1],
                               getattr(tt, f)[:n - 1]), f
        assert torch.equal(carried.leaf_count[:n], tt.leaf_count[:n])


@pytest.mark.parametrize("case", list(CASES))
def test_predictions_and_metrics_match(case):
    run = _run(case)
    tol = 2e-5
    if case == "rf":
        tol = 1e-4 * max(float(np.abs(t.leaf_value).max())
                         for t in run["tb"]._all_trees())
    for raw in (True, False):
        np.testing.assert_allclose(
            run["tb"].predict(run["Xv"], raw_score=raw),
            run["jb"].predict(run["Xv"], raw_score=raw), rtol=0, atol=tol)
    want = run["jev"]["valid_0"]["binary_logloss"]
    got = run["tev"]["valid_0"]["binary_logloss"]
    assert len(got) == len(want) == ITERS
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for (jn, jm, jv, jh), (tn, tm, tv, th) in zip(
            run["jb"].eval_valid(), run["tb"].eval_valid()):
        assert (jn, jm, jh) == (tn, tm, th)
        assert abs(jv - tv) <= 1e-6


@pytest.mark.parametrize("case", list(CASES))
def test_model_text_keys(case):
    """The same lines, key for key (the values differ in the last
    digits); RF's text says ``average_output`` and loads as an averaging
    model in either package."""
    run = _run(case)
    jtext, ttext = run["jb"].model_to_string(), run["tb"].model_to_string()

    def keys(text):
        return [ln.split("=")[0] for ln in text.splitlines()]

    assert keys(ttext) == keys(jtext)
    rf = case == "rf"
    assert ("average_output" in ttext.splitlines()) == rf
    loaded = lt.Booster(model_str=ttext, device="cpu")
    assert loaded._average_output() == rf
    np.testing.assert_allclose(
        loaded.predict(run["Xv"], raw_score=True),
        lj.Booster(model_str=ttext).predict(run["Xv"], raw_score=True),
        rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", [c for c in CASES if c.startswith("dart")])
def test_dart_drops_and_scores(case):
    """Every iteration's drop list is the JAX package's, and the cached
    training scores are a fresh walk of the saved trees (JAX
    ``test_dart_predict_matches_scores``, tighter)."""
    run = _run(case)
    assert run["tdrops"] == run["jdrops"]
    assert len(run["tdrops"]) == ITERS
    assert any(run["tdrops"]), "no iteration dropped a tree"
    tb = run["tb"]
    raw = tb.predict(run["X"], raw_score=True)
    np.testing.assert_allclose(raw, tb._gbdt.raw_train_scores()[:, 0],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb._gbdt._tree_weight,
                               run["jb"]._gbdt._tree_weight, rtol=1e-12)


def test_rf_predict_and_refusals():
    """RF's averaged predictions are the JAX package's, its training
    scores the running sum; without bagging, or with init scores, it
    refuses as the JAX package does."""
    run = _run("rf")
    tb = run["tb"]
    gb = tb._gbdt
    assert isinstance(gb, tgbdt.RF) and gb._model_shrink == [1.0] * ITERS
    assert tb._average_output()
    # the cached sum, averaged, is the prediction of the training rows
    avg = gb._raw_pred(gb._train_scores)
    np.testing.assert_allclose(tb.predict(run["X"], raw_score=True), avg,
                               rtol=0, atol=1e-6)
    X, y = _data(12, 256)
    for extra, kw in (({"bagging_freq": 0}, {}),
                      ({"bagging_fraction": 1.0}, {}),
                      ({}, {"init_score": np.zeros(256)})):
        params = {**BASE, **CASES["rf"], **extra}
        with pytest.raises(LightGBMError, match="RF mode"):
            lt.train(params, lt.Dataset(X, label=y, **kw), 1, device="cpu")


_G3_CASES = {"random": (0, None), "ties": (3, None), "bagged": (7, 0.7)}


@pytest.mark.parametrize("case", list(_G3_CASES))
def test_goss_g3_bit_for_bit(case):
    """``GOSS._sample_g3`` on the same f32 gradients: the JAX rows bit for
    bit, at iteration 0 / 3 / 7; ``ties`` puts a run of equal |g h|
    across the top_k threshold (all are kept), ``bagged`` multiplies a
    bag in last."""
    iteration, bag_frac = _G3_CASES[case]
    n = 1000
    rng = np.random.RandomState(iteration)
    g = rng.randn(n).astype(np.float32)
    h = (rng.rand(n) + 0.1).astype(np.float32)
    if case == "ties":
        g[:300] = 0.5
        h[:300] = 1.0
        g[300:] *= 0.1
    params = {"boosting": "goss", "top_rate": 0.2, "other_rate": 0.15,
              "seed": 5}
    bag = (None if bag_frac is None else
           (rng.rand(n) < bag_frac).astype(np.float32))
    jself = types.SimpleNamespace(config=JConfig.from_dict(params),
                                  num_data=n)
    tself = types.SimpleNamespace(config=Config.from_dict(params),
                                  num_data=n, _shard=None)
    for name in ("_global_rows", "_rows"):
        setattr(tself, name, types.MethodType(getattr(tgbdt.GBDT, name),
                                              tself))
    want = np.asarray(jgbdt.GOSS._sample_g3(
        jself, jnp.asarray(g), jnp.asarray(h),
        None if bag is None else jnp.asarray(bag), iteration))
    got = tgbdt.GOSS._sample_g3(
        tself, torch.from_numpy(g), torch.from_numpy(h),
        None if bag is None else torch.from_numpy(bag), iteration).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    kept = int((got[:, 2] > 0).sum())
    if case == "ties":
        assert (got[:300, 2] == 1).all() and kept > 300 > 0.2 * n


def test_dart_leaf_id_budget_and_tree_walks():
    """Past the leaf-id budget DART removes its drops by walking the
    trees on the bins; the leaf ids are the same, so the model text is
    the one of the recorded-id path.  The sequential grower (no valid
    routing) walks its valid rows and trains the JAX package's trees."""
    X, y = _data(13, 1024)
    Xv, yv = _data(14, 256)
    params = dict(BASE, **CASES["dart-rate0.6"])

    def fit(p):
        return lt.train(p, lt.Dataset(X, label=y), 6,
                        valid_sets=[lt.Dataset(Xv, label=yv)], device="cpu")

    kept = fit(params)
    assert len(kept._gbdt._train_lids) == 6
    assert kept._gbdt._valid_lids[0] is not None
    saved = tgbdt.DART.LID_BUDGET_BYTES
    tgbdt.DART.LID_BUDGET_BYTES = 1
    try:
        walked = fit(params)
    finally:
        tgbdt.DART.LID_BUDGET_BYTES = saved
    assert walked._gbdt._train_lids == [] and not walked._gbdt._keep_lids
    assert walked.model_to_string() == kept.model_to_string()
    seq = dict(params, num_leaves=6)
    tb = fit(seq)
    assert tb._gbdt._valid_lids[0] is None
    jb = lj.train(seq, lj.Dataset(X, label=y), 6,
                  valid_sets=[lj.Dataset(Xv, label=yv)], verbose_eval=False)
    for a, b in zip(jb._gbdt.materialize_host_trees(), tb._all_trees()):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold_bin, b.threshold_bin)
    np.testing.assert_allclose(tb.predict(Xv), jb.predict(Xv), atol=2e-5)


def test_dart_rescales_materialized_trees():
    """A host tree materialized mid-training (a callback writing the model
    text each iteration) is rescaled with the device tree when it is
    dropped: the final predictions are the lazily materialized run's."""
    X, y = _data(15, 1024)
    params = dict(BASE, **CASES["dart-rate0.6"])
    lazy = lt.train(params, lt.Dataset(X, label=y), 8, device="cpu")
    eager = lt.train(params, lt.Dataset(X, label=y), 8, device="cpu",
                     callbacks=[lambda env: env.model.model_to_string()])
    assert all(m is not None for m in eager._gbdt.models[:-1])
    np.testing.assert_allclose(eager.predict(X, raw_score=True),
                               lazy.predict(X, raw_score=True), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(eager.predict(X, raw_score=True),
                               eager._gbdt.raw_train_scores()[:, 0],
                               rtol=0, atol=1e-6)


def test_create_boosting_kinds_and_refusals():
    X, y = _data(16, 256)
    ds = lt.Dataset(X, label=y)
    ds.construct()
    for kind, cls in (("gbdt", tgbdt.GBDT), ("gbrt", tgbdt.GBDT),
                      ("goss", tgbdt.GOSS), ("dart", tgbdt.DART),
                      ("random_forest", tgbdt.RF)):
        cfg = Config.from_dict(dict(BASE, boosting=kind, bagging_freq=1,
                                    bagging_fraction=0.5))
        assert type(tgbdt.create_boosting(cfg, ds._binned, "cpu")) is cls
    with pytest.raises(LightGBMError, match="Unknown boosting"):
        tgbdt.create_boosting(Config.from_dict({"boosting": "nope"}),
                              ds._binned, "cpu")
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1, parallel learners$"):
        tgbdt.create_boosting(Config.from_dict({"elastic_max_restarts": 5}),
                              ds._binned, "cpu")
