"""Callbacks, early stopping and ``cv`` of the port against the JAX
package, on the CPU.

The port's ``callback.py`` is its own copy of the JAX module, and
``engine.train`` runs the same protocol (before-iteration callbacks by
order, the update, the evaluation, the after-iteration callbacks, an
``EarlyStopException`` setting ``best_iteration`` / ``best_score``); the
trees the two packages grow agree within the port's training tolerance,
so their metrics, and the iterations early stopping keeps, agree too.

Tolerances: recorded metrics within 1e-6 (the models' leaves within 2e-5
of each other); best iterations equal; ``cv`` folds row for row, means
and standard deviations within 1e-6.

The JAX package's jitted step keeps the learning rate it was first built
with (a ``reset_parameter`` schedule reaches only its model text's
``shrinkage`` lines); the port shrinks each tree by the rate of its
iteration, as the reference does.  The schedule test holds the port to
the JAX package with its step rebuilt before each iteration.
"""

import numpy as np
import pytest
import torch

import jax
import lightgbmv1_tpu as lj
from lightgbmv1_tpu import callback as jcb
from lightgbmv1_tpu import engine as jengine

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch import callback as tcb
from lightgbmv1_tpu_torch import engine as tengine
from lightgbmv1_tpu_torch.models.convert import tree_arrays_from_numpy

BASE = {"objective": "binary", "verbosity": -1, "num_leaves": 7,
        "max_bin": 31, "min_data_in_leaf": 10, "hist_dtype": "f32",
        "learning_rate": 0.3, "metric": ["binary_logloss", "auc"]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op pool, and
    beside other pytest workers its spinning threads starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n=1500, seed=0):
    """A noisy binary problem that a fast learner overfits within tens of
    iterations, its valid rows apart."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    y = (X[:, 0] - 0.5 * X[:, 1] + 1.5 * rng.randn(n) > 0).astype(float)
    return X[:1000], y[:1000], X[1000:], y[1000:]


def _both(params, rounds, **kw):
    """The port's and the JAX package's ``train`` on one problem with one
    valid set (``kw`` given to both; a callable value is called with the
    package's callback module)."""
    X, y, Xv, yv = _problem()
    out = []
    for pkg, cb in ((lt, tcb), (lj, jcb)):
        ds = pkg.Dataset(X, label=y)
        extra = {k: (v(cb) if callable(v) else v) for k, v in kw.items()}
        if pkg is lt:
            extra["device"] = "cpu"
        else:
            extra.setdefault("verbose_eval", False)
        out.append(pkg.train(dict(params), ds, rounds,
                             valid_sets=[pkg.Dataset(Xv, label=yv,
                                                     reference=ds)],
                             **extra))
    return out


@pytest.mark.parametrize("first_only", [False, True])
def test_early_stopping_matches_jax(first_only):
    """``early_stopping_rounds`` (through an alias in params, too) with
    two metrics, stopping on any or on the first alone: the port stops at
    the JAX package's iteration with its ``best_iteration`` and
    ``best_score``, and records its metrics within 1e-6."""
    params = dict(BASE, first_metric_only=first_only, n_iter_no_change=3)
    evs = ({}, {})
    tb, jb = _both(params, 60, evals_result=lambda cb: evs[
        0 if cb is tcb else 1])
    assert jb.best_iteration > 0
    assert tb.best_iteration == jb.best_iteration
    assert tb.current_iteration() == jb.current_iteration() < 60
    for m in ("binary_logloss", "auc"):
        np.testing.assert_allclose(tb.best_score["valid_0"][m],
                                   jb.best_score["valid_0"][m], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(evs[0]["valid_0"][m], evs[1]["valid_0"][m],
                                   rtol=0, atol=1e-6)


def test_best_iteration_is_the_default():
    """After early stopping ``predict``, ``model_to_string`` and
    ``save_model`` default to ``best_iteration``; an explicit
    ``num_iteration`` still reaches every tree; without stopping every
    iteration is the default."""
    X, y, Xv, yv = _problem()
    ds = lt.Dataset(X, label=y)
    b = lt.train(BASE, ds, 60, valid_sets=[lt.Dataset(Xv, label=yv)],
                 early_stopping_rounds=3, device="cpu")
    best, ran = b.best_iteration, b.current_iteration()
    assert 0 < best < ran
    np.testing.assert_array_equal(b.predict(Xv), b.predict(
        Xv, num_iteration=best))
    assert not np.array_equal(b.predict(Xv), b.predict(Xv,
                                                       num_iteration=ran))
    assert b.model_to_string() == b.model_to_string(num_iteration=best)
    assert b.model_to_string().count("Tree=") == best
    assert b.model_to_string(num_iteration=ran).count("Tree=") == ran
    plain = lt.train(BASE, ds, 4, device="cpu")
    assert plain.best_iteration == -1
    assert plain.model_to_string().count("Tree=") == 4
    lean = lt.train(BASE, ds, 60, valid_sets=[lt.Dataset(Xv, label=yv)],
                    early_stopping_rounds=3, keep_training_booster=False,
                    device="cpu")
    assert lean._gbdt is None and lean.best_iteration == best
    np.testing.assert_allclose(lean.predict(Xv), b.predict(Xv), rtol=0,
                               atol=1e-12)


def _rebuild_step(cb):
    """A before-iteration callback after ``reset_parameter`` that drops
    the JAX package's jitted step, so the next iteration builds it at the
    new rate."""
    def _callback(env):
        env.model._gbdt._step = None

    _callback.before_iteration = True
    _callback.order = 11
    return _callback


def _schedule(i):
    return 0.3 * 0.8 ** i


def test_reset_parameter_schedule_matches_jax():
    """A ``reset_parameter`` learning-rate schedule trains the JAX
    package's trees (its step rebuilt at each rate): every split
    identical, leaves within 2e-5; the trees differ from a constant
    rate's; each tree's rate is the schedule's."""
    tb, jb = _both(BASE, 6, callbacks=lambda cb: (
        [cb.reset_parameter(learning_rate=_schedule)]
        + ([_rebuild_step(cb)] if cb is jcb else [])))
    jtrees = jax.device_get(jb._gbdt._device_trees)
    for jt, tt in zip(jtrees, tb._gbdt._device_trees):
        c = tree_arrays_from_numpy(jt._asdict())
        n = int(c.num_leaves)
        assert n == int(tt.num_leaves)
        for f in ("split_feature", "threshold_bin", "left_child"):
            assert torch.equal(getattr(c, f)[:n - 1], getattr(tt, f)[:n - 1])
        np.testing.assert_allclose(tt.leaf_value[:n].numpy(),
                                   c.leaf_value[:n].numpy(), rtol=0,
                                   atol=2e-5)
    assert tb._gbdt._model_shrink == [_schedule(i) for i in range(6)]
    assert tb.params["learning_rate"] == _schedule(5)
    X, y, _, _ = _problem()
    const = lt.train(BASE, lt.Dataset(X, label=y), 6, device="cpu")
    assert const.model_to_string() != tb.model_to_string()


def test_reset_parameter_other_knob_reaches_the_next_tree():
    """A knob other than the rate (``lambda_l2``, ``num_leaves``) changed
    mid-training rebuilds the grower: the next tree trains under it, as a
    training started with it would grow that tree; a knob the port does
    not train raises."""
    X, y, _, _ = _problem()
    b = lt.Booster(dict(BASE), lt.Dataset(X, label=y), device="cpu")
    b.update()
    b.reset_parameter({"num_leaves": 3, "lambda_l2": 5.0})
    b.update()
    trees = b._all_trees()
    assert trees[0].num_leaves == 7 and trees[1].num_leaves == 3
    assert b._gbdt.split_params.lambda_l2 == 5.0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        b.reset_parameter({"boosting": "dart"})


def test_feval_and_training_set_evaluation_match_jax():
    """``feval`` (one and a list, a tuple and a list of tuples returned)
    adds its metrics to every evaluation, and the training set among the
    valid sets is evaluated under its given name, as in the JAX
    package."""
    X, y, Xv, yv = _problem()

    def mean_pred(preds, data):
        return "mean_pred", float(np.mean(preds)), False

    def two(preds, data):
        # the port hands feval the Dataset (as the reference does), the
        # JAX package a valid set's binned dataset
        lab = (data.get_label() if hasattr(data, "get_label")
               else data.metadata.label)
        return [("err", float(np.mean((preds > 0) != (lab > 0))), False),
                ("n", float(len(lab)), True)]

    evs = []
    for pkg in (lt, lj):
        ds = pkg.Dataset(X, label=y)
        dv = pkg.Dataset(Xv, label=yv, reference=ds)
        ev = {}
        kw = {"device": "cpu"} if pkg is lt else {"verbose_eval": False}
        pkg.train(BASE, ds, 5, valid_sets=[ds, dv],
                  valid_names=["train", "held"], feval=[mean_pred, two],
                  evals_result=ev, **kw)
        evs.append(ev)
    assert sorted(evs[0]) == sorted(evs[1]) == ["held", "train"]
    for d in ("train", "held"):
        assert list(evs[0][d]) == list(evs[1][d])
        for m in evs[1][d]:
            # the raw scores' mean moves with the leaves (2e-5 a tree)
            tol = 2e-5 * 5 if m == "mean_pred" else 1e-6
            np.testing.assert_allclose(evs[0][d][m], evs[1][d][m], rtol=0,
                                       atol=tol)


def test_log_evaluation_and_record_evaluation(capsys):
    """``log_evaluation`` logs every ``period`` iterations;
    ``record_evaluation`` fills an empty dict with every iteration's
    metrics and refuses anything but a dict."""
    X, y, Xv, yv = _problem()
    ev = {}
    lt.train(dict(BASE, verbosity=1), lt.Dataset(X, label=y), 4,
             valid_sets=[lt.Dataset(Xv, label=yv)],
             callbacks=[tcb.log_evaluation(2), tcb.record_evaluation(ev)],
             device="cpu")
    assert list(ev) == ["valid_0"] and len(ev["valid_0"]["auc"]) == 4
    out = capsys.readouterr()
    text = out.out + out.err
    assert "[2]\tvalid_0's binary_logloss" in text and "[4]" in text
    assert "[1]\t" not in text and "[3]\t" not in text
    with pytest.raises(TypeError):
        tcb.record_evaluation([])


@pytest.mark.parametrize("stratified,shuffle", [(True, True), (False, True),
                                                (False, False)])
def test_cv_folds_match_jax(stratified, shuffle):
    """``_make_n_folds`` draws the JAX package's folds row for row (the
    same RandomState stream)."""
    X, y, _, _ = _problem()
    got = list(tengine._make_n_folds(lt.Dataset(X, label=y), 4, {}, 11,
                                     stratified, shuffle))
    want = list(jengine._make_n_folds(lj.Dataset(X, label=y), 4, {}, 11,
                                      stratified, shuffle))
    assert len(got) == len(want) == 4
    for (gt, gv), (wt, wv) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("es", [None, 2])
def test_cv_matches_jax(es):
    """``cv`` over 3 stratified folds: the metrics' means and standard
    deviations a round within 1e-6 of the JAX package's (AUC within two
    pairs of near-equal predictions ordered apart a fold, 2 / (P N) of
    the smallest fold: AUC moves by steps), cut at the same round under
    early stopping; ``return_cvbooster`` hands back the fold boosters."""
    X, y, _, _ = _problem()
    params = dict(BASE, learning_rate=0.5)
    got = lt.cv(params, lt.Dataset(X, label=y), 30, nfold=3, seed=3,
                early_stopping_rounds=es, return_cvbooster=True,
                device="cpu")
    want = lj.cv(params, lj.Dataset(X, label=y), 30, nfold=3, seed=3,
                 early_stopping_rounds=es)
    boosters = got.pop("cvbooster")
    assert sorted(got) == sorted(want)
    folds = tengine._make_n_folds(lt.Dataset(X, label=y), 3, {}, 3, True,
                                  True)
    step = max(1.0 / ((y[v] > 0).sum() * (y[v] <= 0).sum())
               for _, v in folds)
    for k in want:
        assert len(got[k]) == len(want[k])
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=(
            2 * step if k.startswith("auc") else 1e-6))
    assert len(boosters.boosters) == 3
    if es:
        assert len(got["auc-mean"]) < 30
        assert boosters.best_iteration == len(got["auc-mean"])
    assert len(boosters.num_trees()) == 3


def test_dataset_subset_and_fields():
    """``Dataset.subset`` keeps the rows' fields and bins them with the
    full set's bins; ``get_field`` / ``get_label`` read them."""
    X, y, _, _ = _problem()
    w = np.linspace(0.5, 1.5, len(y))
    full = lt.Dataset(X, label=y, weight=w).construct()
    idx = np.arange(0, len(y), 3)
    sub = full.subset(idx).construct()
    np.testing.assert_array_equal(sub.get_label(), y[idx])
    np.testing.assert_array_equal(sub.get_field("weight"), w[idx])
    assert sub.num_data() == len(idx) and sub.num_feature() == 6
    assert sub._binned.bin_mappers is full._binned.bin_mappers
    np.testing.assert_array_equal(sub._binned.binned,
                                  full._binned.binned[:, idx])
