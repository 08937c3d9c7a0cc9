"""The model lifecycle of the port against the JAX package's, on the CPU
(JAX tests/test_checkpoint.py, tests/test_continue.py and
tests/test_api.py::test_custom_fobj_feval).

Both packages train the same numpy rows at ``hist_dtype=f32``: continued
training (``init_model`` from text and from a Booster, the loaded trees'
predictions seeding the training and valid scores), ``rollback_one_iter``
(GBDT and DART), ``refit`` (``decay_rate`` 0.9 and 0.0), a custom
objective (``fobj``, through ``train`` and ``update``), ``finite_guard``
(``warn``, ``raise``, ``clamp``) on an objective poisoned at one
iteration (the JAX package's ``grad_poison`` fault: NaN added to the
gradients and hessians of every 13th row), ``saved_feature_importance_
type``; and the port's own checkpoints: a run resumed from one writes the
uninterrupted run's model text byte for byte (GBDT and DART, bagging and
feature fraction on), a torn or flipped file is refused.

Tolerances: every split identical and leaves within 2e-5 (the port's
training tolerance, test_torch_train.test_f32_trees_identical); refit's
leaves within 2e-5 (the JAX package sums a leaf's gradients in float32,
the port in float64).
"""

import zipfile

import numpy as np
import pytest
import torch

import lightgbmv1_tpu as lj
from lightgbmv1_tpu.models import gbdt as jgbdt
from lightgbmv1_tpu.utils import faults as jfaults

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.io.checkpoint import (CheckpointError,
                                                checkpoint_iteration,
                                                is_checkpoint_file,
                                                load_checkpoint)
from lightgbmv1_tpu_torch.models import gbdt as tgbdt

PARAMS = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 10,
          "learning_rate": 0.1, "metric": "binary_logloss", "verbosity": -1,
          "max_bin": 63, "hist_dtype": "f32"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=2000, seed=0, f=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    logit = 1.5 * X[:, 0] - X[:, 1] + 0.8 * X[:, 2] * X[:, 3]
    y = (logit + rng.randn(n) * 0.4 > 0).astype(np.float64)
    return X, y


def _same_trees(jtrees, ttrees, atol=2e-5):
    """Every split of the host trees identical, leaves within ``atol``."""
    assert len(jtrees) == len(ttrees)
    for jt, tt in zip(jtrees, ttrees):
        n = tt.num_leaves
        assert n == jt.num_leaves
        for f in ("split_feature", "threshold_bin", "default_left",
                  "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(tt, f)[:n - 1],
                                          getattr(jt, f)[:n - 1])
        np.testing.assert_allclose(tt.leaf_value[:n], jt.leaf_value[:n],
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("source", ["text", "booster"])
def test_init_model_matches_jax(source, tmp_path):
    """Continued training from a model text (the same file for both) or
    a Booster: the new trees are the JAX package's, the valid set's
    first metric already counts the loaded trees."""
    X, y = _data()
    Xv, yv = _data(600, seed=3)
    tfirst = lt.train(PARAMS, lt.Dataset(X, label=y), 5, device="cpu")
    jfirst = lj.train(PARAMS, lj.Dataset(X, label=y), 5, verbose_eval=False)
    path = str(tmp_path / "first.txt")
    tfirst.save_model(path)
    tinit, jinit = ((path, path) if source == "text"
                    else (tfirst, jfirst))
    out = []
    for pkg, init, kw in ((lj, jinit, {"verbose_eval": False}),
                          (lt, tinit, {"device": "cpu"})):
        ev = {}
        b = pkg.train(PARAMS, pkg.Dataset(X, label=y), 4, init_model=init,
                      valid_sets=[pkg.Dataset(Xv, label=yv)],
                      evals_result=ev, **kw)
        out.append((b, ev["valid_0"]["binary_logloss"]))
    (jb, jloss), (tb, tloss) = out
    assert tb.num_trees() == jb.num_trees() == 9
    assert tb.current_iteration() == 9
    _same_trees(jb._all_trees(), tb._all_trees())
    np.testing.assert_allclose(tloss, jloss, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb.predict(Xv, raw_score=True),
                               jb.predict(Xv, raw_score=True), rtol=0,
                               atol=2e-5)
    fresh = lt.train(PARAMS, lt.Dataset(X, label=y), 1,
                     valid_sets=[lt.Dataset(Xv, label=yv)],
                     evals_result=(ev := {}), device="cpu")
    assert tloss[0] < ev["valid_0"]["binary_logloss"][0]
    # the saved text holds every tree and loads to the same predictions
    loaded = lt.Booster(model_str=tb.model_to_string(), device="cpu")
    assert loaded.num_trees() == 9
    np.testing.assert_allclose(loaded.predict(X), tb.predict(X), rtol=0,
                               atol=1e-12)
    del fresh


@pytest.mark.parametrize("boosting", ["gbdt", "dart"])
def test_rollback_one_iter(boosting):
    """Ten iterations rolled back once write the nine-iteration model
    text, and the JAX package's rolled-back trees."""
    X, y = _data(1500, seed=1)
    p = dict(PARAMS, boosting=boosting, drop_rate=0.5)
    nine = lt.train(p, lt.Dataset(X, label=y), 9, device="cpu")
    ten = lt.train(p, lt.Dataset(X, label=y), 10, device="cpu")
    assert ten.rollback_one_iter() is ten
    assert ten.current_iteration() == 9 and ten.num_trees() == 9
    assert ten.model_to_string() == nine.model_to_string()
    np.testing.assert_allclose(ten._gbdt.raw_train_scores(),
                               nine._gbdt.raw_train_scores(), rtol=0, atol=0)
    jten = lj.train(p, lj.Dataset(X, label=y), 10, verbose_eval=False)
    jten.rollback_one_iter()
    _same_trees(jten._all_trees(), ten._all_trees())


@pytest.mark.parametrize("decay", [0.9, 0.0])
def test_refit_matches_jax(decay):
    """Refit of one model text on new rows: the same structures, the JAX
    package's leaves within 2e-5, a prediction that moved."""
    X, y = _data(1500, seed=2)
    X2, y2 = _data(1200, seed=5)
    text = lt.train(PARAMS, lt.Dataset(X, label=y), 6,
                    device="cpu").model_to_string()
    tb = lt.Booster(model_str=text, device="cpu")
    jb = lj.Booster(model_str=text)
    tr = tb.refit(X2, y2, decay_rate=decay)
    jr = jb.refit(X2, y2, decay_rate=decay)
    _same_trees(jr._all_trees(), tr._all_trees())
    np.testing.assert_allclose(tr.predict(X2), jr.predict(X2), rtol=0,
                               atol=2e-5)
    assert not np.allclose(tr.predict(X2), tb.predict(X2))
    # a training Booster refits its own trees too
    trained = lt.train(PARAMS, lt.Dataset(X, label=y), 3, device="cpu")
    assert trained.refit(X2, y2).num_trees() == 3


@pytest.mark.parametrize("boosting", ["gbdt", "dart"])
def test_checkpoint_round_trip(boosting, tmp_path):
    """Train 8 straight, or 4 + checkpoint + a fresh Booster resumed for 4
    more (with a valid set, bagging and feature fraction): the model texts
    are equal byte for byte, the valid scores bit for bit."""
    X, y = _data(1500, seed=4)
    Xv, yv = _data(500, seed=6)
    p = dict(PARAMS, boosting=boosting, bagging_fraction=0.7,
             bagging_freq=2, feature_fraction=0.7, drop_rate=0.4)

    def booster():
        b = lt.Booster(p, train_set=lt.Dataset(X, label=y), device="cpu")
        b.add_valid(lt.Dataset(Xv, label=yv), "v")
        return b

    straight = booster()
    for _ in range(8):
        straight.update()
    part = booster()
    for _ in range(4):
        part.update()
    ckpt = str(tmp_path / "state.ckpt")
    part.save_checkpoint(ckpt)
    assert is_checkpoint_file(ckpt) and checkpoint_iteration(ckpt) == 4
    del part
    resumed = booster().resume_from_checkpoint(ckpt)
    for _ in range(4):
        resumed.update()
    assert resumed.model_to_string() == straight.model_to_string()
    assert np.array_equal(resumed._gbdt.raw_valid_scores(0),
                          straight._gbdt.raw_valid_scores(0))
    # train(init_model=<checkpoint>) resumes the same way
    via_train = lt.train(p, lt.Dataset(X, label=y), 4, init_model=ckpt,
                         valid_sets=[lt.Dataset(Xv, label=yv)],
                         device="cpu")
    assert via_train.model_to_string() == straight.model_to_string()


def test_checkpoint_of_continued_training(tmp_path):
    """A checkpoint of a continued run carries the loaded model and
    resumes to the uninterrupted continued run's text."""
    X, y = _data(1200, seed=7)
    base = lt.train(PARAMS, lt.Dataset(X, label=y), 3, device="cpu")
    straight = lt.train(PARAMS, lt.Dataset(X, label=y), 4, init_model=base,
                        device="cpu")
    part = lt.train(PARAMS, lt.Dataset(X, label=y), 2, init_model=base,
                    device="cpu")
    ckpt = str(tmp_path / "cont.ckpt")
    part.save_checkpoint(ckpt)
    assert load_checkpoint(ckpt)["base_model_text"] == base.model_to_string()
    resumed = lt.train(PARAMS, lt.Dataset(X, label=y), 2, init_model=ckpt,
                       device="cpu")
    assert resumed.num_trees() == 7
    assert resumed.model_to_string() == straight.model_to_string()


def test_torn_or_flipped_checkpoint_rejected(tmp_path):
    """A truncated bundle, or one with a flipped byte in its arrays, is a
    CheckpointError at load; a bundle of another seed is refused at
    restore."""
    X, y = _data(800, seed=8)
    p = dict(PARAMS, num_leaves=7)
    b = lt.train(p, lt.Dataset(X, label=y), 3, device="cpu")
    good = str(tmp_path / "good.ckpt")
    b.save_checkpoint(good)
    data = open(good, "rb").read()
    torn = str(tmp_path / "torn.ckpt")
    with open(torn, "wb") as fh:
        fh.write(data[:len(data) // 2])
    with pytest.raises(CheckpointError):
        load_checkpoint(torn)
    bad = str(tmp_path / "bad.ckpt")
    with zipfile.ZipFile(good) as zin, zipfile.ZipFile(bad, "w") as zout:
        for name in zin.namelist():
            payload = bytearray(zin.read(name))
            if name == "arrays.npz":
                payload[len(payload) // 2] ^= 0x01
            zout.writestr(name, bytes(payload))
    with pytest.raises(CheckpointError, match="digest"):
        load_checkpoint(bad)
    assert load_checkpoint(good)["manifest"]["iteration"] == 3
    with pytest.raises(CheckpointError, match="seed"):
        lt.train(dict(p, seed=9), lt.Dataset(X, label=y), 1,
                 init_model=good, device="cpu")
    assert not is_checkpoint_file(torn + ".missing")


_POISON_AT = 2


def _poison(g, h, iteration):
    """NaN on every 13th row's gradient and hessian at ``_POISON_AT``
    (the JAX package's grad_poison fault)."""
    if iteration != _POISON_AT:
        return g, h
    rows = torch.arange(g.shape[0]) % 13 == 0
    bad = torch.where(rows, torch.tensor(float("nan")), torch.tensor(0.0))
    return g + bad, h + bad


def _poisoned_port(p, X, y):
    b = lt.Booster(p, train_set=lt.Dataset(X, label=y), device="cpu")
    obj = b._gbdt.objective
    orig = obj.get_gradients

    def get_gradients(s, iteration=None):
        return _poison(*orig(s), iteration)

    obj.get_gradients, obj.is_stochastic = get_gradients, True
    return b


@pytest.mark.parametrize("mode", ["warn", "raise", "clamp"])
def test_finite_guard(mode, capsys):
    """``clamp`` trains the JAX package's trees through the poisoned
    iteration; ``raise`` stops at its boundary (FiniteGuardError) where
    the JAX package does; ``warn`` warns once and trains on."""
    X, y = _data(1500, seed=9)
    p = dict(PARAMS, finite_guard=mode, verbosity=0)
    tb = _poisoned_port(p, X, y)
    with jfaults.inject(jfaults.FaultSpec("grad_poison",
                                          payload=_POISON_AT)):
        jb = lj.Booster(p, train_set=lj.Dataset(X, label=y))

    def run(b, err):
        done = 0
        for _ in range(5):
            try:
                b.update()
            except err:
                return done, True
            done += 1
        return done, False

    capsys.readouterr()
    tdone, traised = run(tb, tgbdt.FiniteGuardError)
    twarned = capsys.readouterr().err.count("non-finite")
    jdone, jraised = run(jb, jgbdt.FiniteGuardError)
    jwarned = capsys.readouterr().err.count("non-finite")
    assert (tdone, traised, twarned) == (jdone, jraised, jwarned)
    assert traised == (mode == "raise") and tdone == (
        _POISON_AT if mode == "raise" else 5)
    assert twarned == (mode == "warn")
    if mode == "clamp":
        _same_trees(jb._all_trees(), tb._all_trees())
        assert np.isfinite(tb._gbdt.raw_train_scores()).all()
    # off reads nothing and raises nothing
    off = _poisoned_port(dict(PARAMS), X, y)
    for _ in range(3):
        off.update()


@pytest.mark.parametrize("kind", [0, 1])
def test_saved_feature_importance_type(kind):
    """The model text's importance block: split counts (0) or gains (1),
    in the JAX package's order and within its values."""
    X, y = _data(1500, seed=10)
    p = dict(PARAMS, saved_feature_importance_type=kind)
    tb = lt.train(p, lt.Dataset(X, label=y), 5, device="cpu")
    jb = lj.train(p, lj.Dataset(X, label=y), 5, verbose_eval=False)

    def block(text):
        lines = text.split("feature_importances:\n", 1)[1].split("\n\n")[0]
        return [ln.split("=") for ln in lines.splitlines() if "=" in ln]

    tblock, jblock = block(tb.model_to_string()), block(jb.model_to_string())
    assert [k for k, _ in tblock] == [k for k, _ in jblock]
    np.testing.assert_allclose([float(v) for _, v in tblock],
                               [float(v) for _, v in jblock], rtol=1e-4)
    if kind == 0:
        assert [v for _, v in tblock] == [v for _, v in jblock]


def _l2_obj(preds, dataset):
    return preds - dataset.get_label(), np.ones_like(preds)


def _l1_eval(preds, dataset):
    return "custom_l1", float(np.abs(preds - dataset.get_label()).mean()), \
        False


def test_fobj_train_and_update():
    """A custom L2 objective with a custom metric (JAX
    test_custom_fobj_feval): the JAX package's trees and metric curve,
    and ``update(fobj=)`` on a Booster writes ``train``'s text."""
    rng = np.random.RandomState(11)
    X = rng.randn(1000, 6)
    y = 2.0 * X[:, 0] - X[:, 1] + 0.5 * X[:, 2] * X[:, 3] \
        + rng.randn(1000) * 0.1
    p = {"verbosity": -1, "min_data_in_leaf": 5, "metric": "none",
         "num_leaves": 15, "max_bin": 63, "hist_dtype": "f32"}
    out = []
    for pkg, kw in ((lj, {"verbose_eval": False}), (lt, {"device": "cpu"})):
        ds = pkg.Dataset(X, label=y, params={"verbosity": -1})
        ev = {}
        b = pkg.train(p, ds, 12, valid_sets=[ds], fobj=_l2_obj,
                      feval=_l1_eval, evals_result=ev, **kw)
        out.append((b, ev["training"]["custom_l1"]))
    (jb, jl1), (tb, tl1) = out
    assert tl1[-1] < tl1[0] * 0.7
    np.testing.assert_allclose(tl1, jl1, rtol=0, atol=2e-5)
    _same_trees(jb._all_trees(), tb._all_trees())
    manual = lt.Booster(dict(p, objective="none"),
                        train_set=lt.Dataset(X, label=y), device="cpu")
    for _ in range(12):
        manual.update(fobj=_l2_obj)
    assert manual.model_to_string() == tb.model_to_string()
    # without fobj an objective-less trainer has no gradients
    with pytest.raises(lt.LightGBMError, match="fobj"):
        lt.Booster(dict(p, objective="none"),
                   train_set=lt.Dataset(X, label=y), device="cpu").update()
    # cv passes fobj to every fold
    res = lt.cv(dict(p, metric="l2"), lt.Dataset(X, label=y), 3, nfold=2,
                fobj=_l2_obj, device="cpu")
    assert len(res["l2-mean"]) == 3 and res["l2-mean"][-1] < res[
        "l2-mean"][0]
