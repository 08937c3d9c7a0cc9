"""The port's native C++ components against the JAX package's, on the CPU.

``native/predictor.cpp``: the pack of ``build_ensemble_pack`` and the
raw scores of ``predict_ensemble`` bit for bit the JAX package's on the
same model text (binary, multiclass K = 3, a categorical model), and a
pack that cannot hold a model (a categorical node without its raw set)
refused alike; ``Booster.predict``'s routing (``predict_method=native``,
``auto`` at ``_NATIVE_PREDICT_MIN_WORK`` rows x trees) the JAX package's,
the native walk bit for bit the host walk; a failed ``g++`` build raises.

``native/text_parser.cpp``: ``load_data_file`` on csv / tsv with a
header, NaN, ``na`` and blank cells equals the JAX loader (through the
native parser), and a ragged file gives the JAX loader's error.
"""

import numpy as np
import pytest
import torch

import lightgbmv1_tpu as lj
from lightgbmv1_tpu import basic as jbasic
from lightgbmv1_tpu import native as jnative
from lightgbmv1_tpu.io import parser as jparser

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch import basic as tbasic
from lightgbmv1_tpu_torch import native as tnative
from lightgbmv1_tpu_torch.io import parser as tparser

PARAMS = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 10,
          "verbosity": -1, "max_bin": 63, "hist_dtype": "f32"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=1500, seed=0, f=6, n_class=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n, f) < 0.05] = np.nan
    X[:, 0] = np.floor(np.abs(rng.randn(n)) * 4)       # categories 0..~12
    logit = 1.5 * np.nan_to_num(X[:, 1]) - np.nan_to_num(X[:, 2]) \
        + 2.0 * np.isin(X[:, 0], [1, 3, 5]) - 1.0
    if n_class == 2:
        y = (logit + rng.randn(n) * 0.4 > 0).astype(np.float64)
    else:
        y = np.digitize(logit + rng.randn(n) * 0.4, [-0.7, 0.7]) \
            .astype(np.float64)
    return X, y


def _model(kind):
    """A model text the port trained (binary, multiclass K = 3, or with a
    categorical column 0)."""
    if kind == "multiclass":
        X, y = _data(n_class=3)
        p = dict(PARAMS, objective="multiclass", num_class=3)
        ds = lt.Dataset(X, label=y)
    else:
        X, y = _data()
        p = PARAMS
        ds = lt.Dataset(X, label=y, categorical_feature=(
            [0] if kind == "categorical" else "auto"))
    return lt.train(p, ds, 6, device="cpu").model_to_string(), X


@pytest.mark.parametrize("kind", ["binary", "multiclass", "categorical",
                                  "refused"])
def test_pack_and_predict_match_jax(kind):
    text, X = _model("categorical" if kind == "refused" else kind)
    jb = lj.Booster(model_str=text)
    tb = lt.Booster(model_str=text, device="cpu")
    K = tb.num_model_per_iteration()
    jtrees, ttrees = jb._all_trees(), tb._all_trees()
    if kind == "categorical":
        assert any(t.is_cat[:t.num_leaves - 1].any() for t in ttrees)
    if kind == "refused":
        # a categorical node without its raw category set
        for trees in (jtrees, ttrees):
            t = next(t for t in trees if t.is_cat[:t.num_leaves - 1].any())
            t.cat_sets[int(np.flatnonzero(t.is_cat)[0])] = None
        assert jnative.build_ensemble_pack(jtrees, K) is None
        assert tnative.build_ensemble_pack(ttrees, K) is None
        return
    jpack = jnative.build_ensemble_pack(jtrees, K)
    tpack = tnative.build_ensemble_pack(ttrees, K)
    assert sorted(jpack) == sorted(tpack)
    for key, v in jpack.items():
        if isinstance(v, np.ndarray):
            assert tpack[key].dtype == v.dtype, key
            np.testing.assert_array_equal(tpack[key], v, err_msg=key)
        else:
            assert tpack[key] == v, key
    got = tnative.predict_ensemble(X, tpack, num_threads=3)
    np.testing.assert_array_equal(got, jnative.predict_ensemble(X, jpack))
    host = np.zeros_like(got)
    for i, t in enumerate(ttrees):
        host[:, i % K] += t.predict(X)
    np.testing.assert_array_equal(got, host)


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_auto_routes_like_jax(kind, monkeypatch):
    """Above the (lowered) threshold ``auto`` takes the native walk in
    both packages, below it the host walk; both equal the JAX ``auto``
    and each other bit for bit."""
    text, X = _model(kind)
    jb = lj.Booster(model_str=text)
    tb = lt.Booster(model_str=text, device="cpu")
    calls = []
    real = tnative.predict_ensemble

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tnative, "predict_ensemble", spy)
    below = tb.predict(X[:10], raw_score=True)
    assert calls == []
    work = 10 * tb.num_trees()
    monkeypatch.setattr(tbasic, "_NATIVE_PREDICT_MIN_WORK", work)
    monkeypatch.setattr(jbasic, "_NATIVE_PREDICT_MIN_WORK", work)
    for n in (10, len(X)):
        got = tb.predict(X[:n], raw_score=True)
        np.testing.assert_array_equal(got, jb.predict(X[:n],
                                                      raw_score=True))
        np.testing.assert_array_equal(
            got, tb.predict(X[:n], raw_score=True, predict_method="host"))
        np.testing.assert_array_equal(tb.predict(X[:n]), jb.predict(X[:n]))
    assert len(calls) == 4
    np.testing.assert_array_equal(below, got[:10])
    # predict_method=native at any size; a pack slice of its own
    calls.clear()
    np.testing.assert_array_equal(
        tb.predict(X[:3], raw_score=True, predict_method="native",
                   start_iteration=2, num_iteration=2),
        jb.predict(X[:3], raw_score=True, predict_method="native",
                   start_iteration=2, num_iteration=2))
    assert calls == [1]


def test_native_refused_pack_walks_the_host_trees():
    """A model the pack cannot hold predicts through the host walk under
    ``predict_method=native``, as in the JAX package."""
    text, X = _model("categorical")
    tb = lt.Booster(model_str=text, device="cpu")
    jb = lj.Booster(model_str=text)
    for b in (tb, jb):
        for t in b._all_trees():
            t.cat_sets = [None] * len(t.cat_sets)
    got = tb.predict(X, raw_score=True, predict_method="native")
    np.testing.assert_array_equal(got, jb.predict(
        X, raw_score=True, predict_method="native"))
    np.testing.assert_array_equal(got, tb.predict(
        X, raw_score=True, predict_method="host"))


def test_trained_booster_pack_follows_the_model_version():
    """The pack of a training Booster is cached per (slice, tree count,
    model version): an update and a rollback both reach the native
    walk."""
    X, y = _data()
    b = lt.Booster(PARAMS, train_set=lt.Dataset(X, label=y), device="cpu")
    for _ in range(3):
        b.update()
    first = b.predict(X, raw_score=True, predict_method="native")
    b.update()
    second = b.predict(X, raw_score=True, predict_method="native")
    assert not np.array_equal(first, second)
    np.testing.assert_array_equal(second, b.predict(
        X, raw_score=True, predict_method="host"))
    b.rollback_one_iter()
    np.testing.assert_array_equal(
        b.predict(X, raw_score=True, predict_method="native"), first)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A ``g++`` that fails raises with its output; nothing falls back."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "GXX_FLAGS",
                        tnative.GXX_FLAGS + ("--no-such-flag",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on "
                       "native/predictor.cpp"):
        tnative.build("predictor")
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tnative.build("text_parser")


def _write(path, text):
    path.write_text(text)
    return str(path)


_TABLE = [[1.0, 0.5, np.nan, 3.25], [0.0, -1.5, 2.0, np.nan],
          [1.0, np.nan, np.nan, 7.0], [0.0, 4.0, -0.125, 1e-3]]


def _cells(row, sep, nan_tokens):
    return sep.join(nan_tokens[i % len(nan_tokens)] if np.isnan(v)
                    else repr(v) for i, v in enumerate(row))


@pytest.mark.parametrize("fmt", ["csv", "tsv"])
def test_parser_matches_jax_loader(fmt, tmp_path, monkeypatch):
    """csv / tsv with a header, NaN / na / NA / blank cells, a comment
    and a blank line: the native parser reads the file (a spy sees it
    return the table) and the DataFile equals the JAX loader's."""
    sep = "," if fmt == "csv" else "\t"
    lines = [sep.join(["label", "a", "b", "c"])]
    for i, row in enumerate(_TABLE):
        lines.append(_cells(row, sep, ["NaN", "na", "", "NA"][i:] + ["nan"]))
    lines.insert(3, "# a comment")
    lines.insert(4, "")
    path = _write(tmp_path / f"d.{fmt}", "\n".join(lines) + "\n")
    seen = []
    real = tnative.parse_dense_file

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append(out is not None)
        return out

    monkeypatch.setattr(tnative, "parse_dense_file", spy)
    t = tparser.load_data_file(path, has_header=True)
    j = jparser.load_data_file(path, has_header=True)
    assert seen == [True]
    np.testing.assert_array_equal(t.X, j.X)
    np.testing.assert_array_equal(t.label, j.label)
    np.testing.assert_array_equal(t.X, np.asarray(_TABLE)[:, 1:])
    assert t.feature_names == j.feature_names == ["a", "b", "c"]
    np.testing.assert_array_equal(
        tnative.parse_dense_file(path, True, sep),
        jnative.parse_dense_file(path, True, sep))


@pytest.mark.parametrize("fmt", ["csv", "tsv"])
def test_ragged_file_gives_the_jax_error(fmt, tmp_path):
    """A row with a missing field: the native parser hands the file back
    (None) and the Python parser raises the JAX loader's error."""
    sep = "," if fmt == "csv" else "\t"
    path = _write(tmp_path / f"r.{fmt}",
                  f"1{sep}2{sep}3\n4{sep}5\n6{sep}7{sep}8\n")
    assert tnative.parse_dense_file(path, False, sep) is None
    with pytest.raises(ValueError) as te:
        tparser.load_data_file(path)
    with pytest.raises(ValueError) as je:
        jparser.load_data_file(path)
    assert str(te.value) == str(je.value)


def test_parsed_file_trains_the_jax_model(tmp_path):
    """A csv parsed natively trains the same trees as in-memory rows and
    as the JAX package on the same file."""
    X, y = _data(800, seed=4)
    X[:, 0] = np.round(X[:, 0], 3)
    path = str(tmp_path / "train.csv")
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.17g")
    tb = lt.train(PARAMS, lt.Dataset(path), 4, device="cpu")
    jb = lj.train(PARAMS, lj.Dataset(path), 4, verbose_eval=False)
    mem = lt.train(PARAMS, lt.Dataset(X, label=y), 4, device="cpu")
    assert tb.model_to_string() == mem.model_to_string()
    for jt, tt in zip(jb._all_trees(), tb._all_trees()):
        n = tt.num_leaves
        np.testing.assert_array_equal(tt.split_feature[:n - 1],
                                      jt.split_feature[:n - 1])
        np.testing.assert_allclose(tt.leaf_value[:n], jt.leaf_value[:n],
                                   rtol=0, atol=2e-5)
