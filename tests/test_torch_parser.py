"""Data files and the binning knobs of the port against the JAX package's,
on the CPU.

``io/parser.load_data_file`` on csv, tsv (with NA spellings) and libsvm
files, with a header, column specs by index and by ``name:``, ignored
columns, and the ``.weight`` / ``.query`` / ``.init`` siblings: every
array the JAX function's on the same ``tmp_path`` file, bit for bit (the
JAX package's native parser left as it is: it and the Python parser are
held equal by the JAX package's own tests).  ``two_round`` streams the
file into the in-memory loader's bins.  ``Dataset(path)`` trains the
JAX package's trees and ``Booster.predict(path)`` reads a file.

The binning knobs (JAX tests/test_binning.py:124, tests/test_params.py
:172): ``max_bin_by_feature`` and ``forcedbins_filename`` give the JAX
package's bin bounds, on dense and CSR input.
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbmv1_tpu as lj
from lightgbmv1_tpu.config import Config as JConfig
from lightgbmv1_tpu.io.dataset import BinnedDataset as JBinned
from lightgbmv1_tpu.io.parser import load_data_file as jload

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.io.dataset import BinnedDataset
from lightgbmv1_tpu_torch.io.parser import load_data_file as tload

PARAMS = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
          "max_bin": 63, "hist_dtype": "f32", "min_data_in_leaf": 5}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(n=400, seed=0):
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, 4), 4)
    y = (X[:, 0] - X[:, 2] > 0).astype(float)
    return X, y


def _write(path, lines):
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _same(a, b):
    for f in ("X", "label", "weight", "group", "init_score"):
        ga, gb = getattr(a, f), getattr(b, f)
        assert (ga is None) == (gb is None), f
        if ga is not None:
            np.testing.assert_array_equal(ga, gb, err_msg=f)
    assert a.feature_names == b.feature_names


def _files(tmp_path):
    """name -> (path, load_data_file kwargs) of the cases."""
    X, y = _rows()
    w = np.round(np.random.RandomState(1).rand(len(y)) + 0.5, 3)
    qid = np.repeat(np.arange(40), 10)
    out = {}
    out["csv"] = (_write(tmp_path / "a.csv", [
        f"{y[i]:g}," + ",".join(f"{v}" for v in X[i])
        for i in range(len(y))]), {})
    # tsv with NA spellings, a comment line and trailing comments
    lines = []
    for i in range(len(y)):
        if i == 5:
            lines.append("# a comment")
        vals = [f"{v}" for v in X[i]]
        if i % 7 == 0:
            vals[1] = ("na", "NaN", "", "null")[i % 4]
        lines.append("\t".join([f"{y[i]:g}"] + vals) + "  # tail")
    out["tsv"] = (_write(tmp_path / "b.tsv", lines), {})
    out["libsvm"] = (_write(tmp_path / "c.svm", [
        f"{y[i]:g} " + " ".join(f"{j}:{X[i, j]}" for j in range(4)
                                if i % (j + 2)) for i in range(len(y))]), {})
    header = ["f0", "w", "label", "f1", "q", "f2", "f3"]
    lines = [",".join(header)]
    for i in range(len(y)):
        lines.append(",".join(str(v) for v in (
            X[i, 0], w[i], y[i], X[i, 1], qid[i], X[i, 2], X[i, 3])))
    out["header"] = (_write(tmp_path / "d.csv", lines), dict(
        has_header=True, label_column="name:label", weight_column="1",
        group_column="name:q", ignore_column="name:f2"))
    p = _write(tmp_path / "e.csv", [
        f"{y[i]:g}," + ",".join(f"{v}" for v in X[i])
        for i in range(len(y))])
    _write(tmp_path / "e.csv.weight", [f"{v}" for v in w])
    _write(tmp_path / "e.csv.query", ["100"] * 4)
    _write(tmp_path / "e.csv.init", [f"{v}" for v in 0.1 * X[:, 0]])
    out["siblings"] = (p, {})
    return out


@pytest.mark.parametrize("case", ["csv", "tsv", "libsvm", "header",
                                  "siblings"])
def test_load_data_file_matches_jax(case, tmp_path):
    path, kw = _files(tmp_path)[case]
    _same(tload(path, **kw), jload(path, **kw))
    _same(tload(path, is_predict=True, **kw),
          jload(path, is_predict=True, **kw))


def test_dataset_from_file_trains_the_jax_trees(tmp_path):
    """``Dataset(path)`` with the loader knobs in ``params`` (header,
    named label, weight and query columns): the JAX package's bins,
    metadata and trees; ``predict(path)`` drops the label column."""
    path, _ = _files(tmp_path)["header"]
    params = dict(PARAMS, header=True, label_column="name:label",
                  weight_column="1", ignore_column="name:q")
    td = lt.Dataset(path, params=dict(params)).construct()
    jd = lj.Dataset(path, params=dict(params)).construct()
    np.testing.assert_array_equal(td._binned.binned, jd._binned.binned)
    np.testing.assert_array_equal(td._binned.metadata.weight,
                                  jd._binned.metadata.weight)
    assert td._binned.feature_names == jd._binned.feature_names
    tb = lt.train(params, td, 3, device="cpu")
    jb = lj.train(params, jd, 3, verbose_eval=False)
    for jt, tt in zip(jb._all_trees(), tb._all_trees()):
        n = tt.num_leaves
        np.testing.assert_array_equal(tt.split_feature[:n - 1],
                                      jt.split_feature[:n - 1])
    csv, _ = _files(tmp_path)["csv"]
    X, _ = _rows()
    b = lt.train(PARAMS, lt.Dataset(csv), 3, device="cpu")
    np.testing.assert_allclose(b.predict(csv), b.predict(X), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("fmt", ["csv", "siblings", "libsvm"])
def test_two_round_matches_in_memory(fmt, tmp_path):
    """``two_round`` streams a dense file to the in-memory loader's bins
    and metadata (the JAX package's ``load_two_round``'s too); libsvm
    has no streaming path and loads in memory."""
    path, _ = _files(tmp_path)[fmt]
    params = dict(PARAMS, two_round=True, bin_construct_sample_cnt=150)
    mem = lt.Dataset(path, params=dict(PARAMS,
                                       bin_construct_sample_cnt=150))
    two = lt.Dataset(path, params=dict(params))
    if fmt == "libsvm":
        assert two._binned is None and two.data is not None
        return
    assert two.data is None and two._binned is not None
    jtwo = lj.Dataset(path, params=dict(params))
    np.testing.assert_array_equal(two._binned.binned, jtwo._binned.binned)
    for f in ("label", "weight", "init_score"):
        a, b = (getattr(two._binned.metadata, f),
                getattr(jtwo._binned.metadata, f))
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    mem.construct()
    np.testing.assert_array_equal(two.get_label(), mem.get_label())
    b = lt.train(PARAMS, two, 3, device="cpu")
    assert b.num_trees() == 3


def test_max_bin_by_feature_matches_jax():
    """Each feature at its own ``max_bin_by_feature`` (JAX
    test_max_bin_by_feature), on dense and CSR rows; a list of the wrong
    length is fatal."""
    rng = np.random.RandomState(3)
    X = rng.randn(600, 3)
    X[rng.rand(600) < 0.5, 2] = 0.0
    p = {"max_bin_by_feature": [8, 16, 32], "verbosity": -1}
    t = BinnedDataset.from_numpy(X, label=rng.rand(600),
                                 config=Config.from_dict(p))
    j = JBinned.from_numpy(X, label=rng.rand(600),
                           config=JConfig.from_dict(p))
    assert list(t.num_bins) == list(j.num_bins)
    assert t.num_bins[0] <= 8 and t.num_bins[1] <= 16 and t.num_bins[2] <= 32
    c = BinnedDataset.from_csr(*(lambda m: (m.indptr, m.indices, m.data))(
        sp.csr_matrix(X)), 600, 3, config=Config.from_dict(p))
    assert list(c.num_bins) == list(j.num_bins)
    for tm, jm in zip(t.bin_mappers, j.bin_mappers):
        np.testing.assert_array_equal(tm.bin_upper_bound, jm.bin_upper_bound)
    with pytest.raises(lt.LightGBMError, match="max_bin_by_feature"):
        BinnedDataset.from_numpy(X, config=Config.from_dict(
            {"max_bin_by_feature": [8, 16], "verbosity": -1}))


def test_forced_bins_match_jax(tmp_path):
    """``forcedbins_filename``'s bounds are bin bounds (JAX
    test_forced_bin_bounds), the JAX package's exactly; a missing file is
    ignored with a warning; the model trains on them."""
    rng = np.random.RandomState(0)
    X = rng.uniform(0.0, 10.0, size=(3000, 2))
    X[:200, 1] = -rng.uniform(0.0, 3.0, 200)
    spec = [{"feature": 0, "bin_upper_bound": [1.5, 7.25, 7.25]},
            {"feature": 1, "bin_upper_bound": [-1.0, 0.0, 2.0]}]
    fb = tmp_path / "forced_bins.json"
    fb.write_text(json.dumps(spec))
    p = {"max_bin": 16, "forcedbins_filename": str(fb), "verbosity": -1}
    y = (X[:, 0] > 5).astype(float)
    t = BinnedDataset.from_numpy(X, label=y, config=Config.from_dict(p))
    j = JBinned.from_numpy(X, label=y, config=JConfig.from_dict(p))
    for tm, jm in zip(t.bin_mappers, j.bin_mappers):
        np.testing.assert_array_equal(tm.bin_upper_bound, jm.bin_upper_bound)
    assert np.any(np.isclose(t.bin_mappers[0].bin_upper_bound, 7.25))
    np.testing.assert_array_equal(t.binned, j.binned)
    missing = dict(p, forcedbins_filename=str(tmp_path / "none.json"))
    m = BinnedDataset.from_numpy(X, label=y, config=Config.from_dict(missing))
    assert not np.any(np.isclose(m.bin_mappers[0].bin_upper_bound, 7.25))
    b = lt.train(dict(PARAMS, **p), lt.Dataset(X, label=y), 2, device="cpu")
    jb = lj.train(dict(PARAMS, **p), lj.Dataset(X, label=y), 2,
                  verbose_eval=False)
    np.testing.assert_allclose(b.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=2e-5)
