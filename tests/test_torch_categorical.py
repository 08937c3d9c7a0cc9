"""Categorical features of the port against the JAX package, on the CPU.

The binning (``BinMapper`` categorical mappers: truncation, descending
counts, the trailing other / NaN / unseen bin, ``feature_infos``), the
categorical split scan (``split.best_categorical`` merged into the
numerical pick, the plain version of the split-scan kernel's categorical
leg) against the JAX ``find_best_split`` on the same histograms, the
bitset helpers, K3's bitset leg (``fused_cuda.route_rows_ref(...,
cat=)``), training on the wave (staged), sequential and level-wise
growers against the JAX package's trees, the C++ reference's golden
model, the model text, conversion of a JAX-trained model and the
refusals the JAX gates make.

Tolerances: a gain within 1e-5 relative; the features, thresholds,
``is_cat`` and bitsets of a pick identical; its left sums within 1e-6
relative (the sorted scan's prefix sums are PyTorch's CPU cumulative sum,
accumulated in double, and XLA's f32 cumulative sum on the CPU rounds in
another order: the numerical scan's left sums differ by the same ulps).
Trained trees: structures identical, leaves within 2e-5 and raw
predictions within 1.5e-5.  The JAX sequential grower sums a tree's root
rows in row order (a scatter fold, JAX grower.py:259-268), the port in
the device's own order; the sequential trainings here give the port the
JAX order (``_row_order_root_sums``), so their leaves compare at the same
2e-5.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp
import lightgbmv1_tpu as lj
from lightgbmv1_tpu.config import Config as JConfig
from lightgbmv1_tpu.io.dataset import BinnedDataset as JBinned
from lightgbmv1_tpu.ops import split as jsplit

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.io.dataset import BinnedDataset
from lightgbmv1_tpu_torch.models import convert
from lightgbmv1_tpu_torch.models import grower as tgrower
from lightgbmv1_tpu_torch.models.convert import tree_arrays_from_numpy
from lightgbmv1_tpu_torch.models.tree import HostTree, tree_leaf_index_binned
from lightgbmv1_tpu_torch.ops import fused_cuda, scan_cuda
from lightgbmv1_tpu_torch.ops import split as tsplit
from lightgbmv1_tpu_torch.ops import wave_fused as twf
from lightgbmv1_tpu_torch.utils.prng import prng_key

CPU = torch.device("cpu")
DATA = os.path.join(os.path.dirname(__file__), "data")
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
        "learning_rate": 0.2, "verbosity": -1, "hist_dtype": "f32"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_cat_problem(n=3000, seed=0, n_cats=12):
    """JAX tests/test_categorical.py's problem: the label follows a
    non-ordinal subset of one categorical column."""
    rng = np.random.RandomState(seed)
    cat = rng.randint(0, n_cats, size=n)
    x1 = rng.randn(n)
    good = np.isin(cat, [1, 4, 7, 10])
    logit = np.where(good, 2.0, -2.0) + 0.3 * x1
    y = (logit + rng.randn(n) * 0.5 > 0).astype(np.float64)
    return np.column_stack([cat.astype(np.float64), x1]), y


def make_cat_data(n=3000, seed=0, cards=(3, 12, 40)):
    """Categorical columns of the given cardinalities, each with a random
    effect a category (non-ordinal), beside three numerical columns; some
    NaN and negative categories; labels drawn from the logistic model."""
    rng = np.random.RandomState(seed)
    cols, logit = [], np.zeros(n)
    for card in cards:
        c = rng.randint(0, card, n)
        logit += rng.randn(card)[c]
        cols.append(c.astype(np.float64))
    x = rng.randn(n, 3)
    logit += x @ np.array([0.8, -0.5, 0.3])
    X = np.column_stack(cols + [x])
    X[rng.rand(n) < 0.03, 1] = np.nan
    X[rng.rand(n) < 0.02, 2] = -1.0
    y = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float64)
    return X, y


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------

def _binned_pair(X, cats, params=None, csr=False):
    p = dict({"max_bin": 31, "verbosity": -1}, **(params or {}))
    if csr:
        m = sp.csr_matrix(np.nan_to_num(X, nan=0.0))
        args = (m.indptr, m.indices, m.data, X.shape[0], X.shape[1])
        return (JBinned.from_csr(*args, config=JConfig.from_dict(p),
                                 categorical_features=cats),
                BinnedDataset.from_csr(*args, config=Config.from_dict(p),
                                       categorical_features=cats))
    return (JBinned.from_numpy(X, config=JConfig.from_dict(p),
                               categorical_features=cats),
            BinnedDataset.from_numpy(X, config=Config.from_dict(p),
                                     categorical_features=cats))


@pytest.mark.parametrize("case", ["dense", "csr", "prefilter"])
def test_categorical_binning_matches_jax(case):
    """The same mappers (categories in descending count, the trailing
    other bin, zero / NaN bins, missing type, triviality, feature_infos)
    and the same bins: NaN, negative values, a column of more categories
    than max_bin, a 2-category column, and CSR input."""
    rng = np.random.RandomState(4)
    n = 2000
    X = np.column_stack([
        rng.randint(0, 8, n).astype(float),           # few categories
        rng.randint(0, 90, n).astype(float),          # past max_bin = 31
        rng.randint(-3, 5, n) + rng.rand(n) * 0.9,    # negatives, fractions
        rng.randint(0, 2, n).astype(float),           # two categories
        rng.randn(n)])                                # numerical
    X[rng.rand(n) < 0.05, 0] = np.nan
    params = {"min_data_in_leaf": 900} if case == "prefilter" else {}
    jd, td = _binned_pair(X, [0, 1, 2, 3], params, csr=case == "csr")
    for jm, tm in zip(jd.bin_mappers, td.bin_mappers):
        assert tm.bin_type == jm.bin_type
        assert tm.bin_2_categorical == jm.bin_2_categorical
        assert tm.categorical_2_bin == jm.categorical_2_bin
        for f in ("num_bin", "missing_type", "is_trivial", "nan_bin",
                  "zero_bin", "default_bin"):
            assert getattr(tm, f) == getattr(jm, f), f
        assert tm.feature_info_str() == jm.feature_info_str()
        probe = np.array([np.nan, -1.0, 0.0, 2.7, 89.0, 1e4, 3.0])
        np.testing.assert_array_equal(tm.value_to_bin(probe),
                                      jm.value_to_bin(probe))
    np.testing.assert_array_equal(td.is_categorical, jd.is_categorical)
    if case == "csr":
        np.testing.assert_array_equal(td.train_matrix, jd.train_matrix)
    else:
        np.testing.assert_array_equal(td.binned, jd.binned)
    assert td.bin_mappers[1].num_bin == 31


def test_forced_bins_skip_categorical_features(tmp_path, capsys):
    """forcedbins_filename's bounds are ignored on a categorical feature
    with the JAX warning (JAX binning.py:342-343)."""
    from lightgbmv1_tpu_torch.utils import log

    fb = tmp_path / "forced.json"
    fb.write_text('[{"feature": 0, "bin_upper_bound": [1.5, 3.5]},'
                  ' {"feature": 1, "bin_upper_bound": [0.0]}]')
    rng = np.random.RandomState(0)
    X = np.column_stack([rng.randint(0, 6, 500), rng.randn(500)])
    saved = log._level
    try:
        jd, td = _binned_pair(X, [0], {"forcedbins_filename": str(fb),
                                       "verbosity": 0})
    finally:
        log._level = saved
    assert "Feature 0 is categorical" in capsys.readouterr().err
    assert td.bin_mappers[0].bin_2_categorical == \
        jd.bin_mappers[0].bin_2_categorical
    np.testing.assert_array_equal(td.bin_mappers[1].bin_upper_bound,
                                  jd.bin_mappers[1].bin_upper_bound)


# ---------------------------------------------------------------------------
# the categorical split scan
# ---------------------------------------------------------------------------

_SCAN_CASES = {
    "sorted": {},
    "onehot": {"max_cat_to_onehot": 40},
    "min_data_per_group": {"min_data_per_group": 30.0},
    "max_cat_threshold": {"max_cat_threshold": 2, "min_data_per_group": 1.0},
    "extra_trees": {"extra_trees": True, "extra_seed": 9},
    "cegb": {"cegb": True},
    "use_mc": {"mono": True},
    "smooth_mds": {"path_smooth": 2.0, "max_delta_step": 0.4},
    "contri_l1": {"contri": True, "lambda_l1": 0.5, "lambda_l2": 1.0},
    "hist_scale": {"scale": True},
}


def _scan_inputs(seed, C=4, F=5, B=32):
    """C leaves' histograms of rows drawn with categorical features 0, 1,
    3 (cardinalities 9, 25, 3) and numerical 2, 4; each feature's bins
    sum to its leaf's totals."""
    rng = np.random.RandomState(seed)
    nb = np.array([10, 26, 32, 4, 20])
    cat = np.array([True, True, False, True, False])
    hist = np.zeros((C, F, B, 3), np.float32)
    sums = np.zeros((C, 3), np.float32)
    for c in range(C):
        n = rng.randint(300, 900)
        g = (rng.randn(n) * 0.5).astype(np.float32)
        h = (rng.rand(n) * 0.25 + 0.05).astype(np.float32)
        for f in range(F):
            b = rng.randint(0, nb[f], n)
            g_f = g + (0.3 * (b % 3 == 1) if cat[f] else 0.0)
            np.add.at(hist[c, f, :, 0], b, g_f.astype(np.float32))
            np.add.at(hist[c, f, :, 1], b, h)
            np.add.at(hist[c, f, :, 2], b, 1.0)
        sums[c] = hist[c, 2].sum(0)
        hist[c, :, :, 0] *= 1.0
    return hist, sums, nb, cat


def _metas(nb, cat, mono=None, contri=None):
    F = len(nb)
    mono_a = np.zeros(F, np.int32) if mono is None else np.asarray(mono)
    jm = jsplit.FeatureMeta(
        num_bins=jnp.asarray(nb, jnp.int32),
        missing_type=jnp.zeros(F, jnp.int32),
        nan_bin=jnp.asarray(np.where(cat, nb - 1, -1), jnp.int32),
        zero_bin=jnp.zeros(F, jnp.int32), is_categorical=jnp.asarray(cat),
        usable=jnp.ones(F, bool), monotone_type=jnp.asarray(mono_a),
        contri=None if contri is None else jnp.asarray(contri))
    tm = tsplit.with_tables(tsplit.FeatureMeta(
        num_bins=torch.as_tensor(nb, dtype=torch.int64),
        missing_type=torch.zeros(F, dtype=torch.int64),
        nan_bin=torch.as_tensor(np.where(cat, nb - 1, -1)),
        zero_bin=torch.zeros(F, dtype=torch.int64),
        usable=torch.ones(F, dtype=torch.bool),
        monotone_type=None if mono is None else torch.as_tensor(
            mono_a, dtype=torch.int64),
        contri=None if contri is None else torch.as_tensor(contri),
        is_categorical=torch.as_tensor(cat)))
    return jm, tm


@pytest.mark.parametrize("case", list(_SCAN_CASES))
def test_categorical_scan_matches_jax(case):
    """The port's find_best_split (numerical scan, then the categorical
    leg's plain version) picks what the JAX ``find_best_split`` picks
    on each of C leaves: the feature, threshold, is_cat and bitset
    identical, the gain within 1e-5 relative, the left sums within
    1e-6."""
    opts = dict(_SCAN_CASES[case])
    hist, sums, nb, cat = _scan_inputs(7 + len(case))
    C, F, B, _ = hist.shape
    mono = [0, 0, 1, 0, -1] if opts.pop("mono", False) else None
    contri = (np.array([1.0, 0.7, 0.9, 1.2, 1.0], np.float32)
              if opts.pop("contri", False) else None)
    use_cegb = opts.pop("cegb", False)
    use_scale = opts.pop("scale", False)
    jm, tm = _metas(nb, cat, mono, contri)
    params = dict(min_data_in_leaf=10.0, min_sum_hessian_in_leaf=1e-3,
                  cat_smooth=5.0, min_data_per_group=10.0)
    params.update(opts)
    jp, tp = jsplit.SplitParams(**params), tsplit.SplitParams(**params)
    rng = np.random.RandomState(3)
    mask = rng.rand(C, F) > 0.15
    mask[:, 1] = True
    cegb = (rng.rand(C, F).astype(np.float32) * 3.0 if use_cegb else None)
    constr = np.array([[-0.3, 0.4], [-3e38, 3e38], [-1.0, 0.2],
                       [-0.1, 3e38]], np.float32)
    pout = (rng.randn(C) * 0.1).astype(np.float32)
    scale = np.array([0.5, 0.25, 1.0], np.float32) if use_scale else None
    hin = hist if scale is None else (hist / scale).astype(np.float32)
    key = 0x5eed
    uids = np.array([0, 3, 4, 11])
    tres = tsplit.find_best_split(
        torch.as_tensor(hin), torch.as_tensor(sums), tm,
        torch.as_tensor(mask), tp,
        hist_scale=(None if scale is None
                    else torch.as_tensor(scale).expand(C, 3).contiguous()),
        constraint=torch.as_tensor(constr) if mono else None,
        parent_output=torch.as_tensor(pout), key=prng_key(key),
        uids=torch.as_tensor(uids),
        cegb=None if cegb is None else torch.as_tensor(cegb))
    assert tres.is_cat is not None
    n_cat = 0
    for c in range(C):
        rk = (jax.random.fold_in(jax.random.PRNGKey(key),
                                 int(uids[c]) + 1_000_003 + tp.extra_seed)
              if tp.extra_trees else None)
        jr = jsplit.find_best_split(
            jnp.asarray(hin[c]), jnp.asarray(sums[c]), jm,
            jnp.asarray(mask[c]), jp,
            constraint=jnp.asarray(constr[c]) if mono else None,
            parent_output=jnp.asarray(pout[c]), rand_key=rk,
            cegb_penalty=None if cegb is None else jnp.asarray(cegb[c]),
            hist_scale=None if scale is None else jnp.asarray(scale))
        assert int(tres.feature[c]) == int(jr.feature), c
        assert bool(tres.is_cat[c]) == bool(jr.is_cat), c
        assert int(tres.threshold_bin[c]) == int(jr.threshold_bin), c
        assert bool(tres.default_left[c]) == bool(jr.default_left), c
        np.testing.assert_array_equal(
            tres.cat_bitset[c].numpy().view(np.uint32),
            np.asarray(jr.cat_bitset))
        np.testing.assert_allclose(float(tres.gain[c]), float(jr.gain),
                                   rtol=1e-5)
        np.testing.assert_allclose(tres.left_sum[c].numpy(),
                                   np.asarray(jr.left_sum), rtol=1e-6,
                                   atol=1e-6)
        n_cat += bool(jr.is_cat)
    assert n_cat >= 1


def test_categorical_leg_wrapper_is_its_plain_version():
    """``scan_cuda.split_scan_cat`` on CPU tensors is ``split_cat_ref``:
    the merged rows and [is_cat, bitset] rows of ``best_categorical`` +
    ``merge_categorical`` (what the card's kernel is held to), and a
    numerical winner's row is left as the numerical scan wrote it."""
    hist, sums, nb, cat = _scan_inputs(2)
    _, tm = _metas(nb, cat)
    tp = tsplit.SplitParams(min_data_in_leaf=10.0, cat_smooth=5.0,
                            min_data_per_group=10.0)
    h, s = torch.as_tensor(hist), torch.as_tensor(sums)
    mask = torch.ones((4, 5), dtype=torch.bool)
    packed = scan_cuda.split_scan_pick(h, mask, s, meta=tm, params=tp)
    scan_cuda.reset_launch_counts()
    rows, cat_out = scan_cuda.split_scan_cat(h, mask, s, packed.clone(),
                                             meta=tm, params=tp)
    assert scan_cuda.plain_counts["split_scan_cat"] == 1
    assert cat_out.shape == (4, 2) and cat_out.dtype == torch.int32
    shift = tsplit.gain_shift(s, tp)
    g, f, left, bits = tsplit.best_categorical(h, s, tm, mask, tp, shift)
    use = g > packed[:, 0]
    assert torch.equal(cat_out[:, 0] != 0, use)
    assert torch.equal(rows[~use], packed[~use])
    assert torch.equal(rows[use, 4:7], left[use])
    assert torch.equal(cat_out[use, 1:], bits[use])


def test_bitset_helpers_match_jax():
    rng = np.random.RandomState(0)
    member = rng.rand(6, 70) < 0.4
    words = tsplit.pack_bitset(torch.as_tensor(member))
    jw = np.stack([np.asarray(jsplit._pack_bitset(jnp.asarray(m), 70))
                   for m in member])
    np.testing.assert_array_equal(words.numpy().view(np.uint32), jw)
    bins = rng.randint(0, 70, (6, 50))
    got = tsplit.bitset_contains(words[:, None, :].expand(6, 50, 3),
                                 torch.as_tensor(bins))
    want = np.asarray(jsplit.bitset_contains(
        jnp.asarray(jw)[:, None, :].repeat(50, axis=1), jnp.asarray(bins)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.take_along_axis(member, bins, 1))


def test_k3_bitset_leg_plain_version():
    """K3's bitset leg (``route_rows_ref(..., cat=)``): a tree of mixed
    categorical and numerical splits routed round by round gives the
    leaf ids of the binned tree walk (``tree_leaf_index_binned``, the
    decision of JAX tree.py:183-189), and with no categorical split the
    u8 leg's."""
    rng = np.random.RandomState(2)
    N, F, B = 3000, 5, 40
    binned = torch.as_tensor(rng.randint(0, B, (F, N)).astype(np.uint8))
    meta = tsplit.with_tables(tsplit.FeatureMeta(
        num_bins=torch.full((F,), B), missing_type=torch.zeros(F).long(),
        nan_bin=torch.full((F,), -1), zero_bin=torch.zeros(F).long(),
        usable=torch.ones(F, dtype=torch.bool)))
    P = 20
    leafs = [0] + [int(rng.randint(0, p + 1)) for p in range(1, P)]
    nls = list(range(1, P + 1))
    feats = torch.as_tensor(rng.randint(0, F, P))
    thrs = torch.as_tensor(rng.randint(0, B - 1, P))
    is_cat = torch.as_tensor(rng.rand(P) < 0.5)
    bits = tsplit.pack_bitset(torch.as_tensor(rng.rand(P, B) < 0.5))
    cat = torch.cat([is_cat.to(torch.int32)[:, None], bits], dim=1)
    kw = dict(feats=feats, thrs=thrs, dls=torch.zeros(P, dtype=torch.bool),
              leafs=torch.as_tensor(leafs), nls=torch.as_tensor(nls),
              num_leaves=P + 1, meta=meta,
              offsets=torch.arange(P + 1, dtype=torch.int32))
    lid0 = torch.zeros(N, dtype=torch.int32)
    got = twf.fused_route_rows([(binned, lid0)], cat=cat, **kw)[0]
    # the same splits as a tree, walked on the bins
    lid = torch.zeros(N, dtype=torch.int64)
    b = binned.long()
    for p in range(P):
        bp = b[int(feats[p])]
        gl = tsplit.cat_go_left(bp, bits[p], is_cat[p], bp <= thrs[p])
        lid = torch.where((lid == leafs[p]) & ~gl, torch.tensor(nls[p]),
                          lid)
    assert torch.equal(got.long(), lid)
    plain = twf.fused_route_rows([(binned, lid0)], cat=None, **kw)[0]
    none = twf.fused_route_rows([(binned, lid0)],
                                cat=cat * torch.tensor([0] + [1] * 2,
                                                       dtype=torch.int32),
                                **kw)[0]
    assert torch.equal(plain, none)
    fused_cuda.reset_launch_counts()


# ---------------------------------------------------------------------------
# training against the JAX package
# ---------------------------------------------------------------------------

def _row_order_root_sums(g3):
    """The JAX sequential grower's root sums: the rows folded in row order
    (a scatter fold, JAX grower.py:259-268)."""
    return torch.zeros((1, 3), dtype=g3.dtype).index_add_(
        0, torch.zeros(g3.shape[0], dtype=torch.int64), g3)[0]


def _train_both(growth, X, y, cats, extra=None, n_iter=5):
    p = dict(BASE, tree_growth=growth, **(extra or {}))
    if growth == "leafwise":
        p.setdefault("leafwise_wave_size", 4)
    jb = lj.train(p, lj.Dataset(X, label=y, categorical_feature=cats),
                  n_iter, verbose_eval=False)
    saved = tgrower.root_sums
    if growth in ("leafwise_serial", "leafwise_masked"):
        tgrower.root_sums = _row_order_root_sums
    try:
        tb = lt.train(p, lt.Dataset(X, label=y, categorical_feature=cats),
                      n_iter, device="cpu")
    finally:
        tgrower.root_sums = saved
    return jb, tb


def _assert_same_trees(jb, tb, leaf_tol=2e-5):
    """Every tree's structure, categorical bitsets included, identical;
    leaves within ``leaf_tol``.  Returns the categorical split count."""
    jtrees = jax.device_get(jb._gbdt._device_trees)
    assert len(jtrees) == len(tb._gbdt._device_trees)
    n_cat = 0
    for jt, tt in zip(jtrees, tb._gbdt._device_trees):
        c = tree_arrays_from_numpy(jt._asdict())
        n = int(c.num_leaves)
        assert n == int(tt.num_leaves)
        for f in ("split_feature", "threshold_bin", "default_left",
                  "left_child", "right_child", "is_cat"):
            assert torch.equal(getattr(c, f)[:n - 1],
                               getattr(tt, f)[:n - 1]), f
        W = tt.cat_bitset.shape[1]
        isc = tt.is_cat[:n - 1]
        assert torch.equal(c.cat_bitset[:n - 1, :W][isc],
                           tt.cat_bitset[:n - 1][isc])
        np.testing.assert_allclose(tt.leaf_value[:n].numpy(),
                                   c.leaf_value[:n].numpy(), rtol=0,
                                   atol=leaf_tol)
        n_cat += int(isc.sum())
    return n_cat


_GROWTHS = ["leafwise", "leafwise_serial", "levelwise"]


@pytest.mark.parametrize("growth", _GROWTHS)
def test_categorical_training_matches_jax(growth):
    """Three categorical columns (3 categories: one-vs-rest; 12 and 40:
    the sorted scan), NaN and negative categories: every tree the JAX
    package's, bitsets included."""
    X, y = make_cat_data()
    jb, tb = _train_both(growth, X, y, [0, 1, 2])
    assert _assert_same_trees(jb, tb) >= 5
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1.5e-5)


@pytest.mark.parametrize("growth", _GROWTHS)
def test_cat_problem_training_matches_jax(growth):
    """JAX test_categorical's problem.  After the first categorical split
    its leaves hold almost no signal, and the JAX package's next splits
    there come from gains of +-6e-5, one f32 ulp of the leaf's gain
    scale, which any other rounding order of the same sums flips; a
    ``min_gain_to_split`` of 1e-3 keeps such ulp-level gains from
    deciding a split, in both packages alike."""
    X, y = make_cat_problem()
    jb, tb = _train_both(growth, X, y, [0], {"min_gain_to_split": 1e-3})
    assert _assert_same_trees(jb, tb) >= 1
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1.5e-5)


def _golden():
    raw = np.loadtxt(os.path.join(DATA, "golden_binary.tsv"))
    return raw[:, 1:], raw[:, 0]


@pytest.mark.parametrize("growth", _GROWTHS)
def test_golden_categorical_training_matches_jax(growth):
    X, y = _golden()
    jb, tb = _train_both(growth, X, y, [0],
                         {"num_leaves": 7, "max_bin": 32,
                          "max_delta_step": 0.5, "learning_rate": 0.3,
                          "leafwise_wave_size": 2})
    assert _assert_same_trees(jb, tb) >= 1
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1.5e-5)


def test_golden_mds_reference_training_parity():
    """The C++ reference's model trained on golden_binary.tsv with
    categorical_feature=0 (JAX test_golden_compat
    test_max_delta_step_training_parity): split features identical,
    thresholds within 1e-9, predictions within 1e-4 / 2e-5."""
    X, y = _golden()
    ref_pred = np.loadtxt(os.path.join(DATA, "golden_mds_pred.txt"))
    ref = lt.Booster(model_file=os.path.join(DATA, "golden_mds_model.txt"),
                     device="cpu")
    bst = lt.train({"objective": "binary", "num_leaves": 7, "max_bin": 32,
                    "min_data_in_leaf": 20, "learning_rate": 0.3,
                    "max_delta_step": 0.5, "verbosity": -1},
                   lt.Dataset(X, label=y, categorical_feature=[0]), 5,
                   device="cpu")
    n_cat = 0
    for tr, to in zip(ref._all_trees(), bst._all_trees()):
        np.testing.assert_array_equal(tr.split_feature[:tr.num_leaves - 1],
                                      to.split_feature[:to.num_leaves - 1])
        np.testing.assert_allclose(
            np.asarray(tr.threshold[:tr.num_leaves - 1], np.float64),
            np.asarray(to.threshold[:to.num_leaves - 1], np.float64),
            rtol=1e-9)
        n_cat += int(to.is_cat.sum())
    assert n_cat >= 1
    np.testing.assert_allclose(bst.predict(X), ref_pred, rtol=1e-4,
                               atol=2e-5)


def test_valid_sets_route_through_the_bitsets():
    """The wave grower routes each valid set once a tree through K3's
    bitset leg (its plain version on the CPU, with the splits'
    categorical rows); the valid scores are the binned walk's of each
    tree, and the valid metric is the one ``predict`` gives."""
    from lightgbmv1_tpu_torch.models.tree import tree_predict_binned

    X, y = make_cat_data(4000, seed=3)
    Xt, yt, Xv, yv = X[:3000], y[:3000], X[3000:], y[3000:]
    ds = lt.Dataset(Xt, label=yt, categorical_feature=[0, 1, 2])
    dv = lt.Dataset(Xv, label=yv, reference=ds)
    seen = []
    real = fused_cuda.route_rows_ref

    def spy(*a, **k):
        seen.append(a[8] if len(a) > 8 else k.get("cat"))
        return real(*a, **k)

    fused_cuda.route_rows_ref = spy
    try:
        ev = {}
        b = lt.train(dict(BASE, metric="binary_logloss"), ds, 4,
                     valid_sets=[dv], evals_result=ev, device="cpu")
    finally:
        fused_cuda.route_rows_ref = real
    assert len(seen) == 4 and all(c is not None for c in seen)
    g = b._gbdt
    walk = sum(tree_predict_binned(t, g._valid_binned[0], g.meta.nan_bin,
                                   g.meta.missing_type, g.meta.zero_bin)
               for t in g._device_trees)
    np.testing.assert_allclose(
        (g._valid_scores[0].score[:, 0] - g._init_scores[0]).numpy(),
        walk.numpy(), rtol=0, atol=1e-5)
    p = np.clip(b.predict(Xv), 1e-15, 1 - 1e-15)
    want = -np.mean(yv * np.log(p) + (1 - yv) * np.log(1 - p))
    np.testing.assert_allclose(ev["valid_0"]["binary_logloss"][-1], want,
                               rtol=1e-5)


def make_cat_efb_data(n=3000, seed=0):
    """Four sparse categorical columns, a row non-zero in one of them (EFB
    bundles them, JAX io/bundle.py:286 excludes no categorical feature),
    beside four numerical ones."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4)
    which = rng.randint(0, 4, n)
    cat = rng.randint(1, 12, n)
    C = np.zeros((n, 4))
    C[np.arange(n), which] = cat
    logit = X[:, 0] - 0.5 * X[:, 1] + 1.5 * rng.randn(4, 12)[which, cat]
    y = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float64)
    return np.hstack([X, C]), y


@pytest.mark.parametrize("growth", _GROWTHS)
def test_categorical_efb_training_matches_jax(growth):
    """Bundled categorical columns: the same bundle layout as the JAX
    package's, its trees on every grower (a categorical decision decodes
    its bin from the bundle column first), and on the wave grower the
    valid routing through K3's bundle leg with the bitsets (its plain
    version)."""
    X, y = make_cat_efb_data()
    cats = [4, 5, 6, 7]
    jd = lj.Dataset(X, label=y, categorical_feature=cats,
                    params=BASE).construct()._binned
    td = lt.Dataset(X, label=y, categorical_feature=cats,
                    params=BASE).construct()._binned
    assert td.bundle_layout is not None and jd.bundle_layout is not None
    for f in ("bundle_of", "offset", "is_bundled", "bundle_nbins"):
        np.testing.assert_array_equal(getattr(td.bundle_layout, f),
                                      getattr(jd.bundle_layout, f))
    seen = []
    real = fused_cuda.route_rows_ref

    def spy(*a, **k):
        seen.append((a[7] if len(a) > 7 else k.get("bundle"),
                     a[8] if len(a) > 8 else k.get("cat")))
        return real(*a, **k)

    fused_cuda.route_rows_ref = spy
    try:
        p = dict(BASE, tree_growth=growth)
        if growth == "leafwise":
            p["leafwise_wave_size"] = 4
        Xv, yv = make_cat_efb_data(1000, seed=1)
        jb = lj.train(p, lj.Dataset(X, label=y, categorical_feature=cats),
                      5, verbose_eval=False)
        saved = tgrower.root_sums
        if growth == "leafwise_serial":
            tgrower.root_sums = _row_order_root_sums
        try:
            ds = lt.Dataset(X, label=y, categorical_feature=cats)
            tb = lt.train(p, ds, 5, device="cpu",
                          valid_sets=[lt.Dataset(Xv, label=yv,
                                                 reference=ds)])
        finally:
            tgrower.root_sums = saved
    finally:
        fused_cuda.route_rows_ref = real
    assert tb._gbdt._bundle is not None
    assert _assert_same_trees(jb, tb) >= 1
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1.5e-5)
    if growth == "leafwise":
        assert len(seen) == 5 and all(b is not None and c is not None
                                      for b, c in seen)


# ---------------------------------------------------------------------------
# model text, serving, conversion, the Dataset surface
# ---------------------------------------------------------------------------

def test_model_text_round_trip_and_unseen_categories(tmp_path):
    """A port-trained categorical model's text has the v3 categorical
    fields, loads and predicts the same; unseen, negative and NaN
    categories go right (JAX test_categorical_unseen_goes_right); the
    raw walk equals the training walk on the bins."""
    X, y = make_cat_problem()
    b = lt.train(dict(BASE, max_cat_to_onehot=4),
                 lt.Dataset(X, label=y, categorical_feature=[0]), 10,
                 device="cpu")
    path = str(tmp_path / "cat.txt")
    b.save_model(path)
    text = open(path).read()
    assert "num_cat=" in text and "cat_boundaries=" in text \
        and "cat_threshold=" in text
    infos = next(line for line in text.splitlines()
                 if line.startswith("feature_infos=")).split("=")[1].split()
    assert infos[0] == ":".join(
        str(c) for c in b._gbdt.train_set.bin_mappers[0].bin_2_categorical)
    loaded = lt.Booster(model_file=path, device="cpu")
    np.testing.assert_allclose(loaded.predict(X), b.predict(X), rtol=1e-6,
                               atol=1e-7)
    assert loaded.model_to_string() == b.model_to_string()
    for v in (99.0, -2.0, np.nan):
        Xu = X.copy()
        Xu[:, 0] = v
        p_u = b.predict(Xu)
        Xr = X.copy()
        Xr[:, 0] = 12.0                  # never seen either: right
        np.testing.assert_allclose(p_u, b.predict(Xr), rtol=1e-6)


def test_conversion_of_a_jax_categorical_model():
    """A JAX-trained categorical model carried across (``convert``): its
    host trees (raw-category sets) predict as the JAX model does, its bin
    mappers bin as the JAX ones, and its grown trees walk the bins as the
    port's own walk does."""
    X, y = make_cat_data(2000, seed=5)
    jb = lj.train(BASE, lj.Dataset(X, label=y, categorical_feature=[0, 1]),
                  4, verbose_eval=False)
    jg = jb._gbdt
    hosts = jg.materialize_host_trees()
    fields = []
    for t in hosts:
        d = {k: getattr(t, k) for k in HostTree.FIELDS}
        d.update(num_leaves=t.num_leaves, is_cat=t.is_cat,
                 cat_bitset=t.cat_bitset, cat_sets=t.cat_sets,
                 shrinkage=t.shrinkage)
        fields.append(d)
    trees = convert.host_trees_from_numpy(fields, 1, X.shape[1])
    got = sum(t.predict(X) for t in trees)
    np.testing.assert_allclose(got, jb.predict(X, raw_score=True),
                               rtol=1e-6, atol=1e-6)
    mappers = convert.bin_mappers_from_numpy(
        [m.to_arrays() for m in jg.train_set.bin_mappers])
    for j, m in enumerate(mappers):
        np.testing.assert_array_equal(m.value_to_bin(X[:, j]),
                                      jg.train_set.bin_mappers[j]
                                      .value_to_bin(X[:, j]))
    jt = jg._device_trees[0]
    c = tree_arrays_from_numpy(jax.device_get(jt)._asdict())
    assert bool(c.is_cat.any())
    tb = torch.as_tensor(np.asarray(jg.train_set.binned))
    nanb = torch.as_tensor(np.asarray(jg.train_set.nan_bins)).long()
    mt = torch.as_tensor(np.asarray(jg.train_set.missing_types)).long()
    zb = torch.as_tensor(np.asarray(jg.train_set.zero_bins)).long()
    from lightgbmv1_tpu.models.tree import tree_leaf_index_binned as jleaf
    want = np.asarray(jleaf(jt, jnp.asarray(jg.train_set.binned),
                            jnp.asarray(jg.train_set.nan_bins),
                            jnp.asarray(jg.train_set.missing_types),
                            zero_bins=jnp.asarray(jg.train_set.zero_bins)))
    np.testing.assert_array_equal(
        tree_leaf_index_binned(c, tb, nanb, mt, zb).numpy(), want)


def test_dataset_categorical_by_name_knob_and_two_round(tmp_path):
    """``categorical_feature`` by feature name, by the params knob (its
    alias ``cat_feature``) and through a two-round file load bins the
    same categorical columns as by index."""
    X, y = make_cat_data(1500, seed=2)
    names = [f"f{i}" for i in range(X.shape[1])]
    by_idx = lt.Dataset(X, label=y, categorical_feature=[0, 2]).construct()
    by_name = lt.Dataset(X, label=y, feature_name=names,
                         categorical_feature=["f0", "f2"]).construct()
    by_knob = lt.Dataset(X, label=y,
                         params={"cat_feature": "0,2"}).construct()
    for d in (by_name, by_knob):
        np.testing.assert_array_equal(d._binned.binned, by_idx._binned.binned)
        np.testing.assert_array_equal(d._binned.is_categorical,
                                      by_idx._binned.is_categorical)
    path = tmp_path / "train.csv"
    np.savetxt(path, np.column_stack([y, np.nan_to_num(X, nan=0.0)]),
               delimiter=",", fmt="%.10g")
    mem = lt.Dataset(np.nan_to_num(X, nan=0.0), label=y,
                     categorical_feature=[0, 2]).construct()
    two = lt.Dataset(str(path), params={"two_round": True},
                     categorical_feature=[0, 2]).construct()
    assert two._binned.is_categorical.tolist() == \
        mem._binned.is_categorical.tolist()
    np.testing.assert_array_equal(two._binned.binned, mem._binned.binned)


def test_categorical_refusals_keep_the_jax_reasons():
    """The fused family refuses categorical data with the JAX gate's
    reason (JAX wave_fused.py:1370-1371); categorical features beside
    int16 bins raise naming their ROADMAP item."""
    X, y = make_cat_problem(800)
    with pytest.raises(NotImplementedError,
                       match="categorical sorted-scan .per-feature argsort. "
                             "has no kernel lowering"):
        lt.train(dict(BASE, hist_method="fused"),
                 lt.Dataset(X, label=y, categorical_feature=[0]), 1,
                 device="cpu")
    with pytest.raises(NotImplementedError,
                       match="categorical features with int16 bins$"):
        lt.train(dict(BASE, max_bin=300),
                 lt.Dataset(np.column_stack([X, np.arange(800.0)]), label=y,
                            categorical_feature=[0],
                            params={"max_bin": 300}), 1, device="cpu")
