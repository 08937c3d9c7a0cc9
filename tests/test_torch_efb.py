"""Exclusive Feature Bundling (EFB) of the port against the JAX package's,
on the CPU (JAX tests/test_efb.py).

The grouping (``find_bundles``), the bundle matrices of dense and CSR
bins and the zero-bin recovery (``expand_bundle_hist``) are the JAX
functions' on the same inputs; the valid routing's bundle leg (K3's plain
version, ``fused_cuda.route_rows_ref(..., bundle=)``) gives the leaf ids
of the JAX package's ``bundle_bins_of_feat`` decode, and those of the
unbundled bins; training on bundle columns grows the JAX package's trees
on every grower (every split identical at ``hist_dtype=f32``) and
predicts within ``rtol=1e-3, atol=1e-4`` of the port's unbundled
training (JAX :98-108: the zero bin of a bundled feature is its parent's
totals less its other bins, in another f32 order than a direct sum).
Sparse input builds the bundle matrix from the CSR triplets and never
the dense (F, N) bins, and trains the dense input's trees.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp
import lightgbmv1_tpu as lj
from lightgbmv1_tpu.config import Config as JConfig
from lightgbmv1_tpu.io import bundle as jbundle
from lightgbmv1_tpu.io.dataset import BinnedDataset as JBinned

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.io import bundle as tbundle
from lightgbmv1_tpu_torch.io.dataset import BinnedDataset
from lightgbmv1_tpu_torch.models.convert import tree_arrays_from_numpy
from lightgbmv1_tpu_torch.ops import fused_cuda
from lightgbmv1_tpu_torch.ops import wave_fused as twf

CPU = torch.device("cpu")
PARAMS = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
          "min_data_in_leaf": 5, "max_bin": 63, "hist_dtype": "f32"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_sparse_problem(n=3000, blocks=5, seed=0, dense=2):
    """``blocks`` groups of 4 mutually exclusive features (one-hot-like,
    JAX test_efb.make_sparse_problem) beside ``dense`` dense features."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, blocks * 4 + dense))
    logit = np.zeros(n)
    for b in range(blocks):
        which = rng.randint(0, 4, n)
        vals = rng.rand(n) + 0.5
        for j in range(4):
            m = which == j
            X[m, b * 4 + j] = vals[m]
            logit += np.where(m, (j - 1.5) * 0.3 * (b % 3 - 1), 0.0)
    X[:, blocks * 4:] = rng.randn(n, dense)
    logit += 0.5 * X[:, -1]
    y = (logit + rng.randn(n) * 0.5 > 0).astype(float)
    return X, y


_MASK_CASES = {
    "exclusive+dense": ([10, 10, 10, 10, 10], 0.0),
    "capacity": ([100, 100, 100, 100, 3], 0.0),
    "conflicts": ([7, 9, 11, 13, 5], 0.1),
}


def _masks(case):
    rng = np.random.RandomState(len(case))
    S = 400
    m = np.zeros((5, S), bool)
    for j in range(4):
        m[j, j * 100:(j + 1) * 100] = True
    if case == "conflicts":
        m[:4] |= rng.rand(4, S) < 0.02
    m[4] = case != "capacity"
    return m


@pytest.mark.parametrize("case", list(_MASK_CASES))
def test_find_bundles_and_apply_match_jax(case):
    """The same layout from the same masks; the dense and CSR bundle
    matrices of the same bins are the JAX package's."""
    nbins, rate = _MASK_CASES[case]
    masks = _masks(case)
    jl = jbundle.find_bundles(masks, nbins, max_conflict_rate=rate)
    tl = tbundle.find_bundles(masks, nbins, max_conflict_rate=rate)
    assert jl is not None and tl is not None
    for f in ("bundle_of", "offset", "is_bundled", "bundle_nbins"):
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f))
    rng = np.random.RandomState(1)
    zb = np.array([0, 1, 0, 2, 0])
    binned = np.where(masks, rng.randint(1, 3, masks.shape),
                      zb[:, None]).astype(np.uint8)
    binned = np.minimum(binned, np.asarray(nbins)[:, None] - 1) \
        .astype(np.uint8)
    np.testing.assert_array_equal(
        tbundle.apply_bundles_dense(binned, zb, tl),
        jbundle.apply_bundles_dense(binned, zb, jl))
    csr = sp.csr_matrix(binned.T.astype(np.float64))
    for args in ((csr.indptr, csr.indices, csr.data.astype(np.int32),
                  masks.shape[1], zb),):
        np.testing.assert_array_equal(
            tbundle.apply_bundles_csr(*args, tl),
            jbundle.apply_bundles_csr(*args, jl))


def _binned_pair(X, y, params=PARAMS):
    jds = JBinned.from_numpy(X, label=y, config=JConfig.from_dict(params))
    tds = BinnedDataset.from_numpy(X, label=y, config=Config.from_dict(params))
    return jds, tds


def test_dense_bundling_matches_jax():
    """The same bins, layout and bundle matrix from the same rows; the
    padded bundle bin axis the histograms take."""
    X, y = make_sparse_problem(1500)
    jds, tds = _binned_pair(X, y)
    assert tds.bundle_layout is not None
    assert tds.bundled.shape[0] < tds.num_features
    np.testing.assert_array_equal(tds.binned, jds.binned)
    np.testing.assert_array_equal(tds.bundled, jds.bundled)
    for f in ("bundle_of", "offset", "is_bundled", "bundle_nbins"):
        np.testing.assert_array_equal(getattr(tds.bundle_layout, f),
                                      getattr(jds.bundle_layout, f))
    assert tds.padded_bundle_bin == jds.padded_bundle_bin
    assert tds.train_matrix is tds.bundled


@pytest.mark.parametrize("C", [1, 3])
def test_expand_bundle_hist_matches_jax(C):
    """A batch of bundle histograms expands to the JAX function's
    per-feature view (C = 1 each), and to the unbundled histograms."""
    X, y = make_sparse_problem(1200)
    jds, tds = _binned_pair(X, y)
    B, Bb = tds.padded_bin, tds.padded_bundle_bin
    N = tds.num_data
    rng = np.random.RandomState(2)
    hists, direct, parents = [], [], []
    for c in range(C):
        g3 = np.stack([rng.randn(N), np.abs(rng.randn(N)),
                       (rng.rand(N) < 0.8).astype(float)],
                      axis=1).astype(np.float32)
        hb = np.zeros((tds.bundled.shape[0], Bb, 3), np.float64)
        ho = np.zeros((tds.num_features, B, 3), np.float64)
        for f in range(tds.bundled.shape[0]):
            for k in range(3):
                hb[f, :, k] = np.bincount(tds.bundled[f], g3[:, k], Bb)
        for f in range(tds.num_features):
            for k in range(3):
                ho[f, :, k] = np.bincount(tds.binned[f], g3[:, k], B)
        hists.append(hb.astype(np.float32))
        direct.append(ho)
        parents.append(g3.astype(np.float64).sum(axis=0).astype(np.float32))
    ba = tbundle.BundleArrays(tds.bundle_layout, tds.zero_bins, tds.num_bins,
                              CPU)
    got = tbundle.expand_bundle_hist(torch.as_tensor(np.stack(hists)),
                                     torch.as_tensor(np.stack(parents)), ba,
                                     B).numpy()
    jba = jbundle.BundleArrays(jds.bundle_layout, jds.zero_bins, jds.num_bins)
    for c in range(C):
        want = np.asarray(jbundle.expand_bundle_hist(
            jnp.asarray(hists[c]), jnp.asarray(parents[c]), jba, B))
        np.testing.assert_allclose(got[c], want, rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(got[c], direct[c], rtol=1e-4, atol=1e-3)


def _random_tree_splits(num_bins, F, rng, P=12):
    """P splits of a random tree in rounds: leaf l of each split, the new
    leaf, feature, threshold, default-left; round bounds."""
    leafs, nls, nl = [], [], 1
    for _ in range(P):
        leafs.append(int(rng.randint(0, nl)))
        nls.append(nl)
        nl += 1
    feats = rng.randint(0, F, P)
    thrs = np.array([rng.randint(0, max(int(num_bins[f]) - 1, 1))
                     for f in feats])
    dls = rng.rand(P) < 0.5
    return leafs, nls, feats, thrs, dls, nl


def lt_meta(ds):
    from lightgbmv1_tpu_torch.ops.split import make_feature_meta

    return make_feature_meta(ds, CPU)


def test_route_bundle_leg_matches_jax_decode():
    """K3's bundle leg (its plain version) routes the bundle columns to
    the leaf ids of the JAX package's ``bundle_bins_of_feat`` decode,
    and to those of the unbundled bins (u8 leg), round after round."""
    X, y = make_sparse_problem(1000)
    jds, tds = _binned_pair(X, y)
    rng = np.random.RandomState(5)
    leafs, nls, feats, thrs, dls, L = _random_tree_splits(tds.num_bins,
                                                          tds.num_features,
                                                          rng)
    meta_t = lt_meta(tds)
    ba = tbundle.BundleArrays(tds.bundle_layout, tds.zero_bins, tds.num_bins,
                              CPU)
    t = dict(feats=torch.as_tensor(feats), thrs=torch.as_tensor(thrs),
             dls=torch.as_tensor(dls), leafs=torch.as_tensor(leafs),
             nls=torch.as_tensor(nls))
    # one split a round: a leaf's split needs the leaf to exist already
    offsets = torch.arange(len(leafs) + 1, dtype=torch.int32)
    N = tds.num_data
    lids0 = torch.zeros(N, dtype=torch.int32)
    got = twf.fused_route_rows([(torch.as_tensor(tds.bundled), lids0)],
                               num_leaves=L, meta=meta_t, offsets=offsets,
                               bundle=ba, **t)[0]
    plain = twf.fused_route_rows([(torch.as_tensor(tds.binned), lids0)],
                                 num_leaves=L, meta=meta_t, offsets=offsets,
                                 **t)[0]
    # the JAX decode, applied split by split
    jba = jbundle.BundleArrays(jds.bundle_layout, jds.zero_bins, jds.num_bins)
    lid = np.zeros(N, np.int64)
    for p in range(len(leafs)):
        f = int(feats[p])
        b = np.asarray(jbundle.bundle_bins_of_feat(
            jnp.asarray(jds.bundled), jnp.int32(f), jba))
        mt = int(tds.missing_types[f])
        na = ((mt == 2) & (b == tds.nan_bins[f])) | (
            (mt == 1) & (b == tds.zero_bins[f]))
        gl = np.where(na, dls[p], b <= thrs[p])
        lid = np.where((lid == leafs[p]) & ~gl, nls[p], lid)
    np.testing.assert_array_equal(got.numpy(), lid)
    assert torch.equal(got, plain)


_GROWTHS = ["leafwise", "leafwise_serial", "levelwise"]


def _trained(growth, **extra):
    X, y = make_sparse_problem()
    p = dict(PARAMS, tree_growth=growth, **extra)
    if growth == "leafwise":
        p["leafwise_wave_size"] = 4
    jb = lj.train(p, lj.Dataset(X, label=y), 5, verbose_eval=False)
    tb = lt.train(p, lt.Dataset(X, label=y), 5, device="cpu")
    return X, jb, tb, p


@pytest.mark.parametrize("growth", _GROWTHS)
def test_efb_training_matches_jax(growth):
    """EFB training on each grower: the JAX package's trees split for
    split, and predictions within 1e-3 / 1e-4 of unbundled training."""
    X, jb, tb, p = _trained(growth)
    assert tb._gbdt._bundle is not None and jb._gbdt._bundle is not None
    jtrees = jax.device_get(jb._gbdt._device_trees)
    for jt, tt in zip(jtrees, tb._gbdt._device_trees):
        carried = tree_arrays_from_numpy(jt._asdict())
        n = int(carried.num_leaves)
        assert n == int(tt.num_leaves) > 1
        for f in ("split_feature", "threshold_bin", "default_left",
                  "left_child", "right_child"):
            assert torch.equal(getattr(carried, f)[:n - 1],
                               getattr(tt, f)[:n - 1]), f
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=2e-5)
    _, y = make_sparse_problem()
    plain = lt.train(dict(p, enable_bundle=False), lt.Dataset(X, label=y), 5,
                     device="cpu")
    np.testing.assert_allclose(tb.predict(X), plain.predict(X), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("mode", ["sub", "pool-free"])
def test_efb_int8sr_keeps_the_dequantized_route(mode, monkeypatch):
    """Quantized rounds' bundle histograms are dequantized before they are
    expanded (in the subtraction, or pool-free before the scan, which then
    takes no scale under EFB: JAX trainer.py:928-930), and the trees are
    the JAX package's EFB int8sr trees (the slot buckets forced at this
    row count in both packages)."""
    from lightgbmv1_tpu.models import grower_wave as jgw

    from lightgbmv1_tpu_torch.models import grower, grower_wave
    from lightgbmv1_tpu_torch.parallel import trainer as ttrainer

    seen, quant = [], []
    orig_view, orig_quant = grower.scan_view, ttrainer.hist_wave_quant

    def spy_view(hist, sums, bundle, num_bins, hist_scale=None):
        out = orig_view(hist, sums, bundle, num_bins, hist_scale)
        seen.append((hist_scale is not None, out[1] is None))
        return out

    def spy_quant(*a, **k):
        quant.append(1)
        return orig_quant(*a, **k)

    monkeypatch.setattr(grower_wave, "scan_view", spy_view)
    monkeypatch.setattr(ttrainer, "hist_wave_quant", spy_quant)
    for m in (grower_wave, jgw):
        monkeypatch.setattr(m, "_BUCKET_MIN_N", 1)
        if mode == "pool-free":
            monkeypatch.setattr(m, "_SUB_STATE_CAP_BYTES", 0)
    X, y = make_sparse_problem(3000)
    p = dict(PARAMS, num_leaves=80, hist_dtype_deep="int8sr",
             hist_method="pallas", min_data_in_leaf=2)
    tb = lt.train(p, lt.Dataset(X, label=y), 2, device="cpu")
    jb = lj.train(p, lj.Dataset(X, label=y), 2, verbose_eval=False)
    assert tb._gbdt._bundle is not None and quant
    assert all(after for _, after in seen)
    assert any(q for q, _ in seen) == (mode == "pool-free")
    for jt, tt in zip(jb._all_trees(), tb._all_trees()):
        n = tt.num_leaves
        assert n == jt.num_leaves > 1
        np.testing.assert_array_equal(tt.split_feature[:n - 1],
                                      jt.split_feature[:n - 1])
        np.testing.assert_array_equal(tt.threshold_bin[:n - 1],
                                      jt.threshold_bin[:n - 1])


def test_csr_input_never_densifies():
    """CSR rows bin into the bundle matrix with no dense (F, N) bins; the
    bins, layout and trees are the dense input's (and the JAX package's
    CSR construction's)."""
    X, y = make_sparse_problem(2000)
    csr = sp.csr_matrix(X)
    ds = lt.Dataset(csr, label=y, params=dict(PARAMS)).construct()
    assert ds._binned.binned is None and ds._binned.bundled is not None
    dense = lt.Dataset(X, label=y, params=dict(PARAMS)).construct()
    jcsr = lj.Dataset(csr, label=y, params=dict(PARAMS)).construct()
    np.testing.assert_array_equal(ds._binned.bundled,
                                  jcsr._binned.bundled)
    a = lt.train(PARAMS, ds, 4, device="cpu")
    b = lt.train(PARAMS, dense, 4, device="cpu")
    for ta, tb_ in zip(a._all_trees(), b._all_trees()):
        np.testing.assert_array_equal(ta.split_feature, tb_.split_feature)
        np.testing.assert_array_equal(ta.threshold_bin, tb_.threshold_bin)
    np.testing.assert_allclose(a.predict(X), b.predict(X), rtol=0,
                               atol=1e-6)
    # a CSR set with nothing to bundle is the plain matrix
    dn = lt.Dataset(sp.csr_matrix(np.random.RandomState(3).randn(300, 4)),
                    label=np.zeros(300), params=dict(PARAMS)).construct()
    assert dn._binned.bundled is None and dn._binned.binned.shape == (4, 300)


@pytest.mark.parametrize("form", ["dense", "csr", "unreferenced"])
def test_valid_set_takes_the_training_layout(form):
    """A valid set is bundled with the training layout (by reference, or
    re-bundled from its dense bins when built alone), its K3 routing
    gives the tree walk's leaves, and its metric is the JAX package's."""
    X, y = make_sparse_problem(3000)
    Xv, yv = make_sparse_problem(800, seed=4)
    p = dict(PARAMS, metric="auc")
    out = []
    for pkg, kw in ((lj, {"verbose_eval": False}), (lt, {"device": "cpu"})):
        ds = pkg.Dataset(X, label=y)
        data = sp.csr_matrix(Xv) if form == "csr" else Xv
        dv = (pkg.Dataset(data, label=yv) if form == "unreferenced"
              else pkg.Dataset(data, label=yv, reference=ds))
        ev = {}
        b = pkg.train(p, ds, 4, valid_sets=[dv], evals_result=ev, **kw)
        out.append((b, ev["valid_0"]["auc"], dv))
    (jb, jauc, _), (tb, tauc, tdv) = out
    assert tdv._binned.bundle_layout is tb._gbdt.train_set.bundle_layout
    np.testing.assert_allclose(tauc, jauc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb._gbdt.raw_valid_scores(0)[:, 0],
                               tb.predict(Xv, raw_score=True), rtol=0,
                               atol=1e-5)


def test_bundle_refusals():
    """The fused family refuses EFB with the JAX reason; packed bins are
    not stored for bundles."""
    X, y = make_sparse_problem(1000)
    with pytest.raises(NotImplementedError,
                       match="EFB bundle-space histograms"):
        lt.train(dict(PARAMS, hist_method="fused"), lt.Dataset(X, label=y),
                 1, device="cpu")
    b = lt.train(dict(PARAMS, max_bin=15, bin_layout="packed4",
                      hist_method="pallas"), lt.Dataset(X, label=y), 1,
                 device="cpu")
    assert not b._gbdt._packed and b._gbdt._bundle is not None


def test_bundle_launch_count_is_its_own():
    """On the CPU the bundle leg's plain version runs (counted plain);
    the bundle leg's launch counter starts at 0 and resets."""
    fused_cuda.bundle_launch_counts["route_rows"] = 3
    fused_cuda.reset_launch_counts()
    assert fused_cuda.bundle_launch_counts == {"route_rows": 0}
