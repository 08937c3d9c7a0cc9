"""The port's sequential and level-wise growers, and its regression,
multiclass and lambdarank training, held against the JAX package's.

Both packages run on the CPU on the same numpy rows: the JAX package with
``hist_method=pallas`` (the Pallas histogram kernel in interpret mode),
the port with ``hist_method=pallas`` (K1's plain version) and
``device="cpu"``.

Tolerances:
* one grown tree from the same (N, 3) rows: identical in structure at
  every node (features, threshold bins, default directions, children),
  leaf counts and every row's leaf exact.  In f32 each leaf value is
  within 2e-5 of max(1, |leaf|) of the exact one (float64 sums of its
  rows), as tests/test_torch_train.py holds the wave grower's binary
  leaves against the JAX package's, and off the JAX leaf by at most the
  JAX leaf's own error plus that: the JAX sequential grower's root sum
  is an ordered f32 fold, and a larger child is its parent minus the
  smaller, so a small leaf deep in the tree inherits its ancestors'
  rounding (up to 7e-5 of the leaf here, where the port's stays under
  5e-6); in bf16x2 the same structure;
* K1 at one slot (``hist_one_leaf``): counts exact, cells within
  ``4e-6 * sum(|v|) + 1e-7`` of the JAX kernel's, as test_torch_hist.py;
* whole trainings: the same trees, leaves within 2e-5 (multiclass 5e-5:
  a softmax row's K gradients each carry their own rounding), the
  per-iteration valid metric within 1e-6 (ndcg exact: both rank the same
  scores to 2e-5 and no ranking flips here), predictions of the saved
  model equal in the JAX ``Booster``;
* the reference C++ golden ``golden_regtrain_pred.txt`` within
  ``rtol=1e-5, atol=1e-6``, as tests/test_golden_compat.py holds the JAX
  package.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightgbmv1_tpu as lj
from lightgbmv1_tpu.config import Config as JConfig
from lightgbmv1_tpu.io.dataset import BinnedDataset as JDataset
from lightgbmv1_tpu.models.tree import tree_leaf_index_binned as jwalk
from lightgbmv1_tpu.ops import split as jsplit
from lightgbmv1_tpu.ops.histogram import hist_one_leaf as jhist_one_leaf
from lightgbmv1_tpu.parallel.trainer import build_trainer as jbuild_trainer

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.io.dataset import BinnedDataset
from lightgbmv1_tpu_torch.models import grower as tgrower
from lightgbmv1_tpu_torch.models.convert import tree_arrays_from_numpy
from lightgbmv1_tpu_torch.models.tree import tree_leaf_index_binned
from lightgbmv1_tpu_torch.ops import hist_cuda
from lightgbmv1_tpu_torch.ops import split as tsplit
from lightgbmv1_tpu_torch.ops.histogram import hist_one_leaf
from lightgbmv1_tpu_torch.parallel.trainer import build_trainer

DATA = os.path.join(os.path.dirname(__file__), "data")
N, F = 2048, 6
CPU = torch.device("cpu")
BASE = {"min_data_in_leaf": 5, "verbosity": -1, "max_bin": 63,
        "hist_method": "pallas", "hist_dtype": "f32"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed, n=N):
    """NaNs (feature 0), 30% zeros (2), a coarse integer feature (3),
    feature 5 a copy of 4; a continuous target."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n) < 0.05, 0] = np.nan
    X[rng.rand(n) < 0.30, 2] = 0.0
    X[:, 3] = np.round(X[:, 3] * 2)
    X[:, 5] = X[:, 4]
    z = (1.2 * np.nan_to_num(X[:, 0]) - X[:, 1] + 0.6 * X[:, 2] * X[:, 3]
         + 0.4 * X[:, 4] + rng.randn(n))
    return X, z


def _rows(seed, n=N):
    """(n, 3) f32 [grad, hess, count] rows with varied hessians."""
    rng = np.random.RandomState(seed)
    g3 = np.stack([rng.randn(n), rng.rand(n) * 0.5 + 0.05, np.ones(n)],
                  axis=1)
    return g3.astype(np.float32)


def _assert_same_tree(jt, tt, leaf_tol):
    c = tree_arrays_from_numpy(jax.device_get(jt)._asdict())
    n = int(c.num_leaves)
    assert n == int(tt.num_leaves) > 1
    for f in ("split_feature", "threshold_bin", "default_left",
              "missing_type", "left_child", "right_child"):
        assert torch.equal(getattr(c, f)[:n - 1], getattr(tt, f)[:n - 1]), f
    assert torch.equal(c.leaf_parent[:n], tt.leaf_parent[:n])
    assert torch.equal(c.leaf_count[:n], tt.leaf_count[:n])
    np.testing.assert_allclose(tt.leaf_value[:n].numpy(),
                               c.leaf_value[:n].numpy(), rtol=leaf_tol,
                               atol=leaf_tol)
    return n


def _assert_exact_leaves(jt, tt, tleaf, g3, params, tol=2e-5):
    """Each leaf value against the float64 leaf output of its rows, and
    against the JAX leaf within the JAX leaf's own error plus ``tol``."""
    c = tree_arrays_from_numpy(jax.device_get(jt)._asdict())
    n = int(tt.num_leaves)
    G = np.bincount(tleaf, weights=g3[:, 0].astype(np.float64), minlength=n)
    H = np.bincount(tleaf, weights=g3[:, 1].astype(np.float64), minlength=n)
    l1, l2 = params.get("lambda_l1", 0.0), params.get("lambda_l2", 0.0)
    exact = -np.sign(G) * np.maximum(np.abs(G) - l1, 0.0) / (H + l2)
    got = tt.leaf_value[:n].numpy().astype(np.float64)
    jax_leaf = c.leaf_value[:n].numpy().astype(np.float64)
    bound = tol * np.maximum(1.0, np.abs(exact))
    assert (np.abs(got - exact) <= bound).all()
    assert (np.abs(got - jax_leaf) <= np.abs(jax_leaf - exact) + bound).all()


# ---------------------------------------------------------------------------
# one tree from the same rows
# ---------------------------------------------------------------------------

_GROWERS = {
    "seq-partition": {"num_leaves": 7},
    "seq-masked": {"num_leaves": 7, "tree_growth": "leafwise_masked"},
    "seq-serial-15": {"num_leaves": 15, "tree_growth": "leafwise_serial"},
    "seq-poolfree": {"num_leaves": 7, "histogram_pool_size": 0.001},
    "seq-masked-poolfree": {"num_leaves": 7, "histogram_pool_size": 0.001,
                            "tree_growth": "leafwise_masked"},
    "seq-depth": {"num_leaves": 15, "tree_growth": "leafwise_serial",
                  "max_depth": 3},
    "seq-regularized": {"num_leaves": 7, "lambda_l1": 0.3,
                        "lambda_l2": 2.0, "min_gain_to_split": 0.05,
                        "min_sum_hessian_in_leaf": 2.0},
    "level": {"tree_growth": "levelwise", "num_leaves": 31},
    "level-budget": {"tree_growth": "levelwise", "num_leaves": 13},
    "level-depth": {"tree_growth": "levelwise", "num_leaves": 63,
                    "max_depth": 4},
    "level-bf16x2": {"tree_growth": "levelwise", "num_leaves": 31,
                     "hist_dtype": "bf16x2"},
    "seq-bf16x2": {"num_leaves": 7, "hist_dtype": "bf16x2"},
}


def _grow_both(params, seed=20):
    X, _ = _data(seed)
    p = dict(BASE, enable_bundle=False, **params)
    jcfg, tcfg = JConfig.from_dict(dict(p)), Config.from_dict(dict(p))
    jds = JDataset.from_numpy(X, config=jcfg)
    tds = BinnedDataset.from_numpy(X, config=tcfg)
    sp = dict(lambda_l1=tcfg.lambda_l1, lambda_l2=tcfg.lambda_l2,
              min_data_in_leaf=float(tcfg.min_data_in_leaf),
              min_sum_hessian_in_leaf=tcfg.min_sum_hessian_in_leaf,
              min_gain_to_split=tcfg.min_gain_to_split)
    jmeta = jsplit.make_feature_meta(jds)
    jgrow, jbinned, _ = jbuild_trainer(jcfg, jds.binned, jmeta,
                                       jsplit.SplitParams(**sp),
                                       jds.padded_bin)
    tmeta = tsplit.make_feature_meta(tds, CPU)
    tgrow = build_trainer(tcfg, tmeta, tsplit.SplitParams(**sp),
                          tds.padded_bin, CPU)
    assert not getattr(tgrow, "routes_valids", False)
    g3 = _rows(seed + 1)
    jt, jleaf, jroot = jgrow(jbinned, jnp.asarray(g3),
                             jnp.ones(F, bool), jax.random.PRNGKey(0))
    tt, tleaf, troot = tgrow(torch.from_numpy(tds.binned),
                             torch.from_numpy(g3),
                             torch.ones(F, dtype=torch.bool))
    return jt, np.asarray(jleaf), tt, tleaf.numpy(), tds


@pytest.mark.parametrize("name", sorted(_GROWERS))
def test_grower_matches_jax(name):
    params = _GROWERS[name]
    jt, jleaf, tt, tleaf, _ = _grow_both(params)
    n = _assert_same_tree(jt, tt, np.inf)
    np.testing.assert_array_equal(tleaf, jleaf)
    assert n == len(np.unique(tleaf))
    if params.get("hist_dtype", "f32") == "f32":
        _assert_exact_leaves(jt, tt, tleaf, _rows(21), params)
    if "max_depth" in params:
        from lightgbmv1_tpu_torch.models.tree import (host_tree_depth,
                                                      host_tree_from_arrays)
        assert host_tree_depth(host_tree_from_arrays(tt)) \
            <= params["max_depth"]


def test_levelwise_without_subtraction_matches_jax():
    """Above the state cap the port's level-wise grower histograms every
    level whole (one slot a leaf); its trees are the JAX grower's (with
    subtraction at this size) within the same tolerance."""
    saved = tgrower._POOL_AUTO_BYTES
    tgrower._POOL_AUTO_BYTES = 0
    try:
        jt, jleaf, tt, tleaf, _ = _grow_both(_GROWERS["level"])
    finally:
        tgrower._POOL_AUTO_BYTES = saved
    _assert_same_tree(jt, tt, np.inf)
    np.testing.assert_array_equal(tleaf, jleaf)
    _assert_exact_leaves(jt, tt, tleaf, _rows(21), _GROWERS["level"])


def test_k1_call_shapes_of_the_growers(monkeypatch):
    """The sequential grower calls K1 at one slot (the root over every
    row, then one segment a split, gathered at its count); the level-wise
    grower at the whole first level, then at the last level's parents
    plus the dead slot."""
    calls = []
    real = hist_cuda.hist_leaves

    def spy(binned, g3, leaf_id, L, B, precision="bf16x2", live_slots=None,
            **kw):
        calls.append((int(L), int(binned.shape[1]), live_slots))
        return real(binned, g3, leaf_id, L, B, precision, live_slots, **kw)

    monkeypatch.setattr(hist_cuda, "hist_leaves", spy)
    _, _, tt, tleaf, _ = _grow_both({"num_leaves": 7})
    assert [c[0] for c in calls] == [1] * 7
    assert calls[0][1] == N
    counts = np.bincount(tleaf)
    assert all(n < N for _, n, _ in calls[1:]) and sum(
        n for _, n, _ in calls[1:]) < 3 * N
    assert max(counts) < N
    calls.clear()
    _grow_both({"num_leaves": 7, "tree_growth": "leafwise_masked"})
    assert calls == [(1, N, None)] * 7
    calls.clear()
    _, _, tt, _, _ = _grow_both(_GROWERS["level"])
    assert calls[0] == (1, N, None)
    assert [(L, live) for L, _, live in calls[1:]] == [
        (2, 1), (3, 2), (5, 4), (9, 8)]


def test_hist_one_leaf_matches_jax():
    """K1 at one slot over the rows of one leaf, the port's plain version
    against the Pallas kernel in interpret mode."""
    rng = np.random.RandomState(7)
    binned = rng.randint(0, 64, size=(F, 1777)).astype(np.uint8)
    g3 = _rows(8, 1777)
    g3[:, 0] *= 3
    leaf = rng.randint(0, 4, 1777).astype(np.int32)
    for prec in ("f32", "bf16", "bf16x2"):
        want = np.asarray(jhist_one_leaf(
            jnp.asarray(binned), jnp.asarray(g3), jnp.asarray(leaf), 2, 64,
            method="pallas", precision=prec, interpret=True))
        got = hist_one_leaf(torch.from_numpy(binned), torch.from_numpy(g3),
                            torch.from_numpy(leaf), 2, 64, method="pallas",
                            precision=prec).numpy()
        mask = (leaf == 2)[:, None]
        absum = hist_one_leaf(torch.from_numpy(binned),
                              torch.from_numpy(np.abs(g3) * mask),
                              torch.from_numpy(leaf), 2, 64).numpy()
        np.testing.assert_array_equal(got[..., 2], want[..., 2])
        assert got[..., 2].sum() == (leaf == 2).sum() * F
        assert (np.abs(got - want) <= 4e-6 * absum + 1e-7).all()


def test_binned_tree_walk_matches_jax():
    """The valid sets of the sequential and level-wise growers walk each
    tree on their bins: every row's leaf as the JAX walk's (NaN and
    zero-as-missing rows included)."""
    jt, _, tt, tleaf, tds = _grow_both(dict(_GROWERS["level"],
                                            zero_as_missing=True))
    Xv, _ = _data(30, 500)
    tv = BinnedDataset.from_numpy(Xv, reference=tds)
    meta = tsplit.make_feature_meta(tds, CPU)
    got = tree_leaf_index_binned(tt, torch.from_numpy(tv.binned),
                                 meta.nan_bin, meta.missing_type,
                                 meta.zero_bin).numpy()
    want = np.asarray(jwalk(jt, jnp.asarray(tv.binned),
                            jnp.asarray(tds.nan_bins),
                            jnp.asarray(tds.missing_types),
                            zero_bins=jnp.asarray(tds.zero_bins)))
    np.testing.assert_array_equal(got, want)
    # the training rows walk to the leaves the grower assigned
    np.testing.assert_array_equal(
        tree_leaf_index_binned(tt, torch.from_numpy(tds.binned),
                               meta.nan_bin, meta.missing_type,
                               meta.zero_bin).numpy(), tleaf)


@pytest.mark.parametrize("L,precision", [(1, "bf16x2"), (65, "bf16x2"),
                                         (65, "f32")])
def test_roworder_plan_at_the_growers_slot_counts(L, precision):
    """The row-order plain version (the card's bit-for-bit reference) at
    the growers' new call shapes: one slot, and 65 slots, where bf16x2
    needs two slot groups; at the headline shape the plans are the ones
    phase 9 holds K1 to."""
    p = hist_cuda.plan(1 << 20, 28, L, 64, precision)
    assert p["groups"] == (2 if (L, precision) == (65, "bf16x2") else 1)
    rng = np.random.RandomState(L)
    n, B = 700, 16
    binned = rng.randint(0, B, size=(2, n)).astype(np.uint8)
    g3 = _rows(L, n)
    leaf = rng.randint(0, L, n).astype(np.int32)
    got = hist_cuda.hist_leaves_roworder_ref(
        torch.from_numpy(binned), torch.from_numpy(g3),
        torch.from_numpy(leaf), L, B, precision).numpy()
    parts = [x.numpy() for x in hist_cuda.split_parts(torch.from_numpy(g3),
                                                       precision)]
    q = hist_cuda.plan(n, 2, L, B, precision)
    # each (chunk, cell) summed in row order from 0, the chunks in order
    tot = np.zeros((q["n_chunks"], L, 2, B, 3 * len(parts)), np.float32)
    for r in range(n):
        ch = r // q["chunk_rows"]
        for f in range(2):
            for k, part in enumerate(parts):
                cell = tot[ch, leaf[r], f, binned[f, r], 3 * k:3 * k + 3]
                cell[:] = (cell + part[r]).astype(np.float32)
    acc = np.zeros((L, 2, B, 3 * len(parts)), np.float32)
    for ch in range(q["n_chunks"]):
        acc = (acc + tot[ch]).astype(np.float32)
    want = acc[..., :3] if len(parts) == 1 else \
        (acc[..., :3] + acc[..., 3:]).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_fused_on_the_non_wave_growers_raises():
    """hist_method=fused is a wave-round kernel: on the sequential and
    level-wise growers the port raises the JAX package's reason."""
    X, z = _data(40, 512)
    for params, which in (({"num_leaves": 7}, "sequential"),
                          ({"tree_growth": "levelwise"}, "level-wise")):
        with pytest.raises(NotImplementedError,
                           match=f"fused kernel is a wave-round kernel; "
                                 f"this config routes to the {which}"):
            lt.train(dict(BASE, hist_method="fused", **params),
                     lt.Dataset(X, label=z), 1, device="cpu")


# ---------------------------------------------------------------------------
# whole trainings, per family
# ---------------------------------------------------------------------------

def _labels(objective, z):
    if objective in ("multiclass", "multiclassova"):
        return np.digitize(z, [-1.0, 0.0, 1.0]).astype(np.float64)
    if objective == "lambdarank":
        return np.clip(np.round(z / 1.5 + 1), 0, 4)
    return z


_FAMILIES = {
    "regression-default": ({"num_leaves": 7}, "l2"),
    "regression-weighted": ({"objective": "regression", "num_leaves": 15,
                             "metric": "l2,rmse"}, "rmse"),
    "multiclass": ({"objective": "multiclass", "num_class": 4,
                    "num_leaves": 15, "metric": "multi_logloss,multi_error"},
                   "multi_logloss"),
    "multiclassova": ({"objective": "multiclassova", "num_class": 4,
                       "num_leaves": 15}, "multi_logloss"),
    "lambdarank": ({"objective": "lambdarank", "num_leaves": 15,
                    "metric": "ndcg,map", "eval_at": [1, 3, 5]}, "ndcg@3"),
    "lambdarank-sequential": ({"objective": "lambdarank", "num_leaves": 7,
                               "lambdarank_norm": False}, "ndcg@5"),
    "levelwise": ({"tree_growth": "levelwise", "num_leaves": 31}, "l2"),
    "levelwise-multiclass": ({"objective": "multiclass", "num_class": 4,
                              "tree_growth": "levelwise", "num_leaves": 15},
                             "multi_logloss"),
    "leafwise_masked": ({"tree_growth": "leafwise_masked",
                         "num_leaves": 7}, "l2"),
}


def _train_both(params, rounds=3, n=N):
    objective = params.get("objective", "regression")
    X, z = _data(10, n)
    Xv, zv = _data(11, n // 4)
    y, yv = _labels(objective, z), _labels(objective, zv)
    kw, vkw = {}, {}
    if objective == "lambdarank":
        kw, vkw = {"group": [16] * (n // 16)}, {"group": [16] * (n // 64)}
    if params.get("metric") == "l2,rmse":     # weights and init scores
        rng = np.random.RandomState(16)
        kw = dict(weight=rng.rand(n) + 0.5, init_score=rng.randn(n) * 0.3)
        vkw = dict(weight=rng.rand(n // 4) + 0.5,
                   init_score=rng.randn(n // 4) * 0.3)
    p = dict(BASE, **params)
    jev, tev = {}, {}
    jb = lj.train(dict(p), lj.Dataset(X, label=y, **kw), rounds,
                  valid_sets=[lj.Dataset(Xv, label=yv, **vkw)],
                  evals_result=jev, verbose_eval=False)
    tb = lt.train(dict(p), lt.Dataset(X, label=y, **kw), rounds,
                  valid_sets=[lt.Dataset(Xv, label=yv, **vkw)],
                  evals_result=tev, device="cpu")
    return dict(jb=jb, tb=tb, jev=jev, tev=tev, Xv=Xv)


@pytest.fixture(scope="module", params=sorted(_FAMILIES))
def family(request):
    params, metric = _FAMILIES[request.param]
    return request.param, metric, _train_both(params)


def test_family_trees_match_jax(family):
    name, _, run = family
    jtrees = run["jb"]._gbdt._device_trees
    ttrees = run["tb"]._gbdt._device_trees
    K = run["tb"].num_model_per_iteration()
    assert len(jtrees) == len(ttrees) == 3 * K
    tol = 5e-5 if name.startswith(("multiclass", "levelwise-multi")) \
        else 2e-5
    for jt, tt in zip(jtrees, ttrees):
        _assert_same_tree(jt, tt, tol)


def test_family_metrics_match_jax(family):
    name, metric, run = family
    want, got = run["jev"]["valid_0"], run["tev"]["valid_0"]
    assert set(got) == set(want) and metric in got
    for m in got:
        np.testing.assert_allclose(got[m], want[m], rtol=0, atol=1e-6)


def test_family_model_loads_in_jax(family, tmp_path):
    """The saved v3 text loads in the JAX ``Booster`` and predicts what
    the port's own loaded model predicts, converted and raw; the text
    names the objective as the JAX package writes it."""
    name, _, run = family
    path = tmp_path / "model.txt"
    run["tb"].save_model(str(path))
    text = path.read_text()
    jline = [ln for ln in run["jb"].model_to_string().splitlines()
             if ln.startswith("objective=")]
    assert [ln for ln in text.splitlines()
            if ln.startswith("objective=")] == jline
    served = lt.Booster(model_file=str(path), device="cpu")
    jserved = lj.Booster(model_str=text)
    for raw in (False, True):
        np.testing.assert_array_equal(
            jserved.predict(run["Xv"], raw_score=raw),
            served.predict(run["Xv"], raw_score=raw))
    np.testing.assert_allclose(
        served.predict(run["Xv"]), run["tb"].predict(run["Xv"]), rtol=1e-6,
        atol=1e-9)


def test_default_objective_is_regression():
    """``train({}, Dataset(X, y))`` trains regression with its l2 metric
    from the label mean, as the JAX package does."""
    X, z = _data(50, 1024)
    jb = lj.train({"verbosity": -1}, lj.Dataset(X, label=z), 5)
    tb = lt.train({}, lt.Dataset(X, label=z), 5, device="cpu")
    assert tb.config.objective == "regression"
    assert tb._gbdt._init_scores[0] == jb._gbdt._init_scores[0] \
        == pytest.approx(z.mean(), rel=1e-6)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=0,
                               atol=2e-5)


def test_golden_regression_training_parity():
    """tests/test_golden_compat.py::test_regression_training_parity_with_
    init_score for the port: 5 trees trained on the reference's own
    example data with its .init scores predict the reference CLI's raw
    scores."""
    raw = np.loadtxt(os.path.join(DATA, "golden_regtrain.tsv"))
    init = np.loadtxt(os.path.join(DATA, "golden_regtrain.init"))
    X, y = raw[:, 1:], raw[:, 0]
    ref = np.loadtxt(os.path.join(DATA, "golden_regtrain_pred.txt"))
    bst = lt.train({"objective": "regression", "num_leaves": 15,
                    "max_bin": 63, "min_data_in_leaf": 20,
                    "learning_rate": 0.1, "verbosity": -1},
                   lt.Dataset(X, label=y, init_score=init), 5, device="cpu")
    np.testing.assert_allclose(bst.predict(X, raw_score=True), ref,
                               rtol=1e-5, atol=1e-6)


def test_query_groups_must_cover_the_rows():
    """A ranking set's query sizes must sum to its rows; ``set_group`` on
    a constructed set reaches its binned metadata."""
    X, z = _data(60, 64)
    with pytest.raises(ValueError, match="query sizes sum to 60"):
        lt.Dataset(X, label=z, group=[30, 30]).construct()
    ds = lt.Dataset(X, label=z, group=[32, 32]).construct()
    ds.set_group([16] * 4)
    np.testing.assert_array_equal(ds._binned.metadata.query_boundaries,
                                  [0, 16, 32, 48, 64])


def test_golden_zero_as_missing_sequential_parity():
    """tests/test_golden_compat.py::test_zero_as_missing_training_parity
    for the port at the default wave size: 7 leaves route to the
    sequential grower, as in the JAX package, and reproduce the reference
    C++ golden's splits and predictions."""
    raw = np.loadtxt(os.path.join(DATA, "golden_zero_train.tsv"))
    X, y = raw[:, 1:], raw[:, 0]
    ref_pred = np.loadtxt(os.path.join(DATA, "golden_zero_pred.txt"))
    ref = lt.Booster(model_file=os.path.join(DATA, "golden_zero_model.txt"),
                     device="cpu")
    bst = lt.train({"objective": "binary", "num_leaves": 7, "max_bin": 32,
                    "min_data_in_leaf": 20, "learning_rate": 0.2,
                    "zero_as_missing": True, "verbosity": -1},
                   lt.Dataset(X, label=y), 5, device="cpu")
    assert not getattr(bst._gbdt._grow, "routes_valids", False)
    for tr, to in zip(ref._all_trees(), bst._all_trees()):
        np.testing.assert_array_equal(tr.split_feature[:tr.num_leaves - 1],
                                      to.split_feature[:to.num_leaves - 1])
    np.testing.assert_allclose(bst.predict(X), ref_pred, rtol=1e-4,
                               atol=2e-5)


@pytest.mark.parametrize("name,data,num_class", [
    ("multiclass", "multiclass.train", 5), ("lambdarank", "rank.train", 1),
    ("regression", "regression.train", 1)])
def test_golden_family_models_load_and_predict(name, data, num_class):
    """The reference C++ goldens of the three families load in the port
    and predict the reference CLI's outputs (softmax for multiclass), as
    tests/test_golden_compat.py holds the JAX package."""
    from lightgbmv1_tpu.io.parser import load_data_file

    X = load_data_file(os.path.join(DATA, data)).X
    ref = np.loadtxt(os.path.join(DATA, f"golden_{name}_pred.txt"))
    b = lt.Booster(model_file=os.path.join(DATA, f"golden_{name}_model.txt"),
                   device="cpu")
    assert b.num_model_per_iteration() == num_class
    assert b.config.objective == name
    np.testing.assert_allclose(b.predict(X), ref, rtol=1e-9, atol=1e-12)
