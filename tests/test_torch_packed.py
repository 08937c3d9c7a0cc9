"""4-bit packed bins (``bin_layout=packed4``) in the port, held against
the JAX package's packed path and against the port's own byte bins.

On the CPU the port's wrappers compute their plain versions: K1's unpacks
(``hist_cuda.unpack4bit``) and runs the u8 plain version, K2's and K6's
unpack too, K3's decodes the decision bins' nibbles.  Here they are held
to the JAX package's packed kernels run in Pallas interpret mode (as
tests/test_wave_fused.py runs them) on the same numpy inputs.  The CUDA
kernels' packed legs are held to their u8 legs and plain versions on the
card by chip_smoke.py (phases 26-27).

Tolerances:
* the packed layout, routing (leaf ids, labels) and the split counts:
  exact;
* against the port's u8 bins: bit for bit everywhere (histograms, rounds,
  loops, model texts), since every cell takes the same rows in the same
  order;
* against the JAX package: the tolerances of tests/test_torch_hist.py
  (cells within ``4e-6`` of their absolute sum plus 1e-7),
  tests/test_torch_fused.py (picks identical, gains and sums within
  ``4e-6`` of their mass plus 1e-6) and tests/test_torch_wave_loop.py;
  trainings: structure identical, leaf values and predictions within
  2e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightgbmv1_tpu as lj
from lightgbmv1_tpu.config import Config as JaxConfig
from lightgbmv1_tpu.ops import hist_pallas as jhp
from lightgbmv1_tpu.ops import split as jsplit
from lightgbmv1_tpu.ops import wave_fused as jwf
from lightgbmv1_tpu.parallel import trainer as jtrainer

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.models.convert import tree_arrays_from_numpy
from lightgbmv1_tpu_torch.ops import hist_cuda, loop_cuda
from lightgbmv1_tpu_torch.ops import split as tsplit
from lightgbmv1_tpu_torch.ops import wave_fused as twf
from lightgbmv1_tpu_torch.ops.histogram import hist_frontier
from lightgbmv1_tpu_torch.parallel import trainer as ttrainer

import test_torch_fused as tfused
import test_torch_wave_loop as tloop

CPU = torch.device("cpu")
PRECISIONS = ("f32", "bf16", "bf16x2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op pool, and
    beside other pytest workers its spinning threads starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pack(a: np.ndarray) -> np.ndarray:
    return hist_cuda.pack4bit(torch.from_numpy(a)).numpy()


# ---------------------------------------------------------------------------
# (a) the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("F", [1, 2, 7, 8])
def test_pack4bit_is_the_jax_layout(F):
    """pack4bit's bytes are the JAX package's, an odd F's phantom hi
    nibble is 0, unpack4bit inverts it, and the nibble decoders give the
    JAX package's bins."""
    rng = np.random.RandomState(F)
    a = rng.randint(0, 16, (F, 333)).astype(np.uint8)
    p = _pack(a)
    np.testing.assert_array_equal(p, jhp.pack4bit(a))
    assert p.shape == (-(-F // 2), 333) and p.dtype == np.uint8
    if F % 2:
        assert not (p[-1] >> 4).any()
    tp = torch.from_numpy(p)
    np.testing.assert_array_equal(hist_cuda.unpack4bit(tp, F).numpy(), a)
    for f in range(F):
        got = hist_cuda.packed_bins_of_feat(tp, torch.tensor(f)).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jhp.packed_bins_of_feat(jnp.asarray(p), f)))
        np.testing.assert_array_equal(got, a[f])
    f_row = rng.randint(0, F, 333)
    got = hist_cuda.packed_bins_of_rows(tp, torch.from_numpy(f_row)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jhp.packed_bins_of_rows(
        jnp.asarray(p), jnp.asarray(f_row, jnp.int32))))
    np.testing.assert_array_equal(got, a[f_row, np.arange(333)])


# ---------------------------------------------------------------------------
# (b) K1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("F", [6, 7])
def test_k1_packed_matches_jax(F, precision):
    """K1's packed plain version against the JAX packed Pallas kernel:
    counts exact, cells within 4e-6 of their absolute sum; bit for bit
    the port's u8 histogram of the unpacked bytes, in both plain
    versions."""
    L, B, N = 5, 16, 1777
    rng = np.random.RandomState(F)
    binned = rng.randint(0, B, (F, N)).astype(np.uint8)
    g3 = rng.randn(N, 3).astype(np.float32)
    g3[:, 1] = np.abs(g3[:, 1]) * 0.25
    g3[:, 2] = (rng.rand(N) < 0.9).astype(np.float32)
    leaf = rng.randint(0, L, N).astype(np.int32)
    leaf[rng.rand(N) < 0.02] = -1
    p = _pack(binned)
    want = np.asarray(jhp.hist_leaves_pallas(
        jnp.asarray(p), jnp.asarray(g3), jnp.asarray(leaf), L, B,
        precision=precision, interpret=True, packed=True, num_features=F))
    t = torch.from_numpy
    pk = dict(packed=True, num_features=F)
    got = hist_cuda.hist_leaves(t(p), t(g3), t(leaf), L, B, precision, **pk)
    assert got.shape == want.shape == (L, F, B, 3)
    np.testing.assert_array_equal(got[..., 2].numpy(), want[..., 2])
    absum = hist_cuda.index_add_hist(t(binned), [t(np.abs(g3))], t(leaf), L,
                                     B).numpy()
    assert (np.abs(got.numpy() - want) <= 4e-6 * absum + 1e-7).all()
    u8 = hist_cuda.hist_leaves(t(binned), t(g3), t(leaf), L, B, precision)
    assert torch.equal(got, u8)
    row = hist_cuda.hist_leaves_roworder_ref(t(p), t(g3), t(leaf), L, B,
                                             precision, **pk)
    assert torch.equal(row, hist_cuda.hist_leaves_roworder_ref(
        t(binned), t(g3), t(leaf), L, B, precision))


def test_packed_bins_need_the_kernel_method_and_their_shape():
    """Only pallas reads packed bins (the scatter oracle refuses them, as
    in the JAX package), and the kernels' shape check refuses a packed
    matrix of another width than ceil(F/2) bytes."""
    p = torch.zeros((4, 10), dtype=torch.uint8)
    g3 = torch.zeros((10, 3))
    lid = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="pallas"):
        hist_frontier(p, g3, lid, 1, 16, method="scatter", packed=True,
                      num_features=7)
    with pytest.raises(ValueError, match="ceil"):
        hist_cuda.check_bins(p, True, 9)
    assert hist_cuda.check_bins(p, True, 7) == (4, 10)
    assert hist_cuda.check_bins(p, True, 8) == (4, 10)


# ---------------------------------------------------------------------------
# (c) K2 and K3
# ---------------------------------------------------------------------------


def _port_round(r, precision, packed):
    fn = twf.make_fused_round(meta=r["tmeta"], params=tsplit.SplitParams(
        min_data_in_leaf=5.0), num_bins=r["B"], precision=precision,
        deep_precision=precision, packed=packed)
    t = torch.from_numpy
    route = dict(leaf_id=t(r["lids"]), feats=t(r["feats"]),
                 thrs=t(r["thrs"]), dls=t(r["dls"]), leafs=t(r["leafs"]),
                 nls=t(r["nls"]), num_leaves=r["num_leaves"])
    out = fn(t(_pack(r["binned"]) if packed else r["binned"]), t(r["g3"]),
             r["S"], mask=t(r["mask"]), csums=t(r["csums"]),
             sml=t(r["sml"]) if r["sub"] else None,
             parent=t(r["parent"]) if r["sub"] else None, route=route)
    vl, = twf.fused_route_rows(
        [(t(_pack(r["binned"]) if packed else r["binned"]), t(r["lids"]))],
        meta=r["tmeta"], packed=packed,
        **{k: v for k, v in route.items() if k != "leaf_id"})
    return out + (vl,)


def _jax_round(r, precision):
    fn = jwf.make_fused_round(meta=r["jmeta"], params=jsplit.SplitParams(
        min_data_in_leaf=5.0), num_bins=r["B"], precision=precision,
        deep_precision=precision, interpret=True, packed=True)
    j = jnp.asarray
    C = 2 * r["S"]
    route = dict(leaf_id=j(r["lids"]), feats=j(r["feats"]),
                 thrs=j(r["thrs"]), dls=j(r["dls"]), leafs=j(r["leafs"]),
                 nls=j(r["nls"]), num_leaves=r["num_leaves"])
    ptab, hsm, _, new_leaf = fn(
        j(_pack(r["binned"])), j(r["g3"]), None, r["S"], mask=j(r["mask"]),
        csums=j(r["csums"]),
        constr=jnp.tile(jnp.asarray(jsplit.NO_CONSTRAINT, jnp.float32),
                        (C, 1)),
        depth=jnp.ones(C, jnp.int32), pout=jnp.zeros(C, jnp.float32),
        sml=j(r["sml"]) if r["sub"] else None,
        parent=j(r["parent"]) if r["sub"] else None, route=route)
    vl = np.asarray(jwf.fused_route_rows(
        j(_pack(r["binned"])), j(r["lids"]), feats=j(r["feats"]),
        thrs=j(r["thrs"]), dls=j(r["dls"]), leafs=j(r["leafs"]),
        nls=j(r["nls"]), num_leaves=r["num_leaves"], meta=r["jmeta"],
        interpret=True, packed=True))
    return (np.asarray(ptab), None if hsm is None else np.asarray(hsm),
            np.asarray(new_leaf), vl)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("case", ["sub", "pool-free", "sparse"])
def test_k2_k3_packed_match_jax(case, precision):
    """The packed fused round and valid router against the JAX packed
    round and router at odd F (picks identical, values within 4e-6 of
    their mass, leaf ids exact), and bit for bit the port's u8 round;
    ``sparse`` has the live rows of one 256-row chunk only."""
    F, B, N, S, L = 7, 16, 777, 3, 12
    r = tfused._round(31 + F, F, B, N, S, L, case != "pool-free",
                      rows="one chunk" if case == "sparse" else None)
    got = _port_round(r, precision, True)
    u8 = _port_round(r, precision, False)
    for a, b in zip(got, u8):
        assert (a is None and b is None) or torch.equal(a, b)
    ptab, hsm, nleaf, vl = (x if x is None else x.numpy() for x in got)
    jtab, jhsm, jleaf, jvl = _jax_round(r, precision)
    np.testing.assert_array_equal(nleaf, jleaf)
    np.testing.assert_array_equal(nleaf, r["want_leaf"])
    np.testing.assert_array_equal(vl, jvl)
    np.testing.assert_array_equal(vl, r["want_leaf"])
    np.testing.assert_array_equal(ptab[:, 1:4], jtab[:, 1:4])
    fin = np.isfinite(jtab[:, 0])
    np.testing.assert_array_equal(np.isfinite(ptab[:, 0]), fin)
    assert fin.sum() >= 2
    jshift = np.asarray(jax.vmap(lambda c: jsplit.gain_shift(
        c, 0.0, jsplit.SplitParams(min_data_in_leaf=5.0)))(
            jnp.asarray(r["csums"])))
    tol_g = 4e-6 * (np.abs(jtab[:, 0]) + np.abs(jshift)) + 1e-6
    assert (np.abs(ptab[fin, 0] - jtab[fin, 0]) <= tol_g[fin]).all()
    tol_s = 4e-6 * np.concatenate([r["child_absum"]] * 2, 1) + 1e-6
    assert (np.abs(ptab[:, 4:] - jtab[:, 4:]) <= tol_s)[fin].all()
    if r["sub"]:
        np.testing.assert_array_equal(hsm[..., 2], jhsm[..., 2])
        absum = hist_cuda.index_add_hist(
            torch.from_numpy(r["binned"]),
            [torch.from_numpy(np.abs(r["g3"]))],
            torch.from_numpy(np.minimum(r["child"] // 2, S)), S + 1,
            B)[:S].numpy()
        assert (np.abs(hsm - jhsm) <= 4e-6 * absum + 1e-6).all()
    else:
        assert hsm is None and jhsm is None


# ---------------------------------------------------------------------------
# (d) K6
# ---------------------------------------------------------------------------


def _packed_loop(p, seg, rounds, precision, **over):
    """The port's loop on the packed bytes ``p`` of segment ``seg``."""
    t = torch.from_numpy
    return loop_cuda.fused_wave_loop(
        p, t(seg["g3"]), t(seg["lids"]), t(seg["ft"]), seg["nl"],
        rounds=rounds, K=seg["K"], slot_buckets=seg["ladder"],
        max_depth=seg["max_depth"], base_mask=t(seg["mask"]),
        num_bins=seg["B"], precision=precision, meta=seg["tmeta"],
        params=tsplit.SplitParams(**tloop.PARAMS),
        pool=t(seg["pool"]) if seg["sub"] else None, packed=True, **over)


# tests/test_torch_wave_loop.py's segments on a 16-bin axis (odd F)
_LOOP16 = [c for c in tloop._CASES if "-B16-" in c]


@pytest.mark.parametrize("case", _LOOP16)
def test_k6_packed_matches_jax(monkeypatch, case):
    """The packed loop against the JAX packed loop on
    tests/test_torch_wave_loop.py's 16-bin segments, with its tolerances
    (``_check_against_jax``)."""
    F, B, N, K, L, nl, sub, ladder, max_depth, R, prec = tloop._CASES[case]
    s = tloop._segment(sum(map(ord, case)), F, B, N, K, L, nl, sub, ladder,
                       max_depth)
    p = torch.from_numpy(_pack(s["binned"]))

    def jax_loop(seg, rounds, precision):
        fn = jwf.make_fused_wave_loop(
            meta=seg["jmeta"], params=jsplit.SplitParams(**tloop.PARAMS),
            num_bins=seg["B"], precision=precision,
            deep_precision=precision, rounds=rounds, interpret=True,
            packed=True)
        j = jnp.asarray
        out = fn(j(p.numpy()), j(seg["g3"]), j(seg["lids"]), j(seg["ft"]),
                 seg["nl"], jax.random.PRNGKey(0), K=seg["K"],
                 slot_buckets=seg["ladder"], quant_buckets=(),
                 max_depth=seg["max_depth"], base_mask=j(seg["mask"]),
                 pool=j(seg["pool"]) if seg["sub"] else None)
        return tuple(None if x is None else np.asarray(x) for x in out)

    monkeypatch.setattr(tloop, "_port_loop",
                        lambda seg, rounds, precision, **over: _packed_loop(
                            p, seg, rounds, precision, **over))
    monkeypatch.setattr(tloop, "_jax_loop", jax_loop)
    tloop._check_against_jax(s, R, prec, 1)


@pytest.mark.parametrize("sub", [True, False], ids=["sub", "pool-free"])
def test_k6_packed_is_the_u8_loop(sub):
    """At odd F the packed loop's packed rows, leaf ids, pool and split
    counts are the u8 loop's, bit for bit."""
    s = tloop._segment(53 + sub, 7, 16, 1024, 8, 32, 5, sub, (4, 8))
    got = _packed_loop(torch.from_numpy(_pack(s["binned"])), s, 4,
                       "bf16x2")
    want = tloop._port_loop(s, 4, "bf16x2")
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
    assert int((got[3] > 0).sum()) >= 2


# ---------------------------------------------------------------------------
# (e) training: the model text of byte bins
# ---------------------------------------------------------------------------


def _problem(F, n=1500, seed=5):
    """tests/test_wave_fused.py's binary problem at F features, with NaNs
    in feature 0 and exact zeros in feature 2."""
    rng = np.random.RandomState(seed + F)
    X = rng.randn(n, F)
    logit = (1.5 * X[:, 0] - X[:, 1] + 0.8 * X[:, 2] * X[:, 3]
             + 0.5 * np.sin(X[:, 4]))
    y = (logit + rng.randn(n) * 0.4 > 0).astype(np.float64)
    X[rng.rand(n) < 0.05, 0] = np.nan
    X[rng.rand(n) < 0.3, 2] = 0.0
    return X, y


BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 15,
        "min_data_in_leaf": 5, "leafwise_wave_size": 4, "verbosity": -1,
        "metric": "auc,binary_logloss"}
_RUNS = {
    "staged": {"hist_method": "pallas"},
    "fused": {"hist_method": "fused"},
    "looped": {"hist_method": "fused", "wave_loop_rounds": 4,
               "hist_dtype_deep": "bf16x2"},
    "sequential": {"hist_method": "pallas", "num_leaves": 7,
                   "leafwise_wave_size": 0},
    "levelwise": {"hist_method": "pallas", "tree_growth": "levelwise"},
}


def _port_pair(params, X, y, iters=3):
    """The same training on byte bins and on packed bins: both boosters
    and their metrics."""
    out = {}
    for lay in ("u8", "packed4"):
        ev = {}
        b = lt.train(dict(params, bin_layout=lay),
                     lt.Dataset(X[:1200], label=y[:1200]), iters,
                     valid_sets=[lt.Dataset(X[1200:], label=y[1200:])],
                     evals_result=ev, device="cpu")
        out[lay] = (b, ev)
    return out


@pytest.mark.parametrize("F", [6, 7])
@pytest.mark.parametrize("run", list(_RUNS))
def test_packed_training_writes_the_u8_model_text(run, F):
    """Staged, fused, looped, sequential and level-wise training on
    packed bins write the model text of the same training on byte bins,
    with the same metrics and valid scores (the packed valid set routes
    to the same leaves)."""
    X, y = _problem(F)
    out = _port_pair(dict(BASE, **_RUNS[run]), X, y)
    (bu, evu), (bp, evp) = out["u8"], out["packed4"]
    assert bp._gbdt._packed and not bu._gbdt._packed
    assert tuple(bp._gbdt.binned.shape) == (-(-F // 2), 1200)
    assert tuple(bp._gbdt._valid_binned[0].shape) == (-(-F // 2), 300)
    assert bp.model_to_string() == bu.model_to_string()
    assert evp == evu
    assert torch.equal(bp._gbdt._valid_scores[0].score,
                       bu._gbdt._valid_scores[0].score)
    assert all(int(t.num_leaves) > 1 for t in bp._gbdt._device_trees)


def test_packed_multiclass_writes_the_u8_model_text():
    rng = np.random.RandomState(3)
    X = rng.randn(1500, 6)
    y = np.argmax(X[:, :3] + 0.3 * rng.randn(1500, 3), axis=1).astype(float)
    out = _port_pair({"objective": "multiclass", "num_class": 3,
                      "num_leaves": 7, "max_bin": 15, "min_data_in_leaf": 5,
                      "leafwise_wave_size": 1, "hist_method": "fused",
                      "metric": "multi_logloss", "verbosity": -1}, X, y, 2)
    (bu, evu), (bp, evp) = out["u8"], out["packed4"]
    assert bp._gbdt._packed
    assert bp.model_to_string() == bu.model_to_string()
    assert evp == evu


@pytest.fixture(scope="module")
def jax_packed_run():
    """The JAX package's packed fused training and the port's, f32, odd
    F (explicit pallas-family method: both pack at max_bin 15)."""
    params = dict(BASE, num_leaves=15, leafwise_wave_size=8,
                  hist_dtype="f32", hist_method="fused", bin_layout="packed4")
    X, y = _problem(7, n=2000, seed=9)
    jb = lj.train(params, lj.Dataset(X, label=y), 3, verbose_eval=False)
    tb = lt.train(params, lt.Dataset(X, label=y), 3, device="cpu")
    assert jb._gbdt._packed and tb._gbdt._packed
    return jb, tb, _problem(7, n=500, seed=10)[0]


def test_packed_training_matches_jax(jax_packed_run):
    """Against the JAX package's packed training: every tree identical in
    structure, leaf values and predictions within 2e-5."""
    jb, tb, Xv = jax_packed_run
    jtrees = jax.device_get(jb._gbdt._device_trees)
    ttrees = tb._gbdt._device_trees
    assert len(jtrees) == len(ttrees) == 3
    for jt, tt in zip(jtrees, ttrees):
        carried = tree_arrays_from_numpy(jt._asdict())
        n = int(carried.num_leaves)
        assert n == int(tt.num_leaves) > 1
        for f in ("split_feature", "threshold_bin", "default_left",
                  "missing_type", "left_child", "right_child"):
            assert torch.equal(getattr(carried, f)[:n - 1],
                               getattr(tt, f)[:n - 1]), f
        assert torch.equal(carried.leaf_count[:n], tt.leaf_count[:n])
        np.testing.assert_allclose(tt.leaf_value[:n].numpy(),
                                   carried.leaf_value[:n].numpy(),
                                   rtol=0, atol=2e-5)
    np.testing.assert_allclose(tb.predict(Xv, raw_score=True),
                               jb.predict(Xv, raw_score=True), rtol=0,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# (f) select_bin_layout against the JAX package's
# ---------------------------------------------------------------------------


_LAYOUT_CASES = {
    # name: (config knobs, num_total_bin, int16 bins, bundled)
    "eligible": ({}, 16, False, False),
    "int16": ({}, 16, True, False),
    "17 bins": ({}, 17, False, False),
    "bundled": ({}, 16, False, True),
    "scatter": ({"hist_method": "scatter"}, 16, False, False),
    "tree_learner=feature": ({"tree_learner": "feature"}, 16, False, False),
    "gpu_use_dp": ({"gpu_use_dp": True}, 16, False, False),
}


@pytest.mark.parametrize("explicit", [False, True], ids=["auto", "packed4"])
@pytest.mark.parametrize("case", list(_LAYOUT_CASES))
def test_select_bin_layout_matches_jax(monkeypatch, case, explicit):
    """Case by case with hist_method=pallas: the JAX package's layout and
    reasons in its order; auto refuses silently, an explicit packed4
    warns with the JAX package's words (the hist-method reason names
    where the port's kernels unpack)."""
    knobs, ntb, int16, bundled = _LAYOUT_CASES[case]
    params = {"hist_method": "pallas", **knobs,
              "bin_layout": "packed4" if explicit else "auto"}
    said = {"jax": [], "port": []}
    monkeypatch.setattr(jtrainer, "log_warning", said["jax"].append)
    monkeypatch.setattr(ttrainer, "log_warning", said["port"].append)
    want = jtrainer.select_bin_layout(
        JaxConfig.from_dict(dict(params)), num_total_bin=ntb,
        bin_dtype=np.int16 if int16 else np.uint8, bundled=bundled)
    got = ttrainer.select_bin_layout(
        Config.from_dict(dict(params)), num_total_bin=ntb, device=CPU,
        bin_dtype=torch.int16 if int16 else torch.uint8, bundled=bundled)
    assert got == want == ("packed4" if case == "eligible" else "u8")
    assert len(said["port"]) == len(said["jax"]) == (
        int(explicit and case != "eligible"))
    for p, j in zip(said["port"], said["jax"]):
        cut = "(" if case == "scatter" else None
        assert p.split(cut)[0] == j.split(cut)[0]
        assert p.endswith("; storing u8 bins")


def test_auto_layout_follows_the_device():
    """auto packs where the kernel's method runs: on the card at <= 16
    bins (a shape decision, no launch), not on the CPU's scatter oracle;
    explicit u8 never packs."""
    cfg = Config.from_dict({"max_bin": 15})
    assert ttrainer.select_bin_layout(
        cfg, num_total_bin=16, device=torch.device("cuda")) == "packed4"
    assert ttrainer.select_bin_layout(cfg, num_total_bin=16,
                                      device=CPU) == "u8"
    assert ttrainer.select_bin_layout(
        Config.from_dict({"max_bin": 15, "hist_method": "fused"}),
        num_total_bin=16, device=CPU) == "packed4"
    assert ttrainer.select_bin_layout(
        Config.from_dict({"bin_layout": "u8"}), num_total_bin=16,
        device=torch.device("cuda")) == "u8"
