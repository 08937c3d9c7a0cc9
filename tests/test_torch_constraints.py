"""The constrained split scan of the port — monotone constraints (basic
and intermediate), ``monotone_penalty``, ``feature_contri``,
``path_smooth`` and ``max_delta_step`` — held against the JAX package's.

On the CPU the split-scan kernel, K2 and K6 run their plain versions;
here they are held to the JAX package's scan (``find_best_split``,
``child_scan_residue``), fused round (``make_fused_round``, Pallas in
interpret mode) and persistent loop (``make_fused_wave_loop``, interpret
mode) on the same numpy inputs, and the port's trainings to the JAX
package's on tests/test_monotone.py's problem.  The CUDA kernels are held
to the plain versions bit for bit on the card by chip_smoke.py (phases
31-33).

Tolerances:
* picks (feature, threshold bin, default direction, direction * B +
  threshold): identical — the tie band (``TIE_RTOL``) absorbs the f32
  summation order;
* gains: within ``4e-6 * (|gain| + |shift|) + 1e-6`` of the JAX value, as
  tests/test_torch_fused.py; sums within ``4e-6`` of the absolute mass
  they add, plus 1e-6 (the port's cumulative sum rounds each prefix of a
  double accumulation, XLA's adds in f32);
* the monotone penalty factor: the JAX f32 value within 1 ulp (2**-23
  relative; at integer exponents both are exact);
* trainings: trees identical in structure, leaf values within 2e-5, every
  model monotone along its constrained features on a grid; the port's
  staged, fused and looped texts byte for byte equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightgbmv1_tpu as lj
from lightgbmv1_tpu.ops import split as jsplit
from lightgbmv1_tpu.ops import wave_fused as jwf

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.io.dataset import BinnedDataset
from lightgbmv1_tpu_torch.models import grower_wave as tgw
from lightgbmv1_tpu_torch.models.convert import tree_arrays_from_numpy
from lightgbmv1_tpu_torch.ops import fused_cuda, loop_cuda, scan_cuda
from lightgbmv1_tpu_torch.ops import split as tsplit
from lightgbmv1_tpu_torch.ops import wave_fused as twf

CPU = torch.device("cpu")

# the scan options of each case: (monotone, penalty, contri, smooth, mds)
OPTIONS = {
    "none": (False, 0.0, False, 0.0, 0.0),
    "monotone": (True, 0.0, False, 0.0, 0.0),
    "penalty": (True, 1.0, False, 0.0, 0.0),
    "contri": (False, 0.0, True, 0.0, 0.0),
    "smooth": (False, 0.0, False, 1.0, 0.0),
    "max_output": (False, 0.0, False, 0.0, 0.7),
    "all": (True, 1.0, True, 1.0, 0.7),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op pool, and
    beside other pytest workers its spinning threads starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _metas(F, B, opts, rng):
    """The same feature meta for both packages: NaN-, zero- and
    none-missing features, a 2-bin feature, a narrower bin axis, and the
    option's monotone types and contri multipliers."""
    mono_on, _, contri_on, _, _ = opts
    mt = np.array([1, 2, 0, 0, 0] * -(-F // 5))[:F]
    nb = np.full(F, B)
    nb[3 % F] = 2
    nb[4 % F] = max(2, B - 5)
    nan_bin = np.where(mt == 2, nb - 1, -1)
    zero_bin = np.where(mt == 1, np.minimum(3, nb - 1), 0)
    mono = np.array([1, -1, 0, 1, -1, 0] * -(-F // 6))[:F] if mono_on \
        else np.zeros(F, np.int64)
    contri = (0.5 + rng.rand(F)).astype(np.float32) if contri_on else None
    j = jsplit.FeatureMeta(
        num_bins=jnp.asarray(nb, jnp.int32),
        missing_type=jnp.asarray(mt, jnp.int32),
        nan_bin=jnp.asarray(nan_bin, jnp.int32),
        zero_bin=jnp.asarray(zero_bin, jnp.int32),
        is_categorical=jnp.zeros(F, bool), usable=jnp.ones(F, bool),
        monotone_type=jnp.asarray(mono, jnp.int32),
        contri=None if contri is None else jnp.asarray(contri))
    t = tsplit.with_tables(tsplit.FeatureMeta(
        num_bins=torch.as_tensor(nb, dtype=torch.int64),
        missing_type=torch.as_tensor(mt, dtype=torch.int64),
        nan_bin=torch.as_tensor(nan_bin, dtype=torch.int64),
        zero_bin=torch.as_tensor(zero_bin, dtype=torch.int64),
        usable=torch.ones(F, dtype=torch.bool),
        monotone_type=(torch.as_tensor(mono, dtype=torch.int64)
                       if mono_on else None),
        contri=None if contri is None else torch.from_numpy(contri)))
    return j, t, nb


def _params(opts, min_data=5.0):
    _, pen, _, smooth, mds = opts
    common = dict(lambda_l1=0.1, lambda_l2=0.5, min_data_in_leaf=min_data,
                  max_delta_step=mds, path_smooth=smooth)
    return (jsplit.SplitParams(**common),
            tsplit.SplitParams(**common, monotone_penalty=pen), pen)


def _children(seed, F, B, C, opts):
    """C children's histograms binned from the same rows (every feature
    sums to the child's totals), their sums, binding [min, max] bounds
    around each child's output (NO_CONSTRAINT on every fourth), depths
    1..8 and parent outputs."""
    rng = np.random.RandomState(seed)
    jmeta, tmeta, nb = _metas(F, B, opts, rng)
    N = 600 * C
    binned = (rng.randint(0, 1 << 16, (F, N)) % nb[:, None]).astype(np.int64)
    g3 = np.stack([rng.randn(N) + 0.2, rng.rand(N) * 0.3 + 0.1, np.ones(N)],
                  axis=1).astype(np.float32)
    child = rng.randint(0, C, N)
    hist = np.zeros((C, F, B, 3), np.float64)
    absum = np.zeros((C, 3), np.float64)
    for f in range(F):
        np.add.at(hist, (child, f, binned[f]), g3)
    np.add.at(absum, child, np.abs(g3))
    csums = hist[:, 0].sum(axis=1).astype(np.float32)
    out = -csums[:, 0] / (csums[:, 1] + 0.5)
    constr = np.stack([out - 0.05, out + 0.05], axis=1).astype(np.float32)
    constr[::4] = jsplit.NO_CONSTRAINT
    depth = (np.arange(C) % 8 + 1).astype(np.int64)
    pout = (out * 0.8).astype(np.float32)
    mask = np.ones((C, F), bool)
    mask[1, 2] = False
    return dict(hist=hist.astype(np.float32), csums=csums, constr=constr,
                depth=depth, pout=pout, mask=mask, absum=absum,
                jmeta=jmeta, tmeta=tmeta)


def _gain_tol(gain, shift):
    return 4e-6 * (np.abs(gain) + np.abs(shift)) + 1e-6


# ---------------------------------------------------------------------------
# the scan: find_best_split and the residue against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_find_best_split_matches_jax(case):
    opts = OPTIONS[case]
    C, F, B = 8, 7, 16
    d = _children(3, F, B, C, opts)
    jp, tp, pen = _params(opts)
    t = torch.from_numpy
    res = tsplit.find_best_split(
        t(d["hist"]), t(d["csums"]), d["tmeta"], t(d["mask"]), tp,
        constraint=t(d["constr"]), depth=t(d["depth"]),
        parent_output=t(d["pout"]))
    fin = 0
    for c in range(C):
        jr = jsplit.find_best_split(
            jnp.asarray(d["hist"][c]), jnp.asarray(d["csums"][c]),
            d["jmeta"], jnp.asarray(d["mask"][c]), jp,
            constraint=jnp.asarray(d["constr"][c]),
            depth=int(d["depth"][c]), monotone_penalty=pen,
            parent_output=float(d["pout"][c]))
        assert int(jr.feature) == int(res.feature[c])
        assert int(jr.threshold_bin) == int(res.threshold_bin[c])
        assert bool(jr.default_left) == bool(res.default_left[c])
        jg = float(jr.gain)
        assert np.isfinite(jg) == bool(torch.isfinite(res.gain[c]))
        if np.isfinite(jg):
            fin += 1
            shift = float(jsplit.gain_shift(jnp.asarray(d["csums"][c]),
                                            float(d["pout"][c]), jp))
            assert abs(float(res.gain[c]) - jg) <= _gain_tol(jg, shift)
            tol = 4e-6 * d["absum"][c] + 1e-6
            assert (np.abs(res.left_sum[c].numpy()
                           - np.asarray(jr.left_sum)) <= tol).all()
    assert fin >= C // 2


@pytest.mark.parametrize("scaled", [False, True], ids=["f32", "hist_scale"])
@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_split_scan_plain_residue_matches_jax(case, scaled):
    """The split-scan kernel's plain version against the JAX package's
    ``child_scan_residue`` (the in-kernel scan of its fused round), with
    and without int8sr dequantization scales."""
    opts = OPTIONS[case]
    C, F, B = 6, 6, 16
    d = _children(4, F, B, C, opts)
    jp, tp, pen = _params(opts)
    hist, hsc = d["hist"], None
    if scaled:                 # integer sums and power-of-two scales
        hsc = np.tile(np.float32([2.0 ** -4, 2.0 ** -7, 1.0]), (C, 1))
        hist = np.round(hist / hsc[:, None, None, :]).astype(np.float32)
    t = torch.from_numpy
    legs = tsplit.scan_inputs(d["tmeta"], tp, C, CPU, t(d["constr"]),
                              t(d["depth"]), t(d["pout"]))
    before = scan_cuda.plain_counts["split_scan"]
    res = scan_cuda.split_scan(
        t(hist), t(d["mask"]), t(d["csums"]), meta=d["tmeta"], params=tp,
        hist_scale=None if hsc is None else t(hsc), **legs).numpy()
    assert scan_cuda.plain_counts["split_scan"] == before + 1
    for c in range(C):
        want = np.asarray(jwf.child_scan_residue(
            jnp.asarray(hist[c]), jnp.asarray(d["mask"][c]),
            jnp.asarray(d["csums"][c]), jnp.asarray(d["constr"][c]),
            jnp.asarray(d["depth"][c], jnp.int32),
            jnp.asarray(d["pout"][c]),
            jnp.asarray(np.ones(3, np.float32) if hsc is None else hsc[c]),
            meta_blk=d["jmeta"], params=jp, use_mc=opts[0],
            monotone_penalty=pen, child_scale=scaled, num_bins=B, fblk=F))
        np.testing.assert_array_equal(res[c, :, 2], want[:, 2])
        fin = np.isfinite(want[:, 0])
        np.testing.assert_array_equal(np.isfinite(res[c, :, 0]), fin)
        shift = float(jsplit.gain_shift(jnp.asarray(d["csums"][c]),
                                        float(d["pout"][c]), jp))
        for k in (0, 1):
            assert (np.abs(res[c, fin, k] - want[fin, k])
                    <= _gain_tol(want[fin, k], shift)).all()
        tol = 4e-6 * d["absum"][c] + 1e-6
        assert (np.abs(res[c, :, 3:] - want[:, 3:]) <= tol).all()


def test_find_best_split_is_residue_plus_pick():
    """``find_best_split`` = the residue (``scan_residue``) and the
    cross-feature pick (``pick_pack``), equal to the staged stages'
    ``scan_pick`` bit for bit."""
    opts = OPTIONS["all"]
    d = _children(5, 6, 16, 6, opts)
    _, tp, _ = _params(opts)
    t = torch.from_numpy
    legs = tsplit.scan_inputs(d["tmeta"], tp, 6, CPU, t(d["constr"]),
                              t(d["depth"]), t(d["pout"]))
    res = tsplit.find_best_split(
        t(d["hist"]), t(d["csums"]), d["tmeta"], t(d["mask"]), tp,
        constraint=t(d["constr"]), depth=t(d["depth"]),
        parent_output=t(d["pout"]))
    left2 = tsplit.scan_left_sums(t(d["hist"]), d["tmeta"])
    gains, shift = tsplit.scan_direction_gains(
        left2, t(d["csums"]), d["tmeta"], t(d["mask"]), tp,
        legs["constraint"], legs["pfac"], legs["parent_output"])
    best, feat, thr, dirn = tsplit.scan_pick(gains, shift, d["tmeta"])
    assert torch.equal(res.feature, feat)
    assert torch.equal(res.threshold_bin, thr)
    assert torch.equal(torch.where(torch.isfinite(best), best,
                                   torch.full_like(best, -np.inf)),
                       res.gain)
    ci = torch.arange(6)
    assert torch.equal(res.left_sum, left2[ci, dirn, feat, thr])


@pytest.mark.parametrize("penalty", [0.5, 1.0, 1.5, 3.0])
def test_monotone_penalty_factor_matches_jax(penalty):
    depth = np.arange(0, 12)
    got = tsplit.monotone_penalty_factors(torch.from_numpy(depth),
                                          penalty).numpy()
    want = np.asarray(jsplit.monotone_penalty_factor(jnp.asarray(depth),
                                                     penalty))
    np.testing.assert_allclose(got, want, rtol=2.0 ** -23, atol=0)
    assert got.dtype == np.float32


@pytest.mark.parametrize("case", ["monotone", "contri", "smooth",
                                  "max_output"])
def test_leaf_outputs_match_jax(case):
    """``leaf_output`` / ``leaf_gain`` with ``max_delta_step`` and
    ``child_leaf_output`` (smoothing toward the parent, the monotone
    clamp) against the JAX package's."""
    opts = OPTIONS[case]
    d = _children(6, 4, 8, 8, opts)
    jp, tp, _ = _params(opts)
    t = torch.from_numpy
    cs = d["csums"]
    constr = t(d["constr"]) if opts[0] else None
    got = tsplit.child_leaf_output(t(cs), tp, constr, t(d["pout"])).numpy()
    for c in range(8):
        want = float(jsplit.child_leaf_output(
            jnp.asarray(cs[c]), jnp.asarray(d["constr"][c]),
            float(d["pout"][c]), jp, use_mc=opts[0]))
        assert abs(got[c] - want) <= 1e-6 * max(1.0, abs(want))
    lg = tsplit.leaf_gain(t(cs[:, 0]), t(cs[:, 1]), tp).numpy()
    jg = np.asarray(jsplit.leaf_gain(jnp.asarray(cs[:, 0]),
                                     jnp.asarray(cs[:, 1]), jp))
    np.testing.assert_allclose(lg, jg, rtol=1e-6)


def test_make_feature_meta_matches_jax():
    X = np.random.RandomState(7).randn(500, 5)
    cfg = Config.from_dict({"max_bin": 15, "enable_bundle": False})
    tds = BinnedDataset.from_numpy(X, config=cfg)
    from lightgbmv1_tpu.config import Config as JConfig
    from lightgbmv1_tpu.io.dataset import BinnedDataset as JDataset
    jds = JDataset.from_numpy(X, config=JConfig.from_dict(
        {"max_bin": 15, "enable_bundle": False}))
    for mono, contri in (([1, -1], [0.5, 1.0, 2.0]), ([0, 0], []),
                         ([1, 0, 0, 0, 0, -1, 1], [1.0] * 9)):
        tm = tsplit.make_feature_meta(tds, CPU, mono, contri)
        jm = jsplit.make_feature_meta(jds, mono, contri)
        if any(mono):
            np.testing.assert_array_equal(tm.monotone_type.numpy(),
                                          np.asarray(jm.monotone_type))
        else:
            assert tm.monotone_type is None
            assert not np.asarray(jm.monotone_type).any()
        if contri:
            np.testing.assert_array_equal(tm.contri.numpy(),
                                          np.asarray(jm.contri))
        else:
            assert tm.contri is None and jm.contri is None


# ---------------------------------------------------------------------------
# K2's plain version with the constrained legs against the JAX fused round
# ---------------------------------------------------------------------------


def _round(seed, F, B, N, S, L, sub, opts):
    """One routed round's inputs (the last of S slots dead), the
    children's exact sums, bounds, depths and parent outputs, and in
    subtraction mode each slot's parent histogram."""
    rng = np.random.RandomState(seed)
    jmeta, tmeta, nb = _metas(F, B, opts, rng)
    binned = (rng.randint(0, 1 << 16, (F, N)) % nb[:, None]).astype(np.uint8)
    g3 = np.stack([rng.randn(N) + 0.2, np.abs(rng.randn(N)) + 0.1,
                   np.ones(N)], axis=1).astype(np.float32)
    lids = rng.randint(0, L, N).astype(np.int32)
    live = S - 1
    feats = rng.randint(0, F, S).astype(np.int32)
    thrs = np.array([rng.randint(0, max(nb[f] - 1, 1)) for f in feats],
                    np.int32)
    dls = rng.rand(S) < 0.5
    leafs = rng.choice(L, S, replace=False).astype(np.int32)
    leafs[live:] = L + S
    nls = (np.arange(S) + L).astype(np.int32)
    sml = rng.rand(S) < 0.5
    sml[live:] = False
    bk = binned[feats].astype(np.int32)
    mt = np.asarray(jmeta.missing_type)[feats][:, None]
    na = ((mt == 2) & (bk == np.asarray(jmeta.nan_bin)[feats][:, None])) | (
        (mt == 1) & (bk == np.asarray(jmeta.zero_bin)[feats][:, None]))
    gl = np.where(na, dls[:, None], bk <= thrs[:, None])
    mine = lids[None, :] == leafs[:, None]
    child = np.sum(np.where(mine, 2 * np.arange(S)[:, None] + ~gl - 2 * S,
                            0), 0) + 2 * S
    C = 2 * S
    csums = np.zeros((C + 1, 3), np.float64)
    np.add.at(csums, child, g3)
    absums = np.zeros((C + 1, 3), np.float64)
    np.add.at(absums, child, np.abs(g3))
    csums = csums[:C].astype(np.float32)
    csums[2 * live:] = 1.0
    mask = np.zeros((C, F), bool)
    mask[:2 * live] = True
    out = -csums[:, 0] / (csums[:, 1] + 0.5)
    constr = np.stack([out - 0.05, out + 0.05], axis=1).astype(np.float32)
    constr[2 * live:] = 0.0
    depth = np.ones(C, np.int64)
    depth[:2 * live] = np.repeat(rng.randint(1, 9, live), 2)
    pout = np.where(np.arange(C) < 2 * live, out * 0.8, 0.0) \
        .astype(np.float32)
    r = dict(binned=binned, g3=g3, lids=lids, feats=feats, thrs=thrs,
             dls=dls, leafs=leafs, nls=nls, sml=sml, csums=csums, mask=mask,
             child_absum=absums[:C], num_leaves=L + S, jmeta=jmeta,
             tmeta=tmeta, F=F, B=B, S=S, sub=sub, constr=constr,
             depth=depth, pout=pout)
    if sub:
        parent = np.zeros((S + 1, F, B, 3), np.float64)
        slot = np.full(N, S)
        for s in range(live):
            slot[lids == leafs[s]] = s
        for f in range(F):
            np.add.at(parent, (slot, f, binned[f]), g3)
        r["parent"] = parent[:S].astype(np.float32)
    return r


@pytest.mark.parametrize("sub", [True, False], ids=["sub", "pool-free"])
@pytest.mark.parametrize("case", ["monotone", "penalty", "all"])
def test_fused_round_legs_match_jax(case, sub):
    opts = OPTIONS[case]
    r = _round(30, 6, 16, 1500, 4, 12, sub, opts)
    jp, tp, pen = _params(opts)
    t, j = torch.from_numpy, jnp.asarray
    tfn = twf.make_fused_round(meta=r["tmeta"], params=tp, num_bins=r["B"],
                               precision="f32", deep_precision="f32")
    before = fused_cuda.plain_counts["fused_round"]
    troute = dict(leaf_id=t(r["lids"]), feats=t(r["feats"]),
                  thrs=t(r["thrs"]), dls=t(r["dls"]), leafs=t(r["leafs"]),
                  nls=t(r["nls"]), num_leaves=r["num_leaves"])
    ptab, _, nleaf = tfn(t(r["binned"]), t(r["g3"]), r["S"],
                         mask=t(r["mask"]), csums=t(r["csums"]),
                         sml=t(r["sml"]) if sub else None,
                         parent=t(r["parent"]) if sub else None,
                         route=troute, constr=t(r["constr"]),
                         depth=t(r["depth"]), pout=t(r["pout"]))
    assert fused_cuda.plain_counts["fused_round"] == before + 1
    jfn = jwf.make_fused_round(meta=r["jmeta"], params=jp, num_bins=r["B"],
                               precision="f32", deep_precision="f32",
                               monotone_penalty=pen, interpret=True)
    jroute = dict(leaf_id=j(r["lids"]), feats=j(r["feats"]),
                  thrs=j(r["thrs"]), dls=j(r["dls"]), leafs=j(r["leafs"]),
                  nls=j(r["nls"]), num_leaves=r["num_leaves"])
    jtab, _, _, jleaf = jfn(
        j(r["binned"]), j(r["g3"]), None, r["S"], mask=j(r["mask"]),
        csums=j(r["csums"]), constr=j(r["constr"]),
        depth=j(r["depth"].astype(np.int32)), pout=j(r["pout"]),
        sml=j(r["sml"]) if sub else None,
        parent=j(r["parent"]) if sub else None, route=jroute)
    ptab, jtab = ptab.numpy(), np.asarray(jtab)
    np.testing.assert_array_equal(nleaf.numpy(), np.asarray(jleaf))
    np.testing.assert_array_equal(ptab[:, 1:4], jtab[:, 1:4])
    fin = np.isfinite(jtab[:, 0])
    np.testing.assert_array_equal(np.isfinite(ptab[:, 0]), fin)
    assert fin.sum() >= 2
    jshift = np.asarray(jax.vmap(lambda c, p: jsplit.gain_shift(c, p, jp))(
        j(r["csums"]), j(r["pout"])))
    assert (np.abs(ptab[fin, 0] - jtab[fin, 0])
            <= _gain_tol(jtab[fin, 0], jshift[fin])).all()
    tol_s = 4e-6 * np.concatenate([r["child_absum"]] * 2, 1) + 1e-6
    assert (np.abs(ptab[:, 4:] - jtab[:, 4:]) <= tol_s)[fin].all()


def test_fused_round_legs_equal_the_staged_scan():
    """The fused round's constrained scan is ``find_best_split`` on the
    round's children, bit for bit."""
    opts = OPTIONS["all"]
    r = _round(31, 6, 16, 1500, 4, 12, False, opts)
    _, tp, _ = _params(opts)
    t = torch.from_numpy
    tfn = twf.make_fused_round(meta=r["tmeta"], params=tp, num_bins=r["B"],
                               precision="f32", deep_precision="f32")
    troute = dict(leaf_id=t(r["lids"]), feats=t(r["feats"]),
                  thrs=t(r["thrs"]), dls=t(r["dls"]), leafs=t(r["leafs"]),
                  nls=t(r["nls"]), num_leaves=r["num_leaves"])
    ptab, _, _ = tfn(t(r["binned"]), t(r["g3"]), r["S"], mask=t(r["mask"]),
                     csums=t(r["csums"]), route=troute,
                     constr=t(r["constr"]), depth=t(r["depth"]),
                     pout=t(r["pout"]))
    from lightgbmv1_tpu_torch.ops import hist_cuda
    rmeta = twf.pack_route_meta(t(r["feats"]), t(r["thrs"]), t(r["dls"]),
                                t(r["leafs"]), t(r["nls"]), r["tmeta"])
    dbin = twf.decision_bins(t(r["binned"]), t(r["lids"]), t(r["feats"]),
                             t(r["leafs"]), r["num_leaves"])
    _, label = twf.route_tile(dbin, t(r["lids"]), rmeta,
                              nslots=2 * r["S"], sub=False)
    h = hist_cuda.hist_leaves_ref(t(r["binned"]), t(r["g3"]), label,
                                  2 * r["S"] + 1, r["B"], "f32")[:2 * r["S"]]
    res = tsplit.find_best_split(h, t(r["csums"]), r["tmeta"], t(r["mask"]),
                                 tp, constraint=t(r["constr"]),
                                 depth=t(r["depth"]),
                                 parent_output=t(r["pout"]))
    got = tsplit.unpack_children(ptab, r["B"])
    for name in res._fields:
        if getattr(res, name) is None:      # no categorical feature
            assert getattr(got, name) is None, name
            continue
        assert torch.equal(getattr(got, name), getattr(res, name)), name


# ---------------------------------------------------------------------------
# K6's plain version with contri / smooth / max output against the JAX loop
# ---------------------------------------------------------------------------


def _segment(seed, opts, F=5, B=16, N=1000, K=4, L=16, nl=3, sub=True):
    rng = np.random.RandomState(seed)
    jmeta, tmeta, nb = _metas(F, B, opts, rng)
    binned = (rng.randint(0, 1 << 16, (F, N)) % nb[:, None]).astype(np.uint8)
    g3 = np.stack([rng.randn(N) + 0.2, np.abs(rng.randn(N)) + 0.1,
                   np.ones(N)], axis=1).astype(np.float32)
    lids = rng.randint(0, nl, N).astype(np.int32)
    pool = np.zeros((L, F, B, 3), np.float64)
    for f in range(F):
        np.add.at(pool, (lids, f, binned[f]), g3)
    sums = np.zeros((L, 3), np.float64)
    np.add.at(sums, lids, g3)
    pool, sums = pool.astype(np.float32), sums.astype(np.float32)
    _, tp, _ = _params(opts)
    pout = (-sums[:nl, 0] / (sums[:nl, 1] + 0.5) * 0.7).astype(np.float32)
    res = tsplit.find_best_split(
        torch.from_numpy(pool[:nl]), torch.from_numpy(sums[:nl]), tmeta,
        torch.ones((nl, F), dtype=torch.bool), tp,
        parent_output=torch.from_numpy(pout))
    ft = np.zeros((L, 12), np.float32)
    ft[:, 0] = -np.inf
    ft[:nl] = torch.cat([
        res.gain[:, None], res.feature.float()[:, None],
        res.threshold_bin.float()[:, None], res.default_left.float()[:, None],
        res.left_sum, res.right_sum, torch.from_numpy(pout)[:, None],
        torch.from_numpy(rng.randint(0, 3, nl).astype(np.float32))[:, None]],
        dim=1).numpy()
    return dict(binned=binned, g3=g3, lids=lids, pool=pool, ft=ft, nl=nl,
                K=K, L=L, B=B, F=F, sub=sub, jmeta=jmeta, tmeta=tmeta)


@pytest.mark.parametrize("sub", [True, False], ids=["sub", "pool-free"])
@pytest.mark.parametrize("case", ["contri", "smooth", "max_output",
                                  "contri_smooth_max"])
def test_wave_loop_legs_match_jax(case, sub):
    opts = (OPTIONS[case] if case in OPTIONS
            else (False, 0.0, True, 1.0, 0.7))
    s = _segment(40, opts, sub=sub)
    jp, tp, _ = _params(opts)
    t, j = torch.from_numpy, jnp.asarray
    R = 4
    before = loop_cuda.plain_counts["fused_wave_loop"]
    packed, new_leaf, pool, n_split = loop_cuda.fused_wave_loop(
        t(s["binned"]), t(s["g3"]), t(s["lids"]), t(s["ft"]), s["nl"],
        rounds=R, K=s["K"], slot_buckets=(s["K"],), max_depth=-1,
        base_mask=torch.ones(s["F"], dtype=torch.bool), num_bins=s["B"],
        precision="f32", meta=s["tmeta"], params=tp,
        pool=t(s["pool"]) if sub else None)
    assert loop_cuda.plain_counts["fused_wave_loop"] == before + 1
    fn = jwf.make_fused_wave_loop(meta=s["jmeta"], params=jp,
                                  num_bins=s["B"], precision="f32",
                                  deep_precision="f32", rounds=R,
                                  interpret=True)
    jpk, jleaf, jpool = fn(
        j(s["binned"]), j(s["g3"]), j(s["lids"]), j(s["ft"]), s["nl"],
        jax.random.PRNGKey(0), K=s["K"], slot_buckets=(s["K"],),
        quant_buckets=(), max_depth=-1, base_mask=jnp.ones(s["F"], bool),
        pool=j(s["pool"]) if sub else None)
    jpk, packed = np.asarray(jpk), packed.numpy()
    assert int(n_split.sum()) > s["K"]
    np.testing.assert_array_equal(new_leaf.numpy(), np.asarray(jleaf))
    np.testing.assert_array_equal(packed[..., 1:4], jpk[..., 1:4])
    fin = np.isfinite(jpk[..., 0])
    np.testing.assert_array_equal(np.isfinite(packed[..., 0]), fin)
    scale = np.abs(jpk[..., 0]) + np.abs(jpk[..., 4:7]).sum(-1)
    assert (np.abs(packed[..., 0][fin] - jpk[..., 0][fin])
            <= (4e-6 * scale + 1e-5)[fin]).all()
    absum = float(np.abs(s["g3"]).sum())
    assert (np.abs(packed[..., 4:] - jpk[..., 4:])
            <= 4e-6 * absum + 1e-5)[fin].all()
    if sub:
        assert (np.abs(pool.numpy() - np.asarray(jpool))
                <= 4e-6 * absum + 1e-5).all()


def test_wave_loop_refuses_monotone():
    s = _segment(41, OPTIONS["monotone"])
    _, tp, _ = _params(OPTIONS["monotone"])
    t = torch.from_numpy
    with pytest.raises(ValueError, match="monotone constraints propagate "
                       "per-round bounds outside the kernel"):
        loop_cuda.fused_wave_loop(
            t(s["binned"]), t(s["g3"]), t(s["lids"]), t(s["ft"]), s["nl"],
            rounds=2, K=s["K"], slot_buckets=(s["K"],), max_depth=-1,
            base_mask=torch.ones(s["F"], dtype=torch.bool), num_bins=s["B"],
            precision="f32", meta=s["tmeta"], params=tp,
            pool=t(s["pool"]))


# ---------------------------------------------------------------------------
# trainings against the JAX package's (tests/test_monotone.py's problem)
# ---------------------------------------------------------------------------


def _mono_problem(n=2000, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 3)
    y = 5 * x[:, 0] - 5 * x[:, 1] + np.sin(6 * x[:, 2]) + rng.randn(n) * 0.1
    return x, y


def _is_monotone(bst, feature, sign, n_grid=40, n_probe=30, seed=1):
    rng = np.random.RandomState(seed)
    base = rng.rand(n_probe, 3)
    grid = np.linspace(0.0, 1.0, n_grid)
    for row in base:
        pts = np.tile(row, (n_grid, 1))
        pts[:, feature] = grid
        d = np.diff(bst.predict(pts))
        if not ((d >= -1e-10).all() if sign > 0 else (d <= 1e-10).all()):
            return False
    return True


MONO_BASE = {"objective": "regression", "num_leaves": 15,
             "min_data_in_leaf": 20, "learning_rate": 0.1, "verbosity": -1,
             "monotone_constraints": [1, -1, 0]}

_TRAININGS = {
    "wave-basic": {},
    "wave-intermediate": {"monotone_constraints_method": "intermediate"},
    "sequential-basic": {"num_leaves": 7},
    "levelwise-basic": {"tree_growth": "levelwise"},
    "wave-options": {"monotone_constraints_method": "intermediate",
                     "monotone_penalty": 1.0,
                     "feature_contri": [1.0, 0.7, 0.5],
                     "path_smooth": 1.0, "max_delta_step": 0.7},
}


@pytest.fixture(scope="module")
def trainings():
    X, y = _mono_problem()
    out = {}
    for name, extra in _TRAININGS.items():
        p = dict(MONO_BASE, **extra)
        jb = lj.train(p, lj.Dataset(X, label=y), 4)
        tb = lt.train(p, lt.Dataset(X, label=y), 4, device="cpu")
        out[name] = (jb, tb)
    return out


@pytest.mark.parametrize("name", sorted(_TRAININGS))
def test_constrained_training_matches_jax(trainings, name):
    jb, tb = trainings[name]
    jtrees = jax.device_get(jb._gbdt._device_trees)
    ttrees = tb._gbdt._device_trees
    assert len(jtrees) == len(ttrees) == 4
    for jt, tt in zip(jtrees, ttrees):
        c = tree_arrays_from_numpy(jt._asdict())
        n = int(c.num_leaves)
        assert n == int(tt.num_leaves) > 1
        for f in ("split_feature", "threshold_bin", "default_left",
                  "left_child", "right_child"):
            assert torch.equal(getattr(c, f)[:n - 1],
                               getattr(tt, f)[:n - 1]), f
        assert torch.equal(c.leaf_count[:n], tt.leaf_count[:n])
        np.testing.assert_allclose(tt.leaf_value[:n].numpy(),
                                   c.leaf_value[:n].numpy(), rtol=0,
                                   atol=2e-5)


@pytest.mark.parametrize("name", sorted(_TRAININGS))
def test_constrained_training_is_monotone(trainings, name):
    _, tb = trainings[name]
    assert _is_monotone(tb, 0, +1)
    assert _is_monotone(tb, 1, -1)


# ---------------------------------------------------------------------------
# the port's paths against each other, and the mode resolution
# ---------------------------------------------------------------------------


def _binary(n=3000, seed=5, F=8):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n) < 0.05, 2] = np.nan
    y = (X[:, 0] - X[:, 1] + 0.5 * X[:, 2] + rng.randn(n) > 0) \
        .astype(np.float64)
    return X, y


def _text(params, rounds=4, data=None):
    X, y = data if data is not None else _binary()
    b = lt.train(dict({"objective": "binary", "num_leaves": 31,
                       "min_data_in_leaf": 10, "verbosity": -1,
                       "max_bin": 63}, **params),
                 lt.Dataset(X, label=y), rounds, device="cpu")
    return b.model_to_string()


@pytest.mark.parametrize("mode", ["basic", "intermediate"])
def test_fused_text_is_staged_text_monotone_l1(mode):
    """The fused round and the staged rounds write one model text with
    monotone constraints and L1 (as tests/test_wave_fused.py's
    ``test_fused_parity_monotone_l1`` / ``_intermediate`` hold the JAX
    package)."""
    p = {"monotone_constraints": [1, -1, 0, 0, 0, 0, 0, 0],
         "monotone_constraints_method": mode, "lambda_l1": 0.5,
         "lambda_l2": 0.1, "monotone_penalty": 1.0}
    staged = _text(dict(p, hist_method="pallas"))
    assert staged == _text(dict(p, hist_method="fused"))


def test_looped_text_is_single_round_text():
    """The persistent loop's plain version writes the single round's text
    with contri, path smoothing and max_delta_step."""
    p = {"feature_contri": [1.0, 0.5] * 4, "path_smooth": 1.0,
         "max_delta_step": 0.7, "hist_method": "fused",
         "hist_dtype_deep": "bf16x2"}
    single = _text(p)
    assert single == _text(dict(p, wave_loop_rounds=4))
    assert single == _text(dict(p, hist_method="pallas"))


def test_options_change_the_model():
    base = _text({})
    for knob in ({"feature_contri": [1.0, 0.5] * 4}, {"path_smooth": 1.0},
                 {"max_delta_step": 0.05},
                 {"monotone_constraints": [1, -1, 0, 0, 0, 0, 0, 0]}):
        assert _text(knob) != base, knob


def test_advanced_runs_as_intermediate(capsys):
    p = {"monotone_constraints": [1, -1, 0, 0, 0, 0, 0, 0]}
    inter = _text(dict(p, monotone_constraints_method="intermediate"))
    capsys.readouterr()
    adv = _text(dict(p, monotone_constraints_method="advanced",
                     verbosity=0))
    assert "monotone_constraints_method=advanced (slow constraint " \
        "recomputation) is approximated by 'intermediate'" \
        in capsys.readouterr().err
    assert adv.split("parameters:")[0] == inter.split("parameters:")[0]


def test_levelwise_intermediate_falls_back_to_basic(capsys):
    p = {"monotone_constraints": [1, -1, 0, 0, 0, 0, 0, 0],
         "tree_growth": "levelwise"}
    basic = _text(p)
    capsys.readouterr()
    inter = _text(dict(p, monotone_constraints_method="intermediate",
                       verbosity=0))
    assert "monotone_constraints_method=intermediate is implemented by " \
        "the wave-batched leaf-wise grower; falling back to 'basic' for " \
        "this configuration (tree_growth=levelwise)" \
        in capsys.readouterr().err
    assert inter.split("parameters:")[0] == basic.split("parameters:")[0]


def test_intermediate_takes_the_wave_grower_at_seven_leaves(monkeypatch):
    """``intermediate`` takes the wave grower at any leaf count (a wave of
    1 at ``num_leaves <= 7``), as the JAX trainer routes it."""
    built = []
    real = tgw.make_wave_grower

    def spy(**kw):
        built.append(kw["wave_size"])
        return real(**kw)

    from lightgbmv1_tpu_torch.parallel import trainer
    monkeypatch.setattr(trainer, "make_wave_grower", spy)
    _text({"num_leaves": 7, "monotone_constraints": [1, 0, 0, 0, 0, 0, 0, 0],
           "monotone_constraints_method": "intermediate"}, rounds=1)
    assert built == [1]
    built.clear()
    _text({"num_leaves": 7, "monotone_constraints": [1, 0, 0, 0, 0, 0, 0, 0]},
          rounds=1)
    assert built == []


def test_looped_monotone_is_refused():
    with pytest.raises(NotImplementedError, match=(
            r"wave_loop_rounds=4: monotone constraints propagate child "
            r"bounds between rounds outside the kernel")):
        _text({"monotone_constraints": [1, 0, 0, 0, 0, 0, 0, 0],
               "hist_method": "fused", "wave_loop_rounds": 4})


# ---------------------------------------------------------------------------
# interaction constraints, CEGB and forced splits (item 1, part 1.6)
#
# Trainings against the JAX package's: structures identical, leaves within
# 2e-5, raw predictions within 1.5e-5.  The sequential grower's runs give
# the port the JAX sequential grower's root sums (rows folded in row
# order, JAX grower.py:259-268; the port sums in the device's order), as
# tests/test_torch_categorical.py does.
# ---------------------------------------------------------------------------

import json  # noqa: E402

import scipy.sparse as sp  # noqa: E402

from lightgbmv1_tpu.models import grower as jgrower  # noqa: E402
from lightgbmv1_tpu.parallel import trainer as jtrainer  # noqa: E402

from lightgbmv1_tpu_torch.models import grower as tgrower  # noqa: E402
from lightgbmv1_tpu_torch.parallel import trainer as ttrainer  # noqa: E402
from lightgbmv1_tpu_torch.utils.log import LightGBMError  # noqa: E402

_P16 = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
        "verbosity": -1, "hist_dtype": "f32", "learning_rate": 0.2}


def _p16_data(n=3000, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    logit = (X[:, 0] - X[:, 1] + 0.5 * X[:, 2] * X[:, 3] + 0.3 * X[:, 4]
             + 0.2 * X[:, 5])
    y = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(float)
    return X, y


def _row_order_root_sums(g3):
    return torch.zeros((1, 3), dtype=g3.dtype).index_add_(
        0, torch.zeros(g3.shape[0], dtype=torch.int64), g3)[0]


def _p16_train(growth, extra, n_iter=4, X=None, y=None):
    if X is None:
        X, y = _p16_data()
    p = dict(_P16, tree_growth=growth, **extra)
    if growth == "leafwise":
        p.setdefault("leafwise_wave_size", 4)
    jb = lj.train(p, lj.Dataset(X, label=y), n_iter, verbose_eval=False)
    # CEGB and forced splits send leaf-wise growth to the sequential grower
    sequential = growth in ("leafwise_serial", "leafwise_masked") or (
        growth == "leafwise" and any(k.startswith("cegb") or
                                     k == "forcedsplits_filename"
                                     for k in extra))
    saved = tgrower.root_sums
    if sequential:
        tgrower.root_sums = _row_order_root_sums
    try:
        tb = lt.train(p, lt.Dataset(X, label=y), n_iter, device="cpu")
    finally:
        tgrower.root_sums = saved
    jtrees = jax.device_get(jb._gbdt._device_trees)
    assert len(jtrees) == len(tb._gbdt._device_trees)
    for jt, tt in zip(jtrees, tb._gbdt._device_trees):
        c = tree_arrays_from_numpy(jt._asdict())
        n = int(c.num_leaves)
        assert n == int(tt.num_leaves) > 1
        for f in ("split_feature", "threshold_bin", "default_left",
                  "left_child", "right_child"):
            assert torch.equal(getattr(c, f)[:n - 1],
                               getattr(tt, f)[:n - 1]), f
        np.testing.assert_allclose(tt.leaf_value[:n].numpy(),
                                   c.leaf_value[:n].numpy(), rtol=0,
                                   atol=2e-5)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1.5e-5)
    return jb, tb


def _paths(tree):
    """Each leaf's set of split features along its root path."""
    out = []

    def walk(node, feats):
        if node < 0:
            out.append(feats)
            return
        f = feats | {int(tree.split_feature[node])}
        walk(int(tree.left_child[node]), f)
        walk(int(tree.right_child[node]), f)

    if tree.num_leaves > 1:
        walk(0, frozenset())
    return out


_GROUPS = "[0,1],[2,3,4]"


@pytest.mark.parametrize("growth,extra", [
    ("leafwise", {}), ("leafwise_serial", {}), ("levelwise", {}),
    ("leafwise", {"hist_method": "fused"})],
    ids=["wave", "sequential", "levelwise", "fused"])
def test_interaction_constraints_training_matches_jax(growth, extra):
    """Interaction constraints on each grower (the fused round through its
    per-child mask): the JAX package's trees, and every root-to-leaf path
    inside one group (feature 5 in none: never split on)."""
    jb, tb = _p16_train(growth, dict(extra,
                                     interaction_constraints=_GROUPS))
    groups = [{0, 1}, {2, 3, 4}]
    for t in tb._all_trees():
        for path in _paths(t):
            assert any(path <= g for g in groups), path


def test_interaction_helpers_match_jax():
    """``parse_interaction_constraints`` and ``allowed_features_for``
    (JAX trainer.py:174, grower.py:127) on the same specs and branch
    features."""
    for spec in ("[0,1],[2,3,4]", "[1, 2] , [2,9]", "", "[5]"):
        jg = jtrainer.parse_interaction_constraints(spec, 6)
        tg = ttrainer.parse_interaction_constraints(spec, 6)
        if jg is None:
            assert tg is None
            continue
        np.testing.assert_array_equal(tg, jg)
        rng = np.random.RandomState(1)
        used = rng.rand(8, 6) < 0.3
        got = tgrower.allowed_features_for(torch.as_tensor(tg),
                                           torch.as_tensor(used))
        want = np.stack([np.asarray(jgrower.allowed_features_for(
            jnp.asarray(jg), jnp.asarray(u))) for u in used])
        np.testing.assert_array_equal(got.numpy(), want)


def test_looped_interaction_constraints_are_refused():
    """The persistent loop refuses interaction constraints with the JAX
    reason (JAX trainer.py:662-665)."""
    X, y = _p16_data(1000)
    with pytest.raises(NotImplementedError,
                       match="interaction constraints re-mask features "
                             "per split"):
        lt.train(dict(_P16, hist_method="fused", wave_loop_rounds=2,
                      interaction_constraints=_GROUPS),
                 lt.Dataset(X, label=y), 1, device="cpu")


_CEGB = {
    "split": ("leafwise", {"cegb_penalty_split": 0.004}),
    "coupled": ("leafwise", {"cegb_penalty_feature_coupled":
                             [1.0, 2.0, 3.0, 0.0, 0.0, 5.0],
                             "cegb_tradeoff": 2.0}),
    "lazy": ("leafwise", {"cegb_penalty_feature_lazy":
                          [0.01, 0.02, 0.0, 0.0, 0.05, 0.1],
                          "cegb_penalty_split": 0.001}),
    "all": ("leafwise", {"cegb_penalty_split": 0.002,
                         "cegb_penalty_feature_coupled":
                         [1.0, 0.5, 0.0, 2.0, 0.0, 1.0],
                         "cegb_penalty_feature_lazy":
                         [0.01, 0.0, 0.02, 0.0, 0.05, 0.0]}),
    "levelwise": ("levelwise", {"cegb_penalty_split": 0.002,
                                "cegb_penalty_feature_coupled":
                                [1.0, 2.0, 3.0, 0.0, 0.0, 5.0]}),
}


@pytest.mark.parametrize("name", list(_CEGB))
def test_cegb_training_matches_jax(name):
    """CEGB (split, coupled and lazy penalties): leaf-wise growth routes to
    the sequential grower (the lazy penalty to its masked variant), the
    model's used features and the lazy row marks carry across trees; the
    JAX package's trees each time, and a model other than the plain
    one."""
    growth, extra = _CEGB[name]
    seen = []
    real = tgrower.make_leafwise_grower

    def spy(**kw):
        seen.append(kw.get("partition"))
        return real(**kw)

    ttrainer.make_leafwise_grower = spy
    try:
        jb, tb = _p16_train(growth, extra)
    finally:
        ttrainer.make_leafwise_grower = real
    if growth == "leafwise":
        assert seen == [("cegb_penalty_feature_lazy" not in extra)]
    X, y = _p16_data()
    plain = lt.train(dict(_P16, tree_growth=growth), lt.Dataset(X, label=y),
                     4, device="cpu")
    assert plain.model_to_string() != tb.model_to_string()
    g = tb._gbdt
    used = set()
    for t in tb._all_trees():
        used |= set(t.split_feature[:t.num_leaves - 1].tolist())
    assert set(np.flatnonzero(g._cegb_used.numpy()).tolist()) == used


def test_cegb_sizes_and_levelwise_lazy(capsys):
    """A CEGB feature penalty of the wrong size is fatal; the level-wise
    grower drops the lazy penalty with the JAX warning."""
    X, y = _p16_data(600)
    for knob in ("cegb_penalty_feature_lazy",
                 "cegb_penalty_feature_coupled"):
        with pytest.raises(LightGBMError, match=knob + " should be the "
                           "same size as feature number"):
            lt.train(dict(_P16, **{knob: [1.0, 2.0]}),
                     lt.Dataset(X, label=y), 1, device="cpu")
    from lightgbmv1_tpu_torch.utils import log

    saved = log._level
    try:
        lt.train(dict(_P16, tree_growth="levelwise", verbosity=0,
                      cegb_penalty_feature_lazy=[0.01] * 6),
                 lt.Dataset(X, label=y), 1, device="cpu")
    finally:
        log._level = saved
    assert "lazy feature costs are ignored" in capsys.readouterr().err


def _forced_file(tmp_path, spec):
    path = tmp_path / "forced.json"
    path.write_text(json.dumps(spec))
    return str(path)


_FORCED = {"feature": 2, "threshold": 0.1,
           "left": {"feature": 3, "threshold": -0.2},
           "right": {"feature": 0, "threshold": 0.5,
                     "right": {"feature": 5, "threshold": 0.3}}}


@pytest.mark.parametrize("growth", ["leafwise", "leafwise_serial",
                                    "levelwise"])
def test_forced_splits_training_matches_jax(growth, tmp_path):
    """Forced splits (leaf-wise growth routes to the sequential grower):
    the JAX package's trees, and each tree's top splits the forced ones
    in BFS order."""
    path = _forced_file(tmp_path, _FORCED)
    jb, tb = _p16_train(growth, {"forcedsplits_filename": path})
    for t in tb._all_trees():
        assert int(t.split_feature[0]) == 2
    steps = ttrainer.parse_forced_splits(
        path, tb._gbdt.train_set.bin_mappers, 15)
    jsteps = jtrainer.parse_forced_splits(
        path, jb._gbdt.train_set.bin_mappers, 15)
    np.testing.assert_array_equal(steps, jsteps)
    assert steps.shape == (4, 6)


def test_forced_split_with_an_empty_child_is_skipped(tmp_path):
    """A forced step whose child would be empty is skipped, and so are the
    steps below it (JAX grower.py:481-504): the JAX trees on the
    sequential and level-wise growers."""
    spec = {"feature": 1, "threshold": 40.0,          # every row left
            "right": {"feature": 0, "threshold": 0.0},
            "left": {"feature": 4, "threshold": -0.3}}
    path = _forced_file(tmp_path, spec)
    for growth in ("leafwise_serial", "levelwise"):
        _, tb = _p16_train(growth, {"forcedsplits_filename": path}, 2)
        steps = ttrainer.parse_forced_splits(
            path, tb._gbdt.train_set.bin_mappers, 15)
        for t in tb._all_trees():
            n = t.num_leaves - 1
            # no node splits at the forced step's bin of feature 1
            assert not ((t.split_feature[:n] == 1)
                        & (t.threshold_bin[:n] == steps[0, 3])).any()


def test_forced_split_stats_match_jax():
    """``forced_split_stats`` on a leaf's histogram (NaN, zero-as-missing
    and no missing type; both default directions)."""
    from lightgbmv1_tpu.ops.split import SplitParams as JP

    rng = np.random.RandomState(4)
    B = 16
    hf = rng.rand(B, 3).astype(np.float32)
    hf[:, 0] -= 0.5
    ps = hf.sum(0)
    for mt, nanb, zb in ((0, -1, 3), (1, -1, 5), (2, B - 1, 2)):
        jm = jsplit.FeatureMeta(
            num_bins=jnp.full(1, B, jnp.int32),
            missing_type=jnp.full(1, mt, jnp.int32),
            nan_bin=jnp.full(1, nanb, jnp.int32),
            zero_bin=jnp.full(1, zb, jnp.int32),
            is_categorical=jnp.zeros(1, bool), usable=jnp.ones(1, bool),
            monotone_type=jnp.zeros(1, jnp.int32))
        tm = tsplit.with_tables(tsplit.FeatureMeta(
            num_bins=torch.full((1,), B), missing_type=torch.full((1,), mt),
            nan_bin=torch.full((1,), nanb), zero_bin=torch.full((1,), zb),
            usable=torch.ones(1, dtype=torch.bool)))
        for fbin in (1, 7):
            for fdl in (False, True):
                jl, jr, jg = jgrower.forced_split_stats(
                    jnp.asarray(hf), jnp.asarray(ps), 0, fbin, fdl, jm,
                    JP(lambda_l2=1.0))
                tl, tr, tg = tgrower.forced_split_stats(
                    torch.as_tensor(hf), torch.as_tensor(ps), 0, fbin, fdl,
                    tm, tsplit.SplitParams(lambda_l2=1.0))
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                           rtol=1e-6, atol=1e-6)
                np.testing.assert_allclose(tr.numpy(), np.asarray(jr),
                                           rtol=1e-6, atol=1e-6)
                np.testing.assert_allclose(float(tg), float(jg), rtol=1e-5,
                                           atol=1e-6)


def test_forced_splits_disable_efb(tmp_path, capsys):
    """Under forced splits EFB is disabled with the JAX warning on dense
    data and is fatal on a bundled sparse set (JAX gbdt.py:113-123)."""
    rng = np.random.RandomState(0)
    n = 2000
    X = np.zeros((n, 10))
    which = rng.randint(0, 8, n)
    X[np.arange(n), which] = rng.rand(n) + 0.5
    X[:, 8:] = rng.randn(n, 2)
    y = (X[:, 8] + (which % 2) > 0.5).astype(float)
    path = _forced_file(tmp_path, {"feature": 8, "threshold": 0.0})
    from lightgbmv1_tpu_torch.utils import log

    saved = log._level
    try:
        p = dict(_P16, forcedsplits_filename=path, verbosity=0)
        ds = lt.Dataset(X, label=y, params=p)
        assert ds.construct()._binned.bundle_layout is not None
        b = lt.train(p, ds, 2, device="cpu")
    finally:
        log._level = saved
    assert "EFB disabled" in capsys.readouterr().err
    assert b._gbdt._bundle is None
    assert int(b._all_trees()[0].split_feature[0]) == 8
    dcs = lt.Dataset(sp.csr_matrix(X), label=y, params=p)
    assert dcs.construct()._binned.binned is None
    with pytest.raises(LightGBMError, match="forced splits do not support "
                       "EFB-bundled sparse datasets"):
        lt.train(dict(p, verbosity=-1), dcs, 1, device="cpu")
