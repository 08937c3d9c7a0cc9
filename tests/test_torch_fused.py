"""The fused wave round (K2) and the valid-set routing (K3) of the port,
held against the JAX package's ``ops/wave_fused.py``.

On the CPU the port's ``ops/fused_cuda.fused_round`` / ``route_rows``
compute their plain versions; here they are held to the JAX package's
``make_fused_round`` / ``fused_route_rows`` run in Pallas interpret mode
(as tests/test_wave_fused.py runs them) on the same numpy inputs.  The CUDA
kernels themselves are held to the plain versions on the card by
chip_smoke.py.

Tolerances:
* routing (new leaf ids, labels) is integer: exact;
* the picks (feature, threshold bin, default direction) are decided in a
  tie band (``TIE_RTOL``) that absorbs f32 summation order: identical;
* histograms, gains and child sums: within ``4e-6`` of the absolute mass
  they sum (the bound tests/test_torch_hist.py uses: both sides round each
  row the same way and differ only in their f32 summation order), plus
  1e-6;
* the port's fused round against the port's staged composition: bit for
  bit (the same plain functions on the same values);
* whole trainings: model text identical to the port's staged path; against
  the JAX package's fused training, the tolerances of
  tests/test_torch_train.py (structure identical, leaf values and
  predictions within 2e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightgbmv1_tpu as lj
from lightgbmv1_tpu.models import grower_wave as jgw
from lightgbmv1_tpu.ops import split as jsplit
from lightgbmv1_tpu.ops import wave_fused as jwf

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.models import grower_wave as tgw
from lightgbmv1_tpu_torch.models.convert import tree_arrays_from_numpy
from lightgbmv1_tpu_torch.ops import _build, fused_cuda, hist_cuda
from lightgbmv1_tpu_torch.ops import split as tsplit
from lightgbmv1_tpu_torch.ops import wave_fused as twf
from lightgbmv1_tpu_torch.parallel.trainer import build_trainer

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op pool, and
    beside other pytest workers its spinning threads starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _metas(F, B, rng):
    """The same feature meta for both packages: NaN-missing, zero-missing
    and missing-none features, a 2-bin feature and a narrower bin axis."""
    mt = np.array([1, 2, 0, 0, 0] * -(-F // 5))[:F]
    nb = np.full(F, B)
    nb[3 % F] = 2
    nb[4 % F] = max(2, B - 5)
    nan_bin = np.where(mt == 2, nb - 1, -1)
    zero_bin = np.where(mt == 1, np.minimum(3, nb - 1), 0)
    usable = np.ones(F, bool)
    j = jsplit.FeatureMeta(
        num_bins=jnp.asarray(nb, jnp.int32),
        missing_type=jnp.asarray(mt, jnp.int32),
        nan_bin=jnp.asarray(nan_bin, jnp.int32),
        zero_bin=jnp.asarray(zero_bin, jnp.int32),
        is_categorical=jnp.zeros(F, bool), usable=jnp.asarray(usable),
        monotone_type=jnp.zeros(F, jnp.int32))
    t = tsplit.with_tables(tsplit.FeatureMeta(
        num_bins=torch.as_tensor(nb, dtype=torch.int64),
        missing_type=torch.as_tensor(mt, dtype=torch.int64),
        nan_bin=torch.as_tensor(nan_bin, dtype=torch.int64),
        zero_bin=torch.as_tensor(zero_bin, dtype=torch.int64),
        usable=torch.as_tensor(usable)))
    return j, t, nb


def _round(seed, F, B, N, S, L, sub, rows=None):
    """One routed round's inputs, as numpy: rows over L current leaves
    (bins within each feature's own bin count), S slots of which the last
    is dead (leaf id ``L + S``, no row's), the children's exact sums and,
    in subtraction mode, each slot's parent histogram.  ``rows`` makes the
    round sparse-live by moving rows to a leaf no slot splits: all of
    them (``"none"``), all but one row of the first split (``"one
    row"``), all outside the second 256-row chunk (``"one chunk"``); or
    every row into the first split (``"root"``)."""
    rng = np.random.RandomState(seed)
    jmeta, tmeta, nb = _metas(F, B, rng)
    binned = (rng.randint(0, 1 << 16, (F, N)) % nb[:, None]).astype(np.uint8)
    g3 = np.stack([rng.randn(N), np.abs(rng.randn(N)) + 0.1,
                   np.ones(N)], axis=1).astype(np.float32)
    lids = rng.randint(0, L, N).astype(np.int32)
    live = S - 1
    feats = rng.randint(0, F, S).astype(np.int32)
    thrs = np.array([rng.randint(0, max(nb[f] - 1, 1)) for f in feats],
                    np.int32)
    dls = rng.rand(S) < 0.5
    leafs = rng.choice(L, S, replace=False).astype(np.int32)
    leafs[live:] = L + S                               # dead slot
    if rows is not None:
        idle = np.setdiff1d(np.arange(L), leafs[:live])[0]
        keep = np.zeros(N, bool)
        if rows == "one row":
            keep[N // 3] = True
            lids[N // 3] = leafs[0]
        elif rows == "one chunk":
            keep[256:512] = True
        elif rows == "root":
            keep[:] = True
            lids[:] = leafs[0]
        lids = np.where(keep, lids, idle).astype(np.int32)
    nls = (np.arange(S) + L).astype(np.int32)
    sml = rng.rand(S) < 0.5
    sml[live:] = False
    # the staged partition (grower_wave go_left_s), in numpy
    bk = binned[feats].astype(np.int32)                # (S, N)
    mt = np.asarray(jmeta.missing_type)[feats][:, None]
    na = ((mt == 2) & (bk == np.asarray(jmeta.nan_bin)[feats][:, None])) | (
        (mt == 1) & (bk == np.asarray(jmeta.zero_bin)[feats][:, None]))
    gl = np.where(na, dls[:, None], bk <= thrs[:, None])
    mine = lids[None, :] == leafs[:, None]
    want_leaf = lids + np.sum(np.where(mine & ~gl,
                                       nls[:, None] - lids[None, :], 0), 0)
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
    out = dict(binned=binned, g3=g3, lids=lids, feats=feats, thrs=thrs,
               dls=dls, leafs=leafs, nls=nls, sml=sml, csums=csums,
               mask=mask, want_leaf=want_leaf.astype(np.int32), child=child,
               child_absum=absums[:C], num_leaves=L + S, jmeta=jmeta,
               tmeta=tmeta, F=F, B=B, S=S, sub=sub)
    if sub:
        parent = np.zeros((S + 1, F, B, 3), np.float64)
        slot = np.full(N, S)
        for s in range(live):
            slot[lids == leafs[s]] = s
        for f in range(F):
            np.add.at(parent, (slot, f, binned[f]), g3)
        out["parent"] = parent[:S].astype(np.float32)
    return out


def _port_call(r, precision):
    """The port's fused round (its plain version, on CPU tensors)."""
    fn = twf.make_fused_round(meta=r["tmeta"], params=tsplit.SplitParams(
        min_data_in_leaf=5.0), num_bins=r["B"], precision=precision,
        deep_precision=precision)
    t = torch.from_numpy
    route = dict(leaf_id=t(r["lids"]), feats=t(r["feats"]),
                 thrs=t(r["thrs"]), dls=t(r["dls"]), leafs=t(r["leafs"]),
                 nls=t(r["nls"]), num_leaves=r["num_leaves"])
    return fn(t(r["binned"]), t(r["g3"]), r["S"], mask=t(r["mask"]),
              csums=t(r["csums"]),
              sml=t(r["sml"]) if r["sub"] else None,
              parent=t(r["parent"]) if r["sub"] else None, route=route)


def _jax_call(r, precision):
    fn = jwf.make_fused_round(meta=r["jmeta"], params=jsplit.SplitParams(
        min_data_in_leaf=5.0), num_bins=r["B"], precision=precision,
        deep_precision=precision, interpret=True)
    j = jnp.asarray
    C = 2 * r["S"]
    route = dict(leaf_id=j(r["lids"]), feats=j(r["feats"]),
                 thrs=j(r["thrs"]), dls=j(r["dls"]), leafs=j(r["leafs"]),
                 nls=j(r["nls"]), num_leaves=r["num_leaves"])
    ptab, hsm, _, new_leaf = fn(
        j(r["binned"]), j(r["g3"]), None, r["S"], mask=j(r["mask"]),
        csums=j(r["csums"]),
        constr=jnp.tile(jnp.asarray(jsplit.NO_CONSTRAINT, jnp.float32),
                        (C, 1)),
        depth=jnp.ones(C, jnp.int32), pout=jnp.zeros(C, jnp.float32),
        sml=j(r["sml"]) if r["sub"] else None,
        parent=j(r["parent"]) if r["sub"] else None, route=route)
    return (np.asarray(ptab), None if hsm is None else np.asarray(hsm),
            np.asarray(new_leaf))


# ---------------------------------------------------------------------------
# (a) routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_route_rows_matches_jax(seed):
    """The valid-set router against the JAX package's routing kernel and
    the staged partition formula: exact, with NaN- and zero-missing
    features among the splits."""
    r = _round(seed, 5, 16, 777, 3, 12, sub=False)
    t = torch.from_numpy
    before = fused_cuda.plain_counts["route_rows"]
    got, = twf.fused_route_rows(
        [(t(r["binned"]), t(r["lids"]))], feats=t(r["feats"]),
        thrs=t(r["thrs"]), dls=t(r["dls"]), leafs=t(r["leafs"]),
        nls=t(r["nls"]), num_leaves=r["num_leaves"], meta=r["tmeta"])
    assert fused_cuda.plain_counts["route_rows"] == before + 1
    j = jnp.asarray
    want = np.asarray(jwf.fused_route_rows(
        j(r["binned"]), j(r["lids"]), feats=j(r["feats"]),
        thrs=j(r["thrs"]), dls=j(r["dls"]), leafs=j(r["leafs"]),
        nls=j(r["nls"]), num_leaves=r["num_leaves"], meta=r["jmeta"],
        interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, r["want_leaf"])
    assert (want != r["lids"]).any()        # some rows moved


def test_route_tile_labels():
    """The labels of both modes: the smaller child's slot, or 2s + right;
    the dead slot for a row of no split."""
    r = _round(2, 5, 16, 777, 3, 12, sub=False)
    t = torch.from_numpy
    rmeta = twf.pack_route_meta(t(r["feats"]), t(r["thrs"]), t(r["dls"]),
                                t(r["leafs"]), t(r["nls"]), r["tmeta"],
                                sml=t(r["sml"]))
    dbin = twf.decision_bins(t(r["binned"]), t(r["lids"]), t(r["feats"]),
                             t(r["leafs"]), r["num_leaves"])
    S = r["S"]
    nl, pool = twf.route_tile(dbin, t(r["lids"]), rmeta, nslots=2 * S,
                              sub=False)
    np.testing.assert_array_equal(nl.numpy(), r["want_leaf"])
    np.testing.assert_array_equal(pool.numpy(), r["child"])
    _, sub = twf.route_tile(dbin, t(r["lids"]), rmeta, nslots=S, sub=True)
    child = r["child"]
    in_split = child < 2 * S
    smaller = np.where(r["sml"][child // 2 % S], child % 2 == 0,
                       child % 2 == 1)
    want = np.where(in_split & smaller, child // 2, S)
    np.testing.assert_array_equal(sub.numpy(), want)
    assert twf.route_tile(dbin, t(r["lids"]), rmeta, nslots=0, sub=False,
                          want_label=False)[1] is None


# ---------------------------------------------------------------------------
# (b) the fused round against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["f32", "bf16", "bf16x2"])
@pytest.mark.parametrize("shape", [(5, 16, 777, 3, 12, True),
                                   (5, 16, 777, 3, 12, False),
                                   (28, 64, 2048, 5, 9, True)],
                         ids=["sub", "pool-free", "F28-B64-sub"])
def test_fused_round_matches_jax(shape, precision):
    F, B, N, S, L, sub = shape
    r = _round(11 + F, F, B, N, S, L, sub)
    ptab, hsm, nleaf = (x if x is None else x.numpy()
                        for x in _port_call(r, precision))
    jtab, jhsm, jleaf = _jax_call(r, precision)
    np.testing.assert_array_equal(nleaf, jleaf)
    np.testing.assert_array_equal(nleaf, r["want_leaf"])
    # feature, threshold, default direction: identical
    np.testing.assert_array_equal(ptab[:, 1:4], jtab[:, 1:4])
    fin = np.isfinite(jtab[:, 0])
    np.testing.assert_array_equal(np.isfinite(ptab[:, 0]), fin)
    assert fin.sum() >= 2
    jshift = np.asarray(jax.vmap(lambda p: jsplit.gain_shift(
        p, 0.0, jsplit.SplitParams(min_data_in_leaf=5.0)))(
            jnp.asarray(r["csums"])))
    tol_g = 4e-6 * (np.abs(jtab[:, 0]) + np.abs(jshift)) + 1e-6
    assert (np.abs(ptab[fin, 0] - jtab[fin, 0]) <= tol_g[fin]).all()
    tol_s = 4e-6 * np.concatenate([r["child_absum"]] * 2, 1) + 1e-6
    assert (np.abs(ptab[:, 4:] - jtab[:, 4:]) <= tol_s)[fin].all()
    if sub:
        absum = hist_cuda.index_add_hist(
            torch.from_numpy(r["binned"]),
            [torch.from_numpy(np.abs(r["g3"]))],
            torch.from_numpy(np.minimum(r["child"] // 2, S)), S + 1,
            B)[:S].numpy()
        np.testing.assert_array_equal(hsm[..., 2], jhsm[..., 2])
        assert (np.abs(hsm - jhsm) <= 4e-6 * absum + 1e-6).all()
    else:
        assert hsm is None and jhsm is None


# ---------------------------------------------------------------------------
# (c) the fused round is the staged composition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["f32", "bf16x2"])
@pytest.mark.parametrize("shape", [(5, 16, 777, 3, 12, True),
                                   (5, 16, 777, 3, 12, False),
                                   (28, 64, 4096, 16, 40, True)],
                         ids=["sub", "pool-free", "F28-B64-sub"])
def test_fused_round_is_the_staged_composition(shape, precision):
    """K1's plain histogram of the staged label + ``subtract_child_hists``
    + ``find_best_split`` give the fused round's SplitInfo, hsmall and
    leaf ids bit for bit."""
    F, B, N, S, L, sub = shape
    r = _round(F + S, F, B, N, S, L, sub)
    ptab, hsm, nleaf = _port_call(r, precision)
    t = torch.from_numpy
    child = t(r["child"]).long()
    if sub:
        in_split = child < 2 * S
        smaller = torch.where(t(r["sml"])[child // 2 % S], child % 2 == 0,
                              child % 2 == 1)
        label = torch.where(in_split & smaller, child // 2, S)
    else:
        label = child
    nsl = S if sub else 2 * S
    h = hist_cuda.hist_leaves_ref(t(r["binned"]), t(r["g3"]),
                                  label.to(torch.int32), nsl + 1, B,
                                  precision)[:nsl]
    if sub:
        assert torch.equal(hsm, h)
        order = torch.arange(S)
        leaf_hist = t(r["parent"])
        hist = tgw.subtract_child_hists(h, leaf_hist, order, order,
                                        t(r["sml"]))
    else:
        assert hsm is None
        hist = h
    res = tsplit.find_best_split(hist, t(r["csums"]), r["tmeta"],
                                 t(r["mask"]),
                                 tsplit.SplitParams(min_data_in_leaf=5.0))
    got = twf.unpack_children(ptab, B)
    for name in res._fields:
        a, b = getattr(got, name), getattr(res, name)
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    np.testing.assert_array_equal(nleaf.numpy(), r["want_leaf"])


# ---------------------------------------------------------------------------
# (d) the live-row lists of K2's and K6's list stage
# ---------------------------------------------------------------------------


def _every_row(label, nslots, n_chunks, chunk_rows):
    """A list of every row, live or not: through it the plain round sums
    the label's histograms over all rows, the sum the lists must keep."""
    rows = torch.full((n_chunks * chunk_rows,), -1, dtype=torch.int32)
    rows[:label.shape[0]] = torch.arange(label.shape[0], dtype=torch.int32)
    return rows, None


def _labels(case, N, chunk_rows, nslots, rng):
    """Slot labels (``nslots``: a row of no split) whose live rows are
    ``case``'s; ``"jax route"`` takes the JAX package's ``route_tile`` on
    a round's decision bins."""
    lab = np.full(N, nslots, np.int32)
    if case == "one row":
        lab[N // 3] = 1
    elif case == "full chunk":
        lab[chunk_rows:2 * chunk_rows] = rng.randint(0, nslots, chunk_rows)
    elif case == "last partial chunk":
        tail = N - (N // chunk_rows) * chunk_rows
        lab[N - tail:] = np.where(rng.rand(tail) < 0.5,
                                  rng.randint(0, nslots, tail), nslots)
    elif case == "jax route":
        r = _round(41, 5, 16, N, nslots, 12, sub=True)
        j = jnp.asarray
        rmeta = jwf.pack_route_meta(j(r["feats"]), j(r["thrs"]), j(r["dls"]),
                                    j(r["leafs"]), j(r["nls"]), r["jmeta"],
                                    sml=j(r["sml"]))
        dbin = jwf.decision_bins(j(r["binned"]), j(r["lids"]),
                                 j(r["feats"]), j(r["leafs"]),
                                 r["num_leaves"])
        lab = np.asarray(jwf.route_tile(
            dbin.reshape(1, N), j(r["lids"]).reshape(1, N), rmeta,
            nslots=nslots, sub=True)[1]).reshape(N)
    return lab.astype(np.int32)


@pytest.mark.parametrize("case", ["none", "one row", "full chunk",
                                  "last partial chunk", "jax route"])
def test_live_rows_ref(case):
    """The plain list stage: each chunk's span holds exactly its rows
    whose label is below nslots, in row order, then -1; the counts are
    theirs.  N is no multiple of the chunk, so the last chunk is partial."""
    N, chunk_rows, nslots = 1000, 256, 3
    n_chunks = -(-N // chunk_rows)
    lab = _labels(case, N, chunk_rows, nslots, np.random.RandomState(7))
    rows, counts = fused_cuda.live_rows_ref(torch.from_numpy(lab), nslots,
                                            n_chunks, chunk_rows)
    assert rows.dtype == counts.dtype == torch.int32
    assert rows.shape == (n_chunks * chunk_rows,) and counts.shape == (4,)
    for c in range(n_chunks):
        want = [r for r in range(c * chunk_rows, min(N, (c + 1) * chunk_rows))
                if lab[r] < nslots]
        span = rows[c * chunk_rows:(c + 1) * chunk_rows].tolist()
        assert int(counts[c]) == len(want)
        assert span == want + [-1] * (chunk_rows - len(want))
    live = counts.tolist()
    assert {"none": live == [0] * 4, "one row": live == [0, 1, 0, 0],
            "full chunk": live == [0, 256, 0, 0],
            "last partial chunk": live[:3] == [0] * 3 and live[3] > 0,
            "jax route": 0 < sum(live) < N}[case]


@pytest.mark.parametrize("precision", ["f32", "bf16x2"])
@pytest.mark.parametrize("rows", [None, "none", "one row", "one chunk",
                                  "root"])
@pytest.mark.parametrize("sub", [True, False], ids=["sub", "pool-free"])
def test_round_through_the_list_is_the_row_walk(monkeypatch, sub, rows,
                                                precision):
    """K2's plain version sums its histograms over the listed rows; it
    equals the same round summed over every row, bit for bit: residue,
    hsmall, new leaf ids and labels, on dense and sparse-live rounds."""
    r = _round(23, 5, 16, 2048, 3, 12, sub, rows)
    got = _port_call(r, precision)
    monkeypatch.setattr(fused_cuda, "live_rows_ref", _every_row)
    want = _port_call(r, precision)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("rows", ["none", "one row", "one chunk", "root"])
@pytest.mark.parametrize("sub", [True, False], ids=["sub", "pool-free"])
def test_sparse_round_matches_jax(sub, rows):
    """Sparse-live rounds through the lists against the JAX package's
    fused round (interpret mode): leaf ids exact, picks identical, values
    within the tolerance of test_fused_round_matches_jax."""
    F, B, N, S = 5, 16, 2048, 3
    r = _round(29, F, B, N, S, 12, sub, rows)
    ptab, hsm, nleaf = (x if x is None else x.numpy()
                        for x in _port_call(r, "bf16x2"))
    jtab, jhsm, jleaf = _jax_call(r, "bf16x2")
    np.testing.assert_array_equal(nleaf, jleaf)
    np.testing.assert_array_equal(nleaf, r["want_leaf"])
    np.testing.assert_array_equal(ptab[:, 1:4], jtab[:, 1:4])
    fin = np.isfinite(jtab[:, 0])
    np.testing.assert_array_equal(np.isfinite(ptab[:, 0]), fin)
    jshift = np.asarray(jax.vmap(lambda p: jsplit.gain_shift(
        p, 0.0, jsplit.SplitParams(min_data_in_leaf=5.0)))(
            jnp.asarray(r["csums"])))
    tol_g = 4e-6 * (np.abs(jtab[:, 0]) + np.abs(jshift)) + 1e-6
    assert (np.abs(ptab[fin, 0] - jtab[fin, 0]) <= tol_g[fin]).all()
    tol_s = 4e-6 * np.concatenate([r["child_absum"]] * 2, 1) + 1e-6
    assert (np.abs(ptab[:, 4:] - jtab[:, 4:]) <= tol_s)[fin].all()
    live = int((r["child"] < 2 * S).sum())
    assert {"none": live == 0, "one row": live == 1,
            "one chunk": 0 < live <= 256, "root": live == N}[rows]
    if sub:
        np.testing.assert_array_equal(hsm[..., 2], jhsm[..., 2])
        assert np.abs(hsm - jhsm).max() <= 4e-6 * np.abs(r["g3"]).sum() + 1e-6


def test_scan_pick_is_its_two_halves():
    """``scan_pick`` = ``scan_pick_feature`` + the cross-feature band."""
    rng = np.random.RandomState(5)
    _, meta, _ = _metas(6, 16, rng)
    gains = torch.from_numpy(rng.randn(4, 2, 6, 16).astype(np.float32))
    gains[0, :, :, 3] = 7.0                         # an exact tie
    gains[1] = float("-inf")
    shift = torch.from_numpy(rng.rand(4).astype(np.float32))
    best, feat, thr, dirn = tsplit.scan_pick(gains, shift, meta)
    fbest, sel = tsplit.scan_pick_feature(gains, shift, meta)
    assert torch.equal(fbest, torch.cat([gains[:, 0], gains[:, 1]],
                                        2).max(2).values)
    ci = torch.arange(4)
    assert torch.equal(sel[ci, feat], dirn * 16 + thr)
    assert int(feat[0]) == 0                         # lowest feature wins


def test_pack_unpack_roundtrip():
    rng = np.random.RandomState(7)
    C = 6
    res = tsplit.SplitResult(
        gain=torch.from_numpy(rng.randn(C).astype(np.float32)),
        feature=torch.from_numpy(rng.randint(0, 9, C)),
        threshold_bin=torch.from_numpy(rng.randint(0, 64, C)),
        default_left=torch.from_numpy(rng.rand(C) < 0.5),
        left_sum=torch.from_numpy(rng.randn(C, 3).astype(np.float32)),
        right_sum=torch.from_numpy(rng.randn(C, 3).astype(np.float32)))
    back = twf.unpack_children(twf.pack_children(res), 64)
    for name in res._fields:
        assert torch.equal(getattr(back, name), getattr(res, name)), name
    assert twf.pack_children(res).shape == (C, twf.PACK_COLS)


# ---------------------------------------------------------------------------
# the wrappers' contract
# ---------------------------------------------------------------------------


def test_wrappers_take_the_plain_version_on_the_cpu_only():
    """A CPU tensor takes the plain version (counted), a CUDA launch
    count never moves here, and another device raises."""
    r = _round(3, 5, 16, 300, 3, 12, sub=True)
    fused_cuda.reset_launch_counts()
    _port_call(r, "bf16x2")
    assert fused_cuda.plain_counts == {"fused_round": 1, "route_rows": 0}
    assert fused_cuda.launch_counts == {"fused_round": 0, "route_rows": 0,
                                        "fused_round_packed": 0,
                                        "route_rows_packed": 0}
    assert fused_cuda.bucket_launch_counts == {}
    t = torch.from_numpy
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_cuda.route_rows(t(r["binned"]).to("meta"), t(r["lids"]),
                              t(r["feats"]), None, r["num_leaves"])
    fused_cuda.reset_launch_counts()
    assert not any(fused_cuda.plain_counts.values())
    table = r["tmeta"].table
    assert torch.equal(table, tsplit.feature_table(r["tmeta"]))
    assert table.dtype == torch.int32 and table.shape == (5, 5)
    assert table[3].tolist() == r["tmeta"].zero_bin.tolist()


def test_fused_ineligible_reason():
    assert twf.fused_ineligible_reason(bin_dtype=torch.uint8,
                                       num_bins=64) == ""
    # the JAX package's reasons, word for word (JAX wave_fused.py:1367,
    # :1369)
    assert twf.fused_ineligible_reason(bin_dtype=torch.int16, num_bins=64) \
        == "int16 bins exceed the uint8 one-hot kernel family"
    assert twf.fused_ineligible_reason(bin_dtype=torch.uint8, num_bins=512) \
        == "num_bins > 256 exceeds the uint8 kernel family"
    meta = tsplit.with_tables(tsplit.FeatureMeta(
        *(torch.zeros(2, dtype=torch.int64),) * 4,
        usable=torch.ones(2, dtype=torch.bool)))
    with pytest.raises(NotImplementedError,
                       match="int16 bins exceed the uint8 one-hot kernel "
                       "family"):
        build_trainer(Config.from_dict({"hist_method": "fused",
                                        "num_leaves": 15}), meta,
                      tsplit.SplitParams(), 64, CPU, bin_dtype=torch.int16)


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header rebuilds every source that includes
    it: the header's bytes are in the library's hash."""
    for p in _build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    names = ("hist", "wave_fused", "wave_loop", "predict_walk", "quantize")
    # wave_round.cuh includes prng.cuh (the split scan's extra_trees draw)
    assert [p.name for p in _build.sources("wave_fused")] == [
        "wave_fused.cu", "wave_round.cuh", "hist_tile.cuh", "prng.cuh"]
    assert [p.name for p in _build.sources("wave_loop")] == [
        "wave_loop.cu", "prng.cuh", "wave_round.cuh", "hist_tile.cuh"]
    assert [p.name for p in _build.sources("split_scan_wide")] == [
        "split_scan_wide.cu", "split_scan.cu", "wave_round.cuh",
        "hist_tile.cuh", "prng.cuh"]
    assert [p.name for p in _build.sources("quantize")] == [
        "quantize.cu", "prng.cuh"]
    for hdr, moved in (("hist_tile.cuh", {"hist", "wave_fused", "wave_loop"}),
                       ("wave_round.cuh", {"wave_fused", "wave_loop"}),
                       ("prng.cuh", {"quantize", "wave_loop", "wave_fused"})):
        before = {n: _build.lib_path(n) for n in names}
        path = tmp_path / hdr
        path.write_bytes(path.read_bytes() + b"\n// edited\n")
        after = {n: _build.lib_path(n) for n in names}
        assert {n for n in names if after[n] != before[n]} == moved, hdr


# ---------------------------------------------------------------------------
# (d), (e) whole trainings
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def low_buckets():
    """Both growers bucket their slots from 1 row, so the 4-slot ramp,
    the middle bucket and the sustained (deep) rounds all run here."""
    saved = jgw._BUCKET_MIN_N, tgw._BUCKET_MIN_N
    jgw._BUCKET_MIN_N = tgw._BUCKET_MIN_N = 1
    yield
    jgw._BUCKET_MIN_N, tgw._BUCKET_MIN_N = saved


def _data(seed, n):
    """NaNs (features 0, 1), 30% exact zeros (feature 2), a coarse integer
    feature (3), and feature 5 a copy of 4 (an exact cross-feature tie)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[rng.rand(n) < 0.05, 0] = np.nan
    X[rng.rand(n) < 0.10, 1] = np.nan
    X[rng.rand(n) < 0.30, 2] = 0.0
    X[:, 3] = np.round(X[:, 3] * 2)
    X[:, 5] = X[:, 4]
    logit = (1.2 * np.nan_to_num(X[:, 0]) - np.nan_to_num(X[:, 1])
             + 0.6 * X[:, 2] * X[:, 3] + 0.4 * X[:, 4])
    y = (logit + rng.randn(n) > 0).astype(np.float64)
    return X, y


BASE = {"objective": "binary", "min_data_in_leaf": 5, "verbosity": -1,
        "max_bin": 63, "metric": "binary_logloss,auc"}


def _port_train(params, rounds, n=4096):
    X, y = _data(20, n)
    Xv, yv = _data(21, n // 4)
    ev = {}
    b = lt.train(params, lt.Dataset(X, label=y), rounds,
                 valid_sets=[lt.Dataset(Xv, label=yv)], evals_result=ev,
                 device="cpu")
    return b, ev, Xv


@pytest.mark.parametrize("params,pool_free", [
    (dict(BASE, num_leaves=33, leafwise_wave_size=32, min_data_in_leaf=3),
     False),
    (dict(BASE, num_leaves=15, leafwise_wave_size=8, hist_dtype="f32"),
     True)], ids=["bf16x2-deep", "f32-pool-free"])
def test_fused_training_equals_staged(low_buckets, monkeypatch, params,
                                      pool_free):
    """The port's fused training writes the model text of its staged
    (``hist_method=pallas``) training, with the same metrics every
    iteration: the same plain arithmetic, rounds scheduled as one pass."""
    if pool_free:
        monkeypatch.setattr(tgw, "_SUB_STATE_CAP_BYTES", 0)
    runs = {m: _port_train(dict(params, hist_method=m), 3)
            for m in ("pallas", "fused")}
    assert runs["fused"][0].model_to_string() == \
        runs["pallas"][0].model_to_string()
    assert runs["fused"][1] == runs["pallas"][1]
    assert len(runs["fused"][1]["valid_0"]["auc"]) == 3


@pytest.fixture(scope="module")
def jax_fused_run(low_buckets):
    params = dict(BASE, num_leaves=15, leafwise_wave_size=8,
                  hist_dtype="f32", hist_method="fused")
    X, y = _data(22, 4096)
    Xv, yv = _data(23, 1024)
    jb = lj.train(params, lj.Dataset(X, label=y), 3, verbose_eval=False)
    tb = lt.train(params, lt.Dataset(X, label=y), 3, device="cpu")
    return jb, tb, Xv


def test_fused_training_matches_jax_trees(jax_fused_run):
    """Against the JAX package's fused training: every tree identical in
    structure, leaf values within 2e-5."""
    jb, tb, _ = jax_fused_run
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


def test_fused_training_matches_jax_predictions(jax_fused_run):
    jb, tb, Xv = jax_fused_run
    np.testing.assert_allclose(tb.predict(Xv, raw_score=True),
                               jb.predict(Xv, raw_score=True), rtol=0,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# (f) what the slice does not run raises, naming its ROADMAP item
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("params,match", [
    # bf16x2 with a bf16 deep bucket reachable: the loop's refusal, with
    # the JAX planner's reason (tests/test_torch_wave_loop.py)
    ({"hist_method": "fused", "wave_loop_rounds": 2, "num_leaves": 33,
      "leafwise_wave_size": 32},
     "deep-precision drop would change the accumulate dtype mid-loop"),
    # the fused family's JAX gate (wave_fused.py:1366-1374): no per-node
    # thresholds, no int16 bins
    ({"hist_method": "fused", "extra_trees": True},
     "extra_trees draws per-node randomness inside the scan"),
    ({"hist_method": "fused", "max_bin": 300, "min_data_in_bin": 1},
     "int16 bins exceed the uint8 one-hot kernel family")])
def test_unported_fused_configurations_raise(low_buckets, params, match):
    X, y = _data(24, 512)
    with pytest.raises(NotImplementedError, match=match):
        lt.train({**BASE, "num_leaves": 15, **params},
                 lt.Dataset(X, label=y), 2, device="cpu")


def test_wave_loop_rounds_config():
    assert Config().wave_loop_rounds == 1
    assert Config.from_dict({"wave_loop_rounds": "3"}).wave_loop_rounds == 3
    with pytest.raises(ValueError, match="wave_loop_rounds"):
        Config.from_dict({"wave_loop_rounds": 0})
    # without the fused round the knob changes nothing, as in the JAX
    # package: the staged path trains
    X, y = _data(25, 512)
    b = lt.train({**BASE, "num_leaves": 15, "wave_loop_rounds": 2},
                 lt.Dataset(X, label=y), 1, device="cpu")
    assert b.num_trees() == 1
