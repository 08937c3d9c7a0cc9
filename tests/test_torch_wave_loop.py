"""The persistent wave loop (K6) of the port, held against the JAX
package's ``make_fused_wave_loop`` and against the port's single round.

On the CPU the port's ``ops/loop_cuda.fused_wave_loop`` computes its plain
version (R rounds of the fused round's plain arithmetic, with the
grower's boundary, pick and commit); here it is held to the JAX package's
loop run in Pallas interpret mode on the same numpy inputs, to R single
rounds, and whole looped trainings to single-round ones and to the JAX
package's looped training.  The CUDA kernel itself is held to the plain
version and to R launches of K2 on the card by chip_smoke.py (phase 19).

Tolerances:
* routing (new leaf ids) and the split counts are integer: exact;
* the picks (feature, threshold bin, default direction): identical (a
  tie band absorbs f32 summation order);
* gains within ``4e-6 (GL^2 / (HL + l2) + GR^2 / (HR + l2) + |shift|)
  + 1e-6`` from the JAX row's left and right sums (the terms whose f32
  rounding a gain carries: it is two leaf gains minus the shift, and may
  cancel to far less than them), child sums within
  ``4e-6`` of the absolute mass of the child's rows plus 1e-6, the pool
  within ``4e-6`` of the absolute mass of its leaf's rows at the
  segment's start plus 1e-6 (both packages round each row the same way
  and sum in other f32 orders; the JAX loop sums every round at K slots,
  the port at the round's bucket, so only live rows are compared);
* the port's loop against its own single rounds: bit for bit;
* whole trainings: model text and metrics identical to single-round
  training; against the JAX package's looped training, the tolerances of
  tests/test_torch_fused.py (structure identical, leaf values and
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
from lightgbmv1_tpu.utils import log as jlog

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.models import grower_wave as tgw
from lightgbmv1_tpu_torch.models.convert import tree_arrays_from_numpy
from lightgbmv1_tpu_torch.ops import fused_cuda, loop_cuda, quantize
from lightgbmv1_tpu_torch.ops import split as tsplit
from lightgbmv1_tpu_torch.ops import wave_fused as twf
from lightgbmv1_tpu_torch.parallel import trainer as ttrainer

CPU = torch.device("cpu")
PARAMS = dict(min_data_in_leaf=5.0)
DEEP_REASON = "deep-precision drop would change the accumulate dtype mid-loop"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op pool, and
    beside other pytest workers its spinning threads starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def low_buckets():
    """Both growers bucket their slots from 1 row, so the 4-slot ramp,
    the middle bucket and the sustained (deep) rounds all run here."""
    saved = jgw._BUCKET_MIN_N, tgw._BUCKET_MIN_N
    jgw._BUCKET_MIN_N = tgw._BUCKET_MIN_N = 1
    yield
    jgw._BUCKET_MIN_N, tgw._BUCKET_MIN_N = saved


# ---------------------------------------------------------------------------
# one segment's inputs
# ---------------------------------------------------------------------------


def _metas(F, B, rng):
    """The same feature meta for both packages: NaN-missing, zero-missing
    and missing-none features, a 2-bin feature and a narrower bin axis."""
    mt = np.array([1, 2, 0, 0, 0] * -(-F // 5))[:F]
    nb = np.full(F, B)
    nb[3 % F] = 2
    nb[4 % F] = max(2, B - 5)
    nan_bin = np.where(mt == 2, nb - 1, -1)
    zero_bin = np.where(mt == 1, np.minimum(3, nb - 1), 0)
    j = jsplit.FeatureMeta(
        num_bins=jnp.asarray(nb, jnp.int32),
        missing_type=jnp.asarray(mt, jnp.int32),
        nan_bin=jnp.asarray(nan_bin, jnp.int32),
        zero_bin=jnp.asarray(zero_bin, jnp.int32),
        is_categorical=jnp.zeros(F, bool), usable=jnp.ones(F, bool),
        monotone_type=jnp.zeros(F, jnp.int32))
    t = tsplit.with_tables(tsplit.FeatureMeta(
        num_bins=torch.as_tensor(nb, dtype=torch.int64),
        missing_type=torch.as_tensor(mt, dtype=torch.int64),
        nan_bin=torch.as_tensor(nan_bin, dtype=torch.int64),
        zero_bin=torch.as_tensor(zero_bin, dtype=torch.int64),
        usable=torch.ones(F, dtype=torch.bool)))
    return j, t


def _segment(seed, F, B, N, K, L, nl, sub, ladder, max_depth=-1):
    """A segment's start, as numpy: rows over ``nl`` current leaves, each
    leaf's exact histogram (the pool) and its best split (the frontier
    row, as the grower's store holds it: gain, feature, threshold,
    default left, left and right sums, output, depth)."""
    rng = np.random.RandomState(seed)
    jmeta, tmeta = _metas(F, B, rng)
    nbins = np.asarray(tmeta.num_bins)
    binned = (rng.randint(0, 1 << 16, (F, N)) % nbins[:, None]) \
        .astype(np.uint8)
    g3 = np.stack([rng.randn(N), np.abs(rng.randn(N)) + 0.1, np.ones(N)],
                  axis=1).astype(np.float32)
    lids = rng.randint(0, nl, N).astype(np.int32)
    pool = np.zeros((L, F, B, 3), np.float64)
    for f in range(F):
        np.add.at(pool, (lids, f, binned[f]), g3)
    sums = np.zeros((L, 3), np.float64)
    np.add.at(sums, lids, g3)
    pool, sums = pool.astype(np.float32), sums.astype(np.float32)
    params = tsplit.SplitParams(**PARAMS)
    res = tsplit.find_best_split(
        torch.from_numpy(pool[:nl]), torch.from_numpy(sums[:nl]), tmeta,
        torch.ones((nl, F), dtype=torch.bool), params)
    ft = np.zeros((L, 12), np.float32)
    ft[:, 0] = -np.inf
    ft[:nl] = torch.cat([
        res.gain[:, None], res.feature.float()[:, None],
        res.threshold_bin.float()[:, None], res.default_left.float()[:, None],
        res.left_sum, res.right_sum,
        tsplit.child_leaf_output(torch.from_numpy(sums[:nl]),
                                 params)[:, None],
        torch.from_numpy(rng.randint(0, 3, nl).astype(np.float32))[:, None]],
        dim=1).numpy()
    return dict(binned=binned, g3=g3, lids=lids, pool=pool, ft=ft, nl=nl,
                K=K, L=L, B=B, F=F, sub=sub, ladder=tuple(ladder),
                max_depth=max_depth, mask=np.ones(F, bool), jmeta=jmeta,
                tmeta=tmeta)


def _port_loop(s, rounds, precision, **over):
    t = torch.from_numpy
    kw = dict(rounds=rounds, K=s["K"], slot_buckets=s["ladder"],
              max_depth=s["max_depth"], base_mask=t(s["mask"]),
              num_bins=s["B"], precision=precision, meta=s["tmeta"],
              params=tsplit.SplitParams(**s.get("params", PARAMS)),
              pool=t(s["pool"]) if s["sub"] else None)
    kw.update(over)
    return loop_cuda.fused_wave_loop(t(s["binned"]), t(s["g3"]),
                                     t(s["lids"]), t(s["ft"]), s["nl"], **kw)


def _jax_loop(s, rounds, precision):
    fn = jwf.make_fused_wave_loop(
        meta=s["jmeta"], params=jsplit.SplitParams(**s.get("params", PARAMS)),
        num_bins=s["B"], precision=precision, deep_precision=precision,
        rounds=rounds, interpret=True)
    j = jnp.asarray
    packed, new_leaf, pool = fn(
        j(s["binned"]), j(s["g3"]), j(s["lids"]), j(s["ft"]), s["nl"],
        jax.random.PRNGKey(0), K=s["K"], slot_buckets=s["ladder"],
        quant_buckets=(), max_depth=s["max_depth"], base_mask=j(s["mask"]),
        pool=j(s["pool"]) if s["sub"] else None)
    return (np.asarray(packed), np.asarray(new_leaf),
            None if pool is None else np.asarray(pool))


def _rounds_by_numpy(s, packed, n_split, leaf_after):
    """The frontier replayed in numpy from the packed rows: each round's
    live count (recomputed: top gains > 0 within the leaf budget) and its
    children's leaf ids and absolute row masses (rows of the child after
    the round, ``leaf_after[r]``)."""
    ft, nl, L, K = s["ft"].copy(), s["nl"], s["L"], s["K"]
    out = []
    for r in range(len(n_split)):
        order = np.lexsort((np.arange(L), -ft[:, 0]))[:K]
        n = int(np.sum((ft[order, 0] > 0) & (np.arange(K) < L - nl)))
        assert n == n_split[r], (r, n, n_split[r])
        if n == 0:
            assert not packed[r:].any()
            break
        leafs, nls = order[:n], nl + np.arange(n)
        cleafs = np.stack([leafs, nls], 1).reshape(2 * n)
        absum = np.stack([np.abs(s["g3"])[leaf_after[r] == c].sum(0)
                          for c in cleafs])
        out.append((n, cleafs, absum))
        depth = np.repeat(ft[leafs, 11] + 1, 2)
        ok = (s["max_depth"] <= 0) | (depth < s["max_depth"])
        pk = packed[r, :2 * n]
        ft[cleafs, 0] = np.where(ok, pk[:, 0], -np.inf)
        ft[cleafs, 1:10] = pk[:, 1:10]
        ft[cleafs, 11] = depth
        nl += n
    return out


# ---------------------------------------------------------------------------
# (a) the port's loop against the JAX loop, one call
# ---------------------------------------------------------------------------


_CASES = {
    # F, B, N, K, L, nl, sub, ladder, max_depth, rounds, precision
    "F5-B16-K4-R2-sub": (5, 16, 700, 4, 16, 4, True, (4,), -1, 2, "f32"),
    "F6-B64-K8-R4-pool-free": (6, 64, 1024, 8, 32, 5, False, (4, 8), -1, 4,
                               "bf16x2"),
    "F6-B64-K8-R4-sub-depth": (6, 64, 1024, 8, 32, 5, True, (4, 8), 4, 4,
                               "f32"),
    "F5-B16-K4-R4-exhausted": (5, 16, 700, 4, 9, 4, True, (4,), -1, 4,
                               "bf16x2"),
    # a gain that cancels: 1.39e-4 from the JAX loop, within its terms'
    # bound, past one scaled by the gain itself
    "F6-B16-K8-R4-pool-free-bf16x2": (6, 16, 1024, 8, 32, 5, False, (4, 8),
                                      -1, 4, "bf16x2"),
}


def _check_against_jax(s, R, prec, min_rounds=2):
    """The port's loop against the JAX loop on segment ``s``: leaf ids
    and picks exact, split counts exact (replayed from the packed rows),
    gains within 4e-6 of the terms that cancel in them (the two leaf gains
    of the JAX row's left and right sums, and the shift) and sums and the
    pool within 4e-6 of their rows' absolute sums.  Returns the live
    rounds."""
    packed, new_leaf, pool, n_split = (
        x if x is None else x.numpy() for x in _port_loop(s, R, prec))
    jpacked, jleaf, jpool = _jax_loop(s, R, prec)
    np.testing.assert_array_equal(new_leaf, jleaf)
    K, L, F, B = s["K"], s["L"], s["F"], s["B"]
    assert packed.shape == jpacked.shape == (R, 2 * K, twf.PACK_COLS)
    leaf_after = [_port_loop(s, r + 1, prec)[1].numpy()
                  for r in range(R - 1)] + [new_leaf]
    rounds = _rounds_by_numpy(s, packed, n_split, leaf_after)
    assert len(rounds) >= min_rounds
    params = jsplit.SplitParams(**s.get("params", PARAMS))
    for r, (n, _, absum) in enumerate(rounds):
        p, q = packed[r, :2 * n], jpacked[r, :2 * n]
        np.testing.assert_array_equal(p[:, 1:4], q[:, 1:4])
        fin = np.isfinite(q[:, 0])
        np.testing.assert_array_equal(np.isfinite(p[:, 0]), fin)
        shift = np.asarray(jax.vmap(lambda c: jsplit.gain_shift(
            c, 0.0, params))(jnp.asarray(q[:, 4:7] + q[:, 7:10])))
        lgain, rgain = (np.asarray(jax.vmap(lambda c: jsplit.leaf_gain(
            c[0], c[1], params))(jnp.asarray(q[:, cols])))
            for cols in (slice(4, 7), slice(7, 10)))
        tol_g = 4e-6 * (np.abs(lgain) + np.abs(rgain) + np.abs(shift)) \
            + 1e-6
        assert (np.abs(p[fin, 0] - q[fin, 0]) <= tol_g[fin]).all()
        tol_s = 4e-6 * np.concatenate([absum] * 2, 1) + 1e-6
        assert (np.abs(p[:, 4:] - q[:, 4:]) <= tol_s)[fin].all()
    if s["sub"]:
        # every leaf's rows sat in one leaf at the segment's start
        anc = np.zeros(L, np.int64)
        anc[new_leaf] = s["lids"]
        absum = np.zeros((L, F, B, 3))
        for f in range(F):
            np.add.at(absum, (s["lids"], f, s["binned"][f]),
                      np.abs(s["g3"]))
        np.testing.assert_array_equal(pool[..., 2], jpool[..., 2])
        assert (np.abs(pool - jpool) <= 4e-6 * absum[anc] + 1e-6).all()
    else:
        assert pool is None and jpool is None
    return rounds, n_split, pool


@pytest.mark.parametrize("case", list(_CASES))
def test_loop_matches_jax(case):
    F, B, N, K, L, nl, sub, ladder, max_depth, R, prec = _CASES[case]
    s = _segment(sum(map(ord, case)), F, B, N, K, L, nl, sub, ladder,
                 max_depth)
    rounds, n_split, pool = _check_against_jax(s, R, prec)
    if case.endswith("exhausted"):
        assert len(rounds) < R and n_split[len(rounds)] == 0
    if sub:
        assert not np.array_equal(pool, s["pool"])


@pytest.mark.parametrize("rows", ["none", "one row", "one chunk", "root"])
@pytest.mark.parametrize("sub", [True, False], ids=["sub", "pool-free"])
def test_sparse_loop_matches_jax(sub, rows):
    """Sparse-live segments (``_parked``: no row held, one, one chunk's,
    every row in the best leaf) against the JAX loop with
    ``test_loop_matches_jax``'s tolerances."""
    s = _parked(_segment(41 + sub, 6, 64, 1024, 8, 32, 5, sub, (4, 8)),
                rows)
    rounds, _, _ = _check_against_jax(s, 4, "bf16x2" if sub else "f32", 1)
    held = int((s["lids"] != s["L"] - 1).sum())
    assert held == {"none": 0, "one row": 1, "one chunk": 256,
                    "root": 1024}[rows]
    top = int(np.argmax(s["ft"][:s["nl"], 0]))
    assert top in rounds[0][1]      # the first round splits the best leaf


# ---------------------------------------------------------------------------
# (b) the loop is R single rounds
# ---------------------------------------------------------------------------


def _single_rounds(s, R, precision, key=None, quant_buckets=()):
    """R calls of the port's grower-facing single round
    (``make_fused_round``) with the frontier kept in numpy between them:
    top-k by sort, the live count, the bucket, the slots, then the commit
    of the children's rows and pool.  A round of a bucket in
    ``quant_buckets`` is quantized under its round key from the tree key
    ``key``, and every round carries its scales (the tree's, or ones), as
    the grower runs them."""
    t = torch.from_numpy
    meta, params = s["tmeta"], tsplit.SplitParams(**PARAMS)
    fn = twf.make_fused_round(meta=meta, params=params, num_bins=s["B"],
                              precision=precision, deep_precision=precision)
    ft, nl, L, K, F = s["ft"].copy(), s["nl"], s["L"], s["K"], s["F"]
    leaf = t(s["lids"])
    pool = t(s["pool"].copy()) if s["sub"] else None
    packed = torch.zeros((R, 2 * K, twf.PACK_COLS))
    zq = scale3 = None
    if quant_buckets:
        zq, scale3 = quantize.prequantize_rows(t(s["g3"]))
    for r in range(R):
        order = np.lexsort((np.arange(L), -ft[:, 0]))[:K]
        n = int(np.sum((ft[order, 0] > 0) & (np.arange(K) < L - nl)))
        if n == 0:
            break
        S = [b for b in s["ladder"] if b >= n][0]
        leafs, nls = order[:n], nl + np.arange(n)
        rows = ft[leafs]

        def slot(v, fill, width=S):
            return t(np.concatenate([v, np.full((width - len(v),)
                                                + v.shape[1:], fill,
                                                v.dtype)]))

        sml = rows[:, 6] <= rows[:, 9]
        csums = np.stack([rows[:, 4:7], rows[:, 7:10]], 1).reshape(2 * n, 3)
        route = dict(leaf_id=leaf, feats=slot(rows[:, 1].astype(np.int64), 0),
                     thrs=slot(rows[:, 2].astype(np.int64), 0),
                     dls=slot(rows[:, 3] != 0, False),
                     leafs=slot(leafs.astype(np.int64), L),
                     nls=slot(nls.astype(np.int64), 0), num_leaves=L)
        quant = S in quant_buckets
        sc = None
        if quant_buckets:
            sc = (scale3 if quant else torch.ones(3)).expand(
                S if s["sub"] else 2 * S, 3).contiguous()
        pk, hsm, leaf = fn(
            t(s["binned"]), t(s["g3"]), S,
            quant_key=tgw.round_key(key, nl) if quant else None, zq=zq,
            scale=sc,
            mask=slot(np.ones((2 * n, F), bool), False, 2 * S),
            csums=slot(csums, np.float32(1.0), 2 * S),
            sml=slot(sml, False) if s["sub"] else None,
            parent=slot(pool[t(leafs)].numpy(), np.float32(0.0))
            if s["sub"] else None, route=route)
        packed[r, :2 * S] = pk
        cleafs = np.stack([leafs, nls], 1).reshape(2 * n)
        depth = np.repeat(rows[:, 11] + 1, 2)
        ok = (s["max_depth"] <= 0) | (depth < s["max_depth"])
        live = pk[:2 * n].numpy()
        ft[cleafs, 0] = np.where(ok, live[:, 0], -np.inf)
        ft[cleafs, 1:10] = live[:, 1:10]
        ft[cleafs, 11] = depth
        if s["sub"]:
            pool[t(cleafs)] = twf.subtract_children(
                hsm[:n], pool[t(leafs)], t(sml),
                None if sc is None else sc[:n])
        nl += n
    return packed, leaf, pool


@pytest.mark.parametrize("sub", [True, False], ids=["sub", "pool-free"])
@pytest.mark.parametrize("precision", ["f32", "bf16x2"])
def test_loop_is_single_rounds(sub, precision):
    """Over a multi-bucket ladder (4, 16, 24: the buckets change from
    round to round), the loop's packed rows, leaf ids and pool equal R
    single rounds bit for bit."""
    s = _segment(31 + sub, 6, 64, 2048, 24, 96, 3, sub, (4, 16, 24))
    R = 4
    packed, new_leaf, pool, n_split = _port_loop(s, R, precision)
    want = _single_rounds(s, R, precision)
    assert (n_split > 0).sum() >= 3
    assert len({[b for b in s["ladder"] if b >= int(n)][0]
                for n in n_split if n > 0}) >= 2        # buckets changed
    assert torch.equal(packed, want[0])
    assert torch.equal(new_leaf, want[1])
    assert (pool is None and want[2] is None) or torch.equal(pool, want[2])


# ---------------------------------------------------------------------------
# (c) looped training equals single-round training
# ---------------------------------------------------------------------------


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
        "max_bin": 63, "metric": "binary_logloss,auc",
        "hist_method": "fused"}


def _port_train(params, iters=3, n=4096):
    X, y = _data(20, n)
    Xv, yv = _data(21, n // 4)
    ev = {}
    b = lt.train(params, lt.Dataset(X, label=y), iters,
                 valid_sets=[lt.Dataset(Xv, label=yv)], evals_result=ev,
                 device="cpu")
    return b.model_to_string(), ev


_TRAIN = {
    "bf16x2-deep": dict(BASE, num_leaves=33, leafwise_wave_size=32,
                        min_data_in_leaf=3, hist_dtype_deep="bf16x2"),
    "f32-pool-free": dict(BASE, num_leaves=15, leafwise_wave_size=8,
                          hist_dtype="f32"),
}


@pytest.mark.parametrize("rounds", [2, 4, 64])
@pytest.mark.parametrize("case", list(_TRAIN))
def test_looped_training_equals_single_round(low_buckets, monkeypatch, case,
                                             rounds):
    if case.endswith("pool-free"):
        monkeypatch.setattr(tgw, "_SUB_STATE_CAP_BYTES", 0)
    loop_cuda.reset_launch_counts()
    looped = _port_train(dict(_TRAIN[case], wave_loop_rounds=rounds))
    segments = loop_cuda.plain_counts["fused_wave_loop"]
    single = _port_train(_TRAIN[case])
    assert looped[0] == single[0]
    assert looped[1] == single[1]
    assert len(looped[1]["valid_0"]["auc"]) == 3
    # a segment a tree at least; more when a tree outlasts R rounds
    assert segments >= 3 and (rounds > 2 or segments > 3)


def test_wave_loop_rounds_2_trains():
    """``hist_method=fused, wave_loop_rounds=2`` trains (it raised while
    K6 was not ported), and as the single round does."""
    params = dict(BASE, num_leaves=15)
    X, y = _data(24, 512)
    texts = [lt.train(dict(params, wave_loop_rounds=r),
                      lt.Dataset(X, label=y), 2,
                      device="cpu").model_to_string() for r in (2, 1)]
    assert texts[0] == texts[1]


# ---------------------------------------------------------------------------
# (d) against the JAX package's looped training
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_loop_run():
    params = dict(BASE, num_leaves=31, leafwise_wave_size=8,
                  wave_loop_rounds=4, hist_dtype="f32")
    X, y = _data(31, 1024)
    Xv, _ = _data(32, 512)
    lines = []
    jlog.register_callback(lines.append)
    try:
        jb = lj.train(dict(params, verbosity=1), lj.Dataset(X, label=y), 3,
                      verbose_eval=False)
    finally:
        jlog.register_callback(None)
    loop_cuda.reset_launch_counts()
    tb = lt.train(params, lt.Dataset(X, label=y), 3, device="cpu")
    return jb, tb, Xv, lines, dict(loop_cuda.plain_counts)


def test_looped_training_matches_jax_trees(jax_loop_run):
    """The JAX package's loop engaged (its log says so) and the port's
    ran; every tree identical in structure, leaf values within 2e-5."""
    jb, tb, _, lines, counts = jax_loop_run
    assert any("persistent multi-round wave loop engaged" in ln
               for ln in lines), lines
    assert counts["fused_wave_loop"] >= 3
    jtrees = jax.device_get(jb._gbdt._device_trees)
    ttrees = tb._gbdt._device_trees
    assert len(jtrees) == len(ttrees) == 3
    for jt, tt in zip(jtrees, ttrees):
        carried = tree_arrays_from_numpy(jt._asdict())
        n = int(carried.num_leaves)
        assert n == int(tt.num_leaves) > 8          # more than one round
        for f in ("split_feature", "threshold_bin", "default_left",
                  "missing_type", "left_child", "right_child"):
            assert torch.equal(getattr(carried, f)[:n - 1],
                               getattr(tt, f)[:n - 1]), f
        assert torch.equal(carried.leaf_count[:n], tt.leaf_count[:n])
        np.testing.assert_allclose(tt.leaf_value[:n].numpy(),
                                   carried.leaf_value[:n].numpy(),
                                   rtol=0, atol=2e-5)


def test_looped_training_matches_jax_predictions(jax_loop_run):
    jb, tb, Xv, _, _ = jax_loop_run
    np.testing.assert_allclose(tb.predict(Xv, raw_score=True),
                               jb.predict(Xv, raw_score=True), rtol=0,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# (e) the planner and the refusals
# ---------------------------------------------------------------------------


_PLAN = dict(N=4096, F=8, num_bins=32, K=32, L=64, use_sub=True,
             slot_buckets=(4, 16, 32), precision="bf16x2",
             deep_precision="bf16x2")


@pytest.mark.parametrize("over", [
    dict(rounds=1), dict(rounds=4, use_mc=True),
    dict(rounds=4, deep_precision="bf16")],
    ids=["single-round", "monotone", "deep-precision"])
def test_plan_kept_gates_match_jax(over):
    """The gates about the configuration refuse with the JAX planner's
    reason, word for word."""
    args = dict(_PLAN, **over)
    plan = twf.plan_wave_loop(**args)
    jplan = jwf.plan_wave_loop(**args)
    assert not plan["eligible"] and not jplan["eligible"]
    assert plan["reason"] == jplan["reason"] != ""
    assert plan["rounds"] == jplan["rounds"] == 1
    assert plan["ladder"] == jplan["ladder"] == (4, 16, 32)


def test_plan_caps_rounds_and_sizes_the_state():
    plan = twf.plan_wave_loop(**dict(_PLAN, rounds=100))
    assert plan["eligible"] and plan["rounds"] == 64
    assert jwf.plan_wave_loop(**dict(_PLAN, rounds=100))["rounds"] == 64
    assert twf.plan_wave_loop(**dict(_PLAN, rounds=4))["rounds"] == 4
    # frontier, two leaf-id arrays and the pool; pool-free has no pool
    assert plan["state_bytes"] == 64 * 12 * 4 + 2 * 4096 * 4 \
        + 64 * 8 * 32 * 3 * 4
    free = twf.plan_wave_loop(**dict(_PLAN, rounds=4, use_sub=False))
    assert free["state_bytes"] == 64 * 12 * 4 + 2 * 4096 * 4
    assert plan["total_bytes"] > plan["state_bytes"] + plan["partial_bytes"]
    # another deep precision is fine where no deep bucket is reachable
    for over in (dict(K=16, slot_buckets=(4, 16)), dict(slot_buckets=(32,))):
        assert twf.plan_wave_loop(**{**_PLAN, "rounds": 4,
                                     "deep_precision": "bf16", **over}
                                  )["eligible"]


_LIMITS = dict(smem_bytes=109568, blocks_per_sm=2, sms=132, cooperative=True,
               free_bytes=1 << 34)


@pytest.mark.parametrize("over,reason", [
    (dict(cooperative=False), "cooperative launch"),
    (dict(blocks_per_sm=0), "no block of the loop kernel is resident on an "
     "SM at 109568 B"),
    (dict(free_bytes=1000), "exceeds the device's free memory")],
    ids=["cooperative", "occupancy", "memory"])
def test_plan_card_gates(over, reason):
    """The card's own gates take the place of the JAX planner's VMEM and
    row-tile gates, each with its reason."""
    plan = twf.plan_wave_loop(rounds=4, limits=dict(_LIMITS, **over),
                              **_PLAN)
    assert not plan["eligible"] and reason in plan["reason"]
    ok = twf.plan_wave_loop(rounds=4, limits=_LIMITS, **_PLAN)
    assert ok["eligible"] and ok["smem_bytes"] == 109568
    assert ok["blocks_per_sm"] == 2 and ok["cooperative"]


def test_single_round_never_builds_a_loop(monkeypatch):
    def refuse(**kw):
        raise AssertionError("make_fused_wave_loop called at rounds=1")

    monkeypatch.setattr(ttrainer, "make_fused_wave_loop", refuse)
    _, tmeta = _metas(6, 64, np.random.RandomState(0))
    grow = ttrainer.build_trainer(
        Config.from_dict({"hist_method": "fused", "num_leaves": 15}), tmeta,
        tsplit.SplitParams(), 64, CPU, num_data=4096)
    assert callable(grow)
    X, y = _data(28, 512)
    b = lt.train(dict(BASE, num_leaves=15), lt.Dataset(X, label=y), 1,
                 device="cpu")
    assert b.num_trees() == 1


def test_trainer_refuses_deep_precision_drop(low_buckets):
    """bf16x2 with a bf16 deep bucket reachable (K = 32, a multi-bucket
    ladder) cannot run as one loop: the port raises with the JAX reason
    where the JAX package falls back to the single round."""
    X, y = _data(29, 512)
    params = dict(BASE, num_leaves=33, leafwise_wave_size=32,
                  hist_dtype="bf16x2", hist_dtype_deep="", wave_loop_rounds=4)
    with pytest.raises(NotImplementedError, match=DEEP_REASON):
        lt.train(params, lt.Dataset(X, label=y), 1, device="cpu")
    # the same knobs at the deep bucket's own precision train
    b = lt.train(dict(params, hist_dtype_deep="bf16x2"),
                 lt.Dataset(X, label=y), 1, device="cpu")
    assert b.num_trees() == 1


# ---------------------------------------------------------------------------
# (f) the wrapper's contract
# ---------------------------------------------------------------------------


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    """A CPU tensor takes the plain version (counted), a CUDA launch count
    never moves here, and another device raises."""
    s = _segment(3, 5, 16, 300, 4, 16, 4, True, (4,))
    loop_cuda.reset_launch_counts()
    _port_loop(s, 2, "bf16x2")
    assert loop_cuda.plain_counts == {"fused_wave_loop": 1}
    assert loop_cuda.launch_counts == {"fused_wave_loop": 0,
                                       "fused_wave_loop_packed": 0}
    assert loop_cuda.bucket_launch_counts == {}
    t = torch.from_numpy
    with pytest.raises(ValueError, match="cpu or cuda"):
        loop_cuda.fused_wave_loop(
            t(s["binned"]).to("meta"), t(s["g3"]), t(s["lids"]), t(s["ft"]),
            4, rounds=2, K=4, slot_buckets=(4,), max_depth=-1,
            base_mask=t(s["mask"]), num_bins=16, precision="f32",
            meta=s["tmeta"], params=tsplit.SplitParams())
    loop_cuda.reset_launch_counts()
    assert not any(loop_cuda.plain_counts.values())


def test_plain_loop_leaves_its_inputs():
    """The loop returns new tensors; its inputs stay as they were."""
    s = _segment(5, 5, 16, 300, 4, 16, 4, True, (4,))
    t = torch.from_numpy
    ins = [t(s[k].copy()) for k in ("lids", "ft", "pool")]
    before = [x.clone() for x in ins]
    packed, new_leaf, pool, n_split = loop_cuda.fused_wave_loop(
        t(s["binned"]), t(s["g3"]), ins[0], ins[1], 4, rounds=2, K=4,
        slot_buckets=(4,), max_depth=-1, base_mask=t(s["mask"]),
        num_bins=16, precision="f32", meta=s["tmeta"],
        params=tsplit.SplitParams(**PARAMS), pool=ins[2])
    assert all(torch.equal(a, b) for a, b in zip(ins, before))
    assert n_split.dtype == torch.int32 and int(n_split[0]) > 0
    assert not torch.equal(new_leaf, ins[0])


# ---------------------------------------------------------------------------
# (g) the rounds through the live-row lists, and the stage stamps
# ---------------------------------------------------------------------------


def _every_row(label, nslots, n_chunks, chunk_rows):
    """A list of every row, live or not: through it the plain round sums
    the label's histograms over all rows, the sum the lists must keep."""
    rows = torch.full((n_chunks * chunk_rows,), -1, dtype=torch.int32)
    rows[:label.shape[0]] = torch.arange(label.shape[0], dtype=torch.int32)
    return rows, None


def _parked(s, rows):
    """The segment with rows moved to the frontier's last leaf, which no
    round splits: all of them (``"none"``), all but one row of the best
    leaf (``"one row"``), all outside the second 256-row chunk (``"one
    chunk"``); or every row moved into the best leaf (``"root"``).  Each
    current leaf keeps its recorded split (gain, feature, threshold,
    default left, depth); its sums, output and pool histograms become
    those of the rows it now holds, so a leaf left empty still splits.
    ``lambda_l2 = 1``: an empty child's scan gives -inf past its gates,
    not 0 / 0."""
    lids = s["lids"].copy()
    L, nl, F, B = s["L"], s["nl"], s["F"], s["B"]
    top = int(np.argmax(s["ft"][:nl, 0]))
    keep = np.zeros(lids.shape[0], bool)
    if rows == "one row":
        keep[np.flatnonzero(lids == top)[0]] = True
    elif rows == "one chunk":
        keep[256:512] = True
    elif rows == "root":
        lids[:] = top
        keep[:] = True
    lids = np.where(keep, lids, L - 1).astype(np.int32)
    pool = np.zeros((L, F, B, 3), np.float64)
    for f in range(F):
        np.add.at(pool, (lids, f, s["binned"][f]), s["g3"])
    ft, m, t = s["ft"].copy(), s["tmeta"], torch.from_numpy
    feat = ft[:nl, 1].astype(np.int64)
    tf = t(feat)[:, None]
    left = tsplit.go_left_rule(
        torch.arange(B)[None], t(ft[:nl, 2:3].astype(np.int64)),
        t(ft[:nl, 3:4] != 0), m.missing_type[tf], m.nan_bin[tf],
        m.zero_bin[tf]).numpy()                                  # (nl, B)
    h = pool[np.arange(nl), feat]                                # (nl, B, 3)
    lsum, tot = (h * left[..., None]).sum(1), h.sum(1)
    params = dict(PARAMS, lambda_l2=1.0)
    ft[:nl, 4:7], ft[:nl, 7:10] = lsum, tot - lsum
    ft[:nl, 10] = tsplit.child_leaf_output(
        t(tot.astype(np.float32)), tsplit.SplitParams(**params)).numpy()
    return dict(s, lids=lids, pool=pool.astype(np.float32), ft=ft,
                params=params)


@pytest.mark.parametrize("rows", [None, "none", "one row", "one chunk",
                                  "root"])
@pytest.mark.parametrize("sub", [True, False], ids=["sub", "pool-free"])
def test_loop_through_the_list_is_the_row_walk(monkeypatch, sub, rows):
    """K6's plain version runs R plain rounds, each summing its
    histograms over its listed rows; it equals the same rounds summed over
    every row, bit for bit (packed rows, leaf ids, pool, split counts), on
    dense and sparse-live segments over a multi-bucket ladder."""
    s = _segment(37 + sub, 6, 64, 2048, 24, 96, 3, sub, (4, 16, 24))
    if rows is not None:
        s = _parked(s, rows)
    got = _port_loop(s, 4, "bf16x2")
    monkeypatch.setattr(fused_cuda, "live_rows_ref", _every_row)
    want = _port_loop(s, 4, "bf16x2")
    assert int(got[3][0]) > 0
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


def test_stage_split_reads_the_debug_words():
    """``stage_split`` turns K6's debug words (entry and first boundary
    stamps, then each round's stage stamps in ns and its live rows) into
    each live round's stage microseconds; a round of no split ends it.
    The stamps are the card kernel's: a CPU tensor refuses them."""
    stages = loop_cuda.LOOP_STAGES
    R, w = 3, len(stages) + 1
    d = torch.zeros(2 + R * w, dtype=torch.int64)
    d[0], d[1] = 1000, 5000
    t = 5000
    for r in range(2):
        for i in range(len(stages)):
            t += 1000 * (i + 1 + r)
            d[2 + r * w + i] = t
        d[2 + r * w + w - 1] = 100 + r
    out = loop_cuda.stage_split(d, [7, 3, 0])
    assert out == [{"n_split": (7, 3)[r], "live_rows": 100 + r,
                    **{k: float(i + 1 + r) for i, k in enumerate(stages)}}
                   for r in range(2)]
    s = _segment(3, 5, 16, 300, 4, 16, 4, True, (4,))
    with pytest.raises(ValueError, match="card"):
        _port_loop(s, 2, "f32", debug=torch.zeros(2 + 2 * w,
                                                  dtype=torch.int64))
