"""The valid routing (K3) of the port: a row set routed through all of a
tree's rounds of splits in one call, held against the JAX package.

On the CPU ``ops/fused_cuda.route_rows`` is its plain version: the JAX
round's routing (``route_tile`` on the decision bins) applied round after
round.  Here it is held to R successive calls of the JAX package's
``fused_route_rows`` (Pallas in interpret mode, as tests/test_wave_fused.py
runs it), and the wave grower's valid leaf ids, routed once a tree on the
staged, fused and looped paths, to the walk of the finished tree.  The CUDA
kernel itself is held to this plain version on the card by chip_smoke.py.

Tolerances:
* leaf ids are integers: exact;
* the valid metric history against the JAX package's training: binary
  logloss within 1e-6 and AUC within 1e-4, the tolerances of
  tests/test_torch_train.py (the trees are identical in structure, the
  leaf values within 2e-5: the two split scans sum in other f32 orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbmv1_tpu as lj
from lightgbmv1_tpu.models import grower_wave as jgw
from lightgbmv1_tpu.ops import wave_fused as jwf

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.models import grower_wave as tgw
from lightgbmv1_tpu_torch.models.tree import tree_leaf_index_binned
from lightgbmv1_tpu_torch.ops import fused_cuda, hist_cuda
from lightgbmv1_tpu_torch.ops import wave_fused as twf

from test_torch_fused import _metas


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op pool, and
    beside other pytest workers its spinning threads starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_rounds(seed, F, B, slots):
    """A tree grown in rounds from the root, each round padded to its
    slot bucket S with dead slots (leaf id ``L``, no row's), as the
    grower's slot arrays are: ``slots`` lists (S, live splits) a round.
    Live splits take leaves of the tree so far at random, on random
    features with thresholds inside the feature's bin count; a round of
    no live split moves no row.  Returns numpy (S,) arrays a round, the
    leaf count L and both packages' metas."""
    rng = np.random.RandomState(seed)
    jmeta, tmeta, nb = _metas(F, B, rng)
    nl = 1
    live = sum(n for _, n in slots)
    L = 1 + live
    rounds = []
    for S, n in slots:
        n = min(n, nl)
        feats = rng.randint(0, F, S).astype(np.int32)
        thrs = np.array([rng.randint(0, max(nb[f] - 1, 1)) for f in feats],
                        np.int32)
        leafs = np.full(S, L, np.int32)
        leafs[:n] = rng.choice(nl, n, replace=False)
        nls = np.zeros(S, np.int32)
        nls[:n] = nl + np.arange(n)
        rounds.append(dict(feats=feats, thrs=thrs, dls=rng.rand(S) < 0.5,
                           leafs=leafs, nls=nls))
        nl += n
    return rounds, L, jmeta, tmeta, nb


def _port(binned, rounds, L, tmeta, packed=False, lids=None):
    """The port's router on all rounds at once (one call)."""
    t = torch.from_numpy
    cat = {k: t(np.concatenate([r[k] for r in rounds])) for k in rounds[0]}
    offsets = t(np.cumsum([0] + [len(r["feats"]) for r in rounds])
                .astype(np.int32))
    N = binned.shape[1]
    lids = torch.zeros(N, dtype=torch.int32) if lids is None else t(lids)
    return twf.fused_route_rows([(t(binned), lids)], num_leaves=L,
                                meta=tmeta, packed=packed, offsets=offsets,
                                **cat)[0]


def _jax(binned, rounds, L, jmeta, packed=False, lids=None):
    """R successive calls of the JAX package's round router."""
    j = jnp.asarray
    N = binned.shape[1]
    lids = j(np.zeros(N, np.int32) if lids is None else lids)
    for r in rounds:
        lids = jwf.fused_route_rows(
            j(binned), lids, feats=j(r["feats"]), thrs=j(r["thrs"]),
            dls=j(r["dls"]), leafs=j(r["leafs"]), nls=j(r["nls"]),
            num_leaves=L, meta=jmeta, interpret=True, packed=packed)
    return np.array(lids)


# ---------------------------------------------------------------------------
# (a) all rounds in one call against R calls of the JAX router
# ---------------------------------------------------------------------------

SLOTS = {
    # the slot buckets of a 255-leaf wave: the 4-slot ramp, then 16 and 63
    "ramp 4/16/63": [(4, 1), (4, 2), (4, 4), (16, 8), (16, 16), (63, 32),
                     (63, 63), (63, 9)],
    # dead slots only in the middle round: no row moves there
    "idle round": [(4, 1), (4, 2), (16, 0), (16, 3)],
}


@pytest.mark.parametrize("packed", [False, True], ids=["u8", "packed"])
@pytest.mark.parametrize("case", list(SLOTS))
def test_tree_routing_matches_jax_rounds(case, packed):
    """Leaf ids after every round at once equal R successive calls of the
    JAX package's router, exactly: NaN- and zero-missing features among
    the splits, dead slots in every round, u8 and 4-bit packed bins."""
    F, B = (5, 16) if packed else (6, 32)
    rounds, L, jmeta, tmeta, nb = _tree_rounds(3, F, B, SLOTS[case])
    rng = np.random.RandomState(4)
    binned = (rng.randint(0, 1 << 16, (F, 901)) % nb[:, None]) \
        .astype(np.uint8)
    stored = hist_cuda.pack4bit(torch.from_numpy(binned)).numpy() \
        if packed else binned
    before = fused_cuda.plain_counts["route_rows"]
    got = _port(stored, rounds, L, tmeta, packed)
    assert fused_cuda.plain_counts["route_rows"] == before + 1
    want = _jax(stored, rounds, L, jmeta, packed)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 4                    # rows spread out
    if case == "idle round":
        # the rounds around the idle one: the same ids as without it
        np.testing.assert_array_equal(
            _jax(stored, rounds[:2], L, jmeta, packed),
            _jax(stored, rounds[:3], L, jmeta, packed))


def test_tree_routing_of_no_rows():
    """0 rows: nothing routed, no call made."""
    rounds, L, _, tmeta, _ = _tree_rounds(5, 4, 16, SLOTS["idle round"])
    before = fused_cuda.plain_counts["route_rows"]
    got = _port(np.zeros((4, 0), np.uint8), rounds, L, tmeta)
    assert got.shape == (0,) and got.dtype == torch.int32
    assert fused_cuda.plain_counts["route_rows"] == before


def test_tree_routing_is_the_rounds_one_by_one():
    """The one call equals the port's own router called a round at a time
    (R = 1 calls chained), from leaf ids that are not the root's."""
    F, B = 6, 32
    rounds, L, jmeta, tmeta, nb = _tree_rounds(6, F, B,
                                               SLOTS["ramp 4/16/63"])
    rng = np.random.RandomState(7)
    binned = (rng.randint(0, 1 << 16, (F, 700)) % nb[:, None]) \
        .astype(np.uint8)
    lids = rng.randint(0, 3, 700).astype(np.int32)     # below round 2's
    ids = torch.from_numpy(lids)
    for r in rounds[2:]:
        ids = _port(binned, [r], L, tmeta, lids=ids.numpy())
    np.testing.assert_array_equal(
        _port(binned, rounds[2:], L, tmeta, lids=lids).numpy(), ids.numpy())


# ---------------------------------------------------------------------------
# (b) one round: the call as it was
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_one_round_is_the_round_router(seed):
    """R = 1 (offsets (0, S), or none) is the one-round router: K3's plain
    version with no offsets, and the JAX package's ``fused_route_rows``."""
    F, B = 5, 16
    rounds, L, jmeta, tmeta, nb = _tree_rounds(10 + seed, F, B,
                                               [(4, 1), (16, 16)])
    rng = np.random.RandomState(seed)
    binned = (rng.randint(0, 1 << 16, (F, 777)) % nb[:, None]) \
        .astype(np.uint8)
    lids = _jax(binned, rounds[:1], L, jmeta)          # after round 0
    r = rounds[1]
    t = torch.from_numpy
    rmeta = twf.pack_route_meta(t(r["feats"]), t(r["thrs"]), t(r["dls"]),
                                t(r["leafs"]), t(r["nls"]), tmeta)
    args = (t(binned), t(lids), t(r["feats"]), rmeta, L)
    no_offsets = fused_cuda.route_rows(*args)
    one = fused_cuda.route_rows(*args, offsets=torch.tensor(
        [0, r["feats"].shape[0]], dtype=torch.int32))
    want = _jax(binned, [r], L, jmeta, lids=lids)
    np.testing.assert_array_equal(no_offsets.numpy(), want)
    np.testing.assert_array_equal(one.numpy(), want)
    assert (want != lids).any()


# ---------------------------------------------------------------------------
# (c) the wave grower routes each valid set once a tree
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def low_buckets():
    """Both growers bucket their slots from 1 row, so the 4-slot ramp and
    the 8-slot rounds run here."""
    saved = jgw._BUCKET_MIN_N, tgw._BUCKET_MIN_N
    jgw._BUCKET_MIN_N = tgw._BUCKET_MIN_N = 1
    yield
    jgw._BUCKET_MIN_N, tgw._BUCKET_MIN_N = saved


def _data(seed, n):
    """NaNs (feature 0), 30% exact zeros (feature 2), a coarse integer
    feature (3)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    X[rng.rand(n) < 0.08, 0] = np.nan
    X[rng.rand(n) < 0.30, 2] = 0.0
    X[:, 3] = np.round(X[:, 3] * 2)
    logit = (np.nan_to_num(X[:, 0]) - X[:, 1] + 0.6 * X[:, 2] * X[:, 3]
             + 0.4 * X[:, 4])
    return X, (logit + rng.randn(n) > 0).astype(np.float64)


BASE = {"objective": "binary", "num_leaves": 15, "leafwise_wave_size": 8,
        "min_data_in_leaf": 5, "max_bin": 31, "hist_dtype": "f32",
        "metric": "binary_logloss,auc", "verbosity": -1}
PATHS = {"staged": {"hist_method": "pallas"},
         "fused": {"hist_method": "fused"},
         "looped": {"hist_method": "fused", "wave_loop_rounds": 2},
         "packed staged": {"hist_method": "pallas", "max_bin": 15,
                           "bin_layout": "packed4"}}
ROUNDS = 3


@pytest.fixture(scope="module")
def jax_history(low_buckets):
    """The JAX package's valid metric history at BASE (staged)."""
    X, y = _data(30, 2048)
    Xv, yv = _data(31, 600)
    out = {}
    for max_bin in (31, 15):
        ev = {}
        lj.train(dict(BASE, hist_method="pallas", max_bin=max_bin),
                 lj.Dataset(X, label=y), ROUNDS,
                 valid_sets=[lj.Dataset(Xv, label=yv)], evals_result=ev,
                 verbose_eval=False)
        out[max_bin] = ev["valid_0"]
    return out


@pytest.mark.parametrize("path", list(PATHS))
def test_grower_valid_leaf_ids_are_the_tree_walk(path, low_buckets,
                                                 jax_history, monkeypatch):
    """On each path the grower routes the valid set once a tree, after its
    last round, and the ids equal the walk of the finished tree
    (``tree_leaf_index_binned``) exactly; the valid metric history equals
    the JAX package's within the training tolerances."""
    calls = []
    route = tgw.fused_route_rows

    def spy(row_sets, **kw):
        out = route(row_sets, **kw)
        calls.append((kw["offsets"], out))
        return out

    monkeypatch.setattr(tgw, "fused_route_rows", spy)
    X, y = _data(30, 2048)
    Xv, yv = _data(31, 600)
    params = dict(BASE, **PATHS[path])
    ev = {}
    b = lt.train(params, lt.Dataset(X, label=y), ROUNDS,
                 valid_sets=[lt.Dataset(Xv, label=yv)], evals_result=ev,
                 device="cpu")
    g = b._gbdt
    assert g._packed == ("packed" in path)
    trees = g._device_trees
    assert len(calls) == len(trees) == ROUNDS
    for tree, (offsets, (vlids,)) in zip(trees, calls):
        n = int(tree.num_leaves)
        assert n == BASE["num_leaves"]
        # round order: the 4-slot ramp, then rounds of up to 8 splits
        sizes = torch.diff(offsets).tolist()
        assert sum(sizes) == n - 1 and sizes[:3] == [1, 2, 4]
        walk = tree_leaf_index_binned(tree, g._valid_binned[0],
                                      g.meta.nan_bin, g.meta.missing_type,
                                      g.meta.zero_bin, g._packed)
        assert torch.equal(vlids, walk.to(torch.int32))
    want = jax_history[params["max_bin"]]
    for metric, tol in (("binary_logloss", 1e-6), ("auc", 1e-4)):
        assert len(ev["valid_0"][metric]) == ROUNDS
        np.testing.assert_allclose(ev["valid_0"][metric], want[metric],
                                   rtol=0, atol=tol)
