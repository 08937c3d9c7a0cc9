"""Stochastic-rounded int8 histograms (``hist_dtype_deep=int8sr``) in the
port, held against the JAX package.

On the CPU the port's kernels compute their plain versions; here they are
held to the JAX package's functions on the same numpy inputs (Pallas in
interpret mode, as tests/test_int8sr.py runs them).  The CUDA kernels
themselves (the quantize kernel, K1's, K2's and K6's int8sr legs) are held
to the plain versions on the card by chip_smoke.py (phases 28-30).

Tolerances:
* the rounding stream (keys, uniforms), the quantized rows and the
  integer histograms: bit for bit.  The scales too, except where the JAX
  package's CPU backend rounds ``log2`` / ``exp2`` (ops/quantize.py's
  module note): there the port's exponent is the exact one, and that is
  pinned instead;
* leaf ids, split counts and the picks (feature, threshold, default
  direction): identical;
* a quantized round's left and right sums: bit for bit (integer prefix
  sums times a power of two); gains within ``4e-6 (GL^2 / (HL + l2) +
  GR^2 / (HR + l2) + |shift|) + 1e-6`` (the terms a gain's f32 rounding
  is carried by); f32 rounds' sums and pools within ``4e-6`` of their
  rows' absolute mass plus 1e-6;
* whole trainings: at ``hist_dtype=f32`` trees structurally identical to
  the JAX package's and leaf values within 2e-5; at bf16x2 predictions
  within 2e-5 (tests/test_torch_train.py's); the port's staged, fused and
  looped model texts identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightgbmv1_tpu as lj
from lightgbmv1_tpu.models import grower_wave as jgw
from lightgbmv1_tpu.ops import hist_pallas as jhp
from lightgbmv1_tpu.ops import quantize as jq
from lightgbmv1_tpu.ops import split as jsplit
from lightgbmv1_tpu.ops import wave_fused as jwf

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.models import grower_wave as tgw
from lightgbmv1_tpu_torch.models.convert import tree_arrays_from_numpy
from lightgbmv1_tpu_torch.ops import hist_cuda, loop_cuda
from lightgbmv1_tpu_torch.ops import quantize as tq
from lightgbmv1_tpu_torch.ops import split as tsplit
from lightgbmv1_tpu_torch.ops import wave_fused as twf
from lightgbmv1_tpu_torch.parallel import trainer as ttrainer
from lightgbmv1_tpu_torch.utils import prng

from test_torch_fused import _round
from test_torch_wave_loop import (_port_loop, _rounds_by_numpy, _segment,
                                  _single_rounds)

PARAMS = dict(min_data_in_leaf=5.0)


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
    the 16-slot ramp and the sustained rounds run at these sizes."""
    saved = jgw._BUCKET_MIN_N, tgw._BUCKET_MIN_N
    jgw._BUCKET_MIN_N = tgw._BUCKET_MIN_N = 1
    yield
    jgw._BUCKET_MIN_N, tgw._BUCKET_MIN_N = saved


def _keys(seed, tree, nl):
    """The JAX package's round key and the port's, as the growers make
    them: fold_in(fold_in(PRNGKey(seed), tree), 8_000_011 + nl)."""
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                               tree), 8_000_011 + nl)
    pk = tgw.round_key(prng.fold_in(prng.prng_key(seed), tree), nl)
    return jk, pk


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# the rounding stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_rows", [1, 7, 1001])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 33 + 5, -3])
def test_stream_matches_jax_random(seed, n_rows):
    """Keys and uniforms bit for bit: a seed above 2^32 keeps its low word
    (the JAX package runs with 64-bit types off), N = 1 and odd N."""
    for tree, nl in ((0, 1), (3, 17), (1000, 200)):
        jk, pk = _keys(seed, tree, nl)
        assert tuple(int(v) for v in np.asarray(jk)) == pk
        ju = jax.random.uniform(jk, (n_rows, 2), dtype=jnp.float32)
        tu = prng.uniform(pk, n_rows)
        assert tu.dtype == torch.float32 and tuple(tu.shape) == (n_rows, 2)
        np.testing.assert_array_equal(_bits(tu.numpy()), _bits(ju))


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


def _rows(case, n=1001, seed=5):
    rng = np.random.RandomState(seed)
    g3 = np.stack([rng.randn(n), rng.rand(n) * 0.25, np.ones(n)],
                  axis=1).astype(np.float32)
    if case == "weighted":
        g3[:, 2] = rng.rand(n) * 3.0
    elif case == "zero hess":
        g3[:, 1] = 0.0
    elif case == "zero grad and count":
        g3[:, 0] = 0.0
        g3[:, 2] = 0.0
    return g3


def _both_quantized(g3, nslots=4, seed=7, tree=3, nl=9):
    jk, pk = _keys(seed, tree, nl)
    j = [np.asarray(x) for x in jq.sr_prequantize_g3(jnp.asarray(g3),
                                                     nslots)]
    t = [x.numpy() for x in tq.sr_prequantize_g3(torch.from_numpy(g3),
                                                 nslots)]
    jq3, jsc = jq.sr_quantize_g3(jnp.asarray(g3), None, nslots, jk)
    tq3, tsc = tq.sr_quantize_g3(torch.from_numpy(g3), None, nslots, pk)
    return j + [np.asarray(jq3), np.asarray(jsc)], \
        t + [tq3.numpy(), tsc.numpy()]


@pytest.mark.parametrize("case", ["unit", "weighted", "zero hess",
                                  "zero grad and count"])
def test_quantize_matches_jax(case):
    """zg, the rounded counts, the scales and the quantized rows bit for
    bit; the rows are integers in [-127, 127] and the scales powers of
    two (0 for a zero column)."""
    j, t = _both_quantized(_rows(case))
    for a, b, what in zip(j, t, ("zg", "qc", "scales", "q3", "scales")):
        np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=what)
    q3 = t[3]
    assert np.array_equal(q3, np.round(q3)) and np.abs(q3).max() <= 127
    sc = t[2][0]
    assert all(s == 0 or np.frexp(s)[0] == 0.5 for s in sc)
    if case == "zero hess":
        assert sc[1] == 0 and not q3[:, 1].any()
    if case == "zero grad and count":
        assert sc[0] == 0 and sc[2] == 1 and not q3[:, [0, 2]].any()


def _edge_rows(k, steps):
    """Rows whose grad and hess maxima put 127 / amax at 2^k (``steps``
    = 0), ``steps`` f32 ulps above it (amax stepped down) or below it
    (amax stepped up)."""
    amax = np.float32(127 * 2.0 ** -k)
    for _ in range(abs(steps)):
        amax = np.nextafter(amax, np.float32(np.inf if steps < 0 else 0))
    g3 = _rows("unit")
    g3[:, 0] = np.clip(g3[:, 0], -amax, amax)
    g3[:, 1] = np.clip(g3[:, 1], 0, amax)
    g3[0, :2] = amax
    return g3, amax


@pytest.mark.parametrize("k", range(-12, 13))
def test_quantize_exponent_edges(k):
    """127 / amax at a power of two 2^k and within two ulps of it.  At and
    above 2^k the JAX package's CPU scales are exact powers of two here
    (|k| <= 12) and the port equals them bit for bit.  Below 2^k the JAX
    package's CPU ``log2`` may round up to k; where it does not, bit for
    bit; where it does, the port keeps the exact exponent k - 1 (the
    largest power of two with inv * amax <= 127) and the JAX package's is
    k: that difference is pinned."""
    for steps in (0, 1, 2, -1, -2):
        g3, amax = _edge_rows(k, steps)
        j, t = _both_quantized(g3)
        y = np.float32(127) / amax
        exact = np.frexp(y)[1] - 1
        inv = np.float32(1) / t[2][0, 0]
        assert inv * np.float64(amax) <= 127 < 2 * inv * np.float64(amax)
        assert np.frexp(inv)[1] - 1 == exact
        jax_e = int(np.floor(np.asarray(jnp.log2(jnp.float32(y)))))
        if jax_e == exact:
            for a, b in zip(j, t):
                np.testing.assert_array_equal(_bits(b), _bits(a),
                                              err_msg=f"steps={steps}")
        else:
            assert steps < 0 and jax_e == exact + 1, (steps, jax_e, exact)
            assert t[2][0, 0] == 2 * j[2][0, 0]


# ---------------------------------------------------------------------------
# K1's int8sr leg
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [1, 5])
@pytest.mark.parametrize("packed", [False, True], ids=["u8", "packed"])
def test_k1_int8sr_matches_pallas(packed, L):
    """K1's integer plain versions (index_add_ and the row-order one)
    equal the Pallas kernel's int8sr leg exactly on the same quantized
    rows, and the float64 sums of the integers; every cell stays below
    2^24 in magnitude (where the Pallas kernel's f32 adds are exact)."""
    rng = np.random.RandomState(31 + L)
    F, B, N = 5, 16, 1531
    binned = rng.randint(0, B, (F, N)).astype(np.uint8)
    lid = rng.randint(0, L + 1, N).astype(np.int32)    # slot L: no slot
    _, pk = _keys(1, 2, 3)
    q3, _ = tq.sr_quantize_g3(torch.from_numpy(_rows("weighted", N)), None,
                              L, pk)
    q3 = q3.numpy()
    want = np.zeros((L, F, B, 3))
    for f in range(F):
        ok = lid < L
        np.add.at(want, (lid[ok], f, binned[f, ok]), q3[ok])
    assert np.abs(want).max() < 2 ** 24
    jb = jhp.pack4bit(jnp.asarray(binned)) if packed else jnp.asarray(binned)
    jh = np.asarray(jhp.hist_leaves_pallas(
        jb, jnp.asarray(q3), jnp.asarray(lid), L, B, precision="int8sr",
        interpret=True, packed=packed, num_features=F))
    tb = torch.from_numpy(binned)
    tb = hist_cuda.pack4bit(tb) if packed else tb
    pk = dict(packed=packed, num_features=F)
    th = hist_cuda.hist_leaves(tb, torch.from_numpy(q3),
                               torch.from_numpy(lid), L, B, "int8sr", **pk)
    tr = hist_cuda.hist_leaves_roworder_ref(
        tb, torch.from_numpy(q3), torch.from_numpy(lid), L, B, "int8sr",
        **pk)
    np.testing.assert_array_equal(th.numpy(), want)
    np.testing.assert_array_equal(tr.numpy(), want)
    np.testing.assert_array_equal(jh, want)


# ---------------------------------------------------------------------------
# the fused round (K2) with a quantized bucket
# ---------------------------------------------------------------------------


def _gain_bound(q, l2=0.0):
    """The cancellation-aware gain bound on rows ``q`` (C, PACK_COLS) of
    the reference side: its leaf gains' magnitudes and the shift."""
    lg, lh = q[:, 4].astype(np.float64), q[:, 5].astype(np.float64)
    rg, rh = q[:, 7].astype(np.float64), q[:, 8].astype(np.float64)
    tg, th = lg + rg, lh + rh
    terms = lg ** 2 / (lh + l2) + rg ** 2 / (rh + l2) \
        + np.abs(tg ** 2 / (th + l2))
    return 4e-6 * terms + 1e-6


@pytest.mark.parametrize("sub", [True, False], ids=["sub", "pool-free"])
def test_fused_round_int8sr_matches_jax(sub):
    """``make_fused_round(quant_key=...)`` against the JAX package's: the
    rows quantized with the same stream, hsmall the same raw integers,
    the scales applied in the subtraction (``apply_scale``) or after the
    integer cumulative sum (``child_scale``): leaf ids exact, picks
    identical, gains within the bound; pool-free the left and right sums
    bit for bit (integer prefix sums times a power of two), in
    subtraction mode (f32 children: the parent minus the smaller) within
    4e-6 of the children's absolute mass."""
    r = _round(61 + sub, 5, 16, 777, 3, 12, sub)
    jk, pk = _keys(7, 1, r["num_leaves"])
    t, j = torch.from_numpy, jnp.asarray
    tfn = twf.make_fused_round(meta=r["tmeta"], params=tsplit.SplitParams(
        **PARAMS), num_bins=r["B"], precision="f32", deep_precision="f32")
    route = dict(leaf_id=t(r["lids"]), feats=t(r["feats"]),
                 thrs=t(r["thrs"]), dls=t(r["dls"]), leafs=t(r["leafs"]),
                 nls=t(r["nls"]), num_leaves=r["num_leaves"])
    zq, scale3 = tq.prequantize_rows(t(r["g3"]))
    scales = scale3.expand(r["S"] if sub else 2 * r["S"], 3).contiguous()
    ptab, hsm, nleaf = tfn(
        t(r["binned"]), t(r["g3"]), r["S"], quant_key=pk, zq=zq,
        scale=scales, mask=t(r["mask"]), csums=t(r["csums"]),
        sml=t(r["sml"]) if sub else None,
        parent=t(r["parent"]) if sub else None, route=route)
    jfn = jwf.make_fused_round(meta=r["jmeta"], params=jsplit.SplitParams(
        **PARAMS), num_bins=r["B"], precision="f32", deep_precision="f32",
        interpret=True)
    C = 2 * r["S"]
    jroute = dict(leaf_id=j(r["lids"]), feats=j(r["feats"]),
                  thrs=j(r["thrs"]), dls=j(r["dls"]), leafs=j(r["leafs"]),
                  nls=j(r["nls"]), num_leaves=r["num_leaves"])
    jtab, jhsm, jscales, jleaf = jfn(
        j(r["binned"]), j(r["g3"]), None, r["S"], quant_key=jk, scaled=True,
        mask=j(r["mask"]), csums=j(r["csums"]),
        constr=jnp.tile(jnp.asarray(jsplit.NO_CONSTRAINT, jnp.float32),
                        (C, 1)),
        depth=jnp.ones(C, jnp.int32), pout=jnp.zeros(C, jnp.float32),
        sml=j(r["sml"]) if sub else None,
        parent=j(r["parent"]) if sub else None, route=jroute)
    np.testing.assert_array_equal(nleaf.numpy(), np.asarray(jleaf))
    np.testing.assert_array_equal(_bits(scales.numpy()), _bits(jscales))
    if sub:
        h = hsm.numpy()
        np.testing.assert_array_equal(h, np.asarray(jhsm))
        assert np.array_equal(h, np.round(h)) and h.any()
    p, q = ptab.numpy(), np.asarray(jtab)
    np.testing.assert_array_equal(p[:, 1:4], q[:, 1:4])
    fin = np.isfinite(q[:, 0])
    np.testing.assert_array_equal(np.isfinite(p[:, 0]), fin)
    if sub:
        tol_s = 4e-6 * np.concatenate([r["child_absum"]] * 2, 1) + 1e-6
        assert (np.abs(p[:, 4:] - q[:, 4:]) <= tol_s)[fin].all()
    else:
        np.testing.assert_array_equal(_bits(p[fin, 4:]), _bits(q[fin, 4:]))
    assert (np.abs(p[fin, 0] - q[fin, 0]) <= _gain_bound(q[fin])).all()
    # the quantized round is not the f32 one
    f32 = tfn(t(r["binned"]), t(r["g3"]), r["S"], mask=t(r["mask"]),
              csums=t(r["csums"]), sml=t(r["sml"]) if sub else None,
              parent=t(r["parent"]) if sub else None, route=route)
    assert not np.array_equal(f32[0].numpy()[fin, 4:], p[fin, 4:])


# ---------------------------------------------------------------------------
# the persistent loop (K6) with a quantized ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sub", [True, False], ids=["sub", "pool-free"])
def test_loop_int8sr_matches_jax(sub):
    """The port's loop with the 8-slot bucket quantized against the JAX
    package's loop at hist_dtype=f32 (where its planner engages): both
    draw each quantized round's uniforms from fold_in(key, 8_000_011 +
    nl).  Leaf ids, split counts and picks exact; sums and the pool within
    4e-6 of their rows' absolute mass, gains within the bound."""
    # 1,000 rows: the JAX loop's quantized draw does not trace when N is a
    # whole number of its row tiles (1,024 here), a fact of the JAX package
    s = _segment(sum(map(ord, f"int8sr-loop-{sub}")), 6, 16, 1000, 8, 32, 3,
                 sub, (4, 8))
    R, qb = 4, (8,)
    tree = prng.fold_in(prng.prng_key(7), 2)
    jkey = jax.random.fold_in(jax.random.PRNGKey(7), 2)
    t, j = torch.from_numpy, jnp.asarray
    params = tsplit.SplitParams(**PARAMS)
    kw = dict(rounds=R, K=s["K"], slot_buckets=s["ladder"],
              max_depth=s["max_depth"], base_mask=t(s["mask"]),
              num_bins=s["B"], precision="f32", meta=s["tmeta"],
              params=params, pool=t(s["pool"]) if sub else None, key=tree,
              quant_buckets=qb, quant=tq.prequantize_rows(t(s["g3"])))
    packed, new_leaf, pool, n_split = (
        x if x is None else x.numpy() for x in loop_cuda.fused_wave_loop(
            t(s["binned"]), t(s["g3"]), t(s["lids"]), t(s["ft"]), s["nl"],
            **kw))
    fn = jwf.make_fused_wave_loop(
        meta=s["jmeta"], params=jsplit.SplitParams(**PARAMS),
        num_bins=s["B"], precision="f32", deep_precision="f32", rounds=R,
        interpret=True)
    jpacked, jleaf, jpool = (
        x if x is None else np.asarray(x) for x in fn(
            j(s["binned"]), j(s["g3"]), j(s["lids"]), j(s["ft"]), s["nl"],
            jkey, K=s["K"], slot_buckets=s["ladder"], quant_buckets=qb,
            max_depth=s["max_depth"], base_mask=j(s["mask"]),
            pool=j(s["pool"]) if sub else None))
    np.testing.assert_array_equal(new_leaf, jleaf)
    leaf_after = [loop_cuda.fused_wave_loop(
        t(s["binned"]), t(s["g3"]), t(s["lids"]), t(s["ft"]), s["nl"],
        **dict(kw, rounds=r + 1))[1].numpy() for r in range(R - 1)] \
        + [new_leaf]
    rounds = _rounds_by_numpy(s, packed, n_split, leaf_after)
    assert len(rounds) == R
    quantized = [n > 4 for n, _, _ in rounds]
    assert any(quantized) and not all(quantized)
    for r, (n, _, absum) in enumerate(rounds):
        p, q = packed[r, :2 * n], jpacked[r, :2 * n]
        np.testing.assert_array_equal(p[:, 1:4], q[:, 1:4])
        fin = np.isfinite(q[:, 0])
        np.testing.assert_array_equal(np.isfinite(p[:, 0]), fin)
        assert (np.abs(p[fin, 0] - q[fin, 0]) <= _gain_bound(q[fin])).all()
        tol_s = 4e-6 * np.concatenate([absum] * 2, 1) + 1e-6
        assert (np.abs(p[:, 4:] - q[:, 4:]) <= tol_s)[fin].all()
    if sub:
        anc = np.zeros(s["L"], np.int64)
        anc[new_leaf] = s["lids"]
        absum = np.zeros((s["L"], s["F"], s["B"], 3))
        for f in range(s["F"]):
            np.add.at(absum, (s["lids"], f, s["binned"][f]), np.abs(s["g3"]))
        assert (np.abs(pool - jpool) <= 4e-6 * absum[anc] + 1e-6).all()
    else:
        assert pool is None and jpool is None


@pytest.mark.parametrize("sub", [True, False], ids=["sub", "pool-free"])
def test_loop_int8sr_is_its_single_rounds(sub):
    """Under bf16x2 (the JAX planner refuses int8sr there) the port's loop
    with the 8-slot bucket quantized equals R grower-facing single rounds
    bit for bit, each quantized round given its round key: packed rows,
    leaf ids and pool."""
    s = _segment(sum(map(ord, f"int8sr-rounds-{sub}")), 6, 16, 1024, 8, 32,
                 3, sub, (4, 8))
    tree = prng.fold_in(prng.prng_key(3), 4)
    packed, new_leaf, pool, n_split = _port_loop(
        s, 4, "bf16x2", key=tree, quant_buckets=(8,),
        quant=tq.prequantize_rows(torch.from_numpy(s["g3"])))
    want = _single_rounds(s, 4, "bf16x2", key=tree, quant_buckets=(8,))
    live = [int(n) for n in n_split if n > 0]
    assert any(n > 4 for n in live) and any(n <= 4 for n in live)
    assert torch.equal(packed, want[0])
    assert torch.equal(new_leaf, want[1])
    assert (pool is None and want[2] is None) or torch.equal(pool, want[2])


# ---------------------------------------------------------------------------
# whole trainings (tests/test_int8sr.py::_train_int8sr's configuration)
# ---------------------------------------------------------------------------

INT8SR = {"objective": "binary", "num_leaves": 127, "leafwise_wave_size": 63,
          "min_data_in_leaf": 5, "verbosity": -1, "seed": 7,
          "hist_dtype_deep": "int8sr"}


def _problem(n=4000):
    rng = np.random.RandomState(0)
    X = rng.randn(n, 8)
    y = (X[:, 0] * 1.5 - X[:, 1] + 0.3 * rng.randn(n) > 0).astype(float)
    return X, y


def _port(params, rounds=3, n=4000):
    X, y = _problem(n)
    return lt.train(params, lt.Dataset(X, label=y), rounds, device="cpu"), X


@pytest.fixture()
def quant_calls(monkeypatch):
    """Every nslots the port's trainer runs its quantized pass at."""
    calls = []
    orig = ttrainer.hist_wave_quant

    def spy(binned, g3, label, nslots, *a, **kw):
        calls.append(int(nslots))
        return orig(binned, g3, label, nslots, *a, **kw)

    monkeypatch.setattr(ttrainer, "hist_wave_quant", spy)
    return calls


def test_int8sr_gate_buckets(low_buckets, quant_calls):
    """At the JAX package's own int8sr configuration (127 leaves in
    waves of 63: buckets 4, 16, 63) the quantized pass runs at exactly
    the 16-slot ramp and the sustained bucket, never the root or S = 4."""
    tb, X = _port(INT8SR, rounds=2)
    assert np.isfinite(tb.predict(X)).all()
    assert set(quant_calls) == {16, 63}, quant_calls


# waves of 32 (buckets 4, 16, 32; 16 and 32 quantize) on 2,000 rows (not
# a whole number of the JAX loop's row tiles): 33 leaves, the size at which
# tests/test_torch_train.py holds the f32 trees identical, reach the
# 16-slot ramp; the first tree of 64 leaves also the sustained bucket.
# Later trees of 64 leaves part at exact f32 gain ties, int8sr or not.
PARITY = dict(INT8SR, num_leaves=33, leafwise_wave_size=32,
              min_data_in_leaf=3, hist_dtype="f32")


@pytest.mark.parametrize("extra,rounds,buckets", [
    ({}, 3, {16}),
    ({"hist_method": "fused", "wave_loop_rounds": 2}, 3, None),
    ({"num_leaves": 64}, 1, {16, 32})],
    ids=["staged", "looped", "64 leaves"])
def test_int8sr_f32_trees_match_jax(low_buckets, quant_calls, extra, rounds,
                                    buckets):
    """At hist_dtype=f32 the port's int8sr trees are the JAX package's,
    staged and through the loop (where the JAX planner engages it): the
    same quantized rounds on the same stream, every split identical, leaf
    values within 2e-5."""
    params = dict(PARITY, **extra)
    tb, X = _port(params, rounds=rounds, n=2000)
    if buckets is not None:
        assert set(quant_calls) == buckets, quant_calls
    Xn, y = _problem(2000)
    jb = lj.train(params, lj.Dataset(Xn, label=y), rounds,
                  verbose_eval=False)
    jtrees = jax.device_get(jb._gbdt._device_trees)
    ttrees = tb._gbdt._device_trees
    assert len(jtrees) == len(ttrees) == rounds
    for jt, tt in zip(jtrees, ttrees):
        carried = tree_arrays_from_numpy(jt._asdict())
        n = int(carried.num_leaves)
        assert n == int(tt.num_leaves) == params["num_leaves"]
        for f in ("split_feature", "threshold_bin", "default_left",
                  "left_child", "right_child"):
            assert torch.equal(getattr(carried, f)[:n - 1],
                               getattr(tt, f)[:n - 1]), f
        assert torch.equal(carried.leaf_count[:n], tt.leaf_count[:n])
        np.testing.assert_allclose(tt.leaf_value[:n].numpy(),
                                   carried.leaf_value[:n].numpy(),
                                   rtol=0, atol=2e-5)


def test_int8sr_bf16x2_predictions_match_jax(low_buckets):
    """At the default bf16x2 (int8sr sets the deep precision to it) with
    the kernels' method: predictions within 2e-5 of the JAX package's."""
    params = dict(PARITY, hist_dtype="bf16x2", hist_method="pallas",
                  max_bin=63)
    tb, X = _port(params, rounds=2, n=2000)
    Xn, y = _problem(2000)
    jb = lj.train(params, lj.Dataset(Xn, label=y), 2, verbose_eval=False)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(Xn, raw_score=True), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("extra", [{"gpu_use_dp": True},
                                   {"num_leaves": 31,
                                    "leafwise_wave_size": 8}],
                         ids=["gpu_use_dp", "K=8"])
def test_int8sr_gate_off(low_buckets, quant_calls, extra):
    """No quantized pass under gpu_use_dp (the mode is turned off, with
    the JAX package's warning) or on a wave of 8 (no sustained bucket of
    K >= 32 and no 16-slot ramp)."""
    tb, X = _port(dict(INT8SR, **extra), rounds=2)
    assert np.isfinite(tb.predict(X)).all()
    assert quant_calls == []


def test_int8sr_staged_fused_looped_reproducible(low_buckets):
    """Staged, fused and looped int8sr trainings write one model text
    byte for byte, and a second staged training the same text: the
    stream has no state but the keys."""
    base = dict(INT8SR, hist_method="pallas", max_bin=63)
    texts = [_port(dict(base, **extra), rounds=2, n=2000)[0]
             .model_to_string()
             for extra in ({}, {}, {"hist_method": "fused"},
                           {"hist_method": "fused", "wave_loop_rounds": 4})]
    assert texts[0] == texts[1] == texts[2] == texts[3]
    f32 = _port(dict(base, hist_dtype_deep="bf16x2"), rounds=2, n=2000)[0]
    assert f32.model_to_string() != texts[0]
